"""Device meshes: for training and evaluation the data axis, the model axis
and FSDP, one process per device; for serving a mesh in one process.

Port of ``dfol_vqa_tpu/parallel/mesh.py``. The JAX package jits one step
under GSPMD over a ``jax.sharding.Mesh`` with axes ``('data',)`` or
``('data', 'model')``. PyTorch's idiom is one process per device
(``torchrun``), ``torch.distributed``, and a
``torch.distributed.device_mesh.DeviceMesh`` with the same dim names; the
collectives JAX's compiler inserts are written out here and in
``train/trainer.py``:

* **data axis** (JAX ``batch_sharding``, ``shard_train_step``). Each data
  rank loads ``batch_size / n_data`` rows from its own shard of the dataset
  (``batch_sharding``: the loader's ``num_shards``/``shard_index``); the
  ranks of one model group read the same rows. A step divides each rank's
  loss sum by the global count of real questions and sums the gradients
  over the axis, so it equals the single-device step on the union of the
  ranks' rows (JAX divides by the union batch's count,
  ``train/trainer.py:93-95``). DDP's mean over ranks would not, where ranks
  carry different numbers of pad questions.
* **model axis** (JAX ``param_sharding``, ``mesh.py:82-99``). The
  vocabulary axis of ``embedding`` and ``embedding_extra`` is split over
  ``model`` when it divides. The head's logits are all-gathered along V,
  and a token's columns are gathered by the rank that holds them and summed
  over the axis (``VocabSlice``, which takes ``oracle.Embedding``'s place in
  the working tree), both through differentiable collectives. Every rank of a model group computes the whole loss, and
  each backpropagates ``1 / n_model`` of it: a leaf replicated over the axis
  then gets its gradient summed over it, a split leaf its own part.
* **FSDP** (``tpu.fsdp``, ZeRO-3). A leaf whose axis the data size divides
  (the first such axis, JAX's rule) is held as one shard per data rank,
  and the optimizer and its Adam state step the shards. Before a step each
  shard is all-gathered into the working tree that the interpreter reads
  (``ShardedParams.gather``); after backward each gradient is
  reduce-scattered to its shard (``reduce_grads``); after the step the
  gathered copies are freed (``release``). The interpreter reads parameters
  as tensors and calls no module ``forward``, so FSDP2's hooks would never
  fire: the gathers are explicit.
* Host numbers (a step's count of real questions, whether any rank still
  has a batch, error sums, predictions) go over a gloo group on the host,
  so they never wait on the device.

``prod(tpu.mesh_shape)`` must equal the number of processes; nothing falls
back to one device.

Serving (JAX's ``ServingEngine(mesh=...)``) is one process that drives
every device of a ``LocalMesh`` (``make_local_mesh``), with no process
group: one parameter replica per data row (``serving_replicas``), the
vocabulary head split over a row's model devices by the same
``param_sharding`` rule (``VocabShards``, which copies between devices
where ``VocabSlice`` runs collectives); each served group runs whole on
one data row, the rows in turn (``serve.py``).
"""

from __future__ import annotations

import copy
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.models.oracle import Embedding, OracleParams, head_logits

AXES = ("data", "model")
RENDEZVOUS_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def rendezvous_in_env() -> bool:
    """Whether ``torchrun`` (or a multi-host launcher) set the rendezvous."""
    return all(k in os.environ for k in RENDEZVOUS_ENV)


def distributed_requested(cfg: Config) -> bool:
    """Whether a run trains over a mesh: a ``torchrun`` launch, the
    ``DFOL_DISTRIBUTED`` environment (a multi-host launch, as in JAX), or a
    ``tpu.mesh_shape`` of more than one device."""
    return ("WORLD_SIZE" in os.environ or bool(os.environ.get("DFOL_DISTRIBUTED"))
            or math.prod(cfg.tpu.mesh_shape) > 1)


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Join this launch's process group (once) and return this rank's device.

    The rendezvous is ``init_method`` with ``rank`` and ``world_size`` when
    given, else ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``). The backend is NCCL for device
    tensors and gloo for host tensors on the card ("cpu:gloo,cuda:nccl"),
    gloo on the CPU, or ``backend``. The device is ``device``; a bare
    "cuda" becomes ``cuda:LOCAL_RANK``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if init_method is None and not rendezvous_in_env():
            raise RuntimeError(
                "no rendezvous for a distributed run: launch with torchrun (it sets "
                f"{', '.join(RENDEZVOUS_ENV)}) or pass init_method")
        backend = backend or ("cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo")
        kw = {}
        if init_method is not None:
            kw = {"init_method": init_method, "rank": rank, "world_size": world_size}
        dist.init_process_group(backend=backend, **kw)
    return device


@dataclass(frozen=True)
class Placement:
    """Where a leaf is split: ``data_dim`` over the data axis (FSDP),
    ``model_dim`` over the model axis (the vocabulary); None = replicated."""

    data_dim: Optional[int] = None
    model_dim: Optional[int] = None


class Mesh:
    """The ``DeviceMesh`` over the process group, this rank's device and
    coordinates, the axes' process groups, ``fsdp``, and a gloo group for
    host numbers."""

    def __init__(self, device_mesh, device: torch.device, fsdp: bool = False):
        self.device_mesh = device_mesh
        self.device = device
        self.fsdp = fsdp
        names = device_mesh.mesh_dim_names
        coord = device_mesh.get_coordinate()
        self.rank = dist.get_rank()
        self.n_data = device_mesh.size(0)
        self.data_rank = coord[0]
        self.data_group = device_mesh.get_group("data")
        self.n_model = device_mesh.size(1) if len(names) > 1 else 1
        self.model_rank = coord[1] if len(names) > 1 else 0
        self.model_group = device_mesh.get_group("model") if self.n_model > 1 else None
        self.host_group = (dist.group.WORLD if dist.get_backend() == "gloo"
                           else dist.new_group(backend="gloo"))

    @property
    def writes_files(self) -> bool:
        """Rank 0 alone writes checkpoints, predictions and hardsets."""
        return self.rank == 0

    def host_sum(self, values: Sequence[float]) -> np.ndarray:
        """Per-rank host numbers summed over the data axis (float64): the
        ranks of a model group hold the same ones, so the sum over all
        ranks is divided by the model axis's size."""
        t = torch.tensor(list(values), dtype=torch.float64)
        dist.all_reduce(t, group=self.host_group)
        return t.numpy() / self.n_model

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (a host value) on every rank."""
        out = [obj]
        dist.broadcast_object_list(out, src=0, group=self.host_group)
        return out[0]

    def gather_objects(self, obj) -> List:
        """Every rank's ``obj`` of model rank 0, in data-rank order."""
        out: List = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj, group=self.host_group)
        return out[::self.n_model]

    def seed(self, seed: int) -> int:
        """The dropout generator's seed of this rank, from (``seed``, data
        rank): a model group draws the same masks, data ranks their own."""
        return int(np.random.SeedSequence([seed, self.data_rank]).generate_state(1)[0])


def make_mesh(mesh_shape: Sequence[int], axis_names: Sequence[str], device="cuda",
              fsdp: bool = False, **init) -> Mesh:
    """A ``Mesh`` of ``mesh_shape`` with axes ``axis_names`` over the
    processes of this launch (one per device; ``init`` goes to
    ``init_distributed``). Raises unless the shape covers exactly the
    processes that joined, before joining."""
    if dist.is_initialized():
        world = dist.get_world_size()
    elif init.get("init_method"):
        world = int(init["world_size"])
    else:
        world = int(os.environ["WORLD_SIZE"]) if rendezvous_in_env() else 1
    shape = tuple(int(n) for n in mesh_shape)
    if math.prod(shape) != world:
        raise ValueError(
            f"tpu.mesh_shape={shape} covers {math.prod(shape)} devices, one process each, but "
            f"this launch has {world} process(es): run it under torchrun --nproc-per-node "
            f"{math.prod(shape)}, or set tpu.mesh_shape to the launch's size")
    names = tuple(axis_names)
    if names != AXES[:len(shape)]:
        raise ValueError(f"tpu.mesh_axes={names} for mesh_shape={shape}: the axes are "
                         f"('data',) or ('data', 'model')")
    device = init_distributed(device, **init)
    from torch.distributed.device_mesh import DeviceMesh

    device_mesh = DeviceMesh(device.type, torch.arange(world).reshape(shape),
                             mesh_dim_names=names)
    return Mesh(device_mesh, device, fsdp)


def batch_sharding(mesh: Optional[Mesh], batch_size: int) -> Tuple[int, int, int]:
    """(num_shards, shard_index, rows per rank) of a loader of the global
    ``batch_size`` on this rank: its data rank's shard, ``batch_size /
    n_data`` rows a batch."""
    if mesh is None:
        return 1, 0, batch_size
    if batch_size % mesh.n_data:
        raise ValueError(f"batch size {batch_size} is not a multiple of the data axis's "
                         f"{mesh.n_data} ranks")
    return mesh.n_data, mesh.data_rank, batch_size // mesh.n_data


def _vocab_leaf(params: OracleParams, name: str) -> Optional[Embedding]:
    top = name.split(".", 1)[0]
    return getattr(params, top) if top in ("embedding", "embedding_extra") else None


def param_sharding(params: OracleParams, mesh: Mesh) -> Dict[str, Placement]:
    """Each leaf's ``Placement``, JAX's rule: replicated, except that with
    ``mesh.fsdp`` a leaf's first axis that the data size divides is split
    over ``data``, and on a model axis the vocabulary axis of ``embedding``
    / ``embedding_extra`` (when the model size divides it) is split over
    ``model``, their weight's input axis over ``data`` with FSDP, their bias
    replicated over ``data``."""
    fsdp = mesh.fsdp
    out: Dict[str, Placement] = {}
    for name, p in params.named_parameters():
        data_dim = None
        if fsdp and mesh.n_data > 1:
            data_dim = next((a for a, d in enumerate(p.shape)
                             if d % mesh.n_data == 0 and d >= mesh.n_data), None)
        emb = _vocab_leaf(params, name)
        if mesh.n_model > 1 and emb is not None and emb.b.shape[0] % mesh.n_model == 0:
            if name.endswith(".w"):
                rows = fsdp and mesh.n_data > 1 and p.shape[0] % mesh.n_data == 0
                out[name] = Placement(0 if rows else None, 1)
            else:
                out[name] = Placement(None, 0)
            continue
        out[name] = Placement(data_dim, None)
    return out


def _part(t: torch.Tensor, dim: Optional[int], n: int, i: int) -> torch.Tensor:
    if dim is None:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _flat_all_reduce(tensors: List[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place, as one flat buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view_as(t))
        offset += t.numel()


def _reduce_scatter(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


class _GatherVocab(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; the backward reduce-scatters
    the gradient, so each rank's slice gets the sum of every rank's.
    (``torch.distributed.nn.functional.all_gather``'s backward on gloo
    scatters from group ranks taken as global ranks, which fails on a group
    without rank 0, such as the second model group.)"""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None


class VocabSlice(Embedding):
    """A concept head's vocabulary slice on one rank of the model axis: the
    columns ``[start, start + V_pad / n_model)`` of ``emb``'s parameters
    (they stay ``emb``'s), with ``logits`` and ``rows`` giving what the
    whole head would, through differentiable collectives over ``group``."""

    def __init__(self, emb: Embedding, group, start: int):
        torch.nn.Module.__init__(self)
        self.w, self.b = emb.w, emb.b
        self.group, self.start = group, start

    def logits(self, h: torch.Tensor, cfg: Optional[Config] = None) -> torch.Tensor:
        """The slice's logits, all-gathered along V."""
        out = super().logits(h, cfg)
        return _GatherVocab.apply(out, out.ndim - self.b.ndim, self.group,
                                  dist.get_world_size(self.group))

    def rows(self, tok0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each rank gathers the columns it holds, zero for the others, and
        the model axis sums them: exactly one rank holds each."""
        from torch.distributed.nn import functional as dist_nn

        wt = self.w.movedim(1, 0)  # (V / n_model, E[, F-1])
        local = tok0 - self.start
        own = (local >= 0) & (local < wt.shape[0])
        idx = torch.where(own, local, 0)
        w_rows = torch.where(own.reshape(own.shape + (1,) * (wt.ndim - 1)), wt[idx], 0.0)
        b_rows = torch.where(own.reshape(own.shape + (1,) * (self.b.ndim - 1)),
                             self.b[idx], 0.0)
        return (dist_nn.all_reduce(w_rows, group=self.group),
                dist_nn.all_reduce(b_rows, group=self.group))


class ShardedParams:
    """One rank's parameters under a mesh.

    ``working`` is the ``OracleParams`` the interpreter reads: a copy of the
    whole tree in which vocabulary-split leaves hold this rank's slice (its
    ``Embedding``s are ``VocabSlice``s) and FSDP leaves hold
    the gathered tensor between ``gather`` and ``release`` (nothing
    otherwise). ``masters`` are what the optimizer steps: an FSDP leaf's
    shard, any other leaf's working parameter itself."""

    def __init__(self, mesh: Mesh, params: OracleParams):
        self.mesh = mesh
        self.placement = param_sharding(params, mesh)
        self.working = copy.deepcopy(params)
        self._shards: Dict[str, torch.nn.Parameter] = {}
        for top in ("embedding", "embedding_extra"):
            emb = getattr(self.working, top)
            if emb is not None and self.placement[top + ".b"].model_dim is not None:
                setattr(self.working, top, VocabSlice(
                    emb, mesh.model_group,
                    mesh.model_rank * (emb.b.shape[0] // mesh.n_model)))
        for name, p in self.working.named_parameters():
            if self.placement[name].data_dim is not None:
                self._shards[name] = torch.nn.Parameter(torch.empty(0, device=p.device))
        self._gathered = False
        self.load_full(params)

    def _local(self, name: str, full: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(this rank's model slice of ``full``, its data shard)."""
        pl, m = self.placement[name], self.mesh
        sliced = _part(full, pl.model_dim, m.n_model, m.model_rank)
        return sliced, _part(sliced, pl.data_dim, m.n_data, m.data_rank)

    def load_full(self, params: OracleParams) -> None:
        """Take every leaf's value from the whole tree ``params`` (each rank
        slices its own part; no communication)."""
        full = dict(params.named_parameters())
        with torch.no_grad():
            for name, p in self.working.named_parameters():
                sliced, shard = self._local(name, full[name].detach())
                if name in self._shards:
                    self._shards[name].data = shard.clone()
                    p.data = torch.empty(0, device=shard.device)
                else:
                    p.data = sliced.clone()
        self._gathered = False

    def masters(self) -> List[Tuple[str, torch.Tensor]]:
        return [(name, self._shards.get(name, p)) for name, p in self.working.named_parameters()]

    def norm_weight(self, name: str) -> float:
        """1 / the number of ranks holding the same copy of ``name``'s
        master: its squared gradient summed over all ranks then counts
        once in the global norm."""
        pl, m = self.placement[name], self.mesh
        return 1.0 / ((1 if pl.data_dim is not None else m.n_data)
                      * (1 if pl.model_dim is not None else m.n_model))

    def gather(self) -> OracleParams:
        """All-gather every FSDP shard into ``working`` (once until the next
        ``release``); returns ``working``."""
        if not self._gathered:
            m = self.mesh
            with torch.no_grad():
                for name, p in self.working.named_parameters():
                    if name in self._shards:
                        p.data = _all_gather(self._shards[name].data,
                                             self.placement[name].data_dim, m.data_group,
                                             m.n_data)
            self._gathered = True
        return self.working

    def release(self) -> None:
        """Free the gathered FSDP copies and the working gradients."""
        for name, p in self.working.named_parameters():
            if name in self._shards:
                p.data = torch.empty(0, device=p.device)
                p.grad = None
        self._gathered = False

    def reduce_grads(self) -> None:
        """Sum each working gradient over the ranks that hold the leaf
        whole (a missing one counts as zero): over ``model`` for leaves the
        model axis replicates, then over ``data``, by a reduce-scatter onto
        its shard's ``.grad`` for an FSDP leaf."""
        m = self.mesh
        named = list(self.working.named_parameters())
        for _, p in named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if m.n_model > 1:
            _flat_all_reduce([p.grad for name, p in named
                              if self.placement[name].model_dim is None], m.model_group)
        if m.n_data > 1:
            _flat_all_reduce([p.grad for name, p in named if name not in self._shards],
                             m.data_group)
        for name, p in named:
            if name in self._shards:
                self._shards[name].grad = _reduce_scatter(
                    p.grad, self.placement[name].data_dim, m.data_group, m.n_data)
                p.grad = None

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A tensor shaped as ``name``'s master (its value, gradient or Adam
        moment) gathered whole over the axes that split it (a collective)."""
        pl, m = self.placement[name], self.mesh
        with torch.no_grad():
            t = t.detach()
            if name in self._shards:
                t = _all_gather(t, pl.data_dim, m.data_group, m.n_data)
            if pl.model_dim is not None:
                t = _all_gather(t, pl.model_dim, m.model_group, m.n_model)
        return t

    def full_tensors(self) -> Dict[str, torch.Tensor]:
        """Every leaf whole (a collective: every rank calls it), by name."""
        return {name: self.whole(name, master) for name, master in self.masters()}

    def copy_into(self, params: OracleParams) -> None:
        """Write the whole leaves into ``params`` in place (a collective)."""
        full = self.full_tensors()
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(full[name])


def broadcast_params(params: OracleParams) -> OracleParams:
    """Rank 0's values of ``params`` on every rank, in place; returns
    ``params``."""
    with torch.no_grad():
        for p in params.parameters():
            dist.broadcast(p.data, src=0)
    return params


def shard_params(mesh: Mesh, params: OracleParams) -> ShardedParams:
    """Rank 0's ``params`` on every rank (broadcast in place, as DDP does at
    construction), split as ``param_sharding`` says."""
    return ShardedParams(mesh, broadcast_params(params))


# ------------------------------------------------------ serving, one process


def _existing_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (a bare "cuda" is the
    current card); raises unless this process has it."""
    d = torch.device(device)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"a serving mesh holds cpu or cuda devices, not {d}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = d.index if d.index is not None else (torch.cuda.current_device() if n else 0)
    if index >= n:
        raise ValueError(f"mesh device {d} does not exist: this process sees {n} CUDA "
                         f"device(s)")
    return torch.device("cuda", index)


class LocalMesh:
    """A ``('data',)`` or ``('data', 'model')`` mesh of devices in one
    process, for serving (``ServingEngine(mesh=...)``): ``devices[d][m]`` is
    the device at data row ``d`` and model column ``m``. A device may repeat
    (a logical mesh of one card, or of "cpu"), as JAX's virtual devices do.
    ``fsdp`` is off, as JAX serves (``serve.py:304``), so ``param_sharding``
    places the leaves as JAX's serving mesh does."""

    fsdp = False

    def __init__(self, devices: Sequence[Sequence[torch.device]], axis_names: Sequence[str]):
        self.devices = tuple(tuple(row) for row in devices)
        self.axis_names = tuple(axis_names)
        self.n_data = len(self.devices)
        self.n_model = len(self.devices[0])


def make_local_mesh(mesh_shape: Sequence[int], axis_names: Optional[Sequence[str]] = None,
                    devices: Optional[Sequence] = None) -> LocalMesh:
    """A ``LocalMesh`` of ``mesh_shape`` over ``devices`` (default: every
    card of this process), reshaped row-major into (data, model) as JAX's
    ``make_mesh`` reshapes its device array. Raises when a device does not
    exist or the shape does not cover ``len(devices)``; nothing falls back
    to one device."""
    shape = tuple(int(n) for n in mesh_shape)
    names = tuple(axis_names) if axis_names is not None else AXES[:len(shape)]
    if not 1 <= len(shape) <= 2 or names != AXES[:len(shape)]:
        raise ValueError(f"mesh axes {names} for mesh_shape={shape}: the axes are ('data',) "
                         f"or ('data', 'model')")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_existing_device(d) for d in devices]
    if min(shape) < 1 or math.prod(shape) != len(devices):
        raise ValueError(f"mesh_shape={shape} covers {math.prod(shape)} devices, but "
                         f"{len(devices)} were given")
    n_model = shape[1] if len(shape) > 1 else 1
    return LocalMesh([devices[r * n_model:(r + 1) * n_model] for r in range(shape[0])], names)


def _own(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


class VocabShards(Embedding):
    """A concept head split along the vocabulary over one data row's model
    devices, in one process: shard ``i`` holds the columns ``[i * V_pad /
    n, (i + 1) * V_pad / n)`` of the head as the parameters ``w<i>``,
    ``b<i>`` on device ``i``. ``logits`` copies ``h`` to each shard's device
    and concatenates the shards' logits along V on ``h``'s device; ``rows``
    gathers each token's column from the shard that holds it. The serving
    counterpart of ``VocabSlice``, with copies between devices in place of
    its collectives; it splits the trainable interpreter's ``(E, V_pad,
    F-1)`` head too."""

    def __init__(self, emb: Embedding, devices: Sequence[torch.device]):
        torch.nn.Module.__init__(self)
        self.n = len(devices)
        self.size = emb.b.shape[0] // self.n
        self.v_from_end = emb.b.ndim  # V's place from the end of a logits tensor
        with torch.no_grad():
            for i, d in enumerate(devices):
                cols = slice(i * self.size, (i + 1) * self.size)
                self.register_parameter(f"w{i}",
                                        torch.nn.Parameter(emb.w[:, cols].to(d, copy=True)))
                self.register_parameter(f"b{i}",
                                        torch.nn.Parameter(emb.b[cols].to(d, copy=True)))

    def shards(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [(getattr(self, f"w{i}"), getattr(self, f"b{i}")) for i in range(self.n)]

    def logits(self, h: torch.Tensor, cfg: Optional[Config] = None) -> torch.Tensor:
        parts = [head_logits(h.to(w.device), w, b, cfg).to(h.device) for w, b in self.shards()]
        return torch.cat(parts, dim=-self.v_from_end)

    def rows(self, tok0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shard 0's rows, each replaced by the row of the shard that holds
        its token: exactly one shard holds each."""
        w_rows = b_rows = None
        for i, (w, b) in enumerate(self.shards()):
            local = tok0 - i * self.size
            own = (local >= 0) & (local < self.size)
            idx = torch.where(own, local, 0).to(w.device)
            wr, br = w.movedim(1, 0)[idx].to(tok0.device), b[idx].to(tok0.device)
            if w_rows is None:
                w_rows, b_rows = wr, br
            else:
                w_rows = torch.where(_own(own, wr), wr, w_rows)
                b_rows = torch.where(_own(own, br), br, b_rows)
        return w_rows, b_rows


def serving_replicas(mesh: LocalMesh, params: OracleParams) -> List[OracleParams]:
    """One copy of ``params`` per data row of ``mesh``, on the row's lead
    (model 0) device, its concept heads ``VocabShards`` over the row's model
    devices where ``param_sharding`` splits them over ``model``; every other
    leaf whole, as JAX replicates it."""
    placement = param_sharding(params, mesh)
    replicas = []
    for row in mesh.devices:
        rep = copy.deepcopy(params).to(row[0])
        for top in ("embedding", "embedding_extra"):
            emb = getattr(rep, top)
            if emb is not None and placement[top + ".b"].model_dim is not None:
                setattr(rep, top, VocabShards(emb, row))
        replicas.append(rep)
    return replicas
