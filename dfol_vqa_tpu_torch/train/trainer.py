"""Training, offline evaluation and prediction: the JAX package's
``VQATrainer``.

Port of ``dfol_vqa_tpu/train/trainer.py``: ``train`` (per step: forward,
the loss normalised by the batch's real questions, backward, clip + decay +
Adam from ``train/optim.py``; per epoch the loss and error arrays,
mid-epoch validation and saves every ``checkpointing_frequency`` steps,
best/last checkpoints, the crash save in ``finally``, ``losses.npy`` and
``errors.npy``), the 17-bucket per-terminal-op error accounting
(``OP_INDEX``, ``test_epoch`` with ``last_test_counts``), ``test``
(optionally loading a checkpoint first), ``predict`` (prediction JSON, GQA
submission mode), ``decode_answers`` and hard/easy example mining. Batches
come from the JAX package's numpy-only ``BatchLoader``, whose batches
deduplicate images: a relating batch whose unique images U satisfy
U * 2 <= B takes the shared-image relation route, any other the
per-question route (``Interpreter.build_world``).

Chunked dispatch, as in the JAX package (``tpu.train_chunk``,
``tpu.eval_chunk``): ``data/transfer.chunk_prefetch`` groups runs of
same-bucket batches (at most a chunk of them) and copies each group of two
or more to the device as one stacked transfer per tensor; a group of one
batch is copied by ``to_device_batch``. Training runs every group, of
k >= 1 batches, through the chunk step (``_train_chunk``): its k steps.
Evaluation runs a group of one with ``Interpreter.forward`` and a group of
k >= 2 as k forwards (``_eval_chunked``, through
``Interpreter.forward_many``). ``global_step`` advances by a group's
length, and mid-epoch validation and saves are checked after each group
only, as the JAX trainer checks them at dispatch boundaries. On a CUDA
device each chunk step, a lone training step included, runs as one CUDA
graph per key (``train/graphs.py``: the first group of a key eagerly, the
second captured, every later one replayed; one graph per group length);
on the CPU the same steps run eagerly. The port pads nothing, on any
device: with ``tpu.pad_chunks`` the JAX package pads a short group to the
full chunk by repeating its last batch, so that every tail length shares
one XLA executable, gates the padded steps into no-ops on the parameters
and optimizer state and drops the padded forwards. Those steps change
nothing, so the port's real steps reach the parameters JAX's padded chunk
reaches, and the port does not read ``pad_chunks``.
Evaluation runs under ``torch.inference_mode()``; its outputs stay on the
device and are read back once, after the last batch (per batch only when
hardset mining needs the answers). Training keeps each step's loss on the
device and reads the epoch's losses back once.

With a ``mesh`` (``parallel/mesh.py``) every rank runs this trainer on its
own shard of each loader (``mesh.batch_sharding``). Training steps in
lockstep (``mesh_groups``: every rank takes the longest shard's number of
steps, one without rows that step taking part with none); a step gathers
the FSDP shards, divides the rank's loss sum by the step's global count of
real questions, reduces the gradients and steps the masters
(``ShardedParams``). Every rank takes the chunk boundaries one device
would take for the global batches (``mesh_groups``: the ranks agree on
each global batch's spec, program shapes and unique-image count), and
checkpoints fall at those boundaries; the steps of a chunk run eagerly,
one step at a time, with no CUDA graph (gloo cannot be captured, and each
step's exchange of sizes and keys is a host collective).
Every batch under the mesh carries its global batch's reductions over the
question axis (``types.batch_flags``, exchanged with the keys), so a rank
computes its rows as one device computes them in the global batch.
Evaluation under the mesh takes one batch at a time in lockstep, sums the
error counts over the data axis and gathers predictions and hardset entries in
the order one device would hold them (``interleave``). Rank 0 alone
writes files: checkpoints (the whole leaves, gathered), predictions,
hardsets, ``losses.npy``; it alone reads a checkpoint back and broadcasts
it (``load``).
"""

from __future__ import annotations

import copy
import json
import logging
import os
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dfol_vqa_tpu_torch.compiler.program_compiler import pack_meta
from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.data.features import PAD_LADDER
from dfol_vqa_tpu_torch.data.loader import LoadedBatch
from dfol_vqa_tpu_torch.data.transfer import chunk_prefetch, to_device_batch
from dfol_vqa_tpu_torch.models.interpreter import (
    Interpreter,
    decode_answer_flags,
    question_type_of,
)
from dfol_vqa_tpu_torch.models.oracle import OracleParams
from dfol_vqa_tpu_torch.parallel.mesh import Mesh, ShardedParams, broadcast_params, shard_params
from dfol_vqa_tpu_torch.train import checkpoint as ckpt
from dfol_vqa_tpu_torch.train.graphs import GraphCache, param_key
from dfol_vqa_tpu_torch.train.optim import Optimizer, build_optimizer, require_grads
from dfol_vqa_tpu_torch.types import QuestionType, batch_flags
from dfol_vqa_tpu_torch.utils.profiling import span

# per-terminal-op metric buckets (reference trainer.py:64-83)
OP_INDEX = OrderedDict(
    [
        ("query_attr", 1), ("choose_attr", 2), ("verify_attrs", 3), ("choose_rel", 4),
        ("verify_rel", 5), ("exist", 6), ("and", 7), ("or", 8), ("all_same", 9),
        ("all_different", 10), ("two_same", 11), ("two_different", 12), ("compare", 13),
        ("object_attr", 14), ("object_rel", 15), ("scene", 16),
    ]
)
ERROR_DIM = len(OP_INDEX) + 1

U_KEYS = ("obj_geom", "obj_scale")  # program tensors whose leading axis is U_pad


def mesh_group_key(batch: LoadedBatch) -> tuple:
    """A rank's part of the global batch's ``group_key``: the spec, the
    shapes of the program tensors indexed by question, the object shape
    past U, and the batch's image ids (the union's count gives U)."""
    shapes = tuple((k, shape, dtype) for k, shape, dtype, _ in batch.meta[:-1]
                   if k not in U_KEYS)
    return (batch.spec, shapes, tuple(batch.objects.shape[1:]),
            tuple(batch.compiled.image_ids))


def global_group_key(parts: Sequence[tuple]) -> tuple:
    """The global batch's ``group_key`` from the live ranks'
    ``mesh_group_key``s: one device's batch of those rows differs from
    another in spec, meta or object shape exactly where this does (its
    meta's U entries and offsets follow from U_pad)."""
    spec, shapes, rest, _ = parts[0]
    U = len({im for p in parts for im in p[3]})
    u_pad = next((v for v in PAD_LADDER if U <= v), U)
    return (spec, shapes, rest, u_pad)


def with_global_flags(batch: LoadedBatch, parts: Sequence[dict]) -> LoadedBatch:
    """``batch`` (a data rank's rows) carrying, in its arrays, its global
    batch's reductions over the question axis: the OR of the data ranks'
    ``types.batch_flags`` ``parts``."""
    batch.arrays.update({k: np.bitwise_or.reduce([p[k] for p in parts]) for k in parts[0]})
    batch.meta = pack_meta(batch.arrays)
    return batch


def _shapes(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def interleave(per_rank: Sequence[Sequence[Sequence]]) -> List:
    """Each data rank's per-batch lists of per-question items -> one list in
    the order one device holds them: batch by batch, and inside a batch row
    k of every rank before row k + 1 (the loader deals a file's questions
    to the ranks in turn). One rank: its items in order."""
    out: List = []
    for t in range(max((len(b) for b in per_rank), default=0)):
        rows = [b[t] if t < len(b) else [] for b in per_rank]
        for k in range(max(len(r) for r in rows)):
            out.extend(r[k] for r in rows if k < len(r))
    return out


def readback(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Device tensors -> float32 numpy arrays of the same shapes, with one
    device-to-host copy for all of them."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).float() for t in tensors]).cpu().numpy()
    parts = np.split(flat, np.cumsum([t.numel() for t in tensors])[:-1])
    return [p.reshape(tuple(t.shape)) for p, t in zip(parts, tensors)]


class VQATrainer:
    """Trains and evaluates on one device (``device``, default the card:
    CPU callers pass ``device="cpu"``), or on this rank's device of
    ``mesh``; ``params`` passed to its methods live on that device and are
    the whole tree (the same on every rank)."""

    def __init__(
        self,
        cfg: Config,
        interpreter: Interpreter,
        logger: Optional[logging.Logger] = None,
        hardset_path: Optional[str] = None,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        self.cfg = cfg
        self.interp = interpreter
        self.logger = logger or logging.getLogger("dfol_vqa_tpu_torch")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.global_step = 0
        self.last_test_counts: Optional[np.ndarray] = None
        self._hardset_path = hardset_path
        self._hardset: Optional[dict] = None
        self._easyset: Optional[dict] = None
        self._best_error = np.inf
        # training groups (lone steps too) and eval chunks as CUDA graphs on one
        # card; eager on the CPU and under a mesh
        self.graphs = GraphCache(self.device, capture=mesh is None)
        self.train_graph_stats: Optional[dict] = None  # the graphs' stats at train()'s end
        # the train.step spans' tags: the parameter elements that require a
        # gradient and all of them, counted by each train() call
        self._elems: Dict[str, int] = {}
        self._eval_params: Optional[tuple] = None  # (tree, param_key) the eval graphs read

    # ------------------------------------------------------------- utilities

    def _prepare_output_metric_dict(self, error: np.ndarray) -> dict:
        return dict(zip(["over_all"] + list(OP_INDEX.keys()), error.flatten().tolist()))

    @property
    def writes_files(self) -> bool:
        return self.mesh is None or self.mesh.writes_files

    def decode_answers(self, flags: np.ndarray, batch: LoadedBatch) -> List[List[str]]:
        """Answer flags (host) -> answer-string lists (ties kept, in option
        order), as the serving engine decodes them."""
        return decode_answer_flags(flags, batch.spec, batch.compiled)

    # ------------------------------------------------------------------ train

    def compute_grads(self, params: OracleParams, batch: LoadedBatch,
                      generator: Optional[torch.Generator] = None,
                      count: Optional[int] = None, shares: int = 1) -> torch.Tensor:
        """Forward and backward on ``batch``: sets the ``.grad`` of
        ``params`` (a gradient buffer that exists is zeroed and accumulated
        into in place; None stays for a parameter the batch does not reach)
        and returns the loss normalised by ``count`` real questions
        (default: the batch's), a 0-d tensor on the device (not read back).
        The backward runs on ``1 / shares`` of it."""
        _, objects, obj_mask, arrays = to_device_batch(batch, self.device)
        return self._grads(params, objects, obj_mask, arrays, batch.spec, generator, count,
                           shares)

    def _grads(self, params: OracleParams, objects, obj_mask, arrays, spec,
               generator: Optional[torch.Generator] = None, count: Optional[int] = None,
               shares: int = 1) -> torch.Tensor:
        """``compute_grads`` on a batch already on the device."""
        for p in params.parameters():
            if p.grad is not None:
                p.grad.zero_()
        out = self.interp.forward(params, objects, obj_mask, arrays, spec,
                                  is_training=True, generator=generator)
        n = (torch.clamp(torch.sum(arrays["question_mask"]), min=1.0) if count is None
             else max(count, 1))
        loss = out["loss"] / n
        (loss / shares).backward()
        return loss.detach()

    def _train_chunk(self, params: OracleParams, opt: Optimizer, group: List[LoadedBatch],
                     objects: torch.Tensor, obj_mask: torch.Tensor,
                     arrays: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """The k steps of a group of k >= 1 batches (stacked tensors), each
        ``_grads`` then ``opt.step()``, through ``self.graphs`` (one CUDA
        graph per key on one card), as the JAX package's
        ``_train_step_chunk`` or, for a lone batch, its one-step path. Every
        device runs these steps and only these (the module docstring: the
        JAX package's padded steps are no-ops). Returns the k losses on the
        device."""
        b0 = group[0]
        k = len(group)
        names = sorted(arrays)
        inputs = [objects, obj_mask] + [arrays[n] for n in names]

        def steps(objects, obj_mask, *rest):
            losses = []
            for i in range(k):
                loss = self._grads(params, objects[i], obj_mask[i],
                                   {n: t[i] for n, t in zip(names, rest)}, b0.spec, generator)
                opt.step()
                losses.append(loss)
            return (torch.stack(losses) if k > 1 else losses[0][None],)

        key = ("train", b0.spec, b0.meta, _shapes(inputs), k, id(opt), param_key(params))
        gen = generator if self.cfg.dropout > 0 else None
        (losses,) = self.graphs.run(key, steps, inputs, generator=gen)
        return losses

    def train_step(self, params, opt: Optimizer, batch: Optional[LoadedBatch],
                   generator: Optional[torch.Generator] = None,
                   count: Optional[int] = None) -> torch.Tensor:
        """``compute_grads``, then one optimizer step; returns the loss.
        Only the trainable parameters require a gradient (``require_grads``).

        Under the mesh ``params`` is the ``ShardedParams``, ``batch`` this
        rank's rows (None: none this step) and ``count`` the step's count of
        real questions over the data axis (``mesh_groups``); the loss returned
        is this rank's sum over that count, and the data axis's sum of them
        the step's loss."""
        if self.mesh is None:
            require_grads(params, self.cfg)
            loss = self.compute_grads(params, batch, generator)
            opt.step()
            return loss
        working = params.gather()
        require_grads(working, self.cfg)
        if batch is None:
            for p in working.parameters():
                p.grad = None
            loss = torch.zeros((), device=self.device)
        else:  # every rank of a model group backpropagates its share
            loss = self.compute_grads(working, batch, generator, count, self.mesh.n_model)
        params.reduce_grads()
        opt.step()
        params.release()
        return loss

    def mesh_groups(self, loader, chunk: int
                    ) -> Iterator[List[Tuple[Optional[LoadedBatch], int]]]:
        """Under the mesh: the steps of an epoch over ``loader``, as lists
        of (batch, real questions of the step over the data axis) in the
        chunks one device would take for the global batches. Every rank
        takes as many steps as the longest shard, a rank whose shard has
        run out with None. Each step the ranks exchange their batch's
        ``mesh_group_key``, size and ``types.batch_flags`` (one host
        collective); a chunk closes where the global key changes or at
        ``chunk`` steps. Each batch carries its global batch's flags
        (``with_global_flags``), so the executor's reductions over the
        question axis see every data rank's rows, as JAX's do."""
        it = iter(loader)
        buf: List[Tuple[Optional[LoadedBatch], int]] = []
        key = None
        while True:
            batch = next(it, None)
            parts = [p for p in self.mesh.gather_objects(
                None if batch is None
                else (batch.batch_size, mesh_group_key(batch), batch_flags(batch.arrays)))
                if p is not None]
            if not parts:
                break
            if batch is not None:
                with_global_flags(batch, [p[2] for p in parts])
            step_key = global_group_key([p[1] for p in parts])
            if buf and step_key != key:
                yield buf
                buf = []
            key = step_key
            buf.append((batch, sum(p[0] for p in parts)))
            if len(buf) >= chunk:
                yield buf
                buf = []
        if buf:
            yield buf

    def _train_groups(self, loader, state, opt: Optimizer,
                      generator: Optional[torch.Generator]
                      ) -> Iterator[Tuple[List[torch.Tensor], List[int]]]:
        """Trains an epoch over ``loader`` group by group; yields each
        group's (step losses on the device, real questions per step) after
        its last step. Each group's dispatch is a ``train.step`` span
        (``utils/profiling``; tagged with ``train``'s ``_elems`` and the
        ``route`` the graph cache took), each lockstep step under the mesh
        one (``route`` "eager")."""
        chunk = max(1, self.cfg.tpu.train_chunk)
        elems = self._elems
        if self.mesh is not None:
            for group in self.mesh_groups(loader, chunk):
                losses = []
                for batch, count in group:
                    with span("train.step", steps=1, route="eager", **elems):
                        losses.append(self.train_step(state, opt, batch, generator, count))
                yield losses, [count for _, count in group]
            return
        for group, objects, obj_mask, arrays in chunk_prefetch(loader, chunk, self.device):
            with span("train.step", steps=len(group), **elems) as s:
                losses = self._train_chunk(state, opt, group, objects, obj_mask, arrays,
                                           generator)
                s.tags["route"] = self.graphs.last_route
            yield list(losses), [b.batch_size for b in group]

    def train(
        self,
        train_loader,
        validation_loader,
        params: OracleParams,
        *,
        metric_index: int = 0,
        last_export_path_base: Optional[str] = None,
        best_export_path_base: Optional[str] = None,
        seed: int = 0,
        load_model: Optional[str] = None,
        reset_step: bool = False,
    ) -> Tuple[OracleParams, np.ndarray, np.ndarray]:
        """``cfg.repetition_num`` x ``cfg.epoch_num`` epochs over
        ``train_loader``, updating ``params`` in place; returns
        (params, errors (ERROR_DIM, epochs, reps), losses (epochs, reps)), as
        the JAX trainer does. Each call first sets every parameter's
        ``requires_grad`` from the freeze flags (``optim.require_grads``), so
        the frozen parts build no graph and get no gradient.

        Per repetition ``load_model`` ("best"/"last") reloads that checkpoint
        (a missing file is skipped) and ``reset_step`` zeroes the step; the
        optimizer state carries over. Per epoch: the loss is the
        question-weighted mean of the step losses; with ``validation_loader``
        the epoch's error vector comes from ``test_epoch``, a lower
        ``errors[metric_index]`` saves "best", and every
        ``checkpointing_frequency`` steps a mid-epoch validation saves "last"
        (and "best" when not worse). "last" is saved synchronously in a
        ``finally`` after every epoch, so a step that raises still leaves the
        last good parameters on disk. ``losses.npy`` and ``errors.npy`` go to
        ``best_export_path_base``.

        Steps run in chunks of same-bucket batches (the module docstring),
        and ``checkpointing_frequency`` is checked after each chunk, at the
        global steps the JAX trainer checks it. One difference remains:
        randomness (dropout masks) comes from a ``torch.Generator`` seeded
        with ``seed``, so with dropout on the masks differ from JAX's (the
        benchmark's training cells run at ``dropout=0.1``, as their stage
        files do).

        Under the mesh ``params`` (the same on every rank; rank 0's are
        broadcast) is split into a ``ShardedParams`` for the run and gets
        the trained values back at its end; each rank's generator is seeded
        from (``seed``, its data rank)."""
        cfg, mesh = self.cfg, self.mesh
        require_grads(params, cfg)  # a mesh's working tree copies the flags
        self._elems = {"grad_elems": sum(p.numel() for p in params.parameters()
                                         if p.requires_grad),
                       "param_elems": sum(p.numel() for p in params.parameters())}
        state = shard_params(mesh, params) if mesh is not None else params
        opt = build_optimizer(cfg, params, state if mesh is not None else None)
        if mesh is None:
            opt.static_grads()
        self.graphs.drop("train")  # a graph of another run steps another optimizer
        try:
            return self._train(train_loader, validation_loader, params, state, opt,
                               metric_index, last_export_path_base, best_export_path_base,
                               seed, load_model, reset_step)
        finally:
            self.train_graph_stats = self.graphs.stats()
            self.graphs.drop("train")

    def _train(self, train_loader, validation_loader, params, state, opt, metric_index,
               last_export_path_base, best_export_path_base, seed, load_model, reset_step):
        cfg, mesh = self.cfg, self.mesh
        generator = torch.Generator(device=self.device).manual_seed(
            mesh.seed(seed) if mesh is not None else seed)
        errors = np.zeros((ERROR_DIM, cfg.epoch_num, cfg.repetition_num), np.float32)
        losses = np.zeros((cfg.epoch_num, cfg.repetition_num), np.float32)
        self._best_error = np.inf

        for rep in range(cfg.repetition_num):
            ckpt.wait_pending()  # a reload must see complete files
            path = {"best": best_export_path_base, "last": last_export_path_base}.get(load_model)
            if path:
                try:
                    if mesh is None:
                        self._load_into(path, params)
                    else:  # rank 0's file on every rank, each taking its own part
                        state.load_full(self.load(path, params))
                except FileNotFoundError:
                    pass
            if reset_step:
                self.global_step = 0
            for epoch in range(cfg.epoch_num):
                start = time.time()
                try:
                    step_losses: List[torch.Tensor] = []
                    sizes: List[int] = []
                    next_ckpt = self.global_step + cfg.checkpointing_frequency
                    for group_losses, counts in self._train_groups(train_loader, state, opt,
                                                                   generator):
                        step_losses += group_losses
                        sizes += counts
                        self.global_step += len(counts)
                        if validation_loader is not None and self.global_step >= next_ckpt:
                            next_ckpt = self.global_step + cfg.checkpointing_frequency
                            self._checkpoint_mid_epoch(validation_loader, state, metric_index,
                                                       last_export_path_base,
                                                       best_export_path_base)
                    if step_losses:
                        with span("train.readback"):
                            ls = torch.stack(step_losses)
                            if mesh is not None:
                                dist.all_reduce(ls, group=mesh.data_group)
                            ls = readback([ls])[0]
                        losses[epoch, rep] = float(ls @ np.asarray(sizes, np.float64)) / max(
                            sum(sizes), 1)
                    if validation_loader is not None:
                        errors[:, epoch, rep] = self.test_epoch(validation_loader, state)
                finally:
                    if last_export_path_base:
                        ckpt.wait_pending()
                        self._save(last_export_path_base, state, sync=True)
                if (validation_loader is not None and best_export_path_base
                        and errors[metric_index, epoch, rep] < self._best_error):
                    self._best_error = errors[metric_index, epoch, rep]
                    self._save(best_export_path_base, state)
                if cfg.verbose:
                    self.logger.info(
                        "Rep %d, Epoch %d: Step %d, Best Err %.5f: error=%s, loss=%.5f (%.1fs)",
                        rep + 1, epoch + 1, self.global_step, self._best_error,
                        self._prepare_output_metric_dict(errors[:, epoch, rep]),
                        losses[epoch, rep], time.time() - start)

        ckpt.wait_pending()  # every asynchronous write is on disk before returning
        if mesh is not None:
            state.copy_into(params)
        if best_export_path_base and self.writes_files:
            os.makedirs(best_export_path_base, exist_ok=True)
            np.save(os.path.join(best_export_path_base, "losses"), losses, allow_pickle=False)
            np.save(os.path.join(best_export_path_base, "errors"), errors, allow_pickle=False)
        return params, errors, losses

    def _checkpoint_mid_epoch(self, validation_loader, params: OracleParams, metric_index: int,
                              last_export_path_base: Optional[str],
                              best_export_path_base: Optional[str]) -> None:
        """Validate, save "last", and "best" when the error is not worse."""
        err = self.test_epoch(validation_loader, params)
        if last_export_path_base:
            self._save(last_export_path_base, params)
        if best_export_path_base and err[metric_index] <= self._best_error:
            self._best_error = err[metric_index]
            self._save(best_export_path_base, params)
        if self.cfg.verbose:
            self.logger.info("Checkpointing: Step %d, Best Err %.5f: error=%s", self.global_step,
                             self._best_error, self._prepare_output_metric_dict(err))

    def _eval_chunked(self, loader, params
                      ) -> Iterator[Tuple[LoadedBatch, Dict[str, torch.Tensor]]]:
        """(batch, outputs on the device: ``log_probability``, ``match``,
        ``answer_flags``) for every batch of ``loader``, in order. A group of
        one batch runs ``Interpreter.forward``; a group of k >= 2 runs its k
        forwards through ``forward_many``, one CUDA graph per key on one
        card, as the JAX package's ``_eval_chunked``. ``params`` is the
        whole tree or, under the mesh, a ``ShardedParams`` (its gathered
        working tree is read).

        The eval graphs belong to one parameter tree: evaluating another
        drops them, and the trainer holds the tree they read, so its tensors
        keep their addresses while the graphs live.

        Under the mesh the ranks take the batches in lockstep
        (``mesh_groups``, one batch at a time), each with its global batch's
        flags, and run each with ``Interpreter.forward``."""
        if isinstance(params, ShardedParams):
            params = params.gather()
        if self.mesh is not None:
            for ((batch, _),) in self.mesh_groups(loader, 1):
                if batch is not None:
                    _, objects, obj_mask, arrays = to_device_batch(batch, self.device)
                    with torch.inference_mode():
                        yield batch, self.interp.forward(params, objects, obj_mask, arrays,
                                                         batch.spec)
            return
        owner = (params, param_key(params))
        if self._eval_params is None or self._eval_params[0] is not params or \
                self._eval_params[1] != owner[1]:
            self.graphs.drop("eval")
            self._eval_params = owner
        chunk = max(1, self.cfg.tpu.eval_chunk)
        for group, objects, obj_mask, arrays in chunk_prefetch(loader, chunk, self.device):
            b0 = group[0]
            if len(group) == 1:
                with torch.inference_mode():
                    out = self.interp.forward(params, objects[0], obj_mask[0],
                                              {k: v[0] for k, v in arrays.items()}, b0.spec)
                yield b0, out
                continue
            names = sorted(arrays)
            inputs = [objects, obj_mask] + [arrays[n] for n in names]

            def forwards(objects, obj_mask, *rest):
                with torch.inference_mode():
                    out = self.interp.forward_many(params, objects, obj_mask,
                                                   dict(zip(names, rest)), b0.spec)
                return out["log_probability"], out["match"], out["answer_flags"]

            key = ("eval", b0.spec, b0.meta, _shapes(inputs))
            lp, match, flags = self.graphs.run(key, forwards, inputs)
            for i, batch in enumerate(group):
                yield batch, {"log_probability": lp[i], "match": match[i],
                              "answer_flags": flags[i]}

    # ------------------------------------------------------------------- test

    def test_epoch(self, loader, params) -> np.ndarray:
        """One evaluation pass with 17-bucket error accounting: returns the
        error rate per bucket (0 for an empty bucket); the per-bucket
        question counts land in ``last_test_counts``. Under the mesh the
        counts are summed over the data axis."""
        batches: List[LoadedBatch] = []
        matches: List = []
        mined: List[List[tuple]] = []
        for batch, out in self._eval_chunked(loader, params):
            batches.append(batch)
            if self._hardset is not None:
                match = readback([out["match"]])[0] * batch.compiled.question_mask
                mined.append(self._mine_hardset(batch, match))
                matches.append(match)
            else:
                matches.append(out["match"])
        if self._hardset is None:
            matches = readback(matches)
        error = np.zeros(ERROR_DIM, np.float32)
        total = np.zeros(ERROR_DIM, np.float32)
        for batch, match in zip(batches, matches):
            qm = batch.compiled.question_mask
            match = match * qm
            n = qm.sum()
            err = float(n - match.sum())
            # terminals without a bucket (e.g. 'end') count toward over_all only
            op_i = OP_INDEX.get(batch.spec.terminal_op)
            error[0] += err
            total[0] += n
            if op_i is not None:
                error[op_i] += err
                total[op_i] += n
        if self.mesh is not None:
            sums = self.mesh.host_sum(np.concatenate([error, total]))
            error, total = sums[:ERROR_DIM].astype(np.float32), sums[ERROR_DIM:].astype(np.float32)
        if self._hardset is not None:
            self._write_hardset(self._gather(mined))
        self.last_test_counts = total.copy()
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(total > 0, error / np.maximum(total, 1), 0.0)

    def test(self, loader, params: OracleParams, import_path_base: Optional[str] = None):
        """``test_epoch`` (after loading ``import_path_base`` when given)
        with hardset dumps; returns (error, seconds)."""
        if import_path_base is not None:
            params = self.load(import_path_base, params)
        if self._hardset_path is not None:
            self._hardset, self._easyset = {}, {}
        start = time.time()
        error = self.test_epoch(loader, params)
        duration = time.time() - start
        if self._hardset_path is not None:
            self._dump_hardsets()
        if self.cfg.verbose:
            self.logger.info("error=%s", self._prepare_output_metric_dict(error))
            self.logger.info("Time spent: %s seconds", duration)
        return error, duration

    # ---------------------------------------------------------------- predict

    def predict(self, loader, params, out_file,
                import_path_base: Optional[str] = None, is_submission: bool = False):
        """Predictions for every real question, written to ``out_file`` as
        JSON and returned. Under the mesh every rank returns all of them and
        rank 0 alone writes (``out_file`` may be None on the others)."""
        if import_path_base is not None:
            params = self.load(import_path_base, params)
        batches, flags = [], []
        for batch, out in self._eval_chunked(loader, params):
            batches.append(batch)
            flags.append(out["answer_flags"])
        per_batch: List[List[dict]] = []
        for batch, f in zip(batches, readback(flags)):
            predictions: List[dict] = []
            per_batch.append(predictions)
            answers = self.decode_answers(f > 0.5, batch)
            qtype = question_type_of(batch.spec.terminal_op)
            qm = batch.compiled.question_mask
            for qi, qid in enumerate(batch.compiled.question_ids):
                if qm[qi] == 0:
                    continue
                ans = answers[qi]
                if is_submission:
                    predictions.append({"questionId": qid, "prediction": ans[0] if ans else ""})
                elif qtype == QuestionType.QUERY:
                    predictions.append({
                        "questionId": qid,
                        "prediction": ans,
                        "type": "open" if batch.spec.terminal_op == "query_attr" else "binary",
                        "options": batch.compiled.option_strings[qi],
                    })
                else:
                    predictions.append({"questionId": qid,
                                        "prediction": ans[0] if ans else "",
                                        "type": "binary"})
        predictions = self._gather(per_batch)
        if self.writes_files:
            json.dump(predictions, out_file)
        return predictions

    def _gather(self, per_batch: List[List]) -> List:
        """This rank's per-batch item lists -> every data rank's items in
        one device's order (``interleave``)."""
        per_rank = [per_batch] if self.mesh is None else self.mesh.gather_objects(per_batch)
        return interleave(per_rank)

    # ---------------------------------------------------------------- hardset

    def _mine_hardset(self, batch: LoadedBatch, match: np.ndarray) -> List[tuple]:
        """(terminal op, question id, question, hard) of each real question
        of ``batch``; none when the batch kept no original questions."""
        if batch.compiled.original is None:
            return []
        op = batch.spec.terminal_op
        return [(op, batch.compiled.question_ids[qi], q, bool(match[qi] < 1.0))
                for qi, q in enumerate(batch.compiled.original)
                if batch.compiled.question_mask[qi] != 0]

    def _write_hardset(self, entries: List[tuple]) -> None:
        """Record mined entries in the hard/easy sets and, on the rank that
        writes files, append each to ``hard/hard_<op>.json`` or
        ``easy/easy_<op>.json`` (both files exist for every op mined)."""
        for _, qid, q, hard in entries:
            (self._hardset if hard else self._easyset)[qid] = q
        if not (entries and self.writes_files):
            return
        lines: Dict[str, List[str]] = {}
        for op, _, q, hard in entries:
            for kind in ("hard", "easy"):
                lines.setdefault(os.path.join(kind, f"{kind}_{op}.json"), [])
            kind = "hard" if hard else "easy"
            lines[os.path.join(kind, f"{kind}_{op}.json")].append(json.dumps(q))
        for kind in ("hard", "easy"):
            os.makedirs(os.path.join(self._hardset_path, kind), exist_ok=True)
        for name, rows in lines.items():
            with open(os.path.join(self._hardset_path, name), "a") as f:
                f.write("".join(r + "\n" for r in rows))

    def _dump_hardsets(self):
        if not self.writes_files:
            return
        with open(os.path.join(self._hardset_path, "hard.json"), "w") as f:
            json.dump(self._hardset, f)
        with open(os.path.join(self._hardset_path, "easy.json"), "w") as f:
            json.dump(self._easyset, f)

    # ------------------------------------------------------------ checkpoints

    def _save(self, export_path_base: str, params, sync: bool = False) -> None:
        ckpt.save(export_path_base, self.cfg.model_name, params, self.global_step,
                  backend=self.cfg.tpu.checkpoint_backend,
                  async_write=self.cfg.tpu.async_save and not sync)

    def load(self, import_path_base: str, params: OracleParams) -> OracleParams:
        """The checkpoint as a new tree shaped as ``params``, and its step
        into ``global_step``. Under the mesh rank 0 alone reads the file,
        once its own writes are on disk, and broadcasts it, so every rank
        holds the same values (a missing file raises on every rank)."""
        if self.mesh is None:
            params, self.global_step = ckpt.load(import_path_base, self.cfg.model_name, params)
            return params
        step = None
        if self.mesh.writes_files:
            ckpt.wait_pending()
            try:
                params, step = ckpt.load(import_path_base, self.cfg.model_name, params)
            except FileNotFoundError:
                pass
        else:
            params = copy.deepcopy(params)
        step = self.mesh.broadcast_object(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint {self.cfg.model_name} under "
                                    f"{import_path_base}")
        self.global_step = step
        return broadcast_params(params)

    def _load_into(self, import_path_base: str, params: OracleParams) -> None:
        """``load``, copied into ``params`` in place (the optimizer holds
        references to its tensors)."""
        loaded = dict(self.load(import_path_base, params).named_parameters())
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(loaded[name])
