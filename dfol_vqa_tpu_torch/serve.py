"""Online serving engine: continuous batching for ∇-FOL inference, in PyTorch.

Port of ``dfol_vqa_tpu/serve.py``. The host side is the JAX package's:

* **Grid canonicalization.** Every compiled group is re-padded onto a
  canonical grid ``SELECT (FILTER^F RELATE)^S FILTER^F`` with ``S``/``F``
  from small ladders; inserted slots carry ``op_mask = 0`` / ``tok = 0`` and
  are exact no-ops in the executor.
* **Batch-axis ladder.** Request groups are padded to the next ladder size
  by repeating row 0 with ``question_mask = 0``; padded rows are decoded
  and dropped.
* **Queues per canonical spec.** ``submit`` compiles and canonicalizes on
  the caller's thread (memoized in an LRU plan cache) and queues the request
  under its canonical ``BucketSpec``. A queue flushes at ``max_batch`` or
  when its oldest request has waited ``max_delay_ms``. ``max_pending``
  bounds the queued requests (admission control: ``EngineOverloaded``).

**Steps per (spec, meta).** A batch runs through one step callable per
canonical spec and packing descriptor: ``_make_step`` (answer flags) and
``_make_trace_step`` (plus the log-probabilities and the hop-by-hop
attentions). A step takes the parameters as an input, a dict of tensors by
name (``param_tensors``), so one exported step serves any weights of the
same configuration. Live, a step is the eager ``Interpreter.forward``; an
engine built with ``executables`` (``export.load_serving_set``) runs the
loaded ``torch.export`` programs instead and never calls the interpreter.
``warmup`` runs every (spec, batch rung) once, which builds the CUDA kernel
and warms the libraries before traffic arrives. The dispatcher thread only
enqueues device work (CUDA launches are asynchronous); a small completion
pool reads the answer flags back — the completion barrier — and resolves
the futures, so consecutive groups overlap on the device. ``trace``
answers one question at batch rung 1 with its hop-by-hop attentions.

**Serving over a device mesh** (``mesh=parallel.mesh.make_local_mesh(...)``,
JAX's ``ServingEngine(mesh=...)``), one process driving every device of
the mesh, no process group:

* Each data row of the mesh holds one replica of the parameters on its
  lead (model 0) device (``mesh.serving_replicas``). On a model axis the
  concept heads are split along the vocabulary over the row's model
  devices when the model size divides V_pad (``param_sharding``, JAX's
  rule; ``mesh.VocabShards``); every other leaf is whole on the lead.
* Each group runs whole on one data row, the rows taking turns. JAX
  splits a batch's rows over ``data`` where the data size divides the
  batch and computes it replicated otherwise; the answers are the same
  either way. CUDA launches are asynchronous, so on several cards
  consecutive groups run side by side.
* ``warmup`` runs every (spec, rung) on every data row; ``trace`` runs on
  one data row with the split head. Exported steps (``executables``) are
  single-device and refused with a mesh, as ``export_serving_set``
  refuses a mesh engine.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dfol_vqa_tpu_torch.compiler.program_compiler import (
    OP_FILTER,
    OP_RELATE,
    OP_SELECT,
    SUPERVISION_OPS,
    BucketSpec,
    CompiledBatch,
    ProgramCompiler,
    _pad_ladder,
)
from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.data.loader import LoadedBatch
from dfol_vqa_tpu_torch.ontology import GQAOntology
from dfol_vqa_tpu_torch.data.transfer import to_device_batch
from dfol_vqa_tpu_torch.models.interpreter import Interpreter, decode_answer_flags
from dfol_vqa_tpu_torch.models.oracle import OracleParams
from dfol_vqa_tpu_torch.parallel.mesh import serving_replicas

# ------------------------------------------------------- parameters as inputs


def param_tensors(params: OracleParams) -> Dict[str, torch.Tensor]:
    """The parameters by name, sorted (the step's first input)."""
    return {k: p.detach() for k, p in sorted(params.named_parameters())}


def bind_params(module: torch.nn.Module, tensors: Dict[str, torch.Tensor],
                prefix: str = "") -> torch.nn.Module:
    """A shallow copy of ``module`` whose parameters are ``tensors`` (keyed
    as ``param_tensors`` names them); ``module`` is not changed, so threads
    may bind the same parameters at once. Every parameter must be given."""
    clone = copy.copy(module)
    clone._parameters = {n: None if p is None else tensors[prefix + n]
                         for n, p in module._parameters.items()}
    clone._modules = {n: None if m is None else bind_params(m, tensors, f"{prefix}{n}.")
                      for n, m in module._modules.items()}
    return clone


# ----------------------------------------------------------- canonical grids


def branch_structure(grid: Sequence[int]) -> Tuple[int, int]:
    """(n_relate_segments, max_fillers_per_segment) of one branch grid;
    OP_PAD columns do not participate."""
    segs, max_fill, cur = 0, 0, 0
    for op in grid:
        if op == OP_FILTER:
            cur += 1
        elif op == OP_RELATE:
            max_fill = max(max_fill, cur)
            cur = 0
            segs += 1
    return segs, max(max_fill, cur)


def canonical_grid(S: int, F: int) -> Tuple[int, ...]:
    g: List[int] = [OP_SELECT]
    for _ in range(S):
        g.extend([OP_FILTER] * F + [OP_RELATE])
    g.extend([OP_FILTER] * F)
    return tuple(g)


def _slot_mapping(grid: Sequence[int], F: int) -> Dict[int, int]:
    """Map each real slot of a merged grid to its position in
    ``canonical_grid(S, F)`` (OP_PAD slots are dropped)."""
    mapping: Dict[int, int] = {}
    seg, fill = 0, 0
    for si, op in enumerate(grid):
        if op == OP_SELECT:
            mapping[si] = 0
        elif op == OP_FILTER:
            mapping[si] = 1 + seg * (F + 1) + fill
            fill += 1
        elif op == OP_RELATE:
            mapping[si] = 1 + seg * (F + 1) + F
            seg += 1
            fill = 0
    return mapping


_GRID_FIELDS = ("op_mask", "arg_tok", "arg_aux", "arg_flag", "rel_idx")


def canonicalize_batch(
    spec: BucketSpec,
    cb: CompiledBatch,
    seg_ladder: Sequence[int] = (0, 1, 2, 3),
    fill_ladder: Sequence[int] = (0, 1, 2, 4),
) -> Tuple[BucketSpec, CompiledBatch]:
    """Re-pad a compiled batch onto the canonical slot grid (exact: inserted
    slots carry op_mask = 0 / tok = 0)."""
    if spec.terminal_op in SUPERVISION_OPS:
        return spec, cb
    S = _pad_ladder(max((branch_structure(g)[0] for g in spec.grid), default=0), seg_ladder)
    F = _pad_ladder(max((branch_structure(g)[1] for g in spec.grid), default=0), fill_ladder)
    G = canonical_grid(S, F)
    if all(g == G for g in spec.grid):
        return spec, cb
    B, nb, _ = cb.op_mask.shape
    L2 = len(G)
    new = {f: np.zeros((B, nb, L2), getattr(cb, f).dtype) for f in _GRID_FIELDS}
    for b, grid in enumerate(spec.grid):
        for old, pos in _slot_mapping(grid, F).items():
            for f in _GRID_FIELDS:
                new[f][:, b, pos] = getattr(cb, f)[:, b, old]
    return dataclasses.replace(spec, grid=(G,) * nb), dataclasses.replace(cb, **new)


def pad_batch_rows(spec: BucketSpec, cb: CompiledBatch, batch_size: int
                   ) -> Tuple[BucketSpec, CompiledBatch]:
    """Pad the question axis to ``batch_size`` by repeating row 0 with
    ``question_mask = 0`` (valid tokens, so every index stays in range)."""
    B = spec.batch_size
    pad = batch_size - B
    if pad <= 0:
        return spec, cb
    updates: Dict[str, object] = {}
    for f in dataclasses.fields(CompiledBatch):
        v = getattr(cb, f.name)
        if isinstance(v, np.ndarray):
            updates[f.name] = np.concatenate([v, np.repeat(v[:1], pad, axis=0)], axis=0)
        elif isinstance(v, list) and len(v) == B:
            updates[f.name] = v + [v[0]] * pad
    updates["question_mask"] = np.concatenate([cb.question_mask, np.zeros((pad,), np.float32)])
    return (dataclasses.replace(spec, batch_size=batch_size),
            dataclasses.replace(cb, **updates))


def concat_batches(spec: BucketSpec, cbs: Sequence[CompiledBatch]
                   ) -> Tuple[BucketSpec, CompiledBatch]:
    """Concatenate same-spec compiled batches along the question axis."""
    if len(cbs) == 1:
        return spec, cbs[0]
    B = sum(len(c.question_mask) for c in cbs)
    updates: Dict[str, object] = {}
    for f in dataclasses.fields(CompiledBatch):
        vs = [getattr(c, f.name) for c in cbs]
        if isinstance(vs[0], np.ndarray):
            updates[f.name] = np.concatenate(vs, axis=0)
        elif isinstance(vs[0], list):
            updates[f.name] = [x for v in vs for x in v]
    return dataclasses.replace(spec, batch_size=B), dataclasses.replace(cbs[0], **updates)


# ------------------------------------------------------------------- engine


class EngineOverloaded(RuntimeError):
    """Raised by ``submit`` when ``max_pending`` requests are already queued:
    new arrivals fail fast (retryable) instead of joining an unbounded
    queue."""


@dataclass
class ServeResult:
    answers: List[str]  # tie-kept answer strings
    latency_ms: float  # arrival -> host readback of this request's flags
    batch_size: int  # padded batch the request rode in
    spec: BucketSpec


class _Request:
    __slots__ = ("question", "objects", "obj_mask", "cb", "future", "t0")

    def __init__(self, question, objects, obj_mask, cb, t0=None):
        self.question = question
        self.objects = objects
        self.obj_mask = obj_mask
        self.cb = cb  # single-question canonicalized CompiledBatch
        self.future: Future = Future()
        self.t0 = time.perf_counter() if t0 is None else t0


class ServingEngine:
    """Continuous-batching online inference on one device (``device``,
    default the card: CPU callers pass ``device="cpu"``), or over the
    devices of ``mesh`` (a ``parallel.mesh.LocalMesh``; the module
    docstring says how).

    ``submit`` returns a Future[ServeResult]; a dispatcher thread groups
    requests per canonical spec and flushes on size/deadline.
    ``answer_many`` is the synchronous convenience wrapper, ``trace`` the
    hop-by-hop diagnostics of one question. ``executables`` (from
    ``export.load_serving_set``) serves the (spec, meta) keys it holds from
    loaded programs."""

    def __init__(
        self,
        cfg: Config,
        ontology: GQAOntology,
        params: OracleParams,
        features=None,
        *,
        device=None,
        mesh=None,
        max_batch: int = 16,
        max_delay_ms: float = 10.0,
        batch_ladder: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
        seg_ladder: Sequence[int] = (0, 1, 2, 3),
        fill_ladder: Sequence[int] = (0, 1, 2, 4),
        transfer_dtype: Optional[str] = None,
        max_inflight: int = 8,
        max_pending: Optional[int] = None,
        plan_cache_size: int = 4096,
        executables: Optional[Dict[tuple, object]] = None,
        start: bool = True,
    ):
        if int(max_batch) > max(batch_ladder):
            raise ValueError(
                f"max_batch={max_batch} exceeds the top batch-ladder rung "
                f"{max(batch_ladder)}; extend batch_ladder instead")
        if mesh is not None and device is not None:
            raise ValueError("give the engine a device or a mesh, not both")
        if mesh is not None and executables:
            raise ValueError("exported steps are single-device; build the engine without a "
                             "mesh to serve them")
        self.cfg = cfg
        self.interp = Interpreter(cfg, ontology)
        self.compiler = ProgramCompiler(
            ontology,
            object_num=cfg.tpu.max_object_num,
            rel_slots=cfg.tpu.rel_table_size,
            option_pad_ladder=cfg.tpu.option_pad_ladder,
        )
        self.mesh = mesh
        self._turn = itertools.count()  # the data row of the next group (``_row``)
        if mesh is None:
            self.device = torch.device("cuda" if device is None else device)
            # a copy: Module.to() moves in place, and callers may serve the
            # same weights from engines on two devices
            self.params = copy.deepcopy(params).to(self.device)
            self._replicas = None
        else:
            self._replicas = serving_replicas(mesh, params)
            # data row 0's lead device and replica; every replica has its
            # structure, so steps bind any replica's tensors through it
            self.device, self.params = mesh.devices[0][0], self._replicas[0]
        self.features = features
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.batch_ladder = tuple(batch_ladder)
        self.seg_ladder = tuple(seg_ladder)
        self.fill_ladder = tuple(fill_ladder)
        self.transfer_dtype = transfer_dtype
        # (spec, meta[, "trace"]) -> step callable; ``executables`` holds
        # loaded torch.export programs under the same keys
        self._step_cache: Dict[tuple, object] = {}
        self._exported = dict(executables or {})
        self._step_lock = threading.Lock()

        # queue key = canonical BucketSpec with batch_size zeroed
        self._pending: Dict[BucketSpec, List[_Request]] = {}
        self._pending_count = 0
        self.max_pending = max_pending
        # plan cache: canonical-question JSON -> (queue key, CompiledBatch);
        # entries are immutable (concat/pad build fresh arrays)
        self._plan_cache: "OrderedDict[str, Tuple[BucketSpec, CompiledBatch]]" = OrderedDict()
        self._plan_cache_size = int(plan_cache_size)
        self._plan_lock = threading.Lock()
        self._cond = threading.Condition()
        self._stop = False
        self._flush = False
        self.stats = {
            "requests": 0,
            "batches": 0,
            "padded_rows": 0,
            "plan_hits": 0,
            "rejected": 0,
            "compiled_steps": 0,  # live steps made (eager Interpreter.forward)
            "aot_steps": 0,  # steps served from loaded torch.export programs
            "trace_steps": 0,  # live trace steps made
            "latencies_ms": deque(maxlen=100_000),
        }
        self._stats_lock = threading.Lock()
        self._completion = ThreadPoolExecutor(max_workers=4,
                                              thread_name_prefix="dfol-serve-readback")
        # backpressure: dispatch runs at most max_inflight groups ahead of readback
        self._inflight = threading.BoundedSemaphore(int(max_inflight))
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- frontend

    def _prepare(self, question: dict) -> Tuple[BucketSpec, CompiledBatch]:
        """Compile ONE question onto the canonical grid; memoized by the
        whole question dict (sort_keys JSON), so reuse is exact."""
        ck = json.dumps(question, sort_keys=True, default=str)
        with self._plan_lock:
            hit = self._plan_cache.get(ck)
            if hit is not None:
                self._plan_cache.move_to_end(ck)
                self.stats["plan_hits"] += 1
                return hit
        spec, cb = self.compiler.compile([question])
        spec, cb = canonicalize_batch(spec, cb, self.seg_ladder, self.fill_ladder)
        out = (dataclasses.replace(spec, batch_size=0), cb)
        with self._plan_lock:
            self._plan_cache[ck] = out
            if len(self._plan_cache) > self._plan_cache_size:
                self._plan_cache.popitem(last=False)
        return out

    def submit(self, question: dict, objects=None, obj_mask=None) -> Future:
        """Enqueue one question; resolves to a ServeResult.

        ``objects (O, D+6)`` / ``obj_mask (O,)`` may be omitted when the
        engine owns a FeatureSource (then ``question['imageId']`` is looked
        up). Latency is measured from this entry point."""
        t0 = time.perf_counter()
        t = question["program"]["last_op"]["operator"]
        if t in SUPERVISION_OPS:
            raise ValueError(f"{t} is a training-supervision terminal, not a servable question")
        if objects is None:
            objs, mask = self.features.batch([question["imageId"]], self.cfg.tpu.max_object_num)
            objects, obj_mask = objs[0], mask[0]
        key, cb = self._prepare(question)
        r = _Request(question, np.asarray(objects), np.asarray(obj_mask), cb, t0)
        with self._cond:
            if self._stop:
                raise RuntimeError("engine stopped")
            if self.max_pending is not None and self._pending_count >= self.max_pending:
                with self._stats_lock:
                    self.stats["rejected"] += 1
                raise EngineOverloaded(
                    f"{self._pending_count} requests queued >= "
                    f"max_pending={self.max_pending}; retry with backoff")
            self._pending.setdefault(key, []).append(r)
            self._pending_count += 1
            self._cond.notify()
        with self._stats_lock:
            self.stats["requests"] += 1
        return r.future

    def warmup(self, questions: Sequence[dict], batch_sizes=None, traces: bool = False) -> dict:
        """Run every distinct canonical spec in ``questions`` once at every
        batch rung the policy can produce (``<= rung(max_batch)``, or an
        explicit ``batch_sizes``), synchronously; with ``traces``, also its
        trace step. ``steps`` counts the step callables made."""
        if batch_sizes is None:
            top = _pad_ladder(self.max_batch, self.batch_ladder)
            batch_sizes = [b for b in self.batch_ladder if b <= top]
        reps: Dict[BucketSpec, _Request] = {}
        for q in questions:
            if q["program"]["last_op"]["operator"] in SUPERVISION_OPS:
                continue
            key, cb = self._prepare(q)
            if key not in reps:
                objs, mask = self.features.batch([q["imageId"]], self.cfg.tpu.max_object_num)
                reps[key] = _Request(q, objs[0], mask[0], cb)
        t0 = time.perf_counter()
        before = self._steps_made()
        runs = 0
        for key, r in reps.items():
            for row in range(self.mesh.n_data if self.mesh is not None else 1):
                for B in batch_sizes:
                    self._execute(key, [r], pad_to=B, row=row)
                    runs += 1
                if traces:
                    self.trace(r.question, r.objects, r.obj_mask, row=row)
                    runs += 1
        return {"specs": len(reps), "batch_sizes": list(batch_sizes), "runs": runs,
                "steps": self._steps_made() - before, "seconds": time.perf_counter() - t0}

    def _steps_made(self) -> int:
        with self._stats_lock:
            return sum(self.stats[k] for k in ("compiled_steps", "aot_steps", "trace_steps"))

    def flush(self):
        """Dispatch everything pending regardless of deadlines."""
        with self._cond:
            self._flush = True
            self._cond.notify()

    def answer_many(self, questions, objects=None, obj_mask=None) -> List[ServeResult]:
        """Synchronous convenience: submit all, flush, wait."""
        futs = [
            self.submit(q, None if objects is None else objects[i],
                        None if obj_mask is None else obj_mask[i])
            for i, q in enumerate(questions)
        ]
        self.flush()
        return [f.result() for f in futs]

    def stop(self):
        with self._cond:
            self._stop = True
            self._flush = True
            self._cond.notify()
        if self._thread is not None:
            self._thread.join()
        self._completion.shutdown(wait=True)  # drain in-flight readbacks

    # ----------------------------------------------------------- dispatcher

    def _ready_groups(self, now: float) -> List[Tuple[BucketSpec, List[_Request]]]:
        """Pop request groups that should dispatch now (caller holds lock)."""
        out: List[Tuple[BucketSpec, List[_Request]]] = []
        for key in list(self._pending):
            q = self._pending[key]
            while len(q) >= self.max_batch:
                out.append((key, q[: self.max_batch]))
                del q[: self.max_batch]
            if q and (self._flush or now - q[0].t0 >= self.max_delay_s):
                out.append((key, q))
                self._pending[key] = []
            if not self._pending[key]:
                del self._pending[key]
        self._pending_count -= sum(len(g) for _, g in out)
        return out

    def _dispatch_loop(self):
        while True:
            with self._cond:
                while True:
                    now = time.perf_counter()
                    groups = self._ready_groups(now)
                    if groups:
                        break
                    if self._stop and not self._pending:
                        return
                    self._flush = False
                    oldest = min((q[0].t0 for q in self._pending.values() if q), default=None)
                    timeout = None if oldest is None else max(oldest + self.max_delay_s - now, 0.0)
                    self._cond.wait(timeout=timeout)
                if not self._pending:
                    self._flush = False
            for key, g in groups:
                self._process(key, g)

    # ------------------------------------------------------------ execution

    def _constants(self, device) -> Dict[str, torch.Tensor]:
        """The step's last input: tensors on ``device`` that are not
        parameters, passed in so that an exported step does not carry them
        (the calibrator's (V+1, D) GloVe matrix)."""
        if self.params.calibrator is None:
            return {}
        return {"embedding": self.interp.embedding_on(device)}

    def _run_forward(self, params, objects, obj_mask, arrays, consts, spec, return_trace):
        interp = self.interp
        if consts:
            interp = interp.with_embedding(consts["embedding"])
        return interp.forward(bind_params(self.params, params), objects, obj_mask, arrays, spec,
                              return_trace=return_trace)

    def _make_step(self, spec: BucketSpec, meta):
        """The eager eval step ``fn(params, objects, obj_mask, arrays,
        consts) -> answer_flags``: the live step and the export surface."""
        del meta  # the arrays' layout; it keys the step

        def fn(params, objects, obj_mask, arrays, consts):
            return self._run_forward(params, objects, obj_mask, arrays, consts, spec,
                                     False)["answer_flags"]

        return fn

    def _make_trace_step(self, spec: BucketSpec, meta):
        """The eager eval step that also returns the log-probabilities and
        the hop-by-hop attention trace (``trace``'s step and its export
        surface)."""
        del meta

        def fn(params, objects, obj_mask, arrays, consts):
            out = self._run_forward(params, objects, obj_mask, arrays, consts, spec, True)
            return {"log_probability": out["log_probability"],
                    "answer_flags": out["answer_flags"], "trace": out["trace"]}

        return fn

    def _step(self, key: tuple, make, live_stat: str):
        # one callable per key: the dispatcher, warmup and HTTP trace
        # threads share it, and no two threads make or load the same key
        with self._step_lock:
            fn = self._step_cache.get(key)
            if fn is None:
                exp = self._exported.get(key)
                if exp is not None:
                    fn, stat = exp.module(), "aot_steps"
                else:
                    fn, stat = make(key[0], key[1]), live_stat
                with self._stats_lock:
                    self.stats[stat] += 1
                self._step_cache[key] = fn
        return fn

    def read_executables(self) -> int:
        """Make the step of every key in ``executables`` now, reading each
        module from its file, so that no request waits for a read; returns
        the number of steps made."""
        before = self._steps_made()
        for key in list(self._exported):
            self._step(key, None, "aot_steps")
        return self._steps_made() - before

    def _eval_step(self, spec: BucketSpec, meta):
        return self._step((spec, meta), self._make_step, "compiled_steps")

    def _trace_step(self, spec: BucketSpec, meta):
        return self._step((spec, meta, "trace"), self._make_trace_step, "trace_steps")

    def _replica(self, row: int) -> Tuple[torch.device, OracleParams]:
        """(lead device, parameters) of data row ``row``: the engine's own on
        one device."""
        if self._replicas is None:
            return self.device, self.params
        return self.mesh.devices[row][0], self._replicas[row]

    def _inputs(self, lb: LoadedBatch, row: int = 0):
        """A batch's step inputs on data row ``row``'s lead device (the
        engine's device without a mesh)."""
        device, params = self._replica(row)
        _, objects, obj_mask, arrays = to_device_batch(lb, device, self.transfer_dtype)
        return (param_tensors(params), objects, obj_mask,
                {k: arrays[k] for k in sorted(arrays)}, self._constants(device))

    def _row(self, row: Optional[int]) -> int:
        """The data row of the next device run: ``row`` where given, else
        the rows in turn (0 without a mesh)."""
        if self.mesh is None:
            return 0
        return next(self._turn) % self.mesh.n_data if row is None else row

    def trace(self, question: dict, objects=None, obj_mask=None,
              row: Optional[int] = None) -> dict:
        """Hop-by-hop reasoning trace for ONE question, synchronously, at
        batch rung 1: ``viz.trace_to_dict``'s entry (ops, tokens and the
        object attentions per hop, the log-probability) plus the decoded
        ``answers``. Runs on the caller's thread, with its own steps; on a
        mesh, on data row ``row`` (default: the rows in turn)."""
        from dfol_vqa_tpu_torch.viz import trace_to_dict

        t = question["program"]["last_op"]["operator"]
        if t in SUPERVISION_OPS:
            raise ValueError(f"{t} is a training-supervision terminal, not a servable question")
        if objects is None:
            objs, mask = self.features.batch([question["imageId"]], self.cfg.tpu.max_object_num)
            objects, obj_mask = objs[0], mask[0]
        key, cb = self._prepare(question)
        r = _Request(question, np.asarray(objects), np.asarray(obj_mask), cb)
        lb, _ = self._assemble(key, [r], pad_to=1)
        step = self._trace_step(lb.spec, lb.meta)
        with torch.inference_mode():
            out = step(*self._inputs(lb, self._row(row)))
        out = {"log_probability": out["log_probability"].cpu().numpy(),
               "answer_flags": out["answer_flags"].cpu().numpy(),
               "trace": [[a.cpu().numpy() for a in br] for br in out["trace"]]}
        entry = trace_to_dict(lb, out, out["trace"])[0]
        entry["answers"] = decode_answer_flags(out["answer_flags"], lb.spec, lb.compiled)[0]
        return entry

    def _assemble(self, key: BucketSpec, group: List[_Request], pad_to=None):
        """Concat same-spec request rows + pad to the batch ladder.
        Returns (LoadedBatch, pad)."""
        spec, cb = concat_batches(dataclasses.replace(key, batch_size=len(group)),
                                  [r.cb for r in group])
        B2 = pad_to if pad_to is not None else _pad_ladder(len(group), self.batch_ladder)
        spec, cb = pad_batch_rows(spec, cb, B2)
        pad = B2 - len(group)
        objects = np.stack([r.objects for r in group] + [group[0].objects] * pad)
        obj_mask = np.stack([r.obj_mask for r in group] + [group[0].obj_mask] * pad)
        return LoadedBatch(spec, cb, objects, obj_mask), pad

    def _dispatch(self, key: BucketSpec, group: List[_Request], pad_to=None,
                  row: Optional[int] = None):
        """Assemble + enqueue one group on data row ``row`` (``_row``); the
        flags stay on its device. Returns (spec, cb, device_flags, pad)."""
        lb, pad = self._assemble(key, group, pad_to)
        step = self._eval_step(lb.spec, lb.meta)
        with torch.inference_mode():
            flags = step(*self._inputs(lb, self._row(row)))
        return lb.spec, lb.compiled, flags, pad

    def _execute(self, key: BucketSpec, group: List[_Request], pad_to=None,
                 row: Optional[int] = None):
        """Synchronous dispatch + readback (warmup path)."""
        spec, cb, flags_d, pad = self._dispatch(key, group, pad_to, row)
        return spec, cb, flags_d.cpu().numpy(), pad

    def _complete(self, group, spec, cb, flags_d, pad):
        """Readback + future resolution for one in-flight group (completion
        pool), so the dispatcher can enqueue the next group meanwhile."""
        try:
            self._complete_inner(group, spec, cb, flags_d, pad)
        finally:
            self._inflight.release()

    def _complete_inner(self, group, spec, cb, flags_d, pad):
        try:
            flags = flags_d.cpu().numpy()  # the completion barrier
            t_done = time.perf_counter()
            decoded = decode_answer_flags(flags, spec, cb)
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["padded_rows"] += pad
                for r in group:
                    self.stats["latencies_ms"].append((t_done - r.t0) * 1e3)
            for i, r in enumerate(group):
                r.future.set_result(ServeResult(
                    answers=decoded[i], latency_ms=(t_done - r.t0) * 1e3,
                    batch_size=spec.batch_size, spec=spec))
        except BaseException as e:  # surface errors to every waiter
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)

    def _process(self, key: BucketSpec, group: List[_Request]):
        self._inflight.acquire()
        submitted = False
        try:
            spec, cb, flags_d, pad = self._dispatch(key, group)
            self._completion.submit(self._complete, group, spec, cb, flags_d, pad)
            submitted = True
        except BaseException as e:  # surface errors to every waiter
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            if not submitted:
                self._inflight.release()


# --------------------------------------------------------------- demo build


def demo_config(tiny: bool = False, objects: int = 24) -> Config:
    """The demo engine's configuration: ``tiny`` = small dims for CPU tests
    (box 32, oracle 24, E 16, hidden 16, O 8); otherwise production dims
    (2048-d boxes, 512-d oracle, E 300, hidden 256) at ``objects`` slots."""
    if tiny:
        cfg = Config(
            box_features_dim=32, oracle_input_dim=24, word_embedding_dim=16,
            attribute_network_layers_config=[16],
            relation_network_layers_config=[16],
            featurizer_layers_config=[], dropout=0.0, verbose=False,
        )
        cfg.tpu.max_object_num = 8
    else:
        cfg = Config()
        cfg.tpu.max_object_num = objects
    return cfg


def build_demo_engine(tiny: bool = False, objects: int = 24, max_batch: int = 32,
                      max_delay_ms: float = 10.0, seed: int = 0,
                      batch_ladder: Optional[Sequence[int]] = None,
                      max_pending: Optional[int] = None,
                      seg_ladder: Optional[Sequence[int]] = None,
                      fill_ladder: Optional[Sequence[int]] = None,
                      device="cuda", params: Optional[OracleParams] = None,
                      executables=None, start: bool = True, mesh=None):
    """Demo engine over the planted world, as the JAX package builds it.

    Weights are random from ``seed`` (drawn on the CPU, so every device gets
    the same ones) unless ``params`` is given; ``tiny`` sends float32
    objects, production dims send bf16. The engine runs on ``device``
    (default the card), or over ``mesh`` when given, from the loaded
    ``executables`` where given. Returns (cfg, ontology, world, engine)."""
    from dfol_vqa_tpu_torch.data.planted import PlantedWorld

    cfg = demo_config(tiny, objects)
    ont = GQAOntology()
    if params is None:
        params = Interpreter(cfg, ont).init_params(torch.Generator().manual_seed(seed))
    world = PlantedWorld(
        ont, box_dim=cfg.box_features_dim, n_nouns=6, n_attrs=4,
        n_images=48, min_objects=4, max_objects=cfg.tpu.max_object_num,
        noise=0.1, seed=seed,
    )
    extra = {} if batch_ladder is None else {"batch_ladder": tuple(batch_ladder)}
    if seg_ladder is not None:
        extra["seg_ladder"] = tuple(seg_ladder)
    if fill_ladder is not None:
        extra["fill_ladder"] = tuple(fill_ladder)
    eng = ServingEngine(
        cfg, ont, params, features=world, device=None if mesh is not None else device,
        mesh=mesh, max_batch=max_batch, max_delay_ms=max_delay_ms,
        transfer_dtype=None if tiny else "bfloat16",
        max_pending=max_pending, executables=executables, start=start,
        **extra,
    )
    return cfg, ont, world, eng
