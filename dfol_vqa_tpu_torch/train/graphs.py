"""One CUDA graph per chunk: the card's counterpart of the JAX package's
fused chunk dispatch (``lax.scan`` over k steps in one executable) and of
its jitted one-step path.

``GraphCache.run(key, fn, inputs)`` runs ``fn(*inputs)``, a function of
device tensors that returns a tuple of device tensors (k >= 1 training
steps, so a lone training step too, or k >= 2 evaluation forwards). On the
CPU, or with ``capture=False`` (the trainer under a device mesh), it just
calls ``fn``: that eager run is the plain version. On a CUDA device:

* the first call of a key runs ``fn`` eagerly: the warm-up, which is a real
  chunk (its steps train and its outputs are used) and sets up what the
  capture must find ready (the kernels' libraries and attributes, Adam's
  state, the interpreter's index tensors, the gradient buffers);
* the second call copies its inputs into static buffers (allocated outside
  any graph), captures ``fn`` on them into one ``torch.cuda.CUDAGraph`` on
  a side stream and replays it, so this chunk too runs once. The capture
  is begun directly, not through ``torch.cuda.graph``, whose entry runs
  ``gc.collect`` and empties the device and pinned-host caches: on a
  training run that captures a graph now and then, refilling those caches
  afterwards costs more than the capture;
* every later call copies its inputs into those buffers on the current
  stream, replays the graph and returns clones of its static outputs.

``last_route`` says which of these the last ``run`` took: "eager" (no
capture), "warm", "capture" or "replay".

All graphs of a cache share one memory pool. A graph's static outputs may
lie where another graph keeps its temporaries, so they are cloned right
after each replay, before any other graph replays. A capture or replay
that fails raises; nothing falls back to the eager path.

A graph reads everything that is not one of its inputs (parameters,
gradients, Adam's state, the interpreter's cached tensors) at the
addresses it had when captured; callers put what identifies those in the
key (``param_key``) and ``drop`` the graphs whose state goes away.

Dropout draws from the ``generator`` given to ``run`` (a CUDA
``torch.Generator``), which the capture registers, so that every replay
draws new masks and advances it.

Launch counts: the kernels' wrappers count their launches when Python
runs them, which a replay does not. A capture's increments are taken back
(nothing ran), and each replay adds the launches its graph holds, so the
counts stay the number of kernels that ran.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

_WARM = "warm"


def _counters() -> List[Tuple[object, str, threading.Lock]]:
    """(module, attribute, lock) of every kernel's launch count."""
    from dfol_vqa_tpu_torch.ops import pair_mlp, relation_oracle, shared_contract

    return [(relation_oracle, "LAUNCHES", relation_oracle._COUNT_LOCK),
            (relation_oracle, "BWD_LAUNCHES", relation_oracle._COUNT_LOCK),
            (pair_mlp, "LAUNCHES", pair_mlp._COUNT_LOCK),
            (shared_contract, "LAUNCHES", shared_contract._COUNT_LOCK)]


def launch_counts() -> List[int]:
    """(relation_oracle, its backward, pair_mlp, shared_contract)."""
    return [getattr(mod, attr) for mod, attr, _ in _counters()]


def add_launches(counts: Sequence[int], sign: int = 1) -> None:
    for (mod, attr, lock), n in zip(_counters(), counts):
        if n:
            with lock:
                setattr(mod, attr, getattr(mod, attr) + sign * n)


def param_key(params) -> tuple:
    """The addresses of ``params``' tensors: a graph that read them may
    replay only while they are still there."""
    return tuple(p.data_ptr() for p in params.parameters())


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "launches", "replays")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches, self.replays = launches, 0


class GraphCache:
    """CUDA graphs by key on ``device`` (see the module docstring); on the
    CPU or without ``capture`` ``run`` calls ``fn``."""

    def __init__(self, device, capture: bool = True):
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
        self._entries: Dict[Hashable, object] = {}
        self._pool = None
        self._stream = None  # the capture stream, made at the first capture
        self.capture_seconds: List[float] = []
        self.last_route: Optional[str] = None  # how the last ``run`` ran ``fn``

    @property
    def graphs(self) -> List[_Graph]:
        return [e for e in self._entries.values() if isinstance(e, _Graph)]

    def drop(self, kind: str) -> None:
        """Forget the graphs (and warm-ups) of keys that start with ``kind``."""
        for key in [k for k in self._entries if k[0] == kind]:
            del self._entries[key]
        if not self.graphs:
            # the allocator releases a pool that no graph uses any more, and
            # a capture must not name a released pool
            self._pool = None

    def run(self, key: tuple, fn: Callable[..., Tuple[torch.Tensor, ...]],
            inputs: Sequence[torch.Tensor],
            generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """``fn(*inputs)``'s outputs; ``key`` names the graph (its first
        element the kind that ``drop`` takes) and ``generator`` is the one
        ``fn`` draws dropout masks from, if any."""
        if not self.capture:
            self.last_route = "eager"
            return list(fn(*inputs))
        entry = self._entries.get(key)
        if entry is None:
            self._entries[key] = _WARM
            self.last_route = "warm"
            return list(fn(*inputs))
        if entry is _WARM:
            entry = self._capture(key, fn, inputs, generator)
            self.last_route = "capture"
        else:
            self.last_route = "replay"
        for static, x in zip(entry.inputs, inputs):
            static.copy_(x)
        entry.graph.replay()
        entry.replays += 1
        add_launches(entry.launches)
        return [o.clone() for o in entry.outputs]

    def _capture(self, key, fn, inputs, generator) -> _Graph:
        static = [x.clone() for x in inputs]
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = launch_counts()
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        torch.cuda.synchronize(self.device)
        self._stream.wait_stream(current)
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    outputs = tuple(fn(*static))
                finally:
                    graph.capture_end()
            current.wait_stream(self._stream)
        except BaseException:
            del self._entries[key]
            raise
        finally:
            captured = [a - b for a, b in zip(launch_counts(), before)]
            add_launches(captured, -1)  # captured, not run
        self.capture_seconds.append(time.perf_counter() - t0)
        if self._pool is None:
            self._pool = graph.pool()
        entry = self._entries[key] = _Graph(graph, static, outputs, captured)
        return entry

    def stats(self) -> dict:
        """The number of graphs, their replays, the capture seconds and the
        bytes of the device memory segments that the shared pool holds
        (None where the allocator's snapshot does not name pools)."""
        held = None
        if self._pool is not None:
            segments = torch.cuda.memory_snapshot()
            if segments and "segment_pool_id" in segments[0]:
                held = sum(s["total_size"] for s in segments
                           if tuple(s["segment_pool_id"]) == tuple(self._pool))
        graphs = self.graphs
        return {"graphs": len(graphs), "replays": sum(g.replays for g in graphs),
                "capture_seconds": list(self.capture_seconds), "pool_bytes": held}
