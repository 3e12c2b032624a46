"""Profiling and tracing utilities: the port's span recorder and
``torch.profiler`` traces.

  * ``span(name, **tags)``: a context manager that records the enclosed
    block as ``(name, thread ident, start_ns, end_ns, tags)`` on
    ``time.perf_counter_ns`` into one process-wide ring of the last
    ``RING_SIZE`` spans (several minutes of training). It is always on and
    costs one to two microseconds; while a profiler runs it also opens a range
    named ``dfol.<name>`` (``_RANGE``), so that in the profile of a thread
    the span sits beside the kernels it launched. The interval recorded is
    the block's own, inside that range;
  * ``recorded()``: a copy of the ring, oldest first; ``clear()`` empties it;
  * ``trace_to_perf_ns(ts_us)``: a Chrome trace's ``ts`` (microseconds, as
    this process exported it) on the spans' clock, so that the kernels of a
    trace can be placed among the spans (``trace_offset_ns``: the offset
    itself, for many timestamps);
  * ``profile_trace(logdir)``: profiles every thread of the process and,
    where there is one, the card (CUPTI), and writes a Chrome trace
    (``trace.json``, for chrome://tracing or Perfetto) into ``logdir``.

The spans of the training path (``data/loader.py``, ``data/transfer.py``,
``train/trainer.py``, ``models/calibrator.py``):

  * ``loader.programs``, ``loader.scenes``, ``loader.batch``: a batch's
    program rows, its scene block and its ``LoadedBatch``, on the loader's
    producer thread (with ``num_workers > 0`` they run in the worker
    processes and are not recorded here);
  * ``transfer.stage`` (tags ``batches``, ``pinned``: how many of them sent
    their objects from the loader's page-locked block, with no host copy):
    a group's copy to the device, on the transfer worker (groups of two or
    more) or on the consumer (one);
  * ``transfer.wait``: the consumer of ``chunk_prefetch`` blocked on its
    worker;
  * ``train.step`` (tags ``steps``, ``route``: "eager", "warm", "capture"
    or "replay", ``GraphCache.last_route``; ``grad_elems`` and
    ``param_elems``: the parameter elements that require a gradient, and
    all of them): one group's dispatch;
  * ``calib.passes`` (tag ``steps``: the LSTM cell calls): the
    calibrator's two passes, wherever Python runs them (an eager step, a
    capture, an eval or serving forward; a graph replay runs no Python);
  * ``train.readback``: an epoch's step losses read back.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "dfol."
RING_SIZE = 65536
# the Chrome trace exporters write ts as Unix time less the start of its
# "trimonth" (torch/profiler/_chrome_trace_export.py; Kineto's
# ChromeTraceBaseTime does the same)
_TRIMONTH_SECONDS = 7889238
# the profiler's range: the C++ RecordFunction that torch.profiler.record_function
# also opens (an event of category "cpu_op" rather than "user_annotation"), without
# that wrapper's Python and operator dispatch, whose ~15 us, on a thread that has to
# take the GIL back, put the range's ends up to milliseconds from the span's
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)

Span = Tuple[str, int, int, int, Dict[str, object]]
_RING: Deque[Span] = collections.deque(maxlen=RING_SIZE)


class span:
    """``with span(name, **tags) as s:`` records the block (module
    docstring); ``s.tags`` may be completed inside it."""

    __slots__ = ("name", "tags", "_start", "_range")

    def __init__(self, name: str, **tags):
        self.name, self.tags, self._range = name, tags, None

    def __enter__(self) -> "span":
        if getattr(_autograd_profiler, "_is_profiler_enabled", True):
            self._range = _RANGE(PREFIX + self.name)
            self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        _RING.append((self.name, threading.get_ident(), self._start, time.perf_counter_ns(),
                      self.tags))
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


def recorded() -> List[Span]:
    """The ring's spans, oldest first (by end)."""
    while True:
        try:
            return list(_RING)
        except RuntimeError:  # appended to while copied
            continue


def clear() -> None:
    _RING.clear()


def trace_offset_ns(base_ns: Optional[int] = None) -> int:
    """What turns a Chrome trace's ``ts`` in nanoseconds into
    ``perf_counter_ns``: the trace's base (``baseTimeNanoseconds``; by
    default the one an export in this trimonth writes) less the offset of
    Unix time from ``perf_counter_ns``, read now."""
    if base_ns is None:
        base_ns = (int(time.time()) // _TRIMONTH_SECONDS) * _TRIMONTH_SECONDS * 10**9
    reads = []
    for _ in range(5):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        reads.append((b - a, unix - (a + b) // 2))
    return base_ns - min(reads)[1]


def trace_to_perf_ns(ts_us, base_ns: Optional[int] = None):
    """A Chrome trace's ``ts`` (microseconds) on ``perf_counter_ns``."""
    return ts_us * 1e3 + trace_offset_ns(base_ns)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the enclosed block on every thread and write
    ``logdir/trace.json``; yields the ``torch.profiler.profile`` object
    (``key_averages()`` etc.)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=config) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
