"""Profiling and tracing utilities.

Port of ``dfol_vqa_tpu/utils/profiling.py`` over ``torch.profiler``:

  * ``profile_trace(logdir)``: a context manager that profiles the host and,
    where there is one, the card (CUPTI), and writes a Chrome trace
    (``trace.json``, for chrome://tracing or Perfetto) into ``logdir``;
  * ``annotate(name)``: a ``torch.profiler.record_function`` range, so
    phases show up as named spans in the trace;
  * ``StepTimer``: steady-state wall time per step with the warm-up
    discarded. Work on the card is asynchronous, so where CUDA is in use
    the timer synchronizes the card before it reads the clock at either end
    of a step: a step's time is then its work's, not its enqueue's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the enclosed block and write ``logdir/trace.json``; yields
    the ``torch.profiler.profile`` object (``key_averages()`` etc.)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Collects per-step wall times; reports mean/median excluding warmup."""

    def __init__(self, warmup: int = 3):
        self._warmup = warmup
        self._times: List[float] = []
        self._t0: Optional[float] = None

    @staticmethod
    def _sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._times.append(time.perf_counter() - self._t0)

    @property
    def steps(self) -> int:
        return max(0, len(self._times) - self._warmup)

    def mean(self) -> float:
        xs = self._times[self._warmup:]
        return sum(xs) / len(xs) if xs else float("nan")

    def median(self) -> float:
        xs = sorted(self._times[self._warmup:])
        if not xs:
            return float("nan")
        return xs[len(xs) // 2]
