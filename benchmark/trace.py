"""The traced run's reading of the device: ``torch.profiler`` over a slice
of the window, its Chrome trace parsed for kernels (name, start, length,
grid), the union of device activity (``busy_s``) and the host spans the
harness opened (``span``), which name the device's idle gaps.

Spans are ``torch.profiler.record_function`` ranges named ``bench.*``; with
tracing off ``span`` costs a no-op context.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """``span(name)`` opens a host range in traced runs and nothing else."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"bench.{name}")


class Trace:
    """Profiles the device from ``start()`` to ``stop()`` and reads the
    trace: ``kernels`` [(name, start_us, dur_us, grid)], ``busy_s``,
    ``window_s``, ``gaps`` [(seconds, host span)], ``device_ops`` by time."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.prof = None
        self.kernels: List[Tuple[str, float, float, Tuple[int, ...]]] = []
        self.busy_s = 0.0
        self.window_s = 0.0
        self.gaps: List[Tuple[float, str]] = []
        self.device_ops: List[Tuple[str, float]] = []

    def prime(self) -> None:
        """A short session in set-up: the profiler's first start initialises
        CUPTI, which takes seconds and must not fall in the window."""
        import torch

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch

        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._read(events)

    def _read(self, events: List[dict]) -> None:
        device, spans = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
                device.append((ts, ts + dur, e.get("name", "")))
                if cat == "kernel":
                    grid = tuple(int(g) for g in (e.get("args", {}).get("grid") or ()))
                    self.kernels.append((e.get("name", ""), ts, dur, grid))
            elif cat == "user_annotation" and str(e.get("name", "")).startswith("bench."):
                ts = float(e["ts"])
                spans.append((ts, ts + float(e.get("dur", 0.0)), e["name"][len("bench."):]))
        device.sort()
        busy, gaps, end = 0.0, [], None
        for s, t, _ in device:
            if end is None or s > end:
                if end is not None:
                    gaps.append((end, s))
                busy += t - s
                end = t
            elif t > end:
                busy += t - end
                end = t
        self.busy_s = busy * 1e-6
        totals: Dict[str, float] = {}
        for s, t, name in device:
            totals[name] = totals.get(name, 0.0) + (t - s) * 1e-6
        self.device_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
        spans.sort()
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        self.gaps = [((t - s) * 1e-6, _open_span(spans, (s + t) / 2) or "program")
                     for s, t in longest]

    def kernel_time(self, name: str) -> Tuple[float, List[Tuple[int, ...]]]:
        """(seconds, grids) of every launch of the kernel ``name`` (the
        function's name: the trace gives its whole signature)."""
        word = re.compile(rf"\b{re.escape(name)}\b")
        hits = [(dur, grid) for n, _, dur, grid in self.kernels if word.search(n)]
        return sum(d for d, _ in hits) * 1e-6, [g for _, g in hits]

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops],
                "idle_gaps": [[n, s] for s, n in self.gaps]}


def _open_span(spans: List[Tuple[float, float, str]], t: float) -> Optional[str]:
    """The innermost harness span open at ``t`` (spans sorted by start)."""
    best = None
    for s, e, name in spans:
        if s > t:
            break
        if e >= t and (best is None or s >= best[0]):
            best = (s, name)
    return None if best is None else best[1]
