"""The port's own spans (``dfol_vqa_tpu_torch.utils.profiling``) as the
per-layer readers of the training cell read them, after the run, from the
process's span record.

The record is clipped to the traced slice S: from the tracer's start
(``Trace._t0``) to that plus ``window_s``, on ``perf_counter``. A span
contributes its part inside S; per batch and per step, the spans that end
inside S are counted. The trainer's thread is the thread of the
``train.step`` spans. A program that records no spans (no ``recorded`` in
its ``utils.profiling``) gives every reader None.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Set, Tuple

Interval = Tuple[float, float]


def record(obs) -> Optional[Tuple[Interval, list]]:
    """(S in perf_counter nanoseconds, the recorded spans) of a traced
    training run; None without a tracer, off the training path, or where
    the program records no spans."""
    t = obs.get("tracer")
    if obs.get("path") != "train" or t is None or not t.window_s:
        return None
    try:
        from dfol_vqa_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "recorded"):
        return None
    lo = t._t0 * 1e9
    return (lo, lo + t.window_s * 1e9), profiling.recorded()


def ending(spans: Iterable, s: Interval, name: str, threads: Optional[Set[int]] = None) -> list:
    """The spans named ``name`` (on ``threads``, if given) that end in S."""
    return [x for x in spans if x[0] == name and s[0] <= x[3] <= s[1]
            and (threads is None or x[1] in threads)]


def clipped(spans: Iterable, s: Interval, names: Sequence[str],
            threads: Optional[Set[int]] = None) -> List[Interval]:
    """The parts inside S of the spans named in ``names`` (on ``threads``)."""
    return [(max(x[2], s[0]), min(x[3], s[1])) for x in spans
            if x[0] in names and x[2] < s[1] and x[3] > s[0]
            and (threads is None or x[1] in threads)]


def ms(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals) * 1e-6


def per(total: float, n: float) -> Optional[float]:
    return total / n if n else None


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def outside(first: List[Interval], second: List[Interval]) -> float:
    """The length of ``union(first)`` that ``union(second)`` leaves
    uncovered."""
    first, second = union(first), union(second)
    total, j = 0.0, 0
    for a, b in first:
        while j < len(second) and second[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(second) and second[k][0] < b:
            covered += min(b, second[k][1]) - max(a, second[k][0])
            k += 1
        total += (b - a) - covered
    return total
