"""What every cell's run shares: the manifest and the files it names, the
run's context, the metrics' readers, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``:

* a configuration: ``configs/<name>.yaml`` (as the manifest's ``file``);
* a cell: ``workloads/<name>.json``, whose ``path`` names the module in
  ``paths/`` that drives it (``serve``, ``eval``, ``train``), with the
  traffic's parameters and the limits of its comparison;
* a metric: ``metrics/<name>.py``, with ``read(obs) -> float | None``
  over the run's observations (``None``: nothing to read in this cell).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "dfol_vqa_tpu")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_entry(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_of(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    without tracing, its per-layer metrics with it. A metric without a
    ``workloads`` list belongs to every cell (a per-layer one: every cell
    that reports the end-to-end metric it moves)."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def read_metric(name: str, obs: dict) -> Optional[float]:
    """The reader ``metrics/<name>.py`` applied to the observations."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(obs)


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name (before the
    first dot, compared whole) is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


@dataclass
class Ctx:
    """One run: the cell, its configuration file and parameters, and what
    the run observed (``obs``), filled in by the path module."""

    cell: str
    spec: dict
    config_file: str
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = field(default_factory=time.perf_counter)
    obs: Dict[str, object] = field(default_factory=dict)
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0

    def note(self, msg: str) -> None:
        """A line for the run's standard error (before the result)."""
        print(f"[{self.cell} +{time.perf_counter() - self.t0:.1f}s] {msg}", file=sys.stderr,
              flush=True)

    def setup_done(self) -> None:
        """The window starts: set-up is over. What set-up made is collected
        once and frozen out of the garbage collector's later passes, so
        that a full collection in the window does not walk it again."""
        gc.collect()
        gc.freeze()
        self.obs["setup_s"] = time.perf_counter() - self.t0

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared with its limit (``correct`` needs value <=
        limit for every one)."""
        self.checks[name] = {"value": value, "limit": limit}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in self.checks.values())


def device_info(n: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(n))}


def finite(x: float) -> float:
    """JSON has no infinity: a value that never came reads as 1e30."""
    return x if math.isfinite(x) else 1e30
