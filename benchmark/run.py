#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's configuration and traffic from its files, sets up and
warms up, measures for ``--seconds``, checks what the timed path produced
against the plain reference (``benchmark/reference``), and prints one JSON
line last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``busy_s`` and ``window_s`` when traced), ``breakdown`` when traced,
and ``checks``: each number compared with its limit, also printed as the
last lines of standard error. Exits non-zero, printing no result, without
the cards the cell needs, when the program cannot be imported, or when
JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# load from one process with few threads: the program's own threads (the
# serving dispatcher and readback pool, the loader's prefetch) are the load;
# math libraries' thread pools would only contend with them for the cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc builds go to its own ``_build`` directory there)."""
    cache = os.path.join(root, ".bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))


def execute(ctx: harness.Ctx, manifest: dict, chips: int, control=None) -> dict:
    """Run the cell's path, judge it (``control``: what ``control.py`` puts
    in the program's place), read its metrics; the result line."""
    path = importlib.import_module(f"benchmark.paths.{ctx.spec['path']}")
    ctx.obs["path"] = ctx.spec["path"]
    judge = path.run(ctx)
    device = harness.device_info(chips) if ctx.device == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    found = harness.forbidden_modules()
    if found:
        raise SystemExit(f"JAX or the JAX package was loaded: {', '.join(found)}")
    judge(control=control)
    metrics = {}
    for m in harness.metrics_of(manifest, ctx.cell, ctx.trace):
        value = harness.read_metric(m["name"], ctx.obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": ctx.correct, "attempted": ctx.attempted, "failed": ctx.failed,
           "metrics": metrics, "device": device}
    tracer = ctx.obs.get("tracer")
    if tracer is not None:
        device["busy_s"], device["window_s"] = tracer.busy_s, tracer.window_s
        out["breakdown"] = tracer.breakdown()
    out["checks"] = {k: {"value": harness.finite(v["value"]), "limit": v["limit"]}
                     for k, v in ctx.checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)

    manifest = harness.load_manifest()
    entry = harness.cell_entry(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with open(os.path.join(harness.BENCH_DIR, "workloads", f"{args.workload}.json")) as f:
        spec = json.load(f)
    config = harness.config_entry(manifest, entry["config"])
    ctx = harness.Ctx(cell=args.workload, spec=spec, config_file=os.path.join(ROOT, config["file"]),
                      seed=args.seed, seconds=args.seconds, trace=bool(args.trace), t0=T0)
    ctx.obs["scratch"] = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"bench-{os.getpid()}")
    out = execute(ctx, manifest, entry["chips"])
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
