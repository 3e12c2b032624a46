#!/usr/bin/env python3
"""The control of ``correct``: the reference, put in the program's place and
computed one precision below the configuration's (float32 products with
TF32 on), judged by the same comparison, which it has to fail.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seconds <s>]
        [--fault tf32 [half_batch]]

Runs the cell as ``run.py`` does (a short window at the cell's own load is
enough: the sample is drawn as a run draws it), then judges, for each
``--fault`` in turn, the control's answers or steps in place of the
program's and prints a line for it; the benchmark's own runs never run it.
Limits are set between the readings of sound runs and of this control
(PERF.md).
"""

import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.run import T0, cache_dirs  # noqa: E402


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", nargs="+", choices=("tf32", "half_batch"), default=["tf32"],
                    help="tf32: the control; half_batch (training cells): the reference "
                         "with half of each batch left out, a fault the check must catch")
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    manifest = harness.load_manifest()
    entry = harness.cell_entry(manifest, args.workload)
    with open(os.path.join(harness.BENCH_DIR, "workloads", f"{args.workload}.json")) as f:
        spec = json.load(f)
    config = harness.config_entry(manifest, entry["config"])
    ctx = harness.Ctx(cell=args.workload, spec=spec, config_file=os.path.join(ROOT, config["file"]),
                      seed=args.seed, seconds=args.seconds, trace=False, t0=T0)
    ctx.obs["scratch"] = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"bench-{os.getpid()}")
    judge = importlib.import_module(f"benchmark.paths.{spec['path']}").run(ctx)
    for fault in args.fault:
        ctx.checks = {}
        judge(control=fault)
        checks = {k: {"value": harness.finite(v["value"]), "limit": v["limit"]}
                  for k, v in ctx.checks.items()}
        print(json.dumps({"control": fault, "correct": ctx.correct, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
