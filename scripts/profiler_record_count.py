"""How often ``torch.profiler`` records a kernel that its wrapper launched.

``chip_smoke.kernel_device_ms`` times a kernel alone from the profiler's
CUDA records and holds their count against the wrapper's launch count.
This script repeats that profile for kernels 1 and 2 (``relation_oracle``
forward and backward) at a width past one slice of the tile (H=512, E=600,
B=8, O=24) and at the training shape (H=256, E=300, B=80, O=100), and for
every profiled run prints the launches, the records whose name matches,
and, where they differ, every CUDA record's name and count, once with
CUDA activity only (as ``kernel_device_ms``) and once with CPU activity
too.

    python3 scripts/profiler_record_count.py [--runs 40]

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profiled_runs(fn, kernel: str, launches, reps: int, runs: int, activities) -> dict:
    """{"runs", "mismatched": [(launched, recorded, {name: count})]} over
    ``runs`` profiled runs of ``reps`` calls of ``fn``."""
    fn()
    torch.cuda.synchronize()
    mismatched = []
    for _ in range(runs):
        before = launches()
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = collections.Counter(e.name for e in prof.events()
                                    if e.device_type == torch.autograd.DeviceType.CUDA)
        recorded = sum(n for name, n in names.items() if kernel in name)
        launched = launches() - before
        if recorded != launched:
            mismatched.append((launched, recorded, dict(names)))
    return {"runs": runs, "mismatched": mismatched}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_record_count: needs one CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro

    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(ro.build), pool.submit(ro.build_bwd)]:
            fut.result()
    device = torch.device("cuda", 0)
    stamp = cs.card()
    gen = torch.Generator().manual_seed(3)
    cuda_only = [torch.profiler.ProfilerActivity.CUDA]
    both = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = []
    for B, O, H, E in ((8, 24, 512, 600), (80, 100, 256, 300)):
        ins, tok = cs.random_width_inputs(gen, B, O, H, E, device=device)
        g = torch.randn((B, cs.R_SLOTS, O, O), generator=gen).to(device)
        cases = (("relation_oracle_bwd", lambda: ro.pair_tail_bwd_kernel(*ins, tok, g, False),
                  lambda: ro.BWD_LAUNCHES, 5),
                 ("relation_oracle_fwd_kernel", lambda: ro.pair_tail_kernel(*ins, tok),
                  lambda: ro.LAUNCHES, 10))
        for kernel, fn, launches, reps in cases:
            for label, acts in (("cuda", cuda_only), ("cpu+cuda", both)):
                with torch.no_grad():
                    rec = profiled_runs(fn, kernel, launches, reps, args.runs, acts)
                rec.update(kernel=kernel, B=B, O=O, H=H, E=E, reps=reps, activities=label)
                out.append(rec)
                print(json.dumps(rec), flush=True)
    print(f"profiler record counts ({stamp})")
    print(json.dumps({"card": stamp, "cases": [
        {k: r[k] for k in ("kernel", "B", "O", "H", "E", "reps", "activities", "runs")}
        | {"mismatched": len(r["mismatched"])} for r in out]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
