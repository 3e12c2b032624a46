"""Where ``chip_smoke.py``'s phase 10 (the curriculum chain) spends its host
time: the phase under ``cProfile`` on one CUDA card, after the four kernels
are built, then the functions by cumulative and by own time.

    python3 scripts/phase10_profile.py [--top 60]

It needs the card, as ``chip_smoke.py`` does, and runs the phase's gates
as that script runs them.
"""

import argparse
import cProfile
import io
import os
import pstats
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=60, help="functions printed per ordering")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase10_profile: no CUDA device", file=sys.stderr)
        return 2
    from dfol_vqa_tpu_torch.ops import pair_mlp as pm
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro
    from dfol_vqa_tpu_torch.ops import shared_contract as sc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stamp = cs.card()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        for fut in [pool.submit(b) for b in (ro.build, ro.build_bwd, pm.build, sc.build)]:
            fut.result()
    cs.log(f"card {stamp}; kernels built in {time.perf_counter() - t0!r} s")
    prof = cProfile.Profile()
    prof.enable()
    launches = cs.phase_curriculum(torch.device("cuda", 0), stamp)
    prof.disable()
    cs.log(f"launches {launches}")
    for key in ("cumulative", "tottime"):
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(args.top)
        cs.log(f"--- by {key} ({stamp})\n{buf.getvalue()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
