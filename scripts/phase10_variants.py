"""Where phase 10's time goes under chunked dispatch: ``chip_smoke.py``'s
phase 10 (the curriculum chain) on the card, each run in a fresh process
with its kernels built before the phase starts, for a parent checkout and
for variants of a changed one:

* ``parent``: the parent checkout as it is;
* ``change``: the changed checkout as it is;
* ``eager``: no CUDA graph (``GraphCache`` with ``capture=False``), so
  chunks run eagerly and pad as the JAX package does;
* ``chunk-1``: ``tpu.train_chunk = tpu.eval_chunk = 1`` in every stage's
  config (no chunk forms: the one-step path through the chunk feed).

In the changed checkout's runs it also counts the captures and sums their
seconds. Run from the repository root on the card:

    python3 scripts/phase10_variants.py PARENT_DIR CHANGE_DIR OUT_DIR [VARIANT ...]

The variants run in the order given, by default ``parent change change
parent`` (the two checkouts in turns). Writes each run's log to
OUT_DIR/phase10_<i>_<variant>.log and prints one line per run."""
import os
import re
import subprocess
import sys
import time

PRELUDE = """
import sys, time, torch
sys.path.insert(0, '.')
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from dfol_vqa_tpu_torch.ops import pair_mlp as pm, relation_oracle as ro, shared_contract as sc
for build in (ro.build, ro.build_bwd, pm.build, sc.build):
    build()
"""
COUNT = """
from dfol_vqa_tpu_torch.train import graphs
captures = []
_capture = graphs.GraphCache._capture
def _counted(self, *a, **k):
    t0 = time.perf_counter()
    try:
        return _capture(self, *a, **k)
    finally:
        captures.append(time.perf_counter() - t0)
graphs.GraphCache._capture = _counted
"""
VARIANTS = {
    "parent": "",
    "change": COUNT,
    "chunk-1": COUNT + """
from dfol_vqa_tpu_torch.config import Config
_from_yaml = Config.from_yaml
def _one(path_or_dict):
    cfg = _from_yaml(path_or_dict)
    cfg.tpu.train_chunk = cfg.tpu.eval_chunk = 1
    return cfg
Config.from_yaml = staticmethod(_one)
""",
    "eager": COUNT + """
_init = graphs.GraphCache.__init__
def _eager(self, device, capture=True):
    _init(self, device, False)
graphs.GraphCache.__init__ = _eager
""",
}
RUN = """
cs.phase_curriculum(torch.device('cuda', 0), cs.card())
if 'captures' in globals():
    print(f'captures {len(captures)} seconds {sum(captures)!r}', flush=True)
"""

parent, change, out = sys.argv[1], sys.argv[2], sys.argv[3]
order = sys.argv[4:] or ["parent", "change", "change", "parent"]
os.makedirs(out, exist_ok=True)
failed = 0
for i, name in enumerate(order):
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", PRELUDE + VARIANTS[name] + RUN],
                       cwd=parent if name == "parent" else change, capture_output=True,
                       text=True, timeout=900)
    wall = time.perf_counter() - t0
    text = p.stdout + p.stderr
    with open(os.path.join(out, f"phase10_{i}_{name}.log"), "w") as f:
        f.write(text)
    chain = re.search(r"the chain: 8 stages in ([0-9.]+) s", text)
    phase = re.search(r"phase 10 took ([0-9.]+) s", text)
    caps = re.search(r"captures (\d+) seconds ([0-9.]+)", text)
    print(f"run {i} {name}: rc {p.returncode}, chain {chain and chain.group(1)} s, phase 10 "
          f"{phase and phase.group(1)} s, captures {caps and caps.group(1)} in "
          f"{caps and caps.group(2)} s, process {wall!r} s", flush=True)
    failed += p.returncode != 0
sys.exit(1 if failed else 0)
