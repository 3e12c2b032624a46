"""Write the JAX reference answers that the PyTorch port meets on the GPU.

Runs the JAX package (``dfol_vqa_tpu``) on the CPU with the tiny demo
engine (``build_demo_engine(tiny=True, seed=0)``) and stores, in one npz:

* ``params/<key>``: the engine's weights, flattened as in npz checkpoints;
* ``req/<i>/...``: about a dozen requests — the question (JSON), its scene
  (``objects``, ``obj_mask``), the compiled and canonicalized program
  tensors (``arrays/<name>``), and JAX's ``log_probability``,
  ``answer_flags`` and decoded ``answers`` for it at batch rung 1.

The requests cover the serving slice: ``exist`` with 0-2 hops (relate hops
included), ``verify_rel`` and ``query_attr``. ``chip_smoke.py`` runs the
port on the card against this file; ``tests/test_torch_golden.py``
regenerates it and requires it to match the checked-in copy.

    python scripts/make_torch_golden.py [--out tests/data/torch_port_golden.npz]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")

# (family, hops, count): 12 requests over the serving slice's terminals
GOLDEN_MIX = (("exist", 0, 2), ("exist", 1, 2), ("exist", 2, 2),
              ("verify_rel", 1, 2), ("verify_rel", 2, 1),
              ("query_attr", 0, 2), ("query_attr", 1, 1))


def golden_questions(world) -> List[dict]:
    qs: List[dict] = []
    for fi, (fam, hops, n) in enumerate(GOLDEN_MIX):
        qs += world.generate_family(fam, n, length=hops, seed=100 + fi,
                                    neg_prob=0.3 if fam == "exist" else 0.0,
                                    id_prefix=f"golden-{fam}{hops}-")
    return qs


def build_golden() -> Dict[str, np.ndarray]:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from dfol_vqa_tpu.models.interpreter import decode_answer_flags
    from dfol_vqa_tpu.serve import _Request, build_demo_engine
    from dfol_vqa_tpu.train.checkpoint import _flatten

    cfg, _, world, eng = build_demo_engine(tiny=True, seed=0)
    try:
        out = {f"params/{k}": v for k, v in _flatten(jax.tree.map(np.asarray, eng.params)).items()}
        for i, q in enumerate(golden_questions(world)):
            key, cb = eng._prepare(q)
            objs, mask = world.batch([q["imageId"]], cfg.tpu.max_object_num)
            lb, _ = eng._assemble(key, [_Request(q, objs[0], mask[0], cb)], pad_to=1)
            res = eng.interp.forward(
                eng.params, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
                {k: jnp.asarray(v) for k, v in lb.arrays.items()}, lb.spec, False, None)
            flags = np.asarray(res["answer_flags"])
            p = f"req/{i}/"
            out[p + "question"] = np.array(json.dumps(q, sort_keys=True))
            out[p + "objects"] = objs[0]
            out[p + "obj_mask"] = mask[0]
            for k, v in lb.arrays.items():
                out[p + "arrays/" + k] = v
            out[p + "log_probability"] = np.asarray(res["log_probability"])
            out[p + "answer_flags"] = flags
            out[p + "answers"] = np.array(json.dumps(decode_answer_flags(flags, lb.spec, lb.compiled)[0]))
        return out
    finally:
        eng.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=GOLDEN_PATH)
    args = ap.parse_args(argv)
    golden = build_golden()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **golden)
    n = sum(1 for k in golden if k.endswith("/question"))
    print(f"wrote {args.out}: {n} requests, {os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
