"""Write the JAX reference answers that the PyTorch port meets on the GPU.

Runs the JAX package (``dfol_vqa_tpu``) on the CPU and writes two npz files.

``tests/data/torch_port_golden.npz`` (serving), from the tiny demo engine
(``build_demo_engine(tiny=True, seed=0)``):

* ``params/<key>``: the engine's weights, flattened as in npz checkpoints;
* ``req/<i>/...``: about a dozen requests — the question (JSON), its scene
  (``objects``, ``obj_mask``), the compiled and canonicalized program
  tensors (``arrays/<name>``), and JAX's ``log_probability``,
  ``answer_flags`` and decoded ``answers`` for it at batch rung 1. They
  cover ``exist`` with 0-2 hops (relate hops included), ``verify_rel`` and
  ``query_attr``.

``tests/data/torch_port_golden_eval.npz`` (offline evaluation), from the
tiny demo eval workload (``dfol_vqa_tpu_torch/data/evalset.py``: 60
questions in 4 loader batches of 16 on 4 images each, so every batch takes
the shared-image relation route):

* ``params/<key>``: the interpreter's weights (``PRNGKey(0)``);
* ``datasets``: the question files (JSON);
* ``batch/<k>/...``: each ``LoadedBatch`` (``objects``, ``obj_mask``,
  ``arrays/<name>`` with ``img_index``) and JAX's ``log_probability`` and
  ``answer_flags`` for it;
* ``test_epoch/error``, ``test_epoch/counts``: ``VQATrainer.test_epoch``'s
  error vector and ``last_test_counts``; ``predict``: its ``predict``
  output (JSON).

``tests/data/torch_port_golden_train.npz`` (training), from the tiny demo
training config (``dfol_vqa_tpu_torch/data/trainset.py``, dropout 0, weight
decay 0 so that a leaf without a gradient keeps its value and the updates
compress) with the interpreter's weights (``PRNGKey(0)``), for two batches:
``per_question`` (16 ``exist`` questions over all images, U * 2 > B) and
``shared`` (16 ``verify_rel`` questions on 4 images, U * 2 <= B):

* ``params/<key>``: the weights before the step;
* ``datasets/<route>``: the question file (JSON);
* ``batch/<route>/...``: the ``LoadedBatch`` (``objects``, ``obj_mask``,
  ``arrays/<name>``), JAX's normalised ``loss``, its gradients
  ``grads/<key>`` and the change of every parameter in one
  ``build_optimizer`` step, ``update/<key>``.

``chip_smoke.py`` runs the port on the card against the three files;
``tests/test_torch_golden.py`` regenerates them and requires them to match
the checked-in copies.

    python scripts/make_torch_golden.py [--out tests/data/torch_port_golden.npz]
        [--eval-out tests/data/torch_port_golden_eval.npz]
        [--train-out tests/data/torch_port_golden_train.npz]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
from typing import Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
EVAL_GOLDEN_PATH = os.path.join(ROOT, "tests", "data", "torch_port_golden_eval.npz")
TRAIN_GOLDEN_PATH = os.path.join(ROOT, "tests", "data", "torch_port_golden_train.npz")

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


def _jax_on_cpu():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def build_golden() -> Dict[str, np.ndarray]:
    jax = _jax_on_cpu()
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


def build_eval_golden() -> Dict[str, np.ndarray]:
    jax = _jax_on_cpu()
    import jax.numpy as jnp

    from dfol_vqa_tpu.models.interpreter import Interpreter
    from dfol_vqa_tpu.ontology import GQAOntology
    from dfol_vqa_tpu.train.checkpoint import _flatten
    from dfol_vqa_tpu.train.trainer import VQATrainer
    from dfol_vqa_tpu_torch.data import evalset

    ont = GQAOntology()
    cfg = evalset.demo_eval_config(tiny=True, stream_dtype="float32")
    world = evalset.demo_world(ont, tiny=True)
    datasets = evalset.eval_datasets(world, evalset.TINY_MIX, evalset.TINY_BATCH,
                                     evalset.TINY_IMAGES_PER_BATCH)
    loader = evalset.eval_loader(cfg, ont, world, datasets)
    interp = Interpreter(cfg, ont)
    params = interp.init_params(jax.random.PRNGKey(0))
    out = {f"params/{k}": v for k, v in _flatten(jax.tree.map(np.asarray, params)).items()}
    out["datasets"] = np.array(json.dumps(datasets, sort_keys=True))
    for k, lb in enumerate(loader):
        res = interp.forward(params, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
                             {a: jnp.asarray(v) for a, v in lb.arrays.items()}, lb.spec,
                             False, None)
        p = f"batch/{k}/"
        out[p + "objects"] = lb.objects
        out[p + "obj_mask"] = lb.obj_mask
        for a, v in lb.arrays.items():
            out[p + "arrays/" + a] = v
        out[p + "log_probability"] = np.asarray(res["log_probability"])
        out[p + "answer_flags"] = np.asarray(res["answer_flags"])
    trainer = VQATrainer(cfg, interp)
    out["test_epoch/error"] = np.asarray(trainer.test_epoch(loader, params))
    out["test_epoch/counts"] = trainer.last_test_counts
    preds = trainer.predict(loader, params, io.StringIO())
    out["predict"] = np.array(json.dumps(preds))
    return out


def train_golden_setup():
    """(cfg, world, ontology, {route: question files}) of the training golden;
    numpy only, so ``chip_smoke.py`` rebuilds the same batches."""
    from dfol_vqa_tpu.ontology import GQAOntology
    from dfol_vqa_tpu_torch.data import evalset, trainset

    ont = GQAOntology()
    cfg = trainset.demo_train_config(tiny=True)
    cfg.weight_decay = 0.0
    world = evalset.demo_world(ont, tiny=True)
    datasets = {
        "per_question": trainset.train_datasets(world, (("exist", 2, 16),), seed=7),
        "shared": evalset.eval_datasets(world, (("verify_rel", 1, 16),), trainset.TINY_BATCH,
                                        evalset.TINY_IMAGES_PER_BATCH, seed=7),
    }
    return cfg, world, ont, datasets


def build_train_golden() -> Dict[str, np.ndarray]:
    jax = _jax_on_cpu()
    import jax.numpy as jnp
    import optax

    from dfol_vqa_tpu.models.interpreter import Interpreter
    from dfol_vqa_tpu.train.checkpoint import _flatten
    from dfol_vqa_tpu.train.optim import build_optimizer
    from dfol_vqa_tpu_torch.data import trainset

    cfg, world, ont, datasets = train_golden_setup()
    interp = Interpreter(cfg, ont)
    params = interp.init_params(jax.random.PRNGKey(0))
    before = _flatten(jax.tree.map(np.asarray, params))
    out = {f"params/{k}": v for k, v in before.items()}
    for route, files in datasets.items():
        out[f"datasets/{route}"] = np.array(json.dumps(files, sort_keys=True))
        (lb,) = list(trainset.train_loader(cfg, ont, world, files, shuffle=False))
        arrays = {a: jnp.asarray(v) for a, v in lb.arrays.items()}

        def loss_fn(p):
            res = interp.forward(p, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask), arrays,
                                 lb.spec, True, jax.random.PRNGKey(0))
            return res["loss"] / jnp.maximum(jnp.sum(arrays["question_mask"]), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        tx = build_optimizer(cfg, params)
        updates, _ = tx.update(grads, tx.init(params), params)
        after = _flatten(jax.tree.map(np.asarray, optax.apply_updates(params, updates)))
        p = f"batch/{route}/"
        out[p + "objects"] = lb.objects
        out[p + "obj_mask"] = lb.obj_mask
        for a, v in lb.arrays.items():
            out[p + "arrays/" + a] = v
        out[p + "loss"] = np.asarray(loss)
        for k, g in _flatten(jax.tree.map(np.asarray, grads)).items():
            out[p + "grads/" + k] = g
            out[p + "update/" + k] = after[k] - before[k]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=GOLDEN_PATH)
    ap.add_argument("--eval-out", default=EVAL_GOLDEN_PATH)
    ap.add_argument("--train-out", default=TRAIN_GOLDEN_PATH)
    args = ap.parse_args(argv)
    for path, golden, unit, what in (
            (args.out, build_golden(), "/question", "requests"),
            (args.eval_out, build_eval_golden(), "/log_probability", "batches"),
            (args.train_out, build_train_golden(), "/loss", "training batches")):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez_compressed(path, **golden)
        n = sum(1 for k in golden if k.endswith(unit))
        print(f"wrote {path}: {n} {what}, {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
