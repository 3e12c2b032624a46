"""Write the JAX reference answers that the PyTorch port meets on the GPU.

Runs the JAX package (``dfol_vqa_tpu``) on the CPU and writes seven npz files.

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

``tests/data/torch_port_golden_terminals.npz`` (every terminal), with the
offline-eval golden's weights (the same ``PRNGKey(0)`` init at the same
tiny dims; not stored again, to keep the file small): one batch per
terminal, the 14 question terminals of ``evalset.TERMINAL_HOPS`` as 8
questions on 2 images (the shared-image route) and the supervision
terminals as 2 ``trainset.supervision_loader`` questions:

* ``datasets/<terminal>``: a question terminal's file (JSON);
* ``batch/<terminal>/...``: the ``LoadedBatch`` (``objects``, ``obj_mask``,
  the compiled arrays packed into one entry, ``arrays`` with
  ``array_layout``, by ``chip_smoke.pack_arrays``) and, per
  ``soft``/``hard`` mode, JAX's
  ``log_probability``, ``answer_flags`` and ``match``. ``scene``'s scores
  do not depend on the mode and are kept once: its relation scores whole
  and, of its (B, O, 2002) attribute scores, the supervised entries
  (``attr_at``) and the sums over attributes (``attr_sum``), as
  ``chip_smoke.scene_summary`` reduces them;
* for the supervision terminals the normalised training ``loss`` and its
  gradients ``grads/<key>``.

``tests/data/torch_port_golden_calibrator.npz`` (the calibrator and the
trainable interpreter), with the eval golden's weights plus the new leaves
that ``chip_smoke.calibrator_golden_weights`` draws with numpy (output head
and operator modules' final layers at random; not stored), for two models,
``calibrator`` (the last curriculum stage's flags: the oracle frozen) and
``f4`` (``oracle_output_dim=4``, ``operator_layers_config=[8]``), on the
terminals golden's question files and an 8-question shuffled ``exist``
file (``per_question``):

* ``datasets/<batch>``, ``batch/<batch>/...``: the question file and the
  packed ``LoadedBatch``, as in the terminals golden;
* ``<model>/<batch>/{eval,train}/...``: JAX's ``log_probability``,
  ``answer_flags`` and ``match`` with ``is_training`` false and true (the
  calibrator model on every batch, ``f4`` on six);
* ``<model>/<batch>/loss``, ``grads/<key>`` (the trained leaves) and
  ``update/<key>`` (one ``build_optimizer`` step) for the calibrator's
  ``per_question`` and ``choose_rel`` batches and ``f4``'s ``per_question``.

``tests/data/torch_port_golden_trace.npz`` (the hop-by-hop trace), from
the tiny demo engine with the serving golden's weights (not stored again):
``ServingEngine.trace`` of a dozen questions (``TRACE_MIX``: exist with
0-2 hops, verify_rel, query_attr, choose_rel, compare and ``and``):

* ``trace/<i>/question``, ``objects``, ``obj_mask``: the request;
* ``trace/<i>/hops`` (JSON: each hop's branch, op and token),
  ``attention`` (n_hops, O) in probability, ``log_probability`` and
  ``answers`` (JSON): JAX's trace entry.

``tests/data/torch_port_golden_bf16.npz`` (``compute_dtype="bfloat16"``), at
production widths (``chip_smoke.bf16_golden_setup``: the sample widths, O=100,
three batches of 16 questions on 2 images each, the shared route; the port's
weights from ``torch.Generator().manual_seed(0)``, not stored):

* ``datasets``: the question files (JSON); ``param_sha256/<key>``: each
  weight's digest, so the card can check that it drew the same weights;
* ``batch/<k>/objects_sha256`` (the scenes, not stored: their digest),
  JAX's ``log_probability`` and ``answer_flags`` under ``jax.jit``.

``tests/data/torch_port_golden_chunk.npz`` (chunked training), from the
tiny demo training config at ``tpu.train_chunk=8`` with ``pad_chunks`` and
``checkpointing_frequency=3`` (``chip_smoke.chunk_golden_setup``): one
epoch of JAX's ``VQATrainer.train`` over 11 shuffled batches of one
``exist`` file (a chunk of 8, then a tail of 3 padded to 8) with the
training golden's weights (``PRNGKey(0)``) and a validation loader of the
tiny mix on the shared route:

* ``params/<key>``: the weights before training; ``update/<key>``: the
  change training made (weight decay 0, so untouched leaves store zeros);
* ``datasets/train``, ``datasets/validation``: the question files (JSON);
* ``validation_steps``: the global steps at which ``test_epoch`` ran (the
  mid-epoch checks at chunk boundaries, then the epoch's end);
  ``validation_errors``: its chunked error vector each time; ``losses``:
  the epoch loss.

``chip_smoke.py`` runs the port on the card against the eight files;
``tests/test_torch_golden.py`` regenerates them and requires them to match
the checked-in copies.

    python scripts/make_torch_golden.py [--out tests/data/torch_port_golden.npz]
        [--eval-out tests/data/torch_port_golden_eval.npz]
        [--train-out tests/data/torch_port_golden_train.npz]
        [--terminals-out tests/data/torch_port_golden_terminals.npz]
        [--calibrator-out tests/data/torch_port_golden_calibrator.npz]
        [--trace-out tests/data/torch_port_golden_trace.npz]
        [--bf16-out tests/data/torch_port_golden_bf16.npz]
        [--chunk-out tests/data/torch_port_golden_chunk.npz]
"""

from __future__ import annotations

import argparse
import dataclasses
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
TERMINALS_GOLDEN_PATH = os.path.join(ROOT, "tests", "data", "torch_port_golden_terminals.npz")
CALIBRATOR_GOLDEN_PATH = os.path.join(ROOT, "tests", "data", "torch_port_golden_calibrator.npz")
TRACE_GOLDEN_PATH = os.path.join(ROOT, "tests", "data", "torch_port_golden_trace.npz")
BF16_GOLDEN_PATH = os.path.join(ROOT, "tests", "data", "torch_port_golden_bf16.npz")
CHUNK_GOLDEN_PATH = os.path.join(ROOT, "tests", "data", "torch_port_golden_chunk.npz")

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


# (family, hops, count): 12 traced requests, every hop kind and two branches
TRACE_MIX = (("exist", 0, 1), ("exist", 1, 1), ("exist", 2, 2), ("verify_rel", 1, 1),
             ("verify_rel", 2, 1), ("query_attr", 1, 1), ("choose_rel", 1, 2),
             ("compare", 1, 1), ("and", 2, 2))


def trace_questions(world) -> List[dict]:
    qs: List[dict] = []
    for fi, (fam, hops, n) in enumerate(TRACE_MIX):
        qs += world.generate_family(fam, n, length=hops, seed=300 + fi,
                                    neg_prob=0.3 if fam == "exist" else 0.0,
                                    id_prefix=f"trace-{fam}{hops}-")
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


def build_trace_golden() -> Dict[str, np.ndarray]:
    _jax_on_cpu()
    from dfol_vqa_tpu.serve import build_demo_engine

    cfg, _, world, eng = build_demo_engine(tiny=True, seed=0)
    try:
        out: Dict[str, np.ndarray] = {}
        for i, q in enumerate(trace_questions(world)):
            objs, mask = world.batch([q["imageId"]], cfg.tpu.max_object_num)
            entry = eng.trace(q, objs[0], mask[0])
            p = f"trace/{i}/"
            out[p + "question"] = np.array(json.dumps(q, sort_keys=True))
            out[p + "objects"] = objs[0]
            out[p + "obj_mask"] = mask[0]
            out[p + "hops"] = np.array(json.dumps([[h["branch"], h["op"], h["token"]]
                                                   for h in entry["hops"]]))
            out[p + "attention"] = np.asarray([h["attention"] for h in entry["hops"]],
                                              np.float32)
            out[p + "log_probability"] = np.asarray(entry["log_probability"], np.float32)
            out[p + "answers"] = np.array(json.dumps(entry["answers"]))
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
    from tests.jax_batches import JaxLoader

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
    out["test_epoch/error"] = np.asarray(trainer.test_epoch(JaxLoader(loader), params))
    out["test_epoch/counts"] = trainer.last_test_counts
    preds = trainer.predict(JaxLoader(loader), params, io.StringIO())
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


def build_terminals_golden() -> Dict[str, np.ndarray]:
    jax = _jax_on_cpu()
    import jax.numpy as jnp

    from chip_smoke import SUPERVISION_GOLDEN, pack_arrays, scene_summary, terminals_golden_setup
    from dfol_vqa_tpu.models.interpreter import Interpreter
    from dfol_vqa_tpu.ontology import GQAOntology
    from dfol_vqa_tpu.train.checkpoint import _flatten
    from dfol_vqa_tpu_torch.data import trainset

    ont = GQAOntology()
    cfg, sup_cfg, world, files = terminals_golden_setup(ont)
    params = Interpreter(cfg, ont).init_params(jax.random.PRNGKey(0))  # the eval golden's
    out: Dict[str, np.ndarray] = {}
    for term in list(files) + list(trainset.SUPERVISION_TERMINALS):
        if term in files:
            c = cfg
            out[f"datasets/{term}"] = np.array(json.dumps(files[term], sort_keys=True))
            (lb,) = list(trainset.train_loader(cfg, ont, world, [files[term]], shuffle=False))
        else:
            c = sup_cfg
            (lb,) = list(trainset.supervision_loader(sup_cfg, ont, term, **SUPERVISION_GOLDEN))
        p = f"batch/{term}/"
        out[p + "objects"] = lb.objects
        out[p + "obj_mask"] = lb.obj_mask
        out[p + "arrays"], out[p + "array_layout"] = pack_arrays(lb.arrays)
        arrays = {a: jnp.asarray(v) for a, v in lb.arrays.items()}
        for mode in ("soft", "hard"):
            interp = Interpreter(dataclasses.replace(c, hard_mode=mode == "hard"), ont)
            res = interp.forward(params, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
                                 arrays, lb.spec, False, None)
            lp = jax.tree.map(np.asarray, res["log_probability"])
            if isinstance(lp, dict):  # the mode does not enter scene's scores
                for k, v in scene_summary(lp, lb.arrays["attr_weight"]).items():
                    out[f"{p}log_probability/{k}"] = v
            else:
                out[f"{p}{mode}/log_probability"] = lp
            out[f"{p}{mode}/answer_flags"] = np.asarray(res["answer_flags"])
            out[f"{p}{mode}/match"] = np.asarray(res["match"])
        if term in trainset.SUPERVISION_TERMINALS:
            interp = Interpreter(c, ont)

            def loss_fn(q):
                res = interp.forward(q, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
                                     arrays, lb.spec, True, None)
                return res["loss"] / jnp.maximum(jnp.sum(arrays["question_mask"]), 1.0)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            out[p + "loss"] = np.asarray(loss)
            for k, g in _flatten(jax.tree.map(np.asarray, grads)).items():
                out[p + "grads/" + k] = g
    return out


# the calibrator golden's batches per model: every terminal with the
# calibrator (its modulations differ per terminal class), a relating and a
# fan-out sample of terminals with F = 4, and the shuffled per-question batch
CALIBRATOR_GOLDEN_F4_BATCHES = ("exist", "verify_rel", "query_attr", "choose_rel", "compare",
                                "per_question")


def build_calibrator_golden() -> Dict[str, np.ndarray]:
    jax = _jax_on_cpu()
    import jax.numpy as jnp
    import optax

    from chip_smoke import (CALIBRATOR_GOLDEN_STEPS, calibrator_golden_batches,
                            calibrator_golden_setup, calibrator_golden_weights, pack_arrays)
    from dfol_vqa_tpu.models.interpreter import Interpreter
    from dfol_vqa_tpu.ontology import GQAOntology
    from dfol_vqa_tpu.train.checkpoint import _flatten
    from dfol_vqa_tpu.train.optim import build_optimizer
    from dfol_vqa_tpu_torch.convert import unflatten

    ont = GQAOntology()
    calib, f4, world, files = calibrator_golden_setup(ont)
    with np.load(EVAL_GOLDEN_PATH) as eval_golden:
        start = {k[len("params/"):]: eval_golden[k] for k in eval_golden.files
                 if k.startswith("params/")}
    weights = dict(zip(("calibrator", "f4"), calibrator_golden_weights(start, calib, f4)))
    batches = calibrator_golden_batches(ont, world, files, calib)
    out: Dict[str, np.ndarray] = {}
    for name, lb in batches.items():
        out[f"datasets/{name}"] = np.array(json.dumps(files[name], sort_keys=True))
        out[f"batch/{name}/objects"] = lb.objects
        out[f"batch/{name}/obj_mask"] = lb.obj_mask
        out[f"batch/{name}/arrays"], out[f"batch/{name}/array_layout"] = pack_arrays(lb.arrays)
    for model, cfg in (("calibrator", calib), ("f4", f4)):
        interp = Interpreter(cfg, ont)
        params = jax.tree.map(jnp.asarray, unflatten(weights[model]))
        names = list(files) if model == "calibrator" else list(CALIBRATOR_GOLDEN_F4_BATCHES)
        for name in names:
            lb, p = batches[name], f"{model}/{name}/"
            arrays = {a: jnp.asarray(v) for a, v in lb.arrays.items()}
            for mode in ("eval", "train"):
                res = interp.forward(params, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
                                     arrays, lb.spec, mode == "train", None)
                for key in ("log_probability", "answer_flags", "match"):
                    out[f"{p}{mode}/{key}"] = np.asarray(res[key])
            if name not in CALIBRATOR_GOLDEN_STEPS or (model == "f4" and name != "per_question"):
                continue

            def loss_fn(q):
                res = interp.forward(q, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
                                     arrays, lb.spec, True, None)
                return res["loss"] / jnp.maximum(jnp.sum(arrays["question_mask"]), 1.0)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            tx = build_optimizer(cfg, params)
            updates, _ = tx.update(grads, tx.init(params), params)
            after = _flatten(jax.tree.map(np.asarray, optax.apply_updates(params, updates)))
            out[p + "loss"] = np.asarray(loss)
            for k, g in _flatten(jax.tree.map(np.asarray, grads)).items():
                if model == "f4" or k.startswith("calibrator/"):  # the trained leaves
                    out[p + "grads/" + k] = g
                out[p + "update/" + k] = after[k] - weights[model][k]
    return out


def build_bf16_golden() -> Dict[str, np.ndarray]:
    jax = _jax_on_cpu()
    import jax.numpy as jnp

    import chip_smoke
    from dfol_vqa_tpu.config import Config as JConfig
    from dfol_vqa_tpu.models.interpreter import Interpreter
    from dfol_vqa_tpu.ontology import GQAOntology as JOntology
    from dfol_vqa_tpu_torch.convert import flatten, params_to_numpy
    from dfol_vqa_tpu_torch.data import evalset
    from dfol_vqa_tpu_torch.ontology import GQAOntology

    ont = GQAOntology()
    cfg, world, datasets, params = chip_smoke.bf16_golden_setup(ont)
    interp = Interpreter(JConfig.from_yaml(chip_smoke.config_dict(cfg)), JOntology())
    flat = flatten(params_to_numpy(params))
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(params))
    out = {"datasets": np.array(json.dumps(datasets, sort_keys=True))}
    out.update({f"param_sha256/{k}": np.array(chip_smoke.objects_digest(v))
                for k, v in flat.items()})
    for k, lb in enumerate(evalset.eval_loader(cfg, ont, world, datasets)):
        step = jax.jit(lambda p, o, m, a, spec=lb.spec: interp.forward(p, o, m, a, spec, False,
                                                                         None))
        res = step(jparams, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
                   {a: jnp.asarray(v) for a, v in lb.arrays.items()})
        p = f"batch/{k}/"
        out[p + "objects_sha256"] = np.array(chip_smoke.objects_digest(lb.objects))
        out[p + "log_probability"] = np.asarray(res["log_probability"])
        out[p + "answer_flags"] = np.asarray(res["answer_flags"])
    return out


def build_chunk_golden() -> Dict[str, np.ndarray]:
    jax = _jax_on_cpu()

    import chip_smoke
    from dfol_vqa_tpu.models.interpreter import Interpreter
    from dfol_vqa_tpu.ontology import GQAOntology as JOntology
    from dfol_vqa_tpu.train.checkpoint import _flatten
    from dfol_vqa_tpu.train.trainer import VQATrainer
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from tests.jax_batches import JaxLoader

    ont = GQAOntology()
    cfg, world, files, train_ld, val_ld = chip_smoke.chunk_golden_setup(ont)
    params = Interpreter(cfg, JOntology()).init_params(jax.random.PRNGKey(0))
    out = {f"params/{k}": v for k, v in _flatten(jax.tree.map(np.asarray, params)).items()}
    for name, f in files.items():
        out[f"datasets/{name}"] = np.array(json.dumps(f, sort_keys=True))
    trainer = VQATrainer(cfg, Interpreter(cfg, JOntology()))
    seen = chip_smoke.record_validation(trainer)
    params, _, losses = trainer.train(JaxLoader(train_ld), JaxLoader(val_ld), params)
    before = {k: out[f"params/{k}"] for k in _flatten(jax.tree.map(np.asarray, params))}
    out.update({f"update/{k}": v - before[k]
                for k, v in _flatten(jax.tree.map(np.asarray, params)).items()})
    out["validation_steps"] = np.asarray([s for s, _ in seen], np.int64)
    out["validation_errors"] = np.stack([e for _, e in seen])
    out["losses"] = np.asarray(losses)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=GOLDEN_PATH)
    ap.add_argument("--eval-out", default=EVAL_GOLDEN_PATH)
    ap.add_argument("--train-out", default=TRAIN_GOLDEN_PATH)
    ap.add_argument("--terminals-out", default=TERMINALS_GOLDEN_PATH)
    ap.add_argument("--calibrator-out", default=CALIBRATOR_GOLDEN_PATH)
    ap.add_argument("--trace-out", default=TRACE_GOLDEN_PATH)
    ap.add_argument("--bf16-out", default=BF16_GOLDEN_PATH)
    ap.add_argument("--chunk-out", default=CHUNK_GOLDEN_PATH)
    args = ap.parse_args(argv)
    for path, golden, unit, what in (
            (args.out, build_golden(), "/question", "requests"),
            (args.eval_out, build_eval_golden(), "/log_probability", "batches"),
            (args.train_out, build_train_golden(), "/loss", "training batches"),
            (args.terminals_out, build_terminals_golden(), "/objects", "terminal batches"),
            (args.calibrator_out, build_calibrator_golden(), "/eval/log_probability",
             "model batches"),
            (args.trace_out, build_trace_golden(), "/hops", "traced requests"),
            (args.bf16_out, build_bf16_golden(), "/log_probability", "bf16 batches"),
            (args.chunk_out, build_chunk_golden(), "validation_steps", "validation runs")):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez_compressed(path, **golden)
        n = (len(golden[unit]) if unit in golden else
             sum(1 for k in golden if k.endswith(unit)))
        print(f"wrote {path}: {n} {what}, {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
