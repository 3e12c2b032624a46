"""The device mesh on the CPU: the port's training over gloo in several
processes against the JAX package's unsharded step.

Each layout runs ``chip_smoke.mesh_worker`` in one process per rank
(``chip_smoke.run_mesh_job``: rendezvous through a file under
``tmp_path``, ``CHILD_TIMEOUT`` seconds per process, so a hung collective
fails the test). The children import no JAX; this process runs JAX on what
they recorded. Tiny widths (``tests/test_pipeline_train.tiny_cfg``'s),
dropout 0, four lockstep steps over two files: 16 ``exist`` questions on
two images (the shared-image route, per rank and on the union) and 13
``verify_rel`` questions on images of their own (the per-question route),
whose last step carries one pad question on rank 0 and two on rank 1, so a
mean over ranks would show. Global batch 8, per data rank 4.

* ``test_mesh_steps_match_jax``: 2 ranks ``('data',)``, 2 ranks
  ``('data',)`` + FSDP, 4 ranks ``('data', 'model')`` and 4 ranks
  ``('data', 'model')`` + FSDP. Every step is held against JAX's unsharded
  step on the union batch from the parameters and Adam state the mesh had
  before it (``chip_smoke.check_mesh_step``): the loss within
  ``TRAIN_LOSS_RTOL``, every gradient leaf within ``GRAD_RTOL`` of its
  largest value (float32 sums over ranks in another order), the
  parameters after it within ``chip_smoke.adam_bound``; the answer flags
  equal by question id (but for float32 near-ties).
* ``test_mesh_eval_matches_one_device``: after the steps, ``test`` (with
  hardset mining), ``predict`` and a checkpoint under each layout equal one
  device's on the trained parameters: the error vector and counts, the
  prediction list, the hardset files; only rank 0 wrote files. The FSDP
  checkpoint loads on one device and in the JAX package.
* ``test_mesh_step_reduces_over_the_global_batch``: two ``('data',)``
  ranks whose rows differ in what the executor reduces over the question
  axis (negated tokens, selects, with the calibrator on), each step held
  against JAX's unsharded step as above: every rank carries its global
  batch's flags (``trainer.with_global_flags``).
* ``torchrun ... gqa_experiment -c`` trains over two CPU processes as
  one process trains, also over two repetitions that each reload ``last``.
* The host-sharded loader covers every question once; a mesh shape that
  does not cover the processes raises.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dfol_vqa_tpu.train import checkpoint as jckpt
from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu.config import Config as JConfig
from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy, unflatten
from dfol_vqa_tpu_torch.data import synthetic
from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
from dfol_vqa_tpu_torch.data.dataset import ProgramDataset, iter_batches
from dfol_vqa_tpu_torch.data.loader import BatchLoader
from dfol_vqa_tpu_torch.data.features import SyntheticFeatures
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ontology import GQAOntology as TOntology
from dfol_vqa_tpu_torch.parallel import mesh as pmesh
from dfol_vqa_tpu_torch.train import checkpoint as ckpt
from dfol_vqa_tpu_torch.train.trainer import VQATrainer

from tests.test_torch_experiment import data, read_tree, run_dir  # noqa: F401 (fixture)
from tests.test_torch_train_loop import assert_params_close

CHILD_TIMEOUT = 120
GRAD_RTOL = 1e-5
BATCH = 8
LR = 1e-3
FEATURES = {"kind": "synthetic", "box_dim": 32, "min_objects": 2, "max_objects": 6}
LAYOUTS = {
    "data2": (2, [2], ["data"], False),
    "data2_fsdp": (2, [2], ["data"], True),
    "data2_model2": (4, [2, 2], ["data", "model"], False),
    "data2_model2_fsdp": (4, [2, 2], ["data", "model"], True),
}


def tiny_config() -> Config:
    cfg = Config(box_features_dim=32, oracle_input_dim=16, word_embedding_dim=12,
                 featurizer_layers_config=[], attribute_network_layers_config=[8],
                 relation_network_layers_config=[8], dropout=0.0, learning_rate=LR,
                 verbose=False)
    cfg.tpu.max_object_num = 6
    cfg.tpu.rel_table_size = 4
    return cfg


def questions(ontology, term, n, length, seed, per_image):
    qs = synthetic.generate_questions(ontology, n, terminal=term, length=length, seed=seed)
    for i, q in enumerate(qs):
        q["imageId"] = ontology._images[(seed * 100 + i // per_image) % 500]
    return qs


@pytest.fixture(scope="module")
def mesh_data(tmp_path_factory):
    """The job files every layout shares: config, weights (JAX's init,
    ``PRNGKey(3)``), the training files and the evaluation files."""
    root = tmp_path_factory.mktemp("mesh")
    ont = TOntology()
    cfg = tiny_config()
    train = [questions(ont, "exist", 16, 2, 1, 8), questions(ont, "verify_rel", 13, 1, 2, 1)]
    evals = [questions(ont, "query_attr", 10, 1, 3, 5), questions(ont, "exist", 14, 2, 4, 2)]
    paths = {}
    for name, sets in (("train", train), ("eval", evals)):
        paths[name] = str(root / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(sets, f)
    jparams = JInterpreter(JConfig.from_yaml(chip_smoke.config_dict(cfg)), ont).init_params(
        jax.random.PRNGKey(3))
    weights = str(root / "weights.npz")
    np.savez(weights, **flatten(jax.tree.map(np.asarray, jparams)))
    job = {"name": "", "config": chip_smoke.config_dict(cfg), "features": FEATURES,
           "datasets": paths["train"], "weights": weights, "batch": BATCH, "steps": 100,
           "device": "cpu", "rtol": GRAD_RTOL,
           "eval": {"datasets": paths["eval"], "batch": BATCH}}
    return cfg, ont, train, evals, job


@pytest.fixture(scope="module")
def runs(mesh_data, tmp_path_factory):
    """Each layout's job, run once: {layout: (rank results, records)}."""
    cfg, ont, train, evals, job = mesh_data
    out = {}
    for layout, (world, shape, axes, fsdp) in LAYOUTS.items():
        work = str(tmp_path_factory.mktemp(layout))
        res = chip_smoke.run_mesh_job(dict(job, name=layout, mesh_shape=shape, mesh_axes=axes,
                                           fsdp=fsdp), world, work, CHILD_TIMEOUT)
        out[layout] = (res, chip_smoke.read_records(os.path.join(work, "records.npz")), work)
    return out


def union_batches(cfg, ont, sets, batch=BATCH):
    return list(chip_smoke.mesh_loader(cfg, ont, SyntheticFeatures(
        box_dim=32, min_objects=2, max_objects=6), sets, batch))


def jax_loss_grads(cfg, ont, flat, lb):
    """JAX's normalised loss, gradients and outputs on ``lb`` at the flat
    parameters ``flat``."""
    jcfg = JConfig.from_yaml(chip_smoke.config_dict(cfg))
    interp = JInterpreter(jcfg, ont)
    jparams = jax.tree.map(jnp.asarray, unflatten(flat))
    arrays = {k: jnp.asarray(v) for k, v in lb.arrays.items()}

    def loss_fn(p):
        out = interp.forward(p, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask), arrays,
                             lb.spec, True, jax.random.PRNGKey(0))
        return out["loss"] / jnp.maximum(jnp.sum(arrays["question_mask"]), 1.0), out

    (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    return float(loss), flatten(jax.tree.map(np.asarray, grads)), out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_steps_match_jax(mesh_data, runs, layout):
    cfg, ont, train, _, _ = mesh_data
    res, records, _ = runs[layout]
    world, shape, _, fsdp = LAYOUTS[layout]
    batches = union_batches(cfg, ont, train)
    assert len(records) == len(batches) == 4
    assert [r["data_rank"] for r in res] == [r // (world // shape[0]) for r in range(world)]
    # the last step's pad questions differ by rank: 1 on rank 0, 2 on rank 1
    assert [rec["count"] for rec in records] == [8, 8, 8, 5]
    placement = res[0]["placement"]
    assert any(d is not None for d, _ in placement.values()) == fsdp
    assert (placement["embedding.w"][1] == 1) == (len(shape) == 2)
    for t, (rec, lb) in enumerate(zip(records, batches)):
        want_loss, want_grads, out = jax_loss_grads(cfg, ont, rec["before"], lb)
        chip_smoke.check_mesh_step(cfg, rec, want_loss, want_grads, GRAD_RTOL,
                                   f"{layout} step {t}")
        lp = np.asarray(out["log_probability"])
        chip_smoke.check_mesh_flags(res[0]["flags"][t],
                                    chip_smoke.answer_rows(lb, np.asarray(out["answer_flags"])),
                                    chip_smoke.tie_rows(lb, lp), f"{layout} step {t}")
        assert all(r["flags"][t] == res[0]["flags"][t] for r in res)
        assert all(r["losses"][t] == res[0]["losses"][t] for r in res if r["model_rank"] == 0)
    for t in range(3):
        for key, v in records[t]["after"].items():
            np.testing.assert_array_equal(v, records[t + 1]["before"][key])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_eval_matches_one_device(mesh_data, runs, tmp_path, layout):
    cfg, ont, _, evals, _ = mesh_data
    res, records, work = runs[layout]
    params = params_from_numpy(records[-1]["after"])
    one = tmp_path / "one"
    interp = Interpreter(cfg, ont)
    trainer = VQATrainer(cfg, interp, device="cpu", hardset_path=str(one / "hardset"))
    loader = union_batches(cfg, ont, evals)
    error, _ = trainer.test(loader, params)
    with open(one / "predictions.json", "w") as f:
        preds = VQATrainer(cfg, interp, device="cpu").predict(loader, params, f)
    for r in res:
        np.testing.assert_array_equal(r["test_error"], error)
        np.testing.assert_array_equal(r["test_counts"], trainer.last_test_counts)
        assert r["predictions"] == preds
    assert trainer.last_test_counts[0] == 24
    assert read_tree(os.path.join(work, "files0")) == read_tree(one)
    for rank in range(1, len(res)):
        assert read_tree(os.path.join(work, f"files{rank}")) == {}
        assert not os.path.exists(os.path.join(work, f"ckpt{rank}"))
    path = os.path.join(work, "ckpt0")
    loaded, step = ckpt.load(path, cfg.model_name, Interpreter(cfg, ont).init_params(
        torch.Generator().manual_seed(0)))
    assert step == 0
    got = flatten(params_to_numpy(loaded))
    for key, v in records[-1]["after"].items():
        np.testing.assert_array_equal(got[key], v)
    if layout == "data2_fsdp":
        jcfg = JConfig.from_yaml(chip_smoke.config_dict(cfg))
        jparams, _ = jckpt.load(path, cfg.model_name,
                                JInterpreter(jcfg, ont).init_params(jax.random.PRNGKey(0)))
        for key, v in flatten(jax.tree.map(np.asarray, jparams)).items():
            np.testing.assert_array_equal(v, records[-1]["after"][key])


def torchrun_against_one_process(data, tmp_path, load_model: str, reps: int):  # noqa: F811
    """``torchrun --nproc-per-node 2 -m ...gqa_experiment cfg -l <load_model>
    -c`` (global train batch 6, 3 rows a rank; validation and test 12, 6 a
    rank; ``reps`` repetitions of two epochs) against the port's ``run`` in
    one process: the parameters after training, the epoch losses (rtol
    1e-4) and error arrays."""
    from dfol_vqa_tpu_torch.experiments import experiment

    one = experiment.GQAObjectBoxExperiment().run(
        run_dir(data, tmp_path, "one", repetition_num=reps), load_model=load_model,
        device="cpu")
    cfg_path = run_dir(data, tmp_path, "mesh", repetition_num=reps,
                       tpu={"max_object_num": 6, "rel_table_size": 4, "train_chunk": 1,
                            "mesh_shape": [2]})
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "dfol_vqa_tpu_torch.experiments.gqa_experiment", cfg_path, "-l", load_model,
         "-c"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=CHILD_TIMEOUT,
        env=dict(os.environ, PYTHONPATH=chip_smoke.ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    best = tmp_path / "mesh" / "tiny" / "t0" / "best"
    np.testing.assert_allclose(np.load(best / "losses.npy"), one["train_loss"], rtol=1e-4)
    np.testing.assert_array_equal(np.load(best / "errors.npy"), one["train_error"])
    with np.load(tmp_path / "mesh" / "tiny" / "t0" / "last" / "tiny.npz") as z:
        got = {k: z[k] for k in z.files if k != ckpt.STEP_KEY}
    assert_params_close(got, flatten(params_to_numpy(one["params"])), LR, 2 * 4 * reps)


def test_torchrun_cli_trains_over_two_cpu_processes(data, tmp_path):  # noqa: F811
    """One repetition from the shared ``best/`` weights."""
    torchrun_against_one_process(data, tmp_path, "best", 1)


def test_torchrun_cli_reloads_last_each_repetition(data, tmp_path):  # noqa: F811
    """Two repetitions, each reloading ``last``: rank 0 alone wrote it and
    alone reads it back, after its own writes, and broadcasts it
    (``VQATrainer.load``), so no rank starts the second repetition from an
    older file than the one process does."""
    torchrun_against_one_process(data, tmp_path, "last", 2)


def test_host_sharded_loader_partitions_data(ontology):
    """The port of ``tests/test_sharding.py:109``, and the loader: every
    question once over the shards."""
    qs = synthetic.generate_questions(TOntology(), 40, terminal="exist", seed=31)
    ds = ProgramDataset(qs, TOntology())
    seen = []
    for shard in range(4):
        for batch, n_pad in iter_batches([ds], 4, shuffle=False, num_shards=4, shard_index=shard):
            seen += [q["question_id"] for q in batch[: 4 - n_pad]]
    assert sorted(seen) == sorted(q["question_id"] for q in qs)
    cfg = tiny_config()
    compiler = ProgramCompiler(TOntology(), object_num=6, rel_slots=4)
    for shuffle in (False, True):
        got = []
        for shard in range(3):
            loader = BatchLoader([ds], compiler, SyntheticFeatures(box_dim=32), 5,
                                 cfg.tpu.max_object_num, shuffle=shuffle, prefetch=0,
                                 num_shards=3, shard_index=shard)
            got += [qid for lb in loader for qi, qid in enumerate(lb.compiled.question_ids)
                    if lb.compiled.question_mask[qi] > 0]
        assert sorted(got) == sorted(q["question_id"] for q in qs)


def test_mesh_shape_against_the_world_raises(tmp_path):
    """``prod(tpu.mesh_shape)`` must equal the processes of the launch:
    without a launch the world is one process, and a rendezvous of one
    process is one too; the axes must be ``('data',)`` or ``('data',
    'model')``. Each raises before any process group is joined."""
    with pytest.raises(ValueError, match="1 process"):
        pmesh.make_mesh([2], ["data"], device="cpu")
    init = {"init_method": f"file://{tmp_path / 'rdv'}", "rank": 0, "world_size": 1}
    with pytest.raises(ValueError, match="1 process"):
        pmesh.make_mesh([2], ["data"], device="cpu", **init)
    with pytest.raises(ValueError, match="mesh_axes"):
        pmesh.make_mesh([1, 1], ["model", "data"], device="cpu", **init)
    assert not torch.distributed.is_initialized()
    cfg = tiny_config()
    cfg.tpu.mesh_shape = (2,)
    assert pmesh.distributed_requested(cfg)
    with pytest.raises(ValueError, match="multiple"):
        pmesh.batch_sharding(type("M", (), {"n_data": 3, "data_rank": 0})(), 8)


def test_mesh_step_reduces_over_the_global_batch(tmp_path):
    """Rank 0's rows (even positions: the loader shards by stride) negate
    their filters and select real nouns; rank 1's (odd positions) negate
    nothing and select with the wildcard (token 0). JAX reduces over the
    global batch: the lpn round trip of negation runs on every row, and the
    calibrator keeps a select state for every row. Two ``('data',)`` ranks,
    the calibrator on, two steps, each held against JAX's unsharded step on
    the union batch as ``test_mesh_steps_match_jax`` holds them."""
    ont = TOntology()
    cfg = dataclasses.replace(tiny_config(), activate_attention_transfer=True,
                              attention_transfer_state_dim=8)
    neg = synthetic.generate_questions(ont, 8, terminal="exist", length=2, seed=7,
                                       neg_prob=1.0)
    wild = synthetic.generate_questions(ont, 8, terminal="exist", length=2, seed=8,
                                        wildcard_prob=1.0)
    qs = [q for pair in zip(neg, wild) for q in pair]
    for i, q in enumerate(qs):
        q["question_id"] = f"flags-{i}"
        q["imageId"] = ont._images[i % 500]
    sets = [qs]
    batches = union_batches(cfg, ont, sets)
    assert len(batches) == 2
    for lb in batches:  # the global batch negates and selects; rank 1's rows do neither
        assert (lb.arrays["arg_tok"][1::2] >= 0).all() and (lb.arrays["arg_tok"] < 0).any()
        assert (lb.arrays["arg_tok"][1::2, :, 0] == 0).all()
        assert (lb.arrays["arg_tok"][0::2, :, 0] != 0).any()
    path = str(tmp_path / "train.json")
    with open(path, "w") as f:
        json.dump(sets, f)
    jparams = JInterpreter(JConfig.from_yaml(chip_smoke.config_dict(cfg)), ont).init_params(
        jax.random.PRNGKey(5))
    weights = str(tmp_path / "weights.npz")
    np.savez(weights, **flatten(jax.tree.map(np.asarray, jparams)))
    job = {"name": "flags", "config": chip_smoke.config_dict(cfg), "features": FEATURES,
           "datasets": path, "weights": weights, "batch": BATCH, "steps": 100,
           "device": "cpu", "rtol": GRAD_RTOL, "mesh_shape": [2], "mesh_axes": ["data"],
           "fsdp": False}
    work = str(tmp_path / "run")
    res = chip_smoke.run_mesh_job(job, 2, work, CHILD_TIMEOUT)
    records = chip_smoke.read_records(os.path.join(work, "records.npz"))
    assert len(records) == 2
    for t, (rec, lb) in enumerate(zip(records, batches)):
        want_loss, want_grads, out = jax_loss_grads(cfg, ont, rec["before"], lb)
        chip_smoke.check_mesh_step(cfg, rec, want_loss, want_grads, GRAD_RTOL, f"flags step {t}")
        lp = np.asarray(out["log_probability"])
        chip_smoke.check_mesh_flags(res[0]["flags"][t],
                                    chip_smoke.answer_rows(lb, np.asarray(out["answer_flags"])),
                                    chip_smoke.tie_rows(lb, lp), f"flags step {t}")
