"""Frozen leaves out of autograd (``optim.require_grads``) on the CPU.

The deployed stage (``cur7``) trains only the attention-transfer
calibrator on a frozen oracle. The trainer sets every parameter's
``requires_grad`` from the freeze flags before it steps, so the frozen
oracle's forward records no graph and its backward never runs. These tests
hold that rule at tiny widths (``benchmark/tests/tiny.py``: the benchmark's
``cur7-train-calib`` and ``cur5-train-shuffled`` configurations, O = 8,
state 8, batch 16, dropout 0.1 as published, ``train_chunk`` 2) on seeded
random weights (``benchmark/weights.draw``), one batch of each of the
cell's six (family, hops) files:

* with cur7's flags a frozen leaf ends a step with ``.grad`` None and its
  value bitwise as it was, and every calibrator gradient, update and Adam
  moment is bitwise the one of the same step with every leaf requiring a
  gradient (the rule before it); the step is also held against the
  benchmark's plain reference (``Reference.train_steps``);
* with cur5's flags (every network trainable) every leaf gets a gradient;
* two ``train`` calls in one process with other flags each follow their
  own, and the ``train.step`` spans carry the elements each trains;
* ``train`` over the eager chunk path (``train_chunk`` 2) is bitwise the
  run in which every leaf requires a gradient;
* one cur7-flag step over a two-rank gloo mesh against the single-process
  step on the union batch.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark import weights
from benchmark.reference.check import Reference
from benchmark.reference.ontology import GQAOntology as RefOntology
from benchmark.scenes import Scenes
from benchmark.tests.tiny import tiny_config, tiny_spec
from benchmark.traffic import mix
from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy
from dfol_vqa_tpu_torch.data import synthetic
from dfol_vqa_tpu_torch.data.dataset import ProgramDataset
from dfol_vqa_tpu_torch.data.features import SyntheticFeatures
from dfol_vqa_tpu_torch.data.loader import BatchLoader
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ontology import GQAOntology
from dfol_vqa_tpu_torch.train import trainer as trainer_module
from dfol_vqa_tpu_torch.train.optim import build_optimizer, require_grads, trainable_labels
from dfol_vqa_tpu_torch.train.trainer import VQATrainer
from dfol_vqa_tpu_torch.utils import profiling

CELL, ALL_TRAIN_CELL = "cur7-train-calib", "cur5-train-shuffled"
SEED = 2147483659  # past 32 signed bits, as the benchmark's seeds are
FILES = [f"{family}{hops}" for family, hops, _ in tiny_spec(CELL)["mix"]]
# the reference is a frozen copy of the port's plain float32 path: the same
# ops on the same values, the frozen oracle's backward added on the side
# (which feeds nothing on the calibrator's path). What may differ is the
# order of float32 sums, a few units in the last place of a leaf's largest
# value; 1e-6 of it leaves room for that and catches any real fault (a
# question left out moves the gradient by 1e-2 or more, PERF.md §2)
REF_RTOL = 1e-6
SATURATED = {"verify_rel3"}  # files whose first batch the tiny model saturates
MESH_GRAD_RTOL = 1e-5  # float32 sums over two ranks in another order
MESH_TIMEOUT = 120


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The tiny cell: cur7's and cur5's configurations, the world, a
    shuffled loader's first batch of each file and the seeded weights."""
    d = tmp_path_factory.mktemp("frozen")
    paths = {c: tiny_config(d, c) for c in (CELL, ALL_TRAIN_CELL)}
    cfgs = {c: Config.from_yaml(p) for c, p in paths.items()}
    cfg = cfgs[CELL]
    assert cfg.dropout == 0.1 and cfg.tpu.train_chunk == 2 and cfg.activate_attention_transfer
    spec = tiny_spec(CELL)
    O = cfg.tpu.max_object_num
    world = mix.make_world(RefOntology(), spec, O, cfg.box_features_dim, SEED, "cpu")
    files = mix.train_files(world, spec, SEED)
    ont = GQAOntology()
    loader = BatchLoader([ProgramDataset(qs, ont) for qs in files],
                         ProgramCompiler(ont, object_num=O, rel_slots=cfg.tpu.rel_table_size,
                                         option_pad_ladder=cfg.tpu.option_pad_ladder),
                         Scenes(world), cfg.train_batch_size, O, shuffle=True, seed=SEED)
    batches = {}
    for lb in loader:
        batches.setdefault(lb.compiled.question_ids[0].split("-")[0], lb)
    assert sorted(batches) == sorted(FILES)
    by_id = {q["question_id"]: q for qs in files for q in qs}
    values = {}
    for c in (CELL, ALL_TRAIN_CELL):
        params = Interpreter(cfgs[c], ont).init_params(torch.Generator().manual_seed(0),
                                                      torch.device("cpu"))
        values[c] = weights.draw(params, SEED, "cpu")
    return {"paths": paths, "cfgs": cfgs, "world": world, "files": files, "ont": ont,
            "batches": batches, "by_id": by_id, "values": values}


def fresh(cell, c):
    """A new parameter tree of cell ``c`` holding the seeded weights."""
    params = Interpreter(cell["cfgs"][c], cell["ont"]).init_params(
        torch.Generator().manual_seed(0), torch.device("cpu"))
    weights.copy_into(params, cell["values"][c])
    return params


def one_step(cell, c, lb, parent_rule: bool):
    """One training step of cell ``c`` on ``lb`` from the seeded weights:
    ``train_step`` (the trainer's rule), or with ``parent_rule`` every leaf
    requiring a gradient and ``compute_grads`` + the optimizer's step (the
    step before frozen leaves left autograd). Returns (loss, the gradients
    the optimizer got by name, the parameters, the optimizer)."""
    cfg = cell["cfgs"][c]
    params = fresh(cell, c)
    trainer = VQATrainer(cfg, Interpreter(cfg, cell["ont"]), device="cpu")
    opt = build_optimizer(cfg, params)
    grads, real = {}, opt.step

    def step(*a, **k):
        grads.update({n: p.grad.clone() for n, p in params.named_parameters()
                      if p.grad is not None})
        real(*a, **k)

    opt.step = step
    generator = torch.Generator().manual_seed(SEED)
    if parent_rule:
        for p in params.parameters():
            p.requires_grad_(True)
        loss = trainer.compute_grads(params, lb, generator)
        opt.step()
    else:
        loss = trainer.train_step(params, opt, lb, generator)
    return loss, grads, params, opt


def names_by(params, cfg, trains: bool):
    return sorted(n for n, on in trainable_labels(params, cfg).items() if on == trains)


@pytest.mark.parametrize("file", FILES)
def test_frozen_leaves_get_no_gradient_and_the_calibrator_step_is_bitwise(cell, file):
    lb = cell["batches"][file]
    cfg = cell["cfgs"][CELL]
    loss, grads, params, opt = one_step(cell, CELL, lb, parent_rule=False)
    loss0, grads0, params0, opt0 = one_step(cell, CELL, lb, parent_rule=True)
    frozen, trained = names_by(params, cfg, False), names_by(params, cfg, True)
    assert trained and all(n.startswith("calibrator.") for n in trained)
    assert torch.equal(loss, loss0)
    named, named0 = dict(params.named_parameters()), dict(params0.named_parameters())
    start = cell["values"][CELL]
    for n in frozen:
        assert named[n].grad is None and not named[n].requires_grad, n
        assert torch.equal(named[n].detach(), start[n]), n
    assert sorted(grads) == trained
    # the tiny random model saturates on three-hop relate chains: there the
    # loss has no gradient on either side
    live = any(grads0[n].any() for n in trained)
    assert live or file in SATURATED
    # the rule before it differentiated the frozen oracle too, and threw it away
    assert any(grads0[n].any() for n in frozen) == live
    moved = 0
    for n in trained:
        assert torch.equal(grads[n], grads0[n]), n
        assert torch.equal(named[n].detach(), named0[n].detach()), n
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.adam.state[named[n]][k], opt0.adam.state[named0[n]][k]), n
        moved += not torch.equal(named[n].detach(), start[n])
    assert moved == len(trained)  # Adam moves a leaf on its weight decay alone


@pytest.mark.parametrize("file", FILES)
def test_the_calibrator_step_matches_the_reference(cell, file):
    lb = cell["batches"][file]
    loss, _, params, opt = one_step(cell, CELL, lb, parent_rule=False)
    questions = [cell["by_id"][i] for i in lb.compiled.question_ids]
    ref = Reference(cell["paths"][CELL], cell["values"][CELL], "cpu")
    losses, grad1, final = ref.train_steps([questions], cell["world"], SEED)
    assert abs(float(loss) - losses[0]) <= REF_RTOL * abs(losses[0])
    named = dict(params.named_parameters())
    assert sorted(grad1) == names_by(params, cell["cfgs"][CELL], True)
    for n, want in grad1.items():
        got = opt.adam.state[named[n]]["exp_avg"] / 0.1  # as the reference reads it
        tol = REF_RTOL * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=tol, msg=n)
    for n, want in final.items():
        tol = REF_RTOL * float(want.abs().max())
        torch.testing.assert_close(named[n].detach(), want, rtol=0, atol=tol, msg=n)


@pytest.mark.parametrize("file", ["exist3", "query_attr2"])
def test_every_leaf_gets_a_gradient_where_every_network_trains(cell, file):
    loss, grads, params, _ = one_step(cell, ALL_TRAIN_CELL, cell["batches"][file],
                                      parent_rule=False)
    loss0, grads0, _, _ = one_step(cell, ALL_TRAIN_CELL, cell["batches"][file], parent_rule=True)
    names = [n for n, _ in params.named_parameters()]
    assert names_by(params, cell["cfgs"][ALL_TRAIN_CELL], True) == sorted(names)
    assert all(p.requires_grad and p.grad is not None for p in params.parameters())
    # a leaf the batch does not reach (the relation network on query_attr)
    # gets its gradient buffer from the optimizer, as before
    assert sorted(grads) == sorted(grads0) and torch.equal(loss, loss0)
    assert all(torch.equal(grads[n], grads0[n]) for n in grads)


def tiny_loader(cell, files=None, shuffle=True):
    cfg, ont = cell["cfgs"][CELL], cell["ont"]
    O = cfg.tpu.max_object_num
    return BatchLoader([ProgramDataset(qs, ont) for qs in files or cell["files"]],
                       ProgramCompiler(ont, object_num=O, rel_slots=cfg.tpu.rel_table_size,
                                       option_pad_ladder=cfg.tpu.option_pad_ladder),
                       Scenes(cell["world"]), cfg.train_batch_size, O, shuffle=shuffle,
                       seed=SEED)


def test_each_train_call_follows_its_own_flags(cell):
    cfg7 = cell["cfgs"][CELL]
    cfg_all = dataclasses.replace(cfg7, freeze_featurizer=False, freeze_attribute_network=False,
                                  freeze_relation_network=False, freeze_embedding_network=False)
    params = fresh(cell, CELL)
    n_all = sum(p.numel() for p in params.parameters())
    loader = tiny_loader(cell, cell["files"][:2])
    for cfg in (cfg7, cfg_all, cfg7):
        profiling.clear()
        VQATrainer(cfg, Interpreter(cfg, cell["ont"]), device="cpu").train(
            loader, None, params, seed=SEED)
        labels = trainable_labels(params, cfg)
        for n, p in params.named_parameters():
            assert p.requires_grad == labels[n], n
            assert (p.grad is not None) == labels[n], n
        want = sum(p.numel() for n, p in params.named_parameters() if labels[n])
        steps = [r[4] for r in profiling.recorded() if r[0] == "train.step"]
        assert steps and all(t["grad_elems"] == want and t["param_elems"] == n_all
                             for t in steps)
        assert (want < n_all) == (cfg is cfg7)


def test_the_eager_chunk_path_is_bitwise_the_run_with_every_leaf_differentiated(cell,
                                                                              monkeypatch):
    cfg = cell["cfgs"][CELL]
    runs = []
    for parent_rule in (False, True):
        if parent_rule:
            def every_leaf(params, cfg):
                for p in params.parameters():
                    p.requires_grad_(True)

            monkeypatch.setattr(trainer_module, "require_grads", every_leaf)
        params = fresh(cell, CELL)
        profiling.clear()
        _, _, losses = VQATrainer(cfg, Interpreter(cfg, cell["ont"]), device="cpu").train(
            tiny_loader(cell, shuffle=False), None, params, seed=SEED)
        chunks = [r[4]["steps"] for r in profiling.recorded() if r[0] == "train.step"]
        runs.append((losses, params, chunks))
    (losses, params, chunks), (losses0, params0, _) = runs
    named, named0 = dict(params.named_parameters()), dict(params0.named_parameters())
    assert 2 in chunks  # some groups ran as eager chunks of two steps
    assert np.array_equal(losses, losses0)
    start = cell["values"][CELL]
    trained = names_by(params, cfg, True)
    for n, p in named.items():
        assert torch.equal(p.detach(), named0[n].detach()), n
        assert torch.equal(p.detach(), start[n]) != (n in trained), n
        assert (p.grad is None) != (n in trained), n


def test_a_mesh_step_with_frozen_leaves_matches_one_process(cell, tmp_path):
    cfg = dataclasses.replace(cell["cfgs"][CELL], dropout=0.0)  # each rank draws its own masks
    ont = cell["ont"]
    sets = []
    for seed, (term, n, length, per_image) in enumerate((("exist", 16, 2, 8),
                                                         ("verify_rel", 13, 1, 1))):
        qs = synthetic.generate_questions(ont, n, terminal=term, length=length, seed=seed + 1)
        for i, q in enumerate(qs):
            q["imageId"] = ont._images[((seed + 1) * 100 + i // per_image) % 500]
        sets.append(qs)
    with open(tmp_path / "train.json", "w") as f:
        json.dump(sets, f)
    params = chip_smoke.model_params(cfg, ont)  # the calibrator's head drawn at random
    np.savez(tmp_path / "weights.npz", **flatten(params_to_numpy(params)))
    features = {"kind": "synthetic", "box_dim": cfg.box_features_dim, "min_objects": 2,
                "max_objects": 6}
    job = {"name": "cur7 data2", "config": chip_smoke.config_dict(cfg), "features": features,
           "datasets": str(tmp_path / "train.json"), "weights": str(tmp_path / "weights.npz"),
           "batch": 8, "steps": 2, "device": "cpu", "rtol": MESH_GRAD_RTOL,
           "mesh_shape": [2], "mesh_axes": ["data"], "fsdp": False}
    work = str(tmp_path / "mesh")
    chip_smoke.run_mesh_job(job, 2, work, MESH_TIMEOUT)
    records = chip_smoke.read_records(os.path.join(work, "records.npz"))
    union = chip_smoke.mesh_loader(cfg, ont, SyntheticFeatures(
        box_dim=cfg.box_features_dim, min_objects=2, max_objects=6), sets, 8)
    labels = trainable_labels(params, cfg)
    for t, (rec, ub) in enumerate(zip(records, union)):
        one = params_from_numpy(rec["before"])
        require_grads(one, cfg)
        want_loss = VQATrainer(cfg, Interpreter(cfg, ont), device="cpu").compute_grads(
            one, ub).item()
        for n, p in one.named_parameters():
            assert (p.grad is None) != labels[n], n
            key = n.replace(".", "/")
            if not labels[n]:  # the mesh reduces a zero buffer for a leaf with no gradient
                assert not rec["grads"][key].any(), key
                assert np.array_equal(rec["after"][key], rec["before"][key]), key
        chip_smoke.check_mesh_step(cfg, rec, want_loss, chip_smoke.grads_of(one),
                                   MESH_GRAD_RTOL, f"cur7 data2 step {t}")
        assert any(rec["grads"][n.replace(".", "/")].any() for n in labels if labels[n])
