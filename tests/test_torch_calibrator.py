"""The attention-transfer calibrator: the port against the JAX package (CPU).

Tiny widths (``trainset.demo_train_config(tiny=True)``, state S = 8), the
JAX init from ``PRNGKey(4)`` with the output head drawn at random (normal x
0.4, as ``tests/test_calibrator_parity.py`` draws it): at init the head
gives alpha = beta = c = 1, d = 1/2, so ``_modulate`` returns its input up
to rounding and a comparison there would test nothing. The batches are
``tests/test_torch_terminals.terminal_batch``'s: every question terminal
on the shared-image route (16 questions on 4 images) and the per-question
route (shuffled).

Tolerances (float32 sums in another order by XLA and ATen throughout):
``LSTMCell`` within 1e-6; every modulation tensor within 1e-5;
log-probabilities within atol 1e-5 and answer flags and matches equal;
gradients to every calibrator leaf within ``grad_rtol(term)`` of the leaf's
largest value: ``GRAD_RTOL`` = 1e-5, and ``SOFTMAX_GRAD_RTOL`` = 1e-4 for the
two terminals that end in a softmax over the attribute options
(``query_attr``, ``choose_attr``), where this file's readings are 5.95e-5
(``query_attr``, per-question), 1.33e-5 (``query_attr``, shared) and 1.07e-5
(``choose_attr``, shared); every other terminal and route reads at most
4.7e-6. A control holds each gate's teeth: the same gradients with the
output head's weight rounded to bfloat16 read 2.1e-3 to 3.0e-2, and must
fail the gate. One optimizer step with the last curriculum stage's freeze
flags (oracle frozen, calibrator trained) goes through
``tests/test_torch_train_loop.check_step`` at ``grad_rtol(term)`` of each
leaf's own largest value, the parameters within ``adam_bound``, the frozen
ones unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu import nn as jnn
from dfol_vqa_tpu.models import calibrator as jcal
from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu_torch import nn
from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy
from dfol_vqa_tpu_torch.data import evalset, trainset
from dfol_vqa_tpu_torch.data.transfer import to_device_batch
from dfol_vqa_tpu_torch.models import calibrator as cal
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from chip_smoke import grads_of
from tests.test_torch_terminals import TERMINALS, terminal_batch
from tests.test_torch_train_loop import check_step

STATE = 8
GRAD_RTOL = 1e-5
SOFTMAX_GRAD_RTOL = 1e-4
OPEN = ("query_attr", "choose_attr", "choose_rel")  # modulator off at eval


def grad_rtol(term):
    return SOFTMAX_GRAD_RTOL if term in ("query_attr", "choose_attr") else GRAD_RTOL


def calib_cfg(**kw):
    cfg = trainset.demo_train_config(tiny=True)
    return dataclasses.replace(cfg, activate_attention_transfer=True,
                               attention_transfer_state_dim=STATE, **kw)


def randomize_head(jparams, seed=5):
    """The output head's weights normal x 0.4 (the bias keeps its init)."""
    out = jparams["calibrator"]["out"]
    out["w"] = jax.random.normal(jax.random.PRNGKey(seed), out["w"].shape) * 0.4
    return jparams


@pytest.fixture(scope="module")
def setup(ontology):
    cfg = calib_cfg()
    world = evalset.demo_world(ontology, tiny=True)
    jparams = randomize_head(JInterpreter(cfg, ontology).init_params(jax.random.PRNGKey(4)))
    return cfg, world, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def batches(ontology, setup):
    cfg, world, *_ = setup
    return {(term, route): terminal_batch(ontology, cfg, world, term, route)
            for term in TERMINALS for route in ("shared", "per_question")}


def jax_forward(cfg, ontology, jparams, lb, is_training, **kw):
    return JInterpreter(cfg, ontology).forward(
        jparams, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
        {k: jnp.asarray(v) for k, v in lb.arrays.items()}, lb.spec, is_training, None, **kw)


def port_forward(cfg, ontology, tparams, lb, is_training, **kw):
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    with torch.no_grad():
        return Interpreter(cfg, ontology).forward(tparams, objs, mask, arrays, lb.spec,
                                                  is_training=is_training, **kw)


def assert_same_outputs(got, want):
    lp = got["log_probability"].numpy()
    assert np.isfinite(lp).all()
    np.testing.assert_allclose(lp, np.asarray(want["log_probability"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["answer_flags"].numpy(), np.asarray(want["answer_flags"]))
    np.testing.assert_array_equal(got["match"].numpy(), np.asarray(want["match"]))


# ------------------------------------------------------------------ LSTMCell


def test_lstm_cell_matches_jax():
    rng = np.random.default_rng(0)
    p = jnn.lstm_cell_init(jax.random.PRNGKey(1), 10, 6)
    cell = nn.LSTMCell(*(torch.from_numpy(np.array(p[k]))
                         for k in ("w_ih", "w_hh", "b_ih", "b_hh")))
    x = rng.standard_normal((3, 5, 10)).astype(np.float32)  # leading (B, K) dims
    h, c = (rng.standard_normal((3, 5, 6)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        got = cell(torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)))
    want = jnn.lstm_cell(p, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_lstm_cell_init():
    g = torch.Generator().manual_seed(0)
    cell = nn.LSTMCell.init(10, 16, g)
    shapes = {n: tuple(p.shape) for n, p in cell.named_parameters()}
    assert shapes == {"w_ih": (10, 64), "w_hh": (16, 64), "b_ih": (64,), "b_hh": (64,)}
    assert all(float(p.detach().abs().max()) <= 0.25 for p in cell.parameters())


def test_calibrator_init_layout(ontology, setup):
    """The port's init has the JAX tree's keys and shapes, and the identity
    head: zero weights, bias (-log 9, -log 9, -log 9, 0)."""
    cfg, _, jparams, _ = setup
    p = Interpreter(cfg, ontology).init_params(torch.Generator().manual_seed(0))
    got = {k: v.shape for k, v in flatten(params_to_numpy(p)).items()}
    want = {k: v.shape for k, v in flatten(jax.tree.map(np.asarray, jparams)).items()}
    assert got == want and sum(k.startswith("calibrator/") for k in got) == 10
    assert not p.calibrator.out.w.detach().any()
    np.testing.assert_allclose(p.calibrator.out.b.detach().numpy(),
                               [-np.log(9.0)] * 3 + [0.0], rtol=1e-7)
    np.testing.assert_allclose(torch.sigmoid(p.calibrator.out.b).detach().numpy() * [10, 10, 10, 1],
                               [1.0, 1.0, 1.0, 0.5], rtol=1e-6)


# ------------------------------------------------------------- modulations


@pytest.mark.parametrize("term", TERMINALS)
def test_modulations_match_jax(ontology, setup, batches, term):
    """Every slot's and the terminal's modulation tensors within 1e-5."""
    cfg, _, jparams, tparams = setup
    lb = batches[(term, "shared")]
    interp = Interpreter(cfg, ontology)
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    with torch.no_grad():
        world = interp.build_world(tparams, objs, mask, arrays.get("rel_tokens"),
                                   img_index=arrays.get("img_index"))
        got = cal.compute_modulations(tparams.calibrator, interp, world, arrays, lb.spec)
    want = jcal.compute_modulations(jparams["calibrator"], JInterpreter(cfg, ontology), None,
                                    {k: jnp.asarray(v) for k, v in lb.arrays.items()}, lb.spec)
    assert set(got["terminal"]) == set(want["terminal"])
    pairs = [(f"terminal/{k}", got["terminal"][k], want["terminal"][k]) for k in want["terminal"]]
    for b, (gs, ws) in enumerate(zip(got["slots"], want["slots"])):
        assert len(gs) == len(ws)
        for si, (g, w) in enumerate(zip(gs, ws)):
            assert (g is None) == (w is None) and (g is None or set(g) == set(w))
            pairs += [(f"slot {b}/{si}/{k}", g[k], w[k]) for k in (w or {})]
    assert pairs
    for name, g, w in pairs:
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)


# ----------------------------------------------------------------- forward

MODES = [("eval", False), ("eval", True), ("train", False)]


@pytest.mark.parametrize("route", ["shared", "per_question"])
@pytest.mark.parametrize("mode,hard", MODES)
@pytest.mark.parametrize("term", TERMINALS)
def test_forward_matches_jax(ontology, setup, batches, term, mode, hard, route):
    cfg, _, jparams, tparams = setup
    cfg = dataclasses.replace(cfg, hard_mode=hard)
    lb = batches[(term, route)]
    training = mode == "train"
    assert_same_outputs(port_forward(cfg, ontology, tparams, lb, training),
                        jax_forward(cfg, ontology, jparams, lb, training))


@pytest.mark.parametrize("variant", ["modulator_switch_off", "last_op_only"])
@pytest.mark.parametrize("term", TERMINALS)
def test_forward_variants_match_jax(ontology, setup, batches, term, variant):
    """In training (where every terminal runs the modulator):
    ``modulator_switch=False``, and ``apply_modulation_everywhere=False``
    (only the terminal's modulations apply)."""
    cfg, _, jparams, tparams = setup
    lb = batches[(term, "shared")]
    kw = {}
    if variant == "modulator_switch_off":
        kw["modulator_switch"] = False
    else:
        cfg = dataclasses.replace(cfg, apply_modulation_everywhere=False)
    assert_same_outputs(port_forward(cfg, ontology, tparams, lb, True, **kw),
                        jax_forward(cfg, ontology, jparams, lb, True, **kw))


# ------------------------------------------ the JAX package's calibrator cases


@pytest.mark.parametrize("term", ["exist", "verify_rel", "query_attr", "choose_rel", "two_same",
                                  "compare", "and"])
def test_zero_init_modulator_is_identity(ontology, setup, batches, term):
    """With the init head the calibrator changes no output (within 1e-5),
    in training, where it runs for every terminal."""
    cfg, _, jparams, _ = setup
    params = params_from_numpy(jax.tree.map(np.asarray, JInterpreter(cfg, ontology).init_params(
        jax.random.PRNGKey(4))))
    lb = batches[(term, "shared")]
    on = port_forward(cfg, ontology, params, lb, True)
    off = port_forward(dataclasses.replace(cfg, activate_attention_transfer=False), ontology,
                       params, lb, True)
    np.testing.assert_allclose(on["log_probability"].numpy(), off["log_probability"].numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("term", TERMINALS)
def test_modulator_off_for_open_questions_at_eval(ontology, setup, batches, monkeypatch, term):
    """At eval the modulator is off for query_attr, choose_attr and
    choose_rel (exactly the forward without it) and on for every other
    terminal, compare included; in training it is on for all."""
    cfg, _, _, tparams = setup
    lb = batches[(term, "shared")]
    calls = []
    real = cal.compute_modulations
    monkeypatch.setattr(cal, "compute_modulations",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    ev = port_forward(cfg, ontology, tparams, lb, False)
    n_eval = len(calls)
    ev_off = port_forward(cfg, ontology, tparams, lb, False, modulator_switch=False)
    port_forward(cfg, ontology, tparams, lb, True)
    assert n_eval == int(term not in OPEN) and len(calls) == n_eval + 1
    if term in OPEN:
        np.testing.assert_array_equal(ev["log_probability"].numpy(),
                                      ev_off["log_probability"].numpy())


@pytest.mark.parametrize("route", ["shared", "per_question"])
@pytest.mark.parametrize("term", TERMINALS)
def test_calibrator_gradients_match_jax(ontology, setup, batches, term, route):
    """The training loss's gradient to every calibrator leaf against
    ``jax.grad``, within ``grad_rtol(term)`` of the leaf's largest value;
    the output head's weight gets a nonzero gradient. Control: with the
    head's weight rounded to bfloat16 the port's gradients fail that gate."""
    cfg, _, jparams, _ = setup
    lb = batches[(term, route)]
    arrays = {k: jnp.asarray(v) for k, v in lb.arrays.items()}
    jinterp = JInterpreter(cfg, ontology)

    def loss_fn(p):
        out = jinterp.forward(p, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask), arrays,
                              lb.spec, True, None)
        return out["loss"] / jnp.maximum(jnp.sum(arrays["question_mask"]), 1.0)

    want = flatten(jax.tree.map(np.asarray, {"calibrator": jax.grad(loss_fn)(jparams)[
        "calibrator"]}))
    _, objs, mask, t_arrays = to_device_batch(lb, "cpu")

    def port_grads(head_bf16):
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
        if head_bf16:
            with torch.no_grad():
                w = tparams.calibrator.out.w
                w.copy_(w.to(torch.bfloat16).float())
        out = Interpreter(cfg, ontology).forward(tparams, objs, mask, t_arrays, lb.spec,
                                                 is_training=True)
        (out["loss"] / torch.clamp(torch.sum(t_arrays["question_mask"]), min=1.0)).backward()
        return {k: v for k, v in grads_of(tparams).items() if k.startswith("calibrator/")}

    got, rtol = port_grads(False), grad_rtol(term)
    assert set(got) == set(want) and len(got) == 10
    for k, w in want.items():
        mag = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, atol=rtol * mag, rtol=0, err_msg=k)
    assert np.abs(got["calibrator/out/w"]).max() > 0
    control = port_grads(True)
    assert max(float(np.abs(control[k] - w).max() / np.abs(w).max())
               for k, w in want.items() if np.any(w)) > 10 * rtol


@pytest.mark.parametrize("route", ["shared", "per_question"])
@pytest.mark.parametrize("term", ["exist", "verify_rel", "query_attr", "choose_rel", "two_same",
                                  "compare"])
def test_calibrator_step_matches_jax(ontology, setup, batches, term, route):
    """One step with the freeze flags of ``cur6``/``cur7`` (the oracle
    frozen, the calibrator trained) against JAX's loss, gradients and
    optax step; the frozen leaves do not move."""
    cfg, _, jparams, _ = setup
    cfg = dataclasses.replace(cfg, freeze_featurizer=True, freeze_attribute_network=True,
                              freeze_relation_network=True, freeze_embedding_network=True)
    check_step(cfg, JInterpreter(cfg, ontology), jparams, Interpreter(cfg, ontology),
               batches[(term, route)], rtol=grad_rtol(term), floor=0.0)


def test_card_vs_cpu_steps_on_cpu(ontology, setup, batches):
    """``chip_smoke.card_vs_cpu_steps``, the phase that holds each training
    step on the card against the CPU's from the card's parameters and Adam
    state, with both sides on the CPU: three steps with the last curriculum
    stage's freeze flags agree exactly, launch no kernel, move every
    calibrator leaf and leave the frozen oracle bitwise as it was."""
    from chip_smoke import card_vs_cpu_steps, flat_params

    cfg, _, _, tparams = setup
    cfg = dataclasses.replace(cfg, freeze_featurizer=True, freeze_attribute_network=True,
                              freeze_relation_network=True, freeze_embedding_network=True)
    lbs = [batches[(term, "shared")] for term in ("exist", "query_attr", "compare")]
    start = flat_params(tparams)
    rec = card_vs_cpu_steps(cfg, ontology, tparams, lbs, "cpu", "cpu", [0, 0, 0, 0])
    assert len(rec["grads"]) == 3 and all(a == b for a, b in rec["losses"])
    after = flat_params(rec["params"])
    for k, v in start.items():
        assert np.array_equal(after[k], v) != k.startswith("calibrator/"), k
    assert flat_params(tparams).keys() == start.keys()


# ------------------------------------------------- the shipped configurations


@pytest.mark.parametrize("name", ["sample", "cur6", "cur7"])
@pytest.mark.parametrize("training", [False, True])
def test_shipped_configs_run(ontology, name, training):
    """``configs/sample_config.yaml`` and the calibrator curriculum stages
    (``cur6``, ``cur7``) load with the port's ``Config.from_yaml`` at their
    own widths (2048-d boxes, oracle 512, GloVe 300, state 50, O = 100),
    build an ``Interpreter`` and run one batch of relating ``exist``
    questions through the calibrator, within atol 1e-5 of JAX from the same
    weights (head drawn at random)."""
    from dfol_vqa_tpu.config import Config as JConfig
    from dfol_vqa_tpu_torch.config import Config
    from dfol_vqa_tpu_torch.data.planted import PlantedWorld
    from tests.test_torch_trainable import CONFIGS, ROOT

    path = f"{ROOT}/{CONFIGS[name]}"
    cfg, jcfg = Config.from_yaml(path), JConfig.from_yaml(path)
    assert cfg.activate_attention_transfer and cfg.attention_transfer_state_dim == 50
    assert (cfg.box_features_dim, cfg.oracle_input_dim, cfg.word_embedding_dim) == (2048, 512, 300)
    world = PlantedWorld(ontology, box_dim=2048, n_nouns=6, n_attrs=4, n_images=8, min_objects=4,
                         max_objects=8, noise=0.1, seed=0)
    qs = evalset.family_questions(world, "exist", 4, 2, seed=3, prefix="cfg-")
    loader = trainset.train_loader(dataclasses.replace(cfg, train_batch_size=4), ontology, world,
                                   [qs], shuffle=False)
    (lb,) = list(loader)
    assert lb.objects.shape[1] == cfg.tpu.max_object_num == 100
    jparams = randomize_head(JInterpreter(jcfg, ontology).init_params(jax.random.PRNGKey(0)))
    got = port_forward(cfg, ontology, params_from_numpy(jax.tree.map(np.asarray, jparams)), lb,
                       training)
    assert_same_outputs(got, jax_forward(jcfg, ontology, jparams, lb, training))


@pytest.mark.parametrize("term", trainset.SUPERVISION_TERMINALS)
def test_supervision_terminals_match_jax(ontology, setup, term):
    """The scene-graph supervision terminals with the calibrator on (both
    passes run from zero states, no terminal modulation), in training,
    within atol 1e-5 of JAX."""
    cfg, _, jparams, tparams = setup
    (lb,) = list(trainset.supervision_loader(cfg, ontology, term, cfg.train_batch_size, seed=3))
    got = port_forward(cfg, ontology, tparams, lb, True)
    want = jax_forward(cfg, ontology, jparams, lb, True)
    lp, wlp = got["log_probability"], want["log_probability"]
    for k in (("attr", "rel") if isinstance(wlp, dict) else (None,)):
        g, w = (lp[k], wlp[k]) if k else (lp, wlp)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)


def test_warm_start_without_calibrator(ontology, setup, batches, tmp_path):
    """The curriculum's hand-over from stage 5 (no calibrator) to stage 6:
    ``VQATrainer`` loads the stage-5 npz into the calibrator model in place;
    the oracle's leaves are restored, the calibrator's keep their values."""
    from dfol_vqa_tpu_torch.train import checkpoint as ckpt
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    cfg, *_ = setup
    stage5 = Interpreter(trainset.demo_train_config(tiny=True), ontology).init_params(
        torch.Generator().manual_seed(1))
    ckpt.save(str(tmp_path), cfg.model_name, stage5, global_step=11)
    interp = Interpreter(cfg, ontology)
    params = interp.init_params(torch.Generator().manual_seed(2))
    before = flatten(params_to_numpy(params))
    trainer = VQATrainer(cfg, interp, device="cpu")
    trainer._load_into(str(tmp_path), params)
    got, base = flatten(params_to_numpy(params)), flatten(params_to_numpy(stage5))
    assert trainer.global_step == 11 and set(got) - set(base) == {
        k for k in got if k.startswith("calibrator/")}
    for k, v in got.items():
        np.testing.assert_array_equal(v, base[k] if k in base else before[k], err_msg=k)
    out = port_forward(cfg, ontology, params, batches[("verify_rel", "shared")], True)
    assert np.isfinite(out["loss"].item())


def load_witness():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                        "step_gradient_witness.py")
    spec = importlib.util.spec_from_file_location("step_gradient_witness", path)
    witness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(witness)
    return witness


@pytest.mark.parametrize("route", ["shared", "per_question"])
def test_witness_reversed_batch_is_the_same_batch(ontology, setup, batches, route):
    """``scripts/step_gradient_witness.reversed_batch``: the batch with its
    questions in reverse order (the witness's second float32 order) has the
    same loss within 1e-6 and the same gradients within 1e-5 of each leaf's
    largest value, and reverses every per-question array."""
    witness = load_witness()
    cfg, _, _, tparams = setup
    lb = batches[("verify_rel", route)]
    rev = witness.reversed_batch(lb)
    B = len(lb.arrays["img_index"])
    assert rev.arrays is not lb.arrays and B > 1
    for k, v in lb.arrays.items():
        want = v[::-1] if np.ndim(v) and len(v) == B else v
        np.testing.assert_array_equal(rev.arrays[k], want, err_msg=k)
    got = {}
    for name, b in (("fwd", lb), ("rev", rev)):
        p = params_from_numpy(flatten(params_to_numpy(tparams)))
        _, objs, mask, arrays = to_device_batch(b, "cpu")
        out = Interpreter(cfg, ontology).forward(p, objs, mask, arrays, b.spec, is_training=True)
        loss = out["loss"] / torch.clamp(torch.sum(arrays["question_mask"]), min=1.0)
        loss.backward()
        got[name] = (loss.item(), grads_of(p))
    assert abs(got["fwd"][0] - got["rev"][0]) <= 1e-6 * abs(got["fwd"][0])
    for k, g in got["fwd"][1].items():
        np.testing.assert_allclose(got["rev"][1][k], g, atol=1e-5 * np.abs(g).max(), rtol=0,
                                   err_msg=k)


def test_float64_witness_computes_in_float64(ontology, setup, batches):
    """``scripts/step_gradient_witness.float64_grads``, the float64 reference
    of the witness that reads a card-vs-CPU gradient gap: on both routes no
    operator of its forward or backward computes a float32 result (float32
    host constants are only moved, viewed and gathered, which is exact), and
    its gradients meet the float32 port's within 1e-3 of each leaf's largest
    value (readings 2.1e-5 shared, 2.2e-4 per-question: float32's own
    error, which the port and JAX share)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    witness = load_witness()

    EXACT = {"clone", "detach", "index", "lift_fresh", "unsqueeze", "view", "_unsafe_view",
             "expand", "slice", "select", "squeeze", "t", "transpose", "permute", "alias"}

    class NoFloat32(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            floating_in = any(isinstance(a, torch.Tensor) and a.is_floating_point()
                              for a in torch.utils._pytree.tree_leaves((args, kwargs)))
            outs = [o for o in torch.utils._pytree.tree_leaves(out) if isinstance(o, torch.Tensor)]
            name = str(func).split(".")[1]
            if (floating_in and name not in EXACT
                    and any(o.dtype == torch.float32 for o in outs)):
                self.ops.add(str(func))
            return out

    cfg, _, _, tparams = setup
    for route in ("shared", "per_question"):
        lb = batches[("verify_rel", route)]
        with NoFloat32() as mode:
            loss64, g64 = witness.float64_grads(cfg, ontology, tparams, lb)
        assert not mode.ops, (route, sorted(mode.ops))
        _, objs, mask, arrays = to_device_batch(lb, "cpu")
        p = params_from_numpy(flatten(params_to_numpy(tparams)))
        out = Interpreter(cfg, ontology).forward(p, objs, mask, arrays, lb.spec, is_training=True)
        loss = out["loss"] / torch.clamp(torch.sum(arrays["question_mask"]), min=1.0)
        loss.backward()
        assert abs(loss.item() - loss64) <= 1e-5 * abs(loss64)
        for k, g in grads_of(p).items():
            np.testing.assert_allclose(g, g64[k], atol=1e-3 * np.abs(g64[k]).max(), rtol=0,
                                       err_msg=k)
