"""The supervision terminals, listed-pair relation scores and the neural
logic gates: the port against the JAX package (CPU, float32).

* ``object_attr``, ``object_rel`` and ``scene`` batches
  (``trainset.supervision_loader``: ``data/synthetic.py`` questions on
  ``SyntheticFeatures`` scenes with padded object slots), soft and hard:
  log-probabilities within atol 1e-5, equal answer flags and matches, and
  the loss within 1e-5 relative; one training step each against
  ``jax.value_and_grad`` and optax (``test_torch_train_loop.check_step``).
* ``oracle.rel_scores_for_pairs`` against JAX, zero-distance pairs included,
  values and gradients.
* ``trainable_gate``: the init's tree, the forward and one training step on
  relating and fan-out terminals, the bridge and npz checkpoints both ways,
  and the optimizer training the gates under every freeze flag.
* ``tpu.cache_dtype``: "auto" raises (no H100 measurement yet), the two
  explicit dtypes pass through.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu.models import oracle as jom
from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu.train import checkpoint as jckpt
from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy
from dfol_vqa_tpu_torch.data import evalset, trainset
from dfol_vqa_tpu_torch.data.transfer import to_device_batch
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.train import checkpoint as ckpt
from dfol_vqa_tpu_torch.train.optim import trainable_labels
from tests.test_torch_terminals import terminal_batch
from tests.test_torch_train_loop import check_step

TOL = dict(atol=1e-5, rtol=0)


def tiny_cfg(trainable_gate=False):
    cfg = trainset.demo_train_config(tiny=True)
    cfg.trainable_gate = trainable_gate
    return cfg


@pytest.fixture(scope="module")
def setup(ontology):
    cfg = tiny_cfg()
    jinterp = JInterpreter(cfg, ontology)
    jparams = jinterp.init_params(jax.random.PRNGKey(6))
    return cfg, jinterp, jparams, Interpreter(cfg, ontology)


@pytest.fixture(scope="module")
def batches(ontology, setup):
    cfg = setup[0]
    out = {}
    for term in trainset.SUPERVISION_TERMINALS:
        (lb,) = list(trainset.supervision_loader(cfg, ontology, term, cfg.train_batch_size,
                                                 seed=3))
        out[term] = lb
    return out


def test_supervision_batches(batches):
    for term, lb in batches.items():
        assert lb.spec.terminal_op == term and lb.compiled.question_mask.sum() == 16
        assert (lb.obj_mask == 0).any() and (lb.obj_mask == 1).any()  # padded slots
    stmt = batches["object_rel"].arrays
    assert (stmt["stmt_obj"] == stmt["stmt_obj2"]).any()  # a self pair (on the diagonal)


def assert_outputs_match(got, want):
    lp, wlp = got["log_probability"], want["log_probability"]
    if isinstance(wlp, dict):
        assert set(lp) == set(wlp) == {"attr", "rel"}
        for k in wlp:
            assert np.isfinite(lp[k].detach().numpy()).all()
            np.testing.assert_allclose(lp[k].detach().numpy(), np.asarray(wlp[k]), **TOL)
    else:
        assert np.isfinite(lp.detach().numpy()).all()
        np.testing.assert_allclose(lp.detach().numpy(), np.asarray(wlp), **TOL)
    np.testing.assert_array_equal(got["answer_flags"].numpy(), np.asarray(want["answer_flags"]))
    np.testing.assert_allclose(got["match"].detach().numpy(), np.asarray(want["match"]),
                               atol=1e-6, rtol=0)


def jax_forward(jinterp, jparams, lb, training=False):
    return jinterp.forward(jparams, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
                           {k: jnp.asarray(v) for k, v in lb.arrays.items()}, lb.spec, training,
                           None)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("term", trainset.SUPERVISION_TERMINALS)
def test_supervision_forward_matches_jax(ontology, setup, batches, term, hard):
    cfg, _, jparams, _ = setup
    cfg = dataclasses.replace(cfg, hard_mode=hard)
    lb = batches[term]
    want = jax_forward(JInterpreter(cfg, ontology), jparams, lb)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    with torch.inference_mode():
        got = Interpreter(cfg, ontology).forward(tparams, objs, mask, arrays, lb.spec)
    assert_outputs_match(got, want)
    # the loss of the same forward (JAX computes it on every call)
    out = Interpreter(cfg, ontology).forward(tparams, objs, mask, arrays, lb.spec,
                                             is_training=True)
    want_loss = float(jax_forward(JInterpreter(cfg, ontology), jparams, lb, True)["loss"])
    assert abs(out["loss"].item() - want_loss) <= 1e-5 * abs(want_loss)


@pytest.mark.parametrize("term", trainset.SUPERVISION_TERMINALS)
def test_supervision_train_step_matches_jax(setup, batches, term):
    cfg, jinterp, jparams, tinterp = setup
    check_step(cfg, jinterp, jparams, tinterp, batches[term])


# ------------------------------------------------------ rel_scores_for_pairs


def pair_inputs(rng, B=3, O=6, P=5, d=24):
    attr_in = rng.standard_normal((B, O, d)).astype(np.float32)
    pos = rng.uniform(0.05, 0.9, (B, O, 4)).astype(np.float32)
    pos[:, 1] = pos[:, 0]  # objects 0 and 1 share a box: distance 0
    pos[0, 2, :2] = pos[0, 3, :2] + (pos[0, 3, 2:] - pos[0, 2, 2:]) / 2  # same centre
    pair = rng.integers(0, O, (B, P, 2)).astype(np.int32)
    pair[:, 0] = (0, 1)
    pair[:, 1] = (2, 2)  # a self pair
    pair[0, 2] = (2, 3)
    return attr_in, pos, pair


@pytest.mark.parametrize("cols", [False, True])
def test_rel_scores_for_pairs_matches_jax(ontology, setup, cols):
    cfg, _, jparams, _ = setup
    rng = np.random.default_rng(11)
    attr_in, pos, pair = pair_inputs(rng, d=cfg.attr_input_dim)
    rel_cols = np.asarray(ontology._relation_index, np.int64) if cols else None
    weight = rng.standard_normal((3, 5, len(rel_cols) if cols else 2432)).astype(np.float32)

    def jax_sum(p):
        out = jom.rel_scores_for_pairs(p, jnp.asarray(attr_in), jnp.asarray(pos),
                                       jnp.asarray(pair), cfg,
                                       rel_cols=None if rel_cols is None else jnp.asarray(rel_cols))
        return jnp.sum(out * weight), out

    (_, want), want_grads = jax.value_and_grad(jax_sum, has_aux=True)(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    got = om.rel_scores_for_pairs(tparams, torch.from_numpy(attr_in), torch.from_numpy(pos),
                                  torch.from_numpy(pair), cfg,
                                  rel_cols=None if rel_cols is None else torch.from_numpy(rel_cols))
    assert got.shape == want.shape and np.isfinite(got.detach().numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    torch.sum(got * torch.from_numpy(weight)).backward()
    want_grads = flatten(jax.tree.map(np.asarray, want_grads))
    for name, p in tparams.named_parameters():
        key = name.replace(".", "/")
        g = np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
        atol = 1e-5 * max(1.0, float(np.abs(want_grads[key]).max()))
        np.testing.assert_allclose(g, want_grads[key], atol=atol, rtol=0, err_msg=key)


# ------------------------------------------------------------ trainable_gate


@pytest.fixture(scope="module")
def gated(ontology):
    cfg = tiny_cfg(trainable_gate=True)
    jinterp = JInterpreter(cfg, ontology)
    jparams = jinterp.init_params(jax.random.PRNGKey(8))
    assert set(jparams["logic_gates"]) == set(om.LOGIC_GATES)
    return cfg, jinterp, jparams, Interpreter(cfg, ontology)


def test_trainable_gate_init_matches_the_jax_tree(ontology, gated):
    cfg, _, jparams, tinterp = gated
    p = tinterp.init_params(torch.Generator().manual_seed(0))
    got = flatten(params_to_numpy(p))
    want = flatten(jax.tree.map(np.asarray, jparams))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert got["logic_gates/filter/w"].shape == (2, 6)
    assert np.abs(got["logic_gates/relate1/b"]).max() <= 2 ** -0.5  # U(-1/sqrt(2), 1/sqrt(2))
    plain = Interpreter(tiny_cfg(), ontology).init_params(torch.Generator().manual_seed(0))
    assert plain.logic_gates is None
    assert not any(k.startswith("logic_gates/") for k in flatten(params_to_numpy(plain)))


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("term,route", [("exist", "shared"), ("choose_rel", "per_question"),
                                        ("choose_rel", "shared"), ("all_same", "shared"),
                                        ("verify_attrs", "per_question"), ("compare", "shared")])
def test_trainable_gate_forward_matches_jax(ontology, gated, term, route, hard):
    cfg, _, jparams, _ = gated
    cfg = dataclasses.replace(cfg, hard_mode=hard)
    lb = terminal_batch(ontology, cfg, evalset.demo_world(ontology, tiny=True), term, route)
    want = jax_forward(JInterpreter(cfg, ontology), jparams, lb)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    with torch.inference_mode():
        got = Interpreter(cfg, ontology).forward(tparams, objs, mask, arrays, lb.spec)
        ungated = Interpreter(tiny_cfg(), ontology).forward(tparams, objs, mask, arrays,
                                                           lb.spec)
    assert_outputs_match(got, want)
    assert not torch.equal(got["log_probability"], ungated["log_probability"])


@pytest.mark.parametrize("term", ["exist", "choose_rel", "two_same", "compare", "object_attr",
                                  "object_rel"])
def test_trainable_gate_train_step_matches_jax(ontology, gated, term):
    cfg, jinterp, jparams, tinterp = gated
    if term in trainset.SUPERVISION_TERMINALS:
        (lb,) = list(trainset.supervision_loader(cfg, ontology, term, 16, seed=4))
    else:
        lb = terminal_batch(ontology, cfg, evalset.demo_world(ontology, tiny=True), term,
                            "shared" if term == "exist" else "per_question")
    check_step(cfg, jinterp, jparams, tinterp, lb)


def test_logic_gates_bridge_and_checkpoints(gated, tmp_path):
    cfg, jinterp, jparams, _ = gated
    want = flatten(jax.tree.map(np.asarray, jparams))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert set(om.LOGIC_GATES) == set(tparams.logic_gates)
    back = params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jparams))
    for k, v in flatten(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # port -> JAX
    ckpt.save(str(tmp_path / "port"), "m", tparams, global_step=3)
    loaded, step = jckpt.load(str(tmp_path / "port"), "m",
                              jinterp.init_params(jax.random.PRNGKey(1)))
    assert step == 3
    for k, v in flatten(jax.tree.map(np.asarray, loaded)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # JAX -> port, into other weights
    jckpt.save(str(tmp_path / "jax"), "m", jparams, global_step=5)
    start = params_from_numpy(jax.tree.map(np.asarray, jinterp.init_params(
        jax.random.PRNGKey(2))))
    loaded, step = ckpt.load(str(tmp_path / "jax"), "m", start)
    assert step == 5 and loaded.logic_gates is not None
    for k, v in flatten(params_to_numpy(loaded)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_logic_gates_always_train(gated):
    cfg, _, jparams, _ = gated
    cfg = dataclasses.replace(cfg, freeze_featurizer=True, freeze_attribute_network=True,
                              freeze_relation_network=True, freeze_embedding_network=True)
    labels = trainable_labels(params_from_numpy(jax.tree.map(np.asarray, jparams)), cfg)
    assert {k for k, on in labels.items() if on} == {
        f"logic_gates.{g}.{p}" for g in om.LOGIC_GATES for p in ("w", "b")}


# ---------------------------------------------------------------- cache dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "auto"])
def test_cache_dtype(ontology, setup, batches, dtype):
    """The caches' dtype is ``tpu.cache_dtype``; "auto" is float32 at every
    batch, the H100's table in ``om.resolve_cache_dtype`` (bfloat16 slower
    at each measured batch 32, 80, 256), below, inside and above the
    measured batches."""
    cfg, _, jparams, _ = setup
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, cache_dtype=dtype))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    lb = batches["object_attr"]
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    want = torch.float32 if dtype == "auto" else getattr(torch, dtype)
    for b in (1, lb.spec.batch_size, 32, 80, 256, 4096):
        assert om.resolve_cache_dtype(cfg, b) == want
    with torch.inference_mode():
        world = Interpreter(cfg, ontology).build_world(tparams, objs, mask,
                                                       arrays.get("rel_tokens"))
    assert world.attr_ll.dtype == world.rel_ll.dtype == want

