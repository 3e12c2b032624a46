"""The trainable interpreter (``oracle_output_dim`` F > 1): the port against
the JAX package (CPU).

The JAX package's own F > 1 case, F = 4 with ``operator_layers_config=[8]``
(``scripts/answer_parity.py``, ``scripts/trainable_ablation.py``), at tiny
widths (``trainset.demo_train_config(tiny=True)``). The JAX init from
``PRNGKey(5)`` with the operator modules' final layers drawn at random
(normal x 0.4): at init they are zero, so F = 4 equals F = 1 and a
comparison there would not reach the extra channels. Tolerances: caches,
scores and log-probabilities within atol 1e-5, answer flags and matches
equal; one optimizer step through ``tests/test_torch_train_loop.check_step``
(every gradient leaf within 1e-5 x max(1, its largest value), the
parameters within ``adam_bound``). F > 1 takes the plain relation tails on
every device, so there is no kernel here.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu.config import Config as JConfig
from dfol_vqa_tpu.models import oracle as jom
from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu.train import checkpoint as jckpt
from dfol_vqa_tpu.train.optim import trainable_labels as jtrainable_labels
from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy
from dfol_vqa_tpu_torch.data import evalset, trainset
from dfol_vqa_tpu_torch.data.transfer import to_device_batch
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.train import checkpoint as ckpt
from dfol_vqa_tpu_torch.train.optim import trainable_labels
from tests.test_torch_terminals import TERMINALS, terminal_batch
from tests.test_torch_train_loop import check_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"sample": "configs/sample_config.yaml",
           "cur6": "configs/curriculum_training/cur6_classifier-direct-ll.yaml",
           "cur7": "configs/curriculum_training/cur7_classifier-direct-ll.yaml"}
TOL = dict(atol=1e-5, rtol=0)


def f_cfg(F=4, **kw):
    cfg = trainset.demo_train_config(tiny=True)
    return dataclasses.replace(cfg, oracle_output_dim=F, operator_layers_config=[8], **kw)


def randomize_op_modules(jparams, seed=6):
    """The operator modules' final layers normal x 0.4."""
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 4))
    for name in ("arity1", "arity2"):
        last = jparams["op_modules"][name]["layers"][-1]
        for k in ("w", "b"):
            last[k] = jax.random.normal(next(keys), last[k].shape) * 0.4
    return jparams


@pytest.fixture(scope="module")
def setup(ontology):
    cfg = f_cfg()
    jparams = randomize_op_modules(JInterpreter(cfg, ontology).init_params(jax.random.PRNGKey(5)))
    return cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def batches(ontology, setup):
    cfg = setup[0]
    world = evalset.demo_world(ontology, tiny=True)
    return {(term, route): terminal_batch(ontology, cfg, world, term, route)
            for term in TERMINALS for route in ("shared", "per_question")}


def close(t, j):
    assert np.isfinite(t.detach().numpy()).all()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


# ---------------------------------------------------------------- init


def test_init_layout_matches_jax(ontology, setup):
    """The port's F = 4 init has the JAX tree's keys and shapes; the extra
    channels (E, V_pad, F-1) follow the embedding's scale, the operator
    modules map F -> 8 -> 1 with a zero final layer."""
    cfg, jparams, _ = setup
    p = Interpreter(cfg, ontology).init_params(torch.Generator().manual_seed(0))
    got = flatten(params_to_numpy(p))
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in flatten(jax.tree.map(np.asarray, jparams)).items()}
    assert got["embedding_extra/w"].shape == (16, 2432, 3) and not got["embedding_extra/b"].any()
    assert 0.15 < got["embedding_extra/w"].std() < 0.35  # 1/sqrt(16) = 0.25
    for name in ("arity1", "arity2"):
        assert got[f"op_modules/{name}/layers/0/w"].shape == (4, 8)
        assert not got[f"op_modules/{name}/layers/1/w"].any()
        assert not got[f"op_modules/{name}/layers/1/b"].any()
    plain = Interpreter(f_cfg(F=1), ontology).init_params(torch.Generator().manual_seed(0))
    assert plain.embedding_extra is None and plain.op_modules is None


def test_operator_layers_none_raises(ontology):
    cfg = f_cfg(F=2)
    cfg.operator_layers_config = None
    with pytest.raises(ValueError, match="operator_layers_config"):
        Interpreter(cfg, ontology).init_params(torch.Generator().manual_seed(0))


# --------------------------------------------------------------- the caches


def test_attr_cache_matches_jax(setup):
    cfg, jparams, tparams = setup
    attr_in = np.random.default_rng(1).uniform(size=(2, 5, cfg.attr_input_dim)).astype(np.float32)
    got = om.attr_cache(tparams, torch.from_numpy(attr_in), cfg)
    assert got.shape == (2, 2433, 5)
    close(got, jom.attr_cache(jparams, jnp.asarray(attr_in), cfg))


def rel_inputs(cfg, B, O, seed=2):
    rng = np.random.default_rng(seed)
    attr_in = rng.uniform(size=(B, O, cfg.attr_input_dim)).astype(np.float32)
    pos = rng.uniform(size=(B, O, 4)).astype(np.float32)
    tok = rng.integers(1, 2336, (B, 4)).astype(np.int32)
    tok[0, 3] = 0  # pad slot
    return attr_in, pos, tok


@pytest.mark.parametrize("B,O", [(2, 5), (3, 8)])
def test_rel_cache_matches_jax(setup, B, O):
    cfg, jparams, tparams = setup
    ins = rel_inputs(cfg, B, O)
    got = om.rel_cache(tparams, *map(torch.from_numpy, ins), cfg)
    assert got.shape == (B, 4, O, O)
    close(got, jom.rel_cache(jparams, *map(jnp.asarray, ins), cfg))
    assert torch.all(got[0, 3] == om.DEFAULT_LOG_LIKELIHOOD)


def test_rel_cache_shared_tail_matches_jax(ontology, setup):
    """The shared route's per-question tail with the operator module; the
    contract-then-gather tail stays off for F > 1 (as JAX's), though the
    gather map is given and images are shared (U < B)."""
    cfg, jparams, tparams = setup
    attr_in, pos, tok = rel_inputs(cfg, 6, 7)
    U = 3
    img = np.array([0, 0, 1, 2, 2, 1], np.int32)
    interp = Interpreter(cfg, ontology)
    assert cfg.tpu.rel_contract_then_gather
    got = om.rel_cache_shared(tparams, torch.from_numpy(attr_in[:U]), torch.from_numpy(pos[:U]),
                              torch.from_numpy(img), torch.from_numpy(tok), cfg,
                              rel_gather=interp._rel_gather_map)
    want = jom.rel_cache_shared(jparams, jnp.asarray(attr_in[:U]), jnp.asarray(pos[:U]),
                                jnp.asarray(img), jnp.asarray(tok), cfg,
                                rel_gather=JInterpreter(cfg, ontology)._rel_gather_map)
    close(got, want)
    # the per-question tail on the gathered rows is the plain per-question cache
    per_q = om.rel_cache(tparams, torch.from_numpy(attr_in[:U][img]),
                         torch.from_numpy(pos[:U][img]), torch.from_numpy(tok), cfg)
    np.testing.assert_allclose(got.detach().numpy(), per_q.detach().numpy(), **TOL)


@pytest.mark.parametrize("cols", [False, True])
def test_rel_scores_for_pairs_matches_jax(ontology, setup, cols):
    """Listed-pair scores through the arity-2 module, and their gradients
    to every leaf (the extra channels and the modules included)."""
    from tests.test_torch_supervision import pair_inputs

    cfg, jparams, tparams = setup
    rng = np.random.default_rng(12)
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
    close(got, want)
    torch.sum(got * torch.from_numpy(weight)).backward()
    want_grads = flatten(jax.tree.map(np.asarray, want_grads))
    for name, p in tparams.named_parameters():
        key = name.replace(".", "/")
        g = np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
        atol = 1e-5 * max(1.0, float(np.abs(want_grads[key]).max()))
        np.testing.assert_allclose(g, want_grads[key], atol=atol, rtol=0, err_msg=key)
    assert np.abs(tparams.op_modules["arity2"].layers[-1].w.grad.numpy()).max() > 0


# ---------------------------------------------------------------- forward


def port_forward(cfg, ontology, tparams, lb, is_training=False):
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    with torch.no_grad():
        return Interpreter(cfg, ontology).forward(tparams, objs, mask, arrays, lb.spec,
                                                  is_training=is_training)


@pytest.mark.parametrize("route", ["shared", "per_question"])
@pytest.mark.parametrize("term", TERMINALS)
def test_forward_matches_jax(ontology, setup, batches, term, route):
    cfg, jparams, tparams = setup
    lb = batches[(term, route)]
    want = JInterpreter(cfg, ontology).forward(
        jparams, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
        {k: jnp.asarray(v) for k, v in lb.arrays.items()}, lb.spec, False, None)
    got = port_forward(cfg, ontology, tparams, lb)
    close(got["log_probability"], want["log_probability"])
    np.testing.assert_array_equal(got["answer_flags"].numpy(), np.asarray(want["answer_flags"]))
    np.testing.assert_array_equal(got["match"].numpy(), np.asarray(want["match"]))


@pytest.mark.parametrize("term,route", [("exist", "shared"), ("verify_rel", "per_question"),
                                        ("query_attr", "shared"), ("choose_rel", "per_question"),
                                        ("compare", "shared")])
def test_identity_at_init(ontology, batches, term, route):
    """With the init's zero final layers, F = 4 gives F = 1's outputs
    exactly (the base weights shared)."""
    jparams = JInterpreter(f_cfg(), ontology).init_params(jax.random.PRNGKey(7))
    p4 = params_from_numpy(jax.tree.map(np.asarray, jparams))
    p1 = params_from_numpy({k: v for k, v in flatten(jax.tree.map(np.asarray, jparams)).items()
                            if not k.startswith(("embedding_extra/", "op_modules/"))})
    lb = batches[(term, route)]
    out4 = port_forward(f_cfg(), ontology, p4, lb)
    out1 = port_forward(f_cfg(F=1), ontology, p1, lb)
    assert torch.equal(out4["log_probability"], out1["log_probability"])
    assert torch.equal(out4["answer_flags"], out1["answer_flags"])


# ------------------------------------------------------------------ training


@pytest.mark.parametrize("term,route", [("exist", "per_question"), ("exist", "shared"),
                                        ("verify_rel", "shared"), ("query_attr", "per_question"),
                                        ("choose_rel", "per_question"), ("compare", "shared")])
def test_train_step_matches_jax(ontology, setup, batches, term, route):
    cfg, jparams, _ = setup
    check_step(cfg, JInterpreter(cfg, ontology), jparams, Interpreter(cfg, ontology),
               batches[(term, route)])


def tiny_yaml(name: str, F: int = 1, **kw):
    """A shipped configuration's flags at tiny widths, in both packages."""
    both = []
    for cls in (Config, JConfig):
        cfg = cls.from_yaml(os.path.join(ROOT, CONFIGS[name]))
        both.append(dataclasses.replace(
            cfg, box_features_dim=32, oracle_input_dim=24, word_embedding_dim=16,
            attribute_network_layers_config=[16], relation_network_layers_config=[16],
            attention_transfer_state_dim=8, oracle_output_dim=F, operator_layers_config=[8],
            **kw))
    return both


@pytest.mark.parametrize("name,F,kw", [
    ("sample", 1, {}), ("cur6", 1, {}), ("cur7", 1, {}), ("cur7", 4, {}),
    ("sample", 4, {"freeze_embedding_network": True, "freeze_embedding_bias": True}),
    ("sample", 4, {"freeze_attention_network": True})])
def test_freeze_labels_match_jax(ontology, name, F, kw):
    """``trainable_labels`` against JAX's for the shipped configurations
    (the calibrator on), and with F = 4: ``calibrator`` follows
    ``freeze_attention_network``, ``embedding_extra`` the embedding's flag
    (no bias exception), ``op_modules`` always trains."""
    cfg, jcfg = tiny_yaml(name, F, **kw)
    jparams = JInterpreter(jcfg, ontology).init_params(jax.random.PRNGKey(0))
    want = flatten(jtrainable_labels(jparams, jcfg))
    got = trainable_labels(params_from_numpy(jax.tree.map(np.asarray, jparams)), cfg)
    assert {k.replace(".", "/"): ("train" if on else "freeze") for k, on in got.items()} == want
    assert any(k.startswith("calibrator") for k in got)
    if F > 1:
        assert all(got[k] for k in got if k.startswith("op_modules."))
        assert got["embedding_extra.b"] == (not cfg.freeze_embedding_network)


# ---------------------------------------------------------------- checkpoints


def test_warm_start_from_f1_npz(ontology, batches, tmp_path):
    """An F = 1 checkpoint (the curriculum's stage-5 ``-l best`` hand-over)
    loads partially into an F = 4 model: the shared leaves restored, the
    extra channels and operator modules keep their init, and it runs."""
    p1 = Interpreter(f_cfg(F=1), ontology).init_params(torch.Generator().manual_seed(1))
    ckpt.save(str(tmp_path), "best", p1, global_step=7)
    p4 = Interpreter(f_cfg(), ontology).init_params(torch.Generator().manual_seed(2))
    before = flatten(params_to_numpy(p4))
    loaded, step = ckpt.load(str(tmp_path), "best", p4)
    assert step == 7
    got, base = flatten(params_to_numpy(loaded)), flatten(params_to_numpy(p1))
    for k, v in got.items():
        np.testing.assert_array_equal(v, base[k] if k in base else before[k], err_msg=k)
    assert {k for k in got if k not in base} == {k for k in got if k.startswith(
        ("embedding_extra/", "op_modules/"))}
    out = port_forward(f_cfg(), ontology, loaded, batches[("exist", "shared")], is_training=True)
    assert np.isfinite(out["loss"].item())


def test_npz_round_trip_with_jax(ontology, tmp_path):
    """A JAX checkpoint of an F = 4 model with the calibrator loads into the
    port's own init and back, leaf for leaf."""
    cfg = f_cfg(activate_attention_transfer=True, attention_transfer_state_dim=8)
    jinterp = JInterpreter(cfg, ontology)
    jparams = randomize_op_modules(jinterp.init_params(jax.random.PRNGKey(3)))
    want = flatten(jax.tree.map(np.asarray, jparams))
    jckpt.save(str(tmp_path / "jax"), "m", jparams, global_step=4)
    start = Interpreter(cfg, ontology).init_params(torch.Generator().manual_seed(0))
    loaded, step = ckpt.load(str(tmp_path / "jax"), "m", start)
    got = flatten(params_to_numpy(loaded))
    assert step == 4 and set(got) == set(want)
    assert loaded.calibrator is not None and loaded.op_modules is not None
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    ckpt.save(str(tmp_path / "port"), "m", loaded, global_step=9)
    back, step = jckpt.load(str(tmp_path / "port"), "m", jinterp.init_params(jax.random.PRNGKey(8)))
    assert step == 9
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for k, v in flatten(jax.tree.map(np.asarray, back)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
