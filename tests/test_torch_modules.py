"""PyTorch port vs the JAX package, module by module (CPU, float32).

The same inputs, made with numpy from a seed, go through each JAX function
and its counterpart in ``dfol_vqa_tpu_torch``; weights come from the JAX
init through ``convert.params_from_numpy``. Tolerance: atol 1e-5, rtol
1e-5 (float32 sums taken in another order by XLA and ATen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu import logic as jlogic
from dfol_vqa_tpu import nn as jnn
from dfol_vqa_tpu import types as jtypes
from dfol_vqa_tpu.config import Config
from dfol_vqa_tpu.models import calibrator as jcal
from dfol_vqa_tpu.models import featurizer as jfeat
from dfol_vqa_tpu.models import oracle as jom
from dfol_vqa_tpu.ops import cells as jcells
from dfol_vqa_tpu.train.checkpoint import _flatten
from dfol_vqa_tpu_torch import convert, logic, nn, types
from dfol_vqa_tpu_torch.models import featurizer, oracle
from dfol_vqa_tpu_torch.ops import cells

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(atol=1e-5, rtol=1e-5)


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def log_probs(rng, shape):
    """log p with p spanning (1e-30, 1]: exercises the 1e-20 clamp."""
    return np.log(rng.uniform(0.0, 1.0, shape) ** rng.choice([1, 4, 40], shape)
                  + 1e-30).astype(np.float32)


def tiny_cfg(**kw) -> Config:
    cfg = Config(box_features_dim=32, oracle_input_dim=24, word_embedding_dim=16,
                 attribute_network_layers_config=[16], relation_network_layers_config=[16],
                 featurizer_layers_config=[], dropout=0.0, verbose=False, **kw)
    cfg.tpu.max_object_num = 8
    return cfg


@pytest.fixture(scope="module")
def jax_params(ontology):
    return jom.init_oracle_params(jax.random.PRNGKey(3), tiny_cfg(), ontology)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jax_params))


def scene(rng, B, O, box=32):
    obj = np.zeros((B, O, box + 6), np.float32)
    obj[..., :box] = rng.standard_normal((B, O, box))
    obj[..., box] = 640
    obj[..., box + 1] = 480
    obj[..., box + 2] = rng.uniform(0, 600, (B, O))
    obj[..., box + 3] = rng.uniform(0, 440, (B, O))
    obj[..., box + 4] = rng.uniform(5, 40, (B, O))
    obj[..., box + 5] = rng.uniform(5, 40, (B, O))
    obj[0, 1, box + 2:] = obj[0, 0, box + 2:]  # coincident boxes: dist 0, asin clamp
    return obj


# ---------------------------------------------------------------------- logic


LOGIC_CASES = {
    "safe_log": lambda L, x, y, m: L.safe_log(L.safe_exp(x)),
    "log_not": lambda L, x, y, m: L.log_not(x),
    "log_and": lambda L, x, y, m: L.log_and(x, y),
    "log_or": lambda L, x, y, m: L.log_or(x, y),
    "log_parametric_not": lambda L, x, y, m: L.log_parametric_not(x, m, 1.0),
    "log_parametric_not_beta": lambda L, x, y, m: L.log_parametric_not(x, 0.3 * m, 0.7),
    "log_and_tensor": lambda L, x, y, m: L.log_and_tensor(x, axis=-1, mask=m),
    "log_or_tensor": lambda L, x, y, m: L.log_or_tensor(x, axis=-1, mask=m),
    "masked_sum": lambda L, x, y, m: L.masked_sum(x, m, axis=-1),
    "masked_min": lambda L, x, y, m: L.masked_min(x, m, axis=-1),
    "masked_logsumexp": lambda L, x, y, m: L.masked_logsumexp(x, m, axis=-1),
}


@pytest.mark.parametrize("name", sorted(LOGIC_CASES))
def test_logic_matches_jax(name):
    rng = np.random.default_rng(0)
    x, y = log_probs(rng, (4, 9)), log_probs(rng, (4, 9))
    m = (rng.uniform(size=(4, 9)) < 0.7).astype(np.float32)
    fn = LOGIC_CASES[name]
    got = fn(logic, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m))
    want = fn(jlogic, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m))
    close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_safe_log_clamp_per_dtype(dtype):
    """1e-20 for float32, 1e-6 for half precision, as in the JAX package."""
    got = logic.safe_log(torch.zeros(3, dtype=getattr(torch, dtype))).float().numpy()
    want = np.asarray(jlogic.safe_log(jnp.zeros(3, dtype)).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------- types


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("options", [False, True])
def test_variable_set_log_probability(hard, options):
    rng = np.random.default_rng(1)
    shape = (3, 4, 6) if options else (3, 6)
    att = log_probs(rng, shape)
    quant = (rng.uniform(size=shape[:-1]) < 0.5).astype(np.float32)
    mask = (rng.uniform(size=(3, 6)) < 0.7).astype(np.float32)
    got = types.VariableSet(torch.from_numpy(att), torch.from_numpy(quant),
                            torch.from_numpy(mask)).log_probability(hard)
    want = jtypes.VariableSet(jnp.asarray(att), jnp.asarray(quant),
                              jnp.asarray(mask)).log_probability(hard)
    close(got, want)


def test_enums_match_jax():
    for name in ("Quantifier", "QuestionType"):
        assert {m.name: int(m) for m in getattr(types, name)} == {
            m.name: int(m) for m in getattr(jtypes, name)}


# ------------------------------------------------------------------------- nn


@pytest.mark.parametrize("final", ["sigmoid", "logsigmoid", "none"])
def test_mlp_matches_jax(final):
    rng = np.random.default_rng(2)
    p = jnn.mlp_init(jax.random.PRNGKey(0), 10, [7, 5], 3)
    x = rng.standard_normal((4, 10)).astype(np.float32)
    mlp = convert.params_from_numpy({"attribute_network": jax.tree.map(np.asarray, p),
                                     "embedding": {"w": np.zeros((1, 1)), "b": np.zeros(1)}}
                                    ).attribute_network
    close(mlp(torch.from_numpy(x), final=final), jnn.mlp_apply(p, jnp.asarray(x), final=final))


def test_linear_init_bounds_and_dropout():
    g = torch.Generator().manual_seed(0)
    lin = nn.Linear.init(16, 8, g)
    assert lin.w.shape == (16, 8) and lin.b.shape == (8,)
    assert float(lin.w.detach().abs().max()) <= 0.25
    assert float(lin.b.detach().abs().max()) <= 0.25
    x = torch.ones(1000)
    assert nn.dropout(x, 0.5, g, deterministic=True) is x
    assert nn.dropout(x, 0.5, None, deterministic=False) is x
    y = nn.dropout(x, 0.5, g, deterministic=False)
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0} and 300 < int((y == 0).sum()) < 700


# ----------------------------------------------------------------- featurizer


def test_featurizer_matches_jax(jax_params, port_params):
    rng = np.random.default_rng(4)
    cfg = tiny_cfg()
    obj = scene(rng, 2, 5)
    a_t, p_t = featurizer.featurize_objects(port_params.featurizer, torch.from_numpy(obj), cfg)
    a_j, p_j = jfeat.featurize_objects(jax_params["featurizer"], jnp.asarray(obj), cfg)
    close(a_t, a_j)
    close(p_t, p_j)
    g_t = featurizer.pair_geometry(p_t)
    close(g_t, jfeat.pair_geometry(p_j))
    assert torch.isfinite(g_t).all()


# ---------------------------------------------------------------------- cells


@pytest.mark.parametrize("options", [False, True])
def test_relate_update_matches_jax(options):
    rng = np.random.default_rng(5)
    lead = (2, 3) if options else (2,)
    O = 6
    subj, obj = log_probs(rng, lead + (O,)), log_probs(rng, lead + (O,))
    ll = log_probs(rng, lead + (O, O))
    qs = (rng.uniform(size=lead) < 0.5).astype(np.float32)
    qo = (rng.uniform(size=lead) < 0.5).astype(np.float32)
    mask = (rng.uniform(size=(2, O)) < 0.8).astype(np.float32)
    got = cells.relate_update(*map(torch.from_numpy, (subj, obj, ll, qs, qo, mask)))
    want = jcells.relate_update(*map(jnp.asarray, (subj, obj, ll, qs, qo, mask)))
    close(got[0], want[0])
    close(got[1], want[1])


@pytest.mark.parametrize("multi", [False, True])
def test_normalize_over_options_matches_jax(multi):
    """The whole-batch skip: only an all-singleton batch is left alone."""
    rng = np.random.default_rng(6)
    ll = log_probs(rng, (3, 4, 5))
    opt_mask = np.zeros((3, 4), np.float32)
    opt_mask[:, 0] = 1.0
    if multi:
        opt_mask[1, :3] = 1.0
    got = cells.normalize_over_options(torch.from_numpy(ll), torch.from_numpy(opt_mask))
    want = jcells.normalize_over_options(jnp.asarray(ll), jnp.asarray(opt_mask))
    close(got, want)
    assert torch.equal(got, torch.from_numpy(ll)) != multi


def test_filter_and_gate_match_jax():
    rng = np.random.default_rng(7)
    att, ll = log_probs(rng, (3, 5)), log_probs(rng, (3, 5))
    gate_j = jnn.linear_init(jax.random.PRNGKey(1), 2, 6)
    gate_t = nn.Linear(torch.from_numpy(np.array(gate_j["w"])),
                       torch.from_numpy(np.array(gate_j["b"])))
    T, J = torch.from_numpy, jnp.asarray
    close(cells.filter_update(T(att), T(ll)), jcells.filter_update(J(att), J(ll)))
    close(cells.filter_update(T(att), T(ll), gate_t),
          jcells.filter_update(J(att), J(ll), gate_j))


# --------------------------------------------------------------------- oracle


def test_attr_cache_matches_jax(jax_params, port_params):
    rng = np.random.default_rng(8)
    cfg = tiny_cfg()
    attr_in = rng.uniform(size=(2, 5, cfg.attr_input_dim)).astype(np.float32)
    got = oracle.attr_cache(port_params, torch.from_numpy(attr_in), cfg)
    want = jom.attr_cache(jax_params, jnp.asarray(attr_in), cfg)
    assert got.shape == (2, 2433, 5)  # vocab-major over the padded vocab, row 0 = default
    close(got, want)


@pytest.mark.parametrize("B,O", [(2, 5), (3, 8)])
def test_rel_cache_matches_jax(jax_params, port_params, B, O):
    rng = np.random.default_rng(9)
    cfg = tiny_cfg()
    attr_in = rng.uniform(size=(B, O, cfg.attr_input_dim)).astype(np.float32)
    pos = rng.uniform(size=(B, O, 4)).astype(np.float32)
    tok = rng.integers(1, 2336, (B, 4)).astype(np.int32)
    tok[0, 3] = 0  # pad slot
    got = oracle.rel_cache(port_params, *map(torch.from_numpy, (attr_in, pos, tok)), cfg)
    want = jom.rel_cache(jax_params, *map(jnp.asarray, (attr_in, pos, tok)), cfg)
    assert got.shape == (B, 4, O, O)  # R-major
    close(got, want)
    assert torch.all(got[0, 3] == oracle.DEFAULT_LOG_LIKELIHOOD)


def test_init_oracle_params_layout(ontology, jax_params):
    """Same tree as the JAX init: keys, shapes, GloVe-seeded columns, the
    vocab padded to 2432 with padded rows zeroed."""
    cfg = tiny_cfg()
    p = oracle.init_oracle_params(cfg, ontology, torch.Generator().manual_seed(0))
    got = convert.flatten(convert.params_to_numpy(p))
    want = _flatten(jax.tree.map(np.asarray, jax_params))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    w = got["embedding/w"]  # (E, V_pad)
    V = ontology.num_tokens
    assert w.shape == (16, 2432) and not w[:, V:].any()
    np.testing.assert_array_equal(w[:, :V], want["embedding/w"][:, :V])  # GloVe rows
    assert not got["embedding/b"].any()


def test_unsupported_configs_raise(ontology):
    """A compute dtype other than float32 and bfloat16 raises, as does the
    trainable interpreter (F > 1) without an operator module (``ValueError``,
    as the JAX init raises). bfloat16 is ported (``tests/test_torch_bf16.py``)."""
    cfg = tiny_cfg()
    cfg.tpu.compute_dtype = "float16"
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        oracle.init_oracle_params(cfg, ontology, torch.Generator())
    with pytest.raises(ValueError, match="operator_layers_config"):
        oracle.init_oracle_params(tiny_cfg(oracle_output_dim=3, operator_layers_config=None),
                                  ontology, torch.Generator())
    with pytest.raises(ValueError, match="operator_layers_config"):
        jom.init_oracle_params(jax.random.PRNGKey(0),
                               tiny_cfg(oracle_output_dim=3, operator_layers_config=None),
                               ontology)


# --------------------------------------------------------------------- bridge


def test_bridge_round_trip(jax_params, port_params):
    back = convert.params_to_numpy(port_params)
    want = jax.tree.map(np.asarray, jax_params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    flat_back, flat_want = _flatten(back), _flatten(want)
    assert set(flat_back) == set(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_back[k], v)
    names = {n.replace(".", "/") for n, _ in port_params.named_parameters()}
    assert names == set(_flatten(want))


def test_bridge_rejects_unported_modules(jax_params):
    """A key of no module of the port raises and is named: a top-level
    module the port does not hold, and a leaf the calibrator has not."""
    tree = dict(jax.tree.map(np.asarray, jax_params))
    tree["viz_head"] = {"w": np.zeros((2, 6)), "b": np.zeros(6)}
    with pytest.raises(ValueError, match="viz_head/b"):
        convert.params_from_numpy(tree)
    calib = jcal.init_calibrator_params(jax.random.PRNGKey(0), tiny_cfg(), None)
    tree = dict(jax.tree.map(np.asarray, jax_params),
                calibrator=dict(jax.tree.map(np.asarray, calib), lstm={"w": np.zeros(3)}))
    with pytest.raises(ValueError, match="calibrator/lstm/w"):
        convert.params_from_numpy(tree)
