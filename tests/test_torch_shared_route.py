"""The shared-image relation route on the CPU: the pair-MLP and
shared-contract kernel modules' plain versions against the JAX package's
kernels and XLA twins, the wrappers' routing, and ``rel_cache_shared``
against JAX's. The CUDA kernels themselves are tested against these plain
versions on a card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

The JAX kernels run in Pallas interpret mode at ``tile=8``, as
``tests/test_pair_mlp_kernel.py`` and ``tests/test_shared_contract.py`` run
them. Tolerances: log-likelihood caches within atol 1e-5 (float32 sums in
another order); the float32 pair code of the Pallas kernel comparison within
``pair_mlp_tolerance`` (a bound computed from the inputs); a bf16 pair code
within one bf16 ULP of the value (both sides round a float32 value to bf16,
and float32 values that differ in their last bits can round to neighbouring
bf16 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu.config import Config
from dfol_vqa_tpu.models import oracle as jom
from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu.ops.pallas import pair_mlp as jpm
from dfol_vqa_tpu.ops.pallas.shared_contract import shared_contract_pallas
from dfol_vqa_tpu_torch import convert, nn
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.models.featurizer import pair_geometry
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ops import pair_mlp as pm
from dfol_vqa_tpu_torch.ops import shared_contract as sc
from chip_smoke import bf16_ulp
from tests.test_torch_cuda_kernels import contract_inputs, pair_arrays

TOL = dict(atol=1e-5, rtol=0)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
F32_EPS = float(np.finfo(np.float32).eps)
RATIO_ULPS = 4  # float32 ULPs by which the two packages may round the angle's sine


def assert_close(got: torch.Tensor, want, dtype: str, atol=TOL["atol"]):
    got = got.detach().float().numpy()
    want = np.array(jnp.asarray(want).astype(jnp.float32))
    if dtype == "bfloat16":
        assert np.all(np.abs(got - want) <= bf16_ulp(torch.from_numpy(want)).numpy())
    else:
        dev = np.abs(got - want)
        k = np.unravel_index(np.argmax(dev - atol), dev.shape)
        assert np.all(dev <= atol), (f"max deviation {dev.max()!r}; worst against the bound "
                                     f"{dev[k]!r} > {np.broadcast_to(atol, dev.shape)[k]!r} on "
                                     f"the value {want[k]!r} at {k}")


def pair_mlp_tolerance(arrays, chain) -> np.ndarray:
    """Per-element bound on |port - JAX| for a float32 pair code: the flat
    atol of 1e-5 for float32 sums of the depth-16/24 contractions taken in
    another order (measured: <= 2.4e-7), plus the angle feature's
    conditioning.

    angle = asin(dy / dist) has the slope 1 / sqrt(1 - r^2), which grows
    without bound as |r| -> 1 (near-vertical pairs). XLA and ATen may round
    the ratio differently by an ULP or two (FMA contraction and vector code,
    chosen per host CPU), and there that moves the angle by up to ~1e-4 and
    the pair code by ~1e-5: the fault behind this test's failure on another
    host. That term is ``RATIO_ULPS`` ULPs of r through asin, times the
    output's exact sensitivity to the angle (forward mode in float64 through
    w_g[1], the ELUs, the chain and the sigmoid). It is below 1e-7 away from
    near-vertical pairs."""
    pos, h_s, h_o, w_g, b0 = (a.astype(np.float64) for a in arrays)
    geom = pair_geometry(torch.from_numpy(pos)).numpy()
    r = np.abs(np.sin(geom[..., 1]))
    ang = np.arcsin(r)
    d_ang = np.maximum(np.arcsin(np.minimum(r * (1 + RATIO_ULPS * F32_EPS), 1.0)) - ang,
                       ang - np.arcsin(r * (1 - RATIO_ULPS * F32_EPS)))
    z = np.einsum("uijg,gh->uijh", geom, w_g) + h_s[:, :, None] + h_o[:, None] + b0
    dz = np.broadcast_to(w_g[1], z.shape)  # d z / d angle
    for w, b in chain:
        w, b = w.astype(np.float64), b.astype(np.float64)
        dz = (dz * np.where(z > 0, 1.0, np.exp(np.minimum(z, 0.0)))) @ w
        z = np.where(z > 0, z, np.expm1(np.minimum(z, 0.0))) @ w + b
    sig = 1.0 / (1.0 + np.exp(-z))
    return TOL["atol"] + np.abs(sig * (1.0 - sig) * dz) * d_ang[..., None]


def pair_inputs(rng, U, O, widths):
    """(pos, h_s, h_o, w_g, b0) and the chain as JAX dicts and port Linears."""
    arrays, chain = pair_arrays(rng, U, O, widths)
    jl = [{"w": jnp.asarray(w), "b": jnp.asarray(b)} for w, b in chain]
    tl = [nn.Linear(torch.from_numpy(w), torch.from_numpy(b)) for w, b in chain]
    return arrays, jl, tl


# ------------------------------------------------------------------- pair MLP


@pytest.mark.parametrize("hidden,dtype", [((), "float32"), ((24,), "float32"),
                                          ((), "bfloat16"), ((24,), "bfloat16")])
def test_pair_mlp_reference_matches_pallas_kernel(hidden, dtype):
    """U=2, O=128 (the JAX kernel needs O % 128 == 0), H=16, E=12, with and
    without an inner layer of 24. Float32 within ``pair_mlp_tolerance``."""
    widths = (16,) + hidden + (12,)
    arrays, jl, tl = pair_inputs(np.random.default_rng(len(hidden)), 2, 128, widths)
    want = jpm.pair_mlp_fused(*map(jnp.asarray, arrays), jl, out_dtype=DTYPES[dtype][1],
                              tile=8, interpret=True)
    got = pm.pair_mlp_reference(*map(torch.from_numpy, arrays), tl, DTYPES[dtype][0])
    assert got.shape == (2, 128, 128, 12) and got.dtype == DTYPES[dtype][0]
    chain = [(lay.w.detach().numpy(), lay.b.detach().numpy()) for lay in tl]
    assert_close(got, want, dtype, atol=pair_mlp_tolerance(arrays, chain))


@pytest.mark.parametrize("hidden,dtype", [((), "float32"), ((24, 8), "float32"),
                                          ((), "bfloat16")])
def test_pair_mlp_reference_matches_xla_at_true_o(hidden, dtype):
    """O=7: the port runs at the true object count (no 128-lane padding)."""
    arrays, jl, tl = pair_inputs(np.random.default_rng(7), 3, 7, (16,) + hidden + (12,))
    want = jpm.pair_mlp_xla(*map(jnp.asarray, arrays), jl, out_dtype=DTYPES[dtype][1])
    got = pm.pair_mlp_reference(*map(torch.from_numpy, arrays), tl, DTYPES[dtype][0])
    assert_close(got, want, dtype)


def test_pair_mlp_wrapper_on_cpu_takes_the_plain_version():
    arrays, _, tl = pair_inputs(np.random.default_rng(1), 2, 5, (8, 6))
    ins = list(map(torch.from_numpy, arrays))
    before = pm.LAUNCHES
    got = pm.pair_mlp_fused(*ins, tl, torch.float32)
    assert torch.equal(got, pm.pair_mlp_reference(*ins, tl, torch.float32))
    assert pm.LAUNCHES == before  # the CUDA kernel never ran


# ----------------------------------------------------------- shared contract


@pytest.mark.parametrize("O,sorted_imgs,dtype", [(7, True, "float32"), (16, False, "float32"),
                                                 (20, True, "float32"),
                                                 (16, False, "bfloat16")])
def test_shared_contract_reference_matches_pallas_kernel(O, sorted_imgs, dtype):
    """h2 and e_sel in the stream dtype, the cache in float32 (and bf16 for
    the bf16 case); float32 sums on both sides."""
    h2, img, e_sel, b_sel, tok = contract_inputs(np.random.default_rng(O), 3, 6, O, 24, 4,
                                                 sorted_imgs)
    td, jd = DTYPES[dtype]
    h2_j, e_j = jnp.asarray(h2).astype(jd), jnp.asarray(e_sel).astype(jd)
    want = shared_contract_pallas(h2_j, jnp.asarray(img), e_j, jnp.asarray(b_sel),
                                  jnp.asarray(tok), om.DEFAULT_LOG_LIKELIHOOD, tile=8,
                                  interpret=True, out_dtype=jd)
    h2_t, e_t = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(td) for a in (h2_j, e_j))
    got = sc.shared_contract_reference(h2_t, torch.from_numpy(img), e_t, torch.from_numpy(b_sel),
                                       torch.from_numpy(tok), out_dtype=td)
    assert got.shape == (6, 4, O, O) and got.dtype == td
    assert_close(got, want, dtype)
    assert torch.all(got[0, -1] == om.DEFAULT_LOG_LIKELIHOOD)
    assert torch.all(got[-1, 0] == om.DEFAULT_LOG_LIKELIHOOD)


def test_shared_contract_wrapper_on_cpu_takes_the_plain_version():
    ins = list(map(torch.from_numpy, contract_inputs(np.random.default_rng(2), 2, 5, 6, 8, 3,
                                                     False)))
    before = sc.LAUNCHES
    assert torch.equal(sc.shared_contract_kernel(*ins), sc.shared_contract_reference(*ins))
    assert sc.LAUNCHES == before


# ----------------------------------------------------------- rel_cache_shared


def shared_cfg(**tpu) -> Config:
    cfg = Config(box_features_dim=32, oracle_input_dim=16, word_embedding_dim=12,
                 featurizer_layers_config=[], attribute_network_layers_config=[8],
                 relation_network_layers_config=[8], dropout=0.0)
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    return cfg


@pytest.fixture(scope="module")
def shared_params(ontology):
    jp = jom.init_oracle_params(jax.random.PRNGKey(4), shared_cfg(), ontology)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


def shared_inputs(ontology, cfg, U=3, B=8, O=6, R=4, seed=0, foreign=False):
    """Relation tokens from the relation sub-vocabulary (what the compiler
    routes into a slot), with pad slots; ``foreign`` puts a non-relation
    token into one slot."""
    rng = np.random.default_rng(seed)
    attr_in = rng.uniform(size=(U, O, cfg.attr_input_dim)).astype(np.float32)
    pos = rng.uniform(size=(U, O, 4)).astype(np.float32)
    img = np.sort(rng.integers(0, U, B)).astype(np.int32)
    rel_cols = np.asarray(ontology._relation_index)
    tok = (rng.choice(rel_cols, (B, R)) + 1).astype(np.int32)
    tok[0, R - 1] = 0
    tok[3, 0] = 0
    if foreign:
        tok[1, 1] = next(c for c in range(ontology.num_tokens) if c not in set(rel_cols)) + 1
    return attr_in, pos, img, tok


@pytest.mark.parametrize("ctg", [True, False])
@pytest.mark.parametrize("debug", [False, True])
def test_rel_cache_shared_matches_jax(ontology, shared_params, ctg, debug):
    """Contract-then-gather on and off, with ``debug_checks``: a non-relation
    token poisons its slot with NaN on the contract-then-gather tail only."""
    jp, tp = shared_params
    cfg = shared_cfg(rel_contract_then_gather=ctg, debug_checks=debug)
    ins = shared_inputs(ontology, cfg, foreign=debug)
    want = jom.rel_cache_shared(jp, *map(jnp.asarray, ins), cfg,
                                rel_gather=JInterpreter(cfg, ontology)._rel_gather_map)
    got = om.rel_cache_shared(tp, *map(torch.from_numpy, ins), cfg,
                              rel_gather=Interpreter(cfg, ontology)._rel_gather_map)
    assert got.shape == (8, 4, 6, 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), equal_nan=True, **TOL)
    assert torch.isnan(got[1, 1]).all() == (debug and ctg)
    assert torch.all(got[0, 3] == om.DEFAULT_LOG_LIKELIHOOD)


@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [True, False])
def test_kernel_route_composition_on_cpu(ontology, shared_params, monkeypatch, stream, fused):
    """The kernel route's composition (stream-dtype h2, e_sel cast, contraction
    into the cache dtype), with the plain versions standing in for the CUDA
    kernels: at a float32 stream it equals JAX's plain tail; at bf16 it
    equals the JAX kernels' formulation (pair_mlp_xla + shared contraction)."""
    jp, tp = shared_params
    cfg = shared_cfg(rel_stream_dtype=stream, fused_pair_mlp=fused)
    ins = shared_inputs(ontology, cfg, seed=1)
    monkeypatch.setattr(om, "shared_kernel_route", lambda *a: True)
    got = om.rel_cache_shared(tp, *map(torch.from_numpy, ins), cfg)
    attr_in, pos, img, tok = map(jnp.asarray, ins)
    layers = jp["relation_network"]["layers"]
    w_s, w_o, w_g, b0 = jom._first_layer_split(layers[0], attr_in.shape[-1])
    jd = DTYPES[stream][1]
    h2 = jpm.pair_mlp_xla(pos, attr_in @ w_s, attr_in @ w_o, w_g, b0, layers[1:], out_dtype=jd)
    tok0 = jnp.clip(tok - 1, 0)
    want = shared_contract_pallas(h2, img, jp["embedding"]["w"].T[tok0].astype(jd),
                                  jp["embedding"]["b"][tok0], tok, om.DEFAULT_LOG_LIKELIHOOD,
                                  tile=8, interpret=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if stream == "float32":
        plain = jom.rel_cache_shared(jp, attr_in, pos, img, tok, cfg)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(plain), **TOL)


def test_shared_kernel_route_gates():
    """On CUDA, "auto" and "pallas" take the kernels at any O and batch; "xla",
    use_pallas off, active dropout or the CPU take a plain tail."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert om.shared_kernel_route(shared_cfg(), cuda, True)
    assert om.shared_kernel_route(shared_cfg(rel_route="pallas"), cuda, True)
    assert not om.shared_kernel_route(shared_cfg(rel_route="xla"), cuda, True)
    assert not om.shared_kernel_route(shared_cfg(use_pallas=False), cuda, True)
    assert not om.shared_kernel_route(shared_cfg(), cpu, True)
    cfg = shared_cfg()
    cfg.dropout = 0.1
    assert not om.shared_kernel_route(cfg, cuda, False)
    assert om.shared_kernel_route(cfg, cuda, True)
    with pytest.raises(ValueError):
        om.shared_kernel_route(shared_cfg(rel_route="mosaic"), cuda, True)
