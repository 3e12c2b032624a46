"""Training's building blocks on the CPU, against the JAX package.

* Kernel 2's plain version (``pair_tail_bwd_reference``) against the JAX
  Pallas backward kernel (``_pair_tail``'s custom VJP) in interpret mode,
  with pad slots; a float64 ``gradcheck`` of the ``PairTail`` function.
* autograd through the shared-route functions (``PairMLP``,
  ``SharedContract``, with their plain forwards standing in for the CUDA
  kernels) against ``jax.grad`` of the JAX kernels in interpret mode, h2 in
  float32 and bfloat16.
* The optimizer against the optax chain for three steps on fixed
  gradients: clip on and off, each freeze flag, weight decay.

Tolerances, with their reasons:

* gradients of float32 sums over all pairs, taken in another order:
  |port - JAX| <= 1e-5 * max(1, max|JAX|) per gradient;
* the optimizer: within 1e-4 * lr per element after three steps. optax
  takes Adam's bias corrections 1 - 0.999^t in float32, where the
  cancellation keeps ~4 significant digits (torch takes them in float64),
  so each step's size differs by up to ~1e-4 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfol_vqa_tpu.config import Config
from dfol_vqa_tpu.ops.pallas import pair_mlp as jpm
from dfol_vqa_tpu.ops.pallas import relation_oracle as jro
from dfol_vqa_tpu.ops.pallas.shared_contract import shared_contract_pallas
from dfol_vqa_tpu.train.optim import build_optimizer as jbuild_optimizer
from dfol_vqa_tpu_torch import convert
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.ops import pair_mlp as pm
from dfol_vqa_tpu_torch.ops import relation_oracle as ro
from dfol_vqa_tpu_torch.ops import shared_contract as sc
from dfol_vqa_tpu_torch.train.optim import Optimizer, trainable_labels
from tests.test_torch_cuda_kernels import contract_inputs, pair_arrays

GRAD_NAMES = ("dh_s", "dh_o", "dgeom", "dWg", "db0", "dW2", "db2", "de_sel", "db_sel")
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def assert_grad_close(got, want, name: str):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, name
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    dev = float(np.abs(got - want).max())
    assert dev <= atol, f"{name}: max deviation {dev!r} > {atol!r}"


def pair_tail_arrays(rng, B, O, H, E, R):
    """Kernel-2 inputs as numpy: (h_s, h_o, geom, w_g, b0, w2, b2, e_sel,
    b_sel), rel_tokens with pad slots, and an R-major cotangent that is
    nonzero on the pad slots too."""
    arrays = [rng.standard_normal((B, O, H)) * 0.5, rng.standard_normal((B, O, H)) * 0.5,
              rng.uniform(-1, 1, (B, O, O, 4)), rng.standard_normal((4, H)),
              rng.standard_normal(H) * 0.1, rng.standard_normal((H, E)) / np.sqrt(H),
              rng.standard_normal(E) * 0.1, rng.standard_normal((B, R, E)),
              rng.standard_normal((B, R))]
    tok = rng.integers(1, 300, (B, R)).astype(np.int32)
    tok[0, R - 1] = 0
    tok[B - 1, 0] = 0
    g = rng.standard_normal((B, R, O, O))
    return [a.astype(np.float32) for a in arrays], tok, g.astype(np.float32)


# ------------------------------------------------------------------- kernel 2


@pytest.mark.parametrize("B,O,R", [(2, 16, 3), (3, 8, 4)])
def test_pair_tail_bwd_reference_matches_pallas_bwd_kernel(B, O, R):
    """tile=8, H=8, E=6. The JAX wrapper zeroes the pad slots' cotangent
    outside its custom VJP; the port's backward must do it itself, so it is
    given the cotangent with the pad slots still nonzero."""
    arrays, tok, g = pair_tail_arrays(np.random.default_rng(B * O + R), B, O, 8, 6, R)
    live = (tok != 0)[:, :, None, None]
    g_jax = np.moveaxis(np.where(live, g, 0.0), 1, 3)  # (B, O, O, R), pad slots zero
    _, vjp = jax.vjp(functools.partial(jro._pair_tail, (8, True)), *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(g_jax))
    got = ro.pair_tail_bwd_reference(*map(torch.from_numpy, arrays), torch.from_numpy(tok),
                                     torch.from_numpy(g))
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert_grad_close(a, b, name)


def test_pair_tail_function_gradcheck():
    """Float64, every input requiring a gradient (dgeom included), pad slots."""
    rng = np.random.default_rng(5)
    arrays, tok, _ = pair_tail_arrays(rng, 2, 4, 5, 3, 3)
    ins = [torch.from_numpy(a).double().requires_grad_() for a in arrays]
    tok = torch.from_numpy(tok)
    assert torch.autograd.gradcheck(lambda *a: ro.PairTail.apply(*a, tok, -30.0), ins)


def test_pair_tail_function_asks_for_dgeom_only_when_needed(monkeypatch):
    arrays, tok, _ = pair_tail_arrays(np.random.default_rng(6), 2, 4, 5, 3, 3)
    seen = []
    plain = ro.pair_tail_bwd_reference
    monkeypatch.setattr(ro, "pair_tail_bwd_reference",
                        lambda *a: (seen.append(a[-1]), plain(*a))[1])
    for geom_grad in (False, True):
        ins = [torch.from_numpy(a).requires_grad_(k != 2 or geom_grad)
               for k, a in enumerate(arrays)]
        ro.PairTail.apply(*ins, torch.from_numpy(tok), -30.0).sum().backward()
        assert (ins[2].grad is not None) == geom_grad
    assert seen == [False, True]


def test_pair_tail_function_matches_autograd_of_the_plain_forward():
    arrays, tok, g = pair_tail_arrays(np.random.default_rng(7), 2, 6, 8, 6, 3)
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tok, g = torch.from_numpy(tok), torch.from_numpy(g)
    want = torch.autograd.grad(ro.pair_tail_reference(*ins, tok), ins, g)
    got = torch.autograd.grad(ro.PairTail.apply(*ins, tok, -30.0), ins, g)
    for name, a, b in zip(GRAD_NAMES, got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=name)


# ------------------------------------------------------- shared-route autograd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_mlp_function_grads_match_jax(monkeypatch, dtype):
    """U=2, O=128 (the JAX kernel needs O % 128 == 0), H=8, one inner layer
    of 12, E=6; the loss is sum(h2 * w) in float32, so the bf16 case's
    cotangent is w rounded to bf16 on both sides."""
    td, jd = DTYPES[dtype]
    rng = np.random.default_rng(11)
    arrays, chain = pair_arrays(rng, 2, 128, (8, 12, 6))
    w = rng.standard_normal((2, 128, 128, 6)).astype(np.float32)

    def jloss(h_s, h_o, w_g, b0, layers):
        out = jpm.pair_mlp_fused(jnp.asarray(arrays[0]), h_s, h_o, w_g, b0, layers,
                                 out_dtype=jd, tile=8, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w)

    jlayers = [{"w": jnp.asarray(a), "b": jnp.asarray(b)} for a, b in chain]
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays[1:]), jlayers)
    want = list(want[:4]) + [t for lay in want[4] for t in (lay["w"], lay["b"])]

    pos = torch.from_numpy(arrays[0])
    monkeypatch.setattr(pm, "pair_mlp_launch",
                        lambda geom, *a: pm.pair_mlp_reference(pos, *a))  # the kernel's stand-in
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays[1:]]
    wb = [torch.from_numpy(t).requires_grad_() for pair in chain for t in pair]
    out = pm.PairMLP.apply(td, pos, *ins, *wb)
    assert out.dtype == td
    (out.float() * torch.from_numpy(w)).sum().backward()
    for k, (t, b) in enumerate(zip(ins + wb, want)):
        assert_grad_close(t.grad, b, f"input {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_contract_function_grads_match_jax(monkeypatch, dtype):
    """U=3, B=6, O=16, E=24, R=4 with pad slots, unsorted images; h2 and
    e_sel in the stream dtype, the cache in float32; no (B, O, O, E) gather
    in the backward."""
    td, jd = DTYPES[dtype]
    rng = np.random.default_rng(12)
    h2, img, e_sel, b_sel, tok = contract_inputs(rng, 3, 6, 16, 24, 4, False)
    w = rng.standard_normal((6, 4, 16, 16)).astype(np.float32)
    h2_j, e_j = jnp.asarray(h2).astype(jd), jnp.asarray(e_sel).astype(jd)

    def jloss(h2_u, e, b):
        out = shared_contract_pallas(h2_u, jnp.asarray(img), e, b, jnp.asarray(tok),
                                     om.DEFAULT_LOG_LIKELIHOOD, tile=8, interpret=True)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(h2_j, e_j, jnp.asarray(b_sel))
    monkeypatch.setattr(sc, "shared_contract_launch",
                        lambda h2_u, img_index, order, *a: sc.shared_contract_reference(
                            h2_u, img_index, *a))  # the kernel's stand-in
    ins = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(td).requires_grad_()
           for a in (h2_j, e_j)]
    b_t = torch.from_numpy(b_sel).requires_grad_()
    out = sc.SharedContract.apply(ins[0], torch.from_numpy(img), None, ins[1], b_t,
                                  torch.from_numpy(tok), om.DEFAULT_LOG_LIKELIHOOD,
                                  torch.float32)
    (out * torch.from_numpy(w)).sum().backward()
    assert ins[0].grad.dtype == td and ins[1].grad.dtype == td
    for name, t, b in zip(("dh2", "de_sel", "db_sel"), ins + [b_t], want):
        if dtype == "bfloat16" and name != "db_sel":
            # both round the float32 cotangent to bf16: within one bf16 ULP
            from chip_smoke import bf16_ulp

            want_f = torch.from_numpy(np.array(b.astype(jnp.float32)))
            assert torch.all((t.grad.float() - want_f).abs() <= bf16_ulp(want_f)), name
        else:
            assert_grad_close(t.grad, b, name)


# ------------------------------------------------------------------ optimizer


def opt_cfg(**kw) -> Config:
    cfg = Config(box_features_dim=8, oracle_input_dim=6, word_embedding_dim=5,
                 featurizer_layers_config=[4], attribute_network_layers_config=[4],
                 relation_network_layers_config=[4], dropout=0.0)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.parametrize("kw", [
    {"clip_norm": 1e6},                                   # clip inactive
    {"clip_norm": 0.05},                                  # clip active every step
    {"freeze_featurizer": True}, {"freeze_attribute_network": True},
    {"freeze_relation_network": True}, {"freeze_embedding_network": True},
    {"freeze_embedding_bias": True},
    {"weight_decay": 0.1, "freeze_relation_network": True, "clip_norm": 0.05},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_optimizer_matches_optax(ontology, kw):
    """Three steps on fixed gradients; frozen leaves never move."""
    cfg = opt_cfg(learning_rate=1e-2, **kw)
    tp = om.init_oracle_params(cfg, ontology, torch.Generator().manual_seed(0))
    # copies: on the CPU .numpy() shares the parameters' memory
    start = {k: np.array(v) for k, v in convert.flatten(convert.params_to_numpy(tp)).items()}
    jp = jax.tree.map(jnp.asarray, convert.unflatten(start))
    rng = np.random.default_rng(3)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 0.1 for k, v in start.items()}
             for _ in range(3)]
    if cfg.weight_decay > 1e-6:
        # g and weight_decay * p point the same way, so their sum never nearly
        # cancels: there Adam's normalised step would turn a last-bit rounding
        # into a step of up to ~lr
        grads = [{k: np.where(start[k] != 0, np.abs(v) * np.sign(start[k]), v)
                  for k, v in g.items()} for g in grads]
    tx = jbuild_optimizer(cfg, jp)
    state = tx.init(jp)
    opt = Optimizer(cfg, tp)
    labels = trainable_labels(tp, cfg)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, convert.unflatten(g)), state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, p in tp.named_parameters():
            p.grad = torch.from_numpy(g[name.replace(".", "/")].copy())
        opt.step()
    got = convert.flatten(convert.params_to_numpy(tp))
    want = convert.flatten(jax.tree.map(np.asarray, jp))
    for name in labels:
        key = name.replace(".", "/")
        np.testing.assert_allclose(got[key], want[key], atol=1e-4 * cfg.learning_rate, rtol=0,
                                   err_msg=key)
        if not labels[name]:
            np.testing.assert_array_equal(got[key], start[key], err_msg=key)
        else:
            assert not np.array_equal(got[key], start[key]), key


@pytest.mark.parametrize("kw", [{"clip_norm": 1e6}, {"clip_norm": 0.05},
                                {"weight_decay": 0.1, "freeze_relation_network": True}],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_adam_bound_holds_and_is_tight(ontology, kw):
    """``chip_smoke.adam_bound``, the gate on parameters after k steps of two
    implementations: two optimizers fed gradients that differ by up to delta
    (1e-4 of each leaf's largest value) end, after 3 steps, within the bound
    element by element; frozen leaves get a bound of 0; and the bound stays
    far below lr wherever the gradient is not near zero, so a step off by a
    tenth of lr there fails it."""
    from chip_smoke import adam_bound, clip_scale, flat_params, trainable_keys

    cfg = opt_cfg(learning_rate=1e-2, **kw)
    ref = om.init_oracle_params(cfg, ontology, torch.Generator().manual_seed(0))
    other = om.init_oracle_params(cfg, ontology, torch.Generator().manual_seed(0))
    o_ref, o_other = Optimizer(cfg, ref), Optimizer(cfg, other)
    trainable = trainable_keys(cfg, ref)
    rng = np.random.default_rng(5)
    steps = []
    for _ in range(3):
        start = flat_params(ref)
        g_ref = {k: rng.standard_normal(v.shape) * 0.1 for k, v in start.items()}
        delta = {k: 1e-4 * max(1.0, float(np.abs(v).max())) for k, v in g_ref.items()}
        g_other = {k: v + rng.uniform(-1, 1, v.shape) * delta[k] for k, v in g_ref.items()}
        for params, grads in ((ref, g_ref), (other, g_other)):
            for name, p in params.named_parameters():
                p.grad = torch.from_numpy(grads[name.replace(".", "/")].astype(np.float32))
        o_ref.step()
        o_other.step()
        steps.append((g_ref, {k: v.astype(np.float32) for k, v in g_other.items()}, start, delta))
    bound = adam_bound(cfg, trainable, steps)
    got, want = flat_params(other), flat_params(ref)
    for key, b in bound.items():
        assert np.all(np.abs(got[key].astype(np.float64) - want[key]) <= b), key
        if key not in trainable:
            assert not np.any(b), key
    # elements whose clipped, decayed gradient stays away from 0 in every step
    far = {k: np.min([np.abs(clip_scale(cfg, g, trainable) * g[k] + cfg.weight_decay * p[k])
                      / clip_scale(cfg, g, trainable) for g, _, p, _ in steps], 0)
           for k in trainable}
    large = np.concatenate([bound[k][far[k] > 0.02] for k in trainable])
    assert large.size > 100 and large.max() < 0.1 * cfg.learning_rate
