"""``tpu.compute_dtype="bfloat16"``: the port against the JAX package (CPU).

The port of ``tests/test_bf16.py:24`` and ``:45``. Both packages cast the
operands of the oracle's products (the attribute head, the relation MLP's
layers, the pair-code contractions) to bf16 and sum in float32; nothing
else changes. The port rounds the operands to bf16 and multiplies the
rounded values in float32 (``oracle.cast``), which is the same arithmetic.

* The forward of every question terminal, soft, on a deduplicated batch
  (the shared-image route) and a shuffled one (the per-question route,
  plain on the CPU), against JAX's bf16 forward under ``jax.jit``: log-
  probabilities within ``LP_ATOL`` (float32 sums in another order; a
  float32 difference can move a bf16 operand across a rounding boundary;
  the worst seen is 4.8e-6), answer flags equal except where JAX's answer
  is a near-tie within ``LP_ATOL`` in probability.
* The caches (``build_world``) of a relating batch per route within
  ``LP_ATOL``.
* JAX's shared route runs with ``rel_contract_then_gather`` off: XLA:CPU
  refuses its contract-then-gather product at bf16 ("Unsupported element
  type for DotThunk::Execute: BF16 x BF16 = F32"). The port's
  contract-then-gather is held against its own per-question einsum.
* One training step per route against ``jax.value_and_grad`` and optax
  (``tests/test_torch_train_loop.check_step``), gradients within
  ``STEP_RTOL`` of each leaf's largest value.
* The kernel routes' gates, as in JAX: under bf16 the shared route takes
  the contraction kernel (kernel 4) but not the pair-MLP kernel (kernel 3),
  and kernel 1's inputs h_s / h_o come from bf16 products while the
  kernel's own inputs stay float32; its plain version on the CPU is held
  against JAX's ``rel_cache_pallas`` in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu.ops.pallas.relation_oracle import rel_cache_pallas
from dfol_vqa_tpu_torch.convert import params_from_numpy
from dfol_vqa_tpu_torch.data import evalset, trainset
from dfol_vqa_tpu_torch.data.transfer import to_device_batch
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ops import pair_mlp, relation_oracle as ro, shared_contract
from chip_smoke import near_ties
from tests.test_torch_terminals import TERMINALS, terminal_batch
from tests.test_torch_train_loop import check_step

LP_ATOL = 1e-4
STEP_RTOL = 1e-4


def bf16_config(contract_then_gather: bool = True):
    cfg = trainset.demo_train_config(tiny=True)
    cfg.tpu.compute_dtype = "bfloat16"
    cfg.tpu.rel_contract_then_gather = contract_then_gather
    return cfg


@pytest.fixture(scope="module")
def setup(ontology):
    cfg = bf16_config(contract_then_gather=False)
    world = evalset.demo_world(ontology, tiny=True)
    jparams = JInterpreter(cfg, ontology).init_params(jax.random.PRNGKey(4))
    return cfg, world, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def jax_forward(cfg, ontology, jparams, lb, is_training=False):
    interp = JInterpreter(cfg, ontology)
    fn = jax.jit(lambda p, o, m, a: interp.forward(p, o, m, a, lb.spec, is_training, None))
    return fn(jparams, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
              {k: jnp.asarray(v) for k, v in lb.arrays.items()})


def port_forward(cfg, ontology, tparams, lb):
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    with torch.inference_mode():
        return Interpreter(cfg, ontology).forward(tparams, objs, mask, arrays, lb.spec)


def check_answers(term, got, want, opt_mask):
    """Answer flags equal except where JAX's answer is a near-tie within
    ``LP_ATOL`` in probability."""
    wl = np.asarray(want["log_probability"])
    differ = got["answer_flags"].numpy() != np.asarray(want["answer_flags"])
    tie = near_ties(term, wl, opt_mask, band=LP_ATOL).any(axis=1)
    assert not (differ.reshape(len(differ), -1).any(axis=1) & ~tie).any()


@pytest.mark.parametrize("route", ["shared", "per_question"])
@pytest.mark.parametrize("term", TERMINALS)
def test_bf16_forward_matches_jax(ontology, setup, term, route):
    cfg, world, jparams, tparams = setup
    lb = terminal_batch(ontology, cfg, world, term, route)
    want = jax_forward(cfg, ontology, jparams, lb)
    got = port_forward(cfg, ontology, tparams, lb)
    lp = got["log_probability"].numpy()
    assert np.isfinite(lp).all()
    np.testing.assert_allclose(lp, np.asarray(want["log_probability"]), atol=LP_ATOL, rtol=0)
    check_answers(term, got, want, lb.arrays["opt_mask"])


@pytest.mark.parametrize("route", ["shared", "per_question"])
def test_bf16_caches_match_jax(ontology, setup, route):
    """``build_world``'s attribute and relation caches of an ``exist`` batch
    against JAX's, and against the float32 caches: bf16 products move them
    (so the cast is not a no-op) by less than 0.05 in log-likelihood."""
    cfg, world, jparams, tparams = setup
    lb = terminal_batch(ontology, cfg, world, "exist", route)
    args = (lb.objects, lb.obj_mask, lb.arrays["rel_tokens"])
    jw = JInterpreter(cfg, ontology).build_world(
        jparams, *map(jnp.asarray, args), img_index=jnp.asarray(lb.arrays["img_index"]))
    with torch.inference_mode():
        tw = Interpreter(cfg, ontology).build_world(
            tparams, *map(torch.from_numpy, args),
            img_index=torch.from_numpy(lb.arrays["img_index"]))
        f32 = Interpreter(dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, compute_dtype="float32")), ontology).build_world(
            tparams, *map(torch.from_numpy, args),
            img_index=torch.from_numpy(lb.arrays["img_index"]))
    for name in ("attr_ll", "rel_ll"):
        got = getattr(tw, name).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jw, name)), atol=LP_ATOL, rtol=0,
                                   err_msg=name)
        moved = np.abs(got - getattr(f32, name).numpy()).max()
        assert 0 < moved < 0.05, (name, moved)


def test_bf16_contract_then_gather_matches_per_question_einsum(ontology, setup):
    """The shared route's two plain tails agree at bf16 (JAX cannot run the
    first on this host's XLA:CPU)."""
    cfg, world, _, tparams = setup
    lb = terminal_batch(ontology, cfg, world, "verify_rel", "shared")
    a = port_forward(bf16_config(contract_then_gather=True), ontology, tparams, lb)
    b = port_forward(cfg, ontology, tparams, lb)
    np.testing.assert_allclose(a["log_probability"].numpy(), b["log_probability"].numpy(),
                               atol=LP_ATOL, rtol=0)
    check_answers("verify_rel", a, {k: v.numpy() for k, v in b.items()},
                  lb.arrays["opt_mask"])


@pytest.mark.parametrize("route", ["shared", "per_question"])
def test_bf16_step_matches_jax(ontology, setup, route):
    """One step at bf16 compute on a relating batch, against JAX: loss,
    gradients within ``STEP_RTOL`` of each leaf's largest value (a float32
    difference can move a bf16-rounded gradient by one bf16 ULP), and the
    parameters after the optimizer step within ``chip_smoke.adam_bound``;
    the parameters stay float32 (``tests/test_bf16.py:45``)."""
    cfg, world, jparams, _ = setup
    lb = terminal_batch(ontology, cfg, world, "verify_rel", route)
    check_step(cfg, JInterpreter(cfg, ontology), jparams, Interpreter(cfg, ontology), lb,
               rtol=STEP_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_kernel_route_gates(ontology, setup, monkeypatch, dtype):
    """JAX's gate (``models/oracle.py:486-503``): on the kernel route the
    pair-MLP kernel runs at float32 compute only; the contraction kernel at
    both. With the route forced on the CPU (both kernels' wrappers run
    their plain versions there), the cache equals the plain tail's within
    ``LP_ATOL``: with the h2 stream at the compute dtype, the contraction
    kernel multiplies the values the plain tail's cast products do."""
    cfg, world, _, tparams = setup
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, compute_dtype=dtype, rel_stream_dtype=dtype))
    lb = terminal_batch(ontology, cfg, world, "exist", "shared")
    calls = {"pair_mlp": 0, "contract": 0}
    for mod, name, key in ((pair_mlp, "pair_mlp_fused", "pair_mlp"),
                           (shared_contract, "shared_contract_kernel", "contract")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _k=key, **k: (
            calls.__setitem__(_k, calls[_k] + 1), _r(*a, **k))[1])
    args = (tparams, lb.objects, lb.obj_mask, lb.arrays["rel_tokens"])
    interp = Interpreter(cfg, ontology)
    with torch.inference_mode():
        plain = interp.build_world(*args[:1], *map(torch.from_numpy, args[1:]),
                                   img_index=torch.from_numpy(lb.arrays["img_index"])).rel_ll
        monkeypatch.setattr(om, "shared_kernel_route", lambda *a: True)
        routed = interp.build_world(*args[:1], *map(torch.from_numpy, args[1:]),
                                    img_index=torch.from_numpy(lb.arrays["img_index"])).rel_ll
    assert calls == {"pair_mlp": int(dtype == "float32"), "contract": 1}
    np.testing.assert_allclose(routed.numpy(), plain.numpy(), atol=LP_ATOL, rtol=0)


def test_bf16_per_question_kernel_inputs_match_rel_cache_pallas(ontology, setup):
    """Kernel 1's route at bf16: ``rel_cache_kernel`` (its plain version on
    the CPU) against JAX's ``rel_cache_pallas`` in interpret mode, whose
    h_s / h_o products are bf16 and whose kernel takes float32; and its
    h_s differs from the float32 one (the cast reached it)."""
    cfg, world, jparams, tparams = setup
    lb = terminal_batch(ontology, cfg, world, "verify_rel", "per_question")
    interp = Interpreter(cfg, ontology)
    with torch.inference_mode():
        w = interp.build_world(tparams, torch.from_numpy(lb.objects),
                               torch.from_numpy(lb.obj_mask),
                               torch.from_numpy(lb.arrays["rel_tokens"]), needs_rel=False,
                               img_index=torch.from_numpy(lb.arrays["img_index"]))
        tok = torch.from_numpy(lb.arrays["rel_tokens"])
        got = ro.rel_cache_kernel(tparams, w.attr_in, w.pos, tok, cfg)
        h_s16 = ro.pair_tail_inputs(tparams, w.attr_in, w.pos, tok, cfg)[0]
        h_s32 = ro.pair_tail_inputs(tparams, w.attr_in, w.pos, tok)[0]
    want = jax.jit(lambda p, a, q, t: rel_cache_pallas(p, a, q, t, cfg))(
        jparams, jnp.asarray(w.attr_in.numpy()), jnp.asarray(w.pos.numpy()), jnp.asarray(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LP_ATOL, rtol=0)
    assert not torch.equal(h_s16, h_s32)
    torch.testing.assert_close(h_s16, h_s32, atol=0.05, rtol=0.05)
