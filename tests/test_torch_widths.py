"""Kernels 1, 2 and 3 at any width, on the CPU.

The pair-tail kernels take H and E as multiples of 4 (16-byte weight rows)
and loop over slices of 256 hidden units and 320 code columns. Here:

* ``ro.pad_widths`` / ``ro.unpad_grads``, the wrappers' zero padding: the
  plain forward and backward on padded inputs give the unpadded values and
  the JAX Pallas kernels' (interpret mode, ``tile=8``, as
  ``tests/test_torch_train.py`` runs them);
* the slice loops, emulated in plain PyTorch (``sliced_forward``,
  ``sliced_backward``) at small slices: z2 summed over H slices with h1
  rebuilt per slice, the logits summed over E slices before the
  logsigmoid, and the backward's three passes (h2 and logits, then de_sel /
  dz2 / db2 per E slice, then dW2 / dh1 / dz1 per H slice) give the JAX
  kernels' values;
* ``pm.pad_chain``, kernel 3's zero padding of its chain: the plain pair
  code is unchanged.

Tolerances: the log-likelihoods within atol 1e-5, each gradient within 1e-5
of max(1, its largest value) (float32 sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu.ops.pallas import relation_oracle as jro
from dfol_vqa_tpu_torch import nn
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.ops import relation_oracle as ro
from tests.test_torch_train import GRAD_NAMES, assert_grad_close, pair_tail_arrays

# (H, E): neither a multiple of 4, one of them, both
WIDTHS = [(10, 7), (6, 12), (8, 9), (12, 8)]
B, O, R = 2, 8, 3  # O a multiple of the JAX kernel's tile


def jax_forward(arrays, tok):
    """JAX's pair tail -> (B, R, O, O), pad slots at the default."""
    out = jro._pair_tail((8, True), *map(jnp.asarray, arrays))
    out = np.moveaxis(np.asarray(out), 3, 1)
    return np.where((tok != 0)[:, :, None, None], out, om.DEFAULT_LOG_LIKELIHOOD)


def jax_backward(arrays, tok, g):
    """JAX's nine gradients for the R-major cotangent g (pad slots zeroed, as
    the JAX wrapper does outside its custom VJP)."""
    g_jax = np.moveaxis(np.where((tok != 0)[:, :, None, None], g, 0.0), 1, 3)
    _, vjp = jax.vjp(functools.partial(jro._pair_tail, (8, True)), *map(jnp.asarray, arrays))
    return vjp(jnp.asarray(g_jax))


def cases(H, E):
    arrays, tok, g = pair_tail_arrays(np.random.default_rng(H * 100 + E), B, O, H, E, R)
    return arrays, tok, g, [torch.from_numpy(a) for a in arrays]


def slices(n: int, size: int):
    return [(s, min(size, n - s)) for s in range(0, n, size)]


def z1_of(h_s, h_o, geom, w_g, b0, h0, hs):
    """z1 of hidden units [h0, h0 + hs), as the kernels build a slice of h1."""
    cut = slice(h0, h0 + hs)
    return ((h_s[:, :, None, cut] + h_o[:, None, :, cut])
            + torch.einsum("bijg,gh->bijh", geom, w_g[:, cut]) + b0[cut])


def sliced_forward(ins, tok, slice_h, slice_e):
    """The kernels' forward loops: logits summed over E slices, each slice's
    z2 over H slices with h1 rebuilt per slice."""
    h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel = ins
    H, E = w2.shape
    logits = 0.0
    for e0, es in slices(E, slice_e):
        z2 = 0.0
        for h0, hs in slices(H, slice_h):
            h1 = nn.elu_exp(z1_of(h_s, h_o, geom, w_g, b0, h0, hs))
            z2 = z2 + torch.matmul(h1, w2[h0:h0 + hs, e0:e0 + es])
        h2 = torch.sigmoid(z2 + b2[e0:e0 + es])
        logits = logits + torch.einsum("bije,bre->brij", h2, e_sel[:, :, e0:e0 + es])
    out = torch.nn.functional.logsigmoid(logits + b_sel[:, :, None, None])
    return out.masked_fill((tok == 0)[:, :, None, None], om.DEFAULT_LOG_LIKELIHOOD)


def sliced_backward(ins, tok, g, slice_h, slice_e):
    """The backward kernel's three passes over the slices (its sliced
    instance)."""
    h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel = ins
    H, E = w2.shape
    h2 = torch.zeros(B, O, O, E)
    logits = 0.0
    for e0, es in slices(E, slice_e):  # pass 1: h2 and the logits
        z2 = 0.0
        for h0, hs in slices(H, slice_h):
            h1 = nn.elu_exp(z1_of(h_s, h_o, geom, w_g, b0, h0, hs))
            z2 = z2 + torch.matmul(h1, w2[h0:h0 + hs, e0:e0 + es])
        h2[..., e0:e0 + es] = torch.sigmoid(z2 + b2[e0:e0 + es])
        logits = logits + torch.einsum("bije,bre->brij", h2[..., e0:e0 + es],
                                       e_sel[:, :, e0:e0 + es])
    logits = logits + b_sel[:, :, None, None]
    dl = g * torch.sigmoid(-logits) * (tok != 0)[:, :, None, None]
    de_sel, db2, dz2 = torch.zeros(B, R, E), torch.zeros(E), torch.zeros(B, O, O, E)
    for e0, es in slices(E, slice_e):  # pass 2: de_sel, dz2, db2
        cut = slice(e0, e0 + es)
        de_sel[:, :, cut] = torch.einsum("brij,bije->bre", dl, h2[..., cut])
        dz2[..., cut] = (torch.einsum("brij,bre->bije", dl, e_sel[:, :, cut])
                         * h2[..., cut] * (1 - h2[..., cut]))
        db2[cut] = dz2[..., cut].sum((0, 1, 2))
    dh_s, dh_o, dgeom = torch.zeros(B, O, H), torch.zeros(B, O, H), 0.0
    dwg, db0, dw2 = torch.zeros(4, H), torch.zeros(H), torch.zeros(H, E)
    for h0, hs in slices(H, slice_h):  # pass 3: dW2, dh1, dz1's sums
        cut = slice(h0, h0 + hs)
        z1 = z1_of(h_s, h_o, geom, w_g, b0, h0, hs)
        h1 = nn.elu_exp(z1)
        dh1 = 0.0
        for e0, es in slices(E, slice_e):
            dw2[cut, e0:e0 + es] = torch.einsum("bijh,bije->he", h1, dz2[..., e0:e0 + es])
            dh1 = dh1 + torch.matmul(dz2[..., e0:e0 + es], w2[cut, e0:e0 + es].t())
        dz1 = dh1 * torch.where(z1 > 0, 1.0, torch.exp(torch.clamp(z1, max=0.0)))
        dh_s[..., cut], dh_o[..., cut] = dz1.sum(2), dz1.sum(1)
        dgeom = dgeom + torch.matmul(dz1, w_g[:, cut].t())
        dwg[:, cut] = torch.einsum("bijg,bijh->gh", geom, dz1)
        db0[cut] = dz1.sum((0, 1, 2))
    return dh_s, dh_o, dgeom, dwg, db0, dw2, db2, de_sel, dl.sum((2, 3))


@pytest.mark.parametrize("H,E", WIDTHS)
def test_padded_forward_equals_unpadded_and_jax(H, E):
    arrays, tok, _, ins = cases(H, E)
    padded = ro.pad_widths(*ins, 4)
    assert padded[5].shape == (-(-H // 4) * 4, -(-E // 4) * 4)
    if H % 4 == 0 and E % 4 == 0:
        assert all(p is t for p, t in zip(padded, ins))  # no copies
    tok_t = torch.from_numpy(tok)
    got = ro.pair_tail_reference(*padded, tok_t)
    torch.testing.assert_close(got, ro.pair_tail_reference(*ins, tok_t), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), jax_forward(arrays, tok), atol=1e-5, rtol=0)


@pytest.mark.parametrize("H,E", WIDTHS)
def test_padded_backward_equals_unpadded_and_jax(H, E):
    arrays, tok, g, ins = cases(H, E)
    tok_t, g_t = torch.from_numpy(tok), torch.from_numpy(g)
    got = ro.unpad_grads(ro.pair_tail_bwd_reference(*ro.pad_widths(*ins, 4), tok_t, g_t), H, E)
    plain = ro.pair_tail_bwd_reference(*ins, tok_t, g_t)
    for name, a, b, c in zip(GRAD_NAMES, got, plain, jax_backward(arrays, tok, g)):
        assert a.shape == b.shape, name
        assert_grad_close(a, b.numpy(), name)
        assert_grad_close(a, c, name)


@pytest.mark.parametrize("H,E", WIDTHS)
@pytest.mark.parametrize("slice_h,slice_e", [(4, 4), (8, 4), (4, 8)])
def test_sliced_loops_match_jax(H, E, slice_h, slice_e):
    """The slice loops on the padded widths (slices of 4 and 8 here, of 256
    and 320 in the kernels), cut back to the true widths."""
    arrays, tok, g, ins = cases(H, E)
    padded = ro.pad_widths(*ins, 4)
    tok_t, g_t = torch.from_numpy(tok), torch.from_numpy(g)
    np.testing.assert_allclose(sliced_forward(padded, tok_t, slice_h, slice_e).numpy(),
                               jax_forward(arrays, tok), atol=1e-5, rtol=0)
    got = ro.unpad_grads(sliced_backward(padded, tok_t, g_t, slice_h, slice_e), H, E)
    for name, a, b in zip(GRAD_NAMES, got, jax_backward(arrays, tok, g)):
        assert_grad_close(a, b, name)


@pytest.mark.parametrize("widths", [(10, 7), (6, 18, 9), (10,), (30, 18, 22), (8, 12)])
def test_pair_mlp_padded_chain_equals_unpadded(widths):
    """``pm.pad_chain``, kernel 3's zero padding of every width to a
    multiple of 4: the plain pair code of the padded chain, cut to the true
    output width, equals the unpadded one (no copies when nothing pads)."""
    from dfol_vqa_tpu_torch.ops import pair_mlp as pm
    from tests.test_torch_cuda_kernels import pair_arrays

    arrays, chain = pair_arrays(np.random.default_rng(len(widths)), 2, 5, widths)
    pos, h_s, h_o, w_g, b0 = map(torch.from_numpy, arrays)
    layers = [pm._Layer(torch.from_numpy(w), torch.from_numpy(b)) for w, b in chain]
    first, padded = pm.pad_chain(h_s, h_o, w_g, b0, layers, 4)
    assert all(n % 4 == 0 for layer in padded for n in layer.w.shape)
    if all(n % 4 == 0 for n in widths):
        assert all(a is b for a, b in zip(first, (h_s, h_o, w_g, b0)))
        assert all(a.w is b.w and a.b is b.b for a, b in zip(padded, layers))
    got = pm.pair_mlp_reference(pos, *first, padded, torch.float32)[..., :widths[-1]]
    want = pm.pair_mlp_reference(pos, h_s, h_o, w_g, b0, layers, torch.float32)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
