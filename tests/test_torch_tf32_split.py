"""The numerics of kernels 1 and 2's tensor-core products, on the CPU.

Both kernels run their H x E products on the tensor cores in TF32 with the
split-precision scheme: each float32 operand is ``tf32_split`` into a TF32
value and a TF32 residual, and a product is the sum of three TF32 partial
products with float32 sums ("3xTF32"). Here that arithmetic is emulated in
float32 (``tf32x3``) at kernel 2's shapes (H=256, E=300, R=8, up to
128 pairs in one product), through the pair tail's forward and its nine
gradients, against a float64 reference: it stays within the gates the card
is held to (``chip_smoke.KERNEL_ATOL`` on the log-likelihoods,
``chip_smoke.BWD_RTOL`` of each gradient's largest value), and so does a
plain float32 product, while a single TF32 product misses them. The bound
that ``chip_smoke.py`` reports charges such products at the 3xTF32 rate.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dfol_vqa_tpu_torch import nn
from dfol_vqa_tpu_torch.ops import relation_oracle as ro

NAMES = ("dh_s", "dh_o", "dgeom", "dWg", "db0", "dW2", "db2", "de_sel", "db_sel")


def tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels' tensor cores compute it: the three TF32
    partial products of ``tf32_split`` (each exact in float32), float32
    sums."""
    a_big, a_small = ro.tf32_split(a)
    b_big, b_small = ro.tf32_split(b)
    return a_big @ b_small + a_small @ b_big + a_big @ b_big


def tf32_once(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product: both operands rounded to TF32, float32 sums."""
    return ro.tf32_split(a)[0] @ ro.tf32_split(b)[0]


def f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


PRODUCTS = {"3xtf32": tf32x3, "float32": f32, "tf32": tf32_once}


def pair_tail(mm, h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens, g):
    """The forward's log-likelihoods and the nine gradients of
    ``ro.pair_tail_bwd_reference``, with the kernels' three H x E products
    (z2 = h1 W2, dh1 = dz2 W2^T, dW2 = h1^T dz2) through ``mm``; everything
    else in the inputs' dtype."""
    B, O, H = h_s.shape
    z1 = (h_s[:, :, None, :] + h_o[:, None, :, :]) + torch.einsum(
        "bijg,gh->bijh", geom, w_g) + b0
    h1 = nn.elu_exp(z1)
    h2 = torch.sigmoid(mm(h1.reshape(-1, H), w2).reshape(B, O, O, -1) + b2)
    logits = torch.einsum("bije,bre->brij", h2, e_sel) + b_sel[:, :, None, None]
    live = (rel_tokens != 0)[:, :, None, None]
    out = torch.nn.functional.logsigmoid(logits).masked_fill(~live, -30.0)
    dlogits = g * torch.sigmoid(-logits) * live.to(g.dtype)
    dz2 = torch.einsum("brij,bre->bije", dlogits, e_sel) * h2 * (1.0 - h2)
    dh1 = mm(dz2.reshape(-1, dz2.shape[-1]), w2.t()).reshape(B, O, O, H)
    dz1 = dh1 * torch.where(z1 > 0, 1.0, torch.exp(torch.clamp(z1, max=0.0)))
    dw2 = mm(h1.reshape(-1, H).t(), dz2.reshape(-1, dz2.shape[-1]))
    grads = (dz1.sum(2), dz1.sum(1), dz1 @ w_g.t(), torch.einsum("bijg,bijh->gh", geom, dz1),
             dz1.sum((0, 1, 2)), dw2, dz2.sum((0, 1, 2)),
             torch.einsum("brij,bije->bre", dlogits, h2), dlogits.sum((2, 3)))
    return out, grads


def inputs(B, O, H=256, E=300, R=8, seed=0):
    """Kernel 2's inputs at the scales of ``tests/test_torch_cuda_kernels.py``,
    three pad slots per question, float64."""
    rng = np.random.default_rng(seed)
    ins = [torch.from_numpy(a) for a in (
        rng.standard_normal((B, O, H)) * 0.5, rng.standard_normal((B, O, H)) * 0.5,
        rng.uniform(-1, 1, (B, O, O, 4)), rng.standard_normal((4, H)), rng.standard_normal(H),
        rng.standard_normal((H, E)) / np.sqrt(H), rng.standard_normal(E),
        rng.standard_normal((B, R, E)), rng.standard_normal((B, R)))]
    tok = rng.integers(1, 300, (B, R)).astype(np.int32)
    tok[:, R - 3:] = 0
    g = torch.from_numpy(rng.standard_normal((B, R, O, O)))
    return ins, torch.from_numpy(tok), g


def errors(product, B, O):
    """(max abs error of the log-likelihoods, {gradient: max abs error /
    its largest value}) of the float32 pair tail with ``product`` against
    the float64 one."""
    ins, tok, g = inputs(B, O)
    want_out, want = pair_tail(f32, *ins, tok, g)
    got_out, got = pair_tail(PRODUCTS[product], *[t.float() for t in ins], tok, g.float())
    rel = {n: ((a.double() - b).abs().max() / b.abs().max()).item()
           for n, a, b in zip(NAMES, got, want)}
    return (got_out.double() - want_out).abs().max().item(), rel


def test_tf32_split_rounds_to_nearest_and_keeps_the_residual():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(10_000).astype(np.float32))
    x[:3] = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -(1.0 + 2 ** -11)])  # ties, near
    big, small = ro.tf32_split(x)
    assert not (big.view(torch.int32) & 0x1FFF).any()   # a 10-bit mantissa
    assert not (small.view(torch.int32) & 0x1FFF).any()
    assert big[:3].tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10)]  # away
    assert ((x - big).abs() <= big.abs() * 2 ** -11).all()   # round to nearest
    # big + small keeps 21 of float32's 24 bits (small truncated to TF32)
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= x.abs().double() * 2 ** -20).all()


@pytest.mark.parametrize("B,O", [(1, 11), (2, 8)])  # 121 and 128 pairs per product
def test_3xtf32_products_meet_the_card_gates(B, O):
    out_err, rel = errors("3xtf32", B, O)
    assert out_err <= chip_smoke.KERNEL_ATOL
    assert max(rel.values()) <= chip_smoke.BWD_RTOL, rel
    # as close as float32 products, within a small factor
    f32_out, f32_rel = errors("float32", B, O)
    assert f32_out <= chip_smoke.KERNEL_ATOL and max(f32_rel.values()) <= chip_smoke.BWD_RTOL
    assert out_err <= 10 * f32_out + 1e-6


@pytest.mark.parametrize("dtype,rate", [(torch.float32, 495e12 / 3), (torch.bfloat16, 989e12)])
def test_kernel_bound_charges_products_at_their_operands_rate(dtype, rate):
    """``chip_smoke.kernel_bound``: float32 operands at the 3xTF32 rate (a
    third of TF32's), bfloat16 ones at the bf16 tensor-core rate; the bytes'
    time where it is larger."""
    work = chip_smoke.kernel_bound(1e12, 0, 1e6, dtype)
    assert work["bound_by"] == "operations"
    assert work["bound_ms"] == pytest.approx(1e3 * 1e12 / rate)
    work = chip_smoke.kernel_bound(1e9, 0, 1e9, dtype)
    assert work["bound_by"] == "bytes"
    assert work["bound_ms"] == pytest.approx(1e3 * 1e9 / 3.35e12)


@pytest.mark.parametrize("B,O", [(1, 11), (2, 8)])
def test_one_tf32_product_misses_the_card_gates(B, O):
    out_err, rel = errors("tf32", B, O)
    assert out_err > chip_smoke.KERNEL_ATOL or max(rel.values()) > chip_smoke.BWD_RTOL, rel


# ----------------------------------------------------- kernels 3 and 4's products


def pair_mlp_emulated(mm, pos, h_s, h_o, w_g, b0, w, b):
    """Kernel 3's one-Linear chain with its H x E product through ``mm``:
    (U, O, O, E) sigmoid outputs in the inputs' dtype."""
    from dfol_vqa_tpu_torch.models.featurizer import pair_geometry

    geom = pair_geometry(pos)
    h = (geom[..., 0, None] * w_g[0] + geom[..., 1, None] * w_g[1]
         + geom[..., 2, None] * w_g[2] + geom[..., 3, None] * w_g[3])
    h1 = nn.elu_exp(h + h_s[:, :, None, :] + h_o[:, None, :, :] + b0)
    U, O, _, H = h1.shape
    return torch.sigmoid(mm(h1.reshape(-1, H), w).reshape(U, O, O, -1) + b)


def pair_mlp_errors(product):
    """(max abs error against float64, bf16 outputs within one bf16 ULP of
    the plain float32 version's) of kernel 3's pair code at H=256, E=300,
    its product through ``product``."""
    from chip_smoke import bf16_ulp
    from dfol_vqa_tpu_torch.ops import pair_mlp as pm
    from tests.test_torch_cuda_kernels import pair_arrays

    arrays, chain = pair_arrays(np.random.default_rng(7), 1, 12, (256, 300))
    (w, b), = chain
    ins = [torch.from_numpy(a) for a in arrays + [w, b]]
    want = pair_mlp_emulated(f32, *[t.double() for t in ins])
    got = pair_mlp_emulated(PRODUCTS[product], *ins)
    plain16 = pm.pair_mlp_reference(*ins[:5], [pm._Layer(ins[5], ins[6])], torch.bfloat16)
    ulp_ok = bool(((got.to(torch.bfloat16).float() - plain16.float()).abs()
                   <= bf16_ulp(plain16)).all())
    return (got.double() - want).abs().max().item(), ulp_ok


def test_pair_mlp_3xtf32_product_meets_the_card_gates():
    """Kernel 3 at H=256, E=300: 3xTF32 meets KERNEL_ATOL on a float32 pair
    code and one bf16 ULP on a bf16 one; one TF32 product misses the first."""
    err, ulp_ok = pair_mlp_errors("3xtf32")
    assert err <= chip_smoke.KERNEL_ATOL and ulp_ok
    assert pair_mlp_errors("tf32")[0] > chip_smoke.KERNEL_ATOL


def bf16_tiled_contract(h2, img, e_sel, b_sel, tok, k_step=16):
    """Kernel 4's bf16 product: exact bf16 x bf16 products (exact in
    float32), summed in float32 in runs of ``k_step`` (one mma.sync.k16),
    each run added to the float32 accumulator; then the logsigmoid and the
    pad fill."""
    h2q = h2[img.long()].float()   # (B, O, O, E)
    e = e_sel.float()
    acc = torch.zeros(h2q.shape[0], e.shape[1], h2q.shape[1], h2q.shape[2])
    for k0 in range(0, h2q.shape[-1], k_step):
        acc = acc + torch.einsum("bije,bre->brij", h2q[..., k0:k0 + k_step], e[..., k0:k0 + k_step])
    out = torch.nn.functional.logsigmoid(acc + b_sel[:, :, None, None])
    return out.masked_fill((tok == 0)[:, :, None, None], -30.0)


def test_shared_contract_bf16_product_meets_the_card_gate():
    """Kernel 4 with a bf16 stream at E=300, R=8: exact products and float32
    sums in the kernel's tiled order stay within KERNEL_ATOL of the plain
    version, which sums the same products in one float32 einsum."""
    from dfol_vqa_tpu_torch.ops import shared_contract as sc
    from tests.test_torch_cuda_kernels import contract_inputs

    h2, img, e_sel, b_sel, tok = (torch.from_numpy(a) for a in contract_inputs(
        np.random.default_rng(3), 2, 6, 10, 300, 8, False))
    h2, e_sel = h2.to(torch.bfloat16), e_sel.to(torch.bfloat16)
    want = sc.shared_contract_reference(h2, img, e_sel, b_sel, tok, -30.0)
    got = bf16_tiled_contract(h2, img, e_sel, b_sel, tok)
    assert (got - want).abs().max().item() <= chip_smoke.KERNEL_ATOL
