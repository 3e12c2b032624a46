"""Every CUDA kernel of the port against its plain PyTorch version, on a card.

This file imports no JAX, so it also runs on a GPU machine without the JAX
package, where ``tests/conftest.py`` (which imports JAX) cannot load:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Here, without a card, every test skips. Tolerances: 1e-4 abs for float32
results (f32 FMA order over H=256 and E=300 against cuBLAS/ATen sums); one
bf16 ULP of the value for bf16 results (both sides round a float32 value
that may differ in its last bits); gradients within 1e-4 of each
gradient's largest value (float32 sums over many pairs in another order).
The input helpers are shared with the CPU tests of
``tests/test_torch_shared_route.py`` and ``tests/test_torch_train.py``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import bf16_ulp
from dfol_vqa_tpu.config import Config
from dfol_vqa_tpu.ontology import GQAOntology
from dfol_vqa_tpu_torch import nn
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ops import pair_mlp as pm
from dfol_vqa_tpu_torch.ops import relation_oracle as ro
from dfol_vqa_tpu_torch.ops import shared_contract as sc

torch.backends.cuda.matmul.allow_tf32 = False
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pair_arrays(rng, U, O, widths):
    """Pair-MLP inputs (pos, h_s, h_o, w_g, b0) and a chain of (w, b) over
    ``widths`` = (H, ..., E), as numpy."""
    H = widths[0]
    pos = rng.uniform(0, 1, (U, O, 4)).astype(np.float32)
    pos[0, 1] = pos[0, 0]  # coincident boxes: dist 0, asin clamp
    arrays = [pos] + [rng.standard_normal(s).astype(np.float32)
                      for s in ((U, O, H), (U, O, H), (4, H), (H,))]
    chain = [((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32),
              rng.standard_normal(n).astype(np.float32))
             for k, n in zip(widths[:-1], widths[1:])]
    return arrays, chain


def contract_inputs(rng, U, B, O, E, R, sorted_imgs):
    """Shared-contract inputs (h2, img_index, e_sel, b_sel, rel_tokens) with
    two pad slots, as numpy."""
    h2 = (1.0 / (1.0 + np.exp(-rng.standard_normal((U, O, O, E))))).astype(np.float32)
    img = rng.integers(0, U, B).astype(np.int32)
    if sorted_imgs:
        img = np.sort(img)
    e_sel = rng.standard_normal((B, R, E)).astype(np.float32)
    b_sel = rng.standard_normal((B, R)).astype(np.float32)
    tok = rng.integers(1, 300, (B, R)).astype(np.int32)
    tok[0, -1] = 0
    tok[-1, 0] = 0
    return h2, img, e_sel, b_sel, tok


def assert_matches(got: torch.Tensor, want: torch.Tensor):
    assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
    if want.dtype == torch.bfloat16:
        assert bool(((got.float() - want.float()).abs() <= bf16_ulp(want)).all())
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ontology():
    return GQAOntology()


@pytest.mark.cuda
@pytest.mark.parametrize("B,O,H,E", [(2, 7, 8, 12), (3, 33, 16, 40), (32, 24, 256, 300)])
def test_cuda_relation_oracle_matches_plain(cuda, ontology, B, O, H, E):
    cfg = Config(box_features_dim=32, oracle_input_dim=16, word_embedding_dim=E,
                 featurizer_layers_config=[], attribute_network_layers_config=[8],
                 relation_network_layers_config=[H], dropout=0.0)
    tp = om.init_oracle_params(cfg, ontology, torch.Generator().manual_seed(0), cuda)
    rng = np.random.default_rng(0)
    attr_in = rng.uniform(size=(B, O, cfg.attr_input_dim)).astype(np.float32)
    pos = rng.uniform(size=(B, O, 4)).astype(np.float32)
    tok = rng.integers(1, 2300, (B, 8)).astype(np.int32)
    tok[0, 7] = 0
    ins = [torch.from_numpy(a).to(cuda) for a in (attr_in, pos, tok)]
    before = ro.LAUNCHES
    with torch.inference_mode():
        got = ro.rel_cache_kernel(tp, *ins, cfg)
        want = ro.rel_cache_kernel_reference(tp, *ins)
    torch.cuda.synchronize()
    assert ro.LAUNCHES == before + 1
    assert_matches(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("U,O,widths", [(2, 7, (8, 12)), (3, 33, (16, 24, 40)), (2, 5, (16,)),
                                        (8, 100, (256, 300))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_pair_mlp_matches_plain(cuda, U, O, widths, dtype):
    """Chains of one and two Linear layers, and none (sigmoid of the split
    first layer), at odd O and at the production shape."""
    arrays, chain = pair_arrays(np.random.default_rng(U * O), U, O, widths)
    ins = [torch.from_numpy(a).to(cuda) for a in arrays]
    layers = [nn.Linear(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda))
              for w, b in chain]
    before = pm.LAUNCHES
    with torch.inference_mode():
        got = pm.pair_mlp_fused(*ins, layers, DTYPES[dtype])
        want = pm.pair_mlp_reference(*ins, layers, DTYPES[dtype])
    torch.cuda.synchronize()
    assert pm.LAUNCHES == before + 1
    assert_matches(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("U,B,O,E,R", [(3, 6, 7, 24, 4), (2, 9, 20, 33, 11),
                                       (8, 80, 100, 300, 8)])
@pytest.mark.parametrize("dtype,out", [("float32", "float32"), ("bfloat16", "float32"),
                                       ("bfloat16", "bfloat16")])
def test_cuda_shared_contract_matches_plain(cuda, U, B, O, E, R, dtype, out):
    """Unsorted image indices, R above one 8-slot pass, pad slots."""
    h2, img, e_sel, b_sel, tok = (torch.from_numpy(a).to(cuda) for a in contract_inputs(
        np.random.default_rng(B), U, B, O, E, R, False))
    h2, e_sel = h2.to(DTYPES[dtype]), e_sel.to(DTYPES[dtype])
    before = sc.LAUNCHES
    with torch.inference_mode():
        got = sc.shared_contract_kernel(h2, img, e_sel, b_sel, tok, out_dtype=DTYPES[out])
        want = sc.shared_contract_reference(h2, img, e_sel, b_sel, tok, out_dtype=DTYPES[out])
    torch.cuda.synchronize()
    assert sc.LAUNCHES == before + 1
    assert_matches(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_cuda_rel_cache_shared_takes_the_kernels(cuda, ontology, stream):
    """On the card the shared route launches both kernels once, and at a
    float32 stream it agrees with the CPU's contract-then-gather tail."""
    cfg = Config(box_features_dim=32, oracle_input_dim=16, word_embedding_dim=12,
                 featurizer_layers_config=[], attribute_network_layers_config=[8],
                 relation_network_layers_config=[8], dropout=0.0)
    cfg.tpu.rel_stream_dtype = stream
    tp = om.init_oracle_params(cfg, ontology, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    attr_in = torch.from_numpy(rng.uniform(size=(3, 6, cfg.attr_input_dim)).astype(np.float32))
    pos = torch.from_numpy(rng.uniform(size=(3, 6, 4)).astype(np.float32))
    img = torch.tensor([0, 0, 0, 1, 1, 2, 2, 2], dtype=torch.int32)
    tok = torch.from_numpy(rng.choice(np.asarray(ontology._relation_index), (8, 4)) + 1
                           ).to(torch.int32)
    tok[0, 3] = 0
    gather = Interpreter(cfg, ontology)._rel_gather_map
    with torch.inference_mode():
        want = om.rel_cache_shared(tp, attr_in, pos, img, tok, cfg, rel_gather=gather)
        before = (pm.LAUNCHES, sc.LAUNCHES)
        got = om.rel_cache_shared(tp.to(cuda), attr_in.to(cuda), pos.to(cuda), img.to(cuda),
                                  tok.to(cuda), cfg, rel_gather=gather)
    torch.cuda.synchronize()
    assert (pm.LAUNCHES, sc.LAUNCHES) == (before[0] + 1, before[1] + 1)
    atol = 1e-4 if stream == "float32" else 2e-2  # bf16 h2 and e_sel: ~3 significant digits
    torch.testing.assert_close(got.cpu(), want, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,O,H,E,R", [(2, 7, 8, 12, 3), (3, 33, 16, 40, 11),
                                       (32, 24, 256, 300, 8)])
def test_cuda_relation_oracle_bwd_matches_plain(cuda, B, O, H, E, R):
    """All nine gradients of kernel 2, dgeom included, called directly and
    through ``PairTail``; pad slots whose cotangent is nonzero (the kernel
    must zero them itself)."""
    rng = np.random.default_rng(B * O)
    ins = [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.standard_normal((B, O, H)) * 0.5, rng.standard_normal((B, O, H)) * 0.5,
        rng.uniform(-1, 1, (B, O, O, 4)), rng.standard_normal((4, H)), rng.standard_normal(H),
        rng.standard_normal((H, E)) / np.sqrt(H), rng.standard_normal(E),
        rng.standard_normal((B, R, E)), rng.standard_normal((B, R)))]
    tok = rng.integers(1, 300, (B, R)).astype(np.int32)
    tok[0, R - 1] = 0
    tok = torch.from_numpy(tok).to(cuda)
    g = torch.from_numpy(rng.standard_normal((B, R, O, O)).astype(np.float32)).to(cuda)
    before = ro.BWD_LAUNCHES
    got = ro.pair_tail_bwd_kernel(*ins, tok, g, True)
    want = ro.pair_tail_bwd_reference(*ins, tok, g, True)
    # through PairTail with every input requiring a gradient
    leaves = [t.clone().requires_grad_() for t in ins]
    ro.PairTail.apply(*leaves, tok, -30.0).backward(g)
    torch.cuda.synchronize()
    assert ro.BWD_LAUNCHES == before + 2
    for a, t, b in zip(got, leaves, want):
        for x in (a, t.grad):
            assert torch.isfinite(x).all()
            torch.testing.assert_close(x, b, atol=1e-4 * b.abs().max().item(), rtol=0)
    assert ro.pair_tail_bwd_kernel(*ins, tok, g, False)[2] is None


@pytest.mark.cuda
def test_cuda_rel_cache_kernel_trains_through_both_kernels(cuda, ontology):
    """Autograd through ``rel_cache_kernel`` on the card launches the forward
    and the backward kernel once each and gives the CPU's gradients."""
    import copy

    cfg = Config(box_features_dim=32, oracle_input_dim=16, word_embedding_dim=12,
                 featurizer_layers_config=[], attribute_network_layers_config=[8],
                 relation_network_layers_config=[16], dropout=0.0)
    tp = om.init_oracle_params(cfg, ontology, torch.Generator().manual_seed(0))
    tc = copy.deepcopy(tp).to(cuda)
    rng = np.random.default_rng(3)
    attr_in = torch.from_numpy(rng.uniform(size=(4, 9, cfg.attr_input_dim)).astype(np.float32))
    pos = torch.from_numpy(rng.uniform(size=(4, 9, 4)).astype(np.float32))
    tok = torch.from_numpy(rng.integers(1, 2300, (4, 5)).astype(np.int32))
    tok[1, 2] = 0
    w = torch.from_numpy(rng.standard_normal((4, 5, 9, 9)).astype(np.float32))
    (ro.rel_cache_kernel_reference(tp, attr_in, pos, tok) * w).sum().backward()
    before = (ro.LAUNCHES, ro.BWD_LAUNCHES)
    (ro.rel_cache_kernel(tc, attr_in.to(cuda), pos.to(cuda), tok.to(cuda), cfg)
     * w.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    assert (ro.LAUNCHES, ro.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    for (name, a), (_, b) in zip(tp.named_parameters(), tc.named_parameters()):
        if a.grad is None:
            assert b.grad is None, name
        else:
            torch.testing.assert_close(b.grad.cpu(), a.grad, atol=1e-4, rtol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_cuda_rel_cache_shared_trains(cuda, ontology, stream):
    """Autograd through the shared route on the card (kernels 3 and 4
    forward, plain backwards) gives the CPU's gradients: within 1e-4 at a
    float32 stream, 2e-2 at bf16 (h2 and e_sel stored in ~3 digits)."""
    import copy

    cfg = Config(box_features_dim=32, oracle_input_dim=16, word_embedding_dim=12,
                 featurizer_layers_config=[], attribute_network_layers_config=[8],
                 relation_network_layers_config=[8], dropout=0.0)
    cfg.tpu.rel_stream_dtype = stream
    tp = om.init_oracle_params(cfg, ontology, torch.Generator().manual_seed(0))
    tc = copy.deepcopy(tp).to(cuda)
    rng = np.random.default_rng(2)
    attr_in = torch.from_numpy(rng.uniform(size=(3, 6, cfg.attr_input_dim)).astype(np.float32))
    pos = torch.from_numpy(rng.uniform(size=(3, 6, 4)).astype(np.float32))
    img = torch.tensor([0, 0, 0, 1, 1, 2, 2, 2], dtype=torch.int32)
    tok = torch.from_numpy(rng.choice(np.asarray(ontology._relation_index), (8, 4)) + 1
                           ).to(torch.int32)
    tok[0, 3] = 0
    w = torch.from_numpy(rng.standard_normal((8, 4, 6, 6)).astype(np.float32))
    (om.rel_cache_shared(tp, attr_in, pos, img, tok, cfg) * w).sum().backward()
    before = (pm.LAUNCHES, sc.LAUNCHES)
    (om.rel_cache_shared(tc, attr_in.to(cuda), pos.to(cuda), img.to(cuda), tok.to(cuda), cfg)
     * w.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    assert (pm.LAUNCHES, sc.LAUNCHES) == (before[0] + 1, before[1] + 1)
    atol = 1e-4 if stream == "float32" else 2e-2
    for (name, a), (_, b) in zip(tp.named_parameters(), tc.named_parameters()):
        if a.grad is not None:
            scale = max(1.0, a.grad.abs().max().item())
            torch.testing.assert_close(b.grad.cpu(), a.grad, atol=atol * scale, rtol=0, msg=name)
