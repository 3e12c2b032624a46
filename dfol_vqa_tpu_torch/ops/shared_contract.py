"""Shared-image relation contraction: the hand-written Hopper kernel and its
plain PyTorch version.

Port of ``dfol_vqa_tpu/ops/pallas/shared_contract.py``
(``shared_contract_pallas``). The shared route computes the pair code h2
once per unique image (``ops/pair_mlp.py``); each question then needs

    out[b, r, i, j] = logsigmoid(h2[img[b], i, j, :] . e_sel[b, r] + b_sel[b, r])

R-major ``(B, R, O, O)`` in the cache dtype, ``default_ll`` on pad slots
(``rel_tokens == 0``). The kernel is ``csrc/shared_contract.cu``: it fuses
the gather with the contraction, so the ``(B, O, O, E)`` gather that the
plain version materialises never reaches device memory, and it visits the
questions sorted by image so each image's h2 is read from L2 by all of its
questions. h2 and e_sel arrive in the stream dtype (float32 or bfloat16);
the sums are float32.

``shared_contract_kernel`` launches the kernel for CUDA tensors (through
the ``autograd.Function`` ``SharedContract``) and uses
``shared_contract_reference`` — the plain version, the kernel's test oracle
— only for tensors on the CPU. The backward is ``shared_contract_bwd``,
``_gc_bwd``'s math in plain PyTorch, as the JAX one is XLA.
"""

from __future__ import annotations

import ctypes
import threading

import torch
from torch.nn import functional as F

from dfol_vqa_tpu_torch.models.oracle import DEFAULT_LOG_LIKELIHOOD
from dfol_vqa_tpu_torch.ops import cuda_build

# Launches of the CUDA kernel since the last reset (chip_smoke.py reads it to
# show that offline evaluation went through the kernel).
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dfol_shared_contract_fwd.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float, i, i, p]
    lib.dfol_shared_contract_fwd.restype = i


def build() -> cuda_build.Built:
    """Compile (once per source hash) and load the kernel's library."""
    return cuda_build.load("shared_contract", ["shared_contract.cu"], _configure)[1]


def shared_contract_reference(h2_u: torch.Tensor, img_index: torch.Tensor, e_sel: torch.Tensor,
                              b_sel: torch.Tensor, rel_tokens: torch.Tensor,
                              default_ll: float = DEFAULT_LOG_LIKELIHOOD,
                              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gather, einsum, logsigmoid, pad fill: (U, O, O, E) + (B,) -> (B, R, O, O)
    in ``out_dtype``, float32 sums whatever dtype h2 and e_sel stream in."""
    h2_q = h2_u[img_index.long()].float()
    logits = torch.einsum("bije,bre->brij", h2_q, e_sel.float()) + b_sel[:, :, None, None]
    ll = F.logsigmoid(logits).masked_fill((rel_tokens == 0)[:, :, None, None], default_ll)
    return ll.to(out_dtype)


def shared_contract_launch(h2_u: torch.Tensor, img_index: torch.Tensor, order: torch.Tensor,
                           e_sel: torch.Tensor, b_sel: torch.Tensor, rel_tokens: torch.Tensor,
                           default_ll: float, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. h2_u (U, O, O, E) and
    e_sel (B, R, E) in one stream dtype, b_sel (B, R) float32, img_index,
    order (questions sorted by image) and rel_tokens int32; all contiguous
    on one CUDA device."""
    U, O, O2, E = h2_u.shape
    B, R, E2 = e_sel.shape
    device = h2_u.device
    if O2 != O or E2 != E or h2_u.dtype not in DTYPES or e_sel.dtype != h2_u.dtype:
        raise ValueError(f"shared_contract kernel: h2 (U, O, O, E) and e_sel (B, R, E) must "
                         f"share E and a float32/bfloat16 dtype, got {h2_u.dtype} "
                         f"{tuple(h2_u.shape)} and {e_sel.dtype} {tuple(e_sel.shape)}")
    if out_dtype not in DTYPES:
        raise ValueError(f"shared_contract kernel: out_dtype must be float32 or bfloat16, "
                         f"got {out_dtype}")
    expect = {"h2_u": (h2_u, h2_u.dtype, (U, O, O, E)), "e_sel": (e_sel, h2_u.dtype, (B, R, E)),
              "b_sel": (b_sel, torch.float32, (B, R)),
              "img_index": (img_index, torch.int32, (B,)), "order": (order, torch.int32, (B,)),
              "rel_tokens": (rel_tokens, torch.int32, (B, R))}
    for name, (t, dtype, shape) in expect.items():
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"shared_contract kernel: {name} must be {dtype} {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"shared_contract kernel: {name} must be contiguous")
    lib, _ = cuda_build.load("shared_contract", ["shared_contract.cu"], _configure)
    out = torch.empty((B, R, O, O), dtype=out_dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dfol_shared_contract_fwd(
            h2_u.data_ptr(), img_index.data_ptr(), order.data_ptr(), e_sel.data_ptr(),
            b_sel.data_ptr(), rel_tokens.data_ptr(), out.data_ptr(), U, B, O, E, R,
            default_ll, DTYPES[h2_u.dtype], DTYPES[out_dtype], stream)
    cuda_build.check(lib, rc, "shared_contract")
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


def shared_contract_bwd(h2_u: torch.Tensor, img_index: torch.Tensor, e_sel: torch.Tensor,
                        out: torch.Tensor, rel_tokens: torch.Tensor, g: torch.Tensor):
    """The contraction's backward (``_gc_bwd``): from the saved output in the
    cache dtype, dlogits = g * (1 - exp(out)) on live slots, since
    sigmoid(-logits) = 1 - exp(logsigmoid(logits)). dh2 and de_sel are
    summed image by image (mask the questions of image u, contract b and r
    jointly), so no (B, O, O, E) gather is formed; the algebra is float32 and
    the cotangents come back in the primals' dtypes -> (dh2, de_sel,
    db_sel)."""
    U = h2_u.shape[0]
    live = (rel_tokens != 0).to(torch.float32)[:, :, None, None]
    dlogits = g.float() * (1.0 - torch.exp(out.float())) * live  # (B, R, O, O)
    onehot = (img_index.long()[None, :]
              == torch.arange(U, device=img_index.device)[:, None]).to(torch.float32)
    e32 = e_sel.float()
    dh2 = torch.empty(h2_u.shape, dtype=torch.float32, device=h2_u.device)
    d_esel = torch.zeros(e_sel.shape, dtype=torch.float32, device=e_sel.device)
    for u in range(U):
        dl_u = dlogits * onehot[u][:, None, None, None]
        dh2[u] = torch.einsum("brij,bre->ije", dl_u, e32)
        d_esel += torch.einsum("brij,ije->bre", dl_u, h2_u[u].float())
    return dh2.to(h2_u.dtype), d_esel.to(e_sel.dtype), dlogits.sum((2, 3))


class SharedContract(torch.autograd.Function):
    """``SharedContract.apply(h2_u, img_index, order, e_sel, b_sel,
    rel_tokens, default_ll, out_dtype)``, arguments as
    ``shared_contract_launch``'s: the kernel forward and
    ``shared_contract_bwd``; no cotangent for the indices."""

    @staticmethod
    def forward(ctx, h2_u, img_index, order, e_sel, b_sel, rel_tokens, default_ll, out_dtype):
        out = shared_contract_launch(h2_u, img_index, order, e_sel, b_sel, rel_tokens,
                                     default_ll, out_dtype)
        ctx.save_for_backward(h2_u, img_index, e_sel, out, rel_tokens)
        return out

    @staticmethod
    def backward(ctx, g):
        dh2, d_esel, d_bsel = shared_contract_bwd(*ctx.saved_tensors, g)
        return dh2, None, None, d_esel, d_bsel, None, None, None


def shared_contract_kernel(h2_u: torch.Tensor, img_index: torch.Tensor, e_sel: torch.Tensor,
                           b_sel: torch.Tensor, rel_tokens: torch.Tensor,
                           default_ll: float = DEFAULT_LOG_LIKELIHOOD,
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Drop-in for the gather + einsum + logsigmoid + pad tail of
    ``rel_cache_shared``, arguments as ``shared_contract_reference``'s.
    CUDA tensors launch the kernel through ``SharedContract`` (or raise);
    CPU tensors take ``shared_contract_reference``. Image indices outside
    [0, U) are clamped by the kernel."""
    if h2_u.device.type == "cpu":
        return shared_contract_reference(h2_u, img_index, e_sel, b_sel, rel_tokens, default_ll,
                                         out_dtype)
    img = img_index.to(torch.int32).contiguous()
    order = torch.argsort(img, stable=True).to(torch.int32)
    return SharedContract.apply(h2_u.contiguous(), img, order, e_sel.contiguous(),
                                b_sel.float().contiguous(),
                                rel_tokens.to(torch.int32).contiguous(), float(default_ll),
                                out_dtype)
