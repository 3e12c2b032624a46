"""Relation-oracle pair tail: the hand-written Hopper kernels (forward and
backward) and their plain PyTorch versions.

Port of ``dfol_vqa_tpu/ops/pallas/relation_oracle.py`` (``rel_cache_pallas``
and its custom VJP: the per-question relation route that serving and
training take). The forward kernel is ``csrc/relation_oracle.cu``: it fuses,
per object pair,

    h1 = elu(h_s[i] + h_o[j] + geom[i,j] @ Wg + b0)
    h2 = sigmoid(h1 @ W2 + b2)
    out[r, i, j] = logsigmoid(h2 . e_sel[r] + b_sel[r])

and writes the R-major (B, R, O, O) cache with ``default_ll`` on pad slots,
so neither the (B, O, O, H) hidden nor the (B, O, O, E) pair code reaches
device memory. ``h_s``/``h_o`` stay ``torch.matmul``, as they are XLA dots
in the JAX version.

The backward kernel is ``csrc/relation_oracle_bwd.cu`` (the TPU's
``_bwd_kernel``): it recomputes each pair's activations on chip and emits
the nine gradients; ``pair_tail_bwd_reference`` is its plain version
(explicit formulas, no autograd). ``PairTail`` is the ``autograd.Function``
that joins the two: on CUDA tensors its forward launches the forward kernel
and its backward the backward kernel; on CPU tensors it runs the two plain
versions.

``rel_cache_kernel`` goes through ``PairTail`` on either device.
``rel_cache_kernel_reference`` is the forward's plain version from the
oracle's parameters.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch
from torch.nn import functional as F

from dfol_vqa_tpu.config import Config
from dfol_vqa_tpu_torch import nn
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.models.featurizer import pair_geometry
from dfol_vqa_tpu_torch.ops import cuda_build

# Launches of the forward and the backward CUDA kernel since the last reset
# (chip_smoke.py reads them to show that serving and training went through
# the kernels).
LAUNCHES = 0
BWD_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dfol_relation_oracle_fwd.argtypes = [p] * 11 + [i] * 5 + [ctypes.c_float, p]
    lib.dfol_relation_oracle_fwd.restype = i


def _configure_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dfol_relation_oracle_bwd.argtypes = [p] * 19 + [i] * 6 + [p]
    lib.dfol_relation_oracle_bwd.restype = i
    lib.dfol_relation_oracle_bwd_rows.argtypes = []
    lib.dfol_relation_oracle_bwd_rows.restype = i
    lib.dfol_relation_oracle_bwd_blocks_per_sm.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.dfol_relation_oracle_bwd_blocks_per_sm.restype = i


def build() -> cuda_build.Built:
    """Compile (once per source hash) and load the forward kernel's library."""
    return cuda_build.load("relation_oracle", ["relation_oracle.cu"], _configure)[1]


def build_bwd() -> cuda_build.Built:
    """Compile (once per source hash) and load the backward kernel's library."""
    return cuda_build.load("relation_oracle_bwd", ["relation_oracle_bwd.cu"], _configure_bwd)[1]


def pair_tail_inputs(params: om.OracleParams, attr_in: torch.Tensor, pos: torch.Tensor,
                     rel_tokens: torch.Tensor):
    """Inputs of the pair tail: (h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel)."""
    rp = params.relation_network
    w_s, w_o, w_g, b0 = om._first_layer_split(rp.layers[0], attr_in.shape[-1])
    h_s = torch.matmul(attr_in, w_s)
    h_o = torch.matmul(attr_in, w_o)
    e_sel, b_sel = om.select_relation_rows(params, rel_tokens)
    return (h_s, h_o, pair_geometry(pos), w_g, b0, rp.layers[1].w, rp.layers[1].b,
            e_sel, b_sel)


def _kernel_applies(params: om.OracleParams, cfg: Config, deterministic: bool) -> bool:
    """The kernel covers a 2-layer relation MLP with no active dropout
    (rel_cache_pallas's conditions); everything else is ``om.rel_cache``."""
    rp = params.relation_network
    return not (rp is None or len(rp.layers) != 2 or (not deterministic and cfg.dropout > 0))


def pair_tail_reference(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens,
                        default_ll: float = om.DEFAULT_LOG_LIKELIHOOD) -> torch.Tensor:
    """The kernel's math in plain PyTorch: (B, R, O, O), pad slots ->
    ``default_ll``. ELU is the kernel's exp(min(x,0))-1 form."""
    h1 = (h_s[:, :, None, :] + h_o[:, None, :, :]) + torch.einsum(
        "bijg,gh->bijh", geom, w_g) + b0
    h2 = torch.sigmoid(torch.matmul(nn.elu_exp(h1), w2) + b2)
    logits = torch.einsum("bije,bre->brij", h2, e_sel) + b_sel[:, :, None, None]
    out = F.logsigmoid(logits)
    return out.masked_fill((rel_tokens == 0)[:, :, None, None], default_ll)


def rel_cache_kernel_reference(
    params: om.OracleParams,
    attr_in: torch.Tensor,
    pos: torch.Tensor,
    rel_tokens: torch.Tensor,
    default_ll: float = om.DEFAULT_LOG_LIKELIHOOD,
) -> torch.Tensor:
    """``rel_cache_kernel``'s plain PyTorch version, on any device."""
    return pair_tail_reference(*pair_tail_inputs(params, attr_in, pos, rel_tokens), rel_tokens,
                               default_ll)


def pair_tail_bwd_reference(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens, g,
                            need_dgeom: bool = True):
    """The backward kernel's math in plain PyTorch, by explicit formulas (no
    autograd), as the TPU's ``_bwd_kernel`` computes it
    (``relation_oracle.py:83-132``): the cotangent ``g`` of
    ``pair_tail_reference``'s (B, R, O, O) output -> (dh_s, dh_o, dgeom, dWg,
    db0, dW2, db2, de_sel, db_sel), dgeom None unless ``need_dgeom``. The
    forward's pad slots hold a constant, so their dlogits are zero; the ELU
    derivative is exp(min(z, 0)) below 0."""
    z1 = (h_s[:, :, None, :] + h_o[:, None, :, :]) + torch.einsum(
        "bijg,gh->bijh", geom, w_g) + b0
    h1 = nn.elu_exp(z1)
    h2 = torch.sigmoid(torch.matmul(h1, w2) + b2)
    logits = torch.einsum("bije,bre->brij", h2, e_sel) + b_sel[:, :, None, None]
    live = (rel_tokens != 0).to(g.dtype)[:, :, None, None]
    dlogits = g * torch.sigmoid(-logits) * live                       # (B, R, O, O)
    dz2 = torch.einsum("brij,bre->bije", dlogits, e_sel) * h2 * (1.0 - h2)
    dz1 = torch.matmul(dz2, w2.t()) * torch.where(z1 > 0, 1.0, torch.exp(torch.clamp(z1, max=0.0)))
    dgeom = torch.matmul(dz1, w_g.t()) if need_dgeom else None
    return (dz1.sum(2), dz1.sum(1), dgeom, torch.einsum("bijg,bijh->gh", geom, dz1),
            dz1.sum((0, 1, 2)), torch.einsum("bijh,bije->he", h1, dz2), dz2.sum((0, 1, 2)),
            torch.einsum("brij,bije->bre", dlogits, h2), dlogits.sum((2, 3)))


def _check_args(what: str, h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens, g=None):
    """Raise unless the pair-tail tensors are float32, contiguous, of the
    pair tail's shapes and on one device (``rel_tokens`` int32)."""
    B, O, H = h_s.shape
    E = w2.shape[1]
    R = e_sel.shape[1]
    floats = {"h_s": (h_s, (B, O, H)), "h_o": (h_o, (B, O, H)), "geom": (geom, (B, O, O, 4)),
              "w_g": (w_g, (4, H)), "b0": (b0, (H,)), "w2": (w2, (H, E)), "b2": (b2, (E,)),
              "e_sel": (e_sel, (B, R, E)), "b_sel": (b_sel, (B, R))}
    if g is not None:
        floats["g"] = (g, (B, R, O, O))
    device = h_s.device
    for name, (t, shape) in floats.items():
        if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{what} kernel: {name} must be float32 {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel: {name} must be contiguous")
    if (rel_tokens.device != device or rel_tokens.dtype != torch.int32
            or tuple(rel_tokens.shape) != (B, R) or not rel_tokens.is_contiguous()):
        raise ValueError(f"{what} kernel: rel_tokens must be contiguous int32 (B, R) on {device}")


def pair_tail_kernel(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens,
                     default_ll: float = om.DEFAULT_LOG_LIKELIHOOD) -> torch.Tensor:
    """Launch the forward CUDA kernel on the current stream; inputs as
    ``pair_tail_reference``'s, all on one CUDA device, float32 and
    contiguous, ``rel_tokens`` int32."""
    _check_args("relation_oracle", h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens)
    B, O, H = h_s.shape
    E = w2.shape[1]
    R = e_sel.shape[1]
    device = h_s.device
    lib, _ = cuda_build.load("relation_oracle", ["relation_oracle.cu"], _configure)
    out = torch.empty((B, R, O, O), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dfol_relation_oracle_fwd(
            h_s.data_ptr(), h_o.data_ptr(), geom.data_ptr(), w_g.data_ptr(), b0.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), e_sel.data_ptr(), b_sel.data_ptr(),
            rel_tokens.data_ptr(), out.data_ptr(), B, O, H, E, R, default_ll, stream)
    cuda_build.check(lib, rc, "relation_oracle")
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


def pair_tail_bwd_kernel(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens, g,
                         need_dgeom: bool = True):
    """Launch the backward CUDA kernel on the current stream; arguments and
    result as ``pair_tail_bwd_reference``'s, with the forward kernel's
    argument rules and ``g`` float32 (B, R, O, O) contiguous.

    The kernel writes per-item and per-block partials (a block of the
    persistent grid owns a slice of each); they are summed here with
    ``torch.sum`` over their leading axis, as the JAX wrapper sums its dh_o
    partials."""
    _check_args("relation_oracle_bwd", h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel,
                rel_tokens, g)
    B, O, H = h_s.shape
    E = w2.shape[1]
    R = e_sel.shape[1]
    device = h_s.device
    lib, _ = cuda_build.load("relation_oracle_bwd", ["relation_oracle_bwd.cu"], _configure_bwd)
    n_i = -(-O // lib.dfol_relation_oracle_bwd_rows())  # work items (row bands) per question
    f32 = dict(dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        per_sm = ctypes.c_int(0)
        cuda_build.check(lib, lib.dfol_relation_oracle_bwd_blocks_per_sm(
            H, E, R, ctypes.byref(per_sm)), "relation_oracle_bwd occupancy")
        # a persistent grid: every block resident at once
        grid = min(B * n_i, max(1, per_sm.value) * torch.cuda.get_device_properties(
            device).multi_processor_count)
        w2t = w2.t().contiguous()
        dh_s = torch.empty((B, O, H), **f32)
        dho_part = torch.empty((B, n_i, O, H), **f32)
        dgeom = torch.empty((B, O, O, 4), **f32) if need_dgeom else None
        desel_part = torch.empty((B, n_i, R, E), **f32)
        dbsel_part = torch.empty((B, n_i, R), **f32)
        dw2_part = torch.zeros((grid, H, E), **f32)
        small_part = torch.empty((grid, 5 * H + E), **f32)
        rc = lib.dfol_relation_oracle_bwd(
            h_s.data_ptr(), h_o.data_ptr(), geom.data_ptr(), w_g.data_ptr(), b0.data_ptr(),
            w2.data_ptr(), w2t.data_ptr(), b2.data_ptr(), e_sel.data_ptr(), b_sel.data_ptr(),
            rel_tokens.data_ptr(), g.data_ptr(), dh_s.data_ptr(), dho_part.data_ptr(),
            None if dgeom is None else dgeom.data_ptr(), desel_part.data_ptr(),
            dbsel_part.data_ptr(), dw2_part.data_ptr(), small_part.data_ptr(),
            B, O, H, E, R, grid, torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check(lib, rc, "relation_oracle_bwd")
    global BWD_LAUNCHES
    with _COUNT_LOCK:
        BWD_LAUNCHES += 1
    small = small_part.sum(0)
    return (dh_s, dho_part.sum(1), dgeom, small[:4 * H].view(4, H), small[4 * H:5 * H],
            dw2_part.sum(0), small[5 * H:], desel_part.sum(1), dbsel_part.sum(1))


class PairTail(torch.autograd.Function):
    """The pair tail with its fused backward (the TPU's ``_pair_tail`` custom
    VJP): ``PairTail.apply(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel,
    rel_tokens, default_ll)`` -> (B, R, O, O). CUDA tensors run the two CUDA
    kernels; CPU tensors run ``pair_tail_reference`` and
    ``pair_tail_bwd_reference``. dgeom is computed only when ``geom``
    requires a gradient."""

    @staticmethod
    def forward(ctx, h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens, default_ll):
        ins = (h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel)
        ctx.save_for_backward(*ins, rel_tokens)
        if h_s.device.type == "cpu":
            return pair_tail_reference(*ins, rel_tokens, default_ll)
        return pair_tail_kernel(*ins, rel_tokens, default_ll)

    @staticmethod
    def backward(ctx, g):
        *ins, rel_tokens = ctx.saved_tensors
        need_dgeom = ctx.needs_input_grad[2]
        if g.device.type == "cpu":
            grads = pair_tail_bwd_reference(*ins, rel_tokens, g, need_dgeom)
        else:
            grads = pair_tail_bwd_kernel(*ins, rel_tokens, g.contiguous(), need_dgeom)
        return (*grads, None, None)


def rel_cache_kernel(
    params: om.OracleParams,
    attr_in: torch.Tensor,
    pos: torch.Tensor,
    rel_tokens: torch.Tensor,
    cfg: Config,
    deterministic: bool = True,
    default_ll: float = om.DEFAULT_LOG_LIKELIHOOD,
    *,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Drop-in for ``oracle.rel_cache`` on the per-question route, for
    serving and training.

    Goes through ``PairTail``: CUDA tensors launch the forward kernel, and
    under autograd the backward kernel (or raise); CPU tensors run their
    plain versions. Shapes the kernel does not cover and active dropout go to
    ``oracle.rel_cache`` on either device, as in the JAX wrapper
    (``generator`` feeds its dropout)."""
    if not _kernel_applies(params, cfg, deterministic):
        return om.rel_cache(params, attr_in, pos, rel_tokens, cfg, generator, deterministic,
                            default_ll)
    ins = [t.contiguous() for t in pair_tail_inputs(params, attr_in, pos, rel_tokens)]
    return PairTail.apply(*ins, rel_tokens.to(torch.int32).contiguous(), float(default_ll))
