"""Relation-oracle pair tail: the hand-written Hopper kernel and its plain
PyTorch version.

Port of the forward of ``dfol_vqa_tpu/ops/pallas/relation_oracle.py``
(``rel_cache_pallas``, the per-question relation route that serving takes).
The kernel is ``csrc/relation_oracle.cu``: it fuses, per object pair,

    h1 = elu(h_s[i] + h_o[j] + geom[i,j] @ Wg + b0)
    h2 = sigmoid(h1 @ W2 + b2)
    out[r, i, j] = logsigmoid(h2 . e_sel[r] + b_sel[r])

and writes the R-major (B, R, O, O) cache with ``default_ll`` on pad slots,
so neither the (B, O, O, H) hidden nor the (B, O, O, E) pair code reaches
device memory. ``h_s``/``h_o`` stay ``torch.matmul``, as they are XLA dots
in the JAX version.

``rel_cache_kernel`` launches the kernel for CUDA tensors and uses
``rel_cache_kernel_reference`` — the same math in plain PyTorch, the
kernel's test oracle — only for tensors on the CPU. The backward (the
training slice's ``autograd.Function``) is not ported yet.
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

# Launches of the CUDA kernel since the last reset (chip_smoke.py reads it to
# show that the serving path went through the kernel).
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dfol_relation_oracle_fwd.argtypes = [p] * 11 + [i] * 5 + [ctypes.c_float, p]
    lib.dfol_relation_oracle_fwd.restype = i


def build() -> cuda_build.Built:
    """Compile (once per source hash) and load the kernel's library."""
    return cuda_build.load("relation_oracle", ["relation_oracle.cu"], _configure)[1]


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


def pair_tail_kernel(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens,
                     default_ll: float = om.DEFAULT_LOG_LIKELIHOOD) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; inputs as
    ``pair_tail_reference``'s, all on one CUDA device, float32 and
    contiguous, ``rel_tokens`` int32."""
    B, O, H = h_s.shape
    E = w2.shape[1]
    R = e_sel.shape[1]
    floats = {"h_s": (h_s, (B, O, H)), "h_o": (h_o, (B, O, H)), "geom": (geom, (B, O, O, 4)),
              "w_g": (w_g, (4, H)), "b0": (b0, (H,)), "w2": (w2, (H, E)), "b2": (b2, (E,)),
              "e_sel": (e_sel, (B, R, E)), "b_sel": (b_sel, (B, R))}
    device = h_s.device
    for name, (t, shape) in floats.items():
        if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"relation_oracle kernel: {name} must be float32 {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"relation_oracle kernel: {name} must be contiguous")
    if (rel_tokens.device != device or rel_tokens.dtype != torch.int32
            or tuple(rel_tokens.shape) != (B, R) or not rel_tokens.is_contiguous()):
        raise ValueError("relation_oracle kernel: rel_tokens must be contiguous int32 (B, R) "
                         f"on {device}")
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
    """Drop-in for ``oracle.rel_cache`` on the serving (eval) path.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    ``rel_cache_kernel_reference``. Shapes the kernel does not cover go to
    ``oracle.rel_cache`` on either device, as in the JAX wrapper
    (``generator`` feeds its dropout)."""
    if not _kernel_applies(params, cfg, deterministic):
        return om.rel_cache(params, attr_in, pos, rel_tokens, cfg, generator, deterministic,
                            default_ll)
    if attr_in.device.type == "cpu":
        return rel_cache_kernel_reference(params, attr_in, pos, rel_tokens, default_ll)
    ins = pair_tail_inputs(params, attr_in, pos, rel_tokens)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise NotImplementedError(
            "the relation-oracle kernel has no backward yet (ROADMAP queue: training "
            "slice); run it under torch.inference_mode() or torch.no_grad()")
    ins = [t.contiguous() for t in ins]
    return pair_tail_kernel(*ins, rel_tokens.to(torch.int32).contiguous(), float(default_ll))
