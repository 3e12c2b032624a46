"""Shared pair code (the relation pair MLP): the hand-written Hopper kernel
and its plain PyTorch version.

Port of ``dfol_vqa_tpu/ops/pallas/pair_mlp.py`` (``pair_mlp_fused`` and its
XLA twin ``pair_mlp_xla``). On the shared-image relation route
(``oracle.rel_cache_shared``) the O^2 pair code depends only on the scene,
so it is computed once per unique image:

    h  = dist*Wg[0] + ang*Wg[1] + hside*Wg[2] + vside*Wg[3] + h_s[i] + h_o[j] + b0
    h2 = sigmoid(W_L(elu(... W_1(elu(h)))))          # (U, O, O, E)

stored in the stream dtype (``tpu.rel_stream_dtype``). The kernel is
``csrc/pair_mlp.cu``: it runs every Linear on the tensor cores in
split-precision TF32 ("3xTF32", as kernels 1 and 2 do), keeps hidden layers
of up to 256 units on chip and writes only h2. Unlike the TPU kernel it runs
at the true object count (no 128-lane padding) and with float32 dot
operands (the TPU kernel rounds them to bf16 on the MXU; JAX's CPU and
interpret paths do not). It takes chains of up to ``MAX_LAYERS`` Linear
layers after the split first layer, at any widths (``pad_chain`` zero-pads
them to the kernel's multiple; wider hidden layers go through a scratch).

``pair_mlp_fused`` launches the kernel for CUDA tensors (through the
``autograd.Function`` ``PairMLP``) and uses ``pair_mlp_reference`` — the
same math in plain PyTorch, the kernel's test oracle — only for tensors on
the CPU. The backward is plain PyTorch, as the JAX custom VJP's is XLA
(``_pm_bwd``): it recomputes through ``pair_mlp_reference`` in float32 and
differentiates that with the cotangent upcast to float32.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Sequence

import torch
from torch.nn import functional as F

from dfol_vqa_tpu_torch import nn
from dfol_vqa_tpu_torch.models.featurizer import pair_geometry
from dfol_vqa_tpu_torch.ops import cuda_build

# Launches of the CUDA kernel since the last reset (chip_smoke.py reads it to
# show that offline evaluation went through the kernel).
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

MAX_LAYERS = 8  # kMaxLayers in csrc/pair_mlp.cu
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.dfol_pair_mlp_fwd.argtypes = ([p] * 5 + [pp, pp, ctypes.POINTER(i), i, p, i, i, i, i, p,
                                                 i, p])
    lib.dfol_pair_mlp_fwd.restype = i
    lib.dfol_pair_mlp_tile_width.argtypes = []
    lib.dfol_pair_mlp_tile_width.restype = i


def build() -> cuda_build.Built:
    """Compile (once per source hash) and load the kernel's library."""
    return cuda_build.load("pair_mlp", ["pair_mlp.cu"], _configure)[1]


def pair_mlp_reference(pos: torch.Tensor, h_s: torch.Tensor, h_o: torch.Tensor,
                       w_g: torch.Tensor, b0: torch.Tensor, layers: Sequence[nn.Linear],
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(U, O, 4) boxes + (U, O, H) projections -> (U, O, O, E) in
    ``out_dtype``: ``pair_mlp_xla``'s formulation (four rank-1 geometry
    broadcasts, the exp(min(x,0))-1 ELU, float32 dots), on any device."""
    geom = pair_geometry(pos)
    h = (geom[..., 0, None] * w_g[0] + geom[..., 1, None] * w_g[1]
         + geom[..., 2, None] * w_g[2] + geom[..., 3, None] * w_g[3])
    h = h + h_s[:, :, None, :] + h_o[:, None, :, :] + b0
    for layer in layers:
        h = torch.matmul(nn.elu_exp(h), layer.w) + layer.b
    return torch.sigmoid(h).to(out_dtype)


def pair_mlp_launch(geom: torch.Tensor, h_s: torch.Tensor, h_o: torch.Tensor,
                    w_g: torch.Tensor, b0: torch.Tensor, layers: Sequence[nn.Linear],
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: geom (U, O, O, 4),
    h_s/h_o (U, O, H), every weight float32, contiguous and on one CUDA
    device -> (U, O, O, E) in ``out_dtype`` (float32 or bfloat16)."""
    U, O, H = h_s.shape
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"pair_mlp kernel: at most {MAX_LAYERS} Linear layers after the "
                         f"split first layer, got {len(layers)}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"pair_mlp kernel: out_dtype must be float32 or bfloat16, "
                         f"got {out_dtype}")
    widths = [H] + [int(layer.w.shape[1]) for layer in layers]
    floats = {"geom": (geom, (U, O, O, 4)), "h_s": (h_s, (U, O, H)), "h_o": (h_o, (U, O, H)),
              "w_g": (w_g, (4, H)), "b0": (b0, (H,))}
    for li, layer in enumerate(layers):
        floats[f"layers[{li}].w"] = (layer.w, (widths[li], widths[li + 1]))
        floats[f"layers[{li}].b"] = (layer.b, (widths[li + 1],))
    device = h_s.device
    for name, (t, shape) in floats.items():
        if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"pair_mlp kernel: {name} must be float32 {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"pair_mlp kernel: {name} must be contiguous")
    lib, built = cuda_build.load("pair_mlp", ["pair_mlp.cu"], _configure)
    (h_s, h_o, w_g, b0), layers = pad_chain(h_s, h_o, w_g, b0, layers, built.slices[2])
    padded = [h_s.shape[-1]] + [int(layer.w.shape[1]) for layer in layers]
    out = torch.empty((U, O, O, widths[-1]), dtype=out_dtype, device=device)
    n = len(layers)
    ws = (ctypes.c_void_p * max(n, 1))(*[layer.w.data_ptr() for layer in layers])
    bs = (ctypes.c_void_p * max(n, 1))(*[layer.b.data_ptr() for layer in layers])
    wd = (ctypes.c_int * (n + 1))(*padded)
    # hidden layers wider than the on-chip tile go through a per-band scratch
    wide = [w for w in padded[1:n] if w > lib.dfol_pair_mlp_tile_width()]
    s_ld = max(wide, default=0)
    scratch = (torch.empty(2 * -(-O * O // 64) * U * 64 * s_ld, dtype=torch.float32,
                           device=device) if wide else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dfol_pair_mlp_fwd(
            h_s.data_ptr(), h_o.data_ptr(), geom.data_ptr(), w_g.data_ptr(), b0.data_ptr(),
            ws, bs, wd, n, out.data_ptr(), widths[-1], OUT_DTYPES[out_dtype], U, O,
            None if scratch is None else scratch.data_ptr(), s_ld, stream)
    cuda_build.check(lib, rc, "pair_mlp")
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


class _Layer(NamedTuple):
    """A Linear layer's (w, b) as the kernel and the plain version read it."""

    w: torch.Tensor
    b: torch.Tensor


def pad_chain(h_s: torch.Tensor, h_o: torch.Tensor, w_g: torch.Tensor, b0: torch.Tensor,
              layers: Sequence, multiple: int):
    """The first layer's (h_s, h_o, w_g, b0) and the chain with every width
    zero-padded to a multiple of ``multiple`` (the tensors themselves where
    it is one): a padded unit's pre-activation is 0, so elu gives 0, and it
    meets zero rows of the next weight; the padded output columns are not
    stored. -> ((h_s, h_o, w_g, b0), [_Layer])."""
    def pad_to(n):
        return -n % multiple

    dh = pad_to(h_s.shape[-1])
    first = tuple(F.pad(t, (0, dh)) if dh else t for t in (h_s, h_o, w_g, b0))
    chain = []
    for layer in layers:
        dk, dn = pad_to(layer.w.shape[0]), pad_to(layer.w.shape[1])
        chain.append(_Layer(F.pad(layer.w, (0, dn, 0, dk)) if dk or dn else layer.w,
                            F.pad(layer.b, (0, dn)) if dn else layer.b))
    return first, chain


class PairMLP(torch.autograd.Function):
    """``PairMLP.apply(out_dtype, pos, h_s, h_o, w_g, b0, w_1, b_1, ...)``:
    the kernel forward; the backward recomputes ``pair_mlp_reference`` in
    float32 and differentiates it (the JAX ``_pm_bwd``)."""

    @staticmethod
    def forward(ctx, out_dtype, pos, h_s, h_o, w_g, b0, *wb):
        ctx.save_for_backward(pos, h_s, h_o, w_g, b0, *wb)
        layers = [_Layer(wb[k], wb[k + 1]) for k in range(0, len(wb), 2)]
        return pair_mlp_launch(pair_geometry(pos).contiguous(), h_s, h_o, w_g, b0, layers,
                               out_dtype)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            layers = [_Layer(xs[k], xs[k + 1]) for k in range(5, len(xs), 2)]
            out = pair_mlp_reference(*xs[:5], layers, torch.float32)
            wanted = [x for x in xs if x.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g.float()) if wanted else ())
        return (None, *[next(grads) if need else None for need in needs])


def pair_mlp_fused(pos: torch.Tensor, h_s: torch.Tensor, h_o: torch.Tensor,
                   w_g: torch.Tensor, b0: torch.Tensor, layers: Sequence[nn.Linear],
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Drop-in for the pair-MLP trunk of ``rel_cache_shared``, arguments as
    ``pair_mlp_reference``'s. CUDA tensors launch the kernel through
    ``PairMLP`` (or raise); CPU tensors take ``pair_mlp_reference``."""
    if h_s.device.type == "cpu":
        return pair_mlp_reference(pos, h_s, h_o, w_g, b0, layers, out_dtype)
    wb = [t.contiguous() for layer in layers for t in (layer.w, layer.b)]
    return PairMLP.apply(out_dtype, pos, h_s.contiguous(), h_o.contiguous(), w_g.contiguous(),
                         b0.contiguous(), *wb)
