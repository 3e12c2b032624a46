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
in the JAX version. Both kernels run their H x E products on the tensor
cores in split-precision TF32 ("3xTF32", ``tf32_split``), which keeps
float32-level error.

The backward kernel is ``csrc/relation_oracle_bwd.cu`` (the TPU's
``_bwd_kernel``): it recomputes each pair's activations on chip and emits
the nine gradients; ``pair_tail_bwd_reference`` is its plain version
(explicit formulas, no autograd). ``PairTail`` is the ``autograd.Function``
that joins the two: on CUDA tensors its forward launches the forward kernel
and its backward the backward kernel; on CPU tensors it runs the two plain
versions.

The forward is a registered operator, ``relation_oracle_fwd``
(``torch.ops.dfol_vqa_tpu_torch.relation_oracle_fwd``): its CUDA
implementation launches the forward kernel, its CPU implementation is the
plain version, and its fake implementation gives the (B, R, O, O) float32
result's shape, so ``torch.export`` records the kernel as one node of a
serving step (``export.py``) and a loaded step launches it again. The
ctypes launch needs real pointers; the operator keeps it out of export's
tracing.

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

from dfol_vqa_tpu_torch.config import Config
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
    lib.dfol_relation_oracle_bwd.argtypes = [p] * 20 + [i] * 9 + [p]
    lib.dfol_relation_oracle_bwd.restype = i
    lib.dfol_relation_oracle_bwd_tile.argtypes = []
    lib.dfol_relation_oracle_bwd_tile.restype = i
    lib.dfol_relation_oracle_bwd_pad.argtypes = []
    lib.dfol_relation_oracle_bwd_pad.restype = i
    lib.dfol_relation_oracle_bwd_blocks_per_sm.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.dfol_relation_oracle_bwd_blocks_per_sm.restype = i
    lib.dfol_relation_oracle_bwd_wide.argtypes = [i, i]
    lib.dfol_relation_oracle_bwd_wide.restype = i


def build() -> cuda_build.Built:
    """Compile (once per source hash) and load the forward kernel's library."""
    return cuda_build.load("relation_oracle", ["relation_oracle.cu"], _configure)[1]


def build_bwd() -> cuda_build.Built:
    """Compile (once per source hash) and load the backward kernel's library."""
    return cuda_build.load("relation_oracle_bwd", ["relation_oracle_bwd.cu"], _configure_bwd)[1]


def pair_tail_inputs(params: om.OracleParams, attr_in: torch.Tensor, pos: torch.Tensor,
                     rel_tokens: torch.Tensor, cfg: Optional[Config] = None):
    """Inputs of the pair tail: (h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel).
    With ``cfg`` the h_s / h_o products take their operands at its compute
    dtype (``rel_cache_pallas``'s bf16 products, ``relation_oracle.py:265-268``
    in JAX); the kernel's own inputs stay float32."""
    rp = params.relation_network
    w_s, w_o, w_g, b0 = om._first_layer_split(rp.layers[0], attr_in.shape[-1])
    c = (lambda x: om.cast(x, cfg)) if cfg is not None else (lambda x: x)
    h_s = torch.matmul(c(attr_in), c(w_s))
    h_o = torch.matmul(c(attr_in), c(w_o))
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


def tf32_split(x: torch.Tensor):
    """The kernels' split of a float32 operand into the two TF32 values their
    tensor cores multiply: ``big`` is x rounded to TF32 (a 10-bit mantissa,
    to nearest, ties away from zero, as ``cvt.rna.tf32.f32`` rounds), and
    ``small`` the remainder ``x - big`` (exact in float32) as the tensor core
    reads it, its 13 low bits dropped. The kernels' products are ``a_big
    b_small + a_small b_big + a_big b_big`` with float32 sums ("3xTF32")."""
    bits = x.contiguous().view(torch.int32)
    big = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    small = ((x - big).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return big, small


def pad_widths(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, multiple: int):
    """The pair tail's inputs with H and E zero-padded to multiples of
    ``multiple`` (the inputs themselves when they are). A padded hidden unit
    has z1 = 0, so h1 = elu(0) = 0, and meets zero rows of W2; a padded code
    column has h2 = sigmoid(0) but meets zero columns of e_sel. So the log-
    likelihoods are unchanged, and ``unpad_grads`` cuts the gradients back to
    the true widths (the padded ones are zero, or unused)."""
    H, E = w2.shape
    dh, de = -H % multiple, -E % multiple
    if not (dh or de):
        return h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel
    return (F.pad(h_s, (0, dh)), F.pad(h_o, (0, dh)), geom, F.pad(w_g, (0, dh)),
            F.pad(b0, (0, dh)), F.pad(w2, (0, de, 0, dh)), F.pad(b2, (0, de)),
            F.pad(e_sel, (0, de)), b_sel)


def unpad_grads(grads, H: int, E: int):
    """The nine gradients of the pair tail at padded widths, cut to H and E."""
    dh_s, dh_o, dgeom, dwg, db0, dw2, db2, de_sel, db_sel = grads
    return (dh_s[..., :H], dh_o[..., :H], dgeom, dwg[:, :H], db0[:H], dw2[:H, :E], db2[:E],
            de_sel[..., :E], db_sel)


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
    contiguous, ``rel_tokens`` int32. Any H and E: widths that are not
    multiples of the library's are zero-padded (``pad_widths``)."""
    _check_args("relation_oracle", h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens)
    lib, built = cuda_build.load("relation_oracle", ["relation_oracle.cu"], _configure)
    h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel = pad_widths(
        h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, built.slices[2])
    B, O, H = h_s.shape
    E = w2.shape[1]
    R = e_sel.shape[1]
    device = h_s.device
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


def bwd_schedule(B: int, n_t: int, resident: int):
    """The backward kernel's persistent grid for B questions of n_t x n_t
    steps and ``resident`` blocks on the card at once: (per, grid,
    band_slots, question_slots). Block k takes the steps [k per, (k + 1)
    per), in the order (question, row band, column band); a row band's n_t
    consecutive steps and a question's n_t^2 meet at most ``band_slots`` and
    ``question_slots`` blocks, each of which adds into a slot of its own."""
    steps = B * n_t * n_t
    per = -(-steps // min(steps, resident))

    def slots(n):
        return 1 + -(-(n - 1) // per)

    return per, -(-steps // per), slots(n_t), slots(n_t * n_t)


def pair_tail_bwd_kernel(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens, g,
                         need_dgeom: bool = True):
    """Launch the backward CUDA kernel on the current stream; arguments and
    result as ``pair_tail_bwd_reference``'s, with the forward kernel's
    argument rules (any H and E) and ``g`` float32 (B, R, O, O) contiguous.

    The persistent grid's blocks take runs of ``per`` consecutive steps
    (kT x kT pairs each). The kernel writes partials per slot (the blocks
    whose runs meet one question, or one row band), per row band and per
    block; they are summed here with ``torch.sum`` over that axis, as the
    JAX wrapper sums its dh_o partials. Past one slice of H or E the
    kernel's sliced instance also adds dWg, db0 and db2 into the zeroed
    per-block rows, and past one slice of E it spills h2 and dz2 to a
    per-block scratch."""
    _check_args("relation_oracle_bwd", h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel,
                rel_tokens, g)
    true_h, true_e = w2.shape
    lib, built = cuda_build.load("relation_oracle_bwd", ["relation_oracle_bwd.cu"], _configure_bwd)
    _, slice_e, multiple = built.slices
    h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel = pad_widths(
        h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, multiple)
    B, O, H = h_s.shape
    E = w2.shape[1]
    R = e_sel.shape[1]
    device = h_s.device
    wide = bool(lib.dfol_relation_oracle_bwd_wide(H, E))
    n_t = -(-O // lib.dfol_relation_oracle_bwd_tile())  # row (and column) bands per question
    pad = lib.dfol_relation_oracle_bwd_pad()
    hp, ep = -(-H // pad) * pad, -(-E // pad) * pad  # dW2's padded widths, in 32 x 32 chunks
    f32 = dict(dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        per_sm = ctypes.c_int(0)
        cuda_build.check(lib, lib.dfol_relation_oracle_bwd_blocks_per_sm(
            H, E, R, ctypes.byref(per_sm)), "relation_oracle_bwd occupancy")
        per, grid, band_slots, question_slots = bwd_schedule(
            B, n_t, max(1, per_sm.value) * torch.cuda.get_device_properties(
                device).multi_processor_count)
        w2t = w2.t().contiguous()
        dhs_part = torch.zeros((B, band_slots, O, H), **f32)
        dho_part = torch.empty((B, n_t, O, H), **f32)
        dgeom = torch.empty((B, O, O, 4), **f32) if need_dgeom else None
        desel_part = torch.zeros((B, question_slots, R, E), **f32)
        dbsel_part = torch.zeros((B, question_slots, R), **f32)
        dw2_part = torch.zeros((grid, hp // 32, ep // 32, 32, 32), **f32)
        small_part = (torch.zeros if wide else torch.empty)((grid, 5 * H + E), **f32)
        # the sliced instance's h2 / dz2 spill: 64 pairs x ep per block
        scratch = torch.empty((grid, 64, ep), **f32) if E > slice_e else None
        rc = lib.dfol_relation_oracle_bwd(
            h_s.data_ptr(), h_o.data_ptr(), geom.data_ptr(), w_g.data_ptr(), b0.data_ptr(),
            w2.data_ptr(), w2t.data_ptr(), b2.data_ptr(), e_sel.data_ptr(), b_sel.data_ptr(),
            rel_tokens.data_ptr(), g.data_ptr(), dhs_part.data_ptr(), dho_part.data_ptr(),
            None if dgeom is None else dgeom.data_ptr(), desel_part.data_ptr(),
            dbsel_part.data_ptr(), dw2_part.data_ptr(), small_part.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, O, H, E, R, grid, per, band_slots, question_slots,
            torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check(lib, rc, "relation_oracle_bwd")
    global BWD_LAUNCHES
    with _COUNT_LOCK:
        BWD_LAUNCHES += 1
    small = small_part.sum(0)
    return unpad_grads(
        (dhs_part.sum(1), dho_part.sum(1), dgeom, small[:4 * H].view(4, H), small[4 * H:5 * H],
         dw2_part.sum(0).permute(0, 2, 1, 3).reshape(hp, ep)[:H, :E], small[5 * H:],
         desel_part.sum(1), dbsel_part.sum(1)), true_h, true_e)


OP_NAME = "dfol_vqa_tpu_torch::relation_oracle_fwd"


@torch.library.custom_op(OP_NAME, mutates_args=(), device_types="cuda")
def relation_oracle_fwd(h_s: torch.Tensor, h_o: torch.Tensor, geom: torch.Tensor,
                        w_g: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor, e_sel: torch.Tensor, b_sel: torch.Tensor,
                        rel_tokens: torch.Tensor, default_ll: float) -> torch.Tensor:
    """Kernel 1 as an operator: ``pair_tail_kernel`` on CUDA tensors (it
    builds the library at its first call and counts ``LAUNCHES``),
    ``pair_tail_reference`` on CPU tensors, and no other device."""
    return pair_tail_kernel(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens,
                            default_ll)


@relation_oracle_fwd.register_kernel("cpu")
def _relation_oracle_fwd_cpu(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens,
                             default_ll):
    return pair_tail_reference(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens,
                               default_ll)


@relation_oracle_fwd.register_fake
def _relation_oracle_fwd_fake(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens,
                              default_ll):
    B, O, _ = h_s.shape
    return h_s.new_empty((B, e_sel.shape[1], O, O), dtype=torch.float32)


class PairTail(torch.autograd.Function):
    """The pair tail with its fused backward (the TPU's ``_pair_tail`` custom
    VJP): ``PairTail.apply(h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel,
    rel_tokens, default_ll)`` -> (B, R, O, O). The forward is the operator
    ``relation_oracle_fwd``; the backward runs the backward kernel on CUDA
    tensors and ``pair_tail_bwd_reference`` on CPU ones. dgeom is computed
    only when ``geom`` requires a gradient."""

    @staticmethod
    def forward(ctx, h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel, rel_tokens, default_ll):
        ins = (h_s, h_o, geom, w_g, b0, w2, b2, e_sel, b_sel)
        ctx.save_for_backward(*ins, rel_tokens)
        return relation_oracle_fwd(*ins, rel_tokens, default_ll)

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
    plain versions. A relation MLP of other than two layers and active
    dropout go to ``oracle.rel_cache`` on either device, as in the JAX
    wrapper (``generator`` feeds its dropout). The kernels take any relation
    hidden width and pair-code width. At ``tpu.compute_dtype="bfloat16"``
    the h_s / h_o products take bf16 operands and the kernels run on their
    float32 results, as in JAX (kernel 2 is the backward of that)."""
    if not _kernel_applies(params, cfg, deterministic):
        return om.rel_cache(params, attr_in, pos, rel_tokens, cfg, generator, deterministic,
                            default_ll)
    ins = [t.contiguous() for t in pair_tail_inputs(params, attr_in, pos, rel_tokens, cfg)]
    return PairTail.apply(*ins, rel_tokens.to(torch.int32).contiguous(), float(default_ll))
