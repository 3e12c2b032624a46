"""The benchmark's yardstick of work: the H100's published peaks, each
kernel's operations and bytes, and the model's FLOP for ``mfu``.

The kernels' functions are frozen copies of the arithmetic the port's
``chip_smoke.py`` uses (``kernel_bound``, ``pair_tail_work``, and the work of
kernels 3 and 4 in its phase 3), so that a later change to the program
cannot change the yardstick. Work is counted from a call's inputs, whatever
implements it: each input byte read once, each output byte written once.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16, 495 TFLOP/s
TF32, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s HBM3. A float32
product is charged at a third of the TF32 rate (3xTF32, three TF32
products per float32 one), 165 TFLOP/s: the rate at which the port's
float32-accurate kernels multiply, and the peak ``mfu`` divides by for a
``compute_dtype`` of float32.
"""

from __future__ import annotations

from typing import Dict, Sequence

H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 495e12
H100_F32_FLOPS = 67e12
F32_PRODUCT_FLOPS = H100_TF32_FLOPS / 3

PEAK_FLOPS = {"float32": F32_PRODUCT_FLOPS, "bfloat16": H100_BF16_FLOPS}
V_TOKENS = 2335  # the GQA vocabulary (the head's padded columns are never read)
CALIBRATOR_OPS = 17  # the calibrator's op one-hot


def kernel_bound(product_flop: float, other_flop: float, nbytes: float,
                 product_dtype: str = "float32") -> Dict[str, object]:
    """The least time the card could take for a kernel's work: the larger
    of its bytes over HBM's rate and its operations over the peak rate for
    their type (products at the 3xTF32 rate for float32 operands, the bf16
    rate for bfloat16 ones; other float32 operations on the CUDA cores)."""
    product_rate = H100_BF16_FLOPS if product_dtype == "bfloat16" else F32_PRODUCT_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = max(product_flop / product_rate, other_flop / H100_F32_FLOPS)
    return {"flop": product_flop + other_flop, "bytes": nbytes,
            "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def pair_tail_work(B: int, O: int, H: int, E: int, R: int, backward: bool = False) -> dict:
    """Kernel 1 (forward: z2 = h1 W2, 2HE FLOP per pair, and the logits,
    2RE) or kernel 2 (backward: three H x E products, 6HE per pair, and 6RE
    for the logits, dh2 and de_sel), float32 tensors."""
    pairs = B * O * O
    weights = 4 * H + H + H * E + E
    ins = 2 * B * O * H + B * O * O * 4 + weights + B * R * E + B * R + B * R
    out = B * R * O * O
    if backward:
        ins += B * R * O * O
        out = 2 * B * O * H + weights + B * R * E + B * R
    k = 3 if backward else 1
    return kernel_bound(k * 2 * H * E * pairs, k * 2 * R * E * pairs, 4 * (ins + out))


def pair_mlp_work(U: int, O: int, widths: Sequence[int], h2_bytes: int) -> dict:
    """Kernel 3: the relation MLP after its first layer over every pair of
    U images (``widths`` = [H, ..., E]: 2kn FLOP per pair and layer),
    float32 inputs, the pair code h2 written at ``h2_bytes`` per value."""
    H, E = widths[0], widths[-1]
    chain = list(zip(widths, widths[1:]))
    return kernel_bound(U * O * O * sum(2 * k * n for k, n in chain), 0,
                        4 * (U * O * 4 + 2 * U * O * H + 5 * H + sum(k * n + n for k, n in chain))
                        + h2_bytes * U * O * O * E)


def shared_contract_work(B: int, U: int, O: int, E: int, R: int, h2_dtype: str) -> dict:
    """Kernel 4: h2[img[b]] . e_sel[b, r], 2RE FLOP per (question, pair);
    h2 and e_sel in the stream's dtype, float32 log-likelihoods out."""
    esize = 2 if h2_dtype == "bfloat16" else 4
    return kernel_bound(B * O * O * 2 * R * E, 0,
                        esize * (U * O * O * E + B * R * E) + 4 * (B + 2 * U + 2 * B * R)
                        + 4 * B * R * O * O, h2_dtype)


# ------------------------------------------------------------- model FLOP


def _mlp_flop(rows: float, widths: Sequence[int]) -> float:
    return rows * sum(2 * a * b for a, b in zip(widths, widths[1:]))


def image_flop(cfg, n_objects: int) -> float:
    """What one image needs, whatever number of questions ask about it: the
    featurizer, the attribute head over the whole vocabulary, and the
    relation network's pair code h2 over every ordered pair of real
    objects (its first layer split into per-object products, as the model
    defines it)."""
    n = n_objects
    feat_in = cfg.box_features_dim
    att_in = cfg.attr_input_dim
    flop = 0.0
    if cfg.featurizer_layers_config is not None:
        flop += _mlp_flop(n, [feat_in] + list(cfg.featurizer_layers_config)
                          + [cfg.oracle_input_dim])
    att = cfg.attribute_network_layers_config or []
    flop += _mlp_flop(n, [att_in] + list(att) + [cfg.word_embedding_dim])
    flop += 2.0 * n * cfg.word_embedding_dim * V_TOKENS
    rel = cfg.relation_network_layers_config or []
    H, E = rel[0], cfg.word_embedding_dim
    flop += 2 * 2.0 * n * att_in * H          # subject and object parts of layer 0
    flop += n * n * 2.0 * 4 * H               # the pair geometry part of layer 0
    flop += _mlp_flop(n * n, list(rel) + [E])
    return flop


def question_flop(cfg, n_objects: int, rel_slots: int, calibrator_steps: int) -> float:
    """What one question needs beyond its image: the contraction of h2
    with each relation token it uses (2E per pair and slot), and the
    calibrator's LSTM steps (8 S (in + S) each) where it runs."""
    E = cfg.word_embedding_dim
    flop = rel_slots * n_objects * n_objects * 2.0 * E
    if cfg.activate_attention_transfer and calibrator_steps:
        S = cfg.attention_transfer_state_dim
        x = E + 1 + CALIBRATOR_OPS
        flop += calibrator_steps * 8.0 * S * (x + S)
    return flop
