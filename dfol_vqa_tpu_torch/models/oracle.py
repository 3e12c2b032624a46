"""Visual oracle: learned attribute/relation log-likelihood scorer.

Port of ``dfol_vqa_tpu/models/oracle.py`` for ``oracle_output_dim == 1``:
the parameter tree (``OracleParams``), ``attr_cache`` (vocab-major
``(B, V+1, O)``), ``_first_layer_split``, the plain per-question
``rel_cache`` and the shared-image ``rel_cache_shared`` (both R-major
``(B, R, O, O)``). The first relation layer is split into
subject/object/geometry parts, so the O^2 term is a broadcast add of two
(B, O, H) products and a 4-wide geometry contraction.

Still to port (ROADMAP queues): ``rel_scores_for_pairs``,
``full_caches``, ``static_attr_cache`` and ``oracle_output_dim > 1``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn as tnn
from torch.nn import functional as F

from dfol_vqa_tpu.config import Config
from dfol_vqa_tpu_torch import nn
from dfol_vqa_tpu_torch.models.featurizer import pair_geometry

DEFAULT_LOG_LIKELIHOOD = -30.0  # reference default_log_likelihood everywhere


class Embedding(tnn.Module):
    """Concept head: ``w (E, V_pad)``, ``b (V_pad,)``; token code v scores
    column v-1."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = tnn.Parameter(w)
        self.b = tnn.Parameter(b)


class OracleParams(tnn.Module):
    """The oracle's parameters; ``featurizer`` is None for the identity
    network (``featurizer_layers_config=None``)."""

    def __init__(self, featurizer: Optional[nn.MLP], attribute_network: nn.MLP,
                 relation_network: nn.MLP, embedding: Embedding):
        super().__init__()
        self.featurizer = featurizer
        self.attribute_network = attribute_network
        self.relation_network = relation_network
        self.embedding = embedding


def check_supported(cfg: Config) -> None:
    """Raise for configurations this slice of the port does not run."""
    if cfg.oracle_output_dim != 1:
        raise NotImplementedError(
            "oracle_output_dim > 1 (trainable interpreter) is not ported yet "
            "(ROADMAP queue 4: the calibrator and the trainable interpreter)")
    if cfg.tpu.compute_dtype != "float32":
        raise NotImplementedError(
            f"tpu.compute_dtype={cfg.tpu.compute_dtype!r}: the port computes in float32")


def init_oracle_params(cfg: Config, ontology, generator: torch.Generator,
                       device="cpu") -> OracleParams:
    """Random oracle parameters: torch-default Linear init, and the
    embedding head's first word-dim columns seeded with each token's GloVe
    vector. The vocabulary is padded to ``tpu.vocab_pad_multiple`` (2335 ->
    2432) and padded rows are zeroed, so any use of them is conspicuous.
    Drawn from a CPU ``generator`` (the same weights for every device), then
    moved to ``device``."""
    check_supported(cfg)
    featurizer = nn.MLP.init(cfg.box_features_dim, cfg.featurizer_layers_config,
                             cfg.oracle_input_dim, generator)
    attribute = nn.MLP.init(cfg.attr_input_dim, cfg.attribute_network_layers_config,
                            cfg.word_embedding_dim, generator)
    relation = nn.MLP.init(cfg.rel_input_dim, cfg.relation_network_layers_config,
                           cfg.embedding_input_dim, generator)

    concept_num = ontology.num_tokens
    pad_mult = max(1, cfg.tpu.vocab_pad_multiple)
    concept_pad = -(-concept_num // pad_mult) * pad_mult
    emb_in = cfg.embedding_input_dim
    w = torch.randn((concept_pad, emb_in), generator=generator)
    glove = torch.from_numpy(ontology.embedding_matrix()[1:, :])  # (V, word_dim)
    d = min(cfg.word_embedding_dim, glove.shape[1], emb_in)
    w[:concept_num, :d] = glove[:, :d]
    w[concept_num:, :] = 0.0
    embedding = Embedding(w.t().contiguous(), torch.zeros((concept_pad,)))
    return OracleParams(featurizer, attribute, relation, embedding).to(device)


def attr_cache(
    params: OracleParams,
    attr_in: torch.Tensor,
    cfg: Config,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    default_ll: float = DEFAULT_LOG_LIKELIHOOD,
) -> torch.Tensor:
    """attr_in (B, O, D+4) -> (B, V+1, O) log-likelihoods, vocab-major.

    Row v (1-based token code) = logsigmoid(<emb_w[:, v-1], h> + b[v-1]);
    row 0 holds ``default_ll`` so code-0 gathers return the default."""
    h = nn.mlp_apply(params.attribute_network, attr_in, final="sigmoid",
                     dropout_rate=cfg.dropout, generator=generator,
                     deterministic=deterministic)
    logits = torch.matmul(h, params.embedding.w) + params.embedding.b
    ll = F.logsigmoid(logits).movedim(-1, 1)  # (B, V, O)
    B, _, O = ll.shape
    pad = torch.full((B, 1, O), default_ll, dtype=ll.dtype, device=ll.device)
    return torch.cat([pad, ll], dim=1)


def _first_layer_split(p0: nn.Linear, d_att: int):
    """Split the first relation-MLP linear into subject/object/geometry parts."""
    w = p0.w  # (2*d_att + 4, H)
    return w[:d_att], w[d_att: 2 * d_att], w[2 * d_att:], p0.b


def select_relation_rows(params: OracleParams, rel_tokens: torch.Tensor):
    """(B, R) unsigned token codes -> (e_sel (B, R, E), b_sel (B, R)); pad
    slots (code 0) read column 0 and are overwritten downstream."""
    tok0 = torch.clamp(rel_tokens.long() - 1, min=0)
    return params.embedding.w.t()[tok0], params.embedding.b[tok0]


def rel_cache(
    params: OracleParams,
    attr_in: torch.Tensor,
    pos: torch.Tensor,
    rel_tokens: torch.Tensor,
    cfg: Config,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    default_ll: float = DEFAULT_LOG_LIKELIHOOD,
) -> torch.Tensor:
    """Score each (subject, object) pair against a per-question token table.

    attr_in (B, O, D+4), pos (B, O, 4), rel_tokens (B, R) unsigned codes
    (0 = pad) -> (B, R, O, O) log-likelihoods; pad slots get ``default_ll``.
    Materialises the (B, O, O, H) hidden and (B, O, O, E) pair code; the
    JAX option ``tpu.rel_block_size`` only chunks that work and does not
    change the values, so the port computes it in one pass."""
    rp = params.relation_network
    if rp is None:
        raise NotImplementedError(
            "relation_network_layers_config=None (identity relation network) "
            "is not supported by the fused relation path")
    B, O, d_att = attr_in.shape
    geom = pair_geometry(pos)
    e_sel, b_sel = select_relation_rows(params, rel_tokens)

    w_s, w_o, w_g, b0 = _first_layer_split(rp.layers[0], d_att)
    x = nn.dropout(attr_in, cfg.dropout, generator, deterministic)
    x_obj = nn.dropout(attr_in, cfg.dropout, generator, deterministic)
    h_s = torch.matmul(x, w_s)
    h_o = torch.matmul(x_obj, w_o)
    h = (h_s[:, :, None, :] + h_o[:, None, :, :]
         + torch.einsum("bijg,gh->bijh", geom, w_g) + b0)
    for layer in rp.layers[1:]:
        h = nn.elu(h)
        h = nn.dropout(h, cfg.dropout, generator, deterministic)
        h = torch.matmul(h, layer.w) + layer.b
    h = torch.sigmoid(h)
    logits = torch.einsum("bije,bre->brij", h, e_sel) + b_sel[:, :, None, None]
    ll = F.logsigmoid(logits)
    return ll.masked_fill((rel_tokens == 0)[:, :, None, None], default_ll)


REL_ROUTES = ("auto", "pallas", "xla")


def shared_kernel_route(cfg: Config, device: torch.device, deterministic: bool) -> bool:
    """Whether ``rel_cache_shared`` takes the CUDA kernels: ``tpu.use_pallas``,
    a CUDA device, ``tpu.rel_route`` other than "xla", no active dropout
    (the port computes in float32 only, ``check_supported``). The JAX
    package's TPU gates (O >= 64, the measured ``resolve_rel_route`` table,
    128-lane O padding) are not carried over: "auto" and "pallas" take the
    kernels at any O and batch on the card."""
    if cfg.tpu.rel_route not in REL_ROUTES:
        raise ValueError(f"tpu.rel_route must be one of {REL_ROUTES}, got {cfg.tpu.rel_route!r}")
    return (cfg.tpu.use_pallas and device.type == "cuda" and cfg.tpu.rel_route != "xla"
            and cfg.oracle_output_dim == 1 and (deterministic or cfg.dropout == 0.0))


def rel_cache_shared(
    params: OracleParams,
    attr_in_u: torch.Tensor,
    pos_u: torch.Tensor,
    img_index: torch.Tensor,
    rel_tokens: torch.Tensor,
    cfg: Config,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    default_ll: float = DEFAULT_LOG_LIKELIHOOD,
    rel_gather: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> torch.Tensor:
    """Relation cache with the pair MLP computed once per UNIQUE image.

    attr_in_u (U, O, D+4), pos_u (U, O, 4), img_index (B,) question ->
    image row, rel_tokens (B, R) -> (B, R, O, O). Three tails, as in JAX:

    * on the kernel route (``shared_kernel_route``): the pair code h2 in
      ``tpu.rel_stream_dtype`` from ``ops/pair_mlp.pair_mlp_fused`` (or its
      plain version on the card when ``tpu.fused_pair_mlp`` is off), then
      ``ops/shared_contract.shared_contract_kernel`` straight into the cache
      dtype;
    * contract-then-gather when ``rel_gather`` (the interpreter's
      ``_rel_gather_map``) is given, ``tpu.rel_contract_then_gather`` is on
      and U < B: h2 projected once per image onto the relation
      sub-vocabulary, then a per-question row gather;
    * otherwise the per-question einsum over the gathered h2.

    The plain tails use the expm1 ELU (``jax.nn.elu``), the kernel route
    the TPU kernels' exp(x)-1 form."""
    rp = params.relation_network
    if rp is None:
        raise NotImplementedError(
            "relation_network_layers_config=None (identity relation network) "
            "is not supported by the fused relation path")
    U, O, d_att = attr_in_u.shape
    B, R = rel_tokens.shape
    layers = list(rp.layers)
    w_s, w_o, w_g, b0 = _first_layer_split(layers[0], d_att)
    x = nn.dropout(attr_in_u, cfg.dropout, generator, deterministic)
    x_obj = nn.dropout(attr_in_u, cfg.dropout, generator, deterministic)
    h_s = torch.matmul(x, w_s)
    h_o = torch.matmul(x_obj, w_o)
    e_sel, b_sel = select_relation_rows(params, rel_tokens)
    pad_slot = (rel_tokens == 0)[:, :, None, None]

    if shared_kernel_route(cfg, attr_in_u.device, deterministic):
        from dfol_vqa_tpu_torch.ops import pair_mlp, shared_contract

        stream = getattr(torch, cfg.tpu.rel_stream_dtype)
        trunk = pair_mlp.pair_mlp_fused if cfg.tpu.fused_pair_mlp else pair_mlp.pair_mlp_reference
        h2 = trunk(pos_u, h_s, h_o, w_g, b0, layers[1:], stream)
        return shared_contract.shared_contract_kernel(
            h2, img_index, e_sel.to(stream), b_sel, rel_tokens, default_ll,
            out_dtype=getattr(torch, cfg.tpu.resolve_cache_dtype(int(B))))

    geom = pair_geometry(pos_u)
    h = (h_s[:, :, None, :] + h_o[:, None, :, :]
         + torch.einsum("uijg,gh->uijh", geom, w_g) + b0)
    for layer in layers[1:]:
        h = nn.elu(h)
        h = nn.dropout(h, cfg.dropout, generator, deterministic)
        h = torch.matmul(h, layer.w) + layer.b
    h2 = torch.sigmoid(h)  # (U, O, O, E) shared pair code

    if rel_gather is not None and cfg.tpu.rel_contract_then_gather and U < B:
        # the relation sub-vocabulary's embedding columns plus a zero column
        # for tokens outside it (the compiler never routes one into a slot)
        cols, inv = rel_gather
        K = len(cols)
        emb_w = params.embedding.w  # (E, V_pad)
        cols_t = torch.as_tensor(cols, dtype=torch.long, device=emb_w.device)
        emb_rel = torch.cat([emb_w[:, cols_t], emb_w.new_zeros((emb_w.shape[0], 1))], dim=1)
        h2k = torch.einsum("upe,ek->ukp", h2.reshape(U, O * O, -1), emb_rel)  # (U, K+1, O^2)
        tok0 = torch.clamp(rel_tokens.long() - 1, min=0)
        slot = torch.as_tensor(inv, dtype=torch.long, device=tok0.device)[tok0]  # (B, R)
        flat = img_index.long()[:, None] * (K + 1) + slot
        logits = h2k.reshape(U * (K + 1), O * O)[flat] + b_sel[:, :, None]
        ll = F.logsigmoid(logits).reshape(B, R, O, O)
        if cfg.tpu.debug_checks:
            # a non-pad token outside the relation sub-vocabulary would score
            # as logsigmoid(bias) here: poison it so the mismatch is loud
            bad = ((slot == K) & (rel_tokens != 0))[:, :, None, None]
            ll = ll.masked_fill(bad, float("nan"))
        return ll.masked_fill(pad_slot, default_ll)

    h2_q = h2[img_index.long()]  # (B, O, O, E)
    logits = torch.einsum("bije,bre->brij", h2_q, e_sel) + b_sel[:, :, None, None]
    return F.logsigmoid(logits).masked_fill(pad_slot, default_ll)
