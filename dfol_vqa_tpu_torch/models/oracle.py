"""Visual oracle: learned attribute/relation log-likelihood scorer.

Port of ``dfol_vqa_tpu/models/oracle.py`` for ``oracle_output_dim == 1``:
the parameter tree (``OracleParams``), ``attr_cache`` (vocab-major
``(B, V+1, O)``), ``_first_layer_split`` and the plain per-question
``rel_cache`` (R-major ``(B, R, O, O)``). The first relation layer is split
into subject/object/geometry parts, so the O^2 term is a broadcast add of
two (B, O, H) products and a 4-wide geometry contraction.

Still to port (ROADMAP queues): ``rel_cache_shared`` and its two kernels,
``rel_scores_for_pairs`` and ``oracle_output_dim > 1``.
"""

from __future__ import annotations

from typing import Optional

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
            "(ROADMAP queue 1: trainable interpreter)")
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
