"""Visual oracle: learned attribute/relation log-likelihood scorer.

A frozen copy of the PyTorch port's module of the same name (``benchmark/reference/__init__.py``), itself a port of the JAX package's: the parameter tree
(``OracleParams``, with the executor's optional logic gates and calibrator),
``attr_cache`` (vocab-major ``(B, V+1, O)``), ``_first_layer_split``, the
plain per-question ``rel_cache`` and the shared-image ``rel_cache_shared``
(both R-major ``(B, R, O, O)``), and ``rel_scores_for_pairs`` (listed
pairs, for the supervision terminals). The first relation layer is split
into subject/object/geometry parts, so the O^2 term is a broadcast add of
two (B, O, H) products and a 4-wide geometry contraction.

The trainable interpreter (``oracle_output_dim`` F > 1): the concept heads
emit F logit channels per cell, channel 0 from ``embedding`` and channels
1..F-1 from ``embedding_extra`` (``w (E, V_pad, F-1)``), and a per-arity
operator module (``op_modules``: ``arity1`` for attribute cells, ``arity2``
for relation cells, each an MLP F -> ``operator_layers_config`` -> 1)
reduces them to a scalar log-likelihood, ``logsigmoid(logits0 +
mlp(sigmoid([logits0 ‖ logits_x])))``. The module is elementwise over the
cells, so it is applied while the caches are built and the executor reads
scalar caches as for F = 1. Its final layer starts at zero, so F > 1 starts
out equal to F = 1. F > 1 runs the plain tails only: the kernel routes and
the contract-then-gather tail require F == 1, as in JAX.

"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn as tnn
from torch.nn import functional as F

from benchmark.reference.config import Config
from benchmark.reference import nn
from benchmark.reference.featurizer import pair_geometry

DEFAULT_LOG_LIKELIHOOD = -30.0  # reference default_log_likelihood everywhere


class Embedding(tnn.Module):
    """Concept head: ``w (E, V_pad)``, ``b (V_pad,)`` (the trainable
    interpreter's extra channels: ``w (E, V_pad, F-1)``, ``b (V_pad,
    F-1)``); token code v scores column v-1. The oracle reads the head
    through ``logits`` and ``rows`` only, so a device mesh's model axis can
    put a vocabulary slice in its place (``parallel/mesh.VocabSlice`` on a
    training rank, ``parallel/mesh.VocabShards`` in a serving process)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = tnn.Parameter(w)
        self.b = tnn.Parameter(b)

    def logits(self, h: torch.Tensor, cfg: Optional[Config] = None) -> torch.Tensor:
        """h (..., E) -> (..., V_pad) logits ((..., V_pad, F-1) for the extra
        channels), the operands at ``cfg``'s compute dtype when ``cfg`` is
        given (the attribute head), float32 otherwise (listed pairs, as in
        JAX)."""
        return head_logits(h, self.w, self.b, cfg)

    def rows(self, tok0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """0-based token columns (any shape S) -> (the weight columns as rows
        S + (E,) (S + (E, F-1)), the biases S (S + (F-1,)))."""
        return self.w.movedim(1, 0)[tok0], self.b[tok0]


def head_logits(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                cfg: Optional[Config] = None) -> torch.Tensor:
    """``Embedding.logits`` of the columns ``w``, ``b`` (the whole head or a
    vocabulary slice of it)."""
    c = (lambda x: cast(x, cfg)) if cfg is not None else (lambda x: x)
    if w.ndim == 2:
        return torch.matmul(c(h), c(w)) + b
    return torch.einsum("...e,evk->...vk", c(h), c(w)) + b


LOGIC_GATES = ("filter", "relate0", "relate1")


class OracleParams(tnn.Module):
    """The model's parameters; ``featurizer`` is None for the identity
    network (``featurizer_layers_config=None``). The optional parts are None
    when their configuration is off: ``logic_gates``, the executor's neural
    logic gates (``trainable_gate``: one ``Linear(2, 6)`` per combine site,
    keyed by ``LOGIC_GATES``); ``embedding_extra`` and ``op_modules``, the
    trainable interpreter's heads (``oracle_output_dim > 1``);
    ``calibrator``, the attention-transfer calibrator
    (``activate_attention_transfer``, ``models/calibrator.CalibratorParams``)."""

    def __init__(self, featurizer: Optional[nn.MLP], attribute_network: nn.MLP,
                 relation_network: nn.MLP, embedding: Embedding,
                 logic_gates: Optional[tnn.ModuleDict] = None):
        super().__init__()
        self.featurizer = featurizer
        self.attribute_network = attribute_network
        self.relation_network = relation_network
        self.embedding = embedding
        self.logic_gates = logic_gates
        self.embedding_extra: Optional[Embedding] = None
        self.op_modules: Optional[tnn.ModuleDict] = None
        self.calibrator: Optional[tnn.Module] = None


def init_logic_gates(generator: torch.Generator) -> tnn.ModuleDict:
    """Random logic gates (torch-default Linear init), drawn in
    ``LOGIC_GATES`` order."""
    return tnn.ModuleDict({name: nn.Linear.init(2, 6, generator) for name in LOGIC_GATES})


COMPUTE_DTYPES = ("float32", "bfloat16")


def check_supported(cfg: Config) -> None:
    """Raise for configurations the port does not run."""
    if cfg.tpu.compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"tpu.compute_dtype={cfg.tpu.compute_dtype!r}: the port computes in one of "
            f"{COMPUTE_DTYPES}")


def cast(x: torch.Tensor, cfg: Config) -> torch.Tensor:
    """A product's operand at ``tpu.compute_dtype``, kept float32: with
    "bfloat16" it is rounded to bf16 and widened again, so the product that
    follows multiplies bf16 values exactly and sums in float32, JAX's
    ``x.astype(compute_dtype)`` with ``preferred_element_type=float32``
    (its output is not rounded). The gradient through it is rounded to bf16
    too, as JAX's cast transposes. Identity at "float32"."""
    if cfg.tpu.compute_dtype == "float32":
        return x
    return x.to(torch.bfloat16).to(torch.float32)


def resolve_cache_dtype(cfg: Config, batch: int) -> torch.dtype:
    """Storage dtype of the likelihood caches of a batch of ``batch``
    questions, ``tpu.cache_dtype``. The JAX package's "auto" is a TPU v5e
    table (bf16 from batch 256 up); the port's "auto" is float32 at every
    batch, from a table measured on the card: the device time of one eval
    ``Interpreter.forward`` (ms, the union of its device events in
    ``torch.profiler``), median of five runs of five forwards in turns and
    the runs' spread (max - min), on one relating shared-route batch of
    ``exist`` questions at production widths, NVIDIA H100 80GB HBM3,
    700.00 W (``chip_smoke.phase_cache_dtype``, which measures it again on
    the card it runs on and raises if bfloat16 ever beats float32 by more
    than both spreads at every object count of a batch). bfloat16 caches
    were slower at every cell:

        B, O      float32 ms (spread)   bfloat16 ms (spread)
        32, 24    0.4782 (0.0008)       0.4900 (0.0008)
        80, 24    0.5097 (0.0102)       0.5209 (0.0021)
        256, 24   0.7212 (0.0181)       0.7364 (0.0038)
        32, 100   0.7346 (0.0014)       0.7544 (0.0014)
        80, 100   1.0351 (0.0119)       1.0583 (0.0009)
        256, 100  2.8209 (0.1304)       2.8616 (0.2339)
    """
    del batch  # "auto" takes the batch, as the JAX rule does; on the H100 it never matters
    name = cfg.tpu.cache_dtype
    if name == "auto":
        return torch.float32
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"tpu.cache_dtype must be float32, bfloat16 or auto, got {name!r}")
    return getattr(torch, name)


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
    params = OracleParams(featurizer, attribute, relation, embedding)
    channels = cfg.oracle_output_dim
    if channels > 1:
        if cfg.operator_layers_config is None:
            raise ValueError(
                "oracle_output_dim > 1 requires operator_layers_config to be a list (e.g. [] "
                "for a single Linear(F -> 1)); None cannot reduce the feature axis.")
        extra_w = (torch.randn((emb_in, concept_pad, channels - 1), generator=generator)
                   / np.sqrt(emb_in))
        params.embedding_extra = Embedding(extra_w, torch.zeros((concept_pad, channels - 1)))
        params.op_modules = tnn.ModuleDict(
            {name: _zero_final(nn.MLP.init(channels, cfg.operator_layers_config, 1, generator))
             for name in ("arity1", "arity2")})
    return params.to(device)


def _zero_final(mlp: nn.MLP) -> nn.MLP:
    """Zero the last layer: the operator module's output is a residual on
    the channel-0 logit, so F > 1 starts out equal to F = 1."""
    with torch.no_grad():
        mlp.layers[-1].w.zero_()
        mlp.layers[-1].b.zero_()
    return mlp


def trainable_interpreter(params: OracleParams, cfg: Config) -> bool:
    """Whether the caches go through the operator modules (F > 1)."""
    return cfg.oracle_output_dim > 1 and params.op_modules is not None


def _op_module_ll(params: OracleParams, cfg: Config, logits0: torch.Tensor,
                  logits_x: torch.Tensor, arity: int,
                  generator: Optional[torch.Generator] = None,
                  deterministic: bool = True) -> torch.Tensor:
    """Channel-0 logits (...) and the extra channels' (..., F-1) -> scalar
    log-likelihoods (...): logsigmoid(logits0 + mlp(sigmoid(all channels)))."""
    feats = torch.sigmoid(torch.cat([logits0[..., None], logits_x], dim=-1))
    delta = params.op_modules[f"arity{arity}"](
        feats, final="none", dropout_rate=cfg.dropout, generator=generator,
        deterministic=deterministic)[..., 0]
    return F.logsigmoid(logits0 + delta)


def _extra_emb_select(params: OracleParams, tok0: torch.Tensor):
    """(B, R) 0-based token columns -> the extra heads' rows: (e_sel_x
    (B, R, E, F-1), b_sel_x (B, R, F-1))."""
    return params.embedding_extra.rows(tok0)


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
    logits = params.embedding.logits(h, cfg)
    if trainable_interpreter(params, cfg):
        logits_x = params.embedding_extra.logits(h, cfg)
        ll = _op_module_ll(params, cfg, logits, logits_x, 1, generator, deterministic)
    else:
        ll = F.logsigmoid(logits)
    ll = ll.movedim(-1, 1)  # (B, V, O)
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
    return params.embedding.rows(torch.clamp(rel_tokens.long() - 1, min=0))


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
    h_s = torch.matmul(cast(x, cfg), cast(w_s, cfg))
    h_o = torch.matmul(cast(x_obj, cfg), cast(w_o, cfg))
    h = (h_s[:, :, None, :] + h_o[:, None, :, :]
         + torch.einsum("bijg,gh->bijh", geom, w_g) + b0)
    h = torch.sigmoid(_trunk_tail(h, rp.layers[1:], cfg, generator, deterministic))
    ll = _contract_ll(params, cfg, h, rel_tokens, e_sel, b_sel, generator, deterministic)
    return ll.masked_fill((rel_tokens == 0)[:, :, None, None], default_ll)


def _trunk_tail(h: torch.Tensor, layers, cfg: Config,
                generator: Optional[torch.Generator], deterministic: bool) -> torch.Tensor:
    """The relation MLP after its first layer's pre-activation ``h``: ELU
    (expm1), dropout and each Linear, the products at the compute dtype."""
    for layer in layers:
        h = nn.elu(h)
        h = nn.dropout(h, cfg.dropout, generator, deterministic)
        h = torch.matmul(cast(h, cfg), cast(layer.w, cfg)) + layer.b
    return h


def _contract_ll(params: OracleParams, cfg: Config, h2: torch.Tensor, rel_tokens: torch.Tensor,
                 e_sel: torch.Tensor, b_sel: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = True) -> torch.Tensor:
    """Per-question pair codes h2 (B, O, O, E) against each question's
    relation rows -> (B, R, O, O) log-likelihoods, through the arity-2
    operator module for F > 1. The products' operands are at the compute
    dtype."""
    logits = (torch.einsum("bije,bre->brij", cast(h2, cfg), cast(e_sel, cfg))
              + b_sel[:, :, None, None])
    if not trainable_interpreter(params, cfg):
        return F.logsigmoid(logits)
    e_sel_x, b_sel_x = _extra_emb_select(params, torch.clamp(rel_tokens.long() - 1, min=0))
    logits_x = (torch.einsum("bije,bref->brijf", cast(h2, cfg), cast(e_sel_x, cfg))
                + b_sel_x[:, :, None, None, :])
    return _op_module_ll(params, cfg, logits, logits_x, 2, generator, deterministic)


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
    image row, rel_tokens (B, R) -> (B, R, O, O): the plain trunk, then
    contract-then-gather when ``rel_gather`` is given,
    ``tpu.rel_contract_then_gather`` is on and U < B (F == 1 only), else
    the per-question einsum over the gathered h2.

    At inference (``deterministic``, F == 1) the pair code and the relation
    rows are stored in ``tpu.rel_stream_dtype`` before the contraction,
    which is the precision the configuration states for that product (the
    products of two bfloat16 values are exact in float32, the sums float32).
    """
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
    h_s = torch.matmul(cast(x, cfg), cast(w_s, cfg))
    h_o = torch.matmul(cast(x_obj, cfg), cast(w_o, cfg))
    e_sel, b_sel = select_relation_rows(params, rel_tokens)
    pad_slot = (rel_tokens == 0)[:, :, None, None]
    geom = pair_geometry(pos_u)
    h = (h_s[:, :, None, :] + h_o[:, None, :, :]
         + torch.einsum("uijg,gh->uijh", geom, w_g) + b0)
    h2 = torch.sigmoid(_trunk_tail(h, layers[1:], cfg, generator, deterministic))
    stream = getattr(torch, cfg.tpu.rel_stream_dtype)
    stored = deterministic and cfg.oracle_output_dim == 1 and stream != torch.float32
    if stored:
        h2 = h2.to(stream).float()
    # h2: (U, O, O, E) shared pair code

    if (rel_gather is not None and cfg.tpu.rel_contract_then_gather and U < B
            and not trainable_interpreter(params, cfg)):
        # the relation sub-vocabulary's embedding columns plus a zero column
        # for tokens outside it (the compiler never routes one into a slot)
        cols, inv = rel_gather
        K = len(cols)
        cols_t = torch.as_tensor(cols, dtype=torch.long, device=h2.device)
        w_rel = params.embedding.rows(cols_t)[0]  # (K, E)
        emb_rel = torch.cat([w_rel, w_rel.new_zeros((1, w_rel.shape[1]))]).t()
        if stored:
            emb_rel = emb_rel.to(stream).float()
        h2k = torch.einsum("upe,ek->ukp", cast(h2.reshape(U, O * O, -1), cfg),
                           cast(emb_rel, cfg))  # (U, K+1, O^2)
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

    ll = _contract_ll(params, cfg, h2[img_index.long()], rel_tokens, e_sel, b_sel, generator,
                      deterministic)
    return ll.masked_fill(pad_slot, default_ll)


def rel_scores_for_pairs(
    params: OracleParams,
    attr_in: torch.Tensor,
    pos: torch.Tensor,
    pair_idx: torch.Tensor,
    cfg: Config,
    rel_cols: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Score LISTED object pairs against relation vocabulary columns.

    attr_in (B, O, D+4), pos (B, O, 4), ``pair_idx (B, P, 2)`` (subject,
    object) indices -> (B, P, |rel_cols|) log-likelihoods: the whole
    relation MLP on ``[f_s, f_o, geom]`` per listed pair, then
    logsigmoid(hmid @ emb_w[:, cols] + b[cols]). ``rel_cols`` (0-based
    token columns) defaults to every column of the padded vocabulary. The
    pair geometry is the listed-pair form of the JAX package (asin of dy
    over the distance clamped at 1e-10, so a zero-distance pair has angle
    0), not ``featurizer.pair_geometry``'s."""
    rp = params.relation_network
    B = pair_idx.shape[0]
    rows = torch.arange(B, device=pair_idx.device)[:, None]
    i_s, i_o = pair_idx[..., 0].long(), pair_idx[..., 1].long()
    f_s, f_o = attr_in[rows, i_s], attr_in[rows, i_o]
    x, y, w, h = pos[rows, i_s].unbind(-1)
    x2, y2, w2, h2 = pos[rows, i_o].unbind(-1)
    dx = (x + w / 2.0) - (x2 + w2 / 2.0)
    dy = (y + h / 2.0) - (y2 + h2 / 2.0)
    dist = torch.sqrt(dx * dx + dy * dy)
    angle = torch.arcsin(dy / torch.clamp(dist, min=1e-10))
    geom = torch.stack([dist, angle, torch.sign(x2 - x), torch.sign(y2 - y)], dim=-1)
    pair_feat = torch.cat([f_s, f_o, geom], dim=-1)
    hmid = nn.mlp_apply(rp, pair_feat, final="sigmoid", dropout_rate=cfg.dropout,
                        generator=generator, deterministic=deterministic)
    if rel_cols is None:
        logits = params.embedding.logits(hmid)
    else:
        w_rows, b_rows = params.embedding.rows(rel_cols)
        logits = torch.matmul(hmid, w_rows.t()) + b_rows
    if not trainable_interpreter(params, cfg):
        return F.logsigmoid(logits)
    if rel_cols is None:
        logits_x = params.embedding_extra.logits(hmid)
    else:
        w_rows, b_rows = params.embedding_extra.rows(rel_cols)
        logits_x = torch.einsum("bpe,kef->bpkf", hmid, w_rows) + b_rows
    return _op_module_ll(params, cfg, logits, logits_x, 2, None, deterministic)
