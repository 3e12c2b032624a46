"""The program executor, in PyTorch.

A frozen copy of the PyTorch port's module of the same name
(``benchmark/reference/__init__.py``), with the kernel routes left out:

    scene build (featurizer, oracle caches)  ->  unrolled branch slot updates
        ->  terminal op  ->  answer flags and the loss

The program grid is static per ``BucketSpec`` and runs eagerly. Every
terminal of the JAX package runs: the thirteen question terminals, ``end``
statements, and the scene-graph supervision terminals ``object_attr``,
``object_rel`` and ``scene`` (these score listed object pairs through
``oracle.rel_scores_for_pairs``). With ``trainable_gate`` the filter and
relate updates combine through the neural logic gates of
``OracleParams.logic_gates``. The relation cache takes one of two routes,
as in JAX: when questions share images (U * 2 <= B, the deduplicated batches
of ``BatchLoader``), ``oracle.rel_cache_shared``, which on a CUDA device
runs the ``pair_mlp`` and ``shared_contract`` kernels; otherwise, per
question, the relation-oracle kernels (``ops/relation_oracle.py``, forward
and, under autograd, backward) when the tensors are on a CUDA device,
``tpu.use_pallas`` is set and ``oracle_output_dim == 1``, and the plain
``oracle.rel_cache`` otherwise (so the trainable interpreter, F > 1, always
takes a plain tail, as in JAX). The loss covers every question type:
STATEMENT, BINARY, QUERY, OBJECT_STATEMENT and SCENE_GRAPH. With
``activate_attention_transfer`` the calibrator (``models/calibrator.py``)
computes per-slot and terminal modulations, which ``_modulate`` applies to
the attentions the executor carries.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.program_compiler import (
    OP_FILTER,
    OP_PAD,
    OP_RELATE,
    OP_SELECT,
    BucketSpec,
)
from benchmark.reference.config import Config
from benchmark.reference.ontology import GQAOntology
from benchmark.reference import calibrator as cal
from benchmark.reference import oracle as om
from benchmark.reference.featurizer import featurize_objects
from benchmark.reference.cells import filter_update, normalize_over_options, relate_update
from benchmark.reference.nn import Linear
from benchmark.reference import logic
from benchmark.reference.types import QuestionType, VariableSet, World, batch_any

QUERY_OPS = ("query_attr", "choose_attr", "choose_rel", "compare")


def question_type_of(terminal_op: str) -> QuestionType:
    if terminal_op in QUERY_OPS:
        return QuestionType.QUERY
    if terminal_op == "end":
        return QuestionType.STATEMENT
    if terminal_op in ("object_attr", "object_rel"):
        return QuestionType.OBJECT_STATEMENT
    if terminal_op == "scene":
        return QuestionType.SCENE_GRAPH
    return QuestionType.BINARY


def decode_answer_flags(flags, spec, compiled) -> list:
    """Answer flags -> per-question answer-string lists (ties kept, in
    option order), exactly as the JAX package decodes them."""
    qtype = question_type_of(spec.terminal_op)
    flags = np.asarray(flags)
    answers = []
    for qi in range(len(compiled.image_ids)):
        if qtype == QuestionType.QUERY:
            opts = compiled.option_strings[qi]
            answers.append([opts[k] for k in range(len(opts)) if flags[qi, k]])
        elif qtype == QuestionType.STATEMENT:
            names = compiled.names[qi] if compiled.names else ["entity"]
            answers.append([names[0]])
        else:
            answers.append(["yes"] if flags[qi, 0] else ["no"])
    return answers


def spec_needs_relations(spec: BucketSpec) -> bool:
    if spec.terminal_op in ("choose_rel", "verify_rel"):
        return True
    return any(OP_RELATE in g for g in spec.grid)


# ------------------------------------------------------------------- gathers


def _apply_negation_exact(ll: torch.Tensor, neg: torch.Tensor,
                          any_neg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """When ANY token in the batch is negated, lpn(ll, is_neg, 1) is applied
    to every row — an exp/log round trip for the others too; with none
    negated, no transform. A device-side select: no host sync. ``any_neg``
    is the whole batch's answer where these rows are a block of it
    (``types.batch_any``)."""
    shaped = neg.reshape(neg.shape + (1,) * (ll.ndim - neg.ndim))
    if any_neg is None:
        any_neg = torch.amax(neg) > 0
    return torch.where(any_neg, logic.log_parametric_not(ll, shaped, 1.0), ll)


def _gather_attr(world: World, tok: torch.Tensor,
                 any_neg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """attr_ll (U, V+1, O) + img_index, tok (B,) signed -> (B, O), negation
    applied: one (O,)-row gather per question."""
    U, Vp1, O = world.attr_ll.shape
    flat = world.img_index.long() * Vp1 + torch.abs(tok.long())
    ll = world.attr_ll.reshape(U * Vp1, O)[flat].float()
    return _apply_negation_exact(ll, (tok < 0).float(), any_neg)


def _gather_attr_options(world: World, toks: torch.Tensor) -> torch.Tensor:
    """toks (B, K) signed -> (B, K, O) raw (sign NOT applied)."""
    U, Vp1, O = world.attr_ll.shape
    flat = world.img_index.long()[:, None] * Vp1 + torch.abs(toks.long())
    return world.attr_ll.reshape(U * Vp1, O)[flat].float()


def _apply_option_negation(ll: torch.Tensor, toks: torch.Tensor,
                           any_neg: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _apply_negation_exact(ll, (toks < 0).float(), any_neg)


def _gather_rel(rel_ll: torch.Tensor, idx: torch.Tensor, tok: torch.Tensor,
                any_neg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """rel_ll (B, R, O, O), idx (B,), tok (B,) signed -> (B, O, O)."""
    B = rel_ll.shape[0]
    ll = rel_ll[torch.arange(B, device=rel_ll.device), idx.long()].float()
    return _apply_negation_exact(ll, (tok < 0).float(), any_neg)


def _gather_rel_options(rel_ll: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rel_ll (B, R, O, O), idx (B, K) -> (B, K, O, O) raw (sign NOT applied)."""
    rows = torch.arange(rel_ll.shape[0], device=rel_ll.device)[:, None]
    return rel_ll[rows, idx.long()].float()


def _log_probability(att, quant, obj_mask, hard: bool):
    return VariableSet(att, quant, obj_mask).log_probability(hard_mode=hard)


def _bce_terms(lp: torch.Tensor):
    """Stable BCE log terms from a LOG probability, as the JAX package's
    ``_bce_terms``: log(p) = lp clamped at -100 (torch BCE's clamp), and
    log(1 - p) through expm1 with the argument bounded at 1e-12, so the
    gradient stays finite when p saturates."""
    lg = torch.clamp(lp, min=-100.0)
    one_minus = -torch.expm1(torch.clamp(lp, max=-1e-12))
    lg1 = torch.clamp(torch.log(torch.clamp(one_minus, min=1e-12)), min=-100.0)
    return lg, lg1


def _modulate(att: torch.Tensor, mods: Optional[torch.Tensor]) -> torch.Tensor:
    """The attention calibration transform on a log-attention tensor; mods
    (..., 4) in sigmoid space, (alpha, beta, c) scaled by
    ``MAX_ACTIVATION``, broadcast over the last (object) axis."""
    if mods is None:
        return att
    alpha = mods[..., 0:1] * cal.MAX_ACTIVATION
    beta = mods[..., 1:2] * cal.MAX_ACTIVATION
    c = mods[..., 2:3] * cal.MAX_ACTIVATION
    d = mods[..., 3:4]
    temp = alpha * att + logic.safe_log(c) + logic.safe_log(d)
    return temp - logic.safe_log(torch.exp(beta * logic.log_not(att) + logic.safe_log(1.0 - d))
                                 + torch.exp(temp))


Gates = Optional[Dict[str, Linear]]
Mods = Optional[Dict[str, torch.Tensor]]


def _filter_gate(gates: Gates) -> Optional[Linear]:
    return None if gates is None else gates["filter"]


def _relate_gates(gates: Gates):
    return None if gates is None else (gates["relate0"], gates["relate1"])


def _relate_core(subj, obj, ll, obj_mask, gates: Gates = None):
    """EXISTS-quantified arity-2 update (both chains are EXISTS sets)."""
    ones = torch.ones(subj.shape[:-1], dtype=subj.dtype, device=subj.device)
    return relate_update(subj, obj, ll, ones, ones, obj_mask, gates=_relate_gates(gates))


def _relate_step(world: World, att, aux, s, ll_rel, gates: Gates = None, mods: Mods = None,
                 aux_neg: Optional[torch.Tensor] = None):
    """Select the new set (token ``aux``, 0 = everything), relate it with the
    running set ``att`` through ``ll_rel``, and keep the new side: the
    subject when ``s == 1``, else the object. ``ll_rel (B, K, O, O)`` fans
    both sets out over K options (``choose_rel``). The calibrator's
    ``select`` mods apply to the selected set where ``aux != 0``, its
    ``subject`` and ``object`` mods ((B, 4), or (B, K, 4) on a fan-out) to
    the related sets before the side is kept. ``aux_neg``: the whole
    batch's negation flag of ``aux`` (``types.batch_any``)."""
    picked = (aux != 0)[:, None]
    x = torch.where(picked, _gather_attr(world, aux, aux_neg), 0.0)
    if mods is not None and mods.get("select") is not None:
        x = torch.where(picked, _modulate(x, mods["select"]), x)
    subj = s * x + (1.0 - s) * att
    obj = s * att + (1.0 - s) * x
    if ll_rel.ndim == 4:
        K = ll_rel.shape[1]
        subj, obj, s = subj[:, None].expand(-1, K, -1), obj[:, None].expand(-1, K, -1), s[:, None]
    subj2, obj2 = _relate_core(subj, obj, ll_rel, world.obj_mask, gates)
    if mods is not None:
        subj2 = _modulate(subj2, mods.get("subject"))
        obj2 = _modulate(obj2, mods.get("object"))
    return s * subj2 + (1.0 - s) * obj2


_CACHE_LOCK = threading.Lock()  # guards every Interpreter's device cache


def device_key(device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Interpreter:
    """Builds worlds and executes compiled program batches."""

    def __init__(self, cfg: Config, ontology: GQAOntology):
        om.check_supported(cfg)
        self.cfg = cfg
        self.ont = ontology
        self._rel_gather_cache = None
        self._emb_matrix: Optional[np.ndarray] = None
        self._index_cache: Dict[tuple, torch.Tensor] = {}

    def init_params(self, generator: torch.Generator, device="cpu") -> om.OracleParams:
        """The oracle's parameters (with the trainable interpreter's heads
        when ``oracle_output_dim > 1``), then, with ``trainable_gate``, the
        logic gates and, with ``activate_attention_transfer``, the
        calibrator, all drawn from ``generator`` on the CPU and moved to
        ``device``."""
        params = om.init_oracle_params(self.cfg, self.ont, generator)
        if self.cfg.trainable_gate:
            params.logic_gates = om.init_logic_gates(generator)
        if self.cfg.activate_attention_transfer:
            params.calibrator = cal.init_calibrator_params(self.cfg, generator)
        return params.to(device)

    def parameter_count(self, params: om.OracleParams) -> int:
        """The number of parameter elements, every subtree included (the
        calibrator, the logic gates and the F > 1 heads): what
        ``dfol_vqa_tpu.nn.param_count`` counts for the same parameters."""
        return int(sum(p.numel() for p in params.parameters()))

    @property
    def embedding_matrix(self) -> np.ndarray:
        """The whole vocabulary's GloVe matrix (V+1, D), cut to
        ``word_embedding_dim``: the calibrator's token features. Host numpy;
        not a parameter."""
        if self._emb_matrix is None:
            m = self.ont.embedding_matrix()
            self._emb_matrix = np.asarray(m[:, :self.cfg.word_embedding_dim], np.float32)
        return self._emb_matrix

    def _on_device(self, name: str, device, make):
        """The cached ``make(device)`` of ``name`` on ``device``, made once
        per device. "cuda" and "cuda:<current>" share an entry, and the
        get-or-fill is atomic, so the threads of an engine that serves
        several devices share the cache."""
        key = (name, device_key(device))
        with _CACHE_LOCK:
            hit = self._index_cache.get(key)
            if hit is None:
                hit = self._index_cache[key] = make(key[1])
        return hit

    def embedding_on(self, device) -> torch.Tensor:
        """``embedding_matrix`` on ``device``, moved there once."""
        return self._on_device("embedding", device,
                               lambda d: torch.as_tensor(self.embedding_matrix, device=d))

    def with_embedding(self, embedding: torch.Tensor) -> "Interpreter":
        """A shallow copy whose ``embedding_on`` returns ``embedding`` on its
        device (a step input in place of the cached matrix, so that an
        exported step does not carry it)."""
        view = copy.copy(self)
        view._index_cache = {("embedding", device_key(embedding.device)): embedding}
        return view

    def _index(self, name: str, device) -> torch.Tensor:
        """The ontology's 0-based attribute (``name="attribute"``) or
        relation (``"relation"``) token columns, kept on the host and moved
        to ``device`` once."""
        return self._on_device(name, device, lambda d: torch.as_tensor(
            np.asarray(getattr(self.ont, f"_{name}_index"), np.int64), device=d))

    def _rel_gather_on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``_rel_gather_map`` as int64 tensors on ``device``, moved there
        once (a step that a CUDA graph captures copies nothing from the
        host); normal tensors even when first asked for under
        ``torch.inference_mode()``, since training saves them for backward."""
        def make(d):
            with torch.inference_mode(False):
                return tuple(torch.as_tensor(np.asarray(a, np.int64), device=d)
                             for a in self._rel_gather_map)

        return self._on_device("rel_gather", device, make)

    @property
    def _rel_gather_map(self):
        """Static (cols, inv) pair for the contract-then-gather relation
        path (``oracle.rel_cache_shared``): ``cols (K,)`` = 0-based embedding
        columns of the relation vocabulary, ``inv (num_tokens,)`` maps any
        0-based token column to its slot in ``cols`` (non-relations -> K,
        the appended zero column). Host numpy."""
        if self._rel_gather_cache is None:
            cols = np.asarray(self.ont._relation_index, np.int32)
            inv = np.full((self.ont.num_tokens,), len(cols), np.int32)
            inv[cols] = np.arange(len(cols), dtype=np.int32)
            self._rel_gather_cache = (cols, inv)
        return self._rel_gather_cache

    # ----------------------------------------------------------- scene build

    def build_world(
        self,
        params: om.OracleParams,
        objects: torch.Tensor,
        obj_mask: torch.Tensor,
        rel_tokens: Optional[torch.Tensor],
        generator: Optional[torch.Generator] = None,
        deterministic: bool = True,
        needs_rel: bool = True,
        img_index: Optional[torch.Tensor] = None,
    ) -> World:
        """Featurize, then the attribute cache per scene row and the relation
        cache per question. ``objects`` (U, O, D+6) must be float32; with
        ``img_index (B,)`` its rows are unique images, and the featurizer
        and attribute head run once per image."""
        cfg = self.cfg
        attr_in_u, pos_u = featurize_objects(params.featurizer, objects, cfg, generator,
                                             deterministic)
        attr_ll = om.attr_cache(params, attr_in_u, cfg, generator, deterministic)
        if img_index is None:
            img_index = torch.arange(obj_mask.shape[0], device=obj_mask.device)
            attr_in, pos, q_mask = attr_in_u, pos_u, obj_mask
        else:
            idx = img_index.long()
            attr_in, pos, q_mask = attr_in_u[idx], pos_u[idx], obj_mask[idx]
        obj_mask = q_mask
        B, O = obj_mask.shape
        U = attr_in_u.shape[0]
        if needs_rel and rel_tokens is not None:
            if U * 2 <= B:
                rel_ll = om.rel_cache_shared(params, attr_in_u, pos_u, img_index, rel_tokens,
                                             cfg, generator, deterministic,
                                             rel_gather=self._rel_gather_on(objects.device))
            else:
                rel_ll = om.rel_cache(params, attr_in, pos, rel_tokens, cfg, generator,
                                      deterministic)
        else:
            R = 1 if rel_tokens is None else rel_tokens.shape[1]
            rel_ll = torch.zeros((B, R, 1, 1), dtype=torch.float32, device=obj_mask.device)
            if rel_tokens is None:
                rel_tokens = torch.zeros((B, R), dtype=torch.int32, device=obj_mask.device)
        cache_dtype = om.resolve_cache_dtype(cfg, B)
        return World(
            obj_mask=obj_mask,
            attr_ll=attr_ll.to(cache_dtype),
            rel_ll=rel_ll.to(cache_dtype),
            rel_tokens=rel_tokens,
            attr_in=attr_in,
            pos=pos,
            img_index=img_index,
        )

    # -------------------------------------------------------- branch executor

    def _run_branch(self, world: World, arrays: Dict[str, torch.Tensor], branch: int,
                    grid: Sequence[int], gates: Gates = None,
                    slot_mods: Optional[Sequence[Mods]] = None,
                    trace: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """Execute one branch's slot sequence; returns the final (B, O)
        attention. Every slot is gated by ``(tok != 0) * op_mask``, so padded
        slots are exact no-ops. ``slot_mods`` holds the calibrator's role
        dict per slot. With a ``trace`` list, the (B, O) attention after
        every non-pad slot is appended to it."""
        B, O = world.obj_mask.shape
        att = torch.zeros((B, O), dtype=torch.float32, device=world.obj_mask.device)
        for si, opc in enumerate(grid):
            if opc == OP_PAD:
                continue
            mods = slot_mods[si] if slot_mods is not None else None
            m = arrays["op_mask"][:, branch, si]
            tok = arrays["arg_tok"][:, branch, si]
            tok_neg = batch_any(arrays, "neg", "arg_tok", (branch, si))
            if opc in (OP_SELECT, OP_FILTER):
                new = filter_update(att, _gather_attr(world, tok, tok_neg), _filter_gate(gates))
                if mods is not None:
                    new = _modulate(new, mods.get("filter"))
            else:  # OP_RELATE
                ll_rel = _gather_rel(world.rel_ll, arrays["rel_idx"][:, branch, si], tok, tok_neg)
                new = _relate_step(world, att, arrays["arg_aux"][:, branch, si],
                                   arrays["arg_flag"][:, branch, si][:, None], ll_rel, gates,
                                   mods, batch_any(arrays, "neg", "arg_aux", (branch, si)))
            upd = ((tok != 0).float() * m)[:, None]
            att = upd * new + (1.0 - upd) * att
            if trace is not None:
                trace.append(att)
        return att

    # ------------------------------------------------------------- terminals

    def _filter_fanout(self, world, att, options, opt_mask, normalize: bool,
                       gates: Gates = None, mods: Optional[torch.Tensor] = None,
                       opt_neg: Optional[torch.Tensor] = None):
        """Fan-out filter over a (B, K) option axis; ``mods`` (B, K, 4)."""
        ll = _gather_attr_options(world, options)
        ll = normalize_over_options(ll, opt_mask, enabled=normalize and self.cfg.normalize_oracle)
        ll = _apply_option_negation(ll, options, opt_neg)
        return _modulate(filter_update(att[:, None, :], ll, _filter_gate(gates)), mods)

    def _terminal(self, world: World, arrays, spec: BucketSpec, atts, hard: bool,
                  gates: Gates = None, params: Optional[om.OracleParams] = None,
                  tmods: Mods = None):
        """(B,) log probability for BINARY/STATEMENT terminals, (B, K) for
        QUERY and OBJECT_STATEMENT ones, and for ``scene`` a dict of the
        attribute (B, O, A) and listed-pair relation (B, P, V_rel) ones.
        ``tmods`` holds the calibrator's terminal modulations."""
        cfg = self.cfg
        term = spec.terminal_op
        mask = world.obj_mask
        options, opt_mask = arrays["options"], arrays["opt_mask"]
        opt_neg = batch_any(arrays, "neg", "options")
        tmods_get = (lambda _: None) if tmods is None else tmods.get

        def ones(x):
            return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)

        def fanout(att, normalize=True, key="fanout"):
            return self._filter_fanout(world, att, options, opt_mask, normalize, gates,
                                       tmods_get(key), opt_neg)

        def any_option(lp_k):  # OR over the option fan-out
            return logic.log_not(torch.sum(logic.log_not(lp_k) * opt_mask, dim=1))

        # upstream quirk kept for parity: these three delegate without their
        # hard_mode argument, so they always aggregate softly
        if term in ("query_attr", "all_different", "two_different"):
            hard = False

        if term in ("exist", "end"):
            att = atts[0]
            return _log_probability(att, ones(att), mask, hard)

        if term == "verify_attrs":  # AND of the options' filters
            att_k = fanout(atts[0], normalize=False)
            combined = torch.sum(att_k * opt_mask[:, :, None], dim=1)
            return _log_probability(combined, ones(combined), mask, hard)

        if term in ("query_attr", "choose_attr"):
            att_k = fanout(atts[0])
            return _log_probability(att_k, ones(att_k), mask, hard)

        if term == "choose_rel":
            ll = _gather_rel_options(world.rel_ll, arrays["opt_rel_idx"])  # (B, K, O, O)
            ll = normalize_over_options(ll, opt_mask, enabled=cfg.normalize_oracle)
            ll = _apply_option_negation(ll, options, opt_neg)
            chosen = _relate_step(world, atts[0], arrays["last_aux"],
                                  arrays["last_flag"][:, None], ll, gates, tmods,
                                  batch_any(arrays, "neg", "last_aux"))
            return _log_probability(chosen, ones(chosen), mask, hard)

        if term == "verify_rel":
            ll = _gather_rel(world.rel_ll, arrays["last_rel_idx"], arrays["last_tok"],
                             batch_any(arrays, "neg", "last_tok"))
            final = _relate_step(world, atts[0], arrays["last_aux"],
                                 arrays["last_flag"][:, None], ll, gates, tmods,
                                 batch_any(arrays, "neg", "last_aux"))
            return _log_probability(final, ones(final), mask, hard)

        if term in ("and", "or"):
            lp1 = _log_probability(atts[0], ones(atts[0]), mask, hard)
            lp2 = _log_probability(atts[1], ones(atts[1]), mask, hard)
            return logic.log_and(lp1, lp2) if term == "and" else logic.log_or(lp1, lp2)

        if term in ("all_same", "all_different"):
            # (member => holds option k) under FOR_ALL, then OR over options
            att = atts[0]
            att_k = fanout(att)
            log_post = logic.log_not(logic.log_and(att[:, None, :], logic.log_not(att_k)))
            lp_k = _log_probability(log_post, torch.zeros_like(ones(log_post)), mask, hard)
            lp = any_option(lp_k)
            return logic.log_not(lp) if term == "all_different" else lp

        if term in ("two_same", "two_different"):
            att_k1, att_k2 = fanout(atts[0], key="fanout0"), fanout(atts[1], key="fanout1")
            lp_k = logic.log_and(_log_probability(att_k1, ones(att_k1), mask, hard),
                                 _log_probability(att_k2, ones(att_k2), mask, hard))
            lp = any_option(lp_k)
            return logic.log_not(lp) if term == "two_different" else lp

        if term == "compare":
            # both branches filtered by the attribute, a log-softmax over the
            # two, and the is_less flip
            ll = _gather_attr(world, arrays["last_tok"], batch_any(arrays, "neg", "last_tok"))
            a1 = _modulate(filter_update(atts[0], ll, _filter_gate(gates)), tmods_get("branch0"))
            a2 = _modulate(filter_update(atts[1], ll, _filter_gate(gates)), tmods_get("branch1"))
            lp = torch.log_softmax(torch.stack([_log_probability(a1, ones(a1), mask, hard),
                                                _log_probability(a2, ones(a2), mask, hard)],
                                               dim=1), dim=1)
            return logic.log_parametric_not(lp, arrays["last_flag"][:, None], 1.0)

        if term == "object_attr":
            # each statement filters a fresh entity set; read at its object
            ll = _gather_attr_options(world, options)  # (B, K, O)
            ll = normalize_over_options(ll, opt_mask, enabled=cfg.normalize_oracle)
            ll = _apply_option_negation(ll, options, opt_neg)
            att_k = filter_update(torch.zeros_like(ll), ll, _filter_gate(gates))
            return att_k.gather(2, arrays["stmt_obj"].long()[:, :, None])[..., 0]

        if term == "object_rel":
            # statement k's relation scored on every listed pair p of its
            # question, cluster-normalised across the statements per pair,
            # scattered to (B, K, O, O) (unlisted pairs: log 1), then a
            # FOR_ALL x FOR_ALL relate update and FOR_ALL aggregation
            s_obj, s_obj2 = arrays["stmt_obj"].long(), arrays["stmt_obj2"].long()
            scores = om.rel_scores_for_pairs(params, world.attr_in, world.pos,
                                             torch.stack([s_obj, s_obj2], dim=-1), cfg)
            tok0 = torch.clamp(torch.abs(options.long()) - 1, min=0)  # (B, K)
            B, K = tok0.shape
            P = scores.shape[1]
            sc = scores.gather(2, tok0[:, None, :].expand(B, P, K)).transpose(1, 2)  # (B, K, P)
            sc = normalize_over_options(sc, opt_mask, enabled=cfg.normalize_oracle)
            sc = _apply_option_negation(sc, options, opt_neg) * opt_mask[:, None, :]
            O = mask.shape[-1]
            # index_put without accumulate: a pair listed twice writes the
            # same value twice (same pair, same scores), and the pad slots'
            # (0, 0) lies on the diagonal, which relate_update excludes, so
            # the order of colliding writes cannot change the result. JAX's
            # scatter passes the gradient to one of the colliding writes
            # only; so does this, to the first listing of each pair.
            flat = s_obj * O + s_obj2  # (B, P)
            idx = torch.arange(P, device=sc.device)
            first = ~((flat[:, :, None] == flat[:, None, :])
                      & (idx[:, None] > idx[None, :])).any(dim=-1)
            sc = torch.where(first[:, None, :], sc, sc.detach())
            rows = torch.arange(B, device=sc.device)[:, None, None]
            ks = torch.arange(K, device=sc.device)[None, :, None]
            ll = torch.zeros((B, K, O, O), dtype=sc.dtype, device=sc.device).index_put(
                (rows, ks, s_obj[:, None, :], s_obj2[:, None, :]), sc)
            zeros_att = torch.zeros((B, K, O), dtype=sc.dtype, device=sc.device)
            q_all = torch.zeros((B, K), dtype=sc.dtype, device=sc.device)  # FOR_ALL
            subj2, _ = relate_update(zeros_att, zeros_att, ll, q_all, q_all, mask,
                                     gates=_relate_gates(gates))
            return _log_probability(subj2, q_all, mask, hard)

        if term == "scene":
            # the attribute rows of the vocab-major cache, as (B, O, A), and
            # the listed pairs over the relation vocabulary
            attr_lp = world.attr_ll[:, self._index("attribute", mask.device) + 1]
            attr_lp = attr_lp[world.img_index.long()].float().transpose(1, 2)
            rel_lp = om.rel_scores_for_pairs(params, world.attr_in, world.pos,
                                             arrays["pair_idx"], cfg,
                                             rel_cols=self._index("relation", mask.device))
            return {"attr": attr_lp, "rel": rel_lp}

        raise ValueError(f"unknown terminal {term!r}")

    # ---------------------------------------------------------------- output

    def _answers_and_metrics(self, lp, arrays, spec: BucketSpec, qtype: QuestionType):
        """Answer flags + accuracy match, on the device. QUERY tie rule:
        every option whose exp(lp) equals the max and exceeds
        ``likelihood_threshold`` is an answer, credited 1/|ties| (or the
        first flagged option when ``first_answer``); ``compare`` answers
        with the argmax of its two branches."""
        cfg = self.cfg
        out: Dict[str, torch.Tensor] = {"log_probability": lp}
        qm = arrays["question_mask"]
        if qtype == QuestionType.OBJECT_STATEMENT:
            # weighted statement accuracy, the batch's average per question
            w = arrays["stmt_weight"] * arrays["opt_mask"] * qm[:, None]
            pred = torch.exp(lp) > 0.5
            match = (pred == (arrays["answer_opt"] > 0.5)).float()
            avg = torch.sum(match * w) / torch.clamp(torch.sum(w), min=1e-6)
            out["answer_flags"] = pred
            out["match"] = avg.expand(lp.shape[0])
        elif qtype == QuestionType.SCENE_GRAPH:
            # the error over thresholded attributes (real objects) and listed
            # relations, counting entries that the target or the answer holds
            a_ans = (torch.exp(lp["attr"]) > 0.5).float()
            r_ans = (torch.exp(lp["rel"]) > 0.5).float()
            a_t, r_t = arrays["attr_answer"], arrays["rel_answer"]
            a_w = (arrays["attr_weight"] * ((a_t + a_ans) > 0) * qm[:, None, None]
                   * arrays["__obj_mask__"][:, :, None])
            r_w = (arrays["rel_weight"] * arrays["pair_mask"][:, :, None] * ((r_t + r_ans) > 0)
                   * qm[:, None, None])
            nom = torch.sum((a_t != a_ans) * a_w) + torch.sum((r_t != r_ans) * r_w)
            denom = torch.clamp(torch.sum(a_w) + torch.sum(r_w), min=1e-6)
            out["answer_flags"] = torch.zeros((qm.shape[0], 1), dtype=torch.bool,
                                              device=qm.device)
            out["match"] = (1.0 - nom / denom).expand(qm.shape[0])
        elif spec.terminal_op == "compare":
            idx = torch.argmax(lp, dim=1)
            target = arrays.get("answer_match", arrays["answer_opt"])
            out["answer_flags"] = torch.nn.functional.one_hot(idx, 2) > 0
            out["match"] = target.gather(1, idx[:, None])[:, 0]
        elif qtype == QuestionType.QUERY:
            temp = torch.exp(lp) * arrays["opt_mask"]
            mx = torch.amax(temp, dim=1, keepdim=True)
            flags = (temp == mx) & (temp > cfg.likelihood_threshold)
            target = arrays.get("answer_match", arrays["answer_opt"])
            n_flags = flags.sum(dim=1)
            hit = (flags * target).sum(dim=1)
            if cfg.first_answer:
                first = torch.argmax(flags.to(torch.uint8), dim=1)
                match = target.gather(1, first[:, None])[:, 0] * (n_flags > 0)
            else:
                match = torch.where(n_flags > 0, hit / torch.clamp(n_flags, min=1), 0.0)
            out["answer_flags"] = flags
            out["match"] = match
        else:  # BINARY, STATEMENT
            pred_yes = torch.exp(lp) > 0.5
            target = arrays["answer_binary"] > 0.5
            out["answer_flags"] = pred_yes[:, None]
            out["match"] = (pred_yes == target).float()
        return out

    def _loss(self, lp, arrays, qtype: QuestionType, params: om.OracleParams) -> torch.Tensor:
        """Per-question-type loss summed over the batch's real questions
        (``interpreter._loss``): STATEMENT -sum(lp), BINARY the BCE terms,
        QUERY the grouped softmax cross-entropy over each question's options,
        OBJECT_STATEMENT the statements' weighted BCE, SCENE_GRAPH the
        weighted BCE of the attribute matrix (real objects) and the listed
        relations; plus the ``l1_lambda`` term (mean absolute parameter
        value)."""
        qmask = arrays["question_mask"]

        def bce(lp_x, t, w):
            lg, lg1 = _bce_terms(lp_x)
            return -torch.sum(w * (t * lg + (1.0 - t) * lg1))

        if qtype == QuestionType.STATEMENT:
            loss = -torch.sum(lp * qmask)
        elif qtype == QuestionType.BINARY:
            loss = bce(lp, arrays["answer_binary"], qmask)
        elif qtype == QuestionType.QUERY:
            opt_mask = arrays["opt_mask"]
            denom = logic.masked_logsumexp(lp, opt_mask, axis=1)
            loss = torch.sum((denom - torch.sum(arrays["answer_opt"] * lp * opt_mask, dim=1))
                             * qmask)
        elif qtype == QuestionType.OBJECT_STATEMENT:
            w = arrays["stmt_weight"] * arrays["opt_mask"] * qmask[:, None]
            loss = bce(lp, arrays["answer_opt"], w)
        else:  # SCENE_GRAPH
            a_w = arrays["attr_weight"] * qmask[:, None, None] * arrays["__obj_mask__"][:, :, None]
            r_w = arrays["rel_weight"] * arrays["pair_mask"][:, :, None] * qmask[:, None, None]
            loss = bce(lp["attr"], arrays["attr_answer"], a_w) + bce(lp["rel"],
                                                                   arrays["rel_answer"], r_w)
        if self.cfg.l1_lambda > 0:
            leaves = list(params.parameters())
            total = sum(torch.sum(torch.abs(p)) for p in leaves)
            loss = loss + self.cfg.l1_lambda * total / max(1, sum(p.numel() for p in leaves))
        return loss

    # ------------------------------------------------------------ public API

    def forward(
        self,
        params: om.OracleParams,
        objects: torch.Tensor,
        obj_mask: torch.Tensor,
        arrays: Dict[str, torch.Tensor],
        spec: BucketSpec,
        is_training: bool = False,
        generator: Optional[torch.Generator] = None,
        modulator_switch: bool = True,
        return_trace: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Execute one compiled batch. ``objects`` may arrive as bf16 (the
        serving transfer dtype), upcast to float32 on the device, or as int8
        (``data/transfer.quantize_objects``): the feature columns are
        dequantized with the per-object scale ``arrays["obj_scale"]`` and
        the geometry columns spliced back in from their unquantized copy
        ``arrays["obj_geom"]``, as in JAX. ``modulator_switch=False`` turns
        the calibrator off and ``return_trace=True`` adds the hop-by-hop
        attentions (see ``execute``)."""
        if objects.dtype == torch.int8:
            deq = objects.float() * arrays["obj_scale"][..., None]
            geom = arrays["obj_geom"]
            objects = torch.cat([deq[..., :-geom.shape[-1]], geom], dim=-1)
        world = self.build_world(
            params, objects.float(), obj_mask, arrays.get("rel_tokens"),
            generator=generator, deterministic=not is_training,
            needs_rel=spec_needs_relations(spec), img_index=arrays.get("img_index"),
        )
        return self.execute(params, world, arrays, spec, is_training, modulator_switch,
                            return_trace)

    def execute(self, params: om.OracleParams, world: World, arrays: Dict[str, torch.Tensor],
                spec: BucketSpec, is_training: bool = False,
                modulator_switch: bool = True,
                return_trace: bool = False) -> Dict[str, torch.Tensor]:
        """Run a compiled batch against a prebuilt World. Returns
        ``log_probability``, ``answer_flags``, ``match`` and ``type``, and
        with ``is_training`` the ``loss`` (summed over the real questions,
        not yet normalised). JAX's jit drops the loss where nothing reads it;
        eager PyTorch would launch its ops on every serving and eval batch.

        The calibrator runs when ``activate_attention_transfer`` is set, the
        params hold one and ``modulator_switch`` is on, except at eval for
        the open terminals ``query_attr``, ``choose_attr`` and
        ``choose_rel`` (``compare`` keeps it), as in JAX.

        ``return_trace=True`` adds ``trace``: per branch, the list of (B, O)
        log-attentions after each of its non-pad slots (``viz.trace_to_dict``
        reads it)."""
        cfg = self.cfg
        qtype = question_type_of(spec.terminal_op)
        open_terminal = spec.terminal_op in ("query_attr", "choose_attr", "choose_rel")
        modulations = None
        if (cfg.activate_attention_transfer and params is not None
                and params.calibrator is not None
                and modulator_switch and (is_training or not open_terminal)):
            modulations = cal.compute_modulations(params.calibrator, self, world, arrays, spec)
        gates = None
        if cfg.trainable_gate and params is not None and params.logic_gates is not None:
            gates = params.logic_gates
        traces = [[] if return_trace else None for _ in spec.grid]
        atts = [self._run_branch(world, arrays, b, grid, gates,
                                 modulations["slots"][b] if modulations else None, traces[b])
                for b, grid in enumerate(spec.grid)]
        hard = (not is_training) and cfg.hard_mode
        arrays = {**arrays, "__obj_mask__": world.obj_mask}  # scene-graph masking
        lp = self._terminal(world, arrays, spec, atts, hard, gates, params,
                            modulations["terminal"] if modulations else None)
        out = self._answers_and_metrics(lp, arrays, spec, qtype)
        if is_training:
            out["loss"] = self._loss(lp, arrays, qtype, params)
        out["type"] = torch.tensor(int(qtype))
        if return_trace:
            out["trace"] = traces
        return out
