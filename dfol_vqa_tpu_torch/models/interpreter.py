"""The program executor, in PyTorch.

Port of ``dfol_vqa_tpu/models/interpreter.py`` for the serving,
offline-evaluation and training slices:

    scene build (featurizer, oracle caches)  ->  unrolled branch slot updates
        ->  terminal op  ->  answer flags and the loss

The program grid is static per ``BucketSpec`` and runs eagerly. Terminals
ported: ``exist``/``end``, ``verify_rel`` and ``query_attr``; the others
raise ``NotImplementedError``. The relation cache takes one of two routes,
as in JAX: when questions share images (U * 2 <= B, the deduplicated batches
of ``BatchLoader``), ``oracle.rel_cache_shared``, which on a CUDA device
runs the ``pair_mlp`` and ``shared_contract`` kernels; otherwise, per
question, the relation-oracle kernels (``ops/relation_oracle.py``, forward
and, under autograd, backward) when the tensors are on a CUDA device,
``tpu.use_pallas`` is set and ``oracle_output_dim == 1``, and the plain
``oracle.rel_cache`` otherwise. The loss covers the question types of the
ported terminals: STATEMENT, BINARY and QUERY.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dfol_vqa_tpu_torch.compiler.program_compiler import (
    OP_FILTER,
    OP_PAD,
    OP_RELATE,
    OP_SELECT,
    BucketSpec,
)
from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.ontology import GQAOntology
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.models.featurizer import featurize_objects
from dfol_vqa_tpu_torch.ops.cells import filter_update, normalize_over_options, relate_update
from dfol_vqa_tpu_torch import logic
from dfol_vqa_tpu_torch.types import QuestionType, VariableSet, World

QUERY_OPS = ("query_attr", "choose_attr", "choose_rel", "compare")
PORTED_TERMINALS = ("exist", "end", "verify_rel", "query_attr")


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


def _apply_negation_exact(ll: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """When ANY token in the batch is negated, lpn(ll, is_neg, 1) is applied
    to every row — an exp/log round trip for the others too; with none
    negated, no transform. A device-side select: no host sync."""
    shaped = neg.reshape(neg.shape + (1,) * (ll.ndim - neg.ndim))
    any_neg = torch.amax(neg) > 0
    return torch.where(any_neg, logic.log_parametric_not(ll, shaped, 1.0), ll)


def _gather_attr(world: World, tok: torch.Tensor) -> torch.Tensor:
    """attr_ll (U, V+1, O) + img_index, tok (B,) signed -> (B, O), negation
    applied: one (O,)-row gather per question."""
    U, Vp1, O = world.attr_ll.shape
    flat = world.img_index.long() * Vp1 + torch.abs(tok.long())
    ll = world.attr_ll.reshape(U * Vp1, O)[flat].float()
    return _apply_negation_exact(ll, (tok < 0).float())


def _gather_attr_options(world: World, toks: torch.Tensor) -> torch.Tensor:
    """toks (B, K) signed -> (B, K, O) raw (sign NOT applied)."""
    U, Vp1, O = world.attr_ll.shape
    flat = world.img_index.long()[:, None] * Vp1 + torch.abs(toks.long())
    return world.attr_ll.reshape(U * Vp1, O)[flat].float()


def _gather_rel(rel_ll: torch.Tensor, idx: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """rel_ll (B, R, O, O), idx (B,), tok (B,) signed -> (B, O, O)."""
    B = rel_ll.shape[0]
    ll = rel_ll[torch.arange(B, device=rel_ll.device), idx.long()].float()
    return _apply_negation_exact(ll, (tok < 0).float())


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


def _relate_core(subj, obj, ll, obj_mask):
    """EXISTS-quantified arity-2 update (both chains are EXISTS sets)."""
    ones = torch.ones(subj.shape[:-1], dtype=subj.dtype, device=subj.device)
    return relate_update(subj, obj, ll, ones, ones, obj_mask)


def _relate_step(world: World, att, aux, s, ll_rel):
    """Select the new set (token ``aux``, 0 = everything), relate it with the
    running set ``att`` through ``ll_rel``, and keep the new side: the
    subject when ``s == 1``, else the object."""
    x = torch.where((aux != 0)[:, None], _gather_attr(world, aux), 0.0)
    subj = s * x + (1.0 - s) * att
    obj = s * att + (1.0 - s) * x
    subj2, obj2 = _relate_core(subj, obj, ll_rel, world.obj_mask)
    return s * subj2 + (1.0 - s) * obj2


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP: {item})")


class Interpreter:
    """Builds worlds and executes compiled program batches."""

    def __init__(self, cfg: Config, ontology: GQAOntology):
        om.check_supported(cfg)
        if cfg.activate_attention_transfer:
            raise _not_ported("the attention-transfer calibrator", "calibrator queue")
        if cfg.trainable_gate:
            raise _not_ported("trainable_gate (neural logic gates in the executor)",
                              "remaining terminals queue")
        self.cfg = cfg
        self.ont = ontology
        self._rel_gather_cache = None

    def init_params(self, generator: torch.Generator, device="cpu") -> om.OracleParams:
        return om.init_oracle_params(self.cfg, self.ont, generator, device)

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
                                             rel_gather=self._rel_gather_map)
            elif (cfg.tpu.use_pallas and objects.device.type == "cuda"
                    and cfg.oracle_output_dim == 1):
                from dfol_vqa_tpu_torch.ops.relation_oracle import rel_cache_kernel

                rel_ll = rel_cache_kernel(params, attr_in, pos, rel_tokens, cfg, deterministic,
                                          generator=generator)
            else:
                rel_ll = om.rel_cache(params, attr_in, pos, rel_tokens, cfg, generator,
                                      deterministic)
        else:
            R = 1 if rel_tokens is None else rel_tokens.shape[1]
            rel_ll = torch.zeros((B, R, 1, 1), dtype=torch.float32, device=obj_mask.device)
            if rel_tokens is None:
                rel_tokens = torch.zeros((B, R), dtype=torch.int32, device=obj_mask.device)
        cache_dtype = getattr(torch, cfg.tpu.resolve_cache_dtype(int(B)))
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
                    grid: Sequence[int]) -> torch.Tensor:
        """Execute one branch's slot sequence; returns the final (B, O)
        attention. Every slot is gated by ``(tok != 0) * op_mask``, so padded
        slots are exact no-ops."""
        B, O = world.obj_mask.shape
        att = torch.zeros((B, O), dtype=torch.float32, device=world.obj_mask.device)
        for si, opc in enumerate(grid):
            if opc == OP_PAD:
                continue
            m = arrays["op_mask"][:, branch, si]
            tok = arrays["arg_tok"][:, branch, si]
            if opc in (OP_SELECT, OP_FILTER):
                new = filter_update(att, _gather_attr(world, tok))
            else:  # OP_RELATE
                ll_rel = _gather_rel(world.rel_ll, arrays["rel_idx"][:, branch, si], tok)
                new = _relate_step(world, att, arrays["arg_aux"][:, branch, si],
                                   arrays["arg_flag"][:, branch, si][:, None], ll_rel)
            upd = ((tok != 0).float() * m)[:, None]
            att = upd * new + (1.0 - upd) * att
        return att

    # ------------------------------------------------------------- terminals

    def _filter_fanout(self, world, att, options, opt_mask, normalize: bool):
        """Fan-out filter over a (B, K) option axis."""
        ll = _gather_attr_options(world, options)
        ll = normalize_over_options(ll, opt_mask, enabled=normalize and self.cfg.normalize_oracle)
        ll = _apply_negation_exact(ll, (options < 0).float())
        return filter_update(att[:, None, :], ll)

    def _terminal(self, world: World, arrays, spec: BucketSpec, atts, hard: bool):
        """(B,) log probability for BINARY/STATEMENT terminals, (B, K) for
        QUERY ones."""
        term = spec.terminal_op
        mask = world.obj_mask

        def ones(x):
            return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)

        # upstream quirk kept for parity: query_attr delegates without its
        # hard_mode argument, so it always aggregates softly
        if term == "query_attr":
            hard = False

        if term in ("exist", "end"):
            att = atts[0]
            return _log_probability(att, ones(att), mask, hard)

        if term == "query_attr":
            att_k = self._filter_fanout(world, atts[0], arrays["options"], arrays["opt_mask"],
                                        normalize=True)
            return _log_probability(att_k, ones(att_k), mask, hard)

        if term == "verify_rel":
            ll = _gather_rel(world.rel_ll, arrays["last_rel_idx"], arrays["last_tok"])
            final = _relate_step(world, atts[0], arrays["last_aux"],
                                 arrays["last_flag"][:, None], ll)
            return _log_probability(final, ones(final), mask, hard)

        raise _not_ported(f"terminal {term!r}", "remaining terminals queue")

    # ---------------------------------------------------------------- output

    def _answers_and_metrics(self, lp, arrays, spec: BucketSpec, qtype: QuestionType):
        """Answer flags + accuracy match, on the device. QUERY tie rule:
        every option whose exp(lp) equals the max and exceeds
        ``likelihood_threshold`` is an answer, credited 1/|ties| (or the
        first flagged option when ``first_answer``)."""
        cfg = self.cfg
        out: Dict[str, torch.Tensor] = {"log_probability": lp}
        if qtype == QuestionType.QUERY:
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
        elif qtype in (QuestionType.BINARY, QuestionType.STATEMENT):
            pred_yes = torch.exp(lp) > 0.5
            target = arrays["answer_binary"] > 0.5
            out["answer_flags"] = pred_yes[:, None]
            out["match"] = (pred_yes == target).float()
        else:
            raise _not_ported(f"{qtype.name} answers", "remaining terminals queue")
        return out

    def _loss(self, lp, arrays, qtype: QuestionType, params: om.OracleParams) -> torch.Tensor:
        """Per-question-type loss summed over the batch's real questions
        (``interpreter._loss``): STATEMENT -sum(lp), BINARY the BCE terms,
        QUERY the grouped softmax cross-entropy over each question's options;
        plus the ``l1_lambda`` term (mean absolute parameter value)."""
        qmask = arrays["question_mask"]
        if qtype == QuestionType.STATEMENT:
            loss = -torch.sum(lp * qmask)
        elif qtype == QuestionType.BINARY:
            t = arrays["answer_binary"]
            lg, lg1 = _bce_terms(lp)
            loss = -torch.sum((t * lg + (1.0 - t) * lg1) * qmask)
        elif qtype == QuestionType.QUERY:
            opt_mask = arrays["opt_mask"]
            denom = logic.masked_logsumexp(lp, opt_mask, axis=1)
            loss = torch.sum((denom - torch.sum(arrays["answer_opt"] * lp * opt_mask, dim=1))
                             * qmask)
        else:
            raise _not_ported(f"the {qtype.name} loss", "remaining terminals queue")
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
    ) -> Dict[str, torch.Tensor]:
        """Execute one compiled batch. ``objects`` may arrive as bf16 (the
        serving transfer dtype); it is upcast to float32 on the device."""
        if objects.dtype == torch.int8:
            raise _not_ported("int8 object transfer", "queue 1, device transfer")
        world = self.build_world(
            params, objects.float(), obj_mask, arrays.get("rel_tokens"),
            generator=generator, deterministic=not is_training,
            needs_rel=spec_needs_relations(spec), img_index=arrays.get("img_index"),
        )
        return self.execute(params, world, arrays, spec, is_training)

    def execute(self, params: om.OracleParams, world: World, arrays: Dict[str, torch.Tensor],
                spec: BucketSpec, is_training: bool = False) -> Dict[str, torch.Tensor]:
        """Run a compiled batch against a prebuilt World. Returns
        ``log_probability``, ``answer_flags``, ``match`` and ``type``, and
        with ``is_training`` the ``loss`` (summed over the real questions,
        not yet normalised). JAX's jit drops the loss where nothing reads it;
        eager PyTorch would launch its ops on every serving and eval batch."""
        if spec.terminal_op not in PORTED_TERMINALS:
            raise _not_ported(f"terminal {spec.terminal_op!r}", "remaining terminals queue")
        qtype = question_type_of(spec.terminal_op)
        atts = [self._run_branch(world, arrays, b, grid) for b, grid in enumerate(spec.grid)]
        hard = (not is_training) and self.cfg.hard_mode
        lp = self._terminal(world, arrays, spec, atts, hard)
        out = self._answers_and_metrics(lp, arrays, spec, qtype)
        if is_training:
            out["loss"] = self._loss(lp, arrays, qtype, params)
        out["type"] = torch.tensor(int(qtype))
        return out
