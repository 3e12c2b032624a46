"""Ahead-of-time program compiler: FOL program JSON -> fixed-shape tensors.

The PyTorch port's own copy of ``dfol_vqa_tpu/compiler/program_compiler.py``, which it must not import
(the port imports nothing of the JAX package); it behaves exactly as
that module, and tests/test_torch_host.py holds the two equal.

This is the TPU-native replacement for the reference's runtime collation
pipeline (src/nsvqa/data/data_pipeline.py:626-783 ProgramCollaterBase +
OperatorBatch). Where the reference builds ragged Python argument lists,
string-keyed op dispatch and on-the-fly sparse predicate↔question maps per
batch, we compile each batch ONCE into dense int32/float32 arrays executed
by a single jit-compiled function per static bucket signature.

Key ideas:

  * Grid alignment. A batch of same-terminal programs is aligned into a
    fixed per-branch op grid — one `select` starter, then alternating
    `filter` filler slots and `relate` separator slots with per-question
    masks — the exact alignment algorithm of collate_programs
    (data_pipeline.py:647-746). The resulting slot-op sequence is *static*
    (part of the bucket signature), so the executor unrolls it with no
    dynamic dispatch.
  * Static name tracking. The "name" of the running variable set (used by
    query_attr/all_same/... to expand `name`/`type` categories,
    batch_gqa_ops.py:304-306) is a pure function of the program: select and
    relate set it from their arguments, filter keeps it. The compiler tracks
    it and expands all option lists AT COMPILE TIME into a padded (B, K)
    option-token matrix.
  * Per-question relation tables. Each question references at most a few
    relations (branch relate slots + relation options). The compiler packs
    their token codes into a small (B, R) table; the oracle scores exactly
    those (world.rel_ll is (B, O, O, R)) and relate slots address the cache
    by table index.

Token codes are the ontology's signed 1-based codes (negative = negated),
byte-compatible with the reference HDF5 program encoding
(gqa_preprocess.py:51-94).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dfol_vqa_tpu_torch.ontology import GQAOntology

# slot op codes
OP_PAD, OP_SELECT, OP_FILTER, OP_RELATE = 0, 1, 2, 3
_OP_NAMES = {OP_PAD: "pad", OP_SELECT: "select", OP_FILTER: "filter", OP_RELATE: "relate"}

TERMINAL_OPS = (
    "exist",
    "verify_attrs",
    "verify_rel",
    "query_attr",
    "choose_attr",
    "choose_rel",
    "and",
    "or",
    "all_same",
    "all_different",
    "two_same",
    "two_different",
    "compare",
    "end",
)

# direct scene-graph supervision terminals (batch_gqa_ops.py:787-902)
SUPERVISION_OPS = ("object_attr", "object_rel", "scene")

TWO_BRANCH_OPS = ("and", "or", "two_same", "two_different", "compare")

YES_ANSWERS = ("yes", "yeah", "yep", "yup", "aye", "yea")  # trainer.py:188


@dataclass(frozen=True)
class BucketSpec:
    """Static (hashable) shape signature of a compiled batch; one XLA
    compilation per distinct spec."""

    terminal_op: str
    grid: Tuple[Tuple[int, ...], ...]  # per-branch slot op codes
    n_options: int  # K (0 = no option axis)
    rel_slots: int  # R
    object_num: int
    batch_size: int
    n_pairs: int = 0  # listed-pair axis (scene supervision)

    @property
    def n_branch(self) -> int:
        return len(self.grid)

    @property
    def branch_len(self) -> int:
        return max((len(g) for g in self.grid), default=0)


@dataclass
class CompiledBatch:
    """Dense program tensors + host-side metadata for one batch."""

    # branch grid tensors, shape (B, n_branch, L)
    op_mask: np.ndarray
    arg_tok: np.ndarray  # signed token (select noun / filter attr / relate rel)
    arg_aux: np.ndarray  # relate: new-select noun token (0 = entity/'_')
    arg_flag: np.ndarray  # relate: is_subject
    rel_idx: np.ndarray  # relate: index into rel_tokens
    # per-question relation table, (B, R) unsigned
    rel_tokens: np.ndarray
    # terminal arguments
    options: np.ndarray  # (B, K) signed tokens (0 pad); empty (B, 0) if K=0
    opt_mask: np.ndarray  # (B, K)
    opt_rel_idx: np.ndarray  # (B, K) rel-table index (choose_rel)
    last_tok: np.ndarray  # (B,) signed (verify_rel relation / compare attr)
    last_aux: np.ndarray  # (B,) signed (verify_rel/choose_rel select attr)
    last_flag: np.ndarray  # (B,) is_subject / is_less
    last_rel_idx: np.ndarray  # (B,)
    # supervision
    answer_binary: np.ndarray  # (B,) 1.0 = yes
    answer_opt: np.ndarray  # (B, K) loss target per option (exact match)
    question_mask: np.ndarray  # (B,) 0 for padding rows
    answer_match: Optional[np.ndarray] = None  # (B, K) substring accuracy credit
    # direct scene-graph supervision (object_attr / object_rel / scene)
    stmt_obj: Optional[np.ndarray] = None  # (B, K) object (or subject) index
    stmt_obj2: Optional[np.ndarray] = None  # (B, K) pair object index
    stmt_weight: Optional[np.ndarray] = None  # (B, K) per-statement weight
    pair_idx: Optional[np.ndarray] = None  # (B, P, 2)
    pair_mask: Optional[np.ndarray] = None  # (B, P)
    attr_answer: Optional[np.ndarray] = None  # (B, O, V_attr)
    attr_weight: Optional[np.ndarray] = None  # (B, O, V_attr)
    rel_answer: Optional[np.ndarray] = None  # (B, P, V_rel)
    rel_weight: Optional[np.ndarray] = None  # (B, P, V_rel)
    # host metadata
    image_ids: List[str] = field(default_factory=list)
    question_ids: List[Optional[str]] = field(default_factory=list)
    answers: List[Optional[str]] = field(default_factory=list)
    option_strings: List[List[str]] = field(default_factory=list)
    names: List[List[str]] = field(default_factory=list)  # tracked per branch
    questions: List[Optional[str]] = field(default_factory=list)
    original: Optional[List[dict]] = None


def _norm_arg(a) -> Optional[str]:
    if a is None:
        return None
    if isinstance(a, bool):
        return a
    return str(a).lower().strip()


def _is_blank(a) -> bool:
    return a is None or (isinstance(a, str) and a.strip() in ("", "_", "scene"))


def _name_after_select(arg) -> str:
    return "entity" if _is_blank(arg) else str(arg)


def _pad_ladder(n: int, ladder: Sequence[int]) -> int:
    for v in ladder:
        if n <= v:
            return v
    return n


class ProgramCompiler:
    """Compiles batches of ∇-FOL program dicts into CompiledBatch tensors.

    (The supervision-terminal compilation is attached from _SupervisionMixin
    at the bottom of this module.)"""

    def __init__(
        self,
        ontology: GQAOntology,
        object_num: int,
        rel_slots: int = 8,
        option_pad_ladder: Sequence[int] = (2, 4, 8, 16, 32, 64, 128, 192),
        shuffle_choose: bool = False,
        seed: int = 0,
    ):
        self._ont = ontology
        self._object_num = object_num
        self._rel_slots = rel_slots
        self._ladder = tuple(option_pad_ladder)
        self._shuffle_choose = shuffle_choose
        self._rng = np.random.default_rng(seed)

    # -------------------------------------------------------- grid alignment

    def _align_grid(self, branches: List[List[dict]], n_branch: int):
        """Reference collate_programs alignment (data_pipeline.py:647-746).

        Returns per-branch (slot_ops, per-question slot assignments), where
        each question's ops map onto the shared slot sequence."""
        B = len(branches)  # questions
        per_branch = []
        for i in range(n_branch):
            # per-question op lists for this branch
            qops = [b[i] if i < len(b) else [] for b in branches]
            # build filler/separator structure
            filler_list: List[List[List[Optional[dict]]]] = []  # [sep][filler] -> per-q args
            sep_list: List[List[Optional[dict]]] = []
            for k, ops in enumerate(qops):
                filler_ind, sep_ind = 0, 0
                for op in ops[1:]:
                    if op["operator"] == "filter":
                        while sep_ind >= len(filler_list):
                            filler_list.append([])
                        if filler_ind >= len(filler_list[sep_ind]):
                            filler_list[sep_ind].append([None] * B)
                        filler_list[sep_ind][filler_ind][k] = op
                        filler_ind += 1
                    elif op["operator"] == "relate":
                        if sep_ind >= len(sep_list):
                            sep_list.append([None] * B)
                        sep_list[sep_ind][k] = op
                        sep_ind += 1
                        filler_ind = 0
                    else:
                        raise ValueError(f"non filler/separator op in branch: {op['operator']}")
            # interleave: fillers of segment n, then separator n
            slots: List[Tuple[int, List[Optional[dict]]]] = []
            select_args = [
                ops[0] if ops and ops[0]["operator"] == "select" else {"operator": "select", "arguments": ["_"]}
                for ops in qops
            ]
            slots.append((OP_SELECT, select_args))
            t = max(len(sep_list), len(filler_list))
            for n in range(t):
                if len(filler_list) > n:
                    for d in filler_list[n]:
                        slots.append((OP_FILTER, d))
                if len(sep_list) > n:
                    slots.append((OP_RELATE, sep_list[n]))
            per_branch.append(slots)
        return per_branch

    # ------------------------------------------------------------- main entry

    def compile(self, questions: List[dict], keep_original: bool = False) -> Tuple[BucketSpec, CompiledBatch]:
        """Compile a homogeneous-terminal batch of question dicts.

        Each question dict follows the reference program format
        (gqa_preprocess.py:251-274): ``{'program': {'branches': [[op,...]],
        'last_op': {...}}, 'answer', 'imageId', ...}``."""
        B = len(questions)
        assert B > 0
        terminal = questions[0]["program"]["last_op"]["operator"]
        for q in questions:
            assert q["program"]["last_op"]["operator"] == terminal, (
                "batch must be terminal-homogeneous (bucketed files guarantee this)"
            )
        if terminal in SUPERVISION_OPS:
            return self._compile_supervision(questions, terminal, keep_original)
        if terminal in ("select", "filter", "relate"):
            # non-terminal last op: fold it into the branch and auto-append
            # `end` (the reference interpreter does this at runtime,
            # batch_gqa_interpreter.py:75-77)
            new_qs = []
            for q in questions:
                q = dict(q)
                prog = {
                    "branches": [list(b) for b in q["program"]["branches"]],
                    "last_op": {"operator": "end", "arguments": []},
                }
                last = q["program"]["last_op"]
                if last["operator"] == "select" or not prog["branches"]:
                    prog["branches"].append([dict(last)] if last["operator"] == "select"
                                            else [{"operator": "select", "arguments": ["_"]},
                                                  dict(last)])
                else:
                    prog["branches"][0] = prog["branches"][0] + [dict(last)]
                q["program"] = prog
                new_qs.append(q)
            questions = new_qs
            terminal = "end"
        n_branch = 2 if terminal in TWO_BRANCH_OPS else 1

        branches = [q["program"]["branches"] for q in questions]
        per_branch_slots = self._align_grid(branches, n_branch)

        L = max(len(s) for s in per_branch_slots)
        grid = tuple(
            tuple(op for op, _ in slots) + (OP_PAD,) * (L - len(slots))
            for slots in per_branch_slots
        )

        op_mask = np.zeros((B, n_branch, L), np.float32)
        arg_tok = np.zeros((B, n_branch, L), np.int32)
        arg_aux = np.zeros((B, n_branch, L), np.int32)
        arg_flag = np.zeros((B, n_branch, L), np.float32)
        rel_idx = np.zeros((B, n_branch, L), np.int32)

        # per-question relation tables + name tracking
        rel_tables: List[Dict[int, int]] = [dict() for _ in range(B)]
        names = [["entity"] * n_branch for _ in range(B)]

        def rel_slot_of(q: int, token: int) -> int:
            tab = rel_tables[q]
            t = abs(int(token))
            if t not in tab:
                tab[t] = len(tab)
            return tab[t]

        for bi, slots in enumerate(per_branch_slots):
            for si, (op, qargs) in enumerate(slots):
                for qi, a in enumerate(qargs):
                    if a is None:
                        continue
                    args = a["arguments"]
                    if op == OP_SELECT:
                        arg = _norm_arg(args[0]) if args else None
                        names[qi][bi] = _name_after_select(arg)
                        if _is_blank(arg):
                            continue  # select('_') = fresh set, no filter
                        tok = self._ont.try_encode_token(arg)
                        op_mask[qi, bi, si] = 1.0
                        arg_tok[qi, bi, si] = tok or 0
                    elif op == OP_FILTER:
                        arg = _norm_arg(args[0]) if args else None
                        if _is_blank(arg):
                            continue
                        tok = self._ont.try_encode_token(arg)
                        if tok is None:
                            continue
                        op_mask[qi, bi, si] = 1.0
                        arg_tok[qi, bi, si] = tok
                    elif op == OP_RELATE:
                        # relate(relation, is_subject, select_attr)
                        rel = _norm_arg(args[0])
                        is_subject = bool(args[1])
                        attr = _norm_arg(args[2]) if len(args) > 2 else None
                        names[qi][bi] = _name_after_select(attr)
                        tok = self._ont.try_encode_token(rel) if rel is not None else None
                        if tok is None:
                            continue
                        op_mask[qi, bi, si] = 1.0
                        arg_tok[qi, bi, si] = tok
                        arg_flag[qi, bi, si] = 1.0 if is_subject else 0.0
                        rel_idx[qi, bi, si] = rel_slot_of(qi, tok)
                        if not _is_blank(attr):
                            aux = self._ont.try_encode_token(attr)
                            arg_aux[qi, bi, si] = aux or 0

        # ---------------------------------------------------------- terminal
        last_tok = np.zeros((B,), np.int32)
        last_aux = np.zeros((B,), np.int32)
        last_flag = np.zeros((B,), np.float32)
        last_rel_idx = np.zeros((B,), np.int32)
        option_lists: List[List[str]] = [[] for _ in range(B)]
        opt_rel_lists: List[List[int]] = [[] for _ in range(B)]

        for qi, q in enumerate(questions):
            args = q["program"]["last_op"]["arguments"]
            if terminal in ("query_attr", "all_same", "all_different", "two_same", "two_different"):
                category = _norm_arg(args[0])
                opts = self._ont.query(
                    category if category not in ("name", "type") else names[qi][0]
                )
                option_lists[qi] = [o for o in opts if o is not None]
            elif terminal == "choose_attr":
                opts = list(args[0])
                if self._shuffle_choose:
                    self._rng.shuffle(opts)
                option_lists[qi] = [_norm_arg(o) for o in opts]
            elif terminal == "choose_rel":
                opts = list(args[0])
                if self._shuffle_choose:
                    self._rng.shuffle(opts)
                option_lists[qi] = [_norm_arg(o) for o in opts]
                last_flag[qi] = 1.0 if bool(args[1]) else 0.0
                attr = _norm_arg(args[2]) if len(args) > 2 else None
                if not _is_blank(attr):
                    last_aux[qi] = self._ont.try_encode_token(attr) or 0
                for o in option_lists[qi]:
                    tok = self._ont.try_encode_token(o)
                    opt_rel_lists[qi].append(rel_slot_of(qi, tok) if tok else 0)
            elif terminal == "verify_attrs":
                option_lists[qi] = [_norm_arg(o) for o in args[0]]
            elif terminal == "verify_rel":
                rel = _norm_arg(args[0])
                tok = self._ont.try_encode_token(rel)
                last_tok[qi] = tok or 0
                last_flag[qi] = 1.0 if bool(args[1]) else 0.0
                if tok:
                    last_rel_idx[qi] = rel_slot_of(qi, tok)
                attr = _norm_arg(args[2]) if len(args) > 2 else None
                if not _is_blank(attr):
                    last_aux[qi] = self._ont.try_encode_token(attr) or 0
            elif terminal == "compare":
                attr = _norm_arg(args[0])
                last_tok[qi] = self._ont.try_encode_token(attr) or 0
                last_flag[qi] = 1.0 if (len(args) > 1 and bool(args[1])) else 0.0
                option_lists[qi] = [names[qi][0], names[qi][1]]
            # exist/and/or/end: no terminal args

        K_raw = max((len(o) for o in option_lists), default=0)
        K = _pad_ladder(K_raw, self._ladder) if K_raw > 0 else 0
        if terminal == "compare":
            K = 2

        options = np.zeros((B, K), np.int32)
        opt_mask = np.zeros((B, K), np.float32)
        opt_rel_idx = np.zeros((B, K), np.int32)
        answer_opt = np.zeros((B, K), np.float32)
        answer_match = np.zeros((B, K), np.float32)
        answer_binary = np.zeros((B,), np.float32)

        answers: List[Optional[str]] = []
        for qi, q in enumerate(questions):
            ans = q.get("answer")
            ans = transform_answer(terminal, ans)
            answers.append(ans)
            for k, o in enumerate(option_lists[qi]):
                tok = self._ont.try_encode_token(o)
                options[qi, k] = tok or 0
                opt_mask[qi, k] = 1.0
                if opt_rel_lists[qi]:
                    opt_rel_idx[qi, k] = opt_rel_lists[qi][k]
                if ans is not None and str(o) == ans:
                    answer_opt[qi, k] = 1.0
                # accuracy credit uses the reference's SUBSTRING match rule
                # (`a in o`, trainer.py:285-293); the loss target above stays
                # exact equality (trainer.py:212)
                if ans is not None and ans in str(o):
                    answer_match[qi, k] = 1.0
            if ans is not None:
                answer_binary[qi] = 1.0 if ans in YES_ANSWERS else 0.0

        R = max(self._rel_slots, max((len(t) for t in rel_tables), default=1), 1)
        rel_tokens = np.zeros((B, R), np.int32)
        for qi, tab in enumerate(rel_tables):
            for tok, slot in tab.items():
                rel_tokens[qi, slot] = tok

        spec = BucketSpec(
            terminal_op=terminal,
            grid=grid,
            n_options=K,
            rel_slots=R,
            object_num=self._object_num,
            batch_size=B,
        )
        batch = CompiledBatch(
            op_mask=op_mask,
            arg_tok=arg_tok,
            arg_aux=arg_aux,
            arg_flag=arg_flag,
            rel_idx=rel_idx,
            rel_tokens=rel_tokens,
            options=options,
            opt_mask=opt_mask,
            opt_rel_idx=opt_rel_idx,
            last_tok=last_tok,
            last_aux=last_aux,
            last_flag=last_flag,
            last_rel_idx=last_rel_idx,
            answer_binary=answer_binary,
            answer_opt=answer_opt,
            answer_match=answer_match,
            question_mask=np.ones((B,), np.float32),
            image_ids=[q.get("imageId") for q in questions],
            question_ids=[q.get("question_id") for q in questions],
            answers=answers,
            option_strings=[[str(o) for o in ol] for ol in option_lists],
            names=names,
            questions=[q.get("question") for q in questions],
            original=questions if keep_original else None,
        )
        return spec, batch


def _empty_batch_fields(B: int, K: int) -> dict:
    return dict(
        op_mask=np.zeros((B, 1, 1), np.float32),
        arg_tok=np.zeros((B, 1, 1), np.int32),
        arg_aux=np.zeros((B, 1, 1), np.int32),
        arg_flag=np.zeros((B, 1, 1), np.float32),
        rel_idx=np.zeros((B, 1, 1), np.int32),
        rel_tokens=np.zeros((B, 1), np.int32),
        options=np.zeros((B, K), np.int32),
        opt_mask=np.zeros((B, K), np.float32),
        opt_rel_idx=np.zeros((B, K), np.int32),
        last_tok=np.zeros((B,), np.int32),
        last_aux=np.zeros((B,), np.int32),
        last_flag=np.zeros((B,), np.float32),
        last_rel_idx=np.zeros((B,), np.int32),
        answer_binary=np.zeros((B,), np.float32),
        answer_opt=np.zeros((B, K), np.float32),
        answer_match=np.zeros((B, K), np.float32),
        question_mask=np.ones((B,), np.float32),
    )


class _SupervisionMixin:
    """Compilation of the direct scene-graph supervision terminals.

    Data contracts follow the reference collation (data_pipeline.py:593-622,
    batch_gqa_boxfeatures_pipeline.py:93-155):
      object_attr: last_op arguments [per-object attr-list list]; question
        carries 'answer' (list-of-lists of yes/no) and 'weights';
      object_rel: arguments [relation list]; question carries 'object_pairs'
        {'subject_id', 'object_id'}, 'answer', optional 'weights';
      scene: question carries 'attribute_dict' {obj: [(attr, w)...]},
        'relation_list' [(rel, w)...] and 'object_pairs'.
    """

    def _compile_supervision(self, questions: List[dict], terminal: str, keep_original: bool):
        B = len(questions)
        ont = self._ont

        if terminal in ("object_attr", "object_rel"):
            stmts: List[List[tuple]] = []  # (tok, obj, obj2, target, weight)
            for q in questions:
                rows = []
                weights = q.get("weights")
                if terminal == "object_attr":
                    groups = q["program"]["last_op"]["arguments"][0]
                    answers = q.get("answer") or []
                    flat_ans = [a for sub in answers for a in (sub if isinstance(sub, list) else [sub])]
                    w_i = 0
                    for obj_i, attrs in enumerate(groups):
                        for a in attrs:
                            tok = ont.try_encode_token(a)
                            tgt = 1.0 if (w_i < len(flat_ans) and str(flat_ans[w_i]).lower() in YES_ANSWERS) else 0.0
                            w = weights[w_i] if weights and w_i < len(weights) else 1.0
                            if tok:
                                rows.append((tok, obj_i, 0, tgt, w))
                            w_i += 1
                else:
                    rels = q["program"]["last_op"]["arguments"][0]
                    pairs = q.get("object_pairs", {})
                    subs = pairs.get("subject_id", [])
                    objs = pairs.get("object_id", [])
                    answers = q.get("answer") or []
                    flat_ans = [a for sub in answers for a in (sub if isinstance(sub, list) else [sub])]
                    for i, r in enumerate(rels):
                        tok = ont.try_encode_token(r)
                        tgt = 1.0 if (i < len(flat_ans) and str(flat_ans[i]).lower() in YES_ANSWERS) else 0.0
                        w = weights[i] if weights and i < len(weights) else 1.0
                        if tok and i < len(subs) and i < len(objs):
                            rows.append((tok, subs[i], objs[i], tgt, w))
                stmts.append(rows)

            K = _pad_ladder(max((len(s) for s in stmts), default=1), self._ladder)
            f = _empty_batch_fields(B, K)
            stmt_obj = np.zeros((B, K), np.int32)
            stmt_obj2 = np.zeros((B, K), np.int32)
            stmt_weight = np.zeros((B, K), np.float32)
            for qi, rows in enumerate(stmts):
                for k, (tok, o1, o2, tgt, w) in enumerate(rows[:K]):
                    f["options"][qi, k] = tok
                    f["opt_mask"][qi, k] = 1.0
                    f["answer_opt"][qi, k] = tgt
                    stmt_obj[qi, k] = o1
                    stmt_obj2[qi, k] = o2
                    stmt_weight[qi, k] = w

            spec = BucketSpec(terminal, ((OP_PAD,),), K, 1, self._object_num, B)
            batch = CompiledBatch(
                **f, stmt_obj=stmt_obj, stmt_obj2=stmt_obj2, stmt_weight=stmt_weight,
                image_ids=[q.get("imageId") for q in questions],
                question_ids=[q.get("question_id") for q in questions],
                answers=[None] * B,
                option_strings=[[] for _ in range(B)],
                questions=[q.get("question") for q in questions],
                original=questions if keep_original else None,
            )
            return spec, batch

        # ---- scene: dense per-object attribute targets + listed-pair rels
        Va = len(ont._attribute_index)
        Vr = len(ont._relation_index)
        O = self._object_num
        pair_lists = []
        for q in questions:
            pairs = q.get("object_pairs", {})
            subs, objs = pairs.get("subject_id", []), pairs.get("object_id", [])
            pair_lists.append(list(zip(subs, objs)))
        P = _pad_ladder(max((len(p) for p in pair_lists), default=1), self._ladder)

        f = _empty_batch_fields(B, 0)
        attr_answer = np.zeros((B, O, Va), np.float32)
        attr_weight = np.zeros((B, O, Va), np.float32)
        rel_answer = np.zeros((B, P, Vr), np.float32)
        rel_weight = np.zeros((B, P, Vr), np.float32)
        pair_idx = np.zeros((B, P, 2), np.int32)
        pair_mask = np.zeros((B, P), np.float32)

        noun_sub = list(ont._noun_subindex)
        for qi, q in enumerate(questions):
            # attributes (batch_gqa_boxfeatures_pipeline.py:103-130)
            for obj_s, att_list in (q.get("attribute_dict") or {}).items():
                obj_i = int(obj_s)
                if obj_i >= O:
                    continue
                w_ind = set(noun_sub)
                for a, w in att_list:
                    if a in ont._arg_to_idx and a in set(ont._attributes):
                        j = ont._attribute_reversed_index[ont._arg_to_idx[a] - 1]
                        attr_answer[qi, obj_i, j] = 1.0
                        attr_weight[qi, obj_i, j] = w
                        w_ind |= set(ont.get_family_subindex(a))
                rest = list(w_ind)
                mask_vals = attr_weight[qi, obj_i, rest]
                attr_weight[qi, obj_i, rest] = np.where(mask_vals == 0, 1.0, mask_vals)
            # relations (…:132-155): weight defaults to 1 everywhere
            for pi, (s, o) in enumerate(pair_lists[qi][:P]):
                pair_idx[qi, pi] = (s, o)
                pair_mask[qi, pi] = 1.0
                rel_weight[qi, pi, :] = 1.0
            for pi, (rel, w) in enumerate(q.get("relation_list") or []):
                if pi >= P:
                    break
                if rel in ont._arg_to_idx and rel in ont._relation_set:
                    j = ont._relation_reversed_index[ont._arg_to_idx[rel] - 1]
                    rel_answer[qi, pi, j] = 1.0
                    rel_weight[qi, pi, j] = w

        spec = BucketSpec("scene", ((OP_PAD,),), 0, 1, O, B, n_pairs=P)
        batch = CompiledBatch(
            **f, pair_idx=pair_idx, pair_mask=pair_mask,
            attr_answer=attr_answer, attr_weight=attr_weight,
            rel_answer=rel_answer, rel_weight=rel_weight,
            image_ids=[q.get("imageId") for q in questions],
            question_ids=[q.get("question_id") for q in questions],
            answers=[None] * B,
            option_strings=[[] for _ in range(B)],
            questions=[q.get("question") for q in questions],
            original=questions if keep_original else None,
        )
        return spec, batch


ProgramCompiler._compile_supervision = _SupervisionMixin._compile_supervision


def transform_answer(op_name: str, answer) -> Optional[str]:
    """Answer canonicalisation (data_pipeline.py:571-591)."""
    if answer is None:
        return None
    if isinstance(answer, (list, tuple)):
        return None  # object-level supervision answers handled separately
    res = str(answer).lower().strip()
    if op_name == "choose_rel":
        if res == "left":
            res = "to the left of"
        elif res == "right":
            res = "to the right of"
    return res


def batch_arrays(batch: CompiledBatch) -> Dict[str, np.ndarray]:
    """The device-transferable subset of a CompiledBatch, as a flat dict."""
    out = {}
    for f in dataclasses.fields(CompiledBatch):
        v = getattr(batch, f.name)
        if isinstance(v, np.ndarray):
            out[f.name] = v
    return out


def pack_meta(arrays: Dict[str, np.ndarray]) -> Tuple:
    """Static packing descriptor: ((key, shape, dtype, offset), ..., total).

    The JAX package packs the ~17 small program tensors of a batch into ONE
    int32 buffer with it (``pack_arrays``), as one host->device RPC each
    would cost much on tunneled/remote TPU frontends, and unpacks it inside
    jit. The port transfers the arrays one by one and packs nothing: it
    keeps the descriptor as the batch's ``meta``, which keys its steps and
    graphs."""
    meta = []
    off = 0
    for k in sorted(arrays):
        v = arrays[k]
        assert v.dtype.itemsize == 4, (k, v.dtype)
        n = int(np.prod(v.shape)) if v.size else 0
        meta.append((k, tuple(v.shape), str(v.dtype), off))
        off += n
    return tuple(meta) + ((off,),)
