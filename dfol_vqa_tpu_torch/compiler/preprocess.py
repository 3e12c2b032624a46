"""Offline GQA preprocessing: semantic annotations -> ∇-FOL programs.

The PyTorch port's own copy of ``dfol_vqa_tpu/compiler/preprocess.py``, which it must not import
(the port imports nothing of the JAX package); it behaves exactly as
that module, and tests/test_torch_host.py holds the two equal.

Reimplements the reference preprocessing pipeline (src/gqa_preprocess.py:
98-398) over the same op_map metadata: rename the 138 GQA semantic ops to
the 16 canonical DFOL ops, extract per-op arguments, fuse
``verify_attr + and -> verify_attrs``, linearise the dependency DAG into
branches, rewrite logical-branch tails, and segregate output files by
terminal op (and optionally program length) — the bucketing that keeps both
the reference batches homogeneous and our executor's compile signatures few.
"""

from __future__ import annotations

import json
import os
import re
from os.path import isdir, isfile, join, splitext
from typing import Dict, List, Optional

from dfol_vqa_tpu_torch.compiler.normalize import normalize

STARTER_OPS = ["select"]
TRACE_CHANGER_OPS = ["relate"]
LOGICAL_OPS = ["and", "or"]

_PAREN_RE = re.compile(r"\((\d|,|\s)+\)|\((-|\s)*\)")


class GQAPreprocessor:
    def __init__(self, op_map: Dict[str, Optional[str]], is_batch_format: bool = True):
        self._op_map = op_map
        self._is_batch_format = is_batch_format

    # ------------------------------------------------------------- per-op arg
    # (reference gqa_preprocess.py:276-361)

    def parse_operation(self, operator: str, argument: str):
        if operator not in self._op_map:
            return None, None
        op = self._op_map[operator]
        if op is None:
            return None, None
        arg = _PAREN_RE.sub("", argument).strip()
        op_tokens = operator.split(" ")
        arg_tokens = arg.split(",")
        method = getattr(self, "_parse_" + op)
        return op, method(op_tokens, arg_tokens)

    def _parse_select(self, op_tokens, arg_tokens):
        return (normalize(arg_tokens[0]),)

    def _parse_filter(self, op_tokens, arg_tokens):
        return (normalize(arg_tokens[0]),)

    def _parse_relate(self, op_tokens, arg_tokens):
        return (normalize(arg_tokens[1]), arg_tokens[2] == "s", normalize(arg_tokens[0]))

    def _parse_query_attr(self, op_tokens, arg_tokens):
        return (normalize(arg_tokens[0]),)

    def _parse_choose_attr(self, op_tokens, arg_tokens):
        toks = arg_tokens[0].split("|")
        return ([normalize(t) for t in toks],)

    def _parse_verify_attr(self, op_tokens, arg_tokens):
        return (normalize(arg_tokens[0]),)

    def _parse_verify_attrs(self, op_tokens, arg_tokens):
        return ([normalize(t) for t in arg_tokens],)

    def _parse_choose_rel(self, op_tokens, arg_tokens):
        rels = [normalize(r) for r in arg_tokens[1].split("|")]
        return (rels, arg_tokens[2] == "s", normalize(arg_tokens[0]))

    def _parse_verify_rel(self, op_tokens, arg_tokens):
        return (normalize(arg_tokens[1]), arg_tokens[2] == "s", normalize(arg_tokens[0]))

    def _parse_exist(self, op_tokens, arg_tokens):
        return ()

    def _parse_and(self, op_tokens, arg_tokens):
        return ()

    def _parse_or(self, op_tokens, arg_tokens):
        return ()

    def _parse_end(self, op_tokens, arg_tokens):
        return ()

    def _parse_all_same(self, op_tokens, arg_tokens):
        return (normalize(arg_tokens[0]),)

    def _parse_all_different(self, op_tokens, arg_tokens):
        return (normalize(arg_tokens[0]),)

    def _parse_two_same(self, op_tokens, arg_tokens):
        return (" ".join(normalize(t) for t in op_tokens[1:]),)

    def _parse_two_different(self, op_tokens, arg_tokens):
        return (" ".join(normalize(t) for t in op_tokens[1:]),)

    def _parse_compare(self, op_tokens, arg_tokens):
        # "compare more/less X" or comparative "Xer" (gqa_preprocess.py:348-361)
        if len(op_tokens) >= 3:
            if normalize(op_tokens[1]) == "more":
                return (normalize(op_tokens[2]), False)
            if normalize(op_tokens[1]) == "less":
                return (normalize(op_tokens[2]), True)
        token = normalize(op_tokens[1])
        if token.endswith("er"):
            token = token[:-2]
            if token.endswith("i"):
                token = token[:-1] + "y"
        return (token, False)

    # -------------------------------------------------------- program rewrite

    def parse_program(self, program: List[dict]):
        ops, args = [], []
        for p in program:
            o, a = self.parse_operation(p["operation"], p["argument"])
            ops.append(o)
            args.append(a)
        return ops, args, [p["dependencies"] for p in program]

    def _compute_op_trace(self, operators, dependencies):
        """gqa_preprocess.py:215-226."""
        trace_id, trace_num = [], -1
        for op, dep in zip(operators, dependencies):
            if op in STARTER_OPS + TRACE_CHANGER_OPS:
                trace_num += 1
                trace_id.append(trace_num)
            else:
                trace_id.append(trace_id[dep[0]])
        return trace_id, trace_num

    def _combine_verify(self, operators, arguments, dependencies, trace):
        """verify_attr+and on the same trace -> verify_attrs
        (gqa_preprocess.py:228-249)."""
        if operators[-1] == "and" and all(
            operators[i] == "verify_attrs" for i in dependencies[-1]
        ):
            if trace[dependencies[-1][0]] == trace[dependencies[-1][1]]:
                first_ind = min(dependencies[-1])
                second_ind = max(dependencies[-1])
                for i, dep in enumerate(dependencies):
                    for j, d in enumerate(dep):
                        if d > first_ind:
                            dependencies[i][j] = d - 1
                arguments[second_ind] = [
                    [arguments[first_ind][0][0], arguments[second_ind][0][0]]
                ]
                del operators[first_ind]
                del arguments[first_ind]
                del dependencies[first_ind]
                del trace[first_ind]
                return operators[:-1], arguments[:-1], dependencies[:-1], trace[:-1]
        return operators, arguments, dependencies, trace

    def _de_branch_program(self, operators, arguments, dependencies):
        """Linearise into branches + last_op (gqa_preprocess.py:251-274)."""
        branch_num, branch_id = -1, []
        for i in range(len(operators) - 1):
            if operators[i] in STARTER_OPS:
                branch_num += 1
                branch_id.append(branch_num)
            elif dependencies[i] is not None and len(dependencies) > 0 and len(dependencies[i]) > 0:
                branch_id.append(branch_id[dependencies[i][0]])
            elif i > 0:
                branch_id.append(branch_id[i - 1])
            else:
                raise ValueError("Operator not recognized.")
        branch_num += 1
        ops = [[] for _ in range(branch_num)]
        for i in range(len(operators) - 1):
            ops[branch_id[i]].append({"operator": operators[i], "arguments": list(arguments[i])})
        return {
            "branches": ops,
            "last_op": {"operator": operators[-1], "arguments": list(arguments[-1])},
        }

    def _fix_logical_branches(self, program):
        """and/or branch tails: drop exist, verify_rel->relate,
        verify_attrs->filter chain (gqa_preprocess.py:197-213)."""
        if program["last_op"]["operator"] in LOGICAL_OPS:
            for i in range(len(program["branches"])):
                br = program["branches"][i]
                if not br:
                    continue
                if br[-1]["operator"] == "exist":
                    program["branches"][i] = br[:-1]
                elif br[-1]["operator"] == "verify_rel":
                    br[-1]["operator"] = "relate"
                elif br[-1]["operator"] == "verify_attrs":
                    args = br[-1]["arguments"]
                    br[-1]["operator"] = "filter"
                    br[-1]["arguments"] = [args[0][0]]
                    for j in range(len(args[0]) - 1):
                        br.append({"operator": "filter", "arguments": [args[0][j + 1]]})
        return program

    # -------------------------------------------------------------- questions

    def parse_question(self, question: dict, discard_global: bool = False) -> Optional[dict]:
        """gqa_preprocess.py:167-190."""
        sem = question["semantic"]
        if discard_global and sem[0]["operation"] == "select" and sem[0]["argument"] == "scene":
            return None
        ops, args, deps = self.parse_program(sem)
        if None in ops or None in args:
            return None
        trace, _ = self._compute_op_trace(ops, deps)
        ops, args, deps, trace = self._combine_verify(ops, args, deps, trace)
        if self._is_batch_format:
            question = dict(question)
            question["program"] = self._fix_logical_branches(
                self._de_branch_program(ops, args, deps)
            )
        else:
            question = dict(question)
            question["operators"] = ops
            question["arguments"] = args
            question["dependencies"] = deps
        question["answer"] = normalize(question.get("answer", ""))
        return question

    # ------------------------------------------------------------------ files

    def preprocess(self, in_file: str, out_file: str, segregate: bool = True,
                   length_segregation: bool = False, discard_global: bool = False):
        """Read GQA question JSON file(s) and write program JSON-lines,
        segregated by terminal op (+length) (gqa_preprocess.py:113-164)."""
        if isdir(in_file):
            file_names = [
                join(in_file, f) for f in sorted(os.listdir(in_file))
                if isfile(join(in_file, f)) and (f.endswith(".json") or f.endswith(".txt"))
            ]
        else:
            file_names = [in_file]
        fname, ext = splitext(out_file)

        for file in file_names:
            output: Dict[str, dict] = {}
            with open(file, "r") as f:
                data = json.load(f)
            for key, value in data.items():
                if not isinstance(value, dict):
                    continue
                q = self.parse_question(value, discard_global)
                if q is None:
                    continue
                q["question_id"] = key
                if segregate:
                    op = q["program"]["last_op"]["operator"] if self._is_batch_format else q["operators"][-1]
                    if length_segregation:
                        op = op + "_" + str(len(q["program"]["branches"][0]))
                    output.setdefault(op, {})[key] = q
                else:
                    output[key] = q

            if segregate:
                for op, value in output.items():
                    with open(fname + "_" + op + ext, "a") as f:
                        for _, v in value.items():
                            f.write(json.dumps(v) + "\n")
            else:
                with open(out_file, "a") as f:
                    for _, v in output.items():
                        f.write(json.dumps(v) + "\n")
