"""Program schema + vocabulary validator for externally-produced programs.

The PyTorch port's own copy of ``dfol_vqa_tpu/compiler/verifier.py``, which it must not import
(the port imports nothing of the JAX package); it behaves exactly as
that module, and tests/test_torch_host.py holds the two equal.

Reference analog: GQAProgramVerifier (src/nsvqa/nn/parser/parse_utils.py:
26-240). Validates branch shapes (select-first, filter/relate-only bodies,
1-vs-2 branches by terminal op), per-op argument arity, and vocabulary
membership.
"""

from __future__ import annotations

from dfol_vqa_tpu_torch.ontology import GQAOntology, is_negated_token, strip_negation

TWO_BRANCH = ("and", "or", "two_same", "two_different", "compare")
NON_TERMINAL = ("select", "filter", "relate")
CATEGORY_OPS = ("query_attr", "all_same", "all_different", "two_same", "two_different")


class ParserError(Exception):
    pass


class GQAProgramVerifier:
    def __init__(self, ontology: GQAOntology):
        self._ont = ontology

    def _norm(self, token: str) -> str:
        return strip_negation(str(token))

    def _is_valid(self, arg) -> bool:
        return self._norm(arg).lower() in self._ont._arg_to_idx

    def _check_argument_num(self, op: str, arg_num: int, args: list):
        if len(args) != arg_num:
            raise ParserError(
                f"'{op}' must have {arg_num} argument(s), but has {len(args)} argument(s)."
            )

    def _check_category(self, op: str, arg):
        if (
            arg not in self._ont._class_dict
            and arg not in self._ont._attribute_dict
            and arg not in ("name", "type")
        ):
            raise ParserError(f"'{op}' has an unknown category argument: {arg}")

    def _check_relation_triple(self, op: str, args: list):
        self._check_argument_num(op, 3, args)
        rels = args[0] if isinstance(args[0], list) else [args[0]]
        if not rels:
            raise ParserError(f"'{op}' must at least have one relation.")
        for r in rels:
            if not self._ont.is_relation(self._norm(r).lower()):
                raise ParserError(f"'{op}' first argument must be a relation: {r}")
        if not isinstance(args[1], bool):
            raise ParserError(
                f"'{op}' second argument must be a boolean. Current type: {type(args[1])}"
            )
        tgt = self._norm(args[2]).lower()
        if tgt not in ("_", "scene") and not self._is_valid(tgt):
            raise ParserError(f"'{op}' third argument is not in the vocabulary: {args[2]}")

    # per-op checks (parse_utils.py:56-193)

    def _verify_select(self, args):
        self._check_argument_num("select", 1, args)
        a = self._norm(args[0]).lower()
        if a not in ("_", "scene") and not self._is_valid(a):
            raise ParserError("'select' argument must be a noun: " + str(args[0]))

    def _verify_filter(self, args):
        self._check_argument_num("filter", 1, args)
        if not self._is_valid(args[0]):
            raise ParserError("'filter' argument is not in the vocabulary: " + str(args[0]))

    def _verify_relate(self, args):
        self._check_relation_triple("relate", args)

    def _verify_query_attr(self, args):
        self._check_argument_num("query_attr", 1, args)
        self._check_category("query_attr", args[0])

    def _verify_choose_attr(self, args):
        self._check_argument_num("choose_attr", 2, args[0])
        for a in args[0]:
            if not self._is_valid(a):
                raise ParserError("'choose_attr' argument is not in the vocabulary: " + str(a))

    def _verify_verify_attrs(self, args):
        if len(args) != 1 or len(args[0]) == 0:
            raise ParserError("'verify_attrs' must have at least one argument.")
        for a in args[0]:
            if not self._is_valid(a):
                raise ParserError("'verify_attrs' argument is not in the vocabulary: " + str(a))

    def _verify_choose_rel(self, args):
        self._check_relation_triple("choose_rel", args)

    def _verify_verify_rel(self, args):
        self._check_relation_triple("verify_rel", args)

    def _verify_exist(self, args):
        self._check_argument_num("exist", 0, args)

    def _verify_and(self, args):
        self._check_argument_num("and", 0, args)

    def _verify_or(self, args):
        self._check_argument_num("or", 0, args)

    def _verify_all_same(self, args):
        self._check_argument_num("all_same", 1, args)
        self._check_category("all_same", args[0])

    def _verify_all_different(self, args):
        self._check_argument_num("all_different", 1, args)
        self._check_category("all_different", args[0])

    def _verify_two_same(self, args):
        self._check_argument_num("two_same", 1, args)
        self._check_category("two_same", args[0])

    def _verify_two_different(self, args):
        self._check_argument_num("two_different", 1, args)
        self._check_category("two_different", args[0])

    def _verify_compare(self, args):
        self._check_argument_num("compare", 2, args)
        if not self._is_valid(args[0]):
            raise ParserError("'compare' first argument must be an adjective: " + str(args[0]))
        if not isinstance(args[1], bool):
            raise ParserError(
                f"'compare' second argument must be a boolean. Current type: {type(args[1])}"
            )

    def verify(self, program: dict) -> bool:
        """parse_utils.py:195-240."""
        if "last_op" not in program:
            raise ParserError("The 'last_op' field is missing: " + str(program))
        if "operator" not in program["last_op"]:
            raise ParserError("The 'operator' field is missing: " + str(program["last_op"]))
        last = program["last_op"]["operator"]
        if last in NON_TERMINAL:
            raise ParserError(f"'{last}' is not a terminal operator: " + str(program["last_op"]))
        try:
            method = getattr(self, "_verify_" + last)
        except AttributeError:
            raise ParserError("Invalid operator: " + last)
        method(program["last_op"]["arguments"])

        if "branches" not in program:
            raise ParserError("The 'branches' field is missing: " + str(program))
        branch_count = len(program["branches"])
        if last in TWO_BRANCH and branch_count != 2:
            raise ParserError(f"'{last}' must have exactly two branches.")
        if last not in TWO_BRANCH and branch_count != 1:
            raise ParserError(f"'{last}' must have exactly one branch.")

        for b in program["branches"]:
            for i, op in enumerate(b):
                if "operator" not in op:
                    raise ParserError("The 'operator' field is missing: " + str(op))
                if i == 0 and op["operator"] != "select":
                    raise ParserError("The first operator of a branch must be 'select': " + str(b))
                if i > 0 and op["operator"] not in ("filter", "relate"):
                    raise ParserError(
                        "All operators in a branch (except the first operator) must be "
                        "either 'filter' or 'relate': " + op["operator"]
                    )
                try:
                    method = getattr(self, "_verify_" + op["operator"])
                except AttributeError:
                    raise ParserError("Invalid operator: " + op["operator"])
                if "arguments" not in op:
                    raise ParserError("The 'arguments' field is missing: " + str(op))
                method(op["arguments"])
        return True
