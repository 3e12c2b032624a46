"""Fixed-shape int32 HDF5 program codec.

The PyTorch port's own copy of ``dfol_vqa_tpu/compiler/h5_codec.py``, which it must not import
(the port imports nothing of the JAX package); it behaves exactly as
that module, and tests/test_torch_host.py holds the two equal.

Byte-compatible with the reference's AOT program encoding (GQAH5Encoder,
src/gqa_preprocess.py:15-94) and its decoder (ProgramDataset._decode_*,
src/nsvqa/data/data_pipeline.py:337-453): datasets ``answer``, ``image_id``,
``branch_ops (N, branches, 10)``, ``branch_args (N, branches, 10, 3)``,
``last_op (N,)``, ``last_args (N, arg_n)``. HDF5 files produced by the
reference preprocessor load directly into this framework and vice versa.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from dfol_vqa_tpu_torch.ontology import GQAOntology

MAX_BRANCH_LENGTH = 10  # gqa_preprocess.py:19


def _arg_count(op: str) -> int:
    """gqa_preprocess.py:33-40."""
    if op in ("verify_attrs", "choose_attr", "compare"):
        return 2
    if op == "verify_rel":
        return 3
    if op == "choose_rel":
        return 4
    return 1


def _branch_count(op: str) -> int:
    """gqa_preprocess.py:42-45."""
    return 2 if op in ("and", "or", "two_same", "two_different", "compare") else 1


class ProgramH5Codec:
    def __init__(self, ontology: GQAOntology):
        self._ont = ontology

    # ------------------------------------------------------------------ encode

    def _flat_args(self, arguments) -> List:
        out = []
        for a in arguments:
            if isinstance(a, list):
                out.extend(a)
            else:
                out.append(a)
        return out

    def encode_questions(self, questions: List[dict]) -> Dict[str, np.ndarray]:
        """Program dicts -> fixed-shape arrays (gqa_preprocess.py:51-94)."""
        n = len(questions)
        term = questions[0]["program"]["last_op"]["operator"]
        arg_n = _arg_count(term)
        branch_n = _branch_count(term)

        answer = np.zeros(n, np.int32)
        image_id = np.zeros(n, np.int32)
        branch_ops = np.zeros((n, branch_n, MAX_BRANCH_LENGTH), np.int32)
        branch_args = np.zeros((n, branch_n, MAX_BRANCH_LENGTH, 3), np.int32)
        last_op = np.zeros(n, np.int32)
        last_args = np.zeros((n, arg_n), np.int32)

        for i, q in enumerate(questions):
            image_id[i] = self._ont.encode_img_id(q["imageId"])
            answer[i] = self._ont.encode_token(q["answer"])
            for j, b in enumerate(q["program"]["branches"]):
                for k, op in enumerate(b):
                    branch_ops[i, j, k] = self._ont.encode_op(op["operator"])
                    for t, arg in enumerate(self._flat_args(op["arguments"])):
                        branch_args[i, j, k, t] = self._ont.encode_token(arg)
            last_op[i] = self._ont.encode_op(q["program"]["last_op"]["operator"])
            for t, arg in enumerate(self._flat_args(q["program"]["last_op"]["arguments"])):
                last_args[i, t] = self._ont.encode_token(arg)

        return {
            "answer": answer,
            "image_id": image_id,
            "branch_ops": branch_ops,
            "branch_args": branch_args,
            "last_op": last_op,
            "last_args": last_args,
        }

    def write_h5(self, questions: List[dict], path: str):
        import h5py

        data = self.encode_questions(questions)
        with h5py.File(path, "w") as hf:
            for k, v in data.items():
                hf.create_dataset(k, data=v)

    # ------------------------------------------------------------------ decode

    def decode_row(
        self,
        answer: int,
        image_id: int,
        branch_ops: np.ndarray,
        branch_args: np.ndarray,
        last_op: int,
        last_args: np.ndarray,
    ) -> dict:
        """One encoded row -> reference-format question dict
        (data_pipeline.py:343-367)."""
        ont = self._ont
        q: dict = {"imageId": ont.decode_img_id(image_id), "answer": ont.decode_token(answer)}
        l_op = ont.decode_op(last_op)
        q_last = {"operator": l_op, "arguments": self._decode_args(l_op, last_args)}

        branch_num, branch_length = branch_ops.shape
        branches = []
        for i in range(branch_num):
            branch = []
            for j in range(branch_length):
                if branch_ops[i, j] == 0:
                    break
                b_op = ont.decode_op(branch_ops[i, j])
                branch.append(
                    {"operator": b_op, "arguments": self._decode_args(b_op, branch_args[i, j])}
                )
            branches.append(branch)
        q["program"] = {"branches": branches, "last_op": q_last}
        return q

    def _decode_args(self, op: str, codes: np.ndarray) -> list:
        """Per-op argument layouts (data_pipeline.py:398-453)."""
        ont = self._ont
        d = ont.decode_token
        if op in ("select", "filter", "query_attr", "verify_attr", "all_same",
                  "all_different", "two_same", "two_different"):
            return [d(codes[0])]
        if op == "relate":
            return [d(codes[0]), d(codes[1]), d(codes[2])]
        if op == "choose_attr":
            return [[d(codes[0]), d(codes[1])]]
        if op == "verify_attrs":
            res = [d(codes[0])]
            if codes[1] != 0:
                res.append(d(codes[1]))
            return [res]
        if op == "choose_rel":
            return [[d(codes[0]), d(codes[1])], d(codes[2]), d(codes[3])]
        if op == "verify_rel":
            return [d(codes[0]), d(codes[1]), d(codes[2])]
        if op == "compare":
            return [d(codes[0]), d(codes[1])]
        if op in ("exist", "and", "or", "end"):
            return []
        raise ValueError(op)
