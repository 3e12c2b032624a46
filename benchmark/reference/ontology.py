"""GQA ontology: vocabulary, taxonomy and embedding service.

A frozen copy of the PyTorch port's module of the same name, for the
benchmark's reference (``benchmark/reference/__init__.py``).

TPU-first rework of the reference ontology (src/nsvqa/nn/interpreter/
batch_gqa_ops.py:25-148). Differences from upstream, by design:

  * Metadata ships as ONE versioned, compressed asset
    (``data/metadata/gqa_metadata.json.gz``) instead of five loose JSONs;
    the loader also accepts the five reference-format JSON paths for drop-in
    compatibility with existing configs (CONFIG_YAML.md keys
    ``attribute_file``/``class_file``/``vocabulary_file``/``relation_file``).
  * Word embeddings are materialised ONCE as a dense ``(V+1, D)`` matrix for
    the whole 2,335-token vocabulary (row 0 is the padding token) rather
    than per-batch linecache lookups (reference batch_gqa_ops.py:135-148);
    the matrix is the natural TPU-resident form and doubles as the init for
    the oracle's embedding head (gqa_interpreter_experiments.py:147-154).
  * Category -> option-list expansion tables are precomputed as padded int32
    arrays so the AOT program compiler can emit fixed-shape option axes.

Token codes are 1-based (code = index+1), negation encoded as a negative
code — identical to the reference codec (batch_gqa_ops.py:76-94) so HDF5
program files are interchangeable.
"""

from __future__ import annotations

import gzip
import json
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

UNKNOWN = "UNKNOWN"

_NEG_RE = re.compile(r"not\((\w|\s)+\)")

DEFAULT_METADATA_PATH = os.path.join(os.path.dirname(__file__), "gqa_metadata.json.gz")


def is_negated_token(token: str) -> bool:
    return _NEG_RE.match(token.strip()) is not None


def strip_negation(token: str) -> str:
    t = token.strip()
    if is_negated_token(t):
        return t[4:-1]
    return t


class GQAOntology:
    """Vocabulary & taxonomy service with int codecs and embedding matrix."""

    def __init__(
        self,
        metadata_path: Optional[str] = None,
        embedding_file: Optional[str] = None,
        embedding_dim: int = 300,
        *,
        attribute_json_path: Optional[str] = None,
        class_json_path: Optional[str] = None,
        vocab_json_file: Optional[str] = None,
        relation_json_path: Optional[str] = None,
        embedding_cache: Optional[str] = None,
    ):
        if vocab_json_file is not None:
            meta = self._load_reference_jsons(
                attribute_json_path, class_json_path, vocab_json_file, relation_json_path
            )
        else:
            path = metadata_path or DEFAULT_METADATA_PATH
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt", encoding="utf-8") as f:
                meta = json.load(f)

        self._ops: List[str] = meta["ops"]
        self._args: List[str] = meta["args"]
        self._images: List[str] = meta.get("images", [])
        self._attribute_dict: Dict[str, List[str]] = meta["attribute_categories"]
        self._class_dict: Dict[str, List[str]] = meta["class_families"]
        self._relations: List[str] = meta.get("relations", [])
        self._op_map: Dict[str, Optional[str]] = meta.get("op_map", {})

        self._op_to_idx = {o: i + 1 for i, o in enumerate(self._ops)}
        self._arg_to_idx = {a: i + 1 for i, a in enumerate(self._args)}
        self._img_to_idx = {im: i + 1 for i, im in enumerate(self._images)}

        self._nouns = sorted(set(sum(self._class_dict.values(), [])))
        self._noun_set = set(self._nouns)
        self._adjectives = sorted(set(sum(self._attribute_dict.values(), [])))
        self._adjective_set = set(self._adjectives)
        self._relation_set = set(self._relations)

        # child class -> parent families (reference batch_gqa_ops.py:36-39)
        self._inverted_class_dict: Dict[str, List[str]] = {}
        for parent, children in self._class_dict.items():
            for c in children:
                self._inverted_class_dict.setdefault(c, []).append(parent)

        # index partitions (0-based into the arg vocabulary;
        # reference batch_gqa_ops.py:55-66)
        self._noun_index = sorted(
            self._arg_to_idx[n] - 1 for n in self._nouns if n in self._arg_to_idx
        )
        self._relation_index = sorted(
            self._arg_to_idx[r] - 1 for r in self._relations if r in self._arg_to_idx
        )
        rel_set = set(self._relation_index)
        self._attribute_index = [i for i in range(len(self._args)) if i not in rel_set]
        self._attributes = [self._args[i] for i in self._attribute_index]
        self._relation_reversed_index = {v: j for j, v in enumerate(self._relation_index)}
        self._attribute_reversed_index = {v: j for j, v in enumerate(self._attribute_index)}
        self._noun_subindex = sorted(
            j for j, i in enumerate(self._attribute_index) if self._args[i] in self._noun_set
        )
        noun_sub = set(self._noun_subindex)
        self._non_noun_subindex = [
            j for j in range(len(self._attribute_index)) if j not in noun_sub
        ]

        self._embedding_dim = embedding_dim
        self._embedding_file = embedding_file
        self._embedding_cache = embedding_cache
        self._embedding_matrix: Optional[np.ndarray] = None
        self._word_index: Optional[Dict[str, int]] = None

    @staticmethod
    def _load_reference_jsons(attribute_path, class_path, vocab_path, relation_path):
        with open(vocab_path) as f:
            vocab = json.load(f)
        with open(attribute_path) as f:
            attribute_categories = json.load(f)
        with open(class_path) as f:
            class_families = json.load(f)
        relations: List[str] = []
        if relation_path is not None:
            with open(relation_path) as f:
                relations = sorted(set(json.load(f)))
        return {
            "ops": vocab["idx_to_op"],
            "args": vocab["idx_to_arg"],
            "images": vocab.get("idx_to_img", []),
            "attribute_categories": attribute_categories,
            "class_families": class_families,
            "relations": relations,
            "op_map": {},
        }

    # ------------------------------------------------------------------ codecs

    @property
    def num_tokens(self) -> int:
        return len(self._args)

    @property
    def num_ops(self) -> int:
        return len(self._ops)

    @property
    def embedding_dim(self) -> int:
        return self._embedding_dim

    def encode_token(self, token) -> int:
        """Signed 1-based token code; negation flips the sign
        (reference batch_gqa_ops.py:76-85)."""
        t = str(token).lower().strip()
        neg = is_negated_token(t)
        if neg:
            t = t[4:-1]
        return (-1 if neg else 1) * self._arg_to_idx[t]

    def try_encode_token(self, token) -> Optional[int]:
        try:
            return self.encode_token(token)
        except KeyError:
            return None

    def decode_token(self, idx: int):
        t = self._args[abs(int(idx)) - 1]
        if t == "true":
            return True
        if t == "false":
            return False
        return t if idx >= 0 else "not(" + t + ")"

    def encode_op(self, op: str) -> int:
        return self._op_to_idx[op.lower().strip()]

    def decode_op(self, idx: int) -> str:
        return self._ops[int(idx) - 1]

    def encode_img_id(self, img_id: str) -> int:
        return self._img_to_idx[img_id.lower().strip()]

    def decode_img_id(self, idx: int) -> str:
        return self._images[int(idx) - 1]

    # --------------------------------------------------------------- taxonomy

    def query_attribute(self, attr_name):
        return self._attribute_dict.get(attr_name, UNKNOWN)

    def query_class(self, class_name):
        return self._class_dict.get(class_name, UNKNOWN)

    def query(self, name) -> List[Optional[str]]:
        """Candidate answers for a category name (batch_gqa_ops.py:114-124)."""
        if name in self._attribute_dict:
            return list(self._attribute_dict[name])
        if name in self._class_dict:
            return list(self._class_dict[name])
        if name is None:
            return [None]
        if name == "entity":
            return list(self._nouns)
        return [name]

    def is_noun(self, name) -> bool:
        return name in self._noun_set

    def is_adjective(self, name) -> bool:
        return name in self._adjective_set

    def is_relation(self, name) -> bool:
        return name in self._relation_set

    def get_family_subindex(self, attribute) -> List[int]:
        """Attribute-subindex of all class siblings (batch_gqa_ops.py:68-74)."""
        if attribute not in self._inverted_class_dict:
            return []
        children = set()
        for parent in self._inverted_class_dict[attribute]:
            children.update(self._class_dict[parent])
        return [j for j, a in enumerate(self._attributes) if a in children]

    # ------------------------------------------------------------- embeddings

    def _build_word_index(self):
        self._word_index = {}
        with open(self._embedding_file, "r", encoding="utf8") as f:
            for i, line in enumerate(f):
                self._word_index[line.split(" ", 1)[0]] = i

    def _pseudo_embedding(self, word: str) -> np.ndarray:
        """Deterministic fallback embedding when no GloVe file is configured.

        Seeded per word so tests/benchmarks are reproducible without the
        3GB GloVe download. Real runs should set ``word_embedding_file``.
        """
        seed = np.frombuffer(word.encode("utf-8").ljust(8, b"\0")[:8], dtype=np.uint64)[0]
        rng = np.random.default_rng(int(seed) % (2**63))
        return rng.standard_normal(self._embedding_dim).astype(np.float32) * 0.3

    def get_embeddings(self, names: Sequence[str]) -> np.ndarray:
        """(len(names), D) matrix; multi-word token = sum of word vectors
        (reference batch_gqa_ops.py:135-148)."""
        res = np.zeros((len(names), self._embedding_dim), dtype=np.float32)
        if self._embedding_file is not None:
            import linecache

            if self._word_index is None:
                self._build_word_index()
            for i, name in enumerate(names):
                for t in str(name).split(" "):
                    if t in self._word_index:
                        line = linecache.getline(self._embedding_file, self._word_index[t] + 1)
                        res[i, :] += np.array([float(v) for v in line.split(" ")[1:]])
        else:
            for i, name in enumerate(names):
                for t in str(name).split(" "):
                    res[i, :] += self._pseudo_embedding(t)
        return res

    def embedding_matrix(self) -> np.ndarray:
        """(V+1, D): row 0 = padding, row code = token ``code`` embedding.

        The whole-vocabulary matrix replaces the reference's per-batch GloVe
        prefetch — it is computed once, cached on disk, and lives in HBM.
        """
        if self._embedding_matrix is not None:
            return self._embedding_matrix
        cache = self._embedding_cache
        if cache is not None and os.path.exists(cache):
            self._embedding_matrix = np.load(cache)["embedding"]
            return self._embedding_matrix
        mat = np.zeros((self.num_tokens + 1, self._embedding_dim), dtype=np.float32)
        mat[1:, :] = self.get_embeddings(self._args)
        self._embedding_matrix = mat
        if cache is not None:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            np.savez_compressed(cache, embedding=mat)
        return mat

    # --------------------------------------------------- static option tables

    def option_tokens(self, category: Optional[str], name: Optional[str]) -> List[int]:
        """Signed token codes for the option fan-out of a category.

        ``category in ('name','type')`` resolves against the tracked variable
        name, as in GQAQueryAttrBatch (batch_gqa_ops.py:304-306)."""
        cat = category if category not in ("name", "type") else name
        opts = self.query(cat)
        codes = []
        for o in opts:
            if o is None:
                continue
            c = self.try_encode_token(o)
            if c is not None:
                codes.append(c)
        return codes

    def max_option_count(self) -> int:
        sizes = [len(v) for v in self._attribute_dict.values()]
        sizes += [len(v) for v in self._class_dict.values()]
        sizes.append(len(self._nouns))
        return max(sizes)
