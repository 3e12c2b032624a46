"""Synthetic GQA-like question/scene generation for tests and benchmarks.

The PyTorch port's own copy of ``dfol_vqa_tpu/data/synthetic.py``, which it
must not import (the port imports nothing of the JAX package); it behaves
exactly as that module, and tests/test_torch_host.py holds the two equal.

The reference has no synthetic data path; we add one so the full pipeline
(compiler -> oracle -> executor -> trainer) is exercisable without the
GQA download. Questions are drawn over the real 2,335-token ontology so
compiled shapes match production exactly.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dfol_vqa_tpu_torch.ontology import GQAOntology


def generate_questions(
    ontology: GQAOntology,
    n: int,
    terminal: str = "exist",
    length: int = 1,
    seed: int = 0,
    image_pool: int = 64,
    answer_mode: str = "random",
    neg_prob: float = 0.0,
    wildcard_prob: float = 0.0,
) -> List[dict]:
    """Generate `n` program dicts with terminal op `terminal`.

    `length` = number of branch hops beyond select (filters/relates mixed),
    matching the reference's length-segregation convention
    (gqa_preprocess.py:136-147). ``neg_prob`` wraps filter/verify arguments
    in the reference's ``not(x)`` negation syntax (parse_utils detect_
    negations, util.py:68); ``wildcard_prob`` makes select arguments ``_``
    (unconstrained entity, batch_base_ops.py None/'_' masking)."""
    rng = np.random.default_rng(seed)
    nouns = [t for t in ontology._nouns if t in ontology._arg_to_idx]
    adjs = [t for t in ontology._adjectives if t in ontology._arg_to_idx]
    rels = [t for t in ontology._relations if t in ontology._arg_to_idx]
    cats = list(ontology._attribute_dict.keys())

    def maybe_neg(tok: str) -> str:
        return f"not({tok})" if rng.uniform() < neg_prob else tok

    def branch(hops: int) -> List[dict]:
        sel = "_" if rng.uniform() < wildcard_prob else str(rng.choice(nouns))
        ops = [{"operator": "select", "arguments": [sel]}]
        for h in range(hops):
            if rng.uniform() < 0.3 and h < hops:
                ops.append(
                    {
                        "operator": "relate",
                        "arguments": [
                            maybe_neg(str(rng.choice(rels))),
                            bool(rng.uniform() < 0.5),
                            str(rng.choice(nouns)),
                        ],
                    }
                )
            else:
                ops.append({"operator": "filter",
                            "arguments": [maybe_neg(str(rng.choice(adjs)))]})
        return ops

    two_branch = terminal in ("and", "or", "two_same", "two_different", "compare")
    out = []
    for i in range(n):
        branches = [branch(length)] + ([branch(length)] if two_branch else [])
        if terminal == "exist":
            last = {"operator": "exist", "arguments": []}
            ans = str(rng.choice(["yes", "no"]))
        elif terminal == "verify_attrs":
            k = int(rng.integers(1, 3))
            last = {"operator": "verify_attrs",
                    "arguments": [[maybe_neg(str(rng.choice(adjs))) for _ in range(k)]]}
            ans = str(rng.choice(["yes", "no"]))
        elif terminal == "verify_rel":
            last = {
                "operator": "verify_rel",
                "arguments": [maybe_neg(str(rng.choice(rels))), bool(rng.uniform() < 0.5), str(rng.choice(nouns))],
            }
            ans = str(rng.choice(["yes", "no"]))
        elif terminal == "query_attr":
            cat = str(rng.choice(cats))
            last = {"operator": "query_attr", "arguments": [cat]}
            opts = [o for o in ontology.query(cat) if o in ontology._arg_to_idx]
            ans = str(rng.choice(opts)) if opts else "yes"
        elif terminal == "choose_attr":
            opts = [str(rng.choice(adjs)), str(rng.choice(adjs))]
            last = {"operator": "choose_attr", "arguments": [opts]}
            ans = str(rng.choice(opts))
        elif terminal == "choose_rel":
            opts = [str(rng.choice(rels)), str(rng.choice(rels))]
            last = {
                "operator": "choose_rel",
                "arguments": [opts, bool(rng.uniform() < 0.5), str(rng.choice(nouns))],
            }
            ans = str(rng.choice(opts))
        elif terminal in ("and", "or"):
            last = {"operator": terminal, "arguments": []}
            ans = str(rng.choice(["yes", "no"]))
        elif terminal in ("all_same", "all_different", "two_same", "two_different"):
            last = {"operator": terminal, "arguments": [str(rng.choice(cats))]}
            ans = str(rng.choice(["yes", "no"]))
        elif terminal == "compare":
            last = {"operator": "compare", "arguments": [str(rng.choice(adjs)), bool(rng.uniform() < 0.5)]}
            ans = branches[int(rng.uniform() < 0.5)][0]["arguments"][0]
        else:
            raise ValueError(terminal)
        out.append(
            {
                "program": {"branches": branches, "last_op": last},
                "answer": ans,
                "imageId": f"synth_{int(rng.integers(0, image_pool))}",
                "question_id": f"sq{i}",
            }
        )
    return out


def generate_supervision_questions(
    ontology: GQAOntology,
    n: int,
    terminal: str,
    n_objects: int = 6,
    seed: int = 0,
    image_pool: int = 64,
) -> List[dict]:
    """Direct scene-graph supervision questions (object_attr / object_rel /
    scene) following the reference data contracts (data_pipeline.py:593-622,
    batch_gqa_boxfeatures_pipeline.py:93-155)."""
    rng = np.random.default_rng(seed)
    adjs = [t for t in ontology._adjectives if t in ontology._arg_to_idx]
    rels = [t for t in ontology._relations if t in ontology._arg_to_idx]
    out = []
    for i in range(n):
        base = {
            "imageId": f"synth_{int(rng.integers(0, image_pool))}",
            "question_id": f"sv{i}",
        }
        if terminal == "object_attr":
            groups, answers, weights = [], [], []
            for obj_i in range(int(rng.integers(1, n_objects))):
                attrs = [str(rng.choice(adjs)) for _ in range(int(rng.integers(1, 3)))]
                groups.append(attrs)
                answers.append([str(rng.choice(["yes", "no"])) for _ in attrs])
                weights.extend([float(rng.uniform(0.5, 1.0)) for _ in attrs])
            base["program"] = {"branches": [],
                               "last_op": {"operator": "object_attr", "arguments": [groups]}}
            base["answer"] = answers
            base["weights"] = weights
        elif terminal == "object_rel":
            k = int(rng.integers(1, 5))
            base["program"] = {
                "branches": [],
                "last_op": {"operator": "object_rel",
                            "arguments": [[str(rng.choice(rels)) for _ in range(k)]]},
            }
            base["object_pairs"] = {
                "subject_id": [int(rng.integers(0, n_objects)) for _ in range(k)],
                "object_id": [int(rng.integers(0, n_objects)) for _ in range(k)],
            }
            base["answer"] = [str(rng.choice(["yes", "no"])) for _ in range(k)]
        elif terminal == "scene":
            base["program"] = {"branches": [],
                               "last_op": {"operator": "scene", "arguments": []}}
            base["attribute_dict"] = {
                str(obj_i): [(str(rng.choice(adjs)), float(rng.uniform(0.5, 1.0)))]
                for obj_i in range(int(rng.integers(1, n_objects)))
            }
            k = int(rng.integers(1, 5))
            base["object_pairs"] = {
                "subject_id": [int(rng.integers(0, n_objects)) for _ in range(k)],
                "object_id": [int(rng.integers(0, n_objects)) for _ in range(k)],
            }
            base["relation_list"] = [
                (str(rng.choice(rels)), float(rng.uniform(0.5, 1.0))) for _ in range(k)
            ]
        else:
            raise ValueError(terminal)
        out.append(base)
    return out
