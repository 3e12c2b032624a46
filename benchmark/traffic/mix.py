"""The general generator: a workload file's parameters -> the run's inputs.

Every seed gets the same amounts of work in another order: the counts of
each (family, hops) entry are fixed by the file, the seed draws the scenes,
the tokens and the order. Three shapes:

* ``serve``: ``rate_per_s * seconds`` requests, each a fresh question on a
  scene of its own drawn from the pool, the families and hops in the
  proportions of ``mix`` (rows ``[family, min_hops, max_hops, weight]``),
  arriving open-loop at the times of a Poisson process of that rate with
  that many arrivals (sorted uniform times over the window, drawn from the
  seed);
* ``eval``: one question file per ``mix`` row ``[family, hops, count]``,
  every ``batch`` consecutive questions on ``images_per_batch`` scenes of
  their own, sorted by scene (GQA's ~10 questions per image);
* ``train``: one question file per ``mix`` row ``[family, hops, count]``,
  each spread over every scene of the pool.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from benchmark.reference.ontology import GQAOntology
from benchmark.traffic.world import World


def make_world(ontology: GQAOntology, spec: dict, object_num: int, box_dim: int,
               seed: int, device="cpu") -> World:
    """The cell's scenes; their features are drawn on ``device``."""
    w = spec["world"]
    return World(ontology, n_scenes=w["scenes"], min_objects=w["min_objects"],
                 max_objects=w["max_objects"], object_num=object_num, n_nouns=w["nouns"],
                 n_attrs=w["attrs"], box_dim=box_dim, noise=w["noise"], seed=seed,
                 device=device)


def proportional_counts(weights: Sequence[float], n: int) -> List[int]:
    """``n`` split in proportion to ``weights`` (largest remainders)."""
    w = np.asarray(weights, np.float64) / float(np.sum(weights))
    raw = w * n
    counts = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - counts))[: n - int(counts.sum())]:
        counts[i] += 1
    return counts.tolist()


def serve_requests(world: World, spec: dict, seconds: float, seed: int
                   ) -> List[Tuple[float, dict]]:
    """(arrival second, question) of every request due in the window."""
    rng = np.random.default_rng([seed, 1])
    n = int(round(spec["rate_per_s"] * seconds))
    slots = []  # (family, hops) of each request, in proportion
    for (family, lo, hi, _), count in zip(spec["mix"],
                                          proportional_counts([m[3] for m in spec["mix"]], n)):
        hops = list(range(lo, hi + 1))
        slots += [(family, hops[i % len(hops)]) for i in range(count)]
    order = rng.permutation(len(slots))
    scenes = np.arange(len(world.ids))
    out = []
    for i in order:
        family, hops = slots[i]
        q = None
        while q is None:
            q = world.question(rng, family, hops, scenes)
        q["question_id"] = f"r{len(out)}"
        out.append(q)
    times = rng.uniform(0.0, seconds, n)  # Poisson arrivals: n uniform times
    return list(zip(np.sort(times).tolist(), out))


def eval_files(world: World, spec: dict, seed: int) -> List[List[dict]]:
    """One question list per ``mix`` row; see the module docstring."""
    rng = np.random.default_rng([seed, 2])
    batch, per = spec["batch"], spec["images_per_batch"]
    slots = len(world.ids) // per
    files, k = [], 0
    for family, hops, count in spec["mix"]:
        questions: List[dict] = []
        for start in range(0, count, batch):
            scenes = np.arange((k % slots) * per, (k % slots) * per + per)
            part = world.questions(rng, family, hops, min(batch, count - start), scenes,
                                   prefix=f"{family}{hops}-b{k}-")
            questions += sorted(part, key=lambda q: world._index[q["imageId"]])
            k += 1
        files.append(questions)
    return files


def train_files(world: World, spec: dict, seed: int) -> List[List[dict]]:
    """One question list per ``mix`` row, over every scene of the pool."""
    rng = np.random.default_rng([seed, 3])
    scenes = np.arange(len(world.ids))
    return [world.questions(rng, family, hops, count, scenes, prefix=f"{family}{hops}-")
            for family, hops, count in spec["mix"]]


def relation_tokens(question: dict) -> int:
    """The distinct relation tokens a question scores (its relate hops and
    the relation terminals' tokens): the slots its contraction fills."""
    toks = {op["arguments"][0] for br in question["program"]["branches"] for op in br
            if op["operator"] == "relate"}
    last = question["program"]["last_op"]
    if last["operator"] in ("verify_rel", "relate"):
        toks.add(last["arguments"][0])
    elif last["operator"] == "choose_rel":
        toks.update(last["arguments"][0])
    return len(toks)


def calibrator_steps(question: dict) -> int:
    """The calibrator's LSTM steps for a question, approximately: a forward
    and a backward step per op, and one more forward step per relate for
    its select side (the terminal's own steps are left out)."""
    ops = [op for br in question["program"]["branches"] for op in br]
    ops.append(question["program"]["last_op"])
    return 2 * len(ops) + sum(op["operator"] in ("relate", "verify_rel", "choose_rel")
                              for op in ops)
