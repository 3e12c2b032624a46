"""The demo offline-evaluation workload: planted-world question files with
images shared within each batch.

Offline loaders deduplicate images (``BatchLoader`` ->
``FeatureSource.batch_unique``), and GQA averages about ten questions per
image, so a relating batch takes the shared-image relation route when its
unique images U (padded up the 4, 8, 16, 32, 64, ... ladder) satisfy
U * 2 <= B. This module builds such a workload from a ``PlantedWorld``:
one question list per (family, hops) entry — one file-dataset each, as a
file holds one bucket — where every ``batch`` consecutive questions are
drawn from ``images_per_batch`` images of their own and sorted by image.
``exist`` questions take the ``bench.py`` shape (select, then filter and
relate alternating: select -> filter -> relate at two hops); ``end``
questions are statements of that shape (the compiler appends ``end`` to a
program whose last op is select, filter or relate); the other families come
from ``PlantedWorld.generate_family``. Answers are exact.

numpy only: it imports neither torch nor jax, so the JAX golden script,
the tests and ``chip_smoke.py`` share it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.data.dataset import ProgramDataset
from dfol_vqa_tpu_torch.data.loader import BatchLoader
from dfol_vqa_tpu_torch.data.planted import PlantedWorld
from dfol_vqa_tpu_torch.ontology import GQAOntology

# (family, hops, questions): 640 questions in 8 batches of 80, six of them
# relating (exist and verify_rel), at GQA's maximum of 100 objects
PRODUCTION_MIX = (("exist", 2, 320), ("verify_rel", 1, 80), ("verify_rel", 2, 80),
                  ("query_attr", 0, 80), ("query_attr", 1, 80))
PRODUCTION_BATCH = 80  # configs/sample_config.yaml test_batch_size
PRODUCTION_IMAGES_PER_BATCH = 8
PRODUCTION_OBJECTS = 100  # configs/sample_config.yaml tpu.max_object_num

# the same families at tiny widths (CPU tests and the JAX eval golden); the
# last file's 12 questions leave a padded partial batch
TINY_MIX = (("exist", 2, 32), ("verify_rel", 1, 16), ("query_attr", 1, 12))
TINY_BATCH = 16
TINY_IMAGES_PER_BATCH = 4


# every question terminal, with its hops: the 13 planted families and
# ``end`` statements, a relate hop wherever the family's branches can hold
# one. Nine of them relate; query_attr, choose_attr, two_same,
# two_different and compare pin their objects with filters only.
TERMINAL_HOPS = (("exist", 2), ("end", 2), ("verify_attrs", 1), ("verify_rel", 1),
                 ("query_attr", 1), ("choose_attr", 1), ("choose_rel", 1), ("and", 1),
                 ("or", 1), ("all_same", 1), ("all_different", 1), ("two_same", 1),
                 ("two_different", 1), ("compare", 1))


def demo_eval_config(tiny: bool = False, stream_dtype: str = "bfloat16") -> Config:
    """``Config()`` at production dims (2048-d boxes, 512-d oracle, E=300,
    relation hidden 256, 100 objects, batch 80), or tiny widths (box 32,
    oracle 24, E 16, hidden 16, 8 objects, batch 16); the calibrator off.
    ``stream_dtype`` is ``tpu.rel_stream_dtype``."""
    if tiny:
        cfg = Config(box_features_dim=32, oracle_input_dim=24, word_embedding_dim=16,
                     attribute_network_layers_config=[16], relation_network_layers_config=[16],
                     featurizer_layers_config=[], dropout=0.0, verbose=False,
                     test_batch_size=TINY_BATCH)
        cfg.tpu.max_object_num = 8
    else:
        cfg = Config(verbose=False, test_batch_size=PRODUCTION_BATCH)
        cfg.tpu.max_object_num = PRODUCTION_OBJECTS
    cfg.tpu.rel_stream_dtype = stream_dtype
    return cfg


def demo_world(ontology: GQAOntology, tiny: bool = False) -> PlantedWorld:
    """Tiny: the serving demo's world (6 nouns, <= 8 objects, 48 images).
    Production: 64 nouns over 50-100 objects per scene (so most scenes keep
    objects with a noun of their own, which ``query_attr`` needs), 64
    images. Seed 0."""
    if tiny:
        return PlantedWorld(ontology, box_dim=32, n_nouns=6, n_attrs=4, n_images=48,
                            min_objects=4, max_objects=8, noise=0.1, seed=0)
    return PlantedWorld(ontology, box_dim=2048, n_nouns=64, n_attrs=8, n_images=64,
                        min_objects=50, max_objects=PRODUCTION_OBJECTS, noise=0.1, seed=0)


def _exist_questions(world: PlantedWorld, n: int, hops: int, images: Sequence[str],
                     rng: np.random.Generator, prefix: str) -> List[dict]:
    """``n`` balanced exist questions, select then ``hops`` filter/relate
    ops alternating (filter first), on ``images``."""
    out: List[dict] = []
    want_yes = True
    for _ in range(n * 500):
        if len(out) == n:
            return out
        img = str(rng.choice(images))
        ops = [{"operator": "select", "arguments": [str(rng.choice(world.nouns))]}]
        for h in range(hops):
            if h % 2 == 1:
                ops.append({"operator": "relate",
                            "arguments": [str(rng.choice(world.relations)),
                                          bool(rng.uniform() < 0.5), str(rng.choice(world.nouns))]})
            else:
                ops.append({"operator": "filter", "arguments": [str(rng.choice(world.attrs))]})
        ans = "yes" if world.eval_branch(img, ops).any() else "no"
        if (ans == "yes") != want_yes:
            continue
        want_yes = not want_yes
        out.append({"program": {"branches": [ops],
                                "last_op": {"operator": "exist", "arguments": []}},
                    "answer": ans, "imageId": img, "question_id": f"{prefix}{len(out)}"})
    raise RuntimeError(f"only {len(out)}/{n} exist questions on {len(images)} images")


def as_statement(q: dict) -> dict:
    """An ``exist`` question -> the statement of its branch: the branch's
    last op becomes the program's last op, so the compiler ends it with
    ``end`` (a STATEMENT question, trained on its log-probability)."""
    ops = q["program"]["branches"][0]
    return {**q, "program": {"branches": [ops[:-1]] if len(ops) > 1 else [],
                             "last_op": ops[-1]}}


def family_questions(world: PlantedWorld, family: str, n: int, hops: int, seed: int,
                     prefix: str) -> List[dict]:
    """``n`` questions of ``family`` with ``hops`` hops over all of the
    world's images."""
    if family in ("exist", "end"):
        qs = _exist_questions(world, n, hops, world.image_ids, np.random.default_rng(seed),
                              prefix)
        return [as_statement(q) for q in qs] if family == "end" else qs
    return world.generate_family(family, n, length=hops, seed=seed, id_prefix=prefix)


def eval_datasets(world: PlantedWorld, mix: Sequence[Tuple[str, int, int]], batch: int,
                  images_per_batch: int, seed: int = 0) -> List[List[dict]]:
    """One question list per (family, hops, count) entry of ``mix``; every
    ``batch`` consecutive questions share ``images_per_batch`` images of
    their own (taken in turn from ``world.image_ids``, wrapping around) and
    are sorted by image."""
    ids = world.image_ids
    slots = len(ids) // images_per_batch
    if slots == 0:
        raise ValueError(f"{len(ids)} images cannot give {images_per_batch} per batch")
    out: List[List[dict]] = []
    k = 0  # batch counter over the whole mix
    for fi, (family, hops, count) in enumerate(mix):
        questions: List[dict] = []
        for start in range(0, count, batch):
            n = min(batch, count - start)
            lo = (k % slots) * images_per_batch
            prefix = f"{family}{hops}-b{k}-"
            if family in ("exist", "end"):
                part = _exist_questions(world, n, hops, ids[lo:lo + images_per_batch],
                                        np.random.default_rng((seed, fi, k)), prefix)
                if family == "end":
                    part = [as_statement(q) for q in part]
            else:
                # the +0.5 keeps int(fraction * len(ids)) exact at both ends
                part = world.generate_family(
                    family, n, length=hops, seed=seed * 1000 + k,
                    image_slice=((lo + 0.5) / len(ids), (lo + images_per_batch + 0.5) / len(ids)),
                    id_prefix=prefix)
            questions += sorted(part, key=lambda q: ids.index(q["imageId"]))
            k += 1
        out.append(questions)
    return out


def eval_loader(cfg: Config, ontology: GQAOntology, world: PlantedWorld,
                datasets: Sequence[List[dict]], keep_original: bool = False) -> BatchLoader:
    """An unshuffled ``BatchLoader`` over ``datasets`` at
    ``cfg.test_batch_size`` and ``cfg.tpu.max_object_num``; the world is
    the feature source."""
    compiler = ProgramCompiler(ontology, object_num=cfg.tpu.max_object_num,
                               rel_slots=cfg.tpu.rel_table_size)
    return BatchLoader([ProgramDataset(qs, ontology) for qs in datasets], compiler, world,
                       cfg.test_batch_size, cfg.tpu.max_object_num, shuffle=False,
                       keep_original=keep_original)
