"""The demo training workload: planted-world questions at production dims.

Two shapes of the same families (``exist`` select -> filter -> relate,
``end`` statements of that shape, ``verify_rel`` with 1-2 hops,
``query_attr`` with 0-1 hops):

* **shuffled** (``train_datasets`` + ``train_loader(shuffle=True)``), as
  GQA training batches shuffled over its images: each file's questions are
  spread over all of the world's images, so a batch of 80 holds ~46 unique
  images (U_pad = 64) and a relating batch has U * 2 > B. It takes the
  per-question relation route: kernel 1 forward, kernel 2 backward.
* **deduplicated** (``evalset.eval_datasets`` + ``train_loader(shuffle=
  False)``): every batch on 8 images of its own (~10 questions per image),
  so a relating batch has U * 2 <= B and takes the shared-image route:
  kernels 3 and 4 forward, plain backwards.

``supervision_loader`` builds batches of the scene-graph supervision
terminals (``object_attr``, ``object_rel``, ``scene``) from
``data/synthetic.py`` on ``SyntheticFeatures`` scenes.

numpy only, like ``evalset``: the JAX golden script, the tests and
``chip_smoke.py`` share it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.data import synthetic
from dfol_vqa_tpu_torch.data.dataset import ProgramDataset
from dfol_vqa_tpu_torch.data.features import SyntheticFeatures
from dfol_vqa_tpu_torch.data.loader import BatchLoader
from dfol_vqa_tpu_torch.data.planted import PlantedWorld
from dfol_vqa_tpu_torch.ontology import GQAOntology
from dfol_vqa_tpu_torch.data import evalset

# (family, hops, questions): 560 questions, 7 batches of 80, 5 of them relating
PRODUCTION_MIX = (("exist", 2, 160), ("end", 2, 80), ("verify_rel", 1, 80),
                  ("verify_rel", 2, 80), ("query_attr", 0, 80), ("query_attr", 1, 80))
PRODUCTION_BATCH = 80  # configs/sample_config.yaml train_batch_size

# the same families at tiny widths (CPU tests and the JAX training golden)
TINY_MIX = (("exist", 2, 16), ("end", 2, 16), ("verify_rel", 1, 16), ("query_attr", 1, 16))
TINY_BATCH = 16


def demo_train_config(tiny: bool = False, stream_dtype: str = "float32") -> Config:
    """``evalset.demo_eval_config`` with ``dropout=0.0`` (as every training
    script of the repository sets it) and the train batch: 80 at
    production dims, 16 at tiny widths; ``tpu.train_chunk=1`` (one step per
    dispatch, so that each step can be held against another's)."""
    cfg = evalset.demo_eval_config(tiny, stream_dtype)
    cfg.dropout = 0.0
    cfg.train_batch_size = TINY_BATCH if tiny else PRODUCTION_BATCH
    cfg.tpu.train_chunk = 1
    return cfg


def train_datasets(world: PlantedWorld, mix: Sequence[Tuple[str, int, int]],
                   seed: int = 0) -> List[List[dict]]:
    """One question list per (family, hops, count) entry of ``mix``, each
    spread over all of the world's images."""
    return [evalset.family_questions(world, family, count, hops, seed * 1000 + fi,
                                     f"train-{family}{hops}-")
            for fi, (family, hops, count) in enumerate(mix)]


def train_loader(cfg: Config, ontology: GQAOntology, world: PlantedWorld,
                 datasets: Sequence[List[dict]], shuffle: bool = True,
                 seed: int = 0) -> BatchLoader:
    """A ``BatchLoader`` over ``datasets`` at ``cfg.train_batch_size`` and
    ``cfg.tpu.max_object_num``; each pass over it is one epoch (a shuffled
    loader reshuffles per pass)."""
    compiler = ProgramCompiler(ontology, object_num=cfg.tpu.max_object_num,
                               rel_slots=cfg.tpu.rel_table_size)
    return BatchLoader([ProgramDataset(qs, ontology) for qs in datasets], compiler, world,
                       cfg.train_batch_size, cfg.tpu.max_object_num, shuffle=shuffle, seed=seed)


SUPERVISION_TERMINALS = ("object_attr", "object_rel", "scene")


def supervision_loader(cfg: Config, ontology: GQAOntology, terminal: str, n: int,
                       seed: int = 0) -> BatchLoader:
    """An unshuffled ``BatchLoader`` over ``n`` supervision questions of
    ``terminal`` (``synthetic.generate_supervision_questions``) at
    ``cfg.train_batch_size``. The scenes are ``SyntheticFeatures`` of
    ``cfg.box_features_dim`` with between half of ``tpu.max_object_num`` and
    all of it; the statements name objects of the first half only, so every
    one exists and the masks have padding to hide."""
    O = cfg.tpu.max_object_num
    qs = synthetic.generate_supervision_questions(ontology, n, terminal, n_objects=O // 2,
                                                  seed=seed)
    compiler = ProgramCompiler(ontology, object_num=O, rel_slots=cfg.tpu.rel_table_size)
    features = SyntheticFeatures(box_dim=cfg.box_features_dim, min_objects=O // 2,
                                 max_objects=O, seed=seed)
    return BatchLoader([ProgramDataset(qs, ontology)], compiler, features, cfg.train_batch_size,
                       O, shuffle=False, prefetch=0)
