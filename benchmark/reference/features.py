"""Object feature sources: the feature-source interface and its batch joins.

A frozen copy of the PyTorch port's module of the same name, for the
benchmark's reference (``benchmark/reference/__init__.py``).

Dense-padded replacement for BatchGQABoxFeaturesCollator's feature join
(src/nsvqa/data/batch_gqa_boxfeatures_pipeline.py:15-92): per image we emit a
``(O_pad, box_dim + 6)`` row block ``[features ‖ image_w,image_h ‖ bbox
x,y,w,h]`` (bbox converted to width/height form as upstream, …:60-61) plus a
float validity mask, instead of the reference's ragged concat +
object_batch_index.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class FeatureSource:
    """Maps image ids -> (objects (O, D+6), n_objects)."""

    box_dim: int = 2048

    def batch(self, image_ids: List[str], O: int) -> Tuple[np.ndarray, np.ndarray]:
        objs = np.zeros((len(image_ids), O, self.box_dim + 6), np.float32)
        mask = np.zeros((len(image_ids), O), np.float32)
        for i, im in enumerate(image_ids):
            row, n = self.image(im)
            n = min(n, O)
            objs[i, :n] = row[:n]
            mask[i, :n] = 1.0
        return objs, mask

    def image(self, image_id: str) -> Tuple[np.ndarray, int]:
        raise NotImplementedError

    def fork_reset(self):
        """Drop process-shared resources after fork (loader num_workers>0);
        sources with open file handles must reopen them per process."""

    def batch_unique(
        self, image_ids: List[str], O: int, pad_ladder=(4, 8, 16, 32, 64, 128, 256, 512, 1024)
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Deduplicated scene batch: (uniq (U_pad, O, D+6), uniq_mask
        (U_pad, O), img_index (B,)).

        GQA averages ~10 questions per image, so loading each unique image
        once cuts both host->device bytes and per-object oracle FLOPs. U is
        padded up a ladder to bound jit signatures."""
        uniq: dict = {}
        idx = np.zeros(len(image_ids), np.int32)
        for i, im in enumerate(image_ids):
            if im not in uniq:
                uniq[im] = len(uniq)
            idx[i] = uniq[im]
        U = len(uniq)
        U_pad = U
        for v in pad_ladder:
            if U <= v:
                U_pad = v
                break
        objs = np.zeros((U_pad, O, self.box_dim + 6), np.float32)
        mask = np.zeros((U_pad, O), np.float32)
        for im, u in uniq.items():
            row, n = self.image(im)
            n = min(n, O)
            objs[u, :n] = row[:n]
            mask[u, :n] = 1.0
        return objs, mask, idx


class Scenes(FeatureSource):
    """The feature source over the benchmark's scenes (any object with
    ``box_dim`` and ``image``): the reference's joins, not the program's."""

    def __init__(self, scenes):
        self.scenes = scenes
        self.box_dim = scenes.box_dim

    def image(self, image_id: str) -> Tuple[np.ndarray, int]:
        return self.scenes.image(image_id)
