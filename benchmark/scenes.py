"""The program's feature source over the benchmark's scenes.

The program's loaders and its serving engine read features through the
program's own ``FeatureSource`` (its ``batch`` and ``batch_unique`` joins,
as ``GQAHdf5Features`` does in deployment); this one takes each scene from
the benchmark's ``World``, which made them from the seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dfol_vqa_tpu_torch.data.features import FeatureSource


class Scenes(FeatureSource):
    def __init__(self, world):
        self.world = world
        self.box_dim = world.box_dim

    def image(self, image_id: str) -> Tuple[np.ndarray, int]:
        return self.world.image(image_id)
