"""Object feature sources: GQA HDF5 chunks + synthetic scenes.

The PyTorch port's own copy of ``dfol_vqa_tpu/data/features.py``, which it must not import
(the port imports nothing of the JAX package); it behaves exactly as
that module, and tests/test_torch_host.py holds the two equal.

Dense-padded replacement for BatchGQABoxFeaturesCollator's feature join
(src/nsvqa/data/batch_gqa_boxfeatures_pipeline.py:15-92): per image we emit a
``(O_pad, box_dim + 6)`` row block ``[features ‖ image_w,image_h ‖ bbox
x,y,w,h]`` (bbox converted to width/height form as upstream, …:60-61) plus a
float validity mask, instead of the reference's ragged concat +
object_batch_index.

``gather_unique`` writes a batch's scene block once: each scene's rows,
zeros over the rows it leaves empty and over the padded scenes, and the
int8 transfer's scale of each row taken from the rows just written. With
``pinned`` the block is a tensor of PyTorch's caching pinned-host allocator
(``pinned_empty``), which the batch keeps (``LoadedBatch.block``) and the
copy to the card reads directly (``data/transfer.py``); ``objects`` is a
numpy view of it for every host consumer. Without, it is a numpy array.
The loader asks for ``pinned`` where its process can page-lock memory
(``data/loader.can_pin``).

The block is written by one call into a C++ routine
(``csrc/scene_gather.cpp``, built at first use by ``ops/cuda_build``),
which holds no GIL and deals the scenes to ``gather_threads`` threads.
Python keeps the dedup, the pad ladder and each scene's ``image`` call,
the source's own API.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import zlib
from os.path import join
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dfol_vqa_tpu_torch.ops import cuda_build

# trailing non-feature columns of an object row: image w,h + bbox x,y,w,h
# (featurizer.py docstring; reference batch_gqa_boxfeatures_pipeline.py:71)
GEOM_DIM = 6
SCALE_FLOOR = 1e-12  # the int8 scale of an all-zero row
PAD_LADDER = (4, 8, 16, 32, 64, 128, 256, 512, 1024)


def row_scale(rows: np.ndarray) -> np.ndarray:
    """The int8 transfer's per-row scale (``transfer.quantize_objects``):
    the largest |x| of a row's feature columns over 127, at least
    ``SCALE_FLOOR``. It covers ONLY the feature columns: the 6 geometry
    columns (image w/h + bbox) sit at pixel scale (~hundreds), and a shared
    scale would quantize the O(1) features to zero; geometry rides
    unquantized instead (``arrays["obj_geom"]``). The largest |x| is taken
    as the larger of the row's largest value and minus its smallest, which
    is the same number, without an |x| copy of the rows."""
    feats = rows[..., :-GEOM_DIM]
    peak = np.abs(np.maximum(feats.max(axis=-1), -feats.min(axis=-1)))
    return np.maximum(peak / 127.0, SCALE_FLOOR).astype(np.float32)


def gather_threads(nbytes: int) -> int:
    """The native pass's threads for a block of ``nbytes``: the calling
    thread alone under 4 MB, where a thread costs more than its share;
    else up to 4 of the cores this process may run on, less two (the
    trainer's thread and the transfer worker's)."""
    if nbytes < 4 << 20:
        return 1
    return max(1, min(4, len(os.sched_getaffinity(0)) - 2))


@functools.lru_cache(maxsize=None)
def scene_gather_lib() -> ctypes.CDLL:
    """The native scene pass (``csrc/scene_gather.cpp``), built once per
    source hash; raises where it cannot be built or loaded."""
    def configure(lib):
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.dfol_scene_gather.argtypes = [p, p, i64, i64, i64, i64, p, p, p, ctypes.c_int]
        lib.dfol_scene_gather.restype = None

    return cuda_build.load("scene_gather", ["scene_gather.cpp"], configure, host=True)[0]


def pinned_empty(shape) -> torch.Tensor:
    """An uninitialised float32 host tensor from PyTorch's caching
    pinned-host allocator: a block freed after a non-blocking copy of it
    returns to the allocator only once that copy has finished."""
    return torch.empty(shape, dtype=torch.float32, pin_memory=True)


class SceneBlock(NamedTuple):
    """A batch's deduplicated scenes (``FeatureSource.gather_unique``)."""

    objects: np.ndarray  # (U_pad, O, D+6)
    mask: np.ndarray  # (U_pad, O)
    img_index: np.ndarray  # (B,) each question's row of ``objects``
    scale: np.ndarray  # (U_pad, O) ``row_scale`` of each object row
    pinned: Optional[torch.Tensor]  # the page-locked tensor ``objects`` views, or None


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
        self, image_ids: List[str], O: int, pad_ladder=PAD_LADDER
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Deduplicated scene batch: (uniq (U_pad, O, D+6), uniq_mask
        (U_pad, O), img_index (B,)) of ``gather_unique``.

        GQA averages ~10 questions per image, so loading each unique image
        once cuts both host->device bytes and per-object oracle FLOPs. U is
        padded up a ladder to bound jit signatures."""
        g = self.gather_unique(image_ids, O, pad_ladder)
        return g.objects, g.mask, g.img_index

    def gather_unique(self, image_ids: List[str], O: int, pad_ladder=PAD_LADDER,
                      pinned: bool = False, threads: Optional[int] = None) -> SceneBlock:
        """``batch_unique``'s block written in one pass, with each row's
        ``row_scale`` (module docstring); in page-locked memory with
        ``pinned``; on ``threads`` threads in place of ``gather_threads``'
        count."""
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
        shape = (U_pad, O, self.box_dim + GEOM_DIM)
        block = pinned_empty(shape) if pinned else None
        objs = block.numpy() if block is not None else np.empty(shape, np.float32)
        rows, counts = [], np.empty(U, np.int64)
        for im, u in uniq.items():  # u counts up from 0
            row, n = self.image(im)
            k = counts[u] = min(n, O)
            r = np.ascontiguousarray(row[:k], np.float32)
            if r.shape != (k, shape[2]):
                raise ValueError(f"scene {im!r}: rows {r.shape} for {k} objects of width "
                                 f"{shape[2]}")
            rows.append(r)
        ptrs = np.array([r.ctypes.data for r in rows], np.uintp)
        mask = np.empty((U_pad, O), np.float32)
        scale = np.empty((U_pad, O), np.float32)
        scene_gather_lib().dfol_scene_gather(
            ptrs.ctypes.data, counts.ctypes.data, U, U_pad, O, shape[2], objs.ctypes.data,
            mask.ctypes.data, scale.ctypes.data,
            gather_threads(objs.nbytes) if threads is None else threads)
        return SceneBlock(objs, mask, idx, scale, block)


class GQAHdf5Features(FeatureSource):
    """Reads the official GQA objects HDF5 chunk files
    (batch_gqa_boxfeatures_pipeline.py:26-73)."""

    def __init__(self, object_h5_path: str, file_prefix: str, chunk_num: int,
                 object_info_json_path: str):
        import h5py

        self._h5py = h5py
        self._path = object_h5_path
        self._prefix = file_prefix
        self._chunk_num = chunk_num
        with open(object_info_json_path, "r") as f:
            self._info = json.load(f)
        self._handles: Optional[list] = None
        with h5py.File(join(object_h5_path, f"{file_prefix}_0.h5"), "r") as f:
            _, self.max_object_per_image, self.box_dim = f["features"].shape

    def fork_reset(self):
        self._handles = None  # h5py handles are not fork-safe; reopen lazily

    def _handle(self, chunk_id: int):
        if self._handles is None:
            self._handles = [
                self._h5py.File(join(self._path, f"{self._prefix}_{i}.h5"), "r")
                for i in range(self._chunk_num)
            ]
        return self._handles[chunk_id]

    def image(self, image_id: str) -> Tuple[np.ndarray, int]:
        info = self._info[image_id]
        n = info["objectsNum"]
        h = self._handle(info["file"])
        feats = h["features"][info["idx"]]  # (O_max, 2048)
        bboxes = np.array(h["bboxes"][info["idx"]], np.float32)  # (O_max, 4) x1y1x2y2
        O_max = feats.shape[0]
        out = np.zeros((O_max, self.box_dim + 6), np.float32)
        out[:, : self.box_dim] = feats
        out[:, self.box_dim] = info["width"]
        out[:, self.box_dim + 1] = info["height"]
        out[:, self.box_dim + 2] = bboxes[:, 0]
        out[:, self.box_dim + 3] = bboxes[:, 1]
        out[:, self.box_dim + 4] = bboxes[:, 2] - bboxes[:, 0]
        out[:, self.box_dim + 5] = bboxes[:, 3] - bboxes[:, 1]
        return out, n


class SyntheticFeatures(FeatureSource):
    """Deterministic per-image random scenes for tests and benchmarks."""

    def __init__(self, box_dim: int = 2048, min_objects: int = 4, max_objects: int = 16,
                 seed: int = 0):
        self.box_dim = box_dim
        self._min = min_objects
        self._max = max_objects
        self._seed = seed
        self._cache: Dict[str, Tuple[np.ndarray, int]] = {}

    def image(self, image_id: str) -> Tuple[np.ndarray, int]:
        if image_id in self._cache:
            return self._cache[image_id]
        # Process-independent seed (crc32, not builtin hash(): the latter is
        # PYTHONHASHSEED-randomized across interpreters, so spawn workers and
        # re-runs would see different scenes — same scheme as planted.py).
        # NOTE: changed in r4 from hash(); r4 synthetic scenes differ from r3.
        h = (zlib.crc32(f"synth/{image_id}".encode()) ^ (self._seed * 0x9E3779B1)) % (2**32)
        rng = np.random.default_rng(h)
        n = int(rng.integers(self._min, self._max + 1))
        out = np.zeros((n, self.box_dim + 6), np.float32)
        out[:, : self.box_dim] = rng.standard_normal((n, self.box_dim)).astype(np.float32)
        out[:, self.box_dim] = 640
        out[:, self.box_dim + 1] = 480
        out[:, self.box_dim + 2] = rng.uniform(0, 600, n)
        out[:, self.box_dim + 3] = rng.uniform(0, 440, n)
        out[:, self.box_dim + 4] = rng.uniform(5, 40, n)
        out[:, self.box_dim + 5] = rng.uniform(5, 40, n)
        self._cache[image_id] = (out, n)
        return out, n
