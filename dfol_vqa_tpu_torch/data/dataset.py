"""Program datasets and bucketed batch sampling.

The PyTorch port's own copy of ``dfol_vqa_tpu/data/dataset.py``, which it must not import
(the port imports nothing of the JAX package); it behaves exactly as
that module, and tests/test_torch_host.py holds the two equal.

TPU-first rework of the reference data pipeline (src/nsvqa/data/
data_pipeline.py:294-900). The reference relies on torch DataLoader worker
processes; here datasets are lightweight readers and batching is bucketed by
construction: a batch is always drawn from ONE file-dataset (the reference's
MultiSetSampler invariant, data_pipeline.py:808-820), and files are
segregated by terminal op (and optionally program length) by the
preprocessor — which is exactly what keeps the executor's static bucket
signatures few.

Supports both reference on-disk formats: JSON-lines program files and the
fixed-shape int32 HDF5 encoding.
"""

from __future__ import annotations

import json
import os
from os.path import isfile, join, splitext
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from dfol_vqa_tpu_torch.compiler.h5_codec import ProgramH5Codec
from dfol_vqa_tpu_torch.ontology import GQAOntology


class ProgramDataset:
    """One JSON-lines or HDF5 question file (ProgramDataset analog,
    data_pipeline.py:294-453).

    ``in_memory=False`` reads lazily — byte-offset indexed JSON lines or
    per-index HDF5 reads — with an LRU decode cache, mirroring the
    reference's linecache + OrderedDict cache (data_pipeline.py:309-313,
    337-380)."""

    def __init__(self, input_file, ontology: GQAOntology, in_memory: bool = True,
                 max_cache_size: int = 100000):
        self._ont = ontology
        self._codec = ProgramH5Codec(ontology)
        self._h5_cols: Optional[Dict[str, np.ndarray]] = None
        self._h5_file: Optional[str] = None
        self._h5_handle = None
        self._rows: Optional[List[dict]] = None
        self._offsets: Optional[List[int]] = None
        self._path: Optional[str] = None
        self._cache: "object" = None
        self._max_cache = max_cache_size

        if isinstance(input_file, (list, tuple)):
            self._rows = list(input_file)
        elif splitext(input_file)[1] == ".h5":
            import h5py

            if in_memory:
                with h5py.File(input_file, "r") as f:
                    self._h5_cols = {k: np.asarray(f[k]) for k in f.keys()}
                self._n = self._h5_cols["image_id"].shape[0]
            else:
                self._h5_file = input_file
                with h5py.File(input_file, "r") as f:
                    self._n = f["image_id"].shape[0]
                import collections

                self._cache = collections.OrderedDict()
        else:
            if in_memory:
                with open(input_file, "r") as f:
                    self._rows = [json.loads(line) for line in f if line.strip()]
            else:
                self._path = input_file
                self._offsets = []
                with open(input_file, "rb") as f:
                    off = f.tell()
                    for line in f:
                        if line.strip():
                            self._offsets.append(off)
                        off = f.tell()
                self._n = len(self._offsets)
                import collections

                self._cache = collections.OrderedDict()
        if self._rows is not None:
            self._n = len(self._rows)

    def __len__(self) -> int:
        return self._n

    def _cached(self, idx, produce):
        if self._cache is None:
            return produce()
        if idx in self._cache:
            return self._cache[idx]
        v = produce()
        if len(self._cache) >= self._max_cache:
            self._cache.popitem(last=False)
        self._cache[idx] = v
        return v

    def _decode_h5_row(self, c, idx):
        return self._codec.decode_row(
            int(c["answer"][idx]),
            int(c["image_id"][idx]),
            c["branch_ops"][idx],
            c["branch_args"][idx],
            int(c["last_op"][idx]),
            c["last_args"][idx],
        )

    def __getitem__(self, idx: int) -> dict:
        if self._rows is not None:
            return self._rows[idx]
        if self._h5_cols is not None:
            return self._decode_h5_row(self._h5_cols, idx)
        if self._h5_file is not None:
            def produce():
                if self._h5_handle is None:
                    import h5py

                    self._h5_handle = h5py.File(self._h5_file, "r")
                return self._decode_h5_row(self._h5_handle, idx)

            return self._cached(idx, produce)

        def produce():
            with open(self._path, "rb") as f:
                f.seek(self._offsets[idx])
                return json.loads(f.readline())

        return self._cached(idx, produce)

    @property
    def terminal_op(self) -> str:
        return self[0]["program"]["last_op"]["operator"]


class GQADataManager:
    """Directory scanner -> list of file datasets (data_pipeline.py:875-900)."""

    def __init__(self, data_path, ontology: GQAOntology, in_memory: bool = True,
                 max_cache_size: int = 100000):
        if isinstance(data_path, (list, tuple)) or isfile(data_path):
            self.datasets = [ProgramDataset(data_path, ontology, in_memory, max_cache_size)]
        else:
            files = sorted(
                join(data_path, f)
                for f in os.listdir(data_path)
                if isfile(join(data_path, f)) and (f.endswith(".json") or f.endswith(".h5"))
            )
            self.datasets = [
                ProgramDataset(f, ontology, in_memory, max_cache_size) for f in files
            ]

    def __len__(self) -> int:
        return sum(len(d) for d in self.datasets)


def iter_index_batches(
    datasets: Sequence[ProgramDataset],
    batch_size: int,
    *,
    shuffle: bool,
    seed: int = 0,
    drop_last: bool = False,
    num_shards: int = 1,
    shard_index: int = 0,
):
    """Yield (dataset_index, row_indices) with the same sampling policy as
    iter_batches (the MultiSetSampler invariants), without materialising the
    question dicts — used by the precompiled fast path."""
    rng = np.random.default_rng(seed)
    orders = []
    for ds in datasets:
        idx = np.arange(len(ds))
        if shuffle:
            rng.shuffle(idx)
        idx = idx[shard_index::num_shards]
        orders.append(list(idx))
    cursors = [0] * len(datasets)

    def remaining(i):
        return len(orders[i]) - cursors[i]

    while True:
        rem = np.array([remaining(i) for i in range(len(datasets))], np.float64)
        if rem.sum() <= 0:
            break
        if shuffle:
            di = int(rng.choice(len(datasets), p=rem / rem.sum()))
        else:
            di = int(np.argmax(rem > 0))
        take = min(batch_size, remaining(di))
        sel = orders[di][cursors[di] : cursors[di] + take]
        cursors[di] += take
        if take < batch_size and drop_last:
            continue
        yield di, sel


def iter_batches(
    datasets: Sequence[ProgramDataset],
    batch_size: int,
    *,
    shuffle: bool,
    seed: int = 0,
    drop_last: bool = False,
    num_shards: int = 1,
    shard_index: int = 0,
    pad_to_batch: bool = True,
) -> Iterator[List[dict]]:
    """Yield question-dict batches, each drawn from a single file-dataset.

    shuffle=True follows MultiSetSampler (data_pipeline.py:787-826): pick a
    dataset with probability proportional to its remaining length, then take
    its next batch. shuffle=False is MultiSetSequencialSampler (…:829-871).
    ``num_shards``/``shard_index`` implement per-host sharding, making the
    reference's dormant DistributedSampler plumbing (…:793-801) real.

    ``pad_to_batch`` repeats the last question to fill partial batches (the
    padded rows carry question_mask=0 downstream) so bucket shapes stay
    static.
    """
    rng = np.random.default_rng(seed)
    orders = []
    for ds in datasets:
        idx = np.arange(len(ds))
        if shuffle:
            rng.shuffle(idx)
        idx = idx[shard_index::num_shards]
        orders.append(list(idx))

    cursors = [0] * len(datasets)

    def remaining(i):
        return len(orders[i]) - cursors[i]

    while True:
        rem = np.array([remaining(i) for i in range(len(datasets))], np.float64)
        if rem.sum() <= 0:
            break
        if shuffle:
            p = rem / rem.sum()
            di = int(rng.choice(len(datasets), p=p))
        else:
            di = int(np.argmax(rem > 0))
        take = min(batch_size, remaining(di))
        sel = orders[di][cursors[di] : cursors[di] + take]
        cursors[di] += take
        if take < batch_size and drop_last:
            continue
        batch = [datasets[di][j] for j in sel]
        n_pad = 0
        if pad_to_batch and len(batch) < batch_size:
            n_pad = batch_size - len(batch)
            batch = batch + [batch[-1]] * n_pad
        yield batch, n_pad
