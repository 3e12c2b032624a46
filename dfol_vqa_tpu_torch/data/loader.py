"""Batch loader: questions + features -> compiled device batches.

The PyTorch port's own copy of ``dfol_vqa_tpu/data/loader.py``, which it must not import
(the port imports nothing of the JAX package); it behaves exactly as
that module, and tests/test_torch_host.py holds the two equal.

Replaces the reference's DataLoader + collator stack (trainer.py:603-607,
batch_gqa_boxfeatures_pipeline.py): compiles each question batch with the
AOT ProgramCompiler, joins dense padded object features, and prefetches on a
background thread so host IO overlaps device compute.

Each batch's work is three spans (``utils/profiling``) on the thread that
produces it: ``loader.programs`` (the program rows), ``loader.scenes``
(``FeatureSource.gather_unique``) and ``loader.batch`` (``LoadedBatch``).
With ``num_workers > 0`` they run in the worker processes, whose spans the
process that trains does not record.

Where a batch's object block lives: where the process that trains
produces its batches itself (a prefetch thread, or none) and can page-lock
memory (``can_pin``: a card, and not a process forked after CUDA started),
the gather writes the block straight into PyTorch's caching pinned-host
allocator and the batch keeps that tensor (``LoadedBatch.block``), which
``data/transfer.py`` copies to the card with no host copy first. Worker
processes, and processes without a card, gather into numpy arrays. The
gather's one pass also gives each row's int8 scale (``obj_scale``), so the
block is not read again on the host.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch
from typing import Iterator, List, Sequence

from dfol_vqa_tpu_torch.compiler.program_compiler import (
    BucketSpec,
    CompiledBatch,
    ProgramCompiler,
    batch_arrays,
    pack_meta,
)
from dfol_vqa_tpu_torch.data.dataset import ProgramDataset, iter_batches, iter_index_batches
from dfol_vqa_tpu_torch.data.features import GEOM_DIM, FeatureSource, row_scale
from dfol_vqa_tpu_torch.utils.profiling import span


def can_pin() -> bool:
    """Whether this process can page-lock a batch's object block: it sees
    a card, and it is not a child forked after its parent started CUDA."""
    return not torch.cuda._is_in_bad_fork() and torch.cuda.is_available()


class LoadedBatch:
    __slots__ = ("spec", "compiled", "objects", "obj_mask", "arrays", "meta",
                 "obj_scale", "block")

    def __init__(self, spec: BucketSpec, compiled: CompiledBatch, objects, obj_mask,
                 img_index=None, obj_scale=None, block=None):
        self.spec = spec
        self.compiled = compiled
        self.objects = objects  # (U_pad, O, D+6) unique-image scenes
        self.obj_mask = obj_mask  # (U_pad, O)
        # the page-locked tensor ``objects`` views (FeatureSource.gather_unique),
        # kept alive for the copy that reads it, or None
        self.block = block
        self.arrays = batch_arrays(compiled)
        if img_index is not None:
            self.arrays["img_index"] = img_index
        # per-object-row quantization scale for the optional int8 feature
        # transfer (transfer.quantize_objects; features.row_scale), so that
        # device-side dequant uses the exact host scale; ``obj_scale`` where
        # the gather already took it. The geometry rides unquantized in
        # ``obj_geom`` (it is 6 of 2054 columns).
        obj_f32 = np.asarray(objects, np.float32)
        self.obj_scale = row_scale(obj_f32) if obj_scale is None else obj_scale
        self.arrays["obj_scale"] = self.obj_scale
        self.arrays["obj_geom"] = obj_f32[..., -GEOM_DIM:]
        # the arrays' names, shapes and dtypes, which key steps and graphs
        self.meta = pack_meta(self.arrays)

    @property
    def batch_size(self) -> int:
        return int(self.compiled.question_mask.sum())


class PrecompiledDataset:
    """A file-dataset compiled ONCE into per-question tensor rows.

    Because a file holds one bucket (terminal op and similar length), all its
    questions share a single slot grid: compiling the whole file in one
    ProgramCompiler.compile call yields (N, ...) arrays from which any batch
    is a pure row gather — per-batch host compilation disappears and every
    batch from the file shares one BucketSpec (one XLA program)."""

    def __init__(self, dataset: ProgramDataset, compiler: ProgramCompiler,
                 keep_original: bool = False):
        questions = [dataset[i] for i in range(len(dataset))]
        # canonical base compile: choose-option randomness comes only from
        # the per-epoch gather-time permutation (shuffle_choose_options),
        # never from the one-time compile
        old_shuffle = getattr(compiler, "_shuffle_choose", False)
        compiler._shuffle_choose = False
        try:
            self.spec_all, self.cb = compiler.compile(questions, keep_original=keep_original)
        finally:
            compiler._shuffle_choose = old_shuffle
        self.n = len(questions)

    def gather(self, indices, batch_size: int) -> "tuple":
        import dataclasses

        idx = list(indices)
        n_pad = batch_size - len(idx)
        if n_pad:
            idx = idx + [idx[-1]] * n_pad
        sel = np.asarray(idx)
        cb = self.cb
        fields = {}
        for f in dataclasses.fields(type(cb)):
            v = getattr(cb, f.name)
            if isinstance(v, np.ndarray):
                fields[f.name] = v[sel]
            elif isinstance(v, list) and len(v) == self.n:
                fields[f.name] = [v[i] for i in idx]
            else:
                fields[f.name] = v
        out = type(cb)(**fields)
        if n_pad:
            out.question_mask = out.question_mask.copy()
            out.question_mask[-n_pad:] = 0.0
        spec = dataclasses.replace(self.spec_all, batch_size=batch_size)
        return spec, out


def shuffle_choose_options(spec, cb, rng) -> None:
    """Permute each choose question's valid option slots in place.

    Equivalent to the reference's per-epoch choose-option shuffle
    (data_pipeline.py:571-622) applied before compilation: the executor
    scores each option slot from its token alone (option-axis equivariant),
    so permuting the compiled per-slot fields — options, opt_rel_idx,
    answer targets, option strings — is the same augmentation without
    re-running the host compiler every epoch."""
    if spec.terminal_op not in ("choose_attr", "choose_rel"):
        return
    B = cb.options.shape[0]
    for qi in range(B):
        kk = int(cb.opt_mask[qi].sum())
        if kk <= 1:
            continue
        perm = rng.permutation(kk)
        for arr in (cb.options, cb.opt_rel_idx, cb.answer_opt, cb.answer_match):
            if arr is not None and arr.shape[1] >= kk:
                arr[qi, :kk] = arr[qi, perm]
        if cb.option_strings and len(cb.option_strings[qi]) == kk:
            os_q = cb.option_strings[qi]
            cb.option_strings[qi] = [os_q[j] for j in perm]


def _group_by_spec(batches, chunk: int, rng):
    """Reorder an epoch's (dataset_idx, indices) sequence into runs of up to
    ``chunk`` same-dataset batches (one file = one bucket spec), with the
    run order randomized proportionally to each dataset's remaining batches.
    The multiset of batches is exactly preserved; only adjacency changes —
    this is what makes the fused chunk dispatch engage on mixed-family
    epochs, where proportional-random order yields same-spec runs of 1-3."""
    by_di: dict = {}
    for di, indices in batches:
        by_di.setdefault(di, []).append((di, indices))
    out = []
    dis = sorted(by_di)
    remaining = np.asarray([len(by_di[d]) for d in dis], np.float64)
    while remaining.sum() > 0:
        j = rng.choice(len(dis), p=remaining / remaining.sum())
        q = by_di[dis[j]]
        take = min(chunk, len(q))
        out.extend(q[:take])
        del q[:take]
        remaining[j] -= take
    return out


class BatchLoader:
    def __init__(
        self,
        datasets: Sequence[ProgramDataset],
        compiler: ProgramCompiler,
        features: FeatureSource,
        batch_size: int,
        object_num: int,
        *,
        shuffle: bool,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
        keep_original: bool = False,
        precompile: bool = True,
        num_workers: int = 0,
        group_chunk: int = 0,
    ):
        self._datasets = datasets
        self._compiler = compiler
        self._features = features
        self._batch_size = batch_size
        self._O = object_num
        self._shuffle = shuffle
        self._seed = seed
        self._num_shards = num_shards
        self._shard_index = shard_index
        self._prefetch = prefetch
        self._keep_original = keep_original
        self._epoch = 0
        # Per-epoch choose-option shuffling (the reference's anti-position-
        # bias augmentation, data_pipeline.py:571-622) is applied as a
        # gather-time K-axis permutation on the precompiled arrays — the
        # executor is fully equivariant in the option axis (each slot's
        # score depends only on its token), so permuting the compiled slots
        # is exactly equivalent to shuffling before compilation, and the
        # per-question host compile no longer has to rerun every epoch
        # (compiling train files per epoch dominated curriculum host time).
        self._precompile = precompile
        self._shuffle_choose = bool(getattr(compiler, "_shuffle_choose", False))
        self._precompiled = None
        # multi-process batch production (host-side compile/collate/pack is
        # GIL-bound; one prefetch thread caps at ~1 core). Workers shard the
        # deterministic batch sequence i % num_workers == k, so order and
        # content match the single-process path exactly. Requires fork.
        # Workers never touch the device (numpy-only production, os._exit
        # on the way out), the same contract PyTorch DataLoader workers rely on.
        self._num_workers = num_workers
        # >1: reorder each epoch so same-file (= same bucket spec) batches
        # run in group_chunk-length runs — the chunk-fused dispatch then
        # engages on real mixed-family epochs (tpu.group_specs). The batch
        # MULTISET per epoch is unchanged; only the order deviates from the
        # reference's proportional-random file sampling.
        self._group_chunk = group_chunk

    def __len__(self) -> int:
        n = sum(len(d) for d in self._datasets)
        return -(-n // self._batch_size)

    def _get_precompiled(self):
        if self._precompiled is None:
            self._precompiled = [
                PrecompiledDataset(d, self._compiler, self._keep_original)
                for d in self._datasets
            ]
        return self._precompiled

    def _produce(self, pinned: bool) -> Iterator[LoadedBatch]:
        return self._produce_shard(0, 1, pinned)

    def _produce_shard(self, k: int, n: int, pinned: bool = False) -> Iterator[LoadedBatch]:
        """Batches i with i % n == k of the epoch's deterministic sequence,
        their object blocks page-locked with ``pinned``.

        Skipped batches cost only index iteration (no compile/gather), so n
        workers split the host work ~evenly."""
        seed = self._seed + self._epoch
        if self._precompile:
            pre = self._get_precompiled()
            batches = iter_index_batches(
                self._datasets, self._batch_size, shuffle=self._shuffle, seed=seed,
                num_shards=self._num_shards, shard_index=self._shard_index,
            )
            if self._group_chunk > 1 and self._shuffle:
                batches = _group_by_spec(
                    list(batches), self._group_chunk,
                    np.random.default_rng((seed, 0x67726F75)),
                )
            for i, (di, indices) in enumerate(batches):
                if i % n != k:
                    continue
                with span("loader.programs"):
                    spec, cb = pre[di].gather(indices, self._batch_size)
                    if self._shuffle_choose:
                        # per-batch rng (seed, i): loader workers shard batches
                        # by index, so a shared stream would desync them from
                        # the single-process sequence
                        shuffle_choose_options(spec, cb, np.random.default_rng((seed, i)))
                with span("loader.scenes"):
                    g = self._features.gather_unique(cb.image_ids, self._O, pinned=pinned)
                with span("loader.batch"):
                    batch = LoadedBatch(spec, cb, *g)
                yield batch
            return
        for i, (questions, n_pad) in enumerate(iter_batches(
            self._datasets,
            self._batch_size,
            shuffle=self._shuffle,
            seed=seed,
            num_shards=self._num_shards,
            shard_index=self._shard_index,
        )):
            if i % n != k:
                continue
            with span("loader.programs"):
                spec, cb = self._compiler.compile(questions, keep_original=self._keep_original)
                if n_pad:
                    cb.question_mask[-n_pad:] = 0.0
            with span("loader.scenes"):
                g = self._features.gather_unique(cb.image_ids, self._O, pinned=pinned)
            with span("loader.batch"):
                batch = LoadedBatch(spec, cb, *g)
            yield batch

    def _iter_multiprocess(self) -> Iterator[LoadedBatch]:
        import multiprocessing as mp
        import os

        ctx = mp.get_context("fork")
        n = self._num_workers
        if self._precompile:
            self._get_precompiled()  # compile ONCE here; workers inherit by fork
        queues = [ctx.Queue(maxsize=max(1, self._prefetch)) for _ in range(n)]

        def run(k):
            q = queues[k]
            try:
                self._features.fork_reset()  # fresh file handles per process
                for item in self._produce_shard(k, n):
                    q.put(item)
                q.put(None)
            except BaseException:
                import traceback

                q.put(("__worker_error__", traceback.format_exc()))
            finally:
                q.close()
                q.join_thread()
                # skip parent-registered atexit handlers (device clients etc.)
                os._exit(0)

        procs = [ctx.Process(target=run, args=(k,), daemon=True) for k in range(n)]
        for p in procs:
            p.start()
        done = [False] * n
        i = 0
        try:
            while not all(done):
                k = i % n
                i += 1
                if done[k]:
                    continue
                # bounded get + liveness check: a worker killed without
                # enqueueing its sentinel (OOM-kill, hard crash) must raise,
                # not hang the training loop forever
                while True:
                    try:
                        item = queues[k].get(timeout=10.0)
                        break
                    except queue.Empty:
                        if not procs[k].is_alive():
                            raise RuntimeError(
                                f"loader worker {k} died (exitcode="
                                f"{procs[k].exitcode}) without a sentinel"
                            ) from None
                if item is None:
                    done[k] = True
                    continue
                if isinstance(item, tuple) and len(item) == 2 and item[0] == "__worker_error__":
                    raise RuntimeError(f"loader worker {k} failed:\n{item[1]}")
                yield item
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join()

    def __iter__(self) -> Iterator[LoadedBatch]:
        self._epoch += 1
        if self._num_workers > 0:
            yield from self._iter_multiprocess()
            return
        pinned = can_pin()
        if self._prefetch <= 0:
            yield from self._produce(pinned)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        _SENTINEL = object()
        err: List[BaseException] = []

        def worker():
            try:
                for item in self._produce(pinned):
                    q.put(item)
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        t.join()
        if err:
            raise err[0]
