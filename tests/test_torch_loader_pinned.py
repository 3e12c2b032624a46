"""The loader's one-pass scene gather and the object block it hands the
copy to the card (``data/features.gather_unique``, ``data/loader``,
``data/transfer``), on the CPU.

* ``gather_unique`` (and ``LoadedBatch`` built from it, with the scale it
  took) is bitwise equal to the gather it replaced (``np.zeros`` block,
  then the real rows, then the scale over the whole block), kept below as
  ``zeroed_gather`` and ``block_scale``: for U == U_pad and U < U_pad,
  scenes with fewer objects than O (none, too) and more, rows whose
  largest |x| is a negative value, all-zero rows, and junk in a source's
  rows past its object count; in a numpy array, and in a tensor block
  (the page-locked block's stand-in here, ``features.pinned_empty``
  replaced) that arrives full of NaN, as a reused block arrives full of
  an earlier batch;
* a loader's batches: the fork workers' (``num_workers=1``, numpy) equal
  the thread path's, with and without a tensor block;
* ``can_pin`` false keeps plain numpy arrays (no block); true gives each
  batch its block, which ``objects`` views;
* the copy to the device hands the block itself (no host copy), a
  group's stack from blocks equals one from numpy arrays, and the int8 and
  bfloat16 transfers read the same bytes with a block as without;
  ``transfer.stage``'s ``pinned`` tag is 0 off the card;
* the native pass (``csrc/scene_gather.cpp``, built here by the host's C++
  compiler) is bitwise the zeroed gather on every case above, on one
  thread and on three, and on a block split over the threads that
  ``gather_threads`` gives, or more threads than cores; a failed build
  raises.
"""

import os

import numpy as np
import pytest
import torch

from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
from dfol_vqa_tpu_torch.data import features, loader as loader_mod
from dfol_vqa_tpu_torch.data.dataset import ProgramDataset
from dfol_vqa_tpu_torch.data.features import PAD_LADDER, FeatureSource, SyntheticFeatures
from dfol_vqa_tpu_torch.data.loader import BatchLoader, LoadedBatch
from dfol_vqa_tpu_torch.data.synthetic import generate_questions
from dfol_vqa_tpu_torch.data.transfer import chunk_prefetch, to_device_batch
from dfol_vqa_tpu_torch.ontology import GQAOntology
from dfol_vqa_tpu_torch.ops import cuda_build
from dfol_vqa_tpu_torch.utils import profiling

D, O = 16, 6  # feature columns, object slots


def zeroed_gather(source, image_ids, O, pad_ladder=PAD_LADDER):
    """The scene gather the one-pass gather replaced: a zeroed block, then
    each scene's real rows."""
    uniq: dict = {}
    idx = np.zeros(len(image_ids), np.int32)
    for i, im in enumerate(image_ids):
        if im not in uniq:
            uniq[im] = len(uniq)
        idx[i] = uniq[im]
    U = len(uniq)
    U_pad = next((v for v in pad_ladder if U <= v), U)
    objs = np.zeros((U_pad, O, source.box_dim + 6), np.float32)
    mask = np.zeros((U_pad, O), np.float32)
    for im, u in uniq.items():
        row, n = source.image(im)
        n = min(n, O)
        objs[u, :n] = row[:n]
        mask[u, :n] = 1.0
    return objs, mask, idx


def block_scale(objects):
    """The int8 scale as ``LoadedBatch`` took it over the whole block."""
    obj_f32 = np.asarray(objects, np.float32)
    return np.maximum(np.max(np.abs(obj_f32[..., :-6]), axis=-1) / 127.0, 1e-12
                      ).astype(np.float32)


class Rows(FeatureSource):
    """Scenes given whole: image id -> (rows (R, D+6), object count)."""

    box_dim = D

    def __init__(self, scenes):
        self.scenes = scenes

    def image(self, image_id):
        return self.scenes[image_id]


def scene(seed, n, kind="normal", rows=O):
    """``rows`` rows of which the first ``n`` are objects; the rest junk
    that the gather must not copy."""
    rng = np.random.default_rng(seed)
    out = rng.standard_normal((rows, D + 6)).astype(np.float32) * 3
    out[:, D:] = rng.uniform(0, 640, (rows, 6))
    if kind == "negative":  # the largest |x| of each row is a negative value
        out[:, :D] = -np.abs(out[:, :D])
    elif kind == "zero":  # every other object row all zero, geometry too
        out[::2] = 0.0
    elif kind == "nan":  # a NaN among a real row's features
        out[1, 3] = np.nan
    elif kind == "strided":  # rows that are not C-contiguous
        out = np.asfortranarray(out)
    return out, n


CASES = {
    # U == U_pad: four scenes on the ladder's first rung, twelve questions
    "u_eq_upad": ([scene(i, O) for i in range(4)], [0, 1, 2, 3, 0, 1, 2, 3, 3, 2, 1, 0]),
    # U < U_pad: five scenes padded to eight
    "u_lt_upad": ([scene(i, O) for i in range(5)], [4, 3, 2, 1, 0, 0]),
    "fewer_objects": ([scene(0, 1), scene(1, 3), scene(2, 0), scene(3, 5, rows=9)],
                      [0, 1, 2, 3, 1]),
    "more_objects": ([scene(0, 9, rows=9), scene(1, O + 1, rows=8)], [1, 0]),
    "negative_max": ([scene(i, 4, "negative") for i in range(3)], [0, 1, 2]),
    "zero_rows": ([scene(i, n, "zero") for i, n in enumerate((O, 5, 2))], [2, 1, 0, 2]),
    "nan_in_a_row": ([scene(0, 4, "nan"), scene(1, O)], [1, 0]),
    "non_contiguous": ([scene(i, n, "strided") for i, n in enumerate((O, 3, 0))], [0, 2, 1]),
}


@pytest.fixture(scope="module")
def ontology():
    return GQAOntology()


@pytest.fixture(scope="module")
def compiled(ontology):
    """One compiled batch (``LoadedBatch``'s program tensors)."""
    qs = generate_questions(ontology, 4, terminal="exist", length=1, seed=3)
    return ProgramCompiler(ontology, object_num=O, rel_slots=4).compile(qs)


def nan_blocks(monkeypatch):
    """Stand in a NaN-filled CPU tensor for the page-locked block (no card
    here to page-lock with): a block that is not zeroed first."""
    made = []

    def empty(shape):
        made.append(torch.full(shape, float("nan")))
        return made[-1]

    monkeypatch.setattr(features, "pinned_empty", empty)
    return made


def same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what  # bitwise, signs of zeros and NaN bits too


@pytest.mark.parametrize("block", ["numpy", "tensor"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_and_scale_equal_the_zeroed_gather(monkeypatch, compiled, case, block):
    spec, cb = compiled
    scenes, which = CASES[case]
    source = Rows({f"im{i}": s for i, s in enumerate(scenes)})
    ids = [f"im{i}" for i in which]
    made = nan_blocks(monkeypatch)
    g = source.gather_unique(ids, O, pinned=block == "tensor")
    objects, mask, idx = zeroed_gather(source, ids, O)
    same(g.objects, objects, "objects")
    same(g.mask, mask, "mask")
    same(g.img_index, idx, "img_index")
    same(g.scale, block_scale(objects), "scale")
    if block == "tensor":
        assert len(made) == 1 and g.pinned is made[0]
        assert np.shares_memory(g.objects, made[0].numpy())
    else:
        assert g.pinned is None and not made
    got, want = LoadedBatch(spec, cb, *g), LoadedBatch(spec, cb, objects, mask, idx)
    assert got.block is g.pinned and got.meta == want.meta
    same(got.obj_scale, want.obj_scale, "obj_scale")
    for k in want.arrays:
        same(got.arrays[k], want.arrays[k], k)
    # batch_unique is the same gather, returned as before
    for a, b, what in zip(source.batch_unique(ids, O), (objects, mask, idx), "omi"):
        same(a, b, what)


def case_source(case):
    scenes, which = CASES[case]
    return Rows({f"im{i}": s for i, s in enumerate(scenes)}), [f"im{i}" for i in which]


def same_as_zeroed(g, source, ids):
    objects, mask, idx = zeroed_gather(source, ids, O)
    same(g.objects, objects, "objects")
    same(g.mask, mask, "mask")
    same(g.img_index, idx, "img_index")
    same(g.scale, block_scale(objects), "scale")


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("block", ["numpy", "tensor"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_pass_equals_the_zeroed_gather(monkeypatch, case, block, threads):
    source, ids = case_source(case)
    made = nan_blocks(monkeypatch)
    g = source.gather_unique(ids, O, pinned=block == "tensor", threads=threads)
    same_as_zeroed(g, source, ids)
    if block == "tensor":
        assert len(made) == 1 and g.pinned is made[0]
        assert np.shares_memory(g.objects, made[0].numpy())


def test_a_failed_build_raises(monkeypatch):
    def fail(*args, **kwargs):
        raise RuntimeError("c++ failed")

    monkeypatch.setattr(cuda_build, "load", fail)
    features.scene_gather_lib.cache_clear()
    source, ids = case_source("fewer_objects")
    try:
        with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
            source.gather_unique(ids, O)
    finally:
        features.scene_gather_lib.cache_clear()


@pytest.mark.parametrize("threads", [None, 16], ids=["gather_threads", "more_than_cores"])
def test_a_large_block_is_split_over_threads(monkeypatch, threads):
    """Ten scenes of 50-120 rows at the published width: a 6.6 MB block,
    over the one-thread limit, so ``gather_threads`` deals it to up to four
    threads; sixteen threads share its sixteen scenes on fewer cores."""
    lib, asked = features.scene_gather_lib(), []

    class Spy:
        def dfol_scene_gather(self, *args):
            asked.append(args[-1])
            lib.dfol_scene_gather(*args)

    monkeypatch.setattr(features, "scene_gather_lib", Spy)
    source = SyntheticFeatures(box_dim=2048, min_objects=50, max_objects=120, seed=4)
    ids = [f"im{i % 10}" for i in range(23)]
    g = source.gather_unique(ids, 100, threads=threads)
    assert g.objects.nbytes == 16 * 100 * 2054 * 4 >= 4 << 20
    want = threads or max(1, min(4, len(os.sched_getaffinity(0)) - 2))
    assert asked == [want] == [threads or features.gather_threads(g.objects.nbytes)]
    objects, mask, idx = zeroed_gather(source, ids, 100)
    same(g.objects, objects, "objects")
    same(g.mask, mask, "mask")
    same(g.scale, block_scale(objects), "scale")


def test_gather_threads_follow_the_cores_and_the_block(monkeypatch):
    assert features.gather_threads((4 << 20) - 1) == 1
    for cores, want in ((1, 1), (2, 1), (3, 1), (4, 2), (5, 3), (6, 4), (96, 4)):
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid, n=cores: set(range(n)))
        assert features.gather_threads(4 << 20) == want, cores
        assert features.gather_threads((4 << 20) - 1) == 1


def batches(ontology, workers: int, pinned: bool, monkeypatch):
    qs = generate_questions(ontology, 22, terminal="exist", length=2, seed=5)
    comp = ProgramCompiler(ontology, object_num=O, rel_slots=4)
    feats = SyntheticFeatures(box_dim=D, min_objects=2, max_objects=O + 2)
    monkeypatch.setattr(loader_mod, "can_pin", lambda: pinned)
    loader = BatchLoader([ProgramDataset(qs, ontology)], comp, feats, 4, O, shuffle=True,
                         seed=11, prefetch=2, num_workers=workers)
    return list(loader) + list(loader)  # two epochs: the second reshuffles


@pytest.mark.parametrize("pinned", [False, True], ids=["numpy", "tensor"])
def test_fork_workers_equal_the_thread_path(ontology, monkeypatch, pinned):
    made = nan_blocks(monkeypatch)
    thread = batches(ontology, 0, pinned, monkeypatch)
    forked = batches(ontology, 1, pinned, monkeypatch)
    assert len(thread) == len(forked) == 12
    assert len(made) == (12 if pinned else 0)  # only the thread path makes blocks
    for a, b in zip(thread, forked):
        assert a.spec == b.spec and a.compiled.question_ids == b.compiled.question_ids
        assert (a.block is not None) == pinned and b.block is None
        same(a.objects, b.objects, "objects")
        same(a.obj_mask, b.obj_mask, "obj_mask")
        same(a.obj_scale, b.obj_scale, "obj_scale")
        assert a.meta == b.meta and sorted(a.arrays) == sorted(b.arrays)
        for k in a.arrays:
            same(a.arrays[k], b.arrays[k], k)


def test_cannot_pin_keeps_numpy_and_can_pin_gives_blocks(ontology, monkeypatch):
    assert loader_mod.can_pin() == torch.cuda.is_available()
    made = nan_blocks(monkeypatch)
    for b in batches(ontology, 0, False, monkeypatch):
        assert b.block is None and type(b.objects) is np.ndarray
    assert not made
    got = batches(ontology, 0, True, monkeypatch)
    assert [b.block for b in got] == made
    for b in got:
        assert type(b.objects) is np.ndarray and np.shares_memory(b.objects, b.block.numpy())


def test_the_copy_reads_the_block_itself(ontology, monkeypatch):
    made = nan_blocks(monkeypatch)
    with_block = batches(ontology, 0, True, monkeypatch)
    plain = batches(ontology, 0, False, monkeypatch)
    b, p = with_block[0], plain[0]
    _, objects, obj_mask, arrays = to_device_batch(b, "cpu")
    assert objects is b.block  # to the CPU: the tensor itself, no copy
    _, want, want_mask, want_arrays = to_device_batch(p, "cpu")
    same(objects, want, "objects")
    for dtype in ("bfloat16", "int8"):
        got, want = to_device_batch(b, "cpu", dtype)[1], to_device_batch(p, "cpu", dtype)[1]
        assert got.dtype == want.dtype and torch.equal(got.view(torch.uint8),
                                                       want.view(torch.uint8)), dtype
    assert len(made) == len(with_block)


@pytest.mark.parametrize("transfer_dtype", [None, "bfloat16", "int8"])
def test_groups_from_blocks_equal_groups_from_numpy(ontology, monkeypatch, transfer_dtype):
    nan_blocks(monkeypatch)
    with_block = batches(ontology, 0, True, monkeypatch)
    plain = batches(ontology, 0, False, monkeypatch)
    profiling.clear()
    got = list(chunk_prefetch(iter(with_block), 3, "cpu", transfer_dtype=transfer_dtype))
    stages = [r[4] for r in profiling.recorded() if r[0] == "transfer.stage"]
    want = list(chunk_prefetch(iter(plain), 3, "cpu", transfer_dtype=transfer_dtype))
    assert [len(g) for g, *_ in got] == [len(g) for g, *_ in want]
    assert [s["batches"] for s in stages] == [len(g) for g, *_ in got]
    assert all(s["pinned"] == 0 for s in stages)  # nothing is page-locked off the card
    for (_, o1, m1, a1), (_, o2, m2, a2) in zip(got, want):
        assert torch.equal(o1.view(torch.uint8), o2.view(torch.uint8))
        assert torch.equal(m1, m2) and sorted(a1) == sorted(a2)
        for k in a1:
            assert torch.equal(a1[k], a2[k]), k

