"""The serving slice as a whole: the port's engine vs the JAX package's.

Both engines are the tiny demo configuration on the same PlantedWorld and
the same weights (the JAX init, bridged by ``convert.params_from_numpy``).
A stream of ``exist`` (0-2 hops, relate hops and negations included),
``verify_rel``, ``query_attr`` and ``end`` questions must get identical
answer lists, and ``Interpreter.forward`` must give log-probabilities
within atol 1e-5 of JAX's on the same LoadedBatch (float32, CPU).
"""

import dataclasses
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu import serve as jserve
from dfol_vqa_tpu.compiler.program_compiler import ProgramCompiler
from dfol_vqa_tpu.data.loader import LoadedBatch
from dfol_vqa_tpu.models import interpreter as jinterp
from dfol_vqa_tpu_torch import serve
from dfol_vqa_tpu_torch.convert import params_from_numpy
from dfol_vqa_tpu_torch.data.transfer import quantize_objects, to_device_batch
from dfol_vqa_tpu_torch.models import interpreter as interp

torch.backends.cuda.matmul.allow_tf32 = False

# (family, hops, count, negation probability)
STREAM = (("exist", 0, 3, 0.0), ("exist", 1, 3, 0.3), ("exist", 2, 4, 0.3),
          ("verify_rel", 1, 3, 0.0), ("verify_rel", 2, 3, 0.3),
          ("query_attr", 0, 3, 0.0), ("query_attr", 1, 3, 0.0))


def stream(world, seed=0):
    qs = []
    for fi, (fam, hops, n, neg) in enumerate(STREAM):
        qs += world.generate_family(fam, n, length=hops, seed=seed + fi, neg_prob=neg,
                                    id_prefix=f"{fam}{hops}-")
    # a non-terminal last op compiles to the `end` terminal
    qs.append({"program": {"branches": [], "last_op": {"operator": "select",
                                                       "arguments": [world.nouns[0]]}},
               "answer": world.nouns[0], "imageId": world.image_ids[0], "question_id": "end0"})
    return qs


@pytest.fixture(scope="module")
def engines():
    cfg, ont, world, jeng = jserve.build_demo_engine(tiny=True, seed=0, max_batch=8)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    _, _, tworld, teng = serve.build_demo_engine(tiny=True, seed=0, max_batch=8, params=params,
                                                  device="cpu")
    yield cfg, ont, world, jeng, tworld, teng
    jeng.stop()
    teng.stop()


def test_same_planted_world(engines):
    _, _, world, _, tworld, _ = engines
    assert world.image_ids == tworld.image_ids
    o1, m1 = world.batch(world.image_ids[:3], 8)
    o2, m2 = tworld.batch(world.image_ids[:3], 8)
    np.testing.assert_array_equal(o1, o2)
    np.testing.assert_array_equal(m1, m2)


def test_engine_answers_equal_jax(engines):
    *_, world, jeng, _, teng = engines
    qs = stream(world)
    got = teng.answer_many(qs)
    want = jeng.answer_many(qs)
    assert [r.answers for r in got] == [r.answers for r in want]
    assert teng.stats["requests"] >= len(qs)
    assert all(r.latency_ms > 0 and r.batch_size in teng.batch_ladder for r in got)


def batch_of(ont, world, qs, hard=False):
    cfg = serve.demo_config(tiny=True)
    cfg.hard_mode = hard
    compiler = ProgramCompiler(ont, object_num=8, rel_slots=cfg.tpu.rel_table_size)
    spec, cb = serve.canonicalize_batch(*compiler.compile(qs))
    objs, mask = world.batch([q["imageId"] for q in qs], 8)
    return cfg, LoadedBatch(spec, cb, objs, mask)


@pytest.mark.parametrize("family,hops,neg,hard", [
    ("exist", 2, 0.5, False), ("exist", 2, 0.5, True), ("exist", 0, 0.0, True),
    ("verify_rel", 2, 0.3, False), ("query_attr", 1, 0.0, False), ("query_attr", 1, 0.0, True),
])
def test_forward_log_probability_matches_jax(engines, family, hops, neg, hard):
    """Multi-row batches, so the whole-batch quirks (any negated token ->
    lpn on every row; option normalisation) are exercised; hard mode
    includes query_attr's upstream drop to soft aggregation."""
    _, ont, world, jeng, _, teng = engines
    qs = world.generate_family(family, 4, length=hops, seed=77, neg_prob=neg,
                               id_prefix="fw-")
    cfg, lb = batch_of(ont, world, qs, hard)
    want = jinterp.Interpreter(cfg, ont).forward(
        jeng.params, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
        {k: jnp.asarray(v) for k, v in lb.arrays.items()}, lb.spec, False, None)
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    with torch.inference_mode():
        got = interp.Interpreter(cfg, ont).forward(teng.params, objs, mask, arrays, lb.spec)
    np.testing.assert_allclose(got["log_probability"].numpy(),
                               np.asarray(want["log_probability"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["answer_flags"].numpy(), np.asarray(want["answer_flags"]))
    np.testing.assert_allclose(got["match"].numpy(), np.asarray(want["match"]), atol=1e-6)


def test_decode_answer_flags_matches_jax(engines):
    _, ont, world, *_ = engines
    rng = np.random.default_rng(0)
    for fam in ("exist", "query_attr", "verify_rel"):
        qs = world.generate_family(fam, 3, length=1, seed=5, id_prefix="dec-")
        _, lb = batch_of(ont, world, qs)
        width = max(1, lb.spec.n_options)
        flags = rng.uniform(size=(3, width)) < 0.5
        assert (interp.decode_answer_flags(flags, lb.spec, lb.compiled)
                == jinterp.decode_answer_flags(flags, lb.spec, lb.compiled))


def test_host_transforms_equal_jax(engines):
    """canonicalize / pad / concat are copies of the JAX package's."""
    _, ont, world, *_ = engines
    compiler = ProgramCompiler(ont, object_num=8, rel_slots=8)
    qs = (world.generate_family("exist", 2, length=0, seed=1)
          + world.generate_family("exist", 2, length=2, seed=2))
    spec, cb = compiler.compile(qs)
    for fn, args in ((serve.canonicalize_batch, ()), (serve.pad_batch_rows, (8,))):
        jfn = getattr(jserve, fn.__name__)
        s1, c1 = fn(spec, cb, *args)
        s2, c2 = jfn(spec, cb, *args)
        assert s1 == s2
        for f in dataclasses.fields(c1):
            a, b = getattr(c1, f.name), getattr(c2, f.name)
            assert (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b), f.name
    s1, c1 = serve.concat_batches(spec, [cb, cb])
    s2, c2 = jserve.concat_batches(spec, [cb, cb])
    assert s1 == s2 and np.array_equal(c1.arg_tok, c2.arg_tok)
    assert serve.branch_structure(spec.grid[0]) == jserve.branch_structure(spec.grid[0])
    assert serve.canonical_grid(2, 1) == jserve.canonical_grid(2, 1)


def test_transfer_dtypes(engines):
    _, ont, world, *_ = engines
    qs = world.generate_family("exist", 2, length=1, seed=3)
    _, lb = batch_of(ont, world, qs)
    _, objs, mask, arrays = to_device_batch(lb, "cpu", "bfloat16")
    assert objs.dtype == torch.bfloat16 and mask.dtype == torch.float32
    assert set(arrays) == set(lb.arrays)
    assert arrays["arg_tok"].dtype == torch.int32
    _, objs, _, arrays = to_device_batch(lb, "cpu", "int8")
    assert objs.dtype == torch.int8 and arrays["obj_scale"].dtype == torch.float32
    np.testing.assert_array_equal(objs.numpy(), quantize_objects(lb.objects, lb.obj_scale))
    with pytest.raises(ValueError):
        to_device_batch(lb, "cpu", "float16")


# ------------------------------------------------------------ engine policy


def tiny_engine(**kw):
    cfg, ont, world, eng = serve.build_demo_engine(tiny=True, seed=0, device="cpu", **kw)
    return world, eng


def test_batching_policy():
    """max_batch splits greedily; max_delay flushes stragglers."""
    world, eng = tiny_engine(max_batch=4, max_delay_ms=60.0)
    try:
        qs = world.generate_family("exist", 6, length=0, seed=5)
        futs = [eng.submit(q) for q in qs]
        assert all(f.result(timeout=120).batch_size == 4 for f in futs[:4])
        assert all(f.result(timeout=120).batch_size == 2 for f in futs[4:])
        assert eng.stats["batches"] >= 2
    finally:
        eng.stop()


def test_admission_control_and_plan_cache():
    world, eng = tiny_engine(max_batch=4, max_delay_ms=10_000.0, max_pending=3)
    try:
        qs = world.generate_family("exist", 4, length=1, seed=6)
        futs = [eng.submit(q) for q in qs[:3]]
        with pytest.raises(serve.EngineOverloaded):
            eng.submit(qs[3])
        assert eng.stats["rejected"] == 1
        eng.flush()
        first = [f.result(timeout=120).answers for f in futs]
        again = [r.answers for r in eng.answer_many(qs[:3])]
        assert again == first
        assert eng.stats["plan_hits"] >= 3
    finally:
        eng.stop()


def test_warmup_covers_every_rung():
    world, eng = tiny_engine(max_batch=4, batch_ladder=(1, 2, 4))
    try:
        qs = world.generate_family("verify_rel", 3, length=1, seed=8)
        info = eng.warmup(qs)
        assert info["batch_sizes"] == [1, 2, 4] and info["runs"] == info["specs"] * 3
    finally:
        eng.stop()


def test_engine_rejects_bad_requests(monkeypatch):
    with pytest.raises(ValueError):
        tiny_engine(max_batch=128)
    world, eng = tiny_engine(max_batch=4)
    try:
        for term in ("object_attr", "object_rel", "scene"):  # supervision, not questions
            with pytest.raises(ValueError, match=term):
                eng.submit({"program": {"branches": [], "last_op": {"operator": term,
                                                                    "arguments": []}},
                            "imageId": world.image_ids[0]})
        # a group whose execution raises fails its futures, not the dispatcher
        real = interp.Interpreter.execute

        def execute(self, params, world_, arrays, spec, *args, **kw):
            if spec.terminal_op == "choose_attr":
                raise RuntimeError("execution failed")
            return real(self, params, world_, arrays, spec, *args, **kw)

        monkeypatch.setattr(interp.Interpreter, "execute", execute)
        q = world.generate_family("choose_attr", 1, length=0, seed=9)[0]
        with pytest.raises(RuntimeError, match="execution failed"):
            eng.answer_many([q])
        assert eng.answer_many(world.generate_family("exist", 1, seed=1))[0].answers
    finally:
        eng.stop()


# the ten question families of the terminals slice, (family, hops, count)
NEW_FAMILIES = (("verify_attrs", 1, 3), ("choose_attr", 0, 3), ("choose_rel", 0, 2),
                ("choose_rel", 2, 2), ("and", 1, 3), ("or", 2, 3), ("all_same", 1, 2),
                ("all_different", 0, 2), ("two_same", 1, 2), ("two_different", 0, 2),
                ("compare", 1, 3))


def new_family_stream(world):
    return [q for fi, (fam, hops, n) in enumerate(NEW_FAMILIES)
            for q in world.generate_family(fam, n, length=hops, seed=40 + fi,
                                           id_prefix=f"{fam}{hops}-")]


def test_engine_answers_new_families_equal_jax(engines):
    *_, world, jeng, _, teng = engines
    qs = new_family_stream(world)
    assert len({q["program"]["last_op"]["operator"] for q in qs}) == 10
    got = teng.answer_many(qs)
    assert [r.answers for r in got] == [r.answers for r in jeng.answer_many(qs)]
    assert all(r.answers for r in got)


def test_coarse_ladder_engine_answers_like_the_default(engines):
    """One canonical grid (``seg_ladder=(3,)``, ``fill_ladder=(4,)``): every
    request pads to it, and the answers are the default engine's."""
    *_, world, _, _, teng = engines
    qs = stream(world) + new_family_stream(world)
    _, coarse = tiny_engine(max_batch=8, seg_ladder=(3,), fill_ladder=(4,), params=teng.params)
    try:
        got = coarse.answer_many(qs)
        assert {r.spec.grid[0] for r in got} == {serve.canonical_grid(3, 4)}
        assert [r.answers for r in got] == [r.answers for r in teng.answer_many(qs)]
    finally:
        coarse.stop()


def test_coarse_ladder_falls_through_past_its_top(engines):
    """A branch with 4 relate segments or 5 fillers in one segment is past
    the coarse ladder's top rung: it keeps its own size, and is answered as
    the default engine answers it."""
    *_, world, _, _, teng = engines
    img = world.image_ids[3]
    rel = {"operator": "relate", "arguments": [world.relations[0], True, world.nouns[1]]}
    flt = {"operator": "filter", "arguments": [world.attrs[0]]}
    sel = {"operator": "select", "arguments": [world.nouns[0]]}
    qs = [{"program": {"branches": [ops], "last_op": {"operator": "exist", "arguments": []}},
           "answer": "yes", "imageId": img, "question_id": f"deep{k}"}
          for k, ops in enumerate(([sel] + [rel] * 4, [sel] + [flt] * 5 + [rel]))]
    _, coarse = tiny_engine(max_batch=8, seg_ladder=(3,), fill_ladder=(4,), params=teng.params)
    try:
        got = coarse.answer_many(qs)
        assert [serve.branch_structure(r.spec.grid[0]) for r in got] == [(4, 4), (3, 5)]
        assert [r.answers for r in got] == [r.answers for r in teng.answer_many(qs)]
    finally:
        coarse.stop()


def test_shared_image_route_not_ported(engines):
    """Two questions on one image (U * 2 <= B) take the shared-image route
    (``oracle.rel_cache_shared``) and give JAX's log-probabilities."""
    _, ont, world, jeng, _, teng = engines
    qs = world.generate_family("verify_rel", 2, length=1, seed=10)
    cfg, lb = batch_of(ont, world, qs)
    lb.arrays["img_index"] = np.zeros(2, np.int32)  # both rows on the first one's image
    want = jinterp.Interpreter(cfg, ont).forward(
        jeng.params, jnp.asarray(lb.objects[:1]), jnp.asarray(lb.obj_mask[:1]),
        {k: jnp.asarray(v) for k, v in lb.arrays.items()}, lb.spec, False, None)
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    with torch.inference_mode():
        got = interp.Interpreter(cfg, ont).forward(teng.params, objs[:1], mask[:1], arrays,
                                                   lb.spec)
    np.testing.assert_allclose(got["log_probability"].numpy(),
                               np.asarray(want["log_probability"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["answer_flags"].numpy(), np.asarray(want["answer_flags"]))


def test_concurrent_submitters_all_answered():
    """Many client threads submitting at once: every future resolves, and
    the request count is exact."""
    world, eng = tiny_engine(max_batch=8, max_delay_ms=2.0)
    qs = world.generate_family("exist", 24, length=1, seed=11)
    futs, lock = [], threading.Lock()

    def client(chunk):
        for q in chunk:
            f = eng.submit(q)
            with lock:
                futs.append(f)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(qs[i::12],)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert len([f.result(timeout=120) for f in futs]) == len(qs)
        assert eng.stats["requests"] == len(qs)
    finally:
        sys.setswitchinterval(old)
        eng.stop()


def test_port_never_imports_jax():
    code = ("import sys, dfol_vqa_tpu_torch, dfol_vqa_tpu_torch.serve, "
            "dfol_vqa_tpu_torch.convert, dfol_vqa_tpu_torch.ops.relation_oracle, "
            "dfol_vqa_tpu_torch.ops.pair_mlp, dfol_vqa_tpu_torch.ops.shared_contract, "
            "dfol_vqa_tpu_torch.train.trainer, dfol_vqa_tpu_torch.train.checkpoint, "
            "dfol_vqa_tpu_torch.data.evalset, dfol_vqa_tpu_torch.data.transfer, chip_smoke; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300, cwd=root)
