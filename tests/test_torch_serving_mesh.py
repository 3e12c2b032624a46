"""Serving over a device mesh in one process (``ServingEngine(mesh=...)``)
against the JAX package's single-device engine, on the CPU.

Meshes of repeated "cpu" devices (``make_local_mesh``), as JAX's tests serve
on virtual CPU devices: ``(2,)``, ``(4,)``, ``(2, 2)`` and ``(4, 2)`` answer
the mixed stream of ``tests/test_torch_serving.py`` and its newer families
exactly as the JAX engine and the port's single-device engine do (JAX's
own ``test_engine_on_mesh_matches_single_device`` holds its mesh equal to
its single device). Tiny widths, the JAX init's weights bridged by
``convert.params_from_numpy``.

Tolerances: answers equal; ``trace`` log-probabilities and attentions within
1e-5 of JAX's; a split head's ``rows`` bitwise equal to the whole head's (a
gather), its ``logits`` within 1e-6 (a column block of a product may be
summed by another kernel, which can move a float32 sum by an ULP). Each
served group runs whole on one data row. A training mesh's data rank holds
a shard of each global batch and carries the global batch's reductions
over the question axis (``trainer.with_global_flags``): a shard's forward
is bitwise equal to the global batch's rows without the calibrator,
within 1e-6 with it (its LSTM products at another row count).
"""

import dataclasses
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from dfol_vqa_tpu import serve as jserve
from dfol_vqa_tpu.config import Config as JConfig
from dfol_vqa_tpu.models import interpreter as jinterp
from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu.ontology import GQAOntology as JOntology
from dfol_vqa_tpu_torch import export, serve
from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
from dfol_vqa_tpu_torch.convert import params_from_numpy
from dfol_vqa_tpu_torch.data.loader import LoadedBatch
from dfol_vqa_tpu_torch.data.transfer import to_device_batch
from dfol_vqa_tpu_torch.models import calibrator as cal
from dfol_vqa_tpu_torch.models import interpreter as interp
from dfol_vqa_tpu_torch.models.oracle import Embedding
from dfol_vqa_tpu_torch.parallel.mesh import (
    VocabShards,
    make_local_mesh,
    serving_replicas,
)
from dfol_vqa_tpu_torch.train.trainer import with_global_flags
from dfol_vqa_tpu_torch.types import batch_any, batch_flags
from tests.test_torch_calibrator import randomize_head
from tests.test_torch_serving import new_family_stream, stream
from tests.test_torch_trace import check_entries
from tests.test_torch_trainable import randomize_op_modules

SHAPES = [(2,), (4,), (2, 2), (4, 2)]
LOGITS_ATOL = 1e-6


def cpu_mesh(shape):
    return make_local_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def single():
    """(JAX engine, the port's single-device engine, the port's world, the
    port's weights, JAX's answers to the mixed stream)."""
    _, _, jworld, jeng = jserve.build_demo_engine(tiny=True, seed=0, max_batch=8)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    _, _, world, teng = serve.build_demo_engine(tiny=True, seed=0, max_batch=8, params=params,
                                                 device="cpu")
    qs = stream(world) + new_family_stream(world)
    want = [r.answers for r in jeng.answer_many(qs)]
    yield jeng, teng, world, params, qs, want
    jeng.stop()
    teng.stop()


def mesh_engine(shape, params, **kw):
    return serve.build_demo_engine(tiny=True, seed=0, params=params, mesh=cpu_mesh(shape),
                                   **kw)[3]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mesh_engine_answers_equal_jax(single, shape):
    _, teng, _, params, qs, want = single
    eng = mesh_engine(shape, params, max_batch=8)
    try:
        got = eng.answer_many(qs)
        assert [r.answers for r in got] == want
        assert [r.answers for r in got] == [r.answers for r in teng.answer_many(qs)]
        assert all(r.batch_size in eng.batch_ladder for r in got)
        # every group ran whole on one data row, the rows in turn
        assert next(eng._turn) == eng.stats["batches"] > shape[0]
        heads = [type(p.embedding) for p in eng._replicas]
        assert len(heads) == shape[0]
        assert set(heads) == {VocabShards if len(shape) > 1 else Embedding}
    finally:
        eng.stop()


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
@pytest.mark.parametrize("family,hops", [("exist", 2), ("verify_rel", 1), ("choose_rel", 1),
                                         ("compare", 1)])
def test_mesh_trace_matches_jax(single, shape, family, hops):
    """``trace`` at rung 1 runs whole on one data row, through the split
    head, every row in turn."""
    jeng, _, world, params, _, _ = single
    q = world.generate_family(family, 1, length=hops, seed=21, id_prefix="tr-")[0]
    want = jeng.trace(q)
    eng = mesh_engine(shape, params, max_batch=8, start=False)
    try:
        for row in range(shape[0]):
            got = eng.trace(q, row=row)
            assert got["hops"]
            check_entries([got], [want])
    finally:
        eng.stop()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("channels", [1, 3], ids=["head", "extra_head"])
def test_vocab_shards_agree_with_the_whole_head(n, channels):
    """``rows`` is a gather, bitwise; ``logits`` within ``LOGITS_ATOL``."""
    gen = torch.Generator().manual_seed(n + channels)
    E, V = 24, 2432
    shape = (E, V) if channels == 1 else (E, V, channels)
    emb = Embedding(torch.randn(shape, generator=gen), torch.randn(shape[1:], generator=gen))
    split = VocabShards(emb, [torch.device("cpu")] * n)
    assert [tuple(w.shape) for w, _ in split.shards()] == [(E, V // n) + shape[2:]] * n
    tok0 = torch.randint(0, V, (5, 7), generator=gen)
    tok0[0, :4] = torch.tensor([0, V - 1, V // n - 1, V // n])  # the shards' edges
    for got, want in zip(split.rows(tok0), emb.rows(tok0)):
        assert torch.equal(got, want)
    h = torch.rand((3, 5, E), generator=gen)
    with torch.no_grad():
        got, want = split.logits(h), emb.logits(h)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(1, 3), (2, 3)], ids=["1x3", "2x3"])
def test_model_axis_that_does_not_divide_keeps_the_head_whole(single, shape):
    """V_pad = 2432 and a model axis of 3: JAX's rule leaves the head whole
    (replicated), and so do the replicas."""
    _, _, _, params, qs, want = single
    eng = mesh_engine(shape, params, max_batch=8)
    try:
        assert all(type(p.embedding) is Embedding for p in eng._replicas)
        assert [r.answers for r in eng.answer_many(qs)] == want
    finally:
        eng.stop()


@pytest.mark.parametrize("shape", [(4,), (3,)], ids=["4", "3"])
def test_rung_the_data_axis_does_not_divide_runs_whole(single, shape):
    """Groups at rungs 1 and 2, which a data axis of 4 or 3 does not
    divide, run whole on one data row, the rows in turn, with unchanged
    answers (as every group does)."""
    jeng, _, world, params, _, _ = single
    qs = world.generate_family("exist", 6, length=1, seed=12)
    want = [r.answers for r in jeng.answer_many(qs)]
    eng = mesh_engine(shape, params, max_batch=2, max_delay_ms=1.0)
    try:
        got = [eng.submit(q).result(timeout=120) for q in qs]
        assert [r.answers for r in got] == want
        assert {r.batch_size for r in got} <= {1, 2}
        assert eng.stats["batches"] == len(qs)
        assert next(eng._turn) == len(qs)  # every group took its turn
    finally:
        eng.stop()


def test_warmup_runs_every_block_shape_on_every_row(single):
    _, _, world, params, qs, _ = single
    eng = mesh_engine((4,), params, max_batch=8)
    try:
        info = eng.warmup(qs[:3], traces=True)
        # every rung and the trace on each of 4 rows
        assert info["batch_sizes"] == [1, 2, 4, 8]
        assert info["runs"] == info["specs"] * (4 * 4 + 4)
        steps = eng._steps_made()
        for r in eng.answer_many(qs[:3]):
            assert r.answers
        assert eng._steps_made() == steps  # nothing met cold
    finally:
        eng.stop()


def jax_cfg(**kw):
    cfg = JConfig(box_features_dim=32, oracle_input_dim=24, word_embedding_dim=16,
                  attribute_network_layers_config=[16], relation_network_layers_config=[16],
                  featurizer_layers_config=[], dropout=0.0, verbose=False, **kw)
    cfg.tpu.max_object_num = 8
    return cfg


@pytest.mark.parametrize("variant", ["trainable_f4", "calibrator"])
def test_variant_on_2x2_equals_jax(single, variant):
    """F = 4 (``embedding_extra`` split over ``model`` too) and the
    attention-transfer calibrator (its GloVe constant on each replica's
    device) on a (2, 2) mesh, against JAX's single-device engine."""
    _, _, world, _, qs, _ = single
    if variant == "trainable_f4":
        kw = dict(oracle_output_dim=4, operator_layers_config=[8])
        jparams = randomize_op_modules(JInterpreter(jax_cfg(**kw), JOntology())
                                       .init_params(jax.random.PRNGKey(5)))
    else:
        kw = dict(activate_attention_transfer=True, attention_transfer_state_dim=8)
        jparams = randomize_head(JInterpreter(jax_cfg(**kw), JOntology())
                                 .init_params(jax.random.PRNGKey(4)))
    sub = stream(world)
    jeng = jserve.ServingEngine(jax_cfg(**kw), JOntology(), jparams, features=world,
                                max_batch=8)
    try:
        want = [r.answers for r in jeng.answer_many(sub)]
    finally:
        jeng.stop()
    cfg = dataclasses.replace(serve.demo_config(tiny=True), **kw)
    eng = serve.ServingEngine(cfg, serve.GQAOntology(),
                              params_from_numpy(jax.tree.map(np.asarray, jparams)),
                              features=world, mesh=cpu_mesh((2, 2)), max_batch=8)
    try:
        assert [r.answers for r in eng.answer_many(sub)] == want
        for p in eng._replicas:
            assert isinstance(p.embedding, VocabShards)
            assert isinstance(p.embedding_extra, VocabShards) == (variant == "trainable_f4")
        if variant == "calibrator":
            assert set(eng._constants(torch.device("cpu"))) == {"embedding"}
    finally:
        eng.stop()


def test_export_and_executables_refuse_a_mesh(single, tmp_path):
    _, _, world, params, qs, _ = single
    eng = mesh_engine((2,), params, start=False)
    try:
        with pytest.raises(ValueError, match="export is single-device"):
            export.export_serving_set(eng, qs[:2], str(tmp_path))
    finally:
        eng.stop()
    with pytest.raises(ValueError, match="single-device"):
        mesh_engine((2,), params, executables={("spec", "meta"): object()}, start=False)
    cfg = serve.demo_config(tiny=True)
    with pytest.raises(ValueError, match="a device or a mesh"):
        serve.ServingEngine(cfg, serve.GQAOntology(), params, features=world, device="cpu",
                            mesh=cpu_mesh((2,)), start=False)


def test_mesh_errors():
    """A mesh whose device does not exist, or whose shape does not cover
    its devices, raises; nothing falls back to one device."""
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="does not exist"):
            make_local_mesh((2,), devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="does not exist"):
        make_local_mesh((1,), devices=[f"cuda:{torch.cuda.device_count()}"])
    with pytest.raises(ValueError, match="covers 4 devices"):
        make_local_mesh((2, 2), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="axes"):
        make_local_mesh((2, 2), ("model", "data"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        make_local_mesh((1,), devices=["meta"])
    mesh = cpu_mesh((4, 2))
    assert (mesh.n_data, mesh.n_model, mesh.fsdp) == (4, 2, False)
    assert mesh.axis_names == ("data", "model")
    assert [len(row) for row in mesh.devices] == [2] * 4


def test_concurrent_submitters_on_a_mesh_all_answered(single):
    _, _, world, params, _, _ = single
    eng = mesh_engine((2, 2), params, max_batch=8, max_delay_ms=2.0)
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


def take_rows(lb: LoadedBatch, start: int, stop: int) -> LoadedBatch:
    """Rows ``[start, stop)`` of a per-question batch (no ``img_index``):
    every array and list of the compiled batch along its question axis."""
    cb, B = lb.compiled, lb.spec.batch_size
    updates = {f.name: getattr(cb, f.name)[start:stop] for f in dataclasses.fields(cb)
               if isinstance(getattr(cb, f.name), (np.ndarray, list))
               and len(getattr(cb, f.name)) == B}
    return LoadedBatch(dataclasses.replace(lb.spec, batch_size=stop - start),
                       dataclasses.replace(cb, **updates), lb.objects[start:stop],
                       lb.obj_mask[start:stop])


@pytest.mark.parametrize("calibrator", [False, True], ids=["plain", "calibrator"])
@pytest.mark.parametrize("family,hops", [("exist", 2), ("verify_rel", 2), ("query_attr", 1),
                                         ("choose_rel", 1)])
def test_row_blocks_compute_the_whole_batch(single, family, hops, calibrator):
    """Contiguous shards of a batch (pad rows included), each carrying the
    OR of every shard's flags (``with_global_flags``, as a training mesh's
    data ranks do), give the whole batch's rows."""
    _, _, world, params, _, _ = single
    cfg = serve.demo_config(tiny=True)
    if calibrator:
        cfg = dataclasses.replace(cfg, activate_attention_transfer=True,
                                  attention_transfer_state_dim=8)
        params = interp.Interpreter(cfg, serve.GQAOntology()).init_params(
            torch.Generator().manual_seed(4))
    qs = world.generate_family(family, 6, length=hops, seed=5, neg_prob=0.3)
    compiler = ProgramCompiler(serve.GQAOntology(), object_num=8,
                               rel_slots=cfg.tpu.rel_table_size)
    spec, cb = serve.pad_batch_rows(*serve.canonicalize_batch(*compiler.compile(qs)), 8)
    objs, mask = world.batch(cb.image_ids, 8)
    lb = LoadedBatch(spec, cb, objs, mask)
    model = interp.Interpreter(cfg, serve.GQAOntology())

    def run(b):
        _, o, m, a = to_device_batch(b, "cpu")
        with torch.inference_mode():
            return model.forward(params, o, m, a, b.spec)

    whole = run(lb)
    blocks = ((0, 4), (4, 8), (6, 8))
    parts = [take_rows(lb, a, b) for a, b in blocks]
    flags = [batch_flags(p.arrays) for p in parts[:2]]  # (0, 4) and (4, 8) cover the batch
    for (a, b), part in zip(blocks, parts):
        with_global_flags(part, flags)
        assert part.compiled.question_ids == cb.question_ids[a:b]
        np.testing.assert_array_equal(part.compiled.question_mask, cb.question_mask[a:b])
        got = run(part)
        lp, want = got["log_probability"].numpy(), whole["log_probability"][a:b].numpy()
        if calibrator:
            np.testing.assert_allclose(lp, want, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(lp, want)
        np.testing.assert_array_equal(got["answer_flags"].numpy(),
                                      whole["answer_flags"][a:b].numpy())


def test_block_reduces_as_its_batch(single):
    """A shard without a negated token whose global batch has one applies
    the lpn round trip as JAX does on the whole batch (log-likelihoods below
    the float32 clamp of -46 move), and the calibrator keeps a select state
    that another shard's rows ask for."""
    ll = torch.tensor([[-60.0, -1.0], [-70.0, -0.5], [-2.0, -80.0], [-3.0, -0.1]])
    tok = np.array([[3], [4], [-5], [6]], np.int32)  # one column; row 2 negated
    flags = batch_flags({f: tok if f == "arg_tok" else np.zeros((4, 1), np.int32)
                         for f in ("arg_tok", "arg_aux", "last_tok", "last_aux", "options")})
    flags = {k: torch.from_numpy(v) for k, v in flags.items()}
    neg = torch.from_numpy(tok[:, 0] < 0).float()
    want = np.asarray(jinterp._apply_negation_exact(ll.numpy(), neg.numpy()))
    for a, b in ((0, 2), (2, 4)):
        any_neg = batch_any(flags, "neg", "arg_tok", (0,))
        got = interp._apply_negation_exact(ll[a:b], neg[a:b], any_neg)
        np.testing.assert_array_equal(got.numpy(), want[a:b])
    alone = interp._apply_negation_exact(ll[:2], neg[:2])  # the block reducing on its own
    assert not np.array_equal(alone.numpy(), want[:2])
    assert batch_any({}, "neg", "arg_tok") is None
    assert bool(batch_any(flags, "nz", "arg_tok", (0,)))
    assert cal._Ctx.any_valid(torch.zeros(2), torch.tensor(True)).item() == 1.0
    assert cal._Ctx.any_valid(torch.zeros(2)).item() == 0.0


def test_device_cache_is_shared_by_threads(single):
    """``embedding_on`` from many threads at once: one tensor per device,
    made once; "cpu" and torch.device("cpu") share it."""
    cfg = dataclasses.replace(serve.demo_config(tiny=True), activate_attention_transfer=True)
    model = interp.Interpreter(cfg, serve.GQAOntology())
    got, lock = [], threading.Lock()

    def worker():
        for d in ("cpu", torch.device("cpu")) * 20:
            t = model.embedding_on(d)
            with lock:
                got.append(t)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 16 * 40 and all(t is got[0] for t in got)
    assert list(model._index_cache) == [("embedding", torch.device("cpu"))]


def test_replicas_hold_the_weights(single):
    """Each replica is a copy on its row's lead device; its split head
    holds the whole head's columns."""
    *_, params, _, _ = single
    mesh = cpu_mesh((2, 2))
    reps = serving_replicas(mesh, params)
    assert len(reps) == 2 and reps[0] is not reps[1]
    for rep in reps:
        whole = torch.cat([w for w, _ in rep.embedding.shards()], dim=1)
        assert torch.equal(whole, params.embedding.w)
        assert torch.equal(rep.attribute_network.layers[0].w, params.attribute_network.layers[0].w)
