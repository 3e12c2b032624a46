"""The hop-by-hop trace and the diagnostics around it: the port against the
JAX package (CPU, tiny widths).

* ``Interpreter.forward(return_trace=True)``: exist, verify_rel, query_attr,
  choose_rel, compare and ``and`` at 0-2 hops, soft and hard, on the
  shared-image route (16 questions on 4 images) and the per-question route
  (shuffled), and with the calibrator (its output head drawn at random, as
  ``tests/test_torch_calibrator.py`` draws it): the same branches and
  slots, every slot's (B, O) log-attention within ``ATOL`` of JAX's
  (float32 sums in another order; the port's forward parity tests use the
  same), log-probabilities within ``ATOL``, answer flags equal, and the
  rest of the output equal to a forward without the trace;
* ``ServingEngine.trace`` (tiny demo engines on one planted world and one
  set of weights): ops, tokens, answers and hop count equal, attentions
  within ``ATOL`` in probability;
* ``viz.trace_to_dict`` on one batch, and ``viz.visualize_loop``'s
  ``traces.json`` from one npz through both trainers;
* ``oracle.full_caches`` and ``oracle.static_attr_cache``;
* ``utils.profiling``: ``span`` with and without a profiler, and
  ``profile_trace`` (its ``dfol.*`` range in ``key_averages`` and the trace).
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu import serve as jserve
from dfol_vqa_tpu import viz as jviz
from dfol_vqa_tpu.models import oracle as jom
from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu.train import checkpoint as jckpt
from dfol_vqa_tpu.train.trainer import VQATrainer as JTrainer
from dfol_vqa_tpu_torch import serve, viz
from dfol_vqa_tpu_torch.convert import params_from_numpy
from dfol_vqa_tpu_torch.data import evalset, trainset
from dfol_vqa_tpu_torch.data.transfer import to_device_batch
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.train.trainer import VQATrainer
from dfol_vqa_tpu_torch.utils import profiling
from tests.test_torch_calibrator import calib_cfg, randomize_head

ATOL = 1e-5
TERMS = ("exist", "verify_rel", "query_attr", "choose_rel", "compare", "and")


def batch_of(ontology, cfg, world, term, hops, route, seed=5):
    """One 16-question batch of ``term`` at ``hops`` hops: on 4 images
    (``route="shared"``) or over the world's images (``"per_question"``)."""
    mix = ((term, hops, trainset.TINY_BATCH),)
    if route == "shared":
        sets = evalset.eval_datasets(world, mix, trainset.TINY_BATCH,
                                     evalset.TINY_IMAGES_PER_BATCH, seed=seed)
        loader = trainset.train_loader(cfg, ontology, world, sets, shuffle=False)
    else:
        loader = trainset.train_loader(cfg, ontology, world,
                                       trainset.train_datasets(world, mix, seed=seed), seed=seed)
    (lb,) = list(loader)
    U, B = lb.objects.shape[0], len(lb.arrays["img_index"])
    assert (U * 2 <= B) == (route == "shared")
    return lb


@pytest.fixture(scope="module")
def setup(ontology):
    cfg = trainset.demo_train_config(tiny=True)
    world = evalset.demo_world(ontology, tiny=True)
    jparams = JInterpreter(cfg, ontology).init_params(jax.random.PRNGKey(4))
    return cfg, world, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def calib_setup(ontology):
    cfg = calib_cfg()
    jparams = randomize_head(JInterpreter(cfg, ontology).init_params(jax.random.PRNGKey(4)))
    return cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def forwards(ontology, cfg, jparams, tparams, lb):
    want = JInterpreter(cfg, ontology).forward(
        jparams, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
        {k: jnp.asarray(v) for k, v in lb.arrays.items()}, lb.spec, False, None,
        return_trace=True)
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    interp = Interpreter(cfg, ontology)
    with torch.inference_mode():
        got = interp.forward(tparams, objs, mask, arrays, lb.spec, return_trace=True)
        plain = interp.forward(tparams, objs, mask, arrays, lb.spec)
    return got, want, plain


def check_trace(got, want, plain):
    assert len(got["trace"]) == len(want["trace"])
    for tb, jb in zip(got["trace"], want["trace"]):
        assert len(tb) == len(jb) > 0
        for t, j in zip(tb, jb):
            assert t.shape == j.shape
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["log_probability"].numpy(),
                               np.asarray(want["log_probability"]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got["answer_flags"].numpy(), np.asarray(want["answer_flags"]))
    assert set(got) == set(plain) | {"trace"}
    for k in plain:
        assert torch.equal(got[k], plain[k]), k


@pytest.mark.parametrize("route", ["shared", "per_question"])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("hops", [0, 1, 2])
@pytest.mark.parametrize("term", TERMS)
def test_forward_trace_matches_jax(ontology, setup, term, hops, hard, route):
    cfg, world, jparams, tparams = setup
    cfg = dataclasses.replace(cfg, hard_mode=hard)
    lb = batch_of(ontology, cfg, world, term, hops, route)
    check_trace(*forwards(ontology, cfg, jparams, tparams, lb))


@pytest.mark.parametrize("route", ["shared", "per_question"])
@pytest.mark.parametrize("term", TERMS)
def test_forward_trace_with_calibrator_matches_jax(ontology, setup, calib_setup, term, route):
    _, world, *_ = setup
    cfg, jparams, tparams = calib_setup
    lb = batch_of(ontology, cfg, world, term, 1, route)
    check_trace(*forwards(ontology, cfg, jparams, tparams, lb))


@pytest.fixture(scope="module")
def engines():
    _, _, world, jeng = jserve.build_demo_engine(tiny=True, seed=0, max_batch=8)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    _, _, tworld, teng = serve.build_demo_engine(tiny=True, seed=0, max_batch=8, params=params,
                                                  device="cpu")
    yield world, jeng, teng
    jeng.stop()
    teng.stop()


def check_entries(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("question_id", "image_id", "terminal_op", "answer", "answers"):
            assert g.get(k) == w.get(k), k
        np.testing.assert_allclose(g["log_probability"], w["log_probability"], atol=ATOL)
        assert len(g["hops"]) == len(w["hops"])
        for hg, hw in zip(g["hops"], w["hops"]):
            assert (hg["branch"], hg["op"], hg["token"]) == (hw["branch"], hw["op"], hw["token"])
            np.testing.assert_allclose(hg["attention"], hw["attention"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("family,hops", [("exist", 2), ("verify_rel", 1), ("query_attr", 1),
                                         ("choose_rel", 1), ("compare", 1), ("and", 2)])
def test_engine_trace_matches_jax(engines, family, hops):
    world, jeng, teng = engines
    q = world.generate_family(family, 1, length=hops, seed=21, id_prefix="tr-")[0]
    got, want = teng.trace(q), jeng.trace(q)
    assert got["hops"]
    check_entries([got], [want])
    assert got["answers"] == teng.answer_many([q])[0].answers
    with pytest.raises(ValueError, match="supervision"):
        teng.trace({**q, "program": {**q["program"], "last_op": {"operator": "scene",
                                                                 "arguments": []}}})


def test_trace_to_dict_matches_jax(ontology, setup):
    cfg, world, jparams, tparams = setup
    lb = batch_of(ontology, cfg, world, "exist", 2, "per_question")
    got, want, _ = forwards(ontology, cfg, jparams, tparams, lb)
    check_entries(viz.trace_to_dict(lb, got, got["trace"]),
                  jviz.trace_to_dict(lb, want, want["trace"]))


def test_visualize_loop_matches_jax(ontology, setup, tmp_path):
    cfg, world, jparams, _ = setup
    jckpt.save(str(tmp_path / "ckpt"), cfg.model_name, jparams)
    mix = (("exist", 1, 6), ("query_attr", 1, 6), ("verify_rel", 2, 4))
    batches = list(trainset.train_loader(cfg, ontology, world,
                                         trainset.train_datasets(world, mix, seed=2),
                                         shuffle=False))
    start = JInterpreter(cfg, ontology).init_params(jax.random.PRNGKey(9))
    tinterp = Interpreter(cfg, ontology)
    got = viz.visualize_loop(VQATrainer(cfg, tinterp, device="cpu"), tinterp, batches,
                             params_from_numpy(jax.tree.map(np.asarray, start)), None,
                             str(tmp_path / "ckpt"), out_dir=str(tmp_path / "port"))
    jinterp = JInterpreter(cfg, ontology)
    want = jviz.visualize_loop(JTrainer(cfg, jinterp), jinterp, batches, start, None,
                               str(tmp_path / "ckpt"), out_dir=str(tmp_path / "jax"))
    assert len(got) == 16
    check_entries(got, want)
    check_entries(json.loads((tmp_path / "port" / "traces.json").read_text()),
                  json.loads((tmp_path / "jax" / "traces.json").read_text()))


def test_full_caches_match_jax(ontology, setup):
    cfg, world, jparams, tparams = setup
    rng = np.random.default_rng(0)
    attr_in = rng.standard_normal((3, 8, cfg.attr_input_dim)).astype(np.float32)
    pos = rng.random((3, 8, 4)).astype(np.float32)
    idx = np.asarray(ontology._relation_index)
    ja, jr = jom.full_caches(jparams, jnp.asarray(attr_in), jnp.asarray(pos), cfg, idx)
    with torch.inference_mode():
        ta, tr = om.full_caches(tparams, torch.from_numpy(attr_in), torch.from_numpy(pos), cfg,
                                idx)
    assert tr.shape == (3, len(idx), 8, 8)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL, rtol=0)


def test_static_attr_cache_matches_jax():
    table = np.random.default_rng(1).standard_normal((2, 5, 7)).astype(np.float32)
    got = om.static_attr_cache(table)
    assert got.shape == (2, 8, 5) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jom.static_attr_cache(table)))
    np.testing.assert_array_equal(om.static_attr_cache(table, -5.0).numpy()[:, 0], -5.0)


def test_profiling_utils(tmp_path):
    profiling.clear()
    with profiling.span("noop", k=1):  # no profiler: recorded all the same
        torch.ones(4) @ torch.ones(4)
    with profiling.profile_trace(str(tmp_path / "prof")) as prof:
        with profiling.span("matmul-span"):
            torch.ones((8, 8)) @ torch.ones((8, 8))
    assert any(e.key == "dfol.matmul-span" for e in prof.key_averages())
    assert not any(e.key == "dfol.noop" for e in prof.key_averages())
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(ev.get("name") == "dfol.matmul-span" for ev in trace["traceEvents"])
    assert [(r[0], r[1], r[4]) for r in profiling.recorded()] == [
        ("noop", threading.get_ident(), {"k": 1}), ("matmul-span", threading.get_ident(), {})]
    assert all(0 <= r[3] - r[2] < 10**10 for r in profiling.recorded())
