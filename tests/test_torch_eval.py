"""Offline evaluation as a whole: the port against the JAX package (CPU).

Loader batches deduplicate images, so their relating questions take the
shared-image relation route (U * 2 <= B). ``Interpreter.forward`` with
``img_index`` must give JAX's log-probabilities within atol 1e-5 (float32
sums in another order) and equal answer flags and matches; ``VQATrainer``'s
``test``/``test_epoch`` (error vector, counts, hard/easy sets) and
``predict`` (both modes) must equal JAX's on the same ``BatchLoader`` with
the same weights. Checkpoints cross between the packages both ways.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu.compiler.program_compiler import ProgramCompiler
from dfol_vqa_tpu.data.loader import LoadedBatch
from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu.train import checkpoint as jckpt
from dfol_vqa_tpu.train.trainer import ERROR_DIM as JERROR_DIM
from dfol_vqa_tpu.train.trainer import OP_INDEX as JOP_INDEX
from dfol_vqa_tpu.train.trainer import VQATrainer as JVQATrainer
from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy
from dfol_vqa_tpu_torch.data import evalset
from dfol_vqa_tpu_torch.data.transfer import to_device_batch
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.models.interpreter import Interpreter, spec_needs_relations
from dfol_vqa_tpu_torch.train import checkpoint as ckpt
from dfol_vqa_tpu_torch.train import trainer as tr
from tests.jax_batches import JaxLoader


@pytest.fixture(scope="module")
def setup(ontology):
    cfg = evalset.demo_eval_config(tiny=True)
    world = evalset.demo_world(ontology, tiny=True)
    jinterp = JInterpreter(cfg, ontology)
    jparams = jinterp.init_params(jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return cfg, world, jinterp, jparams, Interpreter(cfg, ontology), tparams


def shared_batch(ontology, cfg, world, family, hops, seed):
    """Eight questions on two images: U_pad = 4, so U * 2 <= B."""
    qs = world.generate_family(family, 8, length=hops, seed=seed, image_slice=(0.0, 2.5 / 48),
                               neg_prob=0.3 if family == "exist" else 0.0, id_prefix="sh-")
    compiler = ProgramCompiler(ontology, object_num=cfg.tpu.max_object_num,
                               rel_slots=cfg.tpu.rel_table_size)
    spec, cb = compiler.compile(qs)
    objs, mask, img = world.batch_unique(cb.image_ids, cfg.tpu.max_object_num)
    return LoadedBatch(spec, cb, objs, mask, img)


@pytest.mark.parametrize("family,hops", [("exist", 0), ("exist", 1), ("exist", 2), ("exist", 3),
                                         ("verify_rel", 1), ("verify_rel", 2),
                                         ("query_attr", 0), ("query_attr", 1)])
def test_forward_with_img_index_matches_jax(ontology, setup, monkeypatch, family, hops):
    cfg, world, jinterp, jparams, tinterp, tparams = setup
    lb = shared_batch(ontology, cfg, world, family, hops, seed=10 + hops)
    U, B = lb.objects.shape[0], len(lb.arrays["img_index"])
    assert U * 2 <= B
    calls = []
    shared = om.rel_cache_shared
    monkeypatch.setattr(om, "rel_cache_shared", lambda *a, **k: (calls.append(1),
                                                                 shared(*a, **k))[1])
    want = jinterp.forward(jparams, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
                           {k: jnp.asarray(v) for k, v in lb.arrays.items()}, lb.spec,
                           False, None)
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    with torch.inference_mode():
        got = tinterp.forward(tparams, objs, mask, arrays, lb.spec)
    assert len(calls) == int(spec_needs_relations(lb.spec))  # the shared route, if it relates
    np.testing.assert_allclose(got["log_probability"].numpy(),
                               np.asarray(want["log_probability"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["answer_flags"].numpy(), np.asarray(want["answer_flags"]))
    np.testing.assert_array_equal(got["match"].numpy(), np.asarray(want["match"]))


@pytest.fixture(scope="module")
def loader(ontology, setup):
    cfg, world, *_ = setup
    datasets = evalset.eval_datasets(world, evalset.TINY_MIX, evalset.TINY_BATCH,
                                     evalset.TINY_IMAGES_PER_BATCH, seed=3)
    return evalset.eval_loader(cfg, ontology, world, datasets, keep_original=True)


def test_eval_workload_shares_images(loader):
    batches = list(loader)
    assert [b.spec.terminal_op for b in batches] == ["exist", "exist", "verify_rel", "query_attr"]
    for b in batches:
        assert b.objects.shape[0] == 4 and len(set(b.compiled.image_ids)) <= 4
        assert b.objects.shape[0] * 2 <= len(b.arrays["img_index"])
    assert batches[-1].compiled.question_mask.sum() == 12  # a padded partial batch


def test_test_epoch_and_hardsets_equal_jax(setup, loader, tmp_path):
    cfg, _, jinterp, jparams, tinterp, tparams = setup
    jt = JVQATrainer(cfg, jinterp, hardset_path=str(tmp_path / "jax"))
    tt = tr.VQATrainer(cfg, tinterp, hardset_path=str(tmp_path / "port"), device="cpu")
    want, _ = jt.test(JaxLoader(loader), jparams)
    got, seconds = tt.test(loader, tparams)
    assert tt._prepare_output_metric_dict(got) == jt._prepare_output_metric_dict(want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tt.last_test_counts, jt.last_test_counts)
    assert tt.last_test_counts[0] == 60 and seconds > 0
    for name in ("hard.json", "easy.json"):
        assert (json.loads((tmp_path / "port" / name).read_text())
                == json.loads((tmp_path / "jax" / name).read_text()))


def test_error_buckets_match_jax():
    assert list(tr.OP_INDEX.items()) == list(JOP_INDEX.items())
    assert tr.ERROR_DIM == JERROR_DIM == 17


@pytest.mark.parametrize("submission", [False, True])
def test_predict_equals_jax(setup, loader, submission):
    cfg, _, jinterp, jparams, tinterp, tparams = setup
    jout, tout = io.StringIO(), io.StringIO()
    want = JVQATrainer(cfg, jinterp).predict(JaxLoader(loader), jparams, jout,
                                             is_submission=submission)
    got = tr.VQATrainer(cfg, tinterp, device="cpu").predict(loader, tparams, tout,
                                                           is_submission=submission)
    assert got == want and len(got) == 60
    assert json.loads(tout.getvalue()) == json.loads(jout.getvalue())


def test_test_loads_a_jax_checkpoint(setup, loader, tmp_path):
    """``test(import_path_base=...)`` evaluates the weights in the file."""
    cfg, _, jinterp, _, tinterp, tparams = setup
    other = jinterp.init_params(jax.random.PRNGKey(5))
    jckpt.save(str(tmp_path), cfg.model_name, other, global_step=12)
    want = JVQATrainer(cfg, jinterp).test_epoch(JaxLoader(loader), other)
    tt = tr.VQATrainer(cfg, tinterp, device="cpu")
    got, _ = tt.test(loader, tparams, import_path_base=str(tmp_path))
    np.testing.assert_array_equal(got, want)
    assert tt.global_step == 12


# ----------------------------------------------------------------- checkpoints


def assert_same_params(port_params, jax_tree):
    got = flatten(params_to_numpy(port_params))
    want = flatten(jax.tree.map(np.asarray, jax_tree))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_checkpoint_from_jax_to_port(setup, tmp_path):
    cfg, _, jinterp, jparams, _, tparams = setup
    jckpt.save(str(tmp_path), "m", jparams, global_step=7)
    start = params_from_numpy(jax.tree.map(np.asarray, jinterp.init_params(
        jax.random.PRNGKey(9))))
    loaded, step = ckpt.load(str(tmp_path), "m", start)
    assert step == 7
    assert_same_params(loaded, jparams)
    start_w, loaded_w = (p.relation_network.layers[0].w for p in (start, loaded))
    assert not torch.equal(start_w, loaded_w)  # start is not modified


def test_checkpoint_from_port_to_jax(setup, tmp_path):
    cfg, _, jinterp, _, _, tparams = setup
    path = ckpt.save(str(tmp_path), "m", tparams, global_step=9)
    assert path.endswith("m.npz")
    loaded, step = jckpt.load(str(tmp_path), "m", jinterp.init_params(jax.random.PRNGKey(9)))
    assert step == 9
    assert_same_params(tparams, loaded)


def test_checkpoint_load_is_partial(setup, tmp_path):
    """strict=False: keys absent from the file keep their values; keys of
    modules the port does not hold are ignored."""
    _, _, jinterp, jparams, _, tparams = setup
    flat = flatten(jax.tree.map(np.asarray, jinterp.init_params(jax.random.PRNGKey(3))))
    kept = {k: v for k, v in flat.items() if not k.startswith("relation_network/")}
    kept["calibrator/lstm/w"] = np.zeros(3, np.float32)
    np.savez(tmp_path / "m.npz", **kept)
    loaded, step = ckpt.load(str(tmp_path), "m", tparams)
    assert step == 0
    got = flatten(params_to_numpy(loaded))
    want = flatten(params_to_numpy(tparams))
    for k in got:
        np.testing.assert_array_equal(got[k], want[k] if k.startswith("relation_network/")
                                      else flat[k], err_msg=k)


def test_unported_checkpoint_and_training_paths_raise(setup, tmp_path):
    """Of the checkpoint and training paths only the Orbax backend is still
    unported (ROADMAP queue 6); asynchronous npz writes and ``train`` run
    (``tests/test_torch_train_loop.py``)."""
    cfg, _, _, _, tinterp, tparams = setup
    with pytest.raises(NotImplementedError, match="queue 6"):
        ckpt.save(str(tmp_path), "m", tparams, backend="orbax")
    (tmp_path / "m.orbax").mkdir()
    with pytest.raises(NotImplementedError, match="queue 6"):
        ckpt.load(str(tmp_path), "m", tparams)
    assert callable(tr.VQATrainer(cfg, tinterp, device="cpu").train)
