"""Chunked dispatch on the CPU: the port against the JAX package.

The JAX package runs ``tpu.train_chunk`` / ``tpu.eval_chunk`` same-bucket
batches in one dispatch and checks ``checkpointing_frequency`` only at
those dispatch boundaries; the port runs the same chunks (one CUDA graph a
chunk on the card, eagerly here) at the same boundaries.

* ``chunk_prefetch``'s groups against JAX's (``tests/test_chunk_prefetch``):
  the tail flush, a spec / meta / shape boundary forcing a flush,
  ``chunk=1``, int8 per batch, the producer's error; a group of one is
  ``to_device_batch``'s tensors.
* ``VQATrainer.train`` over one run of six same-bucket batches at
  ``train_chunk=4`` (groups of 4 and 2), ``pad_chunks`` on and off,
  ``checkpointing_frequency=3``, against the JAX trainer from one init:
  the global steps at which validation ran equal JAX's (4, then the
  epoch's end at 6; a per-step check would validate at 3 and 6), the
  parameters within the train loop's Adam bound and the epoch loss within
  1e-4, the error vectors equal.
* The port pads nothing: a short group under ``pad_chunks`` runs its own
  steps only, bitwise as many sequential steps (parameters, Adam's state,
  and at dropout 0.1 the generator), and equals JAX's padded chunk
  (``_train_step_chunk_padded``, whose padded steps are gated no-ops,
  ``tests/test_chunk_padding``); ``pad_chunks`` changes nothing in a full
  chunk; a short eval group reaches ``forward_many`` at its own length.
* ``test_epoch`` and ``predict`` at ``eval_chunk=4`` (groups of 4 and 2)
  equal ``eval_chunk=1`` and JAX's chunked evaluation
  (``tests/test_chunk_mesh``): error vectors, counts and predictions
  equal, every batch's log-probabilities within 1e-6, answer flags and
  matches bitwise.
* Two gloo ranks (``chip_smoke.mesh_worker`` through ``run_mesh_job``, as
  ``tests/test_torch_mesh.py`` runs them): ``train`` at ``train_chunk=4``
  takes one device's chunk boundaries, where a rank's own shard would
  group otherwise, validates at the same steps and ends at the same
  parameters.
"""

import copy
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dfol_vqa_tpu.compiler.program_compiler import pack_arrays as jpack_arrays
from dfol_vqa_tpu.data.device_prefetch import chunk_prefetch as jchunk_prefetch
from dfol_vqa_tpu.data.device_prefetch import quantize_objects as jquantize
from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu.train.optim import build_optimizer as jbuild_optimizer
from dfol_vqa_tpu.train.trainer import VQATrainer as JVQATrainer
from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy
from dfol_vqa_tpu_torch.data import evalset, trainset
from dfol_vqa_tpu_torch.data.features import SyntheticFeatures
from dfol_vqa_tpu_torch.data.transfer import chunk_prefetch, group_batches, to_device_batch
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.train import trainer as tr
from dfol_vqa_tpu_torch.train.optim import Optimizer

from tests.test_torch_mesh import CHILD_TIMEOUT, FEATURES, mesh_data, questions  # noqa: F401
from tests.jax_batches import JaxLoader
from tests.test_torch_train_loop import assert_params_close

LR = 1e-3


# ------------------------------------------------------------ chunk_prefetch


class FakeBatch:
    """What both packages' ``chunk_prefetch`` read of a ``LoadedBatch``:
    ``packed`` (JAX) is the concatenation of ``arrays`` (the port)."""

    def __init__(self, spec, meta, objects, seed):
        rng = np.random.default_rng(seed)
        self.spec, self.meta, self.objects = spec, meta, objects
        self.obj_mask = rng.random(objects.shape[:2]).astype(np.float32)
        self.arrays = {"a": rng.random((3, 2)).astype(np.float32),
                       "b": rng.integers(0, 9, (5,)).astype(np.int32)}
        self.packed = np.concatenate([self.arrays["a"].ravel(),
                                      self.arrays["b"].view(np.float32)])
        self.obj_scale = np.maximum(np.max(np.abs(objects[..., :-6]), axis=-1) / 127.0,
                                    1e-12).astype(np.float32)


def fake(spec="s0", meta="m0", shape=(3, 4, 10), seed=0):
    rng = np.random.default_rng(100 + seed)
    return FakeBatch(spec, meta, rng.standard_normal(shape).astype(np.float32), seed)


def both(batches, chunk, transfer_dtype=None):
    """(port's groups, JAX's groups) of ``batches``."""
    got = list(chunk_prefetch(iter(batches), chunk, "cpu", transfer_dtype=transfer_dtype))
    want = list(jchunk_prefetch(iter(batches), chunk, transfer_dtype=transfer_dtype))
    return got, want


def assert_same_groups(got, want):
    assert [g for g, *_ in got] == [g for g, *_ in want]
    for (g, objs, masks, arrays), (_, jobjs, jmasks, jpacks) in zip(got, want):
        np.testing.assert_array_equal(objs.numpy(), np.asarray(jobjs))
        np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
        packed = np.concatenate([arrays["a"].numpy().reshape(len(g), -1),
                                 arrays["b"].numpy().view(np.float32)], axis=1)
        np.testing.assert_array_equal(packed, np.asarray(jpacks))


def test_chunk_prefetch_tail_flush_matches_jax():
    batches = [fake(seed=i) for i in range(5)]
    got, want = both(batches, 2)
    assert [len(g) for g, *_ in got] == [2, 2, 1]
    assert_same_groups(got, want)


@pytest.mark.parametrize("field", ["spec", "meta", "shape"])
def test_chunk_prefetch_boundary_matches_jax(field):
    other = {"spec": dict(spec="s1"), "meta": dict(meta="m1"), "shape": dict(shape=(2, 4, 10))}
    batches = [fake(seed=0), fake(seed=1), fake(seed=2, **other[field]),
               fake(seed=3, **other[field])]
    got, want = both(batches, 4)
    assert [len(g) for g, *_ in got] == [2, 2]
    assert_same_groups(got, want)


def test_chunk_prefetch_chunk_one_matches_jax():
    batches = [fake(seed=i) for i in range(3)]
    got, want = both(batches, 1)
    assert [len(g) for g, *_ in got] == [1, 1, 1]
    assert_same_groups(got, want)


def test_chunk_prefetch_int8_per_batch_matches_jax():
    batches = [fake(seed=i) for i in range(2)]
    got, want = both(batches, 2, "int8")
    assert got[0][1].dtype == torch.int8
    np.testing.assert_array_equal(got[0][1].numpy(), np.stack(
        [jquantize(b.objects, b.obj_scale) for b in batches]))
    assert_same_groups(got, want)


def test_chunk_prefetch_producer_error_reaches_the_caller():
    def gen():
        yield fake(seed=0)
        raise ValueError("boom")

    for run in (lambda: list(chunk_prefetch(gen(), 4, "cpu")),
                lambda: list(jchunk_prefetch(gen(), 4))):
        with pytest.raises(ValueError, match="boom"):
            run()


def test_group_of_one_is_to_device_batch(ontology):
    """At ``chunk=1`` every group is one batch, its tensors
    ``to_device_batch``'s with a leading axis of one."""
    cfg = evalset.demo_eval_config(tiny=True)
    world = evalset.demo_world(ontology, tiny=True)
    batches = list(eval_loader(ontology, cfg, world))
    got = list(chunk_prefetch(iter(batches), 1, "cpu", transfer_dtype="int8"))
    assert [g[0] for g in got] == [[b] for b in batches]
    for (_, o, m, a), b in zip(got, batches):
        _, wo, wm, wa = to_device_batch(b, "cpu", "int8")
        assert torch.equal(o, wo[None]) and torch.equal(m, wm[None])
        assert set(a) == set(wa) and all(torch.equal(a[k], wa[k][None]) for k in a)


# ------------------------------------------------------------ training


@pytest.fixture(scope="module")
def setup(ontology):
    cfg = trainset.demo_train_config(tiny=True)
    world = evalset.demo_world(ontology, tiny=True)
    jparams = JInterpreter(cfg, ontology).init_params(jax.random.PRNGKey(2))
    return cfg, world, jparams


def chunk_config(pad: bool, chunk: int = 4):
    cfg = trainset.demo_train_config(tiny=True)
    cfg.epoch_num = 1
    cfg.checkpointing_frequency = 3
    cfg.learning_rate = LR
    cfg.tpu.train_chunk = chunk
    cfg.tpu.pad_chunks = pad
    return cfg


def run_loader(ontology, cfg, world):
    """Six shuffled batches of one ``exist`` file: one spec, one shape."""
    files = trainset.train_datasets(world, (("exist", 2, 6 * trainset.TINY_BATCH),), seed=5)
    return trainset.train_loader(cfg, ontology, world, files, seed=1)


def eval_loader(ontology, cfg, world):
    """Four ``exist`` batches then two ``query_attr`` ones, four images a
    batch (the shared route)."""
    files = evalset.eval_datasets(world, (("exist", 2, 64), ("query_attr", 1, 32)),
                                  evalset.TINY_BATCH, evalset.TINY_IMAGES_PER_BATCH, seed=6)
    return evalset.eval_loader(cfg, ontology, world, files)


def recording(trainer):
    """Record ``trainer.global_step`` at each ``test_epoch``."""
    steps, real = [], trainer.test_epoch

    def test_epoch(loader, params):
        steps.append(trainer.global_step)
        return real(loader, params)

    trainer.test_epoch = test_epoch
    return steps


@pytest.mark.parametrize("pad", [True, False])
def test_chunked_train_validates_where_jax_does(ontology, setup, tmp_path, pad):
    """Fails where validation is checked after every step (3 and 6)."""
    _, world, jparams = setup
    cfg = chunk_config(pad)
    assert [len(g) for g in group_batches(run_loader(ontology, cfg, world), 4)] == [4, 2]
    runs = {}
    for name, trainer, params in (
            ("jax", JVQATrainer(cfg, JInterpreter(cfg, ontology)), jparams),
            ("port", tr.VQATrainer(cfg, Interpreter(cfg, ontology), device="cpu"),
             params_from_numpy(jax.tree.map(np.asarray, jparams)))):
        steps = recording(trainer)
        train_ld, val_ld = run_loader(ontology, cfg, world), eval_loader(ontology, cfg, world)
        if name == "jax":
            train_ld, val_ld = JaxLoader(train_ld), JaxLoader(val_ld)
        out = trainer.train(train_ld, val_ld, params,
                            last_export_path_base=str(tmp_path / name / "last"),
                            best_export_path_base=str(tmp_path / name / "best"))
        runs[name] = (trainer, steps, *out)
    jt, jsteps, jp, jerr, jloss = runs["jax"]
    tt, tsteps, tp, terr, tloss = runs["port"]
    assert jsteps == [4, 6]
    assert tsteps == jsteps
    assert tt.global_step == jt.global_step == 6
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4, atol=0)
    np.testing.assert_array_equal(terr, jerr)
    assert_params_close(flatten(params_to_numpy(tp)), flatten(jax.tree.map(np.asarray, jp)),
                        LR, 6)


def adam_state(opt):
    return [t.detach().clone() for t in opt._state_tensors()]


def chunk_inputs(ontology, cfg, world, n):
    batches = list(run_loader(ontology, cfg, world))[:n]
    (group, objects, obj_mask, arrays), = list(chunk_prefetch(iter(batches), n, "cpu"))
    return group, objects, obj_mask, arrays


def test_padded_steps_are_exact_no_ops(ontology, setup):
    """A group of three at ``train_chunk=8`` with ``pad_chunks``, which
    the JAX package pads to eight: the port's chunk equals three sequential
    steps bitwise (parameters, Adam's state, losses) and JAX's padded chunk
    (``_train_step_chunk_padded``), whose five padded steps are no-ops."""
    _, world, jparams = setup
    cfg = chunk_config(True, chunk=8)
    start = jax.tree.map(np.asarray, jparams)
    group, objects, obj_mask, arrays = chunk_inputs(ontology, cfg, world, 3)
    interp = Interpreter(cfg, ontology)
    seq, padded = params_from_numpy(start), params_from_numpy(start)
    trainer = tr.VQATrainer(cfg, interp, device="cpu")
    opt_seq, opt_pad = Optimizer(cfg, seq), Optimizer(cfg, padded)
    seq_losses = []
    for b in group:
        seq_losses.append(trainer.compute_grads(seq, b))
        opt_seq.step()
    losses = trainer._train_chunk(padded, opt_pad, group, objects, obj_mask, arrays, None)
    assert losses.shape == (3,)
    assert torch.equal(losses, torch.stack(seq_losses))
    for (name, a), (_, b) in zip(seq.named_parameters(), padded.named_parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(adam_state(opt_seq), adam_state(opt_pad)):
        assert torch.equal(a, b)
    assert float(opt_pad.adam.state[opt_pad.trainable[0]]["step"]) == 3.0

    jinterp = JInterpreter(cfg, ontology)
    jt = JVQATrainer(cfg, jinterp)
    jt._tx = jbuild_optimizer(cfg, start)
    jp = jax.device_put(start)
    pad = lambda x: jt._pad_chunk(jnp.asarray(x), 8)  # noqa: E731
    jp, _, jlosses, _, _ = jt._train_step_chunk_padded(group[0].spec, group[0].meta, 8)(
        jp, jt._tx.init(jp), pad(np.stack([b.objects for b in group])),
        pad(np.stack([b.obj_mask for b in group])), pad(np.stack([jpack_arrays(b.arrays, b.meta) for b in group])),
        jax.random.PRNGKey(0), np.int32(3))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses)[:3], rtol=1e-5)
    assert_params_close(flatten(params_to_numpy(padded)), flatten(jax.tree.map(np.asarray, jp)),
                        LR, 3)


def test_full_padded_chunk_equals_unpadded(ontology, setup):
    """A full chunk of four, ``pad_chunks`` off and on: the same losses,
    parameters and Adam state bitwise (the port does not read the
    flag)."""
    _, world, jparams = setup
    start = jax.tree.map(np.asarray, jparams)
    group, objects, obj_mask, arrays = chunk_inputs(ontology, chunk_config(True), world, 4)
    out = []
    for pad in (False, True):
        cfg = chunk_config(pad)
        params = params_from_numpy(start)
        opt = Optimizer(cfg, params)
        losses = tr.VQATrainer(cfg, Interpreter(cfg, ontology), device="cpu")._train_chunk(
            params, opt, group, objects, obj_mask, arrays, None)
        out.append((losses, [p.detach().clone() for p in params.parameters()],
                    adam_state(opt)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1] + out[0][2], out[1][1] + out[1][2]):
        assert torch.equal(a, b)


# ------------------------------------------------------------ evaluation


@pytest.fixture(scope="module")
def eval_setup(ontology):
    cfg = evalset.demo_eval_config(tiny=True, stream_dtype="float32")
    world = evalset.demo_world(ontology, tiny=True)
    jinterp = JInterpreter(cfg, ontology)
    jparams = jinterp.init_params(jax.random.PRNGKey(1))
    return cfg, world, jinterp, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def port_eval(ontology, cfg, world, tparams, chunk):
    cfg.tpu.eval_chunk = chunk
    trainer = tr.VQATrainer(cfg, Interpreter(cfg, ontology), device="cpu")
    outs = list(trainer._eval_chunked(eval_loader(ontology, cfg, world), tparams))
    error = trainer.test_epoch(eval_loader(ontology, cfg, world), tparams)
    preds = trainer.predict(eval_loader(ontology, cfg, world), tparams, io.StringIO())
    return outs, error, trainer.last_test_counts, preds


def test_chunked_eval_equals_per_batch_and_jax(ontology, eval_setup):
    cfg, world, jinterp, jparams, tparams = eval_setup
    assert [len(g) for g in group_batches(eval_loader(ontology, cfg, world), 4)] == [4, 2]
    one = port_eval(ontology, cfg, world, tparams, 1)
    four = port_eval(ontology, cfg, world, tparams, 4)
    cfg.tpu.eval_chunk = 4
    jt = JVQATrainer(cfg, jinterp)
    jouts = jt._eval_chunked(JaxLoader(eval_loader(ontology, cfg, world)), jparams)
    jerror = jt.test_epoch(JaxLoader(eval_loader(ontology, cfg, world)), jparams)
    jpreds = jt.predict(JaxLoader(eval_loader(ontology, cfg, world)), jparams, io.StringIO())
    assert len(one[0]) == len(four[0]) == len(jouts) == 6
    for (b1, o1), (b4, o4), (_, jo) in zip(one[0], four[0], jouts):
        assert b1.compiled.question_ids == b4.compiled.question_ids
        for k in ("answer_flags", "match"):
            np.testing.assert_array_equal(o4[k].numpy(), o1[k].numpy(), err_msg=k)
            np.testing.assert_array_equal(o4[k].numpy(), np.asarray(jo[k]), err_msg=k)
        np.testing.assert_allclose(o4["log_probability"].numpy(), o1["log_probability"].numpy(),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(o4["log_probability"].numpy(),
                                   np.asarray(jo["log_probability"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(four[1], one[1])
    np.testing.assert_array_equal(four[1], jerror)
    np.testing.assert_array_equal(four[2], one[2])
    np.testing.assert_array_equal(four[2], jt.last_test_counts)
    assert four[3] == one[3] == jpreds


@pytest.mark.parametrize("case", ["train", "eval"])
def test_a_short_group_runs_its_own_steps_only(ontology, setup, eval_setup, case):
    """Under ``pad_chunks`` the port pads no short group. Training: three
    batches at ``train_chunk=8`` and dropout 0.1 run three forwards and
    leave the parameters, Adam's state and the dropout generator where
    three sequential ``compute_grads`` + ``opt.step()`` leave them (padded
    steps would draw five more steps' masks). Evaluation: at
    ``eval_chunk=4`` the group of two reaches ``forward_many`` with a
    leading axis of two."""
    if case == "eval":
        cfg, world, _, _, tparams = eval_setup
        cfg = copy.deepcopy(cfg)
        cfg.tpu.eval_chunk = 4
        cfg.tpu.pad_chunks = True
        trainer = tr.VQATrainer(cfg, Interpreter(cfg, ontology), device="cpu")
        lengths, real = [], trainer.interp.forward_many

        def forward_many(params, objects, *rest):
            lengths.append(objects.shape[0])
            return real(params, objects, *rest)

        trainer.interp.forward_many = forward_many
        outs = list(trainer._eval_chunked(eval_loader(ontology, cfg, world), tparams))
        assert len(outs) == 6 and lengths == [4, 2]
        assert all(o["match"].shape == outs[0][1]["match"].shape for _, o in outs)
        return
    _, world, jparams = setup
    cfg = chunk_config(True, chunk=8)
    cfg.dropout = 0.1
    start = jax.tree.map(np.asarray, jparams)
    group, objects, obj_mask, arrays = chunk_inputs(ontology, cfg, world, 3)
    trainer = tr.VQATrainer(cfg, Interpreter(cfg, ontology), device="cpu")
    seq, chunked = params_from_numpy(start), params_from_numpy(start)
    opt_seq, opt_chunk = Optimizer(cfg, seq), Optimizer(cfg, chunked)
    gen_seq, gen_chunk = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    seq_losses = []
    for b in group:
        seq_losses.append(trainer.compute_grads(seq, b, gen_seq))
        opt_seq.step()
    forwards, real = [], trainer.interp.forward

    def forward(*args, **kwargs):
        forwards.append(args[1].shape)
        return real(*args, **kwargs)

    trainer.interp.forward = forward
    losses = trainer._train_chunk(chunked, opt_chunk, group, objects, obj_mask, arrays,
                                  gen_chunk)
    assert len(forwards) == 3
    assert torch.equal(losses, torch.stack(seq_losses))
    assert torch.equal(gen_chunk.get_state(), gen_seq.get_state())
    for a, b in zip(list(seq.parameters()) + adam_state(opt_seq),
                    list(chunked.parameters()) + adam_state(opt_chunk)):
        assert torch.equal(a, b)
    assert float(opt_chunk.adam.state[opt_chunk.trainable[0]]["step"]) == 3.0


# ------------------------------------------------------------ the mesh


def test_two_gloo_ranks_take_one_devices_chunks(ontology, mesh_data, tmp_path):
    """An ``exist`` file of two batches, then a ``verify_rel`` file whose
    first batch has 8 images and whose second has 3: one device groups
    them [2], [1], [1] (U_pad 8, then 4), while each rank's half of either
    ``verify_rel`` batch has U_pad 4. Validation after every chunk."""
    cfg, ont, _, evals, job = mesh_data
    vr = (questions(ont, "verify_rel", 8, 1, 5, 1) + questions(ont, "verify_rel", 8, 1, 6, 3))
    train = [questions(ont, "exist", 16, 2, 1, 8), vr]
    path = str(tmp_path / "train.json")
    with open(path, "w") as f:
        json.dump(train, f)
    spec = {"chunk": 4, "every": 1}
    res = chip_smoke.run_mesh_job(dict(job, name="chunked", datasets=path, mesh_shape=[2],
                                       mesh_axes=["data"], fsdp=False, train=spec), 2,
                                  str(tmp_path / "mesh"), CHILD_TIMEOUT)
    one_cfg = chip_smoke.train_job_config(job, spec)
    features = SyntheticFeatures(**{k: v for k, v in FEATURES.items() if k != "kind"})
    groups = [len(g) for g in group_batches(
        chip_smoke.mesh_loader(one_cfg, ont, features, train, job["batch"]), 4)]
    assert groups == [2, 1, 1]
    rank_groups = [len(g) for g in group_batches(chip_smoke.mesh_loader(
        one_cfg, ont, features, train, job["batch"] // 2, 2, 0), 4)]
    assert rank_groups == [2, 2]  # a rank's own shapes would chunk otherwise
    trainer = tr.VQATrainer(one_cfg, Interpreter(one_cfg, ont), device="cpu")
    steps = recording(trainer)
    with np.load(job["weights"]) as w:
        params = params_from_numpy({k: w[k] for k in w.files})
    trainer.train(chip_smoke.mesh_loader(one_cfg, ont, features, train, job["batch"]),
                  chip_smoke.mesh_loader(one_cfg, ont, features, evals, job["batch"]), params)
    assert steps == [2, 3, 4, 4]
    for r in res:
        assert r["validation_steps"] == steps
    with np.load(os.path.join(str(tmp_path / "mesh"), "trained.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert_params_close(got, flatten(params_to_numpy(params)), one_cfg.learning_rate, 4)
