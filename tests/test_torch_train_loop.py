"""Training as a whole on the CPU: the port against the JAX package.

* One training step, JAX versus port, with the same weights and dropout 0,
  on a per-question-route batch (shuffled over many images, U * 2 > B) and
  a shared-route batch (deduplicated, U * 2 <= B) of every question
  terminal (the workload's ``exist``, ``end``, ``verify_rel`` and
  ``query_attr``, and the other ten from
  ``tests/test_torch_terminals.terminal_batch``): the
  loss within 1e-5 relative; every gradient leaf within 1e-5 * max(1,
  max|JAX|) (float32 sums in another order); the parameters after one
  optimizer step within ``chip_smoke.adam_bound``. On the CPU both packages take
  plain relation tails (expm1 ELU).
* ``VQATrainer.train`` against the JAX trainer (``tpu.train_chunk=1``) for
  two epochs with a validation loader, mid-epoch checkpoints and
  asynchronous saves; the crash save; checkpoints across the packages;
  the dropout route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu.train import checkpoint as jckpt
from dfol_vqa_tpu.train.optim import build_optimizer as jbuild_optimizer
from dfol_vqa_tpu.train.trainer import VQATrainer as JVQATrainer
from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy
from dfol_vqa_tpu_torch.data import evalset, trainset
from dfol_vqa_tpu_torch.data.transfer import to_device_batch
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ops import relation_oracle as ro
from dfol_vqa_tpu_torch.train import checkpoint as ckpt
from dfol_vqa_tpu_torch.train import trainer as tr
from dfol_vqa_tpu_torch.train.optim import Optimizer
from chip_smoke import adam_bound, grads_of, trainable_keys
from tests.jax_batches import JaxLoader
from tests.test_torch_terminals import RELATING, TERMINALS, terminal_batch

GRAD_RTOL = 1e-5


@pytest.fixture(scope="module")
def setup(ontology):
    cfg = trainset.demo_train_config(tiny=True)
    world = evalset.demo_world(ontology, tiny=True)
    jinterp = JInterpreter(cfg, ontology)
    jparams = jinterp.init_params(jax.random.PRNGKey(2))
    return cfg, world, jinterp, jparams, Interpreter(cfg, ontology)


def shuffled_loader(ontology, cfg, world, seed=0):
    return trainset.train_loader(cfg, ontology, world,
                                 trainset.train_datasets(world, trainset.TINY_MIX, seed=seed),
                                 seed=seed)


def shared_loader(ontology, cfg, world):
    datasets = evalset.eval_datasets(world, trainset.TINY_MIX, trainset.TINY_BATCH,
                                     evalset.TINY_IMAGES_PER_BATCH, seed=4)
    return trainset.train_loader(cfg, ontology, world, datasets, shuffle=False)


@pytest.fixture(scope="module")
def batches(ontology, setup):
    cfg, world, *_ = setup
    out = {}
    for route, loader in (("per_question", shuffled_loader(ontology, cfg, world)),
                          ("shared", shared_loader(ontology, cfg, world))):
        for lb in loader:
            out[(route, lb.spec.terminal_op)] = lb
        for term in TERMINALS:
            if (route, term) not in out:
                out[(route, term)] = terminal_batch(ontology, cfg, world, term, route)
    return out


def jax_step(cfg, jinterp, jparams, lb):
    """JAX's loss, gradients and parameters after one optimizer step."""
    arrays = {k: jnp.asarray(v) for k, v in lb.arrays.items()}

    def loss_fn(p):
        out = jinterp.forward(p, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask), arrays,
                              lb.spec, True, jax.random.PRNGKey(0))
        return out["loss"] / jnp.maximum(jnp.sum(arrays["question_mask"]), 1.0)

    loss, grads = jax.value_and_grad(loss_fn)(jparams)
    tx = jbuild_optimizer(cfg, jparams)
    updates, _ = tx.update(grads, tx.init(jparams), jparams)
    new = optax.apply_updates(jparams, updates)
    return float(loss), flatten(jax.tree.map(np.asarray, grads)), flatten(
        jax.tree.map(np.asarray, new))


def check_step(cfg, jinterp, jparams, tinterp, lb, rtol=GRAD_RTOL, floor=1.0):
    """One training step of the port on ``lb`` against ``jax_step``: the
    loss, every gradient leaf within ``rtol`` x max(``floor``, its largest
    value) and the parameters after the optimizer step."""
    want_loss, want_grads, want_params = jax_step(cfg, jinterp, jparams, lb)

    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    start = {k: np.array(v) for k, v in flatten(params_to_numpy(tparams)).items()}
    opt = Optimizer(cfg, tparams)
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    out = tinterp.forward(tparams, objs, mask, arrays, lb.spec, is_training=True)
    loss = out["loss"] / torch.clamp(torch.sum(arrays["question_mask"]), min=1.0)
    loss.backward()
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    got_grads, delta = grads_of(tparams), {}
    for key, got in got_grads.items():
        delta[key] = rtol * max(floor, float(np.abs(want_grads[key]).max()))
        np.testing.assert_allclose(got, want_grads[key], atol=delta[key], rtol=0, err_msg=key)
    opt.step()
    bound = adam_bound(cfg, trainable_keys(cfg, tparams),
                       [(want_grads, got_grads, start, delta)])
    got = flatten(params_to_numpy(tparams))
    assert set(got) == set(want_params)
    for key, want in want_params.items():
        assert np.all(np.abs(got[key] - want) <= bound[key]), key


@pytest.mark.parametrize("route", ["per_question", "shared"])
@pytest.mark.parametrize("term", TERMINALS)
def test_train_step_matches_jax(setup, batches, route, term):
    cfg, _, jinterp, jparams, tinterp = setup
    lb = batches[(route, term)]
    U, B = lb.objects.shape[0], len(lb.arrays["img_index"])
    assert (U * 2 <= B) == (route == "shared")
    check_step(cfg, jinterp, jparams, tinterp, lb)


def test_train_workload_routes(ontology, setup, batches):
    """Every relating batch of the shuffled set takes the per-question route,
    of the deduplicated set the shared route; the terminals are covered."""
    from dfol_vqa_tpu_torch.models.interpreter import spec_needs_relations

    assert {term for _, term in batches} == set(TERMINALS)
    for (route, term), lb in batches.items():
        U, B = lb.objects.shape[0], len(lb.arrays["img_index"])
        assert (U * 2 <= B) == (route == "shared")
        assert spec_needs_relations(lb.spec) == (term in RELATING)


# --------------------------------------------------------------------- trainer


def assert_params_close(port_flat: dict, jax_flat: dict, lr: float, steps: int):
    """After ``steps`` Adam steps an element moves at most ~lr per step, so
    a sign flip of a near-zero gradient computed in another order moves it
    by at most 2 lr per step; elsewhere the two agree far closer."""
    assert set(port_flat) == set(jax_flat)
    for k, v in jax_flat.items():
        diff = np.abs(port_flat[k] - v)
        assert diff.max() <= 2 * lr * steps, k
        assert np.mean(diff <= 1e-3 * lr * steps) > 0.99, k


def test_train_matches_the_jax_trainer(ontology, setup, tmp_path):
    """Two epochs of four steps on the shuffled set, a validation loader,
    mid-epoch checkpoints every 3 steps, asynchronous saves."""
    cfg, world, jinterp, jparams, tinterp = setup
    cfg = trainset.demo_train_config(tiny=True)
    cfg.epoch_num = 2
    cfg.checkpointing_frequency = 3
    cfg.learning_rate = 1e-3
    assert cfg.tpu.async_save and cfg.tpu.train_chunk == 1
    runs = {}
    for name, trainer, params in (
            ("jax", JVQATrainer(cfg, JInterpreter(cfg, ontology)), jparams),
            ("port", tr.VQATrainer(cfg, Interpreter(cfg, ontology), device="cpu"),
             params_from_numpy(jax.tree.map(np.asarray, jparams)))):
        train_ld = shuffled_loader(ontology, cfg, world, seed=1)
        val_ld = shared_loader(ontology, cfg, world)
        if name == "jax":
            train_ld, val_ld = JaxLoader(train_ld), JaxLoader(val_ld)
        out = trainer.train(train_ld, val_ld, params,
                            last_export_path_base=str(tmp_path / name / "last"),
                            best_export_path_base=str(tmp_path / name / "best"), seed=0)
        runs[name] = (trainer, *out)
    jt, jp, jerr, jloss = runs["jax"]
    tt, tp, terr, tloss = runs["port"]
    assert tt.global_step == jt.global_step == 8
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4, atol=0)
    np.testing.assert_array_equal(terr, jerr)
    assert_params_close(flatten(params_to_numpy(tp)), flatten(jax.tree.map(np.asarray, jp)),
                        cfg.learning_rate, 8)
    for sub in ("last", "best"):
        # each package's file loads into the other
        from_jax, step = ckpt.load(str(tmp_path / "jax" / sub), cfg.model_name, tp)
        from_port, jstep = jckpt.load(str(tmp_path / "port" / sub), cfg.model_name, jp)
        assert step == jstep
        assert_params_close(flatten(params_to_numpy(from_jax)),
                            flatten(jax.tree.map(np.asarray, from_port)), cfg.learning_rate, 8)
    for arr, want in (("losses", tloss), ("errors", terr)):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / "best" / f"{arr}.npy"), want)


@pytest.mark.parametrize("reset_step", [False, True])
def test_train_reloads_the_last_checkpoint(ontology, setup, tmp_path, reset_step):
    """``load_model="last"`` starts the repetition from the file's weights and
    step (``reset_step`` zeroes the step), as the JAX trainer does."""
    cfg, world, jinterp, jparams, tinterp = setup
    other = params_from_numpy(jax.tree.map(np.asarray, jinterp.init_params(
        jax.random.PRNGKey(7))))
    ckpt.save(str(tmp_path), cfg.model_name, other, global_step=5)
    want = tr.VQATrainer(cfg, tinterp, device="cpu").train(
        shuffled_loader(ontology, cfg, world), None,
        params_from_numpy(flatten(params_to_numpy(other))))[0]
    trainer = tr.VQATrainer(cfg, tinterp, device="cpu")
    got = trainer.train(shuffled_loader(ontology, cfg, world), None,
                        params_from_numpy(jax.tree.map(np.asarray, jparams)),
                        last_export_path_base=str(tmp_path), load_model="last",
                        reset_step=reset_step)[0]
    assert trainer.global_step == (0 if reset_step else 5) + 4
    for (name, a), (_, b) in zip(got.named_parameters(), want.named_parameters()):
        assert torch.equal(a, b), name


class _Boom:
    """A loader whose second batch raises."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        for k, lb in enumerate(self.loader):
            if k == 1:
                raise RuntimeError("the loader failed")
            yield lb


def test_crash_save_keeps_the_last_good_parameters(ontology, setup, tmp_path):
    cfg, world, _, jparams, tinterp = setup
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    trainer = tr.VQATrainer(cfg, tinterp, device="cpu")
    with pytest.raises(RuntimeError, match="the loader failed"):
        trainer.train(_Boom(shuffled_loader(ontology, cfg, world)), None, tparams,
                      last_export_path_base=str(tmp_path))
    saved, step = ckpt.load(str(tmp_path), cfg.model_name, tparams)
    assert step == 1 == trainer.global_step
    for (name, a), (_, b) in zip(saved.named_parameters(), tparams.named_parameters()):
        assert torch.equal(a, b), name
    before = flatten(jax.tree.map(np.asarray, jparams))
    assert not np.array_equal(flatten(params_to_numpy(saved))["embedding/b"],
                              before["embedding/b"])  # the first step happened


def test_async_save_then_wait_pending(setup, tmp_path):
    """The snapshot is taken at save time: later in-place updates do not
    reach the file, which JAX loads after ``wait_pending``."""
    _, _, jinterp, jparams, _ = setup
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    want = {k: np.array(v) for k, v in flatten(params_to_numpy(tparams)).items()}
    path = ckpt.save(str(tmp_path), "m", tparams, global_step=4, async_write=True)
    with torch.no_grad():
        for p in tparams.parameters():
            p.add_(1.0)
    ckpt.wait_pending()
    assert path.endswith("m.npz")
    loaded, step = jckpt.load(str(tmp_path), "m", jinterp.init_params(jax.random.PRNGKey(9)))
    assert step == 4
    for k, v in flatten(jax.tree.map(np.asarray, loaded)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("dropout,training,plain", [(0.1, True, True), (0.1, False, False),
                                                    (0.0, True, False)])
def test_dropout_sends_the_per_question_route_to_plain_rel_cache(
        setup, monkeypatch, dropout, training, plain):
    """As ``rel_cache_pallas``: active dropout (training, rate > 0) takes the
    plain ``rel_cache`` with its dropout; otherwise the kernel's route."""
    cfg, *_ = setup
    cfg = trainset.demo_train_config(tiny=True)
    cfg.dropout = dropout
    _, _, _, jparams, _ = setup
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    calls = []
    real = om.rel_cache
    monkeypatch.setattr(om, "rel_cache", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    rng = np.random.default_rng(0)
    attr_in = torch.from_numpy(rng.uniform(size=(2, 5, cfg.attr_input_dim)).astype(np.float32))
    pos = torch.from_numpy(rng.uniform(size=(2, 5, 4)).astype(np.float32))
    tok = torch.tensor([[3, 0], [5, 9]], dtype=torch.int32)
    out = ro.rel_cache_kernel(tparams, attr_in, pos, tok, cfg, deterministic=not training,
                              generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 2, 5, 5) and bool(calls) == plain
