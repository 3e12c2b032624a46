"""The question terminals: the port against the JAX package (CPU).

Every question terminal (the 13 planted families and ``end`` statements,
``evalset.TERMINAL_HOPS``), soft and hard, on a deduplicated batch (16
questions on 4 images: U * 2 <= B, the shared-image relation route) and a
shuffled one (16 questions over the world's images: U * 2 > B, the
per-question route, plain on the CPU). ``Interpreter.forward`` must give
JAX's log-probabilities within atol 1e-5 (float32 sums in another order)
and equal answer flags and matches; a relating batch must have taken its
route. Training steps of these terminals against ``jax.value_and_grad`` and
optax are in ``tests/test_torch_train_loop.py``; the supervision terminals,
``rel_scores_for_pairs`` and the logic gates in
``tests/test_torch_supervision.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu_torch.convert import params_from_numpy
from dfol_vqa_tpu_torch.data import evalset, trainset
from dfol_vqa_tpu_torch.data.planted import ALL_FAMILIES
from dfol_vqa_tpu_torch.data.transfer import to_device_batch
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.models.interpreter import Interpreter, spec_needs_relations

TERMINALS = [t for t, _ in evalset.TERMINAL_HOPS]
RELATING = {"exist", "end", "verify_attrs", "verify_rel", "choose_rel", "and", "or", "all_same",
            "all_different"}


def terminal_batch(ontology, cfg, world, term, route, seed=5):
    """One 16-question batch of ``term`` at its ``TERMINAL_HOPS`` hops:
    deduplicated on 4 images (``route="shared"``) or shuffled over the
    world's images (``"per_question"``)."""
    mix = ((term, dict(evalset.TERMINAL_HOPS)[term], trainset.TINY_BATCH),)
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
def batches(ontology, setup):
    cfg, world, *_ = setup
    return {(term, route): terminal_batch(ontology, cfg, world, term, route)
            for term in TERMINALS for route in ("shared", "per_question")}


def test_terminals_cover_every_question_family(batches):
    assert set(TERMINALS) == set(ALL_FAMILIES) | {"end"} and len(TERMINALS) == 14
    for (term, _), lb in batches.items():
        assert lb.spec.terminal_op == term
        assert spec_needs_relations(lb.spec) == (term in RELATING)


@pytest.mark.parametrize("route", ["shared", "per_question"])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("term", TERMINALS)
def test_terminal_matches_jax(ontology, setup, batches, monkeypatch, term, hard, route):
    cfg, _, jparams, tparams = setup
    cfg = dataclasses.replace(cfg, hard_mode=hard)
    lb = batches[(term, route)]
    calls = {"shared": 0, "per_question": 0}
    for name, key in (("rel_cache_shared", "shared"), ("rel_cache", "per_question")):
        real = getattr(om, name)
        monkeypatch.setattr(om, name, lambda *a, _r=real, _k=key, **k: (
            calls.__setitem__(_k, calls[_k] + 1), _r(*a, **k))[1])
    want = JInterpreter(cfg, ontology).forward(
        jparams, jnp.asarray(lb.objects), jnp.asarray(lb.obj_mask),
        {k: jnp.asarray(v) for k, v in lb.arrays.items()}, lb.spec, False, None)
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    with torch.inference_mode():
        got = Interpreter(cfg, ontology).forward(tparams, objs, mask, arrays, lb.spec)
    relating = int(term in RELATING)
    assert calls == {"shared": relating * (route == "shared"),
                     "per_question": relating * (route == "per_question")}
    lp = got["log_probability"].numpy()
    assert np.isfinite(lp).all()
    np.testing.assert_allclose(lp, np.asarray(want["log_probability"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["answer_flags"].numpy(), np.asarray(want["answer_flags"]))
    np.testing.assert_array_equal(got["match"].numpy(), np.asarray(want["match"]))
