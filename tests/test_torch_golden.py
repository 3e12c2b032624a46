"""The JAX goldens that the port meets on the GPU (``chip_smoke.py`` phases 5, 7-9, 11-13).

``tests/data/torch_port_golden.npz`` holds the tiny demo engine's weights,
a dozen compiled requests and the JAX package's log-probabilities and
answers for them; ``tests/data/torch_port_golden_eval.npz`` holds a tiny
offline-eval workload (loader batches with shared images), JAX's
log-probabilities and answer flags per batch, and its ``test_epoch`` error
vector and ``predict`` output; ``tests/data/torch_port_golden_train.npz``
holds one training step (loss, gradients, the optimizer's change of every
parameter) on a per-question-route and a shared-route batch;
``tests/data/torch_port_golden_terminals.npz`` holds one batch per terminal
(the 14 question terminals on the shared route and the 3 supervision
terminals, with the eval golden's weights), JAX's log-probabilities,
answer flags and matches in soft and hard mode, and the supervision
terminals' loss and gradients; ``tests/data/torch_port_golden_calibrator.npz``
holds the calibrator model (output head at random, oracle frozen) on every
terminal's batch and the F = 4 model (operator modules' final layers at
random) on six, eval and training-mode log-probabilities, answer flags and
matches, and one training step of each; ``tests/data/torch_port_golden_trace.npz``
holds ``ServingEngine.trace`` of a dozen requests (hops, attentions,
log-probabilities, answers); ``tests/data/torch_port_golden_bf16.npz``
holds ``compute_dtype="bfloat16"`` at production widths (three shared-route
batches; the weights' and scenes' digests, JAX's log-probabilities and
answer flags); ``tests/data/torch_port_golden_chunk.npz`` holds one epoch
of JAX's chunked training (``train_chunk=8``, ``pad_chunks``,
``checkpointing_frequency=3``, 11 batches): the global steps and error
vectors of its validations, the epoch loss and the parameters' change.
All eight are regenerated here and
must match the checked-in copies, so they cannot go stale; and the port, on
the CPU, must meet them with the checks ``chip_smoke.py`` runs on the card
(atol 1e-5 here, float32 on the same host type; 1e-4 on the card).
"""

import importlib.util
import os

import numpy as np
import torch

import chip_smoke

torch.backends.cuda.matmul.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script():
    path = os.path.join(ROOT, "scripts", "make_torch_golden.py")
    spec = importlib.util.spec_from_file_location("make_torch_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_current(fresh, path):
    stored = np.load(path)
    assert set(fresh) == set(stored.files)
    for k, v in fresh.items():
        if k.endswith(("/log_probability", "/attention")):
            # XLA:CPU may vectorise differently on another host type
            np.testing.assert_allclose(v, stored[k], atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(v, stored[k], err_msg=k)
    assert os.path.getsize(path) < 300_000


def test_golden_is_current():
    fresh = load_script().build_golden()
    assert sum(k.endswith("/question") for k in fresh) >= 12
    assert_current(fresh, chip_smoke.GOLDEN)


def test_port_meets_golden_on_cpu():
    assert chip_smoke.check_golden("cpu", atol=1e-5) >= 12


def test_trace_golden_is_current():
    fresh = load_script().build_trace_golden()
    assert sum(k.endswith("/hops") for k in fresh) == 12
    assert_current(fresh, chip_smoke.TRACE_GOLDEN)


def test_port_meets_trace_golden_on_cpu():
    assert chip_smoke.check_trace_golden("cpu", atol=1e-5) == 12


def test_eval_golden_is_current():
    fresh = load_script().build_eval_golden()
    assert sum(k.endswith("/log_probability") for k in fresh) == 4
    assert_current(fresh, chip_smoke.EVAL_GOLDEN)


def test_port_meets_eval_golden_on_cpu():
    assert chip_smoke.check_eval_golden("cpu", atol=1e-5) == 4


def test_train_golden_is_current():
    """Loss and gradients within 1e-6 of their largest value (XLA:CPU may
    vectorise differently on another host type); each parameter's change
    within ``adam_bound`` of the stored one."""
    from dfol_vqa_tpu_torch.convert import params_from_numpy

    script = load_script()
    fresh = script.build_train_golden()
    stored = np.load(chip_smoke.TRAIN_GOLDEN)
    assert set(fresh) == set(stored.files)
    cfg = script.train_golden_setup()[0]
    start = {k[len("params/"):]: v for k, v in fresh.items() if k.startswith("params/")}
    trainable = chip_smoke.trainable_keys(cfg, params_from_numpy(start))
    for route in ("per_question", "shared"):
        p = f"batch/{route}/"
        grads = {k[len(p + "grads/"):]: v for k, v in fresh.items() if k.startswith(p + "grads/")}
        old = {k: stored[p + "grads/" + k] for k in grads}
        delta = {k: 1e-6 * max(1.0, float(np.abs(v).max())) for k, v in grads.items()}
        bound = chip_smoke.adam_bound(cfg, trainable, [(grads, old, start, delta)])
        for key, v in bound.items():
            assert np.all(np.abs(fresh[p + "update/" + key] - stored[p + "update/" + key]) <= v)
    for k, v in fresh.items():
        if "/update/" in k:
            continue
        if k.endswith("/loss") or "/grads/" in k:
            atol = 1e-6 * max(1.0, float(np.abs(v).max()))
            np.testing.assert_allclose(v, stored[k], atol=atol, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(v, stored[k], err_msg=k)
    assert os.path.getsize(chip_smoke.TRAIN_GOLDEN) < 300_000


def test_port_meets_train_golden_on_cpu():
    assert chip_smoke.check_train_golden("cpu", grad_rtol=1e-5) == 2


def test_terminals_golden_is_current():
    """Log-probabilities within 1e-6 (``scene``'s sums over 2002 attributes
    within 1e-6 per term), loss and gradients within 1e-6 of their largest
    value (XLA:CPU may vectorise differently on another host type), the
    rest equal; its weights are the eval golden's."""
    import jax

    from dfol_vqa_tpu.models.interpreter import Interpreter
    from dfol_vqa_tpu.ontology import GQAOntology
    from dfol_vqa_tpu.train.checkpoint import _flatten

    fresh = load_script().build_terminals_golden()
    assert sum(k.endswith("/objects") for k in fresh) == 17
    stored = np.load(chip_smoke.TERMINALS_GOLDEN)
    assert set(fresh) == set(stored.files)
    for k, v in fresh.items():
        if "/log_probability" in k:
            atol = 1e-6 * (2002 if k.endswith("attr_sum") else 1)
            np.testing.assert_allclose(v, stored[k], atol=atol, rtol=0, err_msg=k)
        elif k.endswith("/loss") or "/grads/" in k:
            atol = 1e-6 * max(1.0, float(np.abs(v).max()))
            np.testing.assert_allclose(v, stored[k], atol=atol, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(v, stored[k], err_msg=k)
    assert os.path.getsize(chip_smoke.TERMINALS_GOLDEN) < 300_000
    ont = GQAOntology()
    cfg = chip_smoke.terminals_golden_setup(ont)[0]
    weights = _flatten(jax.tree.map(np.asarray,
                                    Interpreter(cfg, ont).init_params(jax.random.PRNGKey(0))))
    eval_golden = np.load(chip_smoke.EVAL_GOLDEN)
    assert {k for k in eval_golden.files if k.startswith("params/")} == {
        "params/" + k for k in weights}
    for k, v in weights.items():
        np.testing.assert_array_equal(v, eval_golden["params/" + k], err_msg=k)


def test_port_meets_terminals_golden_on_cpu():
    assert chip_smoke.check_terminals_golden("cpu", atol=1e-5, grad_rtol=1e-5) == (17, 0)


def test_calibrator_golden_is_current():
    """Log-probabilities within 1e-6, losses and gradients within 1e-6 of
    max(1, their largest value), each optimizer step's change within
    ``adam_bound`` of the stored one for the trained leaves and equal for
    the others (XLA:CPU may vectorise differently on another host type); the
    rest equal."""
    from dfol_vqa_tpu_torch.ontology import GQAOntology

    fresh = load_script().build_calibrator_golden()
    stored = np.load(chip_smoke.CALIBRATOR_GOLDEN)
    assert set(fresh) == set(stored.files)
    assert sum(k.endswith("/eval/log_probability") for k in fresh) == 21
    calib, f4, *_ = chip_smoke.calibrator_golden_setup(GQAOntology())
    cfgs = {"calibrator": calib, "f4": f4}
    with np.load(chip_smoke.EVAL_GOLDEN) as eval_golden:
        start = {k[len("params/"):]: eval_golden[k] for k in eval_golden.files
                 if k.startswith("params/")}
    weights = dict(zip(cfgs, chip_smoke.calibrator_golden_weights(start, calib, f4)))
    for k, v in fresh.items():
        if "/update/" in k:
            continue
        if k.endswith("/log_probability"):
            np.testing.assert_allclose(v, stored[k], atol=1e-6, rtol=0, err_msg=k)
        elif k.endswith("/loss") or "/grads/" in k:
            atol = 1e-6 * max(1.0, float(np.abs(v).max()))
            np.testing.assert_allclose(v, stored[k], atol=atol, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(v, stored[k], err_msg=k)
    for k in (k for k in fresh if k.endswith("/loss")):
        model, p = k.split("/")[0], k[:-len("loss")]
        grads = {g[len(p + "grads/"):]: v for g, v in fresh.items() if g.startswith(p + "grads/")}
        delta = {g: 1e-6 * max(1.0, float(np.abs(v).max())) for g, v in grads.items()}
        old = {g: stored[p + "grads/" + g] for g in grads}
        bound = chip_smoke.adam_bound(cfgs[model], set(grads), [(grads, old, weights[model], delta)])
        for key in weights[model]:
            got, want = fresh[p + "update/" + key], stored[p + "update/" + key]
            if key in grads:
                assert np.all(np.abs(got - want) <= bound[key]), key
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)
    assert os.path.getsize(chip_smoke.CALIBRATOR_GOLDEN) < 300_000


def test_port_meets_calibrator_golden_on_cpu():
    assert chip_smoke.check_calibrator_golden("cpu", atol=1e-5, grad_rtol=1e-5) == {
        "calibrator": 15, "f4": 6}


def test_bf16_golden_is_current():
    """``compute_dtype="bfloat16"`` at production widths (phase 12)."""
    fresh = load_script().build_bf16_golden()
    assert sum(k.endswith("/log_probability") for k in fresh) == 3
    assert_current(fresh, chip_smoke.BF16_GOLDEN)


def test_port_meets_bf16_golden_on_cpu():
    assert chip_smoke.check_bf16_golden("cpu", atol=1e-5) == (3, 0)


def test_chunk_golden_is_current():
    """The validation steps, error vectors and files equal; the epoch loss
    within 1e-6 relative and the parameters' change within
    ``chip_smoke.params_gap``'s rule (XLA:CPU may vectorise differently on
    another host type)."""
    fresh = load_script().build_chunk_golden()
    stored = np.load(chip_smoke.CHUNK_GOLDEN)
    assert set(fresh) == set(stored.files)
    assert fresh["validation_steps"].tolist() == [8, 11, 11]
    start = {k[len("params/"):]: v for k, v in fresh.items() if k.startswith("params/")}
    chip_smoke.params_gap({k: v + fresh["update/" + k] for k, v in start.items()},
                          {k: v + stored["update/" + k] for k, v in start.items()}, 1e-3, 11)
    for k, v in fresh.items():
        if k == "losses":
            np.testing.assert_allclose(v, stored[k], rtol=1e-6, atol=0)
        elif not k.startswith("update/"):
            np.testing.assert_array_equal(v, stored[k], err_msg=k)
    assert os.path.getsize(chip_smoke.CHUNK_GOLDEN) < 300_000


def test_port_meets_chunk_golden_on_cpu():
    res = chip_smoke.check_chunk_golden("cpu")
    assert res["steps"] == [8, 11, 11] and res["graphs"]["graphs"] == 0
