"""The JAX goldens that the port meets on the GPU (``chip_smoke.py`` phase 5).

``tests/data/torch_port_golden.npz`` holds the tiny demo engine's weights,
a dozen compiled requests and the JAX package's log-probabilities and
answers for them; ``tests/data/torch_port_golden_eval.npz`` holds a tiny
offline-eval workload (loader batches with shared images), JAX's
log-probabilities and answer flags per batch, and its ``test_epoch`` error
vector and ``predict`` output; ``tests/data/torch_port_golden_train.npz``
holds one training step (loss, gradients, the optimizer's change of every
parameter) on a per-question-route and a shared-route batch. All three are
regenerated here and must match the checked-in copies, so they cannot go
stale; and the port, on the CPU, must meet them with the checks
``chip_smoke.py`` runs on the card (atol 1e-5 here, float32 on the same
host type; 1e-4 on the card).
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
        if k.endswith("/log_probability"):
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
