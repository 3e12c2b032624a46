"""The JAX goldens that the port meets on the GPU (``chip_smoke.py`` phase 5).

``tests/data/torch_port_golden.npz`` holds the tiny demo engine's weights,
a dozen compiled requests and the JAX package's log-probabilities and
answers for them; ``tests/data/torch_port_golden_eval.npz`` holds a tiny
offline-eval workload (loader batches with shared images), JAX's
log-probabilities and answer flags per batch, and its ``test_epoch`` error
vector and ``predict`` output. Both are regenerated here and must match the
checked-in copies, so they cannot go stale; and the port, on the CPU, must
meet them with the checks ``chip_smoke.py`` runs on the card (atol 1e-5
here, float32 on the same host type; 1e-4 on the card).
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
