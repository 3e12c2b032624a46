"""The int8 object transfer against the JAX package's, on the CPU.

* ``data/transfer.quantize_objects`` bitwise equal to
  ``dfol_vqa_tpu/data/device_prefetch.quantize_objects`` (feature columns
  scaled per object row, geometry columns zeroed);
* ``Interpreter.forward`` on int8 objects (dequantized with ``obj_scale``,
  the geometry spliced back from ``obj_geom``) against JAX's int8 forward
  on the serving golden's requests: log-probabilities within 1e-5, answer
  flags equal. int8 is compared with int8 only: its features differ from
  float32 by the quantization step;
* ``ServingEngine(transfer_dtype="int8", device="cpu")`` answers equal to
  the JAX engine's with int8.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu import serve as jserve
from dfol_vqa_tpu.data import device_prefetch
from dfol_vqa_tpu.models import interpreter as jinterp
from dfol_vqa_tpu_torch import serve
from dfol_vqa_tpu_torch.convert import params_from_numpy, params_to_numpy
from dfol_vqa_tpu_torch.data.transfer import quantize_objects, to_device_batch
from dfol_vqa_tpu_torch.ontology import GQAOntology
from dfol_vqa_tpu_torch.serve import _Request

import chip_smoke
from tests.test_torch_serving import stream


@pytest.fixture(scope="module")
def golden():
    with np.load(chip_smoke.GOLDEN) as g:
        return {k: g[k] for k in g.files}


def golden_requests(golden):
    n = sum(1 for k in golden if k.endswith("/question"))
    return [(json.loads(str(golden[f"req/{i}/question"])), golden[f"req/{i}/objects"],
             golden[f"req/{i}/obj_mask"]) for i in range(n)]


def golden_params(golden):
    return {k[len("params/"):]: golden[k] for k in golden if k.startswith("params/")}


@pytest.mark.parametrize("case", ["golden", "random"])
def test_quantize_objects_equals_jax(golden, case):
    if case == "golden":
        objs = np.concatenate([o for _, o, _ in golden_requests(golden)])
    else:
        rng = np.random.default_rng(0)
        objs = (rng.standard_normal((5, 7, 38)) * rng.uniform(0.01, 30.0, (5, 7, 1))
                ).astype(np.float32)
        objs[..., -6:] = rng.uniform(0, 640, (5, 7, 6))
        objs[1, 2] = 0.0  # an empty row: the scale's floor
    scale = np.maximum(np.max(np.abs(objs[..., :-6]), axis=-1) / 127.0, 1e-12).astype(np.float32)
    got, want = quantize_objects(objs, scale), device_prefetch.quantize_objects(objs, scale)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert not got[..., -6:].any() and np.abs(got).max() == 127


def test_int8_forward_matches_jax_on_the_golden(golden):
    """Every golden request assembled by the port's engine (its arrays are
    the golden's, checked by ``chip_smoke.check_golden``), then both
    forwards on int8 objects."""
    params = params_from_numpy(golden_params(golden))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(params))
    _, _, _, eng = serve.build_demo_engine(tiny=True, device="cpu", params=params, max_batch=8)
    try:
        cfg, ont = eng.cfg, eng.interp.ont
        jforward = jinterp.Interpreter(cfg, ont).forward
        checked = 0
        for q, objs, mask in golden_requests(golden):
            key, cb = eng._prepare(q)
            lb, _ = eng._assemble(key, [_Request(q, objs, mask, cb)], pad_to=1)
            _, o, m, arrays = to_device_batch(lb, "cpu", "int8")
            assert o.dtype == torch.int8
            with torch.inference_mode():
                got = eng.interp.forward(eng.params, o, m, arrays, lb.spec)
            want = jforward(jp, jnp.asarray(device_prefetch.quantize_objects(lb.objects,
                                                                            lb.obj_scale)),
                            jnp.asarray(lb.obj_mask),
                            {k: jnp.asarray(v) for k, v in lb.arrays.items()}, lb.spec, False)
            np.testing.assert_allclose(got["log_probability"].numpy(),
                                       np.asarray(want["log_probability"]), atol=1e-5, rtol=0)
            np.testing.assert_array_equal(got["answer_flags"].numpy(),
                                          np.asarray(want["answer_flags"]))
            checked += 1
    finally:
        eng.stop()
    assert checked == len(golden_requests(golden)) > 0


def test_int8_engine_answers_equal_jax():
    cfg, ont, world, jeng = jserve.build_demo_engine(tiny=True, seed=0, max_batch=8)
    jeng.stop()
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    engines = (jserve.ServingEngine(cfg, ont, jeng.params, features=world, max_batch=8,
                                    transfer_dtype="int8"),
               serve.ServingEngine(serve.demo_config(tiny=True), GQAOntology(), params,
                                   features=world, device="cpu", max_batch=8,
                                   transfer_dtype="int8"))
    try:
        qs = stream(world, seed=5)
        want, got = (e.answer_many(qs) for e in engines)
        assert [r.answers for r in got] == [r.answers for r in want]
        assert engines[1].transfer_dtype == "int8" and len(got) == len(qs)
    finally:
        for e in engines:
            e.stop()
