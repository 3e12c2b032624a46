"""The port's graft entry points (``dfol_vqa_tpu_torch/graft_entry.py``)
against the JAX package's ``__graft_entry__.py``, on the CPU.

* ``entry(device="cpu")`` at the dims JAX's ``entry`` fixes (``Config()``
  widths with the calibrator, O=16, batch 8, ``exist`` at length 2): the
  same loader batch, and from JAX's weights (``convert.params_from_numpy``)
  log-probabilities within 1e-5 of JAX's jitted ``fn``.
* ``dryrun_multichip(2)`` (``('data',)``) and ``(4)`` (``('data',
  'model')``, FSDP over ``data``) with ``device="cpu"``: one training
  step and one eval dispatch in gloo processes the call spawns itself,
  each with ``DRYRUN_TIMEOUT`` seconds, printing JAX's ``ok`` line. Its
  default is the cards, one per rank over NCCL.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from dfol_vqa_tpu_torch import graft_entry
from dfol_vqa_tpu_torch.convert import params_from_numpy
from dfol_vqa_tpu_torch.serve import param_tensors

ATOL = 1e-5
DRYRUN_TIMEOUT = 240


def test_entry_matches_jax():
    jfn, jargs = jentry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = graft_entry.entry(device="cpu")
    params, objects, obj_mask, arrays = args
    np.testing.assert_array_equal(objects.numpy(), np.asarray(jargs[1]))
    np.testing.assert_array_equal(obj_mask.numpy(), np.asarray(jargs[2]))
    assert set(arrays) == set(jargs[3])
    for k, v in arrays.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jargs[3][k]), err_msg=k)
    bridged = param_tensors(params_from_numpy(jax.tree.map(np.asarray, jargs[0])))
    assert set(bridged) == set(params)
    with torch.no_grad():
        got = fn(bridged, objects, obj_mask, arrays).numpy()
        own = fn(*args).numpy()
    assert got.shape == want.shape == (8,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.isfinite(own).all() and own.shape == (8,)


@pytest.mark.parametrize("n,mesh", [(2, "{'data': 2}"), (4, "{'data': 2, 'model': 2}")])
def test_dryrun_multichip(n, mesh, capsys):
    rep = graft_entry.dryrun_multichip(n, device="cpu", timeout=DRYRUN_TIMEOUT)
    out = capsys.readouterr().out
    assert f"dryrun_multichip ok: mesh={mesh} loss=" in out and "eval_logp_mean=" in out
    assert rep["backend"] == "gloo" and rep["device"] == "cpu"
    assert rep["flag_rows"] == rep["batch_size"] == 4
    assert np.isfinite(rep["loss"]) and rep["launches"] == [0, 0, 0, 0]


def test_dryrun_layout_is_jax():
    """JAX's rule: ('data', 'model') at (n/2, 2) when n is even and > 2."""
    assert [graft_entry.dryrun_layout(n) for n in (1, 2, 3, 4, 8)] == [
        ((1,), ("data",)), ((2,), ("data",)), ((3,), ("data",)),
        ((2, 2), ("data", "model")), ((4, 2), ("data", "model"))]


def test_dryrun_on_missing_cards_raises():
    """The default device is the cards: no CPU fallback."""
    if torch.cuda.device_count() >= 64:
        pytest.skip("a host with 64 cards")
    with pytest.raises(RuntimeError, match="sees only"):
        graft_entry.dryrun_multichip(64)
