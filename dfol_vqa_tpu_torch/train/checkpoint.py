"""Checkpoints in the JAX package's npz format.

Port of ``save``/``load``/``wait_pending`` in
``dfol_vqa_tpu/train/checkpoint.py`` for the npz backend: one
``<name>.npz`` of '/'-flattened parameter arrays (the keys of
``convert.flatten``, e.g. ``relation_network/layers/0/w``) plus the step
under ``__global_step__``. A file written by either package loads into the
other. The write is atomic (a temporary file, then a rename). Loading is
partial (strict=False): keys in the file restore the parameters of that
name, parameters absent from the file keep their values, and keys of
modules the port does not hold are ignored.

``async_write=True`` (``tpu.async_save``, on by default) takes the
device-to-host snapshot at once and leaves serialisation and the write to
one background writer thread, so successive saves to a path never
interleave; ``wait_pending`` drains it and re-raises the first failure.

The Orbax backend raises ``NotImplementedError`` (ROADMAP queue 6, with the
multi-host mesh it serves).
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy
from dfol_vqa_tpu_torch.models.oracle import OracleParams

STEP_KEY = "__global_step__"

_WRITER: Optional[concurrent.futures.ThreadPoolExecutor] = None
_PENDING: List[concurrent.futures.Future] = []
_LOCK = threading.Lock()


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP queue 6: mesh "
                               "and Orbax checkpoints)")


def _writer() -> concurrent.futures.ThreadPoolExecutor:
    global _WRITER
    with _LOCK:
        if _WRITER is None:
            _WRITER = concurrent.futures.ThreadPoolExecutor(max_workers=1,
                                                            thread_name_prefix="ckpt-writer")
        return _WRITER


def wait_pending() -> None:
    """Block until every asynchronous write has finished; re-raise the
    first failure."""
    global _PENDING
    with _LOCK:
        pending, _PENDING = _PENDING, []
    for f in pending:
        f.result()


def _write_npz(flat: Dict[str, np.ndarray], final: str) -> None:
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)


def save(export_path_base: str, name: str, params: OracleParams, global_step: int = 0,
         backend: str = "npz", async_write: bool = False) -> str:
    """Write params (+ step) to ``export_path_base/name.npz``; returns the
    path. With ``async_write`` the file appears after ``wait_pending``."""
    if backend != "npz":
        raise _not_ported(f"checkpoint backend {backend!r}")
    os.makedirs(export_path_base, exist_ok=True)
    # private copies: on the CPU .numpy() shares the parameters' memory, which
    # the optimizer updates in place while a background write runs
    flat = {k: np.array(v) for k, v in flatten(params_to_numpy(params)).items()}
    flat[STEP_KEY] = np.asarray(global_step)
    final = os.path.join(export_path_base, name + ".npz")
    if async_write:
        future = _writer().submit(_write_npz, flat, final)
        with _LOCK:
            _PENDING.append(future)
    else:
        _write_npz(flat, final)
    return final


def load(import_path_base: str, name: str, params: OracleParams) -> Tuple[OracleParams, int]:
    """Partial restore: returns (new params on the device of ``params``,
    global step). ``params`` itself is not modified."""
    path = os.path.join(import_path_base, name)
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    if os.path.isdir(path) or os.path.isdir(path + ".orbax"):
        raise _not_ported("loading an Orbax checkpoint")
    flat = flatten(params_to_numpy(params))
    with np.load(path, allow_pickle=False) as data:
        step = int(data[STEP_KEY]) if STEP_KEY in data.files else 0
        for key in data.files:
            if key in flat:
                flat[key] = data[key]
    device = next(params.parameters()).device
    return params_from_numpy(flat).to(device), step
