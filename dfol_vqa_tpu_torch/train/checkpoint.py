"""Checkpoints in the JAX package's npz format.

Port of ``save``/``load`` in ``dfol_vqa_tpu/train/checkpoint.py`` for the
npz backend: one ``<name>.npz`` of '/'-flattened parameter arrays (the keys
of ``convert.flatten``, e.g. ``relation_network/layers/0/w``) plus the step
under ``__global_step__``. A file written by either package loads into the
other. The write is atomic (a temporary file, then a rename). Loading is
partial (strict=False): keys in the file restore the parameters of that
name, parameters absent from the file keep their values, and keys of
modules the port does not hold are ignored.

The Orbax backend and asynchronous writes belong to training (ROADMAP
queue 3) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy
from dfol_vqa_tpu_torch.models.oracle import OracleParams

STEP_KEY = "__global_step__"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP queue 3: training)")


def save(export_path_base: str, name: str, params: OracleParams, global_step: int = 0,
         backend: str = "npz", async_write: bool = False) -> str:
    """Write params (+ step) to ``export_path_base/name.npz``; returns the path."""
    if backend != "npz":
        raise _not_ported(f"checkpoint backend {backend!r}")
    if async_write:
        raise _not_ported("asynchronous checkpoint writes")
    os.makedirs(export_path_base, exist_ok=True)
    flat = flatten(params_to_numpy(params))
    flat[STEP_KEY] = np.asarray(global_step)
    final = os.path.join(export_path_base, name + ".npz")
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)
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
