"""Random weights from the seed, made on the device in one draw.

Every leaf is uniform in (-k, k), k = 1 / sqrt(fan_in): a weight of layout
``(in, out)`` (the JAX layout both the port and the reference keep) has
``fan_in = in``; a bias or an LSTM bias takes the fan-in of the weight it
is added to (``w`` beside ``b``, ``w_ih`` beside ``b_ih`` and ``b_hh``).
Two leaves take an offset, so that the answers and the losses stay away
from 0 and 1, where a rounding change could not show:

* the concept head's bias (``embedding.b``, every attribute's and
  relation's logit offset) is uniform in ``CONCEPT_BIAS``: a concept holds
  for about 2% of objects, as for a trained detector. Near 0, every object
  would hold every concept with probability ~0.5, and over 50-100 objects
  every existence would saturate to exactly 1;
* the calibrator head's bias (``calibrator.out.b``) is its published
  initial value, the identity offset (-log 9, -log 9, -log 9, 0), so that
  its random weights calibrate around the identity; at a random bias the
  transform sharpens attentions chain after chain down to the log floor.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

CONCEPT_BIAS = (-5.0, -3.0)
CALIBRATOR_OFFSET = (-math.log(9.0), -math.log(9.0), -math.log(9.0), 0.0)


def fan_ins(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, int]:
    """Parameter name -> the fan-in that sets its scale."""
    shapes = {n: tuple(p.shape) for n, p in named}
    out = {}
    for name, shape in shapes.items():
        prefix, _, leaf = name.rpartition(".")
        if len(shape) >= 2:
            out[name] = shape[0]
            continue
        partner = {"b": "w", "b_ih": "w_ih", "b_hh": "w_ih"}.get(leaf)
        key = f"{prefix}.{partner}" if prefix else str(partner)
        if partner is None or key not in shapes:
            raise ValueError(f"no weight sets the scale of {name}")
        out[name] = shapes[key][0]
    return out


def draw(params: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Fill ``params`` (moved to ``device``) in place from ``seed`` and
    return the drawn tensors by name (the same storage), so that the
    reference can take a copy of exactly these values."""
    named = list(params.named_parameters())
    fans = fan_ins(named)
    total = sum(p.numel() for _, p in named)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    with torch.no_grad():
        for name, p in named:
            lo, hi = CONCEPT_BIAS if name == "embedding.b" else (-1.0, 1.0)
            k = 1.0 / math.sqrt(fans[name]) if name != "embedding.b" else 1.0
            vals = lo * k + flat[off:off + p.numel()].view(p.shape) * ((hi - lo) * k)
            if name == "calibrator.out.b":
                vals = torch.tensor(CALIBRATOR_OFFSET, device=vals.device)
            p.data = vals.to(p.dtype).clone()
            out[name] = p.data
            off += p.numel()
    return out


def copy_into(params: torch.nn.Module, values: Dict[str, torch.Tensor]) -> None:
    """Give every parameter of ``params`` the value of the same name (a copy,
    on the parameter's own device)."""
    named = dict(params.named_parameters())
    if set(named) != set(values):
        raise ValueError(f"parameter names differ: {sorted(set(named) ^ set(values))}")
    with torch.no_grad():
        for name, p in named.items():
            p.data = values[name].detach().to(p.device, torch.float32).clone()
