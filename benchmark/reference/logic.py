"""Log-space fuzzy-logic primitives (product t-norm), in PyTorch.

A frozen copy of the PyTorch port's module of the same name (``benchmark/reference/__init__.py``), itself a port of the JAX package's. Truth values live in log space
(``x = log p``, ``p`` in [0, 1]). The clamp points are kept exactly —
1e-20 for float32, 1e-6 for half precision — and ``log_parametric_not``
keeps its exp/log round trip, because the round trip's saturation at the
clamp is part of the reference numerics.
"""

from __future__ import annotations

import torch

__all__ = [
    "safe_log",
    "safe_exp",
    "log_and",
    "log_or",
    "log_not",
    "log_and_tensor",
    "log_or_tensor",
    "log_parametric_not",
    "masked_sum",
    "masked_min",
    "masked_logsumexp",
]

_EPS_F32 = 1e-20
_EPS_HALF = 1e-6


def _eps_for(x: torch.Tensor) -> float:
    if x.dtype in (torch.float16, torch.bfloat16):
        return _EPS_HALF
    return _EPS_F32


def safe_exp(x):
    """exp, unclamped (as upstream)."""
    return torch.exp(x)


def safe_log(x):
    """log with the reference's underflow clamp."""
    x = torch.as_tensor(x)
    return torch.log(torch.clamp(x, min=_eps_for(x)))


def log_and(a, b):
    """Product t-norm AND: log(p*q)."""
    return a + b


def log_not(x):
    """log(1 - p)."""
    return safe_log(1.0 - safe_exp(x))


def log_or(a, b):
    """De-Morgan OR: log(1 - (1-p)(1-q))."""
    return safe_log(1.0 - (1.0 - safe_exp(a)) * (1.0 - safe_exp(b)))


def log_and_tensor(x, axis=None, mask=None):
    """AND-reduce: sum of logs, optionally masked."""
    if mask is not None:
        x = x * mask
    return torch.sum(x) if axis is None else torch.sum(x, dim=axis)


def log_or_tensor(x, axis=None, mask=None):
    """OR-reduce via De Morgan; masked-out entries contribute 0."""
    t = log_not(x)
    if mask is not None:
        t = t * mask
    return log_not(torch.sum(t) if axis is None else torch.sum(t, dim=axis))


def log_parametric_not(x, alpha, beta=1.0):
    """log(alpha + beta * (1 - 2*alpha) * exp(x)).

    alpha=1, beta=1 -> NOT; alpha=0, beta=1 -> identity through the round
    trip. Quantifiers enter as continuous alpha (EXISTS=1, FOR_ALL=0)."""
    return safe_log(alpha + beta * (1.0 - 2.0 * alpha) * safe_exp(x))


def masked_sum(x, mask, axis):
    """Sum with a {0,1} float mask."""
    return torch.sum(x * mask, dim=axis)


def masked_min(x, mask, axis):
    """Min over ``where(mask, x, 0)``: masked entries take part as exactly 0
    (= log 1), the upstream hard-mode quirk."""
    return torch.amin(torch.where(mask > 0, x, torch.zeros_like(x)), dim=axis)


def masked_logsumexp(x, mask, axis):
    """log(sum(mask * exp(x))) with the safe_log clamp; a plain exp-sum-log
    (no max subtraction) as upstream — inputs are <= 0, so exp cannot
    overflow."""
    return safe_log(torch.sum(torch.exp(x) * mask, dim=axis))
