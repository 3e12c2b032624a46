"""Minimal NN layers for the port: ``Linear``, ``MLP`` and ``LSTMCell``
modules, dropout.

A frozen copy of the PyTorch port's module of the same name (``benchmark/reference/__init__.py``), itself a port of the JAX package's. Weights keep the JAX layout — ``w`` is
``(in, out)`` and a layer computes ``x @ w + b`` — so the parameter names
of a module tree (``relation_network.layers.0.w``) are the JAX pytree's
flattened keys with ``.`` for ``/`` (see ``convert.py``).

Init follows torch.nn.Linear's default, U(-k, k) with k = 1/sqrt(in),
drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn as tnn
from torch.nn import functional as F


def elu(x: torch.Tensor) -> torch.Tensor:
    """ELU through expm1, as ``jax.nn.elu``."""
    return torch.where(x > 0, x, torch.expm1(torch.clamp(x, max=0.0)))


def elu_exp(x: torch.Tensor) -> torch.Tensor:
    """ELU as the TPU kernels (and the CUDA kernels that replace them)
    compute it: exp(min(x, 0)) - 1 instead of expm1."""
    return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


class Linear(tnn.Module):
    """``x @ w + b`` with ``w`` of shape (in, out)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = tnn.Parameter(w)
        self.b = tnn.Parameter(b)

    @classmethod
    def init(cls, in_dim: int, out_dim: int, generator: torch.Generator) -> "Linear":
        k = 1.0 / math.sqrt(in_dim)

        def uniform(shape):
            return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * k

        return cls(uniform((in_dim, out_dim)), uniform((out_dim,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.w) + self.b


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout; a no-op when deterministic or without a generator
    (the JAX version's ``rng is None`` rule)."""
    if deterministic or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


class MLP(tnn.Module):
    """RegularMLP / LoglikelihoodMLP: [Dropout, Linear, ELU]* then
    [Dropout, Linear] and a final sigmoid, logsigmoid or none."""

    def __init__(self, layers: Sequence[Linear]):
        super().__init__()
        self.layers = tnn.ModuleList(layers)

    @classmethod
    def init(cls, in_dim: int, hidden: Optional[Sequence[int]], out_dim: int,
             generator: torch.Generator) -> Optional["MLP"]:
        """None for ``hidden=None``: the identity network."""
        if hidden is None:
            return None
        dims = [in_dim] + list(hidden) + [out_dim]
        return cls([Linear.init(dims[i], dims[i + 1], generator)
                    for i in range(len(dims) - 1)])

    def forward(self, x: torch.Tensor, final: str = "sigmoid", dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = dropout(x, dropout_rate, generator, deterministic)
            x = layer(x)
            if i < n - 1:
                x = elu(x)
        if final == "sigmoid":
            return torch.sigmoid(x)
        if final == "logsigmoid":
            return F.logsigmoid(x)
        if final == "none":
            return x
        raise ValueError(final)


def mlp_apply(p: Optional[MLP], x: torch.Tensor, final: str = "sigmoid",
              dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None,
              deterministic: bool = True) -> torch.Tensor:
    """Apply an MLP; ``None`` is the identity network."""
    if p is None:
        return x
    return p(x, final, dropout_rate, generator, deterministic)


State = Tuple[torch.Tensor, torch.Tensor]


def lstm_cell(p: "LSTMCell", x: torch.Tensor, state: State) -> State:
    """One torch.nn.LSTMCell step in the JAX layout: ``state = (h, c)``,
    gates in the order i, f, g, o; returns ``(h', c')``. Leading dims
    broadcast, so a (B, K, in) input steps K states per row at once."""
    h, c = state
    gates = torch.matmul(x, p.w_ih) + p.b_ih + torch.matmul(h, p.w_hh) + p.b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c2), c2


class LSTMCell(tnn.Module):
    """LSTM cell parameters: ``w_ih (in, 4S)``, ``w_hh (S, 4S)``, ``b_ih``,
    ``b_hh (4S,)``, the JAX package's names and layout."""

    def __init__(self, w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                 b_hh: torch.Tensor):
        super().__init__()
        self.w_ih = tnn.Parameter(w_ih)
        self.w_hh = tnn.Parameter(w_hh)
        self.b_ih = tnn.Parameter(b_ih)
        self.b_hh = tnn.Parameter(b_hh)

    @classmethod
    def init(cls, in_dim: int, hidden_dim: int, generator: torch.Generator) -> "LSTMCell":
        """torch.nn.LSTMCell's default, U(-k, k) with k = 1/sqrt(hidden)."""
        k = 1.0 / math.sqrt(hidden_dim)

        def uniform(shape):
            return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * k

        return cls(uniform((in_dim, 4 * hidden_dim)), uniform((hidden_dim, 4 * hidden_dim)),
                   uniform((4 * hidden_dim,)), uniform((4 * hidden_dim,)))

    def forward(self, x: torch.Tensor, state: State) -> State:
        return lstm_cell(self, x, state)
