"""Core runtime types: dense-masked batch layouts, in PyTorch.

A frozen copy of the PyTorch port's module of the same name (``benchmark/reference/__init__.py``), itself a port of the JAX package's (``QuestionType``, ``Quantifier``,
``World``, ``VariableSet.log_probability``). The tensor
layouts are the JAX package's: objects ``(B, O)`` with a float mask, the
attribute cache vocab-major ``(U, V+1, O)``, the relation cache R-major
``(B, R, O, O)``.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Optional

import numpy as np
import torch

from benchmark.reference import logic


class Quantifier(IntEnum):
    FOR_ALL = 0
    EXISTS = 1


class QuestionType(IntEnum):
    BINARY = 0
    QUERY = 1
    STATEMENT = 2
    OBJECT_STATEMENT = 3
    SCENE_GRAPH = 4


@dataclasses.dataclass
class World:
    """A batch of scenes with precomputed oracle likelihood caches."""

    obj_mask: torch.Tensor  # (B, O) float {0,1} per question
    attr_ll: torch.Tensor  # (U, V+1, O) per unique image; row 0 = default ll
    rel_ll: torch.Tensor  # (B, R, O, O) per-question relation-table cache
    rel_tokens: torch.Tensor  # (B, R) int unsigned token codes (0 = pad)
    attr_in: torch.Tensor  # (B, O, D_att) featurized object inputs
    pos: torch.Tensor  # (B, O, 4) normalized bbox features
    img_index: Optional[torch.Tensor] = None  # (B,) question -> image row

    def __post_init__(self):
        if self.img_index is None:
            B = self.obj_mask.shape[0]
            self.img_index = torch.arange(B, device=self.obj_mask.device)


@dataclasses.dataclass
class VariableSet:
    """Soft set of objects per question (optionally per option)."""

    log_attention: torch.Tensor  # (B, O) or (B, K, O)
    quantifier: torch.Tensor  # (B,) or (B, K) float
    obj_mask: torch.Tensor  # (B, O)

    def _mask(self) -> torch.Tensor:
        if self.log_attention.ndim == 3:
            return self.obj_mask[:, None, :]
        return self.obj_mask

    def log_probability(self, hard_mode: bool = False) -> torch.Tensor:
        """Aggregate object attention into a per-question truth value.

        Soft: ``lpn(sum_o mask * lpn(att, q), q)``. Hard: min over
        ``where(mask, lpn(att, q), 0)`` then lpn — masked entries take part
        in the min as exactly 0, the upstream quirk."""
        q = self.quantifier[..., None]
        mask = self._mask()
        inner = logic.log_parametric_not(self.log_attention, q, 1.0)
        if hard_mode:
            agg = logic.masked_min(inner, mask, axis=-1)
        else:
            agg = logic.masked_sum(inner, mask, axis=-1)
        return logic.log_parametric_not(agg, self.quantifier, 1.0)


# The executor's reductions over the question axis: a negated token anywhere
# in a column turns on the lpn round trip for every row
# (``interpreter._apply_negation_exact``), and the calibrator keeps a select
# state when any row selects (``calibrator._Ctx.any_valid``). JAX reduces
# over the whole batch, also where a mesh shards its rows. A training mesh's
# data rank holds a shard of each global batch; its batch carries the global
# batch's reductions in its arrays (``batch_flags`` of every rank, ORed by
# ``trainer.with_global_flags``), and reduces as the global batch does.
FLAG_FIELDS = ("arg_tok", "arg_aux", "last_tok", "last_aux", "options")


def batch_flags(arrays) -> dict:
    """For each signed token field of a batch's host arrays, per column of
    its axes after the question axis: whether any row is negative
    (``"neg:<field>"``) or nonzero (``"nz:<field>"``), as int32 (the
    packing's item size)."""
    out = {}
    for name in FLAG_FIELDS:
        v = arrays[name]
        out[f"neg:{name}"] = (v < 0).any(axis=0).astype(np.int32)
        out[f"nz:{name}"] = (v != 0).any(axis=0).astype(np.int32)
    return out


def batch_any(arrays, kind: str, field: str, index: tuple = ()) -> Optional[torch.Tensor]:
    """The whole batch's ``batch_flags`` reduction ``kind`` ("neg" or "nz")
    of ``field`` at ``index`` (over every column it leaves), a 0-d bool
    tensor; None when ``arrays`` carries no flags (a whole batch, which
    reduces its own rows)."""
    flags = arrays.get(f"{kind}:{field}")
    if flags is None:
        return None
    return torch.any(flags[index] > 0)
