"""Core runtime types: dense-masked batch layouts, in PyTorch.

Port of ``dfol_vqa_tpu/types.py`` (``QuestionType``, ``Quantifier``,
``World``, ``VariableSet.log_probability``). The tensor
layouts are the JAX package's: objects ``(B, O)`` with a float mask, the
attribute cache vocab-major ``(U, V+1, O)``, the relation cache R-major
``(B, R, O, O)``.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Optional

import torch

from dfol_vqa_tpu_torch import logic


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
