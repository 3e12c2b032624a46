"""Scene featurisation: box features -> oracle inputs + pair geometry.

A frozen copy of the PyTorch port's module of the same name (``benchmark/reference/__init__.py``), itself a port of the JAX package's. Object rows are
``[features ‖ image_w, image_h ‖ bbox x, y, w, h]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark.reference.config import Config
from benchmark.reference import nn


def featurize_objects(
    featurizer: Optional[nn.MLP],
    objects: torch.Tensor,
    cfg: Config,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """objects (B, O, box_dim+6) -> (attr_in (B, O, D+4), pos (B, O, 4)).

    ``objects`` must be float32: JAX promotes a bf16 transfer to f32
    implicitly, torch does not, so callers upcast on the device first."""
    feats = objects[..., :-6]
    wh = objects[..., -6:-4]
    bbox = objects[..., -4:]
    f = nn.mlp_apply(featurizer, feats, final="sigmoid", dropout_rate=cfg.dropout,
                     generator=generator, deterministic=deterministic)
    denom = torch.clamp(torch.cat([wh, wh], dim=-1), min=1.0)
    pos = bbox / denom
    return torch.cat([f, pos], dim=-1), pos


def pair_geometry(pos: torch.Tensor) -> torch.Tensor:
    """(B, O, 4) -> (B, O, O, 4): [distance, angle, h_side, v_side].

    Subject = first O axis (i), object = second (j). The asin ratio is
    clamped to [-1, 1]: fp32 rounding can push |dy|/dist past 1 when
    dx ~ 0, which would NaN the asin."""
    x, y, w, h = pos[..., 0], pos[..., 1], pos[..., 2], pos[..., 3]
    cx = x + w / 2.0
    cy = y + h / 2.0
    dx = cx[..., :, None] - cx[..., None, :]
    dy = cy[..., :, None] - cy[..., None, :]
    dist = torch.sqrt(dx * dx + dy * dy)
    angle = torch.asin(torch.clamp(dy / torch.clamp(dist, min=1e-10), -1.0, 1.0))
    h_side = torch.sign(x[..., None, :] - x[..., :, None])
    v_side = torch.sign(y[..., None, :] - y[..., :, None])
    return torch.stack([dist, angle, h_side, v_side], dim=-1)
