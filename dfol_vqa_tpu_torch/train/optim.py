"""Optimizer assembly: global-norm clip, L2 weight decay, Adam, freeze flags.

Port of ``dfol_vqa_tpu/train/optim.py``. The JAX package chains, over the
trainable leaves only (``optax.multi_transform`` with 'train'/'freeze'
labels),

    clip_by_global_norm(clip_norm) -> add_decayed_weights(weight_decay)
        -> scale_by_adam(0.9, 0.999, eps=1e-8) -> scale(-learning_rate)

and gives frozen leaves a zero update. Here:

* the clip is written out: optax leaves the gradients alone when their
  global norm is below ``clip_norm`` and otherwise scales them by
  ``clip_norm / norm`` (``torch.nn.utils.clip_grad_norm_`` would divide by
  ``norm + 1e-6`` instead); the norm runs over the trainable gradients only
  and stays on the device;
* ``torch.optim.Adam(weight_decay=...)`` adds ``weight_decay * p`` to the
  gradient before the moments, which is ``add_decayed_weights`` before
  ``scale_by_adam`` (AdamW's decoupled decay is not);
* frozen parameters are not given to Adam, so they get neither an update
  nor decay.

The update is in place on the parameters (JAX returns new arrays).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from dfol_vqa_tpu.config import Config
from dfol_vqa_tpu_torch.models.oracle import OracleParams


def trainable_labels(params: OracleParams, cfg: Config) -> Dict[str, bool]:
    """Parameter name -> trainable, from the freeze flags: one per module
    (featurizer, attribute network, relation network, embedding) and one
    for the embedding bias (``trainable_labels`` in the JAX package)."""
    frozen = {"featurizer": cfg.freeze_featurizer,
              "attribute_network": cfg.freeze_attribute_network,
              "relation_network": cfg.freeze_relation_network,
              "embedding": cfg.freeze_embedding_network}
    labels = {}
    for name, _ in params.named_parameters():
        top = name.split(".", 1)[0]
        if top not in frozen:
            raise NotImplementedError(f"no freeze flag for the parameters of {top!r}")
        off = frozen[top] or (name == "embedding.b" and cfg.freeze_embedding_bias)
        labels[name] = not off
    return labels


class Optimizer:
    """The JAX package's optimizer chain over ``params``' trainable leaves.
    ``step()`` reads the ``.grad`` of each trainable parameter (a missing
    one counts as zero), clips, and applies decay and Adam in place."""

    def __init__(self, cfg: Config, params: OracleParams):
        labels = trainable_labels(params, cfg)
        self.trainable: List[torch.Tensor] = [p for name, p in params.named_parameters()
                                              if labels[name]]
        self.clip_norm = float(cfg.clip_norm)
        self.adam = (torch.optim.Adam(self.trainable, lr=cfg.learning_rate, betas=(0.9, 0.999),
                                      eps=1e-8, weight_decay=cfg.weight_decay)
                     if self.trainable else None)

    def step(self) -> None:
        if self.adam is None:
            return
        for p in self.trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.trainable]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.clip_norm
        for g in grads:  # optax's form: (g / norm) * clip_norm
            g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        self.adam.step()


def build_optimizer(cfg: Config, params: OracleParams) -> Optimizer:
    return Optimizer(cfg, params)
