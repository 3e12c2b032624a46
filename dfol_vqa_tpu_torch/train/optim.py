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
  nor decay; ``require_grads`` takes them out of autograd, so a step
  computes no gradient for them (the JAX package's jitted step never reads
  the frozen leaves' gradients, and XLA drops their computation).

The update is in place on the parameters (JAX returns new arrays). On a
CUDA device Adam is built with ``capturable=True`` (its step counters and
bias corrections stay on the device), so that a CUDA graph can capture
the step (``train/graphs.py``), and ``static_grads`` gives every trainable
parameter a gradient buffer that stays at one address for the
optimizer's life. Every step updates: the port runs no padded step, so it
needs no counterpart of the JAX package's gated step
(``_train_step_chunk_padded``).

Under a device mesh (``parallel/mesh.py``) the optimizer steps each rank's
masters (``ShardedParams.masters``: an FSDP leaf's shard, else the leaf),
so Adam's state follows the shards; the clip's global norm sums each
master's squared gradient weighted by 1 / its copies and all-reduces the
sum over the ranks, so it is the norm of the whole gradient.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.models.oracle import OracleParams


def trainable_labels(params: OracleParams, cfg: Config) -> Dict[str, bool]:
    """Parameter name -> trainable, from the freeze flags: one per module
    (featurizer, attribute network, relation network, embedding, and the
    calibrator's ``freeze_attention_network``) and one for the embedding
    bias (``trainable_labels`` in the JAX package). The trainable
    interpreter's extra channels follow the embedding's flag, with no bias
    exception; its operator modules and the logic gates have no flag and
    always train."""
    frozen = {"featurizer": cfg.freeze_featurizer,
              "attribute_network": cfg.freeze_attribute_network,
              "relation_network": cfg.freeze_relation_network,
              "embedding": cfg.freeze_embedding_network,
              "embedding_extra": cfg.freeze_embedding_network,
              "calibrator": cfg.freeze_attention_network,
              "op_modules": False,
              "logic_gates": False}
    labels = {}
    for name, _ in params.named_parameters():
        top = name.split(".", 1)[0]
        if top not in frozen:
            raise NotImplementedError(f"no freeze flag for the parameters of {top!r}")
        off = frozen[top] or (name == "embedding.b" and cfg.freeze_embedding_bias)
        labels[name] = not off
    return labels


def require_grads(params: OracleParams, cfg: Config) -> None:
    """Each parameter of ``params`` requires a gradient where
    ``trainable_labels`` says it trains, and only there; a frozen one's
    ``.grad`` is dropped. The frozen parts' forward then records no graph
    and saves nothing for a backward, which never reaches them. The trainer
    sets these flags before it steps (``VQATrainer.train``, ``train_step``),
    so every call follows its own configuration."""
    labels = trainable_labels(params, cfg)
    for name, p in params.named_parameters():
        p.requires_grad_(labels[name])
        if not labels[name]:
            p.grad = None


class Optimizer:
    """The JAX package's optimizer chain over ``params``' trainable leaves
    (``sharded``'s masters of them under a mesh). ``step()`` reads the
    ``.grad`` of each trainable parameter (a missing one counts as zero),
    clips, and applies decay and Adam in place."""

    def __init__(self, cfg: Config, params: OracleParams, sharded=None):
        labels = trainable_labels(params, cfg)
        named = sharded.masters() if sharded is not None else params.named_parameters()
        named = [(name, p) for name, p in named if labels[name]]
        self.trainable: List[torch.Tensor] = [p for _, p in named]
        self._norm_weights = ([sharded.norm_weight(name) for name, _ in named]
                              if sharded is not None else None)
        self.clip_norm = float(cfg.clip_norm)
        self.capturable = bool(self.trainable) and self.trainable[0].device.type == "cuda"
        self.adam = (torch.optim.Adam(self.trainable, lr=cfg.learning_rate, betas=(0.9, 0.999),
                                      eps=1e-8, weight_decay=cfg.weight_decay,
                                      capturable=self.capturable)
                     if self.trainable else None)

    def static_grads(self) -> None:
        """Give each trainable parameter without one a zero gradient buffer;
        the steps after it accumulate into these buffers in place."""
        for p in self.trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    def _init_state(self) -> None:
        """Adam's state as its first step would create it (zero moments,
        step 0), so that ``_state_tensors`` has every tensor to give before
        the first step."""
        for p in self.trainable:
            state = self.adam.state[p]
            if not state:
                state["step"] = (torch.zeros((), dtype=torch.float32, device=p.device)
                                 if self.capturable else torch.tensor(0.0, dtype=torch.float32))
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def _state_tensors(self) -> List[torch.Tensor]:
        """The parameters, then each one's exp_avg, exp_avg_sq and step:
        the tensors a step changes, as callers read and set them (to compare
        two optimizers, or to start one again from a saved state)."""
        self._init_state()
        out = list(self.trainable)
        for p in self.trainable:
            state = self.adam.state[p]
            out += [state["exp_avg"], state["exp_avg_sq"], state["step"]]
        return out

    def step(self) -> None:
        if self.adam is None:
            return
        self.static_grads()
        grads = [p.grad for p in self.trainable]
        if self._norm_weights is None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        else:
            sq = sum(torch.sum(g * g) * w for g, w in zip(grads, self._norm_weights))
            dist.all_reduce(sq)
            norm = torch.sqrt(sq)
        keep = norm < self.clip_norm
        for g in grads:  # optax's form: (g / norm) * clip_norm
            g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        self.adam.step()


def build_optimizer(cfg: Config, params: OracleParams, sharded=None) -> Optimizer:
    return Optimizer(cfg, params, sharded)
