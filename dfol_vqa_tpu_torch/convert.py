"""Weight bridge between the JAX parameter pytree and the port's modules.

Both directions use the flattened keys of the JAX package's npz checkpoints
(``train/checkpoint.py`` ``_flatten``), e.g. ``relation_network/layers/0/w``.
They are the port's parameter names with ``/`` for ``.``, because the port
keeps the JAX ``(in, out)`` weight layout and computes ``x @ w``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from torch import nn as tnn

from dfol_vqa_tpu_torch import nn
from dfol_vqa_tpu_torch.models.oracle import LOGIC_GATES, Embedding, OracleParams


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {'a/0/b': array}; an already flat
    dict maps to itself. ``None`` subtrees (identity networks) vanish."""
    out: Dict[str, np.ndarray] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of ``flatten``: numeric path segments become list indices."""
    root: Dict[str, Any] = {}

    def slot(node, part: str, default):
        if isinstance(node, list):
            idx = int(part)
            node.extend([None] * (idx + 1 - len(node)))
            if node[idx] is None:
                node[idx] = default
            return node[idx]
        return node.setdefault(part, default)

    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for part, nxt in zip(parts[:-1], parts[1:]):
            node = slot(node, part, [] if nxt.isdigit() else {})
        slot(node, parts[-1], value)
    return root


def _tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _mlp(flat: Dict[str, np.ndarray], name: str, used: set) -> Optional[nn.MLP]:
    layers = []
    while f"{name}/layers/{len(layers)}/w" in flat:
        key = f"{name}/layers/{len(layers)}"
        layers.append(nn.Linear(_tensor(flat[f"{key}/w"]), _tensor(flat[f"{key}/b"])))
        used.update((f"{key}/w", f"{key}/b"))
    return nn.MLP(layers) if layers else None


def params_from_numpy(tree) -> OracleParams:
    """JAX parameter pytree (or its flattened dict) as numpy -> OracleParams."""
    flat = flatten(tree)
    used: set = set()
    featurizer = _mlp(flat, "featurizer", used)
    attribute = _mlp(flat, "attribute_network", used)
    relation = _mlp(flat, "relation_network", used)
    embedding = Embedding(_tensor(flat["embedding/w"]), _tensor(flat["embedding/b"]))
    used.update(("embedding/w", "embedding/b"))
    gates = None
    if any(k.startswith("logic_gates/") for k in flat):
        gates = tnn.ModuleDict()
        for name in LOGIC_GATES:
            key = f"logic_gates/{name}"
            gates[name] = nn.Linear(_tensor(flat[f"{key}/w"]), _tensor(flat[f"{key}/b"]))
            used.update((f"{key}/w", f"{key}/b"))
    extra = sorted(set(flat) - used)
    if extra:
        raise NotImplementedError(
            f"parameters of modules not ported yet (calibrator, F>1 heads): {extra[:4]}")
    return OracleParams(featurizer, attribute, relation, embedding, gates)


def params_to_numpy(params: OracleParams) -> Dict[str, Any]:
    """OracleParams -> the JAX parameter pytree as numpy arrays."""
    flat = {name.replace(".", "/"): p.detach().cpu().numpy()
            for name, p in params.named_parameters()}
    return unflatten(flat)
