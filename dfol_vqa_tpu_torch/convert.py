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
from dfol_vqa_tpu_torch.models.calibrator import CalibratorParams
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


def _pair(flat: Dict[str, np.ndarray], key: str, used: set, names=("w", "b")):
    used.update(f"{key}/{n}" for n in names)
    return [_tensor(flat[f"{key}/{n}"]) for n in names]


def _mlp(flat: Dict[str, np.ndarray], name: str, used: set) -> Optional[nn.MLP]:
    layers = []
    while f"{name}/layers/{len(layers)}/w" in flat:
        layers.append(nn.Linear(*_pair(flat, f"{name}/layers/{len(layers)}", used)))
    return nn.MLP(layers) if layers else None


def _has(flat: Dict[str, np.ndarray], top: str) -> bool:
    return any(k.startswith(top + "/") for k in flat)


def params_from_numpy(tree) -> OracleParams:
    """JAX parameter pytree (or its flattened dict) as numpy -> OracleParams.
    Raises ValueError for keys of no module of the port."""
    flat = flatten(tree)
    used: set = set()
    params = OracleParams(_mlp(flat, "featurizer", used), _mlp(flat, "attribute_network", used),
                          _mlp(flat, "relation_network", used),
                          Embedding(*_pair(flat, "embedding", used)))
    if _has(flat, "logic_gates"):
        params.logic_gates = tnn.ModuleDict(
            {name: nn.Linear(*_pair(flat, f"logic_gates/{name}", used)) for name in LOGIC_GATES})
    if _has(flat, "embedding_extra"):
        params.embedding_extra = Embedding(*_pair(flat, "embedding_extra", used))
    if _has(flat, "op_modules"):
        params.op_modules = tnn.ModuleDict(
            {name: _mlp(flat, f"op_modules/{name}", used) for name in ("arity1", "arity2")})
    if _has(flat, "calibrator"):
        lstm = ("w_ih", "w_hh", "b_ih", "b_hh")
        params.calibrator = CalibratorParams(
            nn.LSTMCell(*_pair(flat, "calibrator/fwd", used, lstm)),
            nn.LSTMCell(*_pair(flat, "calibrator/bwd", used, lstm)),
            nn.Linear(*_pair(flat, "calibrator/out", used)))
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"parameters of no module of the port: {extra[:4]}")
    return params


def params_to_numpy(params) -> Dict[str, Any]:
    """OracleParams -> the JAX parameter pytree as numpy arrays. A mesh's
    ``ShardedParams`` (``parallel/mesh.py``) converts whole: its leaves are
    gathered first, a collective that every rank calls."""
    from dfol_vqa_tpu_torch.parallel.mesh import ShardedParams

    named = (params.full_tensors().items() if isinstance(params, ShardedParams)
             else params.named_parameters())
    flat = {name.replace(".", "/"): p.detach().cpu().numpy() for name, p in named}
    return unflatten(flat)
