"""Differentiable FOL update cells (dense-masked Bayesian logic cell).

A frozen copy of the PyTorch port's module of the same name (``benchmark/reference/__init__.py``), itself a port of the JAX package's:

arity 1:  att' = att + ll
arity 2:  subj'[b,i] = subj[b,i] + lpn( sum_{j!=i, valid j} lpn(ll[b,i,j] + obj[b,j], q_obj), q_obj )
          obj' [b,j] = obj[b,j]  + lpn( sum_{i!=j, valid i} lpn(ll[b,i,j] + subj[b,i], q_subj), q_subj )

All cells broadcast over an optional option axis K: attentions ``(B, O)`` or
``(B, K, O)``, relation likelihoods ``(B, O, O)`` or ``(B, K, O, O)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark.reference import logic
from benchmark.reference.nn import Linear


def neural_logic_gate(gate: Linear, log_p: torch.Tensor, log_q: torch.Tensor) -> torch.Tensor:
    """Trainable soft logic gate: a Linear(2, 6) + sigmoid gives the alphas
    and betas of ``lpn(lpn(p, a0, a3) + lpn(q, a1, a4), a2, a5)``."""
    lp, lq = torch.broadcast_tensors(log_p, log_q)
    x = torch.stack([lp, lq], dim=-1)
    alpha = torch.sigmoid(torch.einsum("...i,ij->...j", x, gate.w) + gate.b)
    nlp = logic.log_parametric_not(lp, alpha[..., 0], alpha[..., 3])
    nlq = logic.log_parametric_not(lq, alpha[..., 1], alpha[..., 4])
    return logic.log_parametric_not(nlp + nlq, alpha[..., 2], alpha[..., 5])


def filter_update(log_attention: torch.Tensor, ll: torch.Tensor,
                  gate: Optional[Linear] = None) -> torch.Tensor:
    """Arity-1 Bayesian update: posterior = prior + likelihood (or the
    neural logic gate when ``trainable_gate`` is on)."""
    if gate is not None:
        return neural_logic_gate(gate, ll, log_attention)
    return log_attention + ll


def relate_update(
    subj_att: torch.Tensor,
    obj_att: torch.Tensor,
    ll: torch.Tensor,
    q_subj: torch.Tensor,
    q_obj: torch.Tensor,
    obj_mask: torch.Tensor,
    gates: Optional[Tuple[Linear, Linear]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Arity-2 Bayesian update over a dense (.., O, O) relation likelihood,
    with the self-relation (diagonal) discount and partner validity masks."""
    O = subj_att.shape[-1]
    eye = torch.eye(O, dtype=subj_att.dtype, device=subj_att.device)

    if subj_att.ndim == 3:  # (B, K, O)
        mask_j = obj_mask[:, None, None, :]
        mask_i = obj_mask[:, None, :, None]
        not_diag = (1.0 - eye)[None, None, :, :]
    else:
        mask_j = obj_mask[:, None, :]
        mask_i = obj_mask[:, :, None]
        not_diag = (1.0 - eye)[None, :, :]

    qo = q_obj[..., None, None]
    qs = q_subj[..., None, None]
    g_subj = gates[0] if gates is not None else None
    g_obj = gates[1] if gates is not None else None

    def combine(acc, prior, gate):
        if gate is not None:
            return neural_logic_gate(gate, acc, prior)
        return acc + prior

    # subject update: marginalise the object partner (j, last axis)
    term = logic.log_parametric_not(combine(ll, obj_att[..., None, :], g_obj), qo, 1.0)
    term = term * not_diag * mask_j
    subj_new = combine(
        logic.log_parametric_not(torch.sum(term, dim=-1), q_obj[..., None], 1.0),
        subj_att,
        g_subj,
    )

    # object update: marginalise the subject partner (i, second-to-last axis)
    term = logic.log_parametric_not(combine(ll, subj_att[..., :, None], g_subj), qs, 1.0)
    term = term * not_diag * mask_i
    obj_new = combine(
        logic.log_parametric_not(torch.sum(term, dim=-2), q_subj[..., None], 1.0),
        obj_att,
        g_obj,
    )
    return subj_new, obj_new


def normalize_over_options(ll: torch.Tensor, opt_mask: torch.Tensor,
                           enabled: bool = True) -> torch.Tensor:
    """Per-option-group normalisation ``ll - log(sum_k exp(ll_k))``.

    Upstream skips it for the WHOLE batch only when every option group is a
    singleton; once any question has >1 option, singleton groups are
    normalised too. The choice is a device-side select, so it costs no
    host sync and survives row concatenation and padding exactly."""
    if not enabled:
        return ll
    extra = ll.ndim - 2
    m = opt_mask.reshape(opt_mask.shape + (1,) * extra)
    denom = logic.masked_logsumexp(ll, m, axis=1)
    normed = ll - denom[:, None, ...]
    any_multi = torch.amax(torch.sum(opt_mask, dim=1)) > 1
    return torch.where(any_multi, normed, ll)
