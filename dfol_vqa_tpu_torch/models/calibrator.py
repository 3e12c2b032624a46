"""Attention-transfer calibration: a bidirectional LSTM over the op sequence.

Port of ``dfol_vqa_tpu/models/calibrator.py``. The compiler gives every
batch a static slot grid, so both passes are unrolled over it and produce
one modulation tensor per slot and role, which the executor applies to the
attentions it carries (``interpreter._modulate``):

* per-op features = [op one-hot (17) ‖ relate flag ‖ GloVe embedding of the
  token], zero where the token is 0;
* relate adds the carry state to a fresh state of its select side;
* modulations_i = sigmoid(Linear([h_fwd after op i ‖ h_bwd before op i]));
  the zero-weight, (-log 9, -log 9, -log 9, 0)-bias init makes them the
  identity transform;
* an option fan-out steps one state per option on the way forward and sums
  them per question on the way back;
* the backward pass starts from zero states at the terminal.

Nothing here reads a tensor on the host: validity flags and blends stay on
the device, and the blends stay multiplicative (``new * g + old * (1 - g)``),
as in JAX. The option fan-outs step their K states as one (B, K) batch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn as tnn

from dfol_vqa_tpu_torch import nn
from dfol_vqa_tpu_torch.compiler.program_compiler import OP_FILTER, OP_PAD, OP_SELECT, BucketSpec
from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.types import batch_any
from dfol_vqa_tpu_torch.utils.profiling import span

OPS_INDEX = {
    "all_different": 0, "all_same": 1, "and": 2, "choose_attr": 3, "choose_rel": 4,
    "compare": 5, "end": 6, "exist": 7, "filter": 8, "or": 9, "query_attr": 10,
    "relate": 11, "select": 12, "two_different": 13, "two_same": 14,
    "verify_attrs": 15, "verify_rel": 16, "object_attr": 3, "object_rel": 4, "scene": 6,
}
OPS_NUM = 17
MOD_DIM = 4  # (alpha, beta, c, d) of the calibration transform
MAX_ACTIVATION = 10.0

Mods = Dict[str, torch.Tensor]


class CalibratorParams(tnn.Module):
    """The calibrator's parameters: forward and backward ``LSTMCell`` and the
    output head ``out`` (``Linear(2S, 4)``)."""

    def __init__(self, fwd: nn.LSTMCell, bwd: nn.LSTMCell, out: nn.Linear):
        super().__init__()
        self.fwd = fwd
        self.bwd = bwd
        self.out = out


def init_calibrator_params(cfg: Config, generator: torch.Generator) -> CalibratorParams:
    """Random LSTM cells (torch's default init) and the identity output
    head: zero weights, bias -log(9) for alpha, beta and c, 0 for d."""
    in_dim = cfg.word_embedding_dim + 1 + OPS_NUM
    S = cfg.attention_transfer_state_dim
    fwd = nn.LSTMCell.init(in_dim, S, generator)
    bwd = nn.LSTMCell.init(in_dim, S, generator)
    out_b = torch.full((MOD_DIM,), -math.log(MAX_ACTIVATION - 1.0))
    out_b[3] = 0.0
    return CalibratorParams(fwd, bwd, nn.Linear(torch.zeros((2 * S, MOD_DIM)), out_b))


State = nn.State


class _Ctx:
    """Shared tensors and steps of both passes."""

    def __init__(self, calib: CalibratorParams, emb: torch.Tensor, arrays, B: int):
        self.calib, self.emb, self.arrays = calib, emb, arrays
        self.B, self.S = B, calib.fwd.w_hh.shape[0]
        self.device = emb.device
        self.onehots = torch.eye(OPS_NUM, device=self.device)
        self.steps = 0  # LSTM cell calls made

    def zeros(self, *lead: int) -> State:
        z = torch.zeros((self.B, *lead, self.S), device=self.device)
        return z, z

    def feat(self, op_name: str, flag: float, tok: torch.Tensor) -> torch.Tensor:
        """[onehot ‖ flag ‖ embedding(|tok|)] for tokens of any shape, zeroed
        where tok == 0."""
        lead = tuple(tok.shape)
        oh = self.onehots[OPS_INDEX[op_name]].expand(*lead, OPS_NUM)
        fl = torch.full((*lead, 1), flag, device=self.device)
        f = torch.cat([oh, fl, self.emb[torch.abs(tok.long())]], dim=-1)
        return torch.where((tok != 0)[..., None], f, 0.0)

    def lstm(self, which: str, x: torch.Tensor, state: State) -> State:
        self.steps += 1
        return getattr(self.calib, which)(x, state)

    @staticmethod
    def gate(new: State, old: State, valid: torch.Tensor) -> State:
        g = valid[:, None]
        return new[0] * g + old[0] * (1 - g), new[1] * g + old[1] * (1 - g)

    @staticmethod
    def any_valid(tok: torch.Tensor, whole: Optional[torch.Tensor] = None) -> torch.Tensor:
        """1.0 when any row's token is nonzero, as a 0-d device tensor;
        ``whole`` is the whole batch's answer where these rows are a block
        of it (``types.batch_any``)."""
        if whole is not None:
            return whole.float()
        return (torch.amax(torch.abs(tok)) > 0).float()

    @staticmethod
    def maybe(new: State, old: State, any_v: torch.Tensor) -> State:
        return new[0] * any_v + old[0] * (1 - any_v), new[1] * any_v + old[1] * (1 - any_v)

    def mod(self, h_fwd: torch.Tensor, h_bwd: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.calib.out(torch.cat([h_fwd, h_bwd], dim=-1)))

    def side(self, op_name: str, aux: torch.Tensor, whole: Optional[torch.Tensor] = None
             ) -> State:
        """The select side of a relate: a fresh forward state, kept only
        when some row selects a token."""
        new = self.lstm("fwd", self.feat(op_name, 0.0, aux), self.zeros())
        return self.maybe(new, self.zeros(), self.any_valid(aux, whole))

    def slot(self, b: int, si: int):
        a = self.arrays
        return (a["arg_tok"][:, b, si], a["arg_aux"][:, b, si], a["arg_flag"][:, b, si],
                a["op_mask"][:, b, si])


def _forward_branch(ctx: _Ctx, b: int, grid) -> Tuple[State, List[Optional[dict]]]:
    """Forward LSTM over one branch; returns (end state, per-slot fwd h's)."""
    carry = ctx.zeros()
    fwd: List[Optional[dict]] = []
    for si, opc in enumerate(grid):
        if opc == OP_PAD:
            fwd.append(None)
            continue
        tok, aux, _, m = ctx.slot(b, si)
        if opc == OP_SELECT:
            new = ctx.lstm("fwd", ctx.feat("select", 0.0, tok), ctx.zeros())
            carry = ctx.maybe(new, ctx.zeros(),
                              ctx.any_valid(tok, batch_any(ctx.arrays, "nz", "arg_tok", (b, si))))
            fwd.append({"h": carry[0]})
        elif opc == OP_FILTER:
            new = ctx.lstm("fwd", ctx.feat("filter", 0.0, tok), carry)
            carry = ctx.gate(new, carry, m)
            fwd.append({"h": new[0]})
        else:  # OP_RELATE
            side = ctx.side("relate", aux, batch_any(ctx.arrays, "nz", "arg_aux", (b, si)))
            agg = (side[0] + carry[0], side[1] + carry[1])
            new = ctx.lstm("fwd", ctx.feat("relate", 1.0, tok), agg)
            carry = ctx.gate(new, carry, m)
            fwd.append({"h": new[0], "h_sel": side[0]})
    return carry, fwd


def _backward_branch(ctx: _Ctx, b: int, grid, carry: State, fwd) -> List[Optional[Mods]]:
    """Backward LSTM over one branch (reversed); returns per-slot mods."""
    mods: List[Optional[Mods]] = [None] * len(grid)
    for si in reversed(range(len(grid))):
        opc = grid[si]
        if opc == OP_PAD:
            continue
        tok, _, s, m = ctx.slot(b, si)
        if opc == OP_SELECT:  # the branch start: its backward state is unused
            mods[si] = {"filter": ctx.mod(fwd[si]["h"], carry[0])}
        elif opc == OP_FILTER:
            mods[si] = {"filter": ctx.mod(fwd[si]["h"], carry[0])}
            new = ctx.lstm("bwd", ctx.feat("filter", 0.0, tok), carry)
            carry = ctx.gate(new, carry, m)
        else:  # OP_RELATE: the incoming state goes to the chain's side
            sc = s[:, None]
            new = ctx.lstm("bwd", ctx.feat("relate", 1.0, tok), carry)
            mods[si] = {"subject": ctx.mod(fwd[si]["h"], carry[0] * sc),
                        "object": ctx.mod(fwd[si]["h"], carry[0] * (1 - sc)),
                        "select": ctx.mod(fwd[si]["h_sel"], new[0])}
            carry = ctx.gate(new, carry, m)
    return mods


def _fanout_fwd(ctx: _Ctx, op_name: str, carry: State, toks: torch.Tensor) -> torch.Tensor:
    """One forward step per option from the branch-end carry: (B, K, S) h's."""
    K = toks.shape[1]
    state = tuple(x[:, None].expand(-1, K, -1) for x in carry)
    return ctx.lstm("fwd", ctx.feat(op_name, 0.0, toks), state)[0]


def _fanout_bwd(ctx: _Ctx, op_name: str, h_fwd_k: torch.Tensor, toks: torch.Tensor,
                opt_mask: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """One backward step per option from zero states; returns (mods
    (B, K, 4), the options' states summed per question for the branches)."""
    K = toks.shape[1]
    zero = ctx.zeros(K)
    mods = ctx.mod(h_fwd_k, zero[0])
    new = ctx.lstm("bwd", ctx.feat(op_name, 0.0, toks), zero)
    m = opt_mask[:, :, None]
    return mods, (torch.sum(new[0] * m, dim=1), torch.sum(new[1] * m, dim=1))


def compute_modulations(calib: CalibratorParams, interp, world, arrays,
                        spec: BucketSpec) -> Dict[str, object]:
    """Run both calibration passes; returns the modulations keyed for the
    executor: ``slots[branch][slot]`` role dicts (None for a pad slot, or
    everywhere under ``apply_modulation_everywhere=False``) and the
    ``terminal`` role dict. Both passes are one ``calib.passes`` span
    (``utils/profiling``), tagged with the LSTM cell calls it enqueued."""
    B = world.obj_mask.shape[0]
    ctx = _Ctx(calib, interp.embedding_on(world.obj_mask.device), arrays, B)
    with span("calib.passes") as s:
        out = _passes(ctx, interp, arrays, spec)
        s.tags["steps"] = ctx.steps
    return out


def _passes(ctx: _Ctx, interp, arrays, spec: BucketSpec) -> Dict[str, object]:
    """``compute_modulations``' forward and backward passes."""
    term = spec.terminal_op

    carries, fwds = [], []
    for b, grid in enumerate(spec.grid):
        carry, fwd = _forward_branch(ctx, b, grid)
        carries.append(carry)
        fwds.append(fwd)

    terminal: Mods = {}
    toks, opt_mask = arrays.get("options"), arrays.get("opt_mask")
    zero_h = ctx.zeros()[0]
    if term in ("query_attr", "choose_attr", "verify_attrs", "all_same", "all_different"):
        h_fwd_k = _fanout_fwd(ctx, term, carries[0], toks)
        terminal["fanout"], bcarry = _fanout_bwd(ctx, term, h_fwd_k, toks, opt_mask)
        bcarries = [bcarry]
    elif term in ("two_same", "two_different"):
        bcarries = []
        for b in range(2):
            h_fwd_k = _fanout_fwd(ctx, term, carries[b], toks)
            terminal[f"fanout{b}"], bcarry = _fanout_bwd(ctx, term, h_fwd_k, toks, opt_mask)
            bcarries.append(bcarry)
    elif term == "compare":
        f = ctx.feat("compare", 0.0, arrays["last_tok"])
        for b in range(2):
            terminal[f"branch{b}"] = ctx.mod(ctx.lstm("fwd", f, carries[b])[0], zero_h)
        bcarries = [ctx.lstm("bwd", f, ctx.zeros())] * 2
    elif term == "verify_rel":
        # a relate-style terminal
        side = ctx.side(term, arrays["last_aux"], batch_any(arrays, "nz", "last_aux"))
        f_rel = ctx.feat(term, 1.0, arrays["last_tok"])
        h_fwd = ctx.lstm("fwd", f_rel, (side[0] + carries[0][0], side[1] + carries[0][1]))[0]
        terminal["subject"] = ctx.mod(h_fwd, zero_h)
        terminal["object"] = ctx.mod(h_fwd, zero_h)
        new = ctx.lstm("bwd", f_rel, ctx.zeros())
        terminal["select"] = ctx.mod(side[0], new[0])
        bcarries = [new]
    elif term == "choose_rel":
        # a relate per option, from the same select side and carry
        side = ctx.side(term, arrays["last_aux"], batch_any(arrays, "nz", "last_aux"))
        K = toks.shape[1]
        agg = tuple((side[i] + carries[0][i])[:, None].expand(-1, K, -1) for i in range(2))
        f_rel = ctx.feat(term, 1.0, toks)
        h_fwd = ctx.lstm("fwd", f_rel, agg)[0]
        zero = ctx.zeros(K)
        terminal["subject"] = ctx.mod(h_fwd, zero[0])
        terminal["object"] = ctx.mod(h_fwd, zero[0])
        new = ctx.lstm("bwd", f_rel, zero)
        m = opt_mask[:, :, None]
        carry = (torch.sum(new[0] * m, dim=1), torch.sum(new[1] * m, dim=1))
        terminal["select"] = ctx.mod(side[0], carry[0])
        bcarries = [carry]
    else:  # exist / and / or / end / the supervision terminals: zero starts
        bcarries = [ctx.zeros() for _ in spec.grid]
    if len(bcarries) < len(spec.grid):
        bcarries = bcarries * len(spec.grid)

    slots = [_backward_branch(ctx, b, grid, bcarries[b], fwds[b])
             for b, grid in enumerate(spec.grid)]
    if not interp.cfg.apply_modulation_everywhere:
        # only the terminal's modulations apply; both passes still ran
        slots = [[None] * len(grid) for grid in spec.grid]
    return {"slots": slots, "terminal": terminal}
