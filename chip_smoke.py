"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each reported on its own line(s):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every CUDA kernel of the serving, offline-eval and training
   paths from ``csrc/`` (nvcc, sm_90a, all four started together), with its
   seconds and the ptxas register, shared-memory and spill lines;
3. each kernel against its plain PyTorch version at the paths' shapes, with
   median CUDA-event times of both, timed in turns: the relation-oracle pair
   tail at B=32, O=24 and O=100; its backward (kernel 2) at B=32 with O=24
   and O=100 and at B=80 with O=100, all nine gradients within
   ``BWD_RTOL`` of each gradient's largest value (float32 sums over up to
   800k pairs in another order); the pair MLP at U=8 and U=26 (the unique
   images of 80- and 256-question batches at 10 questions per image) and the
   shared contraction at B=80/U=8 and B=256/U=26, both at O=100, H=256,
   E=300, R=8 with 3 pad slots, with h2 in float32 and bfloat16. Tolerance:
   1e-4 abs for float32 results (f32 sums in another order); one bf16 ULP of
   the value for bf16 h2 (both sides round an f32 value that may differ in
   its last bits);
4. the serving engine (``build_demo_engine`` at production dims: 2048-d
   boxes, 512-d oracle, E=300, H=256, O=24, bf16 transfer) answers 64
   planted-world requests (exist with 0-2 hops, verify_rel, query_attr) on
   the card; the answers must equal the same engine and weights on the CPU
   (plain path), and the relation-oracle kernel must have launched;
5. the JAX goldens: the serving golden (``tests/data/torch_port_golden.npz``,
   answers equal, log-probabilities within 1e-4) and the offline-eval
   golden (``tests/data/torch_port_golden_eval.npz``: a tiny-dims loader
   batch set with shared images, float32 h2 stream; compiled tensors, the
   answers, the ``test_epoch`` error vector and the ``predict`` output
   equal, log-probabilities within 1e-4);
6. offline evaluation at production dims through the port's ``VQATrainer``
   (``data/evalset.py``: 640 planted-world questions in 8 batches of 80 on 8
   images each, up to 100 objects, exist select -> filter -> relate,
   verify_rel with 1-2 hops, query_attr with 0-1 hops; random weights from
   seed 0). With the float32 h2 stream, ``predict``'s answers and
   ``test_epoch``'s error vector must equal the same trainer on the CPU —
   except a query answer that the CPU decides by a float32 near-tie
   (options within ``TIE_ULPS`` ULPs of the best, which the last bits of a
   sum taken in another order decide), where the card's answer must lie
   inside the tie and the error may move by one question per such answer —
   and every relating batch must have launched the pair-MLP and
   shared-contract kernels once (the shared route); then the default bf16
   stream, whose agreement with the float32 answers is reported, not
   gated. Questions per
   second, ms per batch and the device's busy/idle share of one profiled
   pass are printed;
7. training at production dims (``data/trainset.py``: batch 80, O=100,
   random weights from seed 0, dropout 0): the shuffled set's relating
   batches take the per-question route (U * 2 > B), the deduplicated set's
   the shared route. Three steps per route run on the card and on the CPU
   plain path from the same weights: every step's gradients within
   ``TRAIN_GRAD_RTOL`` of each leaf's largest value, every loss within
   ``TRAIN_LOSS_RTOL``, the parameters after the steps finite and, element
   by element, within the bound that Adam's update puts on gradients that
   far apart (``adam_bound``); kernels 1 and 2 launch once per
   per-question relating step, kernels 3 and 4 once per shared one. Then
   the JAX training golden (``torch_port_golden_train.npz``) on the card,
   and the main run: a timed ``VQATrainer.train`` of 21 steps (3 epochs,
   the default bf16 h2 stream, a validation pass at each epoch's end and
   every 4 steps, async checkpoints) with steps/s, questions/s and
   ms/step. Its launches are counted from 0: kernels 1 and 2 once per
   per-question relating step, kernels 3 and 4 once per relating batch of
   the validation passes (shared route), every batch on its route. Then one
   profiled epoch of train steps (device busy/idle share, top device
   events). The loss trend is reported, not gated.

Then one JSON line with each kernel's launches (summed over the main runs
of phases 4, 6 and 7, each counted from 0), error and times, and last the
result line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero before the result line. TF32 is off for matmuls and cuDNN.
"""

from __future__ import annotations

import copy
import io
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
EVAL_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden_eval.npz")
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden_train.npz")
KERNEL_ATOL = 1e-4
GOLDEN_ATOL = 1e-4
TIE_ULPS = 4  # float32 ULPs within which two query options count as tied
# gradients: float32 sums over up to 800k pairs (and the plain path's cuBLAS /
# MKL sums) taken in another order, relative to the gradient's largest value
BWD_RTOL = 1e-4
GOLDEN_GRAD_RTOL = 1e-4
# card vs CPU at production widths, per parameter leaf and step: 6x the worst
# reading with TF32 off on an H100 (5.0e-5, the shared route's third step,
# after Adam has moved the two sides' parameters apart by up to 0.12 lr);
# with TF32 matmuls on, the same steps read 2.7e-3 and 8.0e-3
TRAIN_GRAD_RTOL = 3e-4
TRAIN_LOSS_RTOL = 1e-4
ADAM_EPS = 1e-8

# (family, hops, count): the serving slice's terminals, 64 requests
SERVE_MIX = (("exist", 0, 10), ("exist", 1, 10), ("exist", 2, 12),
             ("verify_rel", 1, 8), ("verify_rel", 2, 8),
             ("query_attr", 0, 8), ("query_attr", 1, 8))


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fns, reps: int = 10):
    """Median CUDA-event milliseconds of each zero-argument fn, timed in
    turns (a, b, b, a) after a warm-up and a synchronize."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    events = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for name in order:
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fns[name]()
            e.record()
            events[name].append((s, e))
    torch.cuda.synchronize()
    return {name: statistics.median(s.elapsed_time(e) for s, e in ev)
            for name, ev in events.items()}


def phase_kernels(eng, stamp: str) -> dict:
    """Kernel vs plain at the serving shapes, with the serving engine's
    weights; returns the kernel's record."""
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro

    cfg, params, device = eng.cfg, eng.params, eng.device
    gen = torch.Generator().manual_seed(1)
    worst, times = 0.0, {}
    for B, O in ((32, 24), (32, 100)):
        attr_in = torch.rand((B, O, cfg.attr_input_dim), generator=gen).to(device)
        pos = torch.rand((B, O, 4), generator=gen).to(device)
        tok = torch.randint(1, 2336, (B, cfg.tpu.rel_table_size), generator=gen,
                            dtype=torch.int32)
        tok[:, 5:] = 0  # pad slots
        tok = tok.to(device)
        with torch.inference_mode():
            ins = [t.contiguous() for t in ro.pair_tail_inputs(params, attr_in, pos, tok)]
            got = ro.pair_tail_kernel(*ins, tok)
            want = ro.pair_tail_reference(*ins, tok)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not (torch.isfinite(got).all() and err <= KERNEL_ATOL):
                raise AssertionError(f"relation_oracle kernel disagrees at B={B} O={O}: "
                                     f"max abs {err} > {KERNEL_ATOL}")
            worst = max(worst, err)
            t = cuda_ms({"kernel": lambda: ro.pair_tail_kernel(*ins, tok),
                         "plain": lambda: ro.pair_tail_reference(*ins, tok)})
        times[(B, O)] = t
        log(f"[3] relation_oracle B={B} O={O} H=256 E=300 R=8: max_abs_err={err!r} "
            f"kernel_ms={t['kernel']!r} plain_ms={t['plain']!r} ({stamp})")
    t24 = times[(32, 24)]
    return {"name": "relation_oracle_fwd", "route": "cuda",
            "source": "dfol_vqa_tpu_torch/csrc/relation_oracle.cu",
            "replaces": "dfol_vqa_tpu/ops/pallas/relation_oracle.py:38",
            "max_abs_err": worst, "ms": t24["kernel"], "plain_ms": t24["plain"]}


def phase_bwd_kernel(eng, stamp: str) -> dict:
    """Kernel 2 against its plain version at the training shapes, with the
    engine's weights: all nine gradients (dgeom included) for a random
    cotangent, pad slots included; returns the kernel's record, timed at
    B=80, O=100 without dgeom (the training path does not ask for it)."""
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro

    cfg, params, device = eng.cfg, eng.params, eng.device
    gen = torch.Generator().manual_seed(3)
    names = ("dh_s", "dh_o", "dgeom", "dWg", "db0", "dW2", "db2", "de_sel", "db_sel")
    worst_abs, times = 0.0, {}
    for B, O in ((32, 24), (32, 100), (80, 100)):
        R = cfg.tpu.rel_table_size
        attr_in = torch.rand((B, O, cfg.attr_input_dim), generator=gen).to(device)
        pos = torch.rand((B, O, 4), generator=gen).to(device)
        tok = torch.randint(1, 2336, (B, R), generator=gen, dtype=torch.int32)
        tok[:, 5:] = 0  # pad slots
        tok = tok.to(device)
        g = torch.randn((B, R, O, O), generator=gen).to(device)  # nonzero on pad slots too
        with torch.no_grad():
            ins = [t.contiguous() for t in ro.pair_tail_inputs(params, attr_in, pos, tok)]
            got = ro.pair_tail_bwd_kernel(*ins, tok, g, True)
            want = ro.pair_tail_bwd_reference(*ins, tok, g, True)
            torch.cuda.synchronize()
            rel = {}
            for name, a, b in zip(names, got, want):
                err, mag = (a - b).abs().max().item(), b.abs().max().item()
                if not (torch.isfinite(a).all() and err <= BWD_RTOL * max(mag, 1e-30)):
                    raise AssertionError(f"relation_oracle_bwd {name} disagrees at B={B} O={O}: "
                                         f"max abs {err!r} > {BWD_RTOL} x {mag!r}")
                rel[name] = err / max(mag, 1e-30)
                worst_abs = max(worst_abs, err)
            t = cuda_ms({"kernel": lambda: ro.pair_tail_bwd_kernel(*ins, tok, g, False),
                         "plain": lambda: ro.pair_tail_bwd_reference(*ins, tok, g, False)}, reps=5)
        times[(B, O)] = t
        worst = max(rel, key=rel.get)
        log(f"[3] relation_oracle_bwd B={B} O={O} H=256 E=300 R=8: nine gradients within "
            f"{BWD_RTOL} of their largest value (worst {worst} {rel[worst]!r}) "
            f"kernel_ms={t['kernel']!r} plain_ms={t['plain']!r} ({stamp})")
    t = times[(80, 100)]
    return {"name": "relation_oracle_bwd", "route": "cuda",
            "source": "dfol_vqa_tpu_torch/csrc/relation_oracle_bwd.cu",
            "replaces": "dfol_vqa_tpu/ops/pallas/relation_oracle.py:66",
            "max_abs_err": worst_abs, "ms": t["kernel"], "plain_ms": t["plain"]}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ULP of each value: 2^(e-8) for |x| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def clip_scale(cfg, grads: dict, trainable: set) -> float:
    """The optimizer's global-norm clip factor for these gradients."""
    norm = np.sqrt(sum(float(np.sum(grads[k].astype(np.float64) ** 2)) for k in trainable))
    return 1.0 if norm < cfg.clip_norm else cfg.clip_norm / norm


def adam_bound(cfg, trainable: set, steps) -> dict:
    """Per-element bound on |other - ref| parameters after ``len(steps)``
    optimizer steps (global-norm clip, L2 decay, Adam) of two
    implementations from the same start. ``steps`` holds, per step, (ref
    gradients, other gradients, ref parameters before the step, delta): flat
    numpy dicts by checkpoint key, the other side's gradient known to lie
    within ``delta[key]`` of the ref's, element by element (the caller's
    gradient gate).

    Interval arithmetic in float64: the other side's clipped, decayed
    gradient lies in an interval around the ref's (its own clip factor, the
    delta, the decay of parameters already apart by the bound so far, and
    4 float32 epsilons of rounding); Adam's moments then lie in the
    intervals the recurrences give, and the step m_hat / (sqrt(v_hat) + eps),
    monotone in each moment, takes its extremes at their corners, and never
    exceeds ``cap`` in size. A near-zero gradient whose interval holds 0 so
    gets up to 2 cap lr (a sign flip), a large one about lr * delta / |g|.
    Each step adds 1e-4 lr for
    float32 bias correction (1 - 0.999^t keeps ~4 digits in optax) and
    two float32 ULPs of the parameter for rounding p + step. Frozen leaves
    must not move: their bound is 0."""
    b1, b2, lr, wd, f32 = 0.9, 0.999, cfg.learning_rate, cfg.weight_decay, np.float32
    keys = list(steps[0][0])
    bound = {k: np.zeros(steps[0][0][k].shape) for k in keys}
    state = {k: [0.0] * 6 for k in trainable}  # m, v of the ref; m_lo, m_hi, v_lo, v_hi
    for t, (ref, other, params, delta) in enumerate(steps, 1):
        s_ref, s_other = clip_scale(cfg, ref, trainable), clip_scale(cfg, other, trainable)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        # |m_hat| / sqrt(v_hat) <= cap for any gradients (Cauchy-Schwarz on
        # the two moments' sums): about 1 in the first steps
        cap = (1 - b1) / c1 * np.sqrt(c2 / (1 - b2) * sum((b1 * b1 / b2) ** j for j in range(t)))

        def u(m, v):
            return (m / c1) / (np.sqrt(v / c2) + ADAM_EPS)

        for k in trainable:
            g, p = ref[k].astype(np.float64), params[k].astype(np.float64)
            x = s_ref * g + wd * p
            lo = s_other * (g - delta[k]) + wd * (p - bound[k])
            hi = s_other * (g + delta[k]) + wd * (p + bound[k])
            lo, hi = lo - 4 * np.finfo(f32).eps * np.abs(lo), hi + 4 * np.finfo(f32).eps * np.abs(hi)
            sq_lo = np.where(lo * hi <= 0, 0.0, np.minimum(lo * lo, hi * hi))
            sq_hi = np.maximum(lo * lo, hi * hi)
            m, v, m_lo, m_hi, v_lo, v_hi = state[k]
            m, m_lo, m_hi = (b1 * a + (1 - b1) * y for a, y in ((m, x), (m_lo, lo), (m_hi, hi)))
            v, v_lo, v_hi = (b2 * a + (1 - b2) * y for a, y in ((v, x * x), (v_lo, sq_lo),
                                                                (v_hi, sq_hi)))
            state[k] = [m, v, m_lo, m_hi, v_lo, v_hi]
            corners = [u(a, c) for a in (m_lo, m_hi) for c in (v_lo, v_hi)]
            step = u(m, v)
            spread = np.maximum(np.minimum(np.maximum.reduce(corners), cap) - step,
                                step - np.maximum(np.minimum.reduce(corners), -cap))
            bound[k] = bound[k] + lr * (spread + 1e-4) + 2 * np.spacing(np.abs(p).astype(f32))
    return bound


def grads_of(params) -> dict:
    """Flat {checkpoint key: gradient} copies of ``params``' gradients as
    float32 numpy (the optimizer clips them in place); a parameter without a
    gradient counts as zeros."""
    return {name.replace(".", "/"): (p.grad.detach().cpu().numpy().copy() if p.grad is not None
                                     else np.zeros(tuple(p.shape), np.float32))
            for name, p in params.named_parameters()}


def trainable_keys(cfg, params) -> set:
    """Checkpoint keys of the parameters the optimizer trains."""
    from dfol_vqa_tpu_torch.train.optim import trainable_labels

    return {name.replace(".", "/") for name, on in trainable_labels(params, cfg).items() if on}


def flat_params(params) -> dict:
    """Flat {checkpoint key: value} copies of ``params`` as numpy."""
    return {name.replace(".", "/"): p.detach().cpu().numpy().copy()
            for name, p in params.named_parameters()}


def leaf_errors(got: dict, want: dict) -> dict:
    """{key: (max abs difference, max abs of want)} per leaf."""
    return {k: (float(np.abs(got[k] - w).max()), float(np.abs(w).max())) for k, w in want.items()}


def phase_shared_kernels(params, cfg, device, stamp: str):
    """The pair MLP and the shared contraction against their plain versions
    at the offline-eval shapes; returns their two records."""
    from dfol_vqa_tpu_torch.models import oracle as om
    from dfol_vqa_tpu_torch.ops import pair_mlp as pm
    from dfol_vqa_tpu_torch.ops import shared_contract as sc

    gen = torch.Generator().manual_seed(2)
    rp = params.relation_network
    O, R = 100, cfg.tpu.rel_table_size
    err = {"pair_mlp": 0.0, "shared_contract": 0.0}
    times = {}
    for U, B in ((8, 80), (26, 256)):
        attr_in = torch.rand((U, O, cfg.attr_input_dim), generator=gen).to(device)
        pos = torch.rand((U, O, 4), generator=gen).to(device)
        img = torch.arange(B) // 10
        img = img[torch.randperm(B, generator=gen)] if B == 256 else img  # unsorted too
        img = img.to(torch.int32).to(device)
        tok = torch.randint(1, 2336, (B, R), generator=gen, dtype=torch.int32)
        tok[:, 5:] = 0  # 3 pad slots
        tok = tok.to(device)
        with torch.inference_mode():
            w_s, w_o, w_g, b0 = om._first_layer_split(rp.layers[0], attr_in.shape[-1])
            h_s, h_o = attr_in @ w_s, attr_in @ w_o
            layers = list(rp.layers[1:])
            e_sel, b_sel = om.select_relation_rows(params, tok)
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).replace("torch.", "")
                got = pm.pair_mlp_fused(pos, h_s, h_o, w_g, b0, layers, dtype)
                h2 = pm.pair_mlp_reference(pos, h_s, h_o, w_g, b0, layers, dtype)
                torch.cuda.synchronize()
                diff = (got.float() - h2.float()).abs()
                if dtype == torch.float32:
                    ok, bound = diff.max().item() <= KERNEL_ATOL, f"{KERNEL_ATOL} abs"
                    err["pair_mlp"] = max(err["pair_mlp"], diff.max().item())
                else:
                    ok, bound = bool((diff <= bf16_ulp(h2)).all()), "one bf16 ULP"
                if not (torch.isfinite(got.float()).all() and ok):
                    raise AssertionError(f"pair_mlp kernel disagrees at U={U} {name}: max abs "
                                         f"{diff.max().item()!r} beyond {bound}")
                t = cuda_ms({"kernel": lambda: pm.pair_mlp_fused(pos, h_s, h_o, w_g, b0, layers,
                                                                 dtype),
                             "plain": lambda: pm.pair_mlp_reference(pos, h_s, h_o, w_g, b0,
                                                                    layers, dtype)})
                times[("pair_mlp", U, name)] = t
                log(f"[3] pair_mlp U={U} O={O} H={h_s.shape[-1]} E={h2.shape[-1]} h2 {name}: "
                    f"max_abs_err={diff.max().item()!r} (within {bound}) "
                    f"kernel_ms={t['kernel']!r} plain_ms={t['plain']!r} ({stamp})")

                es = e_sel.to(dtype)
                got = sc.shared_contract_kernel(h2, img, es, b_sel, tok)
                want = sc.shared_contract_reference(h2, img, es, b_sel, tok)
                torch.cuda.synchronize()
                e = (got - want).abs().max().item()
                if not (torch.isfinite(got).all() and e <= KERNEL_ATOL):
                    raise AssertionError(f"shared_contract kernel disagrees at B={B} U={U} "
                                         f"{name}: max abs {e!r} > {KERNEL_ATOL}")
                err["shared_contract"] = max(err["shared_contract"], e)
                t = cuda_ms({"kernel": lambda: sc.shared_contract_kernel(h2, img, es, b_sel, tok),
                             "plain": lambda: sc.shared_contract_reference(h2, img, es, b_sel,
                                                                           tok)})
                times[("shared_contract", U, name)] = t
                log(f"[3] shared_contract B={B} U={U} O={O} E={h2.shape[-1]} R={R} h2 {name}: "
                    f"max_abs_err={e!r} kernel_ms={t['kernel']!r} plain_ms={t['plain']!r} "
                    f"({stamp})")
    sources = {"pair_mlp": ("pair_mlp.cu", "dfol_vqa_tpu/ops/pallas/pair_mlp.py:90"),
               "shared_contract": ("shared_contract.cu",
                                   "dfol_vqa_tpu/ops/pallas/shared_contract.py:46")}
    records = []
    for name, (src, replaces) in sources.items():
        t = times[(name, 8, "bfloat16")]  # the offline-eval default: U=8, bf16 stream
        records.append({"name": f"{name}_fwd", "route": "cuda",
                        "source": f"dfol_vqa_tpu_torch/csrc/{src}", "replaces": replaces,
                        "max_abs_err": err[name], "ms": t["kernel"], "plain_ms": t["plain"]})
    return records


def serve_questions(world):
    qs = []
    for fi, (fam, hops, n) in enumerate(SERVE_MIX):
        qs += world.generate_family(fam, n, length=hops, seed=1000 + fi,
                                    neg_prob=0.3 if fam == "exist" else 0.0,
                                    id_prefix=f"smoke-{fam}{hops}-")
    return qs


def phase_serve(eng, world, stamp: str) -> int:
    """Serve 64 requests on the card; returns the kernel launches of the run."""
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro
    from dfol_vqa_tpu_torch.serve import build_demo_engine

    _, _, _, cpu_eng = build_demo_engine(device="cpu", max_batch=32, seed=0)
    try:
        qs = serve_questions(world)
        info = eng.warmup(qs)
        log(f"[4] warmup: {info['specs']} specs x rungs {info['batch_sizes']} in "
            f"{info['seconds']!r} s ({stamp})")
        ro.LAUNCHES = 0
        t0 = time.perf_counter()
        results = eng.answer_many(qs)
        seconds = time.perf_counter() - t0
        launches = ro.LAUNCHES
        want = [r.answers for r in cpu_eng.answer_many(qs)]
    finally:
        cpu_eng.stop()
    got = [r.answers for r in results]
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"{bad}/{len(qs)} GPU answers differ from the CPU plain engine")
    if launches <= 0:
        raise AssertionError("the relation_oracle kernel never launched while serving")
    p50 = statistics.median(r.latency_ms for r in results)
    log(f"[4] served {len(qs)} requests in {seconds!r} s: {len(qs) / seconds!r} requests/s, "
        f"p50 latency {p50!r} ms, batches {eng.stats['batches']}, "
        f"relation_oracle launches {launches}; answers == CPU plain engine ({stamp})")
    return launches


def check_golden(device, atol: float) -> int:
    """Run the port against the JAX golden on ``device``; returns the number
    of requests checked. Answers must be equal and log-probabilities within
    ``atol``; the port's compiled program tensors must equal JAX's."""
    from dfol_vqa_tpu_torch.convert import params_from_numpy
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.serve import _Request, build_demo_engine

    golden = np.load(GOLDEN)
    params = params_from_numpy({k[len("params/"):]: golden[k]
                                for k in golden.files if k.startswith("params/")})
    n = sum(1 for k in golden.files if k.endswith("/question"))
    _, _, _, eng = build_demo_engine(tiny=True, device=device, params=params, max_batch=8)
    try:
        qs, objs, masks = [], [], []
        for i in range(n):
            p = f"req/{i}/"
            q = json.loads(str(golden[p + "question"]))
            key, cb = eng._prepare(q)
            lb, _ = eng._assemble(key, [_Request(q, golden[p + "objects"],
                                                 golden[p + "obj_mask"], cb)], pad_to=1)
            for k, v in lb.arrays.items():
                if not np.array_equal(v, golden[p + "arrays/" + k]):
                    raise AssertionError(f"request {i}: compiled {k} differs from the golden")
            _, o, m, arrays = to_device_batch(lb, device, eng.transfer_dtype)
            with torch.inference_mode():
                res = eng.interp.forward(eng.params, o, m, arrays, lb.spec)
            lp = res["log_probability"].cpu().numpy()
            err = np.abs(lp - golden[p + "log_probability"]).max()
            if not (np.isfinite(lp).all() and err <= atol):
                raise AssertionError(f"request {i}: log_probability off by {err} > {atol}")
            if not np.array_equal(res["answer_flags"].cpu().numpy(), golden[p + "answer_flags"]):
                raise AssertionError(f"request {i}: answer flags differ from the golden")
            qs.append(q)
            objs.append(golden[p + "objects"])
            masks.append(golden[p + "obj_mask"])
        got = [r.answers for r in eng.answer_many(qs, objs, masks)]
    finally:
        eng.stop()
    want = [json.loads(str(golden[f"req/{i}/answers"])) for i in range(n)]
    if got != want:
        raise AssertionError(f"served answers {got} != golden {want}")
    return n


def check_eval_golden(device, atol: float) -> int:
    """Run the port's offline evaluation against the JAX eval golden on
    ``device`` (float32 h2 stream); returns the number of batches checked.
    The loader's batches must equal the golden's, log-probabilities agree
    within ``atol``, and answer flags, the ``test_epoch`` error vector and
    counts, and the ``predict`` output be equal."""
    from dfol_vqa_tpu.ontology import GQAOntology
    from dfol_vqa_tpu_torch.convert import params_from_numpy
    from dfol_vqa_tpu_torch.data import evalset
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    golden = np.load(EVAL_GOLDEN)
    params = params_from_numpy({k[len("params/"):]: golden[k]
                                for k in golden.files if k.startswith("params/")}).to(device)
    ont = GQAOntology()
    cfg = evalset.demo_eval_config(tiny=True, stream_dtype="float32")
    world = evalset.demo_world(ont, tiny=True)
    loader = evalset.eval_loader(cfg, ont, world, json.loads(str(golden["datasets"])))
    interp = Interpreter(cfg, ont)
    n = 0
    for k, lb in enumerate(loader):
        p = f"batch/{k}/"
        for name, v in [("objects", lb.objects), ("obj_mask", lb.obj_mask)] + [
                ("arrays/" + a, v) for a, v in lb.arrays.items()]:
            if not np.array_equal(v, golden[p + name]):
                raise AssertionError(f"batch {k}: {name} differs from the golden")
        _, o, m, arrays = to_device_batch(lb, device)
        with torch.inference_mode():
            res = interp.forward(params, o, m, arrays, lb.spec)
        lp = res["log_probability"].cpu().numpy()
        err = np.abs(lp - golden[p + "log_probability"]).max()
        if not (np.isfinite(lp).all() and err <= atol):
            raise AssertionError(f"batch {k}: log_probability off by {err} > {atol}")
        if not np.array_equal(res["answer_flags"].cpu().numpy(), golden[p + "answer_flags"]):
            raise AssertionError(f"batch {k}: answer flags differ from the golden")
        n += 1
    if n != sum(1 for k in golden.files if k.endswith("/log_probability")):
        raise AssertionError(f"{n} loader batches, the golden has another count")
    trainer = VQATrainer(cfg, interp, device=device)
    error = trainer.test_epoch(loader, params)
    if not (np.array_equal(error, golden["test_epoch/error"])
            and np.array_equal(trainer.last_test_counts, golden["test_epoch/counts"])):
        raise AssertionError(f"test_epoch error {error} != golden {golden['test_epoch/error']}")
    preds = trainer.predict(loader, params, io.StringIO())
    if preds != json.loads(str(golden["predict"])):
        raise AssertionError("predict output differs from the golden")
    return n


def check_train_golden(device, grad_rtol: float) -> int:
    """One training step of the port against the JAX training golden on
    ``device``, for its per-question-route and shared-route batch; returns
    the number of batches checked. The rebuilt batches must equal the
    golden's; the loss agree within ``grad_rtol`` relative, every gradient
    leaf within ``grad_rtol`` of max(1, its largest value), and every
    parameter's change in one optimizer step within ``adam_bound`` of JAX's
    for gradients that far apart. On a CUDA
    device the per-question batch must launch kernels 1 and 2 and the
    shared batch kernels 3 and 4."""
    from dfol_vqa_tpu.ontology import GQAOntology
    from dfol_vqa_tpu_torch.convert import params_from_numpy
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ops import pair_mlp as pm
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro
    from dfol_vqa_tpu_torch.ops import shared_contract as sc
    from dfol_vqa_tpu_torch.train.optim import Optimizer
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    golden = np.load(TRAIN_GOLDEN)
    start = {k[len("params/"):]: golden[k] for k in golden.files if k.startswith("params/")}
    ont = GQAOntology()
    cfg = trainset.demo_train_config(tiny=True)
    cfg.weight_decay = 0.0
    world = evalset.demo_world(ont, tiny=True)
    trainer = VQATrainer(cfg, Interpreter(cfg, ont), device=device)
    n = 0
    for route in ("per_question", "shared"):
        p = f"batch/{route}/"
        files = json.loads(str(golden[f"datasets/{route}"]))
        (lb,) = list(trainset.train_loader(cfg, ont, world, files, shuffle=False))
        for name, v in [("objects", lb.objects), ("obj_mask", lb.obj_mask)] + [
                ("arrays/" + a, v) for a, v in lb.arrays.items()]:
            if not np.array_equal(v, golden[p + name]):
                raise AssertionError(f"{route} batch: {name} differs from the golden")
        params = params_from_numpy(start).to(device)
        opt = Optimizer(cfg, params)
        before = (ro.LAUNCHES, ro.BWD_LAUNCHES, pm.LAUNCHES, sc.LAUNCHES)
        loss = trainer.compute_grads(params, lb).item()
        want = float(golden[p + "loss"])
        if not (np.isfinite(loss) and abs(loss - want) <= grad_rtol * abs(want)):
            raise AssertionError(f"{route} batch: loss {loss!r} != golden {want!r}")
        want_grads = {k[len(p + "grads/"):]: golden[k] for k in golden.files
                      if k.startswith(p + "grads/")}
        got_grads, delta = grads_of(params), {}
        for k, (err, mag) in leaf_errors(got_grads, want_grads).items():
            delta[k] = grad_rtol * max(1.0, mag)
            if not err <= delta[k]:
                raise AssertionError(f"{route} batch: gradient {k} off by {err!r} (max {mag!r})")
        opt.step()
        bound = adam_bound(cfg, trainable_keys(cfg, params),
                           [(want_grads, got_grads, start, delta)])
        after = flat_params(params)
        for k, s0 in start.items():
            if not np.all(np.abs((after[k] - s0) - golden[p + "update/" + k]) <= bound[k]):
                raise AssertionError(f"{route} batch: the step's change of {k} is off")
        if torch.device(device).type == "cuda":
            d = [a - b for a, b in zip((ro.LAUNCHES, ro.BWD_LAUNCHES, pm.LAUNCHES, sc.LAUNCHES),
                                       before)]
            if d != ([1, 1, 0, 0] if route == "per_question" else [0, 0, 1, 1]):
                raise AssertionError(f"{route} batch launched (fwd, bwd, pair_mlp, contract) "
                                     f"{d} times")
        n += 1
    return n


def device_time(prof):
    """From a ``torch.profiler`` run: the union of its device-side (kernel,
    copy) event intervals in ms, None when it saw no device event, and the
    device ms and count of each event name."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1000.0, n + 1)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return None, by_name
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy + cur_e - cur_s) / 1000.0, by_name


def float_ties(interp, loader, params) -> dict:
    """QUERY questions whose answer the CPU decides by a float32 near-tie:
    two or more options whose scores exp(log_probability) lie within
    ``TIE_ULPS`` float32 ULPs of the best one. The tie rule flags every
    option equal to the best, so such an answer hinges on the last bits of
    sums taken in another order on another device. Returns {question id:
    (terminal op, near-tie option strings)}."""
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models.interpreter import QUERY_OPS

    ties = {}
    for lb in loader:
        if lb.spec.terminal_op not in QUERY_OPS:
            continue
        _, o, m, arrays = to_device_batch(lb, "cpu")
        with torch.inference_mode():
            lp = interp.forward(params, o, m, arrays, lb.spec)["log_probability"].numpy()
        live = lb.arrays["opt_mask"] > 0
        score = np.where(live, np.exp(lp), 0.0).astype(np.float32)
        best = score.max(axis=1, keepdims=True)
        near = live & (np.abs(score - best) <= TIE_ULPS * np.spacing(best))
        cb = lb.compiled
        for qi in np.flatnonzero((near.sum(axis=1) > 1) & (cb.question_mask > 0)):
            opts = cb.option_strings[qi]
            ties[cb.question_ids[qi]] = (lb.spec.terminal_op,
                                         [opts[k] for k in np.flatnonzero(near[qi])])
    return ties


def tie_buckets(ties: dict) -> dict:
    counts: dict = {}
    for term, _ in ties.values():
        counts[term] = counts.get(term, 0) + 1
    return counts


def phase_eval(device, stamp: str) -> dict:
    """Offline evaluation at production dims on the card; returns the
    kernel launches of the main run (the float32-stream ``test_epoch``)."""
    from dfol_vqa_tpu.ontology import GQAOntology
    from dfol_vqa_tpu_torch.data import evalset
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter, spec_needs_relations
    from dfol_vqa_tpu_torch.ops import pair_mlp as pm
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro
    from dfol_vqa_tpu_torch.ops import shared_contract as sc
    from dfol_vqa_tpu_torch.train.trainer import OP_INDEX, VQATrainer

    t0 = time.perf_counter()
    ont = GQAOntology()
    cfg = evalset.demo_eval_config(stream_dtype="float32")
    world = evalset.demo_world(ont)
    datasets = evalset.eval_datasets(world, evalset.PRODUCTION_MIX, evalset.PRODUCTION_BATCH,
                                     evalset.PRODUCTION_IMAGES_PER_BATCH)
    loader = evalset.eval_loader(cfg, ont, world, datasets)
    shapes = [(lb.spec.terminal_op, lb.objects.shape[0], len(lb.arrays["img_index"]),
               spec_needs_relations(lb.spec)) for lb in loader]
    relating = sum(r for *_, r in shapes)
    n_q = sum(len(d) for d in datasets)
    for term, U, B, rel in shapes:
        if rel and U * 2 > B:
            raise AssertionError(f"a relating {term} batch has U={U} > B/2={B // 2}: it "
                                 "would take the per-question route")
    log(f"[6] eval set: {n_q} questions, {len(shapes)} batches (terminal, U_pad, B): "
        f"{[s[:3] for s in shapes]}, {relating} relating, built in "
        f"{time.perf_counter() - t0!r} s")

    params_cpu = Interpreter(cfg, ont).init_params(torch.Generator().manual_seed(0))
    params = copy.deepcopy(params_cpu).to(device)
    gpu = VQATrainer(cfg, Interpreter(cfg, ont), device=device)
    gpu.test_epoch(loader, params)  # warm-up
    torch.cuda.synchronize()

    pm.LAUNCHES = sc.LAUNCHES = ro.LAUNCHES = 0
    t0 = time.perf_counter()
    error = gpu.test_epoch(loader, params)
    seconds = time.perf_counter() - t0
    launches = {"pair_mlp_fwd": pm.LAUNCHES, "shared_contract_fwd": sc.LAUNCHES,
                "relation_oracle_fwd": ro.LAUNCHES}
    if launches["pair_mlp_fwd"] != relating or launches["shared_contract_fwd"] != relating:
        raise AssertionError(f"launches {launches} != {relating} relating batches: a relating "
                             "batch missed the shared-route kernels")
    log(f"[6] test_epoch on the card (f32 h2 stream): {n_q} questions in {seconds!r} s = "
        f"{n_q / seconds!r} questions/s, {1000 * seconds / len(shapes)!r} ms/batch; launches "
        f"{launches} for {relating} relating batches ({stamp})")

    pm.LAUNCHES = sc.LAUNCHES = 0
    preds = gpu.predict(loader, params, io.StringIO())
    if pm.LAUNCHES != relating or sc.LAUNCHES != relating:
        raise AssertionError(f"predict launched pair_mlp {pm.LAUNCHES}, shared_contract "
                             f"{sc.LAUNCHES} times for {relating} relating batches")
    cpu = VQATrainer(cfg, Interpreter(cfg, ont), device="cpu")
    t0 = time.perf_counter()
    error_cpu = cpu.test_epoch(loader, params_cpu)
    preds_cpu = cpu.predict(loader, params_cpu, io.StringIO())
    cpu_seconds = time.perf_counter() - t0
    ties = float_ties(cpu.interp, loader, params_cpu)
    flipped = 0
    for got, want in zip(preds, preds_cpu):
        if got == want:
            continue
        tie = ties.get(want["questionId"])
        if (got["questionId"] != want["questionId"] or tie is None or not got["prediction"]
                or not set(got["prediction"]) <= set(tie[1])):
            raise AssertionError(f"prediction on the card {got} != CPU {want}")
        flipped += 1
    # a tie-decided question moves its bucket's error count by at most 1
    bound = np.zeros_like(error)
    for term, n in tie_buckets(ties).items():
        bound[0] += n
        bound[OP_INDEX[term]] += n
    counts = cpu.last_test_counts
    if not (np.array_equal(counts, gpu.last_test_counts)
            and np.all(np.abs(error - error_cpu) * counts <= bound + 1e-3)):
        raise AssertionError(f"test_epoch error on the card {error} != CPU {error_cpu} beyond "
                             f"the float-tie bound {bound}")
    log(f"[6] f32 h2 stream vs CPU plain path (CPU test_epoch + predict {cpu_seconds!r} s): "
        f"every answer equal except {flipped} of the {len(ties)} query answers that the CPU "
        f"decides by a float32 near-tie (options within {TIE_ULPS} ULPs of the best; the card "
        f"picked inside the tie); test_epoch error equal bucket by bucket beyond those "
        f"(card {error.tolist()}, CPU {error_cpu.tolist()})")

    cfg16 = evalset.demo_eval_config(stream_dtype="bfloat16")
    gpu16 = VQATrainer(cfg16, Interpreter(cfg16, ont), device=device)
    preds16 = gpu16.predict(loader, params, io.StringIO())
    agree = sum(a == b for a, b in zip(preds16, preds))
    error16 = gpu16.test_epoch(loader, params)
    log(f"[6] bf16 h2 stream (default): {agree}/{len(preds)} answers equal the f32 stream's; "
        f"over_all error {float(error16[0])!r} vs {float(error[0])!r} (reported, not gated)")

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gpu16.test_epoch(loader, params)
        torch.cuda.synchronize()
        wall = 1000 * (time.perf_counter() - t0)
    busy, by_name = device_time(prof)
    share = ("not measured (the profiler saw no device event)" if busy is None else
             f"device busy {busy!r} ms, idle share {1 - busy / wall!r}")
    log(f"[6] profiled test_epoch (bf16 stream): wall {wall!r} ms, {share} ({stamp})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log("[6]   device ms by event (count): " + "; ".join(
        f"{name[:60]} {ms!r} ({n})" for name, (ms, n) in top))
    return launches


TRAIN_COMPARE_STEPS = 3  # card vs CPU steps per route (a CPU step at O=100 takes seconds)


class RouteCounter:
    """A loader that counts its passes and the relating batches it yields,
    and raises when a relating batch would take another relation route than
    ``route`` ("per_question": U * 2 > B, "shared": U * 2 <= B)."""

    def __init__(self, loader, route: str):
        self.loader, self.route = loader, route
        self.passes = self.relating = 0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        from dfol_vqa_tpu_torch.models.interpreter import spec_needs_relations

        self.passes += 1
        for lb in self.loader:
            if spec_needs_relations(lb.spec):
                U, B = lb.objects.shape[0], len(lb.arrays["img_index"])
                if (U * 2 <= B) != (self.route == "shared"):
                    raise AssertionError(f"a relating {lb.spec.terminal_op} batch with U={U}, "
                                         f"B={B} would not take the {self.route} route")
                self.relating += 1
            yield lb


def profile_steps(trainer, params, opt, batches) -> tuple:
    """``train_step`` over ``batches`` under ``torch.profiler``: (wall ms,
    device busy ms or None, device ms and count by event name)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for lb in batches:
            trainer.train_step(params, opt, lb)
        torch.cuda.synchronize()
        wall = 1000 * (time.perf_counter() - t0)
    busy, by_name = device_time(prof)
    return wall, busy, by_name


def phase_train(device, stamp: str) -> dict:
    """Training at production widths on the card (``data/trainset.py``,
    random weights from seed 0, float32 h2 stream for the comparison);
    returns the kernel launches of the main run, the timed
    ``VQATrainer.train``."""
    import tempfile

    from dfol_vqa_tpu.ontology import GQAOntology
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter, spec_needs_relations
    from dfol_vqa_tpu_torch.ops import pair_mlp as pm
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro
    from dfol_vqa_tpu_torch.ops import shared_contract as sc
    from dfol_vqa_tpu_torch.train.optim import Optimizer
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    t0 = time.perf_counter()
    ont = GQAOntology()
    cfg = trainset.demo_train_config(stream_dtype="float32")
    world = evalset.demo_world(ont)
    shuffled_sets = trainset.train_datasets(world, trainset.PRODUCTION_MIX)
    dedup_sets = evalset.eval_datasets(world, trainset.PRODUCTION_MIX, trainset.PRODUCTION_BATCH,
                                       evalset.PRODUCTION_IMAGES_PER_BATCH)
    routes = {"per_question": list(trainset.train_loader(cfg, ont, world, shuffled_sets)),
              "shared": list(trainset.train_loader(cfg, ont, world, dedup_sets, shuffle=False))}
    for route, batches in routes.items():
        shapes = [(lb.spec.terminal_op, lb.objects.shape[0], len(lb.arrays["img_index"]))
                  for lb in batches]
        for lb, (term, U, B) in zip(batches, shapes):
            if spec_needs_relations(lb.spec) and (U * 2 <= B) != (route == "shared"):
                raise AssertionError(f"a relating {term} batch with U={U}, B={B} would not take "
                                     f"the {route} route")
        log(f"[7] {route} training set: {len(batches)} batches of {cfg.train_batch_size} "
            f"(terminal, U_pad, B): {shapes}")
    log(f"[7] sets built in {time.perf_counter() - t0!r} s")

    params_cpu = Interpreter(cfg, ont).init_params(torch.Generator().manual_seed(0))
    lr = cfg.learning_rate
    trainable = trainable_keys(cfg, params_cpu)

    def counts():
        return ro.LAUNCHES, ro.BWD_LAUNCHES, pm.LAUNCHES, sc.LAUNCHES

    for route, batches in routes.items():
        batches = batches[:TRAIN_COMPARE_STEPS]
        relating = sum(spec_needs_relations(lb.spec) for lb in batches)
        p_gpu, p_cpu = copy.deepcopy(params_cpu).to(device), copy.deepcopy(params_cpu)
        gpu = VQATrainer(cfg, Interpreter(cfg, ont), device=device)
        cpu = VQATrainer(cfg, Interpreter(cfg, ont), device="cpu")
        o_gpu, o_cpu = Optimizer(cfg, p_gpu), Optimizer(cfg, p_cpu)
        before = counts()
        steps, losses, worst = [], [], (0.0, "")
        for k, lb in enumerate(batches):
            l_gpu = gpu.compute_grads(p_gpu, lb).item()
            start = flat_params(p_cpu)
            l_cpu = cpu.compute_grads(p_cpu, lb).item()
            g_gpu, g_cpu, delta = grads_of(p_gpu), grads_of(p_cpu), {}
            for key, (err, mag) in leaf_errors(g_gpu, g_cpu).items():
                delta[key] = TRAIN_GRAD_RTOL * mag
                if not err <= delta[key]:
                    raise AssertionError(f"{route} step {k} gradient {key}: card vs CPU "
                                         f"{err!r} > {TRAIN_GRAD_RTOL} x {mag!r}")
                worst = max(worst, (err / max(mag, 1e-30), f"{key} at step {k}"))
            steps.append((g_cpu, g_gpu, start, delta))
            if not (np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= TRAIN_LOSS_RTOL * abs(l_cpu)):
                raise AssertionError(f"{route} step {k}: loss {l_gpu!r} on the card, {l_cpu!r} "
                                     "on the CPU")
            losses.append((l_gpu, l_cpu))
            o_gpu.step()
            o_cpu.step()
        d = [a - b for a, b in zip(counts(), before)]
        want = [relating, relating, 0, 0] if route == "per_question" else [0, 0, relating, relating]
        if d != want:
            raise AssertionError(f"{route}: {relating} relating steps launched (fwd, bwd, "
                                 f"pair_mlp, contract) {d} times, not {want}")
        n = len(batches)
        bound = adam_bound(cfg, trainable, steps)
        got, want_p = flat_params(p_gpu), flat_params(p_cpu)
        if not all(torch.isfinite(p).all() for p in p_gpu.parameters()):
            raise AssertionError(f"{route}: non-finite parameters after {n} steps on the card")
        diff, used = 0.0, (0.0, "")
        for key, b in bound.items():
            gap = np.abs(got[key].astype(np.float64) - want_p[key])
            if not np.all(gap <= b):
                at = np.unravel_index(np.argmax(gap - b), gap.shape)
                raise AssertionError(f"{route}: parameter {key}{list(at)} after {n} steps is "
                                     f"{gap[at]!r} from the CPU's, beyond the Adam bound {b[at]!r}")
            diff = max(diff, float(gap.max()))
            if np.any(b > 0):
                used = max(used, (float(np.max(gap / np.where(b > 0, b, np.inf))), key))
        log(f"[7] {route} route, {n} steps card vs CPU plain path: gradients of every step within "
            f"{TRAIN_GRAD_RTOL} of each leaf's largest (worst {worst[1]} {worst[0]!r}); losses "
            f"(card, CPU) {losses}; parameters apart by at most {diff / lr!r} lr, within the Adam "
            f"bound of those gradient gates element by element (largest share of its bound "
            f"{used[0]!r}, {used[1]}); launches (fwd, bwd, pair_mlp, contract) {d} for "
            f"{relating} relating steps")

    n = check_train_golden(device, GOLDEN_GRAD_RTOL)
    log(f"[7] JAX training golden: {n} batches (per-question and shared route), loss and "
        f"gradients within {GOLDEN_GRAD_RTOL} relative, one optimizer step within the Adam bound")

    # the main path: a timed VQATrainer.train with the default bf16 h2 stream,
    # mid-epoch and per-epoch validation, and async checkpoints
    cfg = trainset.demo_train_config()
    cfg.epoch_num = 3
    cfg.checkpointing_frequency = 4  # one mid-epoch validation in each 7-step epoch
    trainer = VQATrainer(cfg, Interpreter(cfg, ont), device=device)
    params = copy.deepcopy(params_cpu).to(device)
    train_ld = RouteCounter(trainset.train_loader(cfg, ont, world, shuffled_sets), "per_question")
    val_ld = RouteCounter(trainset.train_loader(cfg, ont, world, dedup_sets, shuffle=False),
                          "shared")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        ro.LAUNCHES = ro.BWD_LAUNCHES = pm.LAUNCHES = sc.LAUNCHES = 0
        t0 = time.perf_counter()
        params, errors, losses = trainer.train(train_ld, val_ld, params,
                                               last_export_path_base=os.path.join(tmp, "last"),
                                               best_export_path_base=os.path.join(tmp, "best"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"relation_oracle_fwd": ro.LAUNCHES, "relation_oracle_bwd": ro.BWD_LAUNCHES,
                    "pair_mlp_fwd": pm.LAUNCHES, "shared_contract_fwd": sc.LAUNCHES}
        passes = cfg.epoch_num * (1 + len(train_ld) // cfg.checkpointing_frequency)
        want = {"relation_oracle_fwd": train_ld.relating, "relation_oracle_bwd": train_ld.relating,
                "pair_mlp_fwd": val_ld.relating, "shared_contract_fwd": val_ld.relating}
        if launches != want or val_ld.passes != passes or train_ld.passes != cfg.epoch_num:
            raise AssertionError(
                f"train(): launches {launches}, not {want} ({train_ld.relating} per-question "
                f"relating steps in {train_ld.passes} epochs, {val_ld.relating} shared-route "
                f"relating validation batches in {val_ld.passes} passes, {passes} expected)")
        relating = {"train": train_ld.relating, "validation": val_ld.relating}
        files = sorted(os.path.relpath(os.path.join(d, f), tmp)
                       for d, _, fs in os.walk(tmp) for f in fs)
        t0 = time.perf_counter()
        trainer.test_epoch(val_ld, params)
        val_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        trainer._save(os.path.join(tmp, "timed"), params, sync=True)
        save_s = time.perf_counter() - t0
        ckpt_mb = os.path.getsize(os.path.join(tmp, "timed", cfg.model_name + ".npz")) / 2**20
    steps = trainer.global_step
    if not (all(torch.isfinite(p).all() for p in params.parameters()) and set(files) >= {
            "last/model.npz", "best/model.npz", "best/losses.npy", "best/errors.npy"}):
        raise AssertionError(f"train(): non-finite parameters or missing files {files}")
    q = steps * cfg.train_batch_size
    log(f"[7] VQATrainer.train (bf16 h2 stream): {steps} steps in {cfg.epoch_num} epochs, "
        f"{passes} validation passes of {len(val_ld)} batches (each epoch's end and every "
        f"{cfg.checkpointing_frequency} steps) and async saves: {wall!r} s = {steps / wall!r} "
        f"steps/s, {q / wall!r} questions/s, {1000 * wall / steps!r} ms/step, validation "
        f"included ({stamp}); launches {launches} for relating batches {relating}: kernels 1 "
        f"and 2 once per per-question relating step, kernels 3 and 4 once per shared-route "
        f"relating validation batch; epoch "
        f"losses {losses[:, 0].tolist()} (trend reported, not gated); over_all error by epoch "
        f"{errors[0, :, 0].tolist()}; files {files}")
    log(f"[7] inside train(): one validation pass ({len(val_ld)} batches) {val_s!r} s, one "
        f"synchronous save of the {ckpt_mb!r} MiB checkpoint {save_s!r} s ({stamp})")

    batches = list(train_ld)
    opt = Optimizer(cfg, params)
    wall, busy, by_name = profile_steps(trainer, params, opt, batches)  # warm: the profiler's own
    wall, busy, by_name = profile_steps(trainer, params, opt, batches)
    share = ("not measured (the profiler saw no device event)" if busy is None else
             f"device busy {busy!r} ms, idle share {1 - busy / wall!r}")
    log(f"[7] profiled epoch of {len(batches)} train steps (loader outside): wall {wall!r} ms = "
        f"{wall / len(batches)!r} ms/step, {share} ({stamp})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    log("[7]   device ms by event (count): " + "; ".join(
        f"{name[:60]} {ms!r} ({n})" for name, (ms, n) in top))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dfol_vqa_tpu_torch.ops import pair_mlp as pm
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro
    from dfol_vqa_tpu_torch.ops import shared_contract as sc
    from dfol_vqa_tpu_torch.serve import build_demo_engine

    device = torch.device("cuda", 0)
    stamp = card()
    log(f"[1] card: {stamp}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, tf32 matmul/cudnn off")

    builds = {"relation_oracle": ro.build, "relation_oracle_bwd": ro.build_bwd,
              "pair_mlp": pm.build, "shared_contract": sc.build}
    with ThreadPoolExecutor(len(builds)) as pool:
        builds = {name: pool.submit(build) for name, build in builds.items()}
        builds = {name: fut.result() for name, fut in builds.items()}
    for name, built in builds.items():
        log(f"[2] built {name} in {built.seconds!r} s: {' '.join(built.command)}")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[2]   {line.strip()}")

    _, _, world, eng = build_demo_engine(device=device, max_batch=32, seed=0)
    try:
        records = [phase_kernels(eng, stamp), phase_bwd_kernel(eng, stamp)]
        records += phase_shared_kernels(eng.params, eng.cfg, device, stamp)
        serve = {"relation_oracle_fwd": phase_serve(eng, world, stamp)}
    finally:
        eng.stop()
    n = check_golden(device, GOLDEN_ATOL)
    log(f"[5] JAX golden: {n} requests, answers equal, log_probability within {GOLDEN_ATOL}")
    n = check_eval_golden(device, GOLDEN_ATOL)
    log(f"[5] JAX eval golden: {n} loader batches, answers, test_epoch error and predict "
        f"equal, log_probability within {GOLDEN_ATOL}")
    paths = {"serve": serve, "eval": phase_eval(device, stamp), "train": phase_train(device, stamp)}
    # each path's counts were set to 0 just before its main run and read just after
    for rec in records:
        rec["launches"] = sum(run.get(rec["name"], 0) for run in paths.values())
        if rec["launches"] <= 0:
            raise AssertionError(f"{rec['name']} never launched on a main path")
    log(f"launches by main path: {paths}")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
