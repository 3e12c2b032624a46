"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each reported on its own line(s):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every CUDA kernel of the serving, offline-eval and training
   paths from ``csrc/`` (nvcc, sm_90a, all four started together), with its
   seconds and the ptxas register, shared-memory and spill lines;
3. each kernel against its plain PyTorch version at the paths' shapes
   (kernel 1 called through its registered operator), with
   median CUDA-event times of the wrapper and the plain version, timed in
   turns, and the kernel's own device time from ``torch.profiler``: the
   relation-oracle pair tail (kernel 1) and its backward (kernel 2) at a
   ragged B=3, O=37, at B=32 with O=24 and O=100, and at B=80, O=100 (the
   engine's weights, H=256, E=300), and at B=8, O=24 with H=512, E=600 (two
   slices of the tile in each) and H=20, E=30 (not multiples of 4; random
   weights), kernel 2's nine gradients within ``BWD_RTOL`` of each
   gradient's largest value (float32 sums over up to 800k pairs in another
   order); the pair MLP at U=8 and U=26 (the unique
   images of 80- and 256-question batches at 10 questions per image) and the
   shared contraction at B=80/U=8 and B=256/U=26, both at O=100, H=256,
   E=300, R=8 with 3 pad slots, with h2 in float32 and bfloat16. Tolerance:
   1e-4 abs for float32 results (f32 sums in another order); one bf16 ULP of
   the value for bf16 h2 (both sides round an f32 value that may differ in
   its last bits). Each timed shape also reports its FLOP and bytes, its
   bound (``kernel_bound``: the least time the card could take, matrix
   products on the tensor cores, in 3xTF32 for float32 operands and at the
   bf16 rate for bf16 ones) and the share of it reached; then the
   measurement behind ``tpu.cache_dtype="auto"`` (``phase_cache_dtype``):
   the profiler's device time of one eval forward with float32 and with
   bfloat16 caches at B in (32, 80, 256) and O in (24, 100), median and
   spread of five runs in turns, and the dtype the rule of
   ``models/oracle.py`` picks from it;
4. the serving engine (``build_demo_engine`` at production dims: 2048-d
   boxes, 512-d oracle, E=300, H=256, O=24, bf16 transfer) answers 64
   planted-world requests (exist with 0-2 hops, verify_rel, query_attr) on
   the card; the answers must equal the same engine and weights on the CPU
   (plain path), and the relation-oracle kernel must have launched; the same
   64 requests with the int8 object transfer (``phase_serve_int8``),
   answers equal to the CPU engine's with int8, and the host ms per batch of
   the int8 and bf16 transfers;
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
   shared-contract kernels once (the shared route; ``tpu.eval_chunk=8``:
   the exist run of 4 batches runs as one CUDA graph of 4 forwards); then
   the default bf16 stream, whose agreement with the float32 answers is
   reported, not gated. Questions per second, ms per batch and the
   device's busy/idle share of one profiled pass are printed;
7. training at production dims (``data/trainset.py``: batch 80, O=100,
   random weights from seed 0, dropout 0): the shuffled set's relating
   batches take the per-question route (U * 2 > B), the deduplicated set's
   the shared route. Three steps per route run on the card, each held
   against the CPU plain path's step from the card's parameters and Adam
   state (``card_vs_cpu_steps``): its gradients within ``TRAIN_GRAD_RTOL``
   of each leaf's largest value, its loss within ``TRAIN_LOSS_RTOL``, the
   parameters after it finite and, element by element, within the bound
   that Adam's update puts on gradients that far apart (``adam_bound``);
   kernels 1 and 2 launch once per
   per-question relating step, kernels 3 and 4 once per shared one. Then
   the JAX training golden (``torch_port_golden_train.npz``) on the card,
   and the main run: a timed ``VQATrainer.train`` of 21 steps (3 epochs,
   the default bf16 h2 stream, a validation pass at each epoch's end and
   every 4 steps, async checkpoints) with steps/s, questions/s and
   ms/step. Its launches are counted from 0: kernels 1 and 2 once per
   per-question relating step, kernels 3 and 4 once per relating batch of
   the validation passes (shared route), every batch on its route. Then one
   profiled epoch of train steps (device busy/idle share, top device
   events). The loss trend is reported, not gated;
8. the terminals (every terminal of the executor, at production dims
   unless said): the fourth JAX golden (``torch_port_golden_terminals.npz``:
   each terminal soft and hard at tiny dims, and the supervision
   terminals' loss and gradients); a 68-request burst of the ten newer
   question families (``SERVE_TERMINALS_MIX``, 0-2 hops, choose_rel
   included) through phase 4's engine, answers equal to the CPU engine's,
   kernel 1 once per relating group; offline evaluation of every question
   terminal (``evalset.TERMINAL_HOPS``, one batch of 80 on 8 images each,
   O=100) soft and hard through ``VQATrainer.test_epoch`` and ``predict``
   against the CPU: probabilities within ``EVAL_P_ATOL``, answers and error
   vector equal up to the near-tie rule (``near_ties``: a query's options,
   compare's two branches, a binary flag at 0.5), kernels 3 and 4 once per
   relating batch, questions/s per terminal; and one training step each,
   card vs CPU under phase 7's gates, of ``choose_rel`` and ``compare`` on
   the per-question route, the supervision terminals ``object_attr``,
   ``object_rel`` and ``scene`` (``trainset.supervision_loader``), and a
   ``trainable_gate`` batch on the shared route;
9. the calibrator and the trainable interpreter (``phase_calibrator``): the
   fifth JAX golden (``torch_port_golden_calibrator.npz``: a calibrator
   model on every terminal and an F = 4 model, eval and training-mode
   forwards and one step each); the last curriculum stage
   (``configs/curriculum_training/cur7_classifier-direct-ll.yaml`` through
   ``Config.from_yaml``, its widths, dropout 0, the calibrator's output
   head drawn at random) serving phase 4's 64 requests at O=24 (answers
   equal to the CPU engine's, kernel 1 once per relating group, the
   calibrator run for exist and verify_rel and not for query_attr), every
   question terminal evaluated soft at O=100/batch 80 as in phase 8, and
   three training steps per route as in phase 7 (one saturated batch
   within ``CALIB_SATURATED_STEP_RTOL``; every calibrator leaf with a
   nonzero gradient, the frozen oracle out of autograd, with no gradient
   and no backward kernel, and bitwise unchanged) with the
   bare ms/step beside phase 7's configuration on the same batches; the
   trainable interpreter (F = 4, operator modules [8], their final layers
   at random) on one shared-route eval batch and one per-question step,
   card vs CPU, launching no kernel (its plain tails); and one profiled
   calibrator eval pass (idle share, device events and host enqueue ms per
   batch);
10. the curriculum chain (``phase_curriculum``): the eight stage files
   through ``experiments/curriculum.run_stage`` and the experiment runner
   at their own widths and batch sizes (1000/100 and 80/80), dropout 0, on
   the production planted world cut in depth (``CURRICULUM_SCALE``, two
   epochs a stage): stage 0's first steps at batch 1000 against the CPU's
   under phase 7's gates, the ``-l best`` hand-over loaded bitwise (stage 6
   partially, its calibrator fresh), frozen leaves unchanged and every
   calibrator leaf moved in stages 6-7, finite losses and each stage's
   files, every relating batch's kernels once (the stages train at
   ``train_chunk=8``, their chunks as CUDA graphs); then the CLI
   (``gqa_experiment -t -l best -p``) over stage 7's test set on the card
   against ``-c`` on the CPU, up to the near-tie rule;
11. the serving deployment (``phase_daemon``) at the demo engine's
   production widths on phase 4's 64 requests: ``ServingEngine.trace`` of
   each relating spec on the card against the CPU and the sixth JAX golden
   (``tests/data/torch_port_golden_trace.npz``); the weight-free artifact
   exported on the card at rungs 1-32 with traces (``EXPORT_WORKERS``
   processes), served by a fresh engine with ``Interpreter.forward``
   forbidden (answers equal to the live card engine's and the CPU's, no
   live step, kernel 1 through its operator once per relating group), a
   CPU artifact refused; requests/s of the live and the artifact engine in
   turns; the HTTP daemon in a subprocess (``--ckpt`` of the phase's
   weights, ``--artifact``) answering the requests from ``DAEMON_CLIENTS``
   threads (``/healthz``, ``/v1/trace``, ``/stats`` gated);
12. the training mesh (``phase_mesh``) and ``compute_dtype="bfloat16"``
   (``phase_bf16``). The mesh: ``mesh_worker`` children, one per rank
   (the parent built the kernels; the children load them), three
   steps per layout at ``sample_config``'s widths, O=100, global batch 80
   (one shared-route step, two per-question ones), each held against the
   single-process step on the union batch from the same parameters and
   Adam state under phase 7's gates (``check_mesh_step``), answer flags by
   question id; NCCL at ``torch.cuda.device_count()`` ranks in
   ``('data',)``, ``('data',)`` + FSDP and ``('data', 'model')``, then two
   ranks on the one card over gloo in the same three layouts
   (``GLOO_LAYOUTS``: gloo has every collective the mesh uses on CUDA
   tensors but all-to-all, which it does not use); every rank's launches
   of kernels 1-4 counted in its steps and returned to this process; the
   one-rank mesh step timed against the single-process step. bf16: phase
   4's 64 requests (kernel 1 on bf16 h_s / h_o products), one eval batch
   and one training step per route against the CPU in the card's
   formulation (``KernelRouteOnCpu``), and the seventh JAX golden
   (``tests/data/torch_port_golden_bf16.npz``, production widths);
13. chunked dispatch as one CUDA graph per chunk (``phase_chunk``) at
   ``Config()``'s widths, O=100, batch 80, seed 0: (a) 11 batches of one
   shuffled ``exist`` file (the per-question route) at ``train_chunk=8``
   with ``pad_chunks`` (a chunk of 8, then a tail of 3: a graph each, the
   graph running the tail's real steps only), three passes (a key's first
   chunk eager, the second captured and replayed, the third replayed),
   each chunk held against the card's eager per-step path from the same
   state (every leaf's change within ``TRAIN_GRAD_RTOL`` of its largest;
   bitwise equality reported), the eager chunk of the tail (no padded
   step under ``pad_chunks``) leaving every parameter and Adam tensor
   bitwise where the per-step path's 3 steps leave them, kernels 1 and 2
   counted once a step, replays included; (b) the same on the deduplicated
   set (the shared route, kernels 3 and 4); each timed against the eager
   one-step path (ms per step, host enqueue ms per step, idle share; loader
   outside, in turns); (c) the eighth JAX golden
   (``tests/data/torch_port_golden_chunk.npz``: ``checkpointing_frequency=3``,
   validation at the same global steps as JAX's, the same error vectors,
   the parameters within ``params_gap``); (d) ``test_epoch`` / ``predict``
   at ``eval_chunk=8`` against ``eval_chunk=1`` on phase 6's 640 questions
   (answers, matches, errors equal; log-probabilities within
   ``GOLDEN_ATOL``; questions/s, host enqueue and idle share of both);
   (e) a chunk of two shared-route batches at ``dropout=0.1`` (plain
   tails), whose two replays from one state draw different masks. Graphs,
   capture seconds and the bytes their memory pool holds are printed;
14. serving over a device mesh in one process and the graft entry points
   (``phase_serving_mesh``): (a) the demo engine at production widths on
   logical meshes of the card, ``(2,)``, ``(4,)``, ``(2, 2)`` and ``(4,
   2)`` (``parallel/mesh.make_local_mesh``; each data row a replica, the
   concept head split over the model axis, each group whole on one data
   row, the rows in turn), warmed up on every data row, serving phase 4's
   64 and phase 8's 68 requests: answers equal to the CPU engine's (and so
   to the single-card engine's), kernel 1 once per relating group and
   never for the others; (b) the first JAX golden through a ``(2, 2)``
   tiny mesh engine; (c) the ``cur7`` calibrator engine on ``(2, 2)``
   against phase 9's CPU answers, its GloVe constant on each replica's
   device; (d) with two cards or more, the meshes ``(n,)``, ``(n/2, 2)``
   and ``(1, n)`` over the n cards held to (a)'s checks, and requests/s of
   each against one card in turns (else printed as not measured); (e)
   ``graft_entry.entry()`` on the card against the CPU from the same
   weights (within ``GOLDEN_ATOL``) and ``graft_entry.dryrun_multichip(2)``
   as two gloo ranks on the card (over NCCL on every card where there are
   two or more), its ranks' launches counted;
15. the loader's page-locked object blocks (``phase_pinned``; alone:
   ``python3 -c "import chip_smoke as c; c.phase_pinned()"``): (a) a
   ``VQATrainer.train`` at production widths over five batches of one
   file at ``train_chunk=4`` (a group of 4 and one of 1): every batch's
   ``block`` page-locked, each ``transfer.stage`` span's ``pinned`` equal
   to its ``batches``; (b) a batch dropped right after the non-blocking
   copy of its block (queued behind a 1 s spin kernel), then four gathers
   of other scenes into blocks of the same size while the copy waits: the
   device tensor equals the dropped batch's bytes, and no new gather got
   its block before the copy ran; the same copy from a ``torch.from_numpy``
   view of the block, which the allocator cannot see, is printed as the
   control; the pinned allocator's counts (``torch.cuda.host_memory_stats``).

Then one JSON line with each kernel's launches (summed over the main runs
of phases 4 (both transfers), 6, 7, 8, 9, 10, 11, 12, 13 and 14, each
counted from 0; a CUDA graph's replay counts the kernels it holds),
error, times, FLOP, bound and
share of bound (``library_ms`` null: no single PyTorch call computes any of
the four fused functions), and last the
result line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero before the result line. TF32 is off for matmuls and cuDNN.
"""

from __future__ import annotations

import copy
import dataclasses
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
TERMINALS_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden_terminals.npz")
CALIBRATOR_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden_calibrator.npz")
TRACE_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden_trace.npz")
BF16_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden_bf16.npz")
CHUNK_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden_chunk.npz")
SUPERVISION_GOLDEN = {"n": 2, "seed": 3}  # the terminals golden's supervision batches
KERNEL_ATOL = 1e-4
GOLDEN_ATOL = 1e-4
TIE_ULPS = 4  # float32 ULPs within which an answer counts as a near-tie (near_ties)
# gradients: float32 sums over up to 800k pairs (and the plain path's cuBLAS /
# MKL sums) taken in another order, relative to the gradient's largest value
BWD_RTOL = 1e-4
GOLDEN_GRAD_RTOL = 1e-4
# card vs CPU at production widths, per parameter leaf and step, each step
# from the card's parameters: 6x the worst reading with TF32 off on an H100
# (4.9e-5, phase 7's shared route, third step); with TF32 matmuls on, phase
# 7's steps read 2.7e-3 and 8.0e-3
TRAIN_GRAD_RTOL = 3e-4
# one batch's own limit: phase 9's shared route, second step (an exist batch
# at loss 11.0, the calibrator's head drawn at random), where the card reads
# 1.31e-3 against the CPU on an NVIDIA H100 80GB HBM3 at 700 W, the same to
# the last digit in every run. A float64 run cannot say which side is off:
# both float32 paths lie 0.951 from it (the reference's clamps saturate in
# float32, not in float64). Summing the batch in reverse order moves either
# side by 2.3e-7 at most, so the gap is not the order of the sums. With TF32
# matmuls on, the step reads 8.2e-3 against the CPU, beyond this limit
# (scripts/step_gradient_witness.py)
CALIB_SATURATED_STEP_RTOL = 3e-3
TRAIN_LOSS_RTOL = 1e-4
# phase 8's eval, card vs CPU at O=100, in probability space: ~8x the worst
# reading on an NVIDIA H100 80GB HBM3 at 700 W (1.17e-4, compare in hard
# mode; every other terminal within 1.5e-6). Log space is no place for the
# gate: near the 1e-20 clamp one side's hard-mode minimum reads log(1e-20) =
# -46.05, the other's -16.6
EVAL_P_ATOL = 1e-3
ADAM_EPS = 1e-8

# (family, hops, count): the serving slice's terminals, 64 requests
SERVE_MIX = (("exist", 0, 10), ("exist", 1, 10), ("exist", 2, 12),
             ("verify_rel", 1, 8), ("verify_rel", 2, 8),
             ("query_attr", 0, 8), ("query_attr", 1, 8))
# phase 8's burst: the ten question families of the terminals slice, 0-2
# hops, 68 requests
SERVE_TERMINALS_MIX = (("verify_attrs", 1, 6), ("choose_attr", 0, 6), ("choose_rel", 0, 6),
                       ("choose_rel", 1, 6), ("choose_rel", 2, 4), ("and", 1, 6), ("or", 2, 4),
                       ("all_same", 1, 6), ("all_different", 0, 4), ("two_same", 1, 6),
                       ("two_different", 0, 4), ("compare", 1, 6), ("compare", 2, 4))
TERMINALS_SEED = 8  # phase 8's question sets


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


# NVIDIA H100 SXM published peaks (NVIDIA's H100 datasheet, dense): HBM
# bytes/s, bf16 and TF32 tensor-core FLOP/s, float32 FLOP/s outside the
# tensor cores
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 495e12
H100_F32_FLOPS = 67e12


def kernel_bound(product_flop: float, other_flop: float, nbytes: float,
                 product_dtype: torch.dtype = torch.float32) -> dict:
    """The least time the card could take for a kernel's work: the larger of
    its bytes (each input read once, each output written once) over HBM's
    rate and its operations over the peak rate for their type. Matrix
    products of float32 operands run on the tensor cores in 3xTF32 (three
    TF32 products per float32 one: a third of the TF32 rate), of bfloat16
    operands at the bf16 tensor-core rate (exact products, float32 sums);
    other float32 operations on the CUDA cores. ``f32_simt_bound_ms`` is the
    same with every operation on the CUDA cores."""
    product_rate = H100_BF16_FLOPS if product_dtype == torch.bfloat16 else H100_TF32_FLOPS / 3
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = max(product_flop / product_rate, other_flop / H100_F32_FLOPS)
    return {"flop": product_flop + other_flop, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "f32_simt_bound_ms": 1e3 * max(t_bytes,
                                           (product_flop + other_flop) / H100_F32_FLOPS)}


def pair_tail_work(B, O, H, E, R, backward: bool) -> dict:
    """``kernel_bound`` of kernel 1 (forward: z2 = h1 W2, 2HE FLOP per pair,
    and the logits, 2RE) or kernel 2 (backward: three H x E products, 6HE
    per pair, and 6RE for the logits, dh2 and de_sel), float32 tensors."""
    pairs = B * O * O
    weights = 4 * H + H + H * E + E
    ins = 2 * B * O * H + B * O * O * 4 + weights + B * R * E + B * R + B * R  # + rel_tokens
    out = B * R * O * O
    if backward:
        ins += B * R * O * O  # the cotangent
        out = 2 * B * O * H + weights + B * R * E + B * R  # dgeom not asked for
    k = 3 if backward else 1
    return kernel_bound(k * 2 * H * E * pairs, k * 2 * R * E * pairs, 4 * (ins + out))


LIBRARY_NOTE = "no single PyTorch call computes this fused function"


def random_pair_tail_inputs(eng, gen, B, O):
    """Random pair-tail inputs at the engine's widths with three pad slots."""
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro

    cfg, device = eng.cfg, eng.device
    attr_in = torch.rand((B, O, cfg.attr_input_dim), generator=gen).to(device)
    pos = torch.rand((B, O, 4), generator=gen).to(device)
    tok = torch.randint(1, 2336, (B, cfg.tpu.rel_table_size), generator=gen, dtype=torch.int32)
    tok[:, 5:] = 0  # pad slots
    tok = tok.to(device)
    with torch.no_grad():
        ins = [t.contiguous() for t in ro.pair_tail_inputs(eng.params, attr_in, pos, tok)]
    return ins, tok


# (B, O): a ragged shape (O not a multiple of the kernels' 8 x 8 and 64-pair
# tiles), the serving shape, and the training shapes at 32 and 80 questions
PAIR_TAIL_SHAPES = ((3, 37), (32, 24), (32, 100), (80, 100))
# (B, O, H, E): widths past one slice of the tile in both H and E (256, 320),
# and widths that are not multiples of 4 (zero-padded), random weights
PAIR_TAIL_WIDTHS = ((8, 24, 512, 600), (8, 24, 20, 30))
R_SLOTS = 8


def random_width_inputs(gen, B, O, H, E, R=R_SLOTS, device="cuda"):
    """Pair-tail inputs at widths H and E from ``gen`` (weights scaled as an
    initialiser would), three pad slots."""
    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device).contiguous()

    ins = [randn(B, O, H, scale=0.5), randn(B, O, H, scale=0.5),
           (torch.rand((B, O, O, 4), generator=gen) * 2 - 1).to(device), randn(4, H), randn(H),
           randn(H, E, scale=H ** -0.5), randn(E), randn(B, R, E), randn(B, R)]
    tok = torch.randint(1, 2336, (B, R), generator=gen, dtype=torch.int32)
    tok[:, 5:] = 0
    return ins, tok.to(device)


PROFILE_TRIES = 3


def kernel_device_ms(fn, kernel: str, launches, reps: int = 10) -> float:
    """Median device milliseconds of the CUDA kernel whose name contains
    ``kernel`` over ``reps`` calls of ``fn``, from ``torch.profiler``
    (CUPTI): the kernel alone, without its wrapper's other launches and host
    work. ``launches()`` reads the wrapper's launch count, and each profiled
    run's records are held against the launches in that run. A run with
    fewer records lost some (on an H100, 2 of 160 profiled runs of kernel 2
    and none of kernel 1's 160: ``scripts/profiler_record_count.py``): it is
    logged and the kernel profiled again, up to ``PROFILE_TRIES`` runs. More
    records than launches, or no run with all of them, raises."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        before = launches()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launched = launches() - before
        times = [(e.time_range.end - e.time_range.start) / 1000.0 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(times) > launched or launched == 0:
            raise RuntimeError(f"the profiler recorded {kernel!r} {len(times)} times, its "
                               f"wrapper launched it {launched} times")
        if len(times) == launched:
            return statistics.median(times)
        log(f"[3]   the profiler recorded {len(times)} of the {launched} launches of "
            f"{kernel!r} in this run: records lost, profiled again")
    raise RuntimeError(f"no profiled run of {PROFILE_TRIES} recorded every launch of "
                       f"{kernel!r}")


def shape_record(t, work, device_ms: float, **shape) -> dict:
    """One timed shape: its dims, work and bound; ``ms``, the wrapper's
    CUDA-event time (every launch it makes, as ``share_of_bound`` counts
    it); ``device_ms``, the profiler's time of the kernel alone; and the
    plain version's event time (``plain_ms``)."""
    return {**shape, "ms": t["kernel"], "device_ms": device_ms, "plain_ms": t["plain"], **work,
            "share_of_bound": work["bound_ms"] / t["kernel"]}


def pair_tail_cases(eng, gen):
    """Kernels 1 and 2's inputs: (B, O, ins, tok) at ``PAIR_TAIL_SHAPES`` with
    the serving engine's weights, then at ``PAIR_TAIL_WIDTHS`` with random
    ones."""
    for B, O in PAIR_TAIL_SHAPES:
        yield (B, O, *random_pair_tail_inputs(eng, gen, B, O))
    for B, O, H, E in PAIR_TAIL_WIDTHS:
        yield (B, O, *random_width_inputs(gen, B, O, H, E, device=eng.device))


DEFAULT_LL = -30.0  # the pad slots' log-likelihood (oracle.DEFAULT_LOG_LIKELIHOOD)


def phase_kernels(eng, stamp: str) -> dict:
    """Kernel 1 vs plain at the ragged, serving and training shapes, with
    the serving engine's weights, and at a wide (two slices of H and E) and
    an odd (not multiples of 4) pair of widths, called and timed through its
    registered operator (``relation_oracle_fwd``); returns the kernel's record,
    timed at B=80, O=100 (the training shape), with every shape under
    ``shapes``."""
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro

    gen = torch.Generator().manual_seed(1)
    worst, shapes = 0.0, []
    for B, O, ins, tok in pair_tail_cases(eng, gen):
        H, E, R = ins[0].shape[-1], ins[5].shape[1], tok.shape[1]
        with torch.inference_mode():
            got = ro.relation_oracle_fwd(*ins, tok, DEFAULT_LL)
            want = ro.pair_tail_reference(*ins, tok)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not (torch.isfinite(got).all() and err <= KERNEL_ATOL):
                raise AssertionError(f"relation_oracle kernel disagrees at B={B} O={O} H={H} "
                                     f"E={E}: max abs {err} > {KERNEL_ATOL}")
            worst = max(worst, err)
            t = cuda_ms({"kernel": lambda: ro.relation_oracle_fwd(*ins, tok, DEFAULT_LL),
                         "plain": lambda: ro.pair_tail_reference(*ins, tok)})
            dev = kernel_device_ms(lambda: ro.relation_oracle_fwd(*ins, tok, DEFAULT_LL),
                                   "relation_oracle_fwd_kernel", lambda: ro.LAUNCHES)
        rec = shape_record(t, pair_tail_work(B, O, H, E, R, backward=False), dev, B=B, O=O, H=H,
                           E=E, max_abs_err=err)
        shapes.append(rec)
        log(f"[3] relation_oracle B={B} O={O} H={H} E={E} R={R}: max_abs_err={err!r} "
            f"ms={rec['ms']!r} device_ms={rec['device_ms']!r} "
            f"plain_ms={t['plain']!r} flop={rec['flop']!r} bound_ms={rec['bound_ms']!r} "
            f"({rec['bound_by']}, 3xTF32) share_of_bound={rec['share_of_bound']!r} "
            f"f32_simt_bound_ms={rec['f32_simt_bound_ms']!r} ({stamp})")
    main = next(r for r in shapes if (r["B"], r["O"], r["H"]) == (80, 100, 256))
    return {"name": "relation_oracle_fwd", "route": "cuda",
            "source": "dfol_vqa_tpu_torch/csrc/relation_oracle.cu",
            "replaces": "dfol_vqa_tpu/ops/pallas/relation_oracle.py:38",
            "max_abs_err": worst, "ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"], "flop": main["flop"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "share_of_bound": main["share_of_bound"],
            "library_ms": None, "library_note": LIBRARY_NOTE, "at": {"B": 80, "O": 100},
            "shapes": shapes}


def phase_bwd_kernel(eng, stamp: str) -> dict:
    """Kernel 2 against its plain version at kernel 1's shapes and widths:
    all nine gradients (dgeom included) for a random cotangent, pad slots
    included; returns the kernel's record, timed at B=80, O=100 without
    dgeom (the training path does not ask for it), with every shape under
    ``shapes``."""
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro

    gen = torch.Generator().manual_seed(3)
    names = ("dh_s", "dh_o", "dgeom", "dWg", "db0", "dW2", "db2", "de_sel", "db_sel")
    worst_abs, shapes = 0.0, []
    for B, O, ins, tok in pair_tail_cases(eng, gen):
        H, E, R = ins[0].shape[-1], ins[5].shape[1], tok.shape[1]
        g = torch.randn((B, R, O, O), generator=gen).to(eng.device)  # nonzero on pad slots too
        with torch.no_grad():
            got = ro.pair_tail_bwd_kernel(*ins, tok, g, True)
            want = ro.pair_tail_bwd_reference(*ins, tok, g, True)
            torch.cuda.synchronize()
            rel = {}
            for name, a, b in zip(names, got, want):
                err, mag = (a - b).abs().max().item(), b.abs().max().item()
                if not (torch.isfinite(a).all() and err <= BWD_RTOL * max(mag, 1e-30)):
                    raise AssertionError(f"relation_oracle_bwd {name} disagrees at B={B} O={O} "
                                         f"H={H} E={E}: max abs {err!r} > {BWD_RTOL} x {mag!r}")
                rel[name] = err / max(mag, 1e-30)
                worst_abs = max(worst_abs, err)
            t = cuda_ms({"kernel": lambda: ro.pair_tail_bwd_kernel(*ins, tok, g, False),
                         "plain": lambda: ro.pair_tail_bwd_reference(*ins, tok, g, False)}, reps=5)
            dev = kernel_device_ms(lambda: ro.pair_tail_bwd_kernel(*ins, tok, g, False),
                                   "relation_oracle_bwd", lambda: ro.BWD_LAUNCHES, reps=5)
        worst = max(rel, key=rel.get)
        rec = shape_record(t, pair_tail_work(B, O, H, E, R, backward=True), dev, B=B, O=O, H=H,
                           E=E, worst_grad_rel_err=rel[worst])
        shapes.append(rec)
        log(f"[3] relation_oracle_bwd B={B} O={O} H={H} E={E} R={R}: nine gradients within "
            f"{BWD_RTOL} of their largest value (worst {worst} {rel[worst]!r}) "
            f"ms={rec['ms']!r} device_ms={rec['device_ms']!r} "
            f"plain_ms={t['plain']!r} flop={rec['flop']!r} bound_ms={rec['bound_ms']!r} "
            f"({rec['bound_by']}, 3xTF32) share_of_bound={rec['share_of_bound']!r} "
            f"f32_simt_bound_ms={rec['f32_simt_bound_ms']!r} ({stamp})")
    main = next(r for r in shapes if (r["B"], r["O"], r["H"]) == (80, 100, 256))
    return {"name": "relation_oracle_bwd", "route": "cuda",
            "source": "dfol_vqa_tpu_torch/csrc/relation_oracle_bwd.cu",
            "replaces": "dfol_vqa_tpu/ops/pallas/relation_oracle.py:66",
            "max_abs_err": worst_abs, "ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"], "flop": main["flop"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "share_of_bound": main["share_of_bound"],
            "library_ms": None, "library_note": LIBRARY_NOTE, "at": {"B": 80, "O": 100},
            "shapes": shapes}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ULP of each value: 2^(e-8) for |x| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def clip_scale(cfg, grads: dict, trainable: set) -> float:
    """The optimizer's global-norm clip factor for these gradients."""
    norm = np.sqrt(sum(float(np.sum(grads[k].astype(np.float64) ** 2)) for k in trainable))
    return 1.0 if norm < cfg.clip_norm else cfg.clip_norm / norm


def adam_bound(cfg, trainable: set, steps, moments: dict = None, t0: int = 0) -> dict:
    """Per-element bound on |other - ref| parameters after ``len(steps)``
    optimizer steps (global-norm clip, L2 decay, Adam) of two
    implementations from the same start. ``steps`` holds, per step, (ref
    gradients, other gradients, ref parameters before the step, delta): flat
    numpy dicts by checkpoint key, the other side's gradient known to lie
    within ``delta[key]`` of the ref's, element by element (the caller's
    gradient gate). Both start from Adam's zero moments, or from the same
    ``moments`` {key: (m, v)} after ``t0`` steps (``adam_moments``).

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
    for k, (m, v) in (moments or {}).items():
        m, v = m.astype(np.float64), v.astype(np.float64)
        state[k] = [m, v, m, m, v, v]
    for t, (ref, other, params, delta) in enumerate(steps, t0 + 1):
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


def adam_moments(opt, params) -> tuple:
    """({checkpoint key: (m, v)} as numpy, steps taken) of ``opt``'s Adam
    over ``params``: ``adam_bound``'s ``moments`` and ``t0``."""
    state = opt.adam.state if opt.adam is not None else {}
    moments, t0 = {}, 0
    for name, p in params.named_parameters():
        if p in state:
            s = state[p]
            moments[name.replace(".", "/")] = (s["exp_avg"].cpu().numpy().copy(),
                                               s["exp_avg_sq"].cpu().numpy().copy())
            t0 = int(s["step"])
    return moments, t0


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
            H = h_s.shape[-1]
            widths = [H] + [layer.w.shape[1] for layer in layers]
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).replace("torch.", "")
                esize = torch.empty((), dtype=dtype).element_size()
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
                dev = kernel_device_ms(lambda: pm.pair_mlp_fused(pos, h_s, h_o, w_g, b0, layers,
                                                                 dtype), "pair_mlp_fwd_kernel",
                                       lambda: pm.LAUNCHES)
                E = h2.shape[-1]
                # the Linear chain, 2kn FLOP per pair and layer, f32 inputs, h2 out
                chain = list(zip(widths, widths[1:]))
                work = kernel_bound(U * O * O * sum(2 * k * n for k, n in chain), 0,
                                    4 * (U * O * 4 + 2 * U * O * H + 5 * H
                                         + sum(k * n + n for k, n in chain))
                                    + esize * U * O * O * E)
                rec = times[("pair_mlp", U, name)] = shape_record(t, work, dev, U=U, O=O, h2=name)
                log(f"[3] pair_mlp U={U} O={O} H={H} E={E} h2 {name}: "
                    f"max_abs_err={diff.max().item()!r} (within {bound}) "
                    f"ms={rec['ms']!r} device_ms={rec['device_ms']!r} "
                    f"plain_ms={t['plain']!r} flop={work['flop']!r} "
                    f"bound_ms={work['bound_ms']!r} ({work['bound_by']}, 3xTF32) share_of_bound="
                    f"{rec['share_of_bound']!r} f32_simt_bound_ms="
                    f"{work['f32_simt_bound_ms']!r} ({stamp})")

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
                dev = kernel_device_ms(lambda: sc.shared_contract_kernel(h2, img, es, b_sel, tok),
                                       "shared_contract_kernel", lambda: sc.LAUNCHES)
                # h2[img[b]] . e_sel[b, r]: 2RE FLOP per (question, pair); h2 and
                # e_sel in the stream's dtype, float32 log-likelihoods out
                work = kernel_bound(B * O * O * 2 * R * E, 0,
                                    esize * (U * O * O * E + B * R * E) + 4 * (B + 2 * U + 2 * B * R)
                                    + 4 * B * R * O * O, dtype)
                rec = times[("shared_contract", U, name)] = shape_record(t, work, dev, B=B, U=U,
                                                                         O=O, h2=name)
                log(f"[3] shared_contract B={B} U={U} O={O} E={E} R={R} h2 {name}: "
                    f"max_abs_err={e!r} ms={rec['ms']!r} device_ms={rec['device_ms']!r} "
                    f"plain_ms={t['plain']!r} flop={work['flop']!r} "
                    f"bound_ms={work['bound_ms']!r} ({work['bound_by']}) share_of_bound="
                    f"{rec['share_of_bound']!r} f32_simt_bound_ms="
                    f"{work['f32_simt_bound_ms']!r} ({stamp})")
    sources = {"pair_mlp": ("pair_mlp.cu", "dfol_vqa_tpu/ops/pallas/pair_mlp.py:90"),
               "shared_contract": ("shared_contract.cu",
                                   "dfol_vqa_tpu/ops/pallas/shared_contract.py:46")}
    records = []
    for name, (src, replaces) in sources.items():
        main = times[(name, 8, "bfloat16")]  # the offline-eval default: U=8, bf16 stream
        records.append({"name": f"{name}_fwd", "route": "cuda",
                        "source": f"dfol_vqa_tpu_torch/csrc/{src}", "replaces": replaces,
                        "max_abs_err": err[name], "ms": main["ms"], "device_ms": main["device_ms"],
                        "plain_ms": main["plain_ms"],
                        "flop": main["flop"], "bound_ms": main["bound_ms"],
                        "bound_by": main["bound_by"], "share_of_bound": main["share_of_bound"],
                        "library_ms": None, "library_note": LIBRARY_NOTE,
                        "at": {"U": 8, "B": 80, "O": 100, "h2": "bfloat16"},
                        "shapes": [rec for (n, *_), rec in times.items() if n == name]})
    return records


def serve_questions(world, mix=SERVE_MIX, seed=1000):
    qs = []
    for fi, (fam, hops, n) in enumerate(mix):
        qs += world.generate_family(fam, n, length=hops, seed=seed + fi,
                                    neg_prob=0.3 if fam == "exist" else 0.0,
                                    id_prefix=f"smoke-{fam}{hops}-")
    return qs


def check_launches(launches: int, keys, relating) -> None:
    """Kernel 1 launches once per relating group of a served run: at least
    once per relating canonical spec, at most once per relating request."""
    if not len(keys) <= launches <= sum(relating) or launches <= 0:
        raise AssertionError(f"the relation_oracle kernel launched {launches} times for "
                             f"{sum(relating)} relating requests of {len(keys)} specs")


def phase_serve(eng, cpu_eng, world, stamp: str, mix=SERVE_MIX, tag: str = "4",
                seed: int = 1000, answers: dict = None) -> int:
    """Serve ``mix`` (default: phase 4's 64 requests) on the card; the
    answers must equal ``cpu_eng``'s (the same engine and weights on the
    CPU), and kernel 1 must have launched once per relating group: at least
    once per relating canonical spec, at most once per relating request.
    ``answers[tag]`` keeps the CPU engine's answers (phase 14 holds its mesh
    engines to them). Returns the kernel launches of the run."""
    from dfol_vqa_tpu_torch.models.interpreter import spec_needs_relations
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro

    qs = serve_questions(world, mix, seed)
    specs = [eng._prepare(q)[0] for q in qs]
    relating = [spec_needs_relations(k) for k in specs]
    keys = {k for k, r in zip(specs, relating) if r}
    info = eng.warmup(qs)
    log(f"[{tag}] warmup: {info['specs']} specs x rungs {info['batch_sizes']} in "
        f"{info['seconds']!r} s ({stamp})")
    ro.LAUNCHES = 0
    t0 = time.perf_counter()
    results = eng.answer_many(qs)
    seconds = time.perf_counter() - t0
    launches = ro.LAUNCHES
    want = [r.answers for r in cpu_eng.answer_many(qs)]
    got = [r.answers for r in results]
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"{bad}/{len(qs)} GPU answers differ from the CPU plain engine")
    if answers is not None:
        answers[tag] = want
    check_launches(launches, keys, relating)
    p50 = statistics.median(r.latency_ms for r in results)
    families = sorted({q["program"]["last_op"]["operator"] for q in qs})
    log(f"[{tag}] served {len(qs)} requests ({', '.join(families)}) in {seconds!r} s: "
        f"{len(qs) / seconds!r} requests/s, p50 latency {p50!r} ms, batches "
        f"{eng.stats['batches']}, relation_oracle launches {launches} for {sum(relating)} "
        f"relating requests of {len(keys)} specs; answers == CPU plain engine ({stamp})")
    return launches


def transfer_host_ms(lb, device, transfer_dtype, reps: int = 20) -> tuple:
    """Host ms of ``to_device_batch(lb, device, transfer_dtype)``: the median
    of the call alone (quantization, pinning and enqueue) and of the call
    with a synchronize after it, over ``reps`` calls each."""
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch

    alone, synced = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_device_batch(lb, device, transfer_dtype)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        alone.append(1000 * (t1 - t0))
        synced.append(1000 * (time.perf_counter() - t0))
    return statistics.median(alone[1:]), statistics.median(synced[1:])


def phase_serve_int8(eng, cpu_eng, world, device, stamp: str) -> int:
    """Phase 4's 64 requests through engines like phase 4's (same weights)
    with the int8 object transfer (``transfer_dtype="int8"``): the card's
    answers must equal the CPU engine's with int8 (int8 is held against int8:
    its features differ from float32 by the quantization step), kernel 1
    once per relating group (``phase_serve``). Then the host ms per batch of
    the int8 and the bf16 transfer of one 32-request batch. Returns kernel
    1's launches."""
    from dfol_vqa_tpu_torch.data.loader import LoadedBatch
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.serve import ServingEngine

    ont = GQAOntology()
    engines = [ServingEngine(e.cfg, ont, e.params, features=world, device=d, max_batch=32,
                             transfer_dtype="int8") for e, d in ((eng, device), (cpu_eng, "cpu"))]
    try:
        launches = phase_serve(engines[0], engines[1], world, stamp, tag="4 int8")
    finally:
        for e in engines:
            e.stop()
    qs = world.generate_family("exist", 32, length=2, seed=3000)
    spec, cb = eng.compiler.compile(qs)
    objects, obj_mask = world.batch([q["imageId"] for q in qs], eng.cfg.tpu.max_object_num)
    lb = LoadedBatch(spec, cb, objects, obj_mask)
    times = [(dt, transfer_host_ms(lb, device, dt))
             for dt in ("int8", "bfloat16", "bfloat16", "int8")]  # in turns
    log(f"[4 int8] host ms per 32-request batch (objects {tuple(objects.shape)}), median of 20 "
        f"calls, the call alone / with a synchronize after it: " + "; ".join(
            f"{dt} {a!r} / {b!r}" for dt, (a, b) in times) + f" ({stamp})")
    return launches


def check_golden(device, atol: float, mesh=None) -> int:
    """Run the port against the JAX golden on ``device`` (or over the
    serving ``mesh``: each request's forward through data row 0's replica,
    its head split over the row's model devices); returns the number of
    requests checked. Answers must be equal and log-probabilities within
    ``atol``; the port's compiled program tensors must equal JAX's."""
    from dfol_vqa_tpu_torch.convert import params_from_numpy
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.serve import _Request, build_demo_engine

    golden = np.load(GOLDEN)
    params = params_from_numpy({k[len("params/"):]: golden[k]
                                for k in golden.files if k.startswith("params/")})
    n = sum(1 for k in golden.files if k.endswith("/question"))
    _, _, _, eng = build_demo_engine(tiny=True, device=device, params=params, max_batch=8,
                                     mesh=mesh)
    device = eng.device
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


def check_trace_golden(device, atol: float) -> int:
    """``ServingEngine.trace`` on ``device`` against the JAX trace golden
    (the tiny demo engine with the serving golden's weights); returns the
    number of requests checked. Hops (branch, op, token) and answers must
    be equal, the attentions (probabilities) and log-probabilities within
    ``atol``."""
    from dfol_vqa_tpu_torch.convert import params_from_numpy
    from dfol_vqa_tpu_torch.serve import build_demo_engine

    weights = np.load(GOLDEN)
    params = params_from_numpy({k[len("params/"):]: weights[k]
                                for k in weights.files if k.startswith("params/")})
    golden = np.load(TRACE_GOLDEN)
    n = sum(1 for k in golden.files if k.endswith("/hops"))
    _, _, _, eng = build_demo_engine(tiny=True, device=device, params=params, start=False)
    try:
        for i in range(n):
            p = f"trace/{i}/"
            entry = eng.trace(json.loads(str(golden[p + "question"])), golden[p + "objects"],
                              golden[p + "obj_mask"])
            hops = [[h["branch"], h["op"], h["token"]] for h in entry["hops"]]
            if hops != json.loads(str(golden[p + "hops"])):
                raise AssertionError(f"trace {i}: hops {hops} differ from the golden")
            if entry["answers"] != json.loads(str(golden[p + "answers"])):
                raise AssertionError(f"trace {i}: answers {entry['answers']} differ")
            for what, got in (("attention", [h["attention"] for h in entry["hops"]]),
                              ("log_probability", entry["log_probability"])):
                err = np.abs(np.asarray(got, np.float32) - golden[p + what]).max()
                if not err <= atol:
                    raise AssertionError(f"trace {i}: {what} off by {err} > {atol}")
    finally:
        eng.stop()
    return n


def check_eval_golden(device, atol: float) -> int:
    """Run the port's offline evaluation against the JAX eval golden on
    ``device`` (float32 h2 stream); returns the number of batches checked.
    The loader's batches must equal the golden's, log-probabilities agree
    within ``atol``, and answer flags, the ``test_epoch`` error vector and
    counts, and the ``predict`` output be equal."""
    from dfol_vqa_tpu_torch.ontology import GQAOntology
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
    from dfol_vqa_tpu_torch.ontology import GQAOntology
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


def terminals_golden_setup(ontology):
    """(cfg, supervision cfg, world, {terminal: question file}) of the
    terminals golden: tiny dims, dropout 0, each question terminal of
    ``evalset.TERMINAL_HOPS`` as 8 questions on 2 images of their own (U * 2
    <= B: the shared-image route), the supervision batches of
    ``SUPERVISION_GOLDEN["n"]`` questions. numpy only."""
    from dfol_vqa_tpu_torch.data import evalset, trainset

    cfg = trainset.demo_train_config(tiny=True)
    cfg.train_batch_size = 8
    sup_cfg = dataclasses.replace(cfg, train_batch_size=SUPERVISION_GOLDEN["n"])
    world = evalset.demo_world(ontology, tiny=True)
    sets = evalset.eval_datasets(world, tuple((t, h, 8) for t, h in evalset.TERMINAL_HOPS), 8, 2,
                                 seed=11)
    return cfg, sup_cfg, world, {t: qs for (t, _), qs in zip(evalset.TERMINAL_HOPS, sets)}


def pack_arrays(arrays: dict) -> tuple:
    """A batch's compiled arrays as one float64 vector (every int32 and
    float32 value is exact in float64) and its layout, JSON [name, dtype,
    shape] in name order: one npz entry per batch instead of one per array."""
    names = sorted(arrays)
    layout = [[k, str(arrays[k].dtype), list(arrays[k].shape)] for k in names]
    blob = np.concatenate([np.asarray(arrays[k], np.float64).ravel() for k in names])
    return blob, np.array(json.dumps(layout))


def scene_summary(lp: dict, attr_weight: np.ndarray) -> dict:
    """``scene``'s log-probabilities as the terminals golden keeps them: the
    listed-pair relation scores whole; of the (B, O, A) attribute scores,
    the entries that ``attr_weight`` supervises (``attr_at``) and the sums
    over the A attributes (``attr_sum``)."""
    attr = np.asarray(lp["attr"])
    return {"rel": np.asarray(lp["rel"]), "attr_at": attr[np.asarray(attr_weight) > 0],
            "attr_sum": attr.sum(axis=-1)}


def check_terminals_golden(device, atol: float, grad_rtol: float) -> tuple:
    """Every terminal, soft and hard, against the JAX terminals golden on
    ``device`` (the eval golden's weights); returns (batches checked, answers
    that differ inside a near-tie). The rebuilt batches must equal the
    golden's; log-probabilities agree within ``atol`` (``scene``'s attribute
    sums within ``atol`` per term); answer flags and matches be equal except
    on a row that the golden's scores put in a near-tie (``near_ties``); and
    for the supervision terminals the training loss agree within
    ``grad_rtol`` relative and every gradient leaf within ``grad_rtol`` of
    max(1, its largest value)."""
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.convert import params_from_numpy
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    golden = np.load(TERMINALS_GOLDEN)
    with np.load(EVAL_GOLDEN) as eval_golden:
        start = {k[len("params/"):]: eval_golden[k] for k in eval_golden.files
                 if k.startswith("params/")}
    ont = GQAOntology()
    cfg, sup_cfg, world, _ = terminals_golden_setup(ont)
    n = ties = 0
    for term in [t for t, _ in evalset.TERMINAL_HOPS] + list(trainset.SUPERVISION_TERMINALS):
        p = f"batch/{term}/"
        if term in trainset.SUPERVISION_TERMINALS:
            c = sup_cfg
            (lb,) = list(trainset.supervision_loader(sup_cfg, ont, term, **SUPERVISION_GOLDEN))
        else:
            c = cfg
            (lb,) = list(trainset.train_loader(
                cfg, ont, world, [json.loads(str(golden["datasets/" + term]))], shuffle=False))
        blob, layout = pack_arrays(lb.arrays)
        for name, v in (("objects", lb.objects), ("obj_mask", lb.obj_mask), ("arrays", blob),
                        ("array_layout", layout)):
            if not np.array_equal(v, golden[p + name]):
                raise AssertionError(f"{term} batch: {name} differs from the golden")
        params = params_from_numpy(start).to(device)
        _, o, m, arrays = to_device_batch(lb, device)
        for mode in ("soft", "hard"):
            interp = Interpreter(dataclasses.replace(c, hard_mode=mode == "hard"), ont)
            with torch.inference_mode():
                res = interp.forward(params, o, m, arrays, lb.spec)
            lp, q = res["log_probability"], f"{p}{mode}/"
            if isinstance(lp, dict):  # the mode does not enter scene's scores
                got = scene_summary({k: v.cpu().numpy() for k, v in lp.items()},
                                    lb.arrays["attr_weight"])
                want = {k: golden[f"{p}log_probability/{k}"] for k in got}
                tie = np.zeros((len(lb.arrays["question_mask"]), 1), bool)
            else:
                got = {"": lp.cpu().numpy()}
                want = {"": golden[q + "log_probability"]}
                tie = near_ties(term, want[""], lb.arrays["opt_mask"])
            for k, v in got.items():
                tol = atol * (lp["attr"].shape[-1] if k == "attr_sum" else 1)
                err = np.abs(v - want[k]).max()
                if not (np.isfinite(v).all() and v.shape == want[k].shape and err <= tol):
                    raise AssertionError(f"{term} {mode}: log_probability {k} off by {err} > {tol}")
            flags = res["answer_flags"].cpu().numpy()
            differ = (flags != golden[q + "answer_flags"]).reshape(len(flags), -1).any(axis=1)
            row_tie = tie.any(axis=1)
            match = res["match"].cpu().numpy()
            bad_match = match != golden[q + "match"]
            if term in trainset.SUPERVISION_TERMINALS:  # a batch-wide average
                bad_match = bad_match & ~row_tie.any()
            else:
                bad_match = bad_match & ~row_tie
            if (differ & ~row_tie).any() or bad_match.any():
                raise AssertionError(f"{term} {mode}: answer flags or matches differ from the "
                                     "golden outside a near-tie")
            ties += int(differ.sum())
        if term in trainset.SUPERVISION_TERMINALS:
            trainer = VQATrainer(c, Interpreter(c, ont), device=device)
            loss = trainer.compute_grads(params, lb).item()
            want = float(golden[p + "loss"])
            if not (np.isfinite(loss) and abs(loss - want) <= grad_rtol * abs(want)):
                raise AssertionError(f"{term}: loss {loss!r} != golden {want!r}")
            want_grads = {k[len(p + "grads/"):]: golden[k] for k in golden.files
                          if k.startswith(p + "grads/")}
            for k, (err, mag) in leaf_errors(grads_of(params), want_grads).items():
                if not err <= grad_rtol * max(1.0, mag):
                    raise AssertionError(f"{term}: gradient {k} off by {err!r} (max {mag!r})")
        n += 1
    return n, ties


CALIBRATOR_GOLDEN_SEED = 9  # numpy seed of the calibrator golden's new leaves
CALIBRATOR_GOLDEN_STEPS = ("per_question", "choose_rel")  # its training batches


def calibrator_golden_setup(ontology):
    """(calibrator cfg, F = 4 cfg, world, {batch name: question file}) of the
    calibrator golden: the terminals golden's tiny dims and question files
    (every question terminal, 8 questions on 2 images: the shared route)
    and the training golden's shuffled ``exist`` file (``per_question``:
    U * 2 > B). The calibrator cfg carries the last curriculum stage's
    freeze flags (the oracle frozen, the calibrator trained) and state 8;
    the F = 4 cfg ``operator_layers_config=[8]``. Weight decay 0, so a leaf
    without a gradient keeps its value. numpy only."""
    from dfol_vqa_tpu_torch.data import trainset

    cfg, _, world, files = terminals_golden_setup(ontology)
    cfg = dataclasses.replace(cfg, weight_decay=0.0)
    calib = dataclasses.replace(cfg, activate_attention_transfer=True,
                                attention_transfer_state_dim=8, freeze_featurizer=True,
                                freeze_attribute_network=True, freeze_relation_network=True,
                                freeze_embedding_network=True)
    f4 = dataclasses.replace(cfg, oracle_output_dim=4, operator_layers_config=[8])
    files = dict(files, per_question=trainset.train_datasets(world, (("exist", 2, 8),), seed=7)[0])
    return calib, f4, world, files


def calibrator_golden_weights(start: dict, calib, f4) -> tuple:
    """The calibrator golden's weights, flat by checkpoint key: (calibrator
    model, F = 4 model), each the eval golden's weights ``start`` plus new
    leaves drawn with numpy from ``CALIBRATOR_GOLDEN_SEED``: the LSTM cells
    as torch initialises them and the output head's weights normal x 0.4
    (its bias at init); the extra channels normal / sqrt(E) and the operator
    modules' first layers as torch initialises them, their final layers
    normal x 0.4. At init the head and the final layers are identities; drawn
    at random, the comparison reaches the calibrator and the extra channels."""
    from dfol_vqa_tpu_torch.models import calibrator as cal

    rng = np.random.default_rng(CALIBRATOR_GOLDEN_SEED)

    def uniform(shape, k):
        return rng.uniform(-k, k, shape).astype(np.float32)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    S, in_dim = calib.attention_transfer_state_dim, calib.word_embedding_dim + 1 + cal.OPS_NUM
    k = 1.0 / np.sqrt(S)
    calib_w = dict(start)
    for cell in ("fwd", "bwd"):
        for name, shape in (("w_ih", (in_dim, 4 * S)), ("w_hh", (S, 4 * S)), ("b_ih", (4 * S,)),
                            ("b_hh", (4 * S,))):
            calib_w[f"calibrator/{cell}/{name}"] = uniform(shape, k)
    calib_w["calibrator/out/w"] = normal((2 * S, cal.MOD_DIM), 0.4)
    calib_w["calibrator/out/b"] = np.array([-np.log(cal.MAX_ACTIVATION - 1.0)] * 3 + [0.0],
                                           np.float32)
    E, V_pad = start["embedding/w"].shape
    F, hidden = f4.oracle_output_dim, f4.operator_layers_config[0]
    f4_w = dict(start)
    f4_w["embedding_extra/w"] = normal((E, V_pad, F - 1), 1.0 / np.sqrt(E))
    f4_w["embedding_extra/b"] = np.zeros((V_pad, F - 1), np.float32)
    for arity in ("arity1", "arity2"):
        key = f"op_modules/{arity}/layers"
        f4_w[f"{key}/0/w"] = uniform((F, hidden), 1.0 / np.sqrt(F))
        f4_w[f"{key}/0/b"] = uniform((hidden,), 1.0 / np.sqrt(F))
        f4_w[f"{key}/1/w"] = normal((hidden, 1), 0.4)
        f4_w[f"{key}/1/b"] = normal((1,), 0.4)
    return calib_w, f4_w


def calibrator_golden_batches(ontology, world, files, cfg) -> dict:
    """{batch name: LoadedBatch} of the calibrator golden, unshuffled."""
    from dfol_vqa_tpu_torch.data import trainset

    return {name: list(trainset.train_loader(cfg, ontology, world, [qs], shuffle=False))[0]
            for name, qs in files.items()}


def check_calibrator_golden(device, atol: float, grad_rtol: float) -> dict:
    """The calibrator and F = 4 models against the JAX calibrator golden on
    ``device``; returns {model: batches checked} and logs the worst
    reading. The rebuilt batches must equal the golden's; per model and
    batch every eval and training-mode log_probability meets
    ``saturated_lp_check`` at ``atol``, eval answer flags and
    matches equal except on a row that the golden's scores put in a near-tie
    (``near_ties``; training-mode flags answer nothing); per training batch the loss within ``grad_rtol``
    relative, every gradient leaf stored within ``grad_rtol`` of max(1, its
    largest value), and one optimizer step's change of every parameter
    within ``adam_bound`` of JAX's. The calibrator model's frozen oracle
    must not move. On a CUDA device the calibrator's per-question step
    launches kernels 1 and 2 once each, its shared ``choose_rel`` step kernels
    3 and 4, and the F = 4 model no kernel."""
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.convert import params_from_numpy
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.train.optim import Optimizer
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    golden = np.load(CALIBRATOR_GOLDEN)
    with np.load(EVAL_GOLDEN) as eval_golden:
        start = {k[len("params/"):]: eval_golden[k] for k in eval_golden.files
                 if k.startswith("params/")}
    ont = GQAOntology()
    calib, f4, world, files = calibrator_golden_setup(ont)
    weights = dict(zip(("calibrator", "f4"), calibrator_golden_weights(start, calib, f4)))
    batches = calibrator_golden_batches(ont, world, files, calib)
    cuda = torch.device(device).type == "cuda"
    checked, worst, saturated = {}, (0.0, ""), [0, 0.0]
    for model, cfg in (("calibrator", calib), ("f4", f4)):
        interp = Interpreter(cfg, ont)
        names = [n for n in files if f"{model}/{n}/eval/log_probability" in golden.files]
        for name in names:
            lb, p = batches[name], f"{model}/{name}/"
            blob, layout = pack_arrays(lb.arrays)
            for key, v in (("objects", lb.objects), ("obj_mask", lb.obj_mask), ("arrays", blob),
                           ("array_layout", layout)):
                if not np.array_equal(v, golden[f"batch/{name}/{key}"]):
                    raise AssertionError(f"{name} batch: {key} differs from the golden")
            params = params_from_numpy(weights[model]).to(device)
            _, o, m, arrays = to_device_batch(lb, device)
            for mode in ("eval", "train"):
                with torch.inference_mode():
                    res = interp.forward(params, o, m, arrays, lb.spec, is_training=mode == "train")
                lp, want = res["log_probability"].cpu().numpy(), golden[p + mode + "/log_probability"]
                if lp.shape != want.shape or not np.isfinite(lp).all():
                    raise AssertionError(f"{model} {name} {mode}: log_probability {lp.shape} "
                                         f"not finite or not the golden's {want.shape}")
                ok, by_ulp, err = saturated_lp_check(lp, want, atol)
                if not ok.all():
                    at = np.unravel_index(np.argmin(ok), ok.shape)
                    raise AssertionError(f"{model} {name} {mode}: log_probability {lp[at]!r} at "
                                         f"{list(at)}, the golden's {want[at]!r}: beyond {atol} x "
                                         f"max(1, |golden's|) and {SATURATED_ULPS} x 2^-24 in "
                                         "probability")
                worst = max(worst, (err[1], f"{model} {name} {mode}"))
                saturated = [saturated[0] + by_ulp[0], max(saturated[1], by_ulp[1])]
                if mode == "train":
                    continue
                tie = near_ties(lb.spec.terminal_op, want, lb.arrays["opt_mask"]).any(axis=1)
                flags = res["answer_flags"].cpu().numpy()
                differ = (flags != golden[p + mode + "/answer_flags"]).reshape(len(flags), -1)
                bad = differ.any(axis=1) | (res["match"].cpu().numpy() != golden[p + mode + "/match"])
                if (bad & ~tie).any():
                    raise AssertionError(f"{model} {name} {mode}: answer flags or matches differ "
                                         "from the golden outside a near-tie")
            if p + "loss" not in golden.files:
                continue
            trainer = VQATrainer(cfg, interp, device=device)
            opt = Optimizer(cfg, params)
            before = launch_counts()
            loss = trainer.compute_grads(params, lb).item()
            d = [a - b for a, b in zip(launch_counts(), before)]
            want = float(golden[p + "loss"])
            if not (np.isfinite(loss) and abs(loss - want) <= grad_rtol * abs(want)):
                raise AssertionError(f"{model} {name}: loss {loss!r} != golden {want!r}")
            want_grads = {k[len(p + "grads/"):]: golden[k] for k in golden.files
                          if k.startswith(p + "grads/")}
            got_grads, delta = grads_of(params), {}
            for k, (err, mag) in leaf_errors({k: got_grads[k] for k in want_grads},
                                             want_grads).items():
                delta[k] = grad_rtol * max(1.0, mag)
                if not err <= delta[k]:
                    raise AssertionError(f"{model} {name}: gradient {k} off by {err!r} "
                                         f"(max {mag!r})")
            opt.step()
            trainable = trainable_keys(cfg, params)
            ref = {k: want_grads.get(k, np.zeros_like(v)) for k, v in weights[model].items()}
            bound = adam_bound(cfg, trainable, [(ref, got_grads, weights[model], delta)])
            after = flat_params(params)
            for k, s0 in weights[model].items():
                if k not in trainable and not np.array_equal(after[k], s0):
                    raise AssertionError(f"{model} {name}: frozen {k} moved")
                if not np.all(np.abs((after[k] - s0) - golden[p + "update/" + k]) <= bound[k]):
                    raise AssertionError(f"{model} {name}: the step's change of {k} is off")
            # F = 4 takes the plain tails; the calibrator model's per-question
            # batch kernels 1 and 2, its shared choose_rel batch kernels 3 and 4
            want_d = ([0, 0, 0, 0] if model == "f4" else
                      [1, 1, 0, 0] if name == "per_question" else [0, 0, 1, 1])
            if cuda and d != want_d:
                raise AssertionError(f"{model} {name}: step launched (fwd, bwd, pair_mlp, "
                                     f"contract) {d} times")
        checked[model] = len(names)
    log(f"[calibrator golden on {device}] worst reading outside the float32-saturated "
        f"entries: {worst[0]!r} x max(1, |golden's|) in log space ({worst[1]}); saturated "
        f"entries (beyond {atol} in log space, within {SATURATED_ULPS} x 2^-24 in probability): "
        f"{saturated[0]}, the largest {saturated[1]!r} x 2^-24")
    return checked


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


CACHE_DTYPE_BATCHES = (32, 80, 256)
CACHE_DTYPE_OBJECTS = (24, 100)
CACHE_DTYPE_ROUNDS = 5  # profiled runs per dtype and cell, in turns
CACHE_DTYPE_REPS = 5  # forwards per profiled run


def phase_cache_dtype(device, stamp: str) -> dict:
    """The measurement behind ``tpu.cache_dtype="auto"``: the device time of
    one eval ``Interpreter.forward`` (the union of its device events in
    ``torch.profiler``, per forward) with float32 and with bfloat16 caches,
    on one relating batch of ``exist`` questions at ~10 questions per image
    (the shared route) at production widths, for each batch in
    ``CACHE_DTYPE_BATCHES`` and object count in ``CACHE_DTYPE_OBJECTS``:
    ``CACHE_DTYPE_ROUNDS`` profiled runs per dtype in turns, their median and
    spread (max - min). Eval is host-bound, so the host clock would not show
    the difference. Prints the table and what "auto" picks; raises if
    bfloat16 beats float32 by more than both runs' spreads at every object
    count of some batch, since ``models/oracle.resolve_cache_dtype`` makes
    "auto" float32 at every batch from the table it was measured to on an
    NVIDIA H100 80GB HBM3 at 700 W. Returns the table, (B, O) -> (float32
    ms, spread, bfloat16 ms, spread)."""
    import dataclasses as dc

    from dfol_vqa_tpu_torch.data import evalset
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models import oracle as om
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology

    t0 = time.perf_counter()
    ont = GQAOntology()
    world = evalset.demo_world(ont)
    base = evalset.demo_eval_config()
    params = Interpreter(base, ont).init_params(torch.Generator().manual_seed(0), device)
    readings = {}
    for O in CACHE_DTYPE_OBJECTS:
        for B in CACHE_DTYPE_BATCHES:
            cfgs = {dt: dc.replace(base, test_batch_size=B, tpu=dc.replace(
                base.tpu, max_object_num=O, cache_dtype=dt)) for dt in ("float32", "bfloat16")}
            sets = evalset.eval_datasets(world, (("exist", 2, B),), B, max(1, B // 10))
            (lb,) = list(evalset.eval_loader(cfgs["float32"], ont, world, sets))
            U = lb.objects.shape[0]
            if U * 2 > B:
                raise AssertionError(f"B={B}, O={O}: U={U} would take the per-question route")
            _, o, m, arrays = to_device_batch(lb, device)
            interps = {dt: Interpreter(cfg, ont) for dt, cfg in cfgs.items()}
            runs = {dt: [] for dt in cfgs}
            with torch.inference_mode():
                for dt, interp in interps.items():  # warm-up
                    interp.forward(params, o, m, arrays, lb.spec)
                for r in range(CACHE_DTYPE_ROUNDS):
                    for dt in (("float32", "bfloat16") if r % 2 == 0 else
                               ("bfloat16", "float32")):
                        torch.cuda.synchronize()
                        with torch.profiler.profile(
                                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                            for _ in range(CACHE_DTYPE_REPS):
                                out = interps[dt].forward(params, o, m, arrays, lb.spec)
                            torch.cuda.synchronize()
                        busy, _ = device_time(prof)
                        if busy is None:
                            raise AssertionError("the profiler saw no device event")
                        if out["log_probability"].dtype != torch.float32:
                            raise AssertionError("the forward's output left float32")
                        runs[dt].append(busy / CACHE_DTYPE_REPS)
            readings[(B, O)] = tuple(x for dt in ("float32", "bfloat16") for x in (
                statistics.median(runs[dt]), max(runs[dt]) - min(runs[dt])))
            f32, f32_s, bf16, bf16_s = readings[(B, O)]
            log(f"[3] cache dtype, B={B}, O={O} (U_pad={U}): device ms per eval forward, median "
                f"(spread) of {CACHE_DTYPE_ROUNDS} runs of {CACHE_DTYPE_REPS}: float32 {f32!r} "
                f"({f32_s!r}), bfloat16 {bf16!r} ({bf16_s!r}); bf16 wins here: "
                f"{f32 - bf16 > f32_s + bf16_s} ({stamp})")
    log(f"[3] cache dtype table (B, O) -> (f32 ms, spread, bf16 ms, spread): {readings!r}")
    auto = dc.replace(base, tpu=dc.replace(base.tpu, cache_dtype="auto"))
    picks = {B: str(om.resolve_cache_dtype(auto, B)) for B in CACHE_DTYPE_BATCHES}
    wins = [B for B in CACHE_DTYPE_BATCHES
            if all(f32 - bf16 > f32_s + bf16_s
                   for (b, _), (f32, f32_s, bf16, bf16_s) in readings.items() if b == B)]
    if wins:
        raise AssertionError(f'bfloat16 caches beat float32 beyond both spreads at batches '
                             f'{wins} on {stamp}, but "auto" picks {picks}')
    log(f'[3] "auto" picks {picks}; bfloat16 wins beyond both spreads at no batch '
        f"({time.perf_counter() - t0!r} s, {stamp})")
    return readings


def near_ties(term: str, lp: np.ndarray, opt_mask: np.ndarray, band: float = 0.0) -> np.ndarray:
    """(B, options) mask of the answers that a float32 near-tie decides,
    from one batch's log-probabilities: a query's options whose scores
    exp(lp) lie within ``TIE_ULPS`` float32 ULPs of the best one (where two
    or more do: the tie rule flags every option equal to the best;
    ``compare``'s argmax picks one of its two branches); a binary or
    statement flag, or an object statement's, whose exp(lp) lies within
    ``TIE_ULPS`` ULPs of 0.5. Such an answer hinges on the last bits of sums
    taken in another order on another device. ``band``, when larger, is
    the tie's width in probability instead (bf16 products). Binary rows
    come back as (B, 1)."""
    from dfol_vqa_tpu_torch.models.interpreter import QUERY_OPS

    score = np.exp(lp).astype(np.float32)
    if term in QUERY_OPS:
        live = opt_mask[:, :score.shape[1]] > 0
        score = np.where(live, score, 0.0).astype(np.float32)
        best = score.max(axis=1, keepdims=True)
        near = live & (np.abs(score - best) <= np.maximum(TIE_ULPS * np.spacing(best), band))
        return near & (near.sum(axis=1, keepdims=True) > 1)
    near = np.abs(score - 0.5) <= max(TIE_ULPS * np.spacing(np.float32(0.5)), band)
    return near.reshape(len(near), -1)


def float_ties(interp, loader, params) -> dict:
    """Questions whose answer the CPU decides by a float32 near-tie
    (``near_ties``). Returns {position of the question among the loader's
    real questions, the order of ``predict``'s output: (terminal op, the
    answers inside the tie: option strings, or "yes" and "no")}. Positions,
    not question ids: programs read back from h5 files carry none."""
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models.interpreter import QUERY_OPS

    ties, seen = {}, 0
    for lb in loader:
        _, o, m, arrays = to_device_batch(lb, "cpu")
        with torch.inference_mode():
            lp = interp.forward(params, o, m, arrays, lb.spec)["log_probability"].numpy()
        term, cb = lb.spec.terminal_op, lb.compiled
        near = near_ties(term, lp, lb.arrays["opt_mask"])
        real = np.flatnonzero(cb.question_mask > 0)
        for pos, qi in enumerate(real):
            if near[qi].any():
                inside = ([cb.option_strings[qi][k] for k in np.flatnonzero(near[qi])]
                          if term in QUERY_OPS else ["yes", "no"])
                ties[seen + pos] = (term, inside)
        seen += len(real)
    return ties


def same_up_to_ties(preds, preds_cpu, ties) -> int:
    """Checks the card's predictions against the CPU's: equal, except where
    the CPU's answer is a near-tie (``float_ties``), where the card's must
    lie inside the tie. Returns the count of such answers that differ."""
    flipped = 0
    for pos, (got, want) in enumerate(zip(preds, preds_cpu)):
        if got == want:
            continue
        tie = ties.get(pos)
        pred = got["prediction"] if isinstance(got["prediction"], list) else [got["prediction"]]
        if (got["questionId"] != want["questionId"] or tie is None or not pred
                or not set(pred) <= set(tie[1])):
            raise AssertionError(f"prediction on the card {got} != CPU {want}")
        flipped += 1
    if len(preds) != len(preds_cpu):
        raise AssertionError(f"{len(preds)} predictions on the card, {len(preds_cpu)} on the CPU")
    return flipped


def check_error_up_to_ties(error, counts, error_cpu, counts_cpu, ties) -> None:
    """``test_epoch``'s error vector on the card against the CPU's: the same
    question counts, and each bucket's error count apart by at most its
    near-tie questions (a tie-decided answer moves its bucket by at most
    one)."""
    from dfol_vqa_tpu_torch.train.trainer import OP_INDEX

    bound = np.zeros_like(error)
    for term, _ in ties.values():
        bound[0] += 1
        if term in OP_INDEX:
            bound[OP_INDEX[term]] += 1
    if not (np.array_equal(counts, counts_cpu)
            and np.all(np.abs(error - error_cpu) * counts <= bound + 1e-3)):
        raise AssertionError(f"test_epoch error on the card {error} != CPU {error_cpu} beyond "
                             f"the float-tie bound {bound}")


def phase_eval(device, stamp: str) -> dict:
    """Offline evaluation at production dims on the card; returns the
    kernel launches of the main run (the float32-stream ``test_epoch``)."""
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.data import evalset
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter, spec_needs_relations
    from dfol_vqa_tpu_torch.ops import pair_mlp as pm
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro
    from dfol_vqa_tpu_torch.ops import shared_contract as sc
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

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
        f"{launches} for {relating} relating batches at eval_chunk={cfg.tpu.eval_chunk} "
        f"({stamp})")

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
    flipped = same_up_to_ties(preds, preds_cpu, ties)
    check_error_up_to_ties(error, gpu.last_test_counts, error_cpu, cpu.last_test_counts, ties)
    log(f"[6] f32 h2 stream vs CPU plain path (CPU test_epoch + predict {cpu_seconds!r} s): "
        f"every answer equal except {flipped} of the {len(ties)} answers that the CPU "
        f"decides by a float32 near-tie (near_ties: within {TIE_ULPS} ULPs; the card picked "
        f"inside the tie); test_epoch error equal bucket by bucket beyond those "
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
    """A loader that counts its passes, its batches and the relating batches
    it yields by relation route (``by_route``), and raises when a relating
    batch would take another route than ``route`` ("per_question": U * 2 >
    B, "shared": U * 2 <= B; "either" takes both)."""

    def __init__(self, loader, route: str):
        self.loader, self.route = loader, route
        self.passes = self.relating = self.batches = 0
        self.by_route = {"per_question": 0, "shared": 0}

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        from dfol_vqa_tpu_torch.models.interpreter import spec_needs_relations

        self.passes += 1
        for lb in self.loader:
            self.batches += 1
            if spec_needs_relations(lb.spec):
                U, B = lb.objects.shape[0], len(lb.arrays["img_index"])
                route = "shared" if U * 2 <= B else "per_question"
                if self.route not in ("either", route):
                    raise AssertionError(f"a relating {lb.spec.terminal_op} batch with U={U}, "
                                         f"B={B} would not take the {self.route} route")
                self.by_route[route] += 1
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


def launch_counts() -> list:
    """The kernels' launch counts: (relation_oracle, its backward, pair_mlp,
    shared_contract), a CUDA graph's replays included."""
    from dfol_vqa_tpu_torch.train import graphs

    return graphs.launch_counts()


def card_vs_cpu_steps(cfg, ont, params_cpu, batches, device, what: str, want_launches,
                      limits: dict = None) -> dict:
    """Training steps over ``batches`` on the card from the weights
    ``params_cpu``, each held against the CPU plain path's step from the
    same parameters and Adam state (the card's, copied to the CPU before
    every step: a reading holds one step's rounding, not the drift of two
    trajectories that Adam moves apart): every step's gradients within
    ``TRAIN_GRAD_RTOL`` of each leaf's largest value (``limits`` {step:
    rtol} gives a batch its own limit), its loss within
    ``TRAIN_LOSS_RTOL``, and the parameters after it finite and, element by
    element, within ``adam_bound`` of the CPU's; the kernels' launches over
    the card's steps (``launch_counts`` order) must be ``want_launches``.
    Returns {"launches", "losses", "text", "params" (the card's after the
    steps), "grads" (the card's, per step), "no_grad" (the checkpoint keys
    of the card's leaves that end the steps without a gradient)}. Both
    sides require gradients of the trainable leaves only, as the trainer
    does (``optim.require_grads``)."""
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.train.optim import Optimizer, require_grads
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    p_gpu, p_cpu = copy.deepcopy(params_cpu).to(device), copy.deepcopy(params_cpu)
    require_grads(p_gpu, cfg)
    require_grads(p_cpu, cfg)
    gpu = VQATrainer(cfg, Interpreter(cfg, ont), device=device)
    cpu = VQATrainer(cfg, Interpreter(cfg, ont), device="cpu")
    o_gpu, o_cpu = Optimizer(cfg, p_gpu), Optimizer(cfg, p_cpu)
    trainable = trainable_keys(cfg, params_cpu)
    before = launch_counts()
    losses, worst, card_grads, by_step, diff, used = [], (0.0, ""), [], [], 0.0, (0.0, "")
    for k, lb in enumerate(batches):
        with torch.no_grad():
            for mine, card_p in zip(p_cpu.parameters(), p_gpu.parameters()):
                mine.copy_(card_p.cpu())
        if o_gpu.adam is not None:
            # a copy: load_state_dict keeps Adam's step counters as given; the
            # card's Adam is capturable (its counters on the card), the CPU's not
            state = copy.deepcopy(o_gpu.adam.state_dict())
            for group in state["param_groups"]:
                group["capturable"] = False
            for leaf in state["state"].values():
                leaf["step"] = leaf["step"].cpu()
            o_cpu.adam.load_state_dict(state)
        start = flat_params(p_cpu)
        moments, t0 = adam_moments(o_cpu, p_cpu)
        l_gpu = gpu.compute_grads(p_gpu, lb).item()
        l_cpu = cpu.compute_grads(p_cpu, lb).item()
        g_gpu, g_cpu, delta, step_worst = grads_of(p_gpu), grads_of(p_cpu), {}, 0.0
        rtol = (limits or {}).get(k, TRAIN_GRAD_RTOL)
        for key, (err, mag) in leaf_errors(g_gpu, g_cpu).items():
            delta[key] = rtol * mag
            if not err <= delta[key]:
                raise AssertionError(f"{what} step {k} gradient {key}: card vs CPU "
                                     f"{err!r} > {rtol} x {mag!r}")
            worst = max(worst, (err / max(mag, 1e-30), f"{key} at step {k}"))
            step_worst = max(step_worst, err / max(mag, 1e-30))
        by_step.append(step_worst)
        card_grads.append(g_gpu)
        if not (np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= TRAIN_LOSS_RTOL * abs(l_cpu)):
            raise AssertionError(f"{what} step {k}: loss {l_gpu!r} on the card, {l_cpu!r} "
                                 "on the CPU")
        losses.append((l_gpu, l_cpu))
        o_gpu.step()
        o_cpu.step()
        bound = adam_bound(cfg, trainable, [(g_cpu, g_gpu, start, delta)], moments, t0)
        got, want_p = flat_params(p_gpu), flat_params(p_cpu)
        if not all(np.isfinite(v).all() for v in got.values()):
            raise AssertionError(f"{what}: non-finite parameters after step {k} on the card")
        for key, b in bound.items():
            gap = np.abs(got[key].astype(np.float64) - want_p[key])
            if not np.all(gap <= b):
                at = np.unravel_index(np.argmax(gap - b), gap.shape)
                raise AssertionError(f"{what}: parameter {key}{list(at)} after step {k} is "
                                     f"{gap[at]!r} from the CPU's, beyond the Adam bound "
                                     f"{b[at]!r}")
            diff = max(diff, float(gap.max()))
            if np.any(b > 0):
                used = max(used, (float(np.max(gap / np.where(b > 0, b, np.inf))), key))
    d = [a - b for a, b in zip(launch_counts(), before)]
    if d != list(want_launches):
        raise AssertionError(f"{what}: {len(batches)} steps launched (fwd, bwd, pair_mlp, "
                             f"contract) {d} times, not {list(want_launches)}")
    own = f" (step: own limit {limits})" if limits else ""
    text = (f"every step from the card's parameters and Adam state: gradients within "
            f"{TRAIN_GRAD_RTOL} of each leaf's largest{own} (worst {worst[1]} {worst[0]!r}; worst "
            f"by step {by_step!r}); losses (card, CPU) {losses}; parameters after a step apart "
            f"by at most {diff / cfg.learning_rate!r} lr, within the Adam bound of those "
            f"gradient gates element by element (largest share of its bound {used[0]!r}, "
            f"{used[1]})")
    no_grad = sorted(n.replace(".", "/") for n, p in p_gpu.named_parameters() if p.grad is None)
    return {"launches": d, "losses": losses, "text": text, "params": p_gpu, "grads": card_grads,
            "no_grad": no_grad}


def phase_train(device, stamp: str) -> dict:
    """Training at production widths on the card (``data/trainset.py``,
    random weights from seed 0, float32 h2 stream for the comparison);
    returns the kernel launches of the main run, the timed
    ``VQATrainer.train``."""
    import tempfile

    from dfol_vqa_tpu_torch.ontology import GQAOntology
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

    for route, batches in routes.items():
        batches = batches[:TRAIN_COMPARE_STEPS]
        relating = sum(spec_needs_relations(lb.spec) for lb in batches)
        want = [relating, relating, 0, 0] if route == "per_question" else [0, 0, relating, relating]
        rec = card_vs_cpu_steps(cfg, ont, params_cpu, batches, device, f"{route} route", want)
        log(f"[7] {route} route, {len(batches)} steps card vs CPU plain path: {rec['text']}; "
            f"launches (fwd, bwd, pair_mlp, contract) {rec['launches']} for {relating} relating "
            "steps")

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
        pq, shared = train_ld.relating, val_ld.relating
        want = {"relation_oracle_fwd": pq, "relation_oracle_bwd": pq,
                "pair_mlp_fwd": shared, "shared_contract_fwd": shared}
        if launches != want or val_ld.passes != passes or train_ld.passes != cfg.epoch_num:
            raise AssertionError(
                f"train(): launches {launches}, not {want} ({train_ld.relating} per-question "
                f"relating steps in {train_ld.passes} epochs, {val_ld.relating} shared-route "
                f"relating validation batches in {val_ld.passes} passes, {passes} expected; "
                f"eval_chunk={cfg.tpu.eval_chunk})")
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
        f"relating validation batch (eval_chunk={cfg.tpu.eval_chunk}); epoch "
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


def lp_error(got, want) -> tuple:
    """(largest |exp(got) - exp(want)|, largest |got - want| / max(1,
    |want|), and the (got, want) pair of the latter) of two log-probability
    arrays (a dict for ``scene``)."""
    if isinstance(want, dict):
        errs = [lp_error(got[k], want[k]) for k in want]
        return max(e[0] for e in errs), *max((e[1:] for e in errs), key=lambda e: e[0])
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    at = np.unravel_index(np.argmax(rel), rel.shape)
    return (float(np.max(np.abs(np.exp(got) - np.exp(want)))), float(rel[at]),
            (float(got[at]), float(want[at])))


# a probability that the reference computes as 1 - y, y rounded to float32
# just below 1 (``logic.log_not``'s 1 - exp(x)), is a multiple of 2^-24 and
# moves by 2^-24 when y moves by one ULP: at p ~ 6e-7 one such step is 0.1 in
# log space
SATURATED_ULPS = TIE_ULPS


def saturated_lp_check(got, want, atol) -> tuple:
    """Per entry of two log-probability arrays: within ``atol`` x max(1,
    |want|) in log space, or, where float32 rounding rules log space (a
    probability near 2^-24 resolves to few steps of 2^-24), within
    ``SATURATED_ULPS`` x 2^-24 in probability. Returns (the entries that
    agree, (how many agree only by the probability branch, their largest
    gap in steps of 2^-24), ``lp_error``)."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    in_log = np.abs(g - w) <= atol * np.maximum(1.0, np.abs(w))
    gap = np.abs(np.exp(g) - np.exp(w)) / 2.0 ** -24
    by_ulp = ~in_log & (gap <= SATURATED_ULPS)
    largest = float(gap[by_ulp].max()) if by_ulp.any() else 0.0
    err = lp_error(np.where(by_ulp, w, g), w)  # the log-space reading of the rest
    return in_log | by_ulp, (int(by_ulp.sum()), largest), err


def forward_lp(interp, params, lb, device):
    """``log_probability`` of one batch as numpy (a dict for ``scene``)."""
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch

    _, o, m, arrays = to_device_batch(lb, device)
    with torch.inference_mode():
        lp = interp.forward(params, o, m, arrays, lb.spec)["log_probability"]
    if isinstance(lp, dict):
        return {k: v.cpu().numpy() for k, v in lp.items()}
    return lp.cpu().numpy()


def terminal_eval_batches(cfg, ont) -> dict:
    """{terminal: [its one LoadedBatch]}: 80 questions per terminal of
    ``evalset.TERMINAL_HOPS`` on 8 images of their own, phase 8's set."""
    from dfol_vqa_tpu_torch.data import evalset

    world = evalset.demo_world(ont)
    mix = tuple((t, h, evalset.PRODUCTION_BATCH) for t, h in evalset.TERMINAL_HOPS)
    datasets = evalset.eval_datasets(world, mix, evalset.PRODUCTION_BATCH,
                                     evalset.PRODUCTION_IMAGES_PER_BATCH, seed=TERMINALS_SEED)
    return {t: list(evalset.eval_loader(cfg, ont, world, [qs]))
            for (t, _), qs in zip(evalset.TERMINAL_HOPS, datasets)}


def phase_terminals_eval(device, stamp: str, cfg=None, params_cpu=None,
                         modes=("soft", "hard"), tag: str = "8") -> dict:
    """Offline evaluation of every question terminal at production dims on
    the card through ``VQATrainer``: one batch of 80 questions per terminal
    of ``evalset.TERMINAL_HOPS`` on 8 images of its own (O=100, the float32
    h2 stream; by default ``evalset.demo_eval_config`` and random weights
    from seed 0, or ``cfg`` and ``params_cpu``), in each of ``modes``. Against the same
    trainer on the CPU: probabilities exp(log_probability) within
    ``EVAL_P_ATOL``, ``predict``'s answers and ``test_epoch``'s error vector equal
    up to the near-tie rule (``near_ties``); the pair-MLP and
    shared-contract kernels launch once per relating batch in each
    ``test_epoch`` and ``predict``. Returns the launches of the timed
    ``test_epoch`` runs."""
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.data import evalset
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter, spec_needs_relations
    from dfol_vqa_tpu_torch.ops import pair_mlp as pm
    from dfol_vqa_tpu_torch.ops import shared_contract as sc
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    t0 = time.perf_counter()
    ont = GQAOntology()
    cfg = cfg or evalset.demo_eval_config(stream_dtype="float32")
    batches = terminal_eval_batches(cfg, ont)
    log(f"[{tag}] eval set: {len(batches)} terminals x 1 batch of {evalset.PRODUCTION_BATCH} "
        f"(terminal, U_pad, relating): "
        f"{[(t, b[0].objects.shape[0], spec_needs_relations(b[0].spec)) for t, b in batches.items()]}"
        f", built in {time.perf_counter() - t0!r} s")
    if params_cpu is None:
        params_cpu = Interpreter(cfg, ont).init_params(torch.Generator().manual_seed(0))
    params = copy.deepcopy(params_cpu).to(device)
    launches = {"pair_mlp_fwd": 0, "shared_contract_fwd": 0}
    rates, errs, n_ties, n_flipped, cpu_s = {}, {}, 0, 0, 0.0
    for mode in modes:
        c = dataclasses.replace(cfg, hard_mode=mode == "hard")
        gpu = VQATrainer(c, Interpreter(c, ont), device=device)
        cpu = VQATrainer(c, Interpreter(c, ont), device="cpu")
        for term, lbs in batches.items():
            (lb,) = lbs
            relating = int(spec_needs_relations(lb.spec))
            if relating and lb.objects.shape[0] * 2 > len(lb.arrays["img_index"]):
                raise AssertionError(f"a relating {term} batch would take the per-question route")
            gpu.test_epoch(lbs, params)  # warm-up of this spec
            torch.cuda.synchronize()
            pm.LAUNCHES = sc.LAUNCHES = 0
            t0 = time.perf_counter()
            error = gpu.test_epoch(lbs, params)
            rates[(term, mode)] = len(lb.compiled.question_ids) / (time.perf_counter() - t0)
            got = {"pair_mlp_fwd": pm.LAUNCHES, "shared_contract_fwd": sc.LAUNCHES}
            pm.LAUNCHES = sc.LAUNCHES = 0
            preds = gpu.predict(lbs, params, io.StringIO())
            if set(got.values()) != {relating} or (pm.LAUNCHES, sc.LAUNCHES) != (relating,) * 2:
                raise AssertionError(f"{term} {mode}: test_epoch launched {got}, predict "
                                     f"({pm.LAUNCHES}, {sc.LAUNCHES}) for {relating} relating "
                                     "batches")
            for k, v in got.items():
                launches[k] += v
            t0 = time.perf_counter()
            error_cpu = cpu.test_epoch(lbs, params_cpu)
            preds_cpu = cpu.predict(lbs, params_cpu, io.StringIO())
            ties = float_ties(cpu.interp, lbs, params_cpu)
            lp_cpu = forward_lp(cpu.interp, params_cpu, lb, "cpu")
            cpu_s += time.perf_counter() - t0
            errs[(term, mode)] = lp_error(forward_lp(gpu.interp, params, lb, device), lp_cpu)
            n_flipped += same_up_to_ties(preds, preds_cpu, ties)
            check_error_up_to_ties(error, gpu.last_test_counts, error_cpu,
                                   cpu.last_test_counts, ties)
            n_ties += len(ties)
    log(f"[{tag}] log_probability card vs CPU per terminal, {' / '.join(modes)}: largest "
        "|exp(card) - exp(CPU)|, largest |card - CPU| / max(1, |CPU|) at (card, CPU): "
        + "; ".join(f"{t} " + " / ".join(repr(errs[(t, m)]) for m in modes) for t in batches))
    worst = max(errs, key=lambda k: errs[k][0])
    if errs[worst][0] > EVAL_P_ATOL:
        raise AssertionError(f"{worst}: probability card vs CPU {errs[worst]!r} > "
                             f"{EVAL_P_ATOL}")
    log(f"[{tag}] eval of {len(batches)} terminals x {modes} on the card vs the CPU plain path "
        f"(CPU {cpu_s!r} s): exp(log_probability) within {EVAL_P_ATOL} (worst "
        f"{errs[worst][0]!r}, {worst}); predict and test_epoch equal except {n_flipped} of the "
        f"{n_ties} answers that a float32 near-tie decides (within {TIE_ULPS} ULPs; reported, "
        f"not gated); launches {launches}: pair_mlp and shared_contract once per relating batch "
        f"({stamp})")
    log(f"[{tag}] test_epoch questions/s per terminal on the card, one loaded batch of "
        f"{evalset.PRODUCTION_BATCH} (loader outside), {' / '.join(modes)}: " + "; ".join(
            f"{t} " + " / ".join(repr(rates[(t, m)]) for m in modes) for t in batches))
    return launches


def phase_terminals_train(device, stamp: str) -> dict:
    """One training step, card vs CPU plain path (``card_vs_cpu_steps``),
    at production dims and batch 80 for: ``choose_rel`` and ``compare`` on
    the per-question route (shuffled over the world's images, U * 2 > B;
    choose_rel relates: kernels 1 and 2; compare pins its objects with
    filters and launches nothing); the three supervision terminals
    (``trainset.supervision_loader``, O=100, no relation cache: plain
    autograd through ``rel_scores_for_pairs``); and with ``trainable_gate``
    a deduplicated ``exist`` batch on the shared route (kernels 3 and 4,
    plain backwards), whose eval forward must first agree with the CPU's
    within ``EVAL_P_ATOL``.
    Returns the launches of the card's steps."""
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter, spec_needs_relations

    ont = GQAOntology()
    cfg = trainset.demo_train_config(stream_dtype="float32")
    world = evalset.demo_world(ont)
    hops = dict(evalset.TERMINAL_HOPS)
    params_cpu = Interpreter(cfg, ont).init_params(torch.Generator().manual_seed(0))
    cases = []
    for term in ("choose_rel", "compare"):
        files = trainset.train_datasets(world, ((term, hops[term], trainset.PRODUCTION_BATCH),),
                                        seed=TERMINALS_SEED)
        (lb,) = list(trainset.train_loader(cfg, ont, world, files, seed=TERMINALS_SEED))
        r = int(spec_needs_relations(lb.spec))
        if r and lb.objects.shape[0] * 2 <= len(lb.arrays["img_index"]):
            raise AssertionError(f"the {term} batch would take the shared route")
        cases.append((term, "per-question route", cfg, params_cpu, lb, [r, r, 0, 0]))
    for term in trainset.SUPERVISION_TERMINALS:
        (lb,) = list(trainset.supervision_loader(cfg, ont, term, trainset.PRODUCTION_BATCH,
                                                 seed=TERMINALS_SEED))
        cases.append((term, "no relation cache", cfg, params_cpu, lb, [0, 0, 0, 0]))
    gated = dataclasses.replace(cfg, trainable_gate=True)
    params_gated = Interpreter(gated, ont).init_params(torch.Generator().manual_seed(0))
    files = evalset.eval_datasets(world, (("exist", hops["exist"], trainset.PRODUCTION_BATCH),),
                                  trainset.PRODUCTION_BATCH, evalset.PRODUCTION_IMAGES_PER_BATCH,
                                  seed=TERMINALS_SEED)
    (lb,) = list(trainset.train_loader(gated, ont, world, files, shuffle=False))
    if lb.objects.shape[0] * 2 > len(lb.arrays["img_index"]) or not spec_needs_relations(lb.spec):
        raise AssertionError("the trainable_gate batch would not relate on the shared route")
    before = launch_counts()
    lp = forward_lp(Interpreter(gated, ont), copy.deepcopy(params_gated).to(device), lb, device)
    d = [a - b for a, b in zip(launch_counts(), before)]
    err = lp_error(lp, forward_lp(Interpreter(gated, ont), params_gated, lb, "cpu"))
    if not (err[0] <= EVAL_P_ATOL and d == [0, 0, 1, 1]):
        raise AssertionError(f"trainable_gate eval batch: probability card vs CPU {err!r}, "
                             f"launches {d}")
    log(f"[8] trainable_gate eval batch (exist, shared route): exp(log_probability) card vs "
        f"CPU within {err[0]!r} (log space {err[1]!r} x max(1, |CPU's|)), launches (fwd, bwd, "
        f"pair_mlp, contract) {d}")
    cases.append(("exist, trainable_gate", "shared route", gated, params_gated, lb, [0, 0, 1, 1]))
    total = [0, 0, 0, 0]
    for term, route, c, p, lb, want in cases:
        t0 = time.perf_counter()
        rec = card_vs_cpu_steps(c, ont, p, [lb], device, f"{term} ({route})", want)
        total = [a + b for a, b in zip(total, rec["launches"])]
        log(f"[8] {term} ({route}), one step of batch {len(lb.compiled.question_ids)} card vs CPU "
            f"plain path in {time.perf_counter() - t0!r} s: {rec['text']}; launches (fwd, bwd, "
            f"pair_mlp, contract) {rec['launches']}")
    names = ("relation_oracle_fwd", "relation_oracle_bwd", "pair_mlp_fwd", "shared_contract_fwd")
    return dict(zip(names, total))

# phase 9: the last curriculum stage (calibrator on a frozen oracle), loaded
# as a user loads it, and the JAX package's own trainable-interpreter case
CALIBRATOR_CONFIG = os.path.join(ROOT, "configs", "curriculum_training",
                                 "cur7_classifier-direct-ll.yaml")
TRAINABLE = {"oracle_output_dim": 4, "operator_layers_config": [8]}


def calibrator_config(objects: int = 100):
    """``cur7`` through the port's ``Config.from_yaml`` at its own widths
    (2048-d boxes, oracle 512, GloVe 300, state 50, batch 80), at
    ``objects`` slots, with ``dropout=0.0`` (as every training script of the
    repository sets it; with dropout on, both packages send training to the
    plain tail) and the float32 h2 stream (card and CPU compared)."""
    from dfol_vqa_tpu_torch.config import Config

    cfg = Config.from_yaml(CALIBRATOR_CONFIG)
    cfg.dropout, cfg.verbose = 0.0, False
    cfg.tpu.max_object_num = objects
    cfg.tpu.rel_stream_dtype = "float32"
    cfg.tpu.train_chunk = 1
    return cfg


def model_params(cfg, ont):
    """Random weights from seed 0 (on the CPU), with the heads that start
    as identities drawn at random, normal x 0.4 from seed 1: the
    calibrator's output weights and the operator modules' final layers. At
    init these make the calibrator and the extra channels vanish, and a
    comparison there would test nothing."""
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter

    params = Interpreter(cfg, ont).init_params(torch.Generator().manual_seed(0))
    heads = [] if params.calibrator is None else [params.calibrator.out.w]
    if params.op_modules is not None:
        heads += [t for m in params.op_modules.values() for t in (m.layers[-1].w, m.layers[-1].b)]
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for h in heads:
            h.copy_(torch.randn(h.shape, generator=g) * 0.4)
    return params


def phase_calibrator_serve(world, device, stamp: str, answers: dict = None) -> int:
    """Phase 4's 64 requests through a ``ServingEngine`` with the calibrator
    configuration at O=24 on the card, answers equal to the same engine on
    the CPU, kernel 1 once per relating group (``phase_serve``); the
    calibrator must run for ``exist`` and ``verify_rel`` and not for
    ``query_attr`` (an open question at eval). Returns kernel 1's launches."""
    from dfol_vqa_tpu_torch.models import calibrator as cal
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.serve import ServingEngine

    ont = GQAOntology()
    cfg = calibrator_config(objects=24)
    params = model_params(cfg, ont)
    runs: dict = {}
    real = cal.compute_modulations

    def counted(calib, interp, w, arrays, spec):
        runs[spec.terminal_op] = runs.get(spec.terminal_op, 0) + 1
        return real(calib, interp, w, arrays, spec)

    engines = [ServingEngine(cfg, ont, params, features=world, device=d, max_batch=32,
                             transfer_dtype="bfloat16") for d in (device, "cpu")]
    cal.compute_modulations = counted
    try:
        launches = phase_serve(engines[0], engines[1], world, stamp, tag="9", answers=answers)
    finally:
        cal.compute_modulations = real
        for eng in engines:
            eng.stop()
    if not (runs.get("exist", 0) > 0 and runs.get("verify_rel", 0) > 0
            and runs.get("query_attr", 0) == 0):
        raise AssertionError(f"calibrator runs by terminal {runs}: want exist and verify_rel, "
                             "not query_attr")
    log(f"[9] served with the calibrator: calibrator runs by terminal {runs} (none for "
        "query_attr, an open question at eval)")
    return launches


def bare_step_ms(trainer, params, batches) -> float:
    """ms per ``train_step`` over ``batches`` (host clock, ending in a
    synchronize), after one warm pass."""
    from dfol_vqa_tpu_torch.train.optim import Optimizer

    opt = Optimizer(trainer.cfg, params)
    for lb in batches:
        trainer.train_step(params, opt, lb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lb in batches:
        trainer.train_step(params, opt, lb)
    torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0) / len(batches)


def phase_calibrator_train(device, stamp: str) -> list:
    """The calibrator configuration (batch 80, O=100) trained on phase 7's
    sets, ``TRAIN_COMPARE_STEPS`` steps per route on the card and the CPU
    (``card_vs_cpu_steps``: kernel 1 per per-question relating step, 3 and
    4 per shared one, and no kernel 2: the frozen pair tail is out of
    autograd; the shared route's second step within
    ``CALIB_SATURATED_STEP_RTOL``); the first step gives every calibrator leaf a
    nonzero gradient, only the calibrator trains, and the frozen oracle
    gets no gradient and does not move by a bit. Then the bare ms/step of
    the shuffled set on the card against phase 7's F = 1 configuration on
    the same batches, timed in turns. Returns the steps' launches
    (``launch_counts`` order)."""
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter, spec_needs_relations
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    ont = GQAOntology()
    cfg = calibrator_config()
    world = evalset.demo_world(ont)
    routes = {
        "per_question": list(trainset.train_loader(
            cfg, ont, world, trainset.train_datasets(world, trainset.PRODUCTION_MIX))),
        "shared": list(trainset.train_loader(
            cfg, ont, world, evalset.eval_datasets(world, trainset.PRODUCTION_MIX,
                                                   trainset.PRODUCTION_BATCH,
                                                   evalset.PRODUCTION_IMAGES_PER_BATCH),
            shuffle=False))}
    params_cpu = model_params(cfg, ont)
    start = flat_params(params_cpu)
    calib_keys = {k for k in start if k.startswith("calibrator/")}
    if trainable_keys(cfg, params_cpu) != calib_keys:
        raise AssertionError("the last curriculum stage must train the calibrator only")
    total = [0, 0, 0, 0]
    for route, batches in routes.items():
        batches = batches[:TRAIN_COMPARE_STEPS]
        relating = sum(spec_needs_relations(lb.spec) for lb in batches)
        for lb in batches:
            U, B = lb.objects.shape[0], len(lb.arrays["img_index"])
            if spec_needs_relations(lb.spec) and (U * 2 <= B) != (route == "shared"):
                raise AssertionError(f"a relating batch with U={U}, B={B} is off the {route} route")
        want = [relating, 0, 0, 0] if route == "per_question" else [0, 0, relating, relating]
        t0 = time.perf_counter()
        limits = None
        if route == "shared":
            if batches[1].spec.terminal_op != "exist":
                raise AssertionError("CALIB_SATURATED_STEP_RTOL was read on an exist batch")
            limits = {1: CALIB_SATURATED_STEP_RTOL}
        rec = card_vs_cpu_steps(cfg, ont, params_cpu, batches, device,
                                f"calibrator, {route} route", want, limits)
        zero = sorted(k for k in calib_keys if not np.any(rec["grads"][0][k]))
        after = flat_params(rec["params"])
        moved = sorted(k for k in start if k not in calib_keys
                       and not np.array_equal(after[k], start[k]))
        with_grad = sorted(set(start) - calib_keys - set(rec["no_grad"]))
        if zero or moved or with_grad:
            raise AssertionError(f"calibrator {route}: zero gradients {zero}, frozen leaves "
                                 f"moved {moved}, frozen leaves with a gradient {with_grad}")
        total = [a + b for a, b in zip(total, rec["launches"])]
        log(f"[9] calibrator, {route} route, {len(batches)} steps of batch "
            f"{cfg.train_batch_size} card vs CPU plain "
            f"path in {time.perf_counter() - t0!r} s: {rec['text']}; every one of the "
            f"{len(calib_keys)} calibrator leaves has a nonzero gradient, the "
            f"{len(start) - len(calib_keys)} frozen oracle leaves have no gradient and are "
            f"bitwise unchanged; launches "
            f"(fwd, bwd, pair_mlp, contract) {rec['launches']} for {relating} relating steps")

    cfg1 = trainset.demo_train_config()  # phase 7's F = 1 configuration
    p_cal = copy.deepcopy(params_cpu).to(device)
    p_one = copy.deepcopy(params_cpu)
    p_one.calibrator = None
    p_one = p_one.to(device)
    runs = {"F=1": (VQATrainer(cfg1, Interpreter(cfg1, ont), device=device), p_one),
            "calibrator": (VQATrainer(cfg, Interpreter(cfg, ont), device=device), p_cal)}
    ms = {name: [] for name in runs}
    for name in ("F=1", "calibrator", "calibrator", "F=1"):
        ms[name].append(bare_step_ms(*runs[name], routes["per_question"]))
    log(f"[9] bare train_step on the card, the shuffled set's {len(routes['per_question'])} "
        f"batches of {cfg.train_batch_size} (loader outside), ms/step in turns: F=1 (phase 7's configuration) "
        f"{ms['F=1']!r}, calibrator (cur7: oracle frozen) {ms['calibrator']!r} ({stamp})")
    return total


def phase_trainable(device, stamp: str) -> list:
    """The trainable interpreter (``TRAINABLE``: F = 4, operator modules
    [8]) at ``Config()`` widths, batch 80, O=100: one eval batch on the
    shared route (phase 8's ``exist`` set) and one training step on the
    per-question route (a shuffled ``exist`` batch), card against the CPU
    plain path: probabilities within ``EVAL_P_ATOL`` and answer flags equal
    up to the near-tie rule, the step under phase 7's gates. F > 1 runs the
    plain tails, as the JAX package does: kernels 1-4 must launch zero
    times. Returns the launches (all 0)."""
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter, spec_needs_relations

    ont = GQAOntology()
    cfg = dataclasses.replace(trainset.demo_train_config(), **TRAINABLE)
    world = evalset.demo_world(ont)
    params_cpu = model_params(cfg, ont)
    hops = dict(evalset.TERMINAL_HOPS)["exist"]
    files = evalset.eval_datasets(world, (("exist", hops, evalset.PRODUCTION_BATCH),),
                                  evalset.PRODUCTION_BATCH, evalset.PRODUCTION_IMAGES_PER_BATCH,
                                  seed=TERMINALS_SEED)
    (lb,) = list(evalset.eval_loader(cfg, ont, world, files))
    if lb.objects.shape[0] * 2 > len(lb.arrays["img_index"]):
        raise AssertionError("the F = 4 eval batch would not take the shared route")
    interp = Interpreter(cfg, ont)
    out = {}
    before = launch_counts()
    for dev, p in ((device, copy.deepcopy(params_cpu).to(device)), ("cpu", params_cpu)):
        _, o, m, arrays = to_device_batch(lb, dev)
        with torch.inference_mode():
            res = interp.forward(p, o, m, arrays, lb.spec)
        out[str(dev)] = {k: res[k].cpu().numpy() for k in ("log_probability", "answer_flags")}
    d = [a - b for a, b in zip(launch_counts(), before)]
    card, cpu = out[str(device)], out["cpu"]
    err = lp_error(card["log_probability"], cpu["log_probability"])
    tie = near_ties("exist", cpu["log_probability"], lb.arrays["opt_mask"]).any(axis=1)
    differ = (card["answer_flags"] != cpu["answer_flags"]).reshape(len(tie), -1).any(axis=1)
    if err[0] > EVAL_P_ATOL or (differ & ~tie).any() or d != [0, 0, 0, 0]:
        raise AssertionError(f"F=4 eval batch: probability card vs CPU {err!r}, flags differ "
                             f"outside a near-tie on {int((differ & ~tie).sum())} rows, "
                             f"launches {d}")
    log(f"[9] F=4 eval batch (exist, shared route, plain tails): exp(log_probability) card vs "
        f"CPU within {err[0]!r} (log space {err[1]!r} x max(1, |CPU's|)); answer flags equal "
        f"({int(differ.sum())} inside a near-tie); launches (fwd, bwd, pair_mlp, contract) {d}")
    files = trainset.train_datasets(world, (("exist", hops, trainset.PRODUCTION_BATCH),),
                                    seed=TERMINALS_SEED)
    (lb,) = list(trainset.train_loader(cfg, ont, world, files, seed=TERMINALS_SEED))
    if lb.objects.shape[0] * 2 <= len(lb.arrays["img_index"]) or not spec_needs_relations(lb.spec):
        raise AssertionError("the F = 4 training batch would not relate on the per-question route")
    t0 = time.perf_counter()
    rec = card_vs_cpu_steps(cfg, ont, params_cpu, [lb], device, "F=4 (per-question route)",
                            [0, 0, 0, 0])
    log(f"[9] F=4 step (exist, per-question route, plain tails), batch {cfg.train_batch_size} "
        f"card vs CPU in "
        f"{time.perf_counter() - t0!r} s: {rec['text']}; launches (fwd, bwd, pair_mlp, "
        f"contract) {rec['launches']} ({stamp})")
    return [a + b for a, b in zip(d, rec["launches"])]


def phase_calibrator_profile(device, stamp: str) -> None:
    """One profiled eval pass of the calibrator configuration over phase 9's
    14 terminal batches (loaded, loader outside): device busy and idle share
    and the device events per batch; and the host's enqueue ms per batch
    (``forward`` returning, before a synchronize) with the calibrator and,
    on the same batches, with ``modulator_switch=False``."""
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    ont = GQAOntology()
    cfg = calibrator_config()
    batches = [lbs[0] for lbs in terminal_eval_batches(cfg, ont).values()]
    params = model_params(cfg, ont).to(device)
    trainer = VQATrainer(cfg, Interpreter(cfg, ont), device=device)
    trainer.test_epoch(batches, params)  # warm-up
    wall, busy, by_name = None, None, {}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.test_epoch(batches, params)
        torch.cuda.synchronize()
        wall = 1000 * (time.perf_counter() - t0)
    busy, by_name = device_time(prof)
    events = sum(n for _, n in by_name.values())
    share = ("not measured (the profiler saw no device event)" if busy is None else
             f"device busy {busy!r} ms, idle share {1 - busy / wall!r}")
    enqueue = {}
    for switch in (True, False, False, True):
        times = []
        for lb in batches:
            _, o, m, arrays = to_device_batch(lb, device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                trainer.interp.forward(params, o, m, arrays, lb.spec, modulator_switch=switch)
            times.append(1000 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
        enqueue.setdefault(switch, []).append(statistics.mean(times))
    log(f"[9] profiled calibrator eval pass over {len(batches)} terminal batches of "
        f"{cfg.test_batch_size} (loader outside): wall {wall!r} ms, {share}, {events} device events = "
        f"{events / len(batches)!r} per batch ({stamp})")
    log(f"[9]   host enqueue ms per batch (forward returning), in turns: calibrator on "
        f"{enqueue[True]!r}, modulator_switch=False {enqueue[False]!r} ({stamp})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log("[9]   device ms by event (count): " + "; ".join(
        f"{name[:60]} {ms!r} ({n})" for name, (ms, n) in top))


def phase_calibrator(world, device, stamp: str, answers: dict = None) -> dict:
    """Phase 9: the calibrator and the trainable interpreter on the card
    (``answers["9"]``: the CPU engine's answers to the served burst).
    Returns the kernels' launches over its main runs (the served burst, the
    eval, the training steps, F = 4)."""
    t0 = time.perf_counter()
    n = check_calibrator_golden(device, GOLDEN_ATOL, GOLDEN_GRAD_RTOL)
    log(f"[9] JAX calibrator golden: {n} batches (calibrator model: every terminal and a shuffled "
        f"batch; F=4: six), eval and training-mode log_probability within {GOLDEN_ATOL} (or, "
        f"where float32 saturates, {SATURATED_ULPS} x 2^-24 in probability), answer "
        f"flags and matches equal up to near-ties, one step each (calibrator: per-question and "
        f"shared; F=4: per-question) within {GOLDEN_GRAD_RTOL} relative and the Adam bound")
    serve = phase_calibrator_serve(world, device, stamp, answers)
    cfg = calibrator_config()
    from dfol_vqa_tpu_torch.ontology import GQAOntology

    ev = phase_terminals_eval(device, stamp, cfg, model_params(cfg, GQAOntology()), ("soft",),
                              tag="9")
    steps = phase_calibrator_train(device, stamp)
    f4 = phase_trainable(device, stamp)
    phase_calibrator_profile(device, stamp)
    log(f"[9] phase 9 took {time.perf_counter() - t0!r} s, CPU references included")
    runs = [[serve, 0, 0, 0], [0, 0, ev["pair_mlp_fwd"], ev["shared_contract_fwd"]], steps, f4]
    names = ("relation_oracle_fwd", "relation_oracle_bwd", "pair_mlp_fwd", "shared_contract_fwd")
    return dict(zip(names, (sum(r[i] for r in runs) for i in range(4))))


# phase 10: the curriculum chain through the experiment runner, at the
# stage files' own widths and batch sizes on the production planted world
CURRICULUM_SCALE = 0.25  # 125 Train-All, 80 Train-Balanced, 24 val, 32 test questions a file
CURRICULUM_STAGE0_BATCH = 1000  # stage 0's Train-All files hold one full batch each
CURRICULUM_WRITERS = 8  # processes that write the program files
CURRICULUM_EPOCH_SCALE = 0.01  # every stage at the JAX script's floor of 2 epochs
CURRICULUM_COMPARE_STEPS = 2  # stage 0's first steps (batch 1000) held against the CPU's


def bulk_features(source):
    """A feature source's scenes made once, in bulk: the planted world
    draws an image's features anew on every read, where a GQA feature file
    is read as stored."""
    from dfol_vqa_tpu_torch.data.features import FeatureSource

    class BulkFeatures(FeatureSource):
        def __init__(self):
            self.box_dim = source.box_dim
            self._rows = {im: source.image(im) for im in source.image_ids}

        def image(self, image_id: str):
            return self._rows[image_id]

    return BulkFeatures()


def stage_steps_check(ont, cfg, params_cpu, loader, device) -> str:
    """Stage 0's first ``CURRICULUM_COMPARE_STEPS`` training steps at batch
    1000, card vs CPU under phase 7's gates (``card_vs_cpu_steps``), with
    the float32 h2 stream as phase 7 compares (the bf16 stream, the stage
    files' default, rounds h2 on the card only: on an NVIDIA H100 80GB
    HBM3 at 700 W the relation network's first-layer gradient then read
    3.1e-3 of its largest)."""
    from dfol_vqa_tpu_torch.models.interpreter import spec_needs_relations

    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, rel_stream_dtype="float32"))

    batches = list(loader)[:CURRICULUM_COMPARE_STEPS]
    relating = 0
    for lb in batches:
        U, B = lb.objects.shape[0], len(lb.arrays["img_index"])
        if (B != CURRICULUM_STAGE0_BATCH or lb.batch_size != B
                or (spec_needs_relations(lb.spec) and U * 2 > B)):
            raise AssertionError(f"stage 0 batch of B={B} rows, {lb.batch_size} real questions, "
                                 f"U={U}: not {CURRICULUM_STAGE0_BATCH} real questions on the "
                                 "shared route")
        relating += spec_needs_relations(lb.spec)
    rec = card_vs_cpu_steps(cfg, ont, params_cpu, batches, device, "stage 0 at batch 1000",
                            [0, 0, relating, relating])
    shapes = [(lb.spec.terminal_op, lb.objects.shape[0], len(lb.arrays["img_index"]),
               lb.batch_size) for lb in batches]
    return (f"stage 0's first {len(batches)} steps (terminal, U_pad, B, real questions) "
            f"{shapes}, {relating} relating, card vs CPU plain path: {rec['text']}")


def phase_curriculum(device, stamp: str) -> dict:
    """Phase 10: the eight curriculum stages
    (``configs/curriculum_training/cur{0..7}_classifier-direct-ll.yaml``)
    through ``experiments/curriculum.run_stage`` and
    ``GQAObjectBoxExperiment.run`` on the card, at the stage files' own
    widths (2048-d boxes, oracle 512, relation hidden 256, E=300, R=8, O=100,
    calibrator state 50) and batch sizes (1000/100 for stages 0, 1, 2, 4, 6;
    80/80 for 3, 5, 7), dropout 0, on the production planted world
    (``evalset.demo_world``, its scenes' features made once in bulk), cut
    in depth only (``CURRICULUM_SCALE``, ``CURRICULUM_EPOCH_SCALE``), but
    stage 0's two Train-All files, which hold ``CURRICULUM_STAGE0_BATCH``
    questions each (later stages read them too): every batch of stage 0 is
    1000 real questions, where the other files fill 12.5% (Train-All), 100%
    (Train-Balanced), 24-32% (val, test at 100) or 30-40% (val, test at 80)
    of a batch.
    Gates: stage 0's first steps at batch 1000 against the CPU
    (``stage_steps_check``); each stage i > 0 loads every
    leaf of stage i-1's ``best/`` bitwise (stage 6 partially: its calibrator
    fresh); in stages 6 and 7 every frozen leaf is bitwise unchanged and
    every calibrator leaf moved; finite losses and the stage's files; every
    relating batch on its route (``RouteCounter``: per-question in the
    batch-80 stages' training, shared in the rest) and the kernels launched
    once per relating batch of it. The program files are JSON lines
    (``h5py``, which the h5 codec needs, is missing on the H100 host this
    was built on), written by ``CURRICULUM_WRITERS`` forked processes.
    Then the CLI's test-only mode with predictions (``gqa_experiment -t -l
    best -p``) over stage 7's test set on the card against the same CLI with
    ``-c``, both at the float32 h2 stream (phase 6's rule for a card vs
    CPU comparison): error vector and predictions equal up to the near-tie
    rule. The
    CLI cannot take the planted world: with no GQA feature files it scores
    ``SyntheticFeatures`` scenes, as the JAX CLI does. Returns the kernel
    launches of the chain and the card's CLI run."""
    import logging
    import tempfile

    import yaml

    from dfol_vqa_tpu_torch.config import Config
    from dfol_vqa_tpu_torch.data import evalset
    from dfol_vqa_tpu_torch.experiments import curriculum as cur
    from dfol_vqa_tpu_torch.experiments import gqa_experiment
    from dfol_vqa_tpu_torch.experiments.experiment import GQAObjectBoxExperiment
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.ops import pair_mlp as pm
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro
    from dfol_vqa_tpu_torch.ops import shared_contract as sc
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    logging.basicConfig(level=logging.WARNING)  # the stage files' verbose logs stay quiet
    t_phase = time.perf_counter()
    ont = GQAOntology()
    world = evalset.demo_world(ont)  # phase 7's training world
    seed = 0

    class CountedExperiment(cur.PlantedCurriculumExperiment):
        """Every loader wrapped in a ``RouteCounter``: training batches of 80
        on either route (a shuffled batch holds more than 40 of the 54
        training images, the per-question route, unless its family's
        questions gather on fewer), everything else on the shared route;
        ``counters`` lists them as ("train" | "eval", counter)."""

        def __init__(self, world):
            super().__init__(world)
            self.counters = []

        def build_loader(self, cfg, path, ontology, features, batch_size, shuffle,
                         keep_original=False):
            loader = super().build_loader(cfg, path, ontology, features, batch_size, shuffle,
                                          keep_original)
            if loader is None:
                return None
            route = "either" if shuffle and batch_size <= 80 else "shared"
            counter = RouteCounter(loader, route)
            self.counters.append(("train" if shuffle else "eval", counter))
            return counter

    loaded: dict = {}
    real_load_into = VQATrainer._load_into

    def spy(self, path, params):
        real_load_into(self, path, params)
        loaded[self.cfg.version] = flat_params(params)

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        st0 = cur.STAGES[0]
        full = {("all", fam, L): CURRICULUM_STAGE0_BATCH for fam in st0["fams"]
                for L in st0["lens"]}
        made = cur.prepare_datasets(world, ont, root, CURRICULUM_SCALE,
                                    f"scale={CURRICULUM_SCALE} world=demo", fmt="json",
                                    sizes=full, workers=CURRICULUM_WRITERS)
        features = bulk_features(world)
        log(f"[10] planted datasets (4 splits x 13 families x 3 lengths, scale "
            f"{CURRICULUM_SCALE}, stage 0's files {sorted(full)} at "
            f"{CURRICULUM_STAGE0_BATCH} questions, JSON-lines program files, "
            f"{CURRICULUM_WRITERS} writer processes) and the {len(world.image_ids)} scenes' "
            f"features written in {time.perf_counter() - t0!r} s")

        t0 = time.perf_counter()
        cfg0 = Config.from_yaml(cur.stage_config(st0, root, made, CURRICULUM_EPOCH_SCALE,
                                                 st0["lr"], {}))
        if cfg0.train_batch_size != CURRICULUM_STAGE0_BATCH:
            raise AssertionError(f"stage 0 trains at batch {cfg0.train_batch_size}")
        loader0 = cur.PlantedCurriculumExperiment(features).build_loader(
            cfg0, cfg0.train_path, ont, features, cfg0.train_batch_size, shuffle=True)
        params0 = Interpreter(cfg0, ont).init_params(torch.Generator().manual_seed(seed))
        log(f"[10] {stage_steps_check(ont, cfg0, params0, loader0, device)} "
            f"({time.perf_counter() - t0!r} s)")

        experiment = CountedExperiment(features)
        rows, total = [], [0, 0, 0, 0]
        VQATrainer._load_into = spy
        ro.LAUNCHES = ro.BWD_LAUNCHES = pm.LAUNCHES = sc.LAUNCHES = 0
        try:
            t_chain = time.perf_counter()
            for st in cur.STAGES:
                i = st["i"]
                experiment.counters = []
                before = launch_counts()
                row, res = cur.run_stage(experiment, st, root, made, CURRICULUM_EPOCH_SCALE,
                                         st["lr"], seed, device, {})
                d = [a - b for a, b in zip(launch_counts(), before)]
                total = [a + b for a, b in zip(total, d)]
                rows.append(row)
                cfg = Config.from_yaml(cur.stage_config(st, root, made, CURRICULUM_EPOCH_SCALE,
                                                        st["lr"], {}))
                check_stage(cfg, st, root, res, loaded, d, experiment.counters, row)
        finally:
            VQATrainer._load_into = real_load_into
        chain_s = time.perf_counter() - t_chain
        log(f"[10] the chain: {len(rows)} stages in {chain_s!r} s; test accuracy by stage "
            f"{[r['test_acc_overall'] for r in rows]} (reported, not gated); launches "
            f"(fwd, bwd, pair_mlp, contract) {total} ({stamp})")

        # the CLI over stage 7's test set: card, then -c on the CPU
        t0 = time.perf_counter()
        st7 = cur.STAGES[7]
        cfg7 = cur.stage_config(st7, root, made, CURRICULUM_EPOCH_SCALE, st7["lr"], {})
        cfg7["tpu"]["rel_stream_dtype"] = "float32"  # card and CPU compared, as in phase 6
        cfg_path = os.path.join(root, "cli_cur7.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg7, f)
        pred_path = os.path.join(os.path.relpath(cfg7["model_path"]), "predictions",
                                 cur.MODEL_NAME, cfg7["version"], "prediction_test_full.json")
        runs, cli_launches = {}, None
        for where, flags in (("card", []), ("cpu", ["-c"])):
            before = launch_counts()
            t1 = time.perf_counter()
            res = gqa_experiment.main([cfg_path, "-t", "-l", "best", "-p", "-s", "0"] + flags)
            seconds = time.perf_counter() - t1
            with open(pred_path) as f:
                runs[where] = (res, json.load(f), seconds)
            if where == "card":  # the end of phase 10's main path: read the counts
                cli_launches = [a - b for a, b in zip(launch_counts(), before)]
                total = [a + b for a, b in zip(total, cli_launches)]
                if launch_counts() != total:
                    raise AssertionError(f"launches {launch_counts()} != the stages' and the "
                                         f"CLI's {total}")
        (res_card, preds, card_s), (res_cpu, preds_cpu, cpu_s) = runs["card"], runs["cpu"]
        flipped = 0
        if preds != preds_cpu or not np.array_equal(res_card["test_error"],
                                                     res_cpu["test_error"]):
            cli_cfg = Config.from_yaml(cfg_path)
            exp = GQAObjectBoxExperiment()
            features = exp.build_features(cli_cfg, logging.getLogger("phase10"))
            test_ld = exp.build_loader(cli_cfg, cli_cfg.test_path, ont, features,
                                       cli_cfg.test_batch_size, shuffle=False)
            cpu_tr = VQATrainer(cli_cfg, Interpreter(cli_cfg, ont), device="cpu")
            params_cpu = cpu_tr.load(os.path.join(cfg7["model_path"], cur.MODEL_NAME,
                                                  cfg7["version"], "best"),
                                     Interpreter(cli_cfg, ont).init_params(
                                         torch.Generator().manual_seed(0)))
            ties = float_ties(cpu_tr.interp, test_ld, params_cpu)
            flipped = same_up_to_ties(preds, preds_cpu, ties)
            check_error_up_to_ties(res_card["test_error"], res_card["test_counts"],
                                   res_cpu["test_error"], res_cpu["test_counts"], ties)
        if len(preds) != int(res_card["test_counts"][0]) or not preds:
            raise AssertionError(f"{len(preds)} predictions for {res_card['test_counts'][0]} "
                                 "test questions")
        if cli_launches[2] <= 0 or cli_launches[2] != cli_launches[3] or any(cli_launches[:2]):
            raise AssertionError(f"the card's CLI test launched (fwd, bwd, pair_mlp, contract) "
                                 f"{cli_launches}: want kernels 3 and 4 per relating batch only")
        log(f"[10] CLI -t -l best -p over stage 7's test set ({len(preds)} questions, the "
            f"CLI's SyntheticFeatures scenes, f32 h2 stream): card {card_s!r} s, CPU (-c) "
            f"{cpu_s!r} s; predictions and test error equal up to the near-tie rule "
            f"({flipped} answers inside a CPU near-tie differ); over_all test error "
            f"{float(res_card['test_error'][0])!r}; launches {cli_launches} "
            f"({time.perf_counter() - t0!r} s, {stamp})")
    log(f"[10] phase 10 took {time.perf_counter() - t_phase!r} s, CPU references included")
    names = ("relation_oracle_fwd", "relation_oracle_bwd", "pair_mlp_fwd", "shared_contract_fwd")
    return dict(zip(names, total))


def check_stage(cfg, st, root, res, loaded, launches, counters, row) -> None:
    """Phase 10's gates on one finished stage (``phase_curriculum``) and its
    printed line."""
    from dfol_vqa_tpu_torch.experiments import curriculum as cur
    from dfol_vqa_tpu_torch.train.optim import trainable_labels

    i = st["i"]
    ver = os.path.join(root, "runs", cur.MODEL_NAME)
    best, last = os.path.join(ver, cfg.version, "best"), os.path.join(ver, cfg.version, "last")
    need = [os.path.join(best, f) for f in (f"{cur.MODEL_NAME}.npz", "losses.npy",
                                            "errors.npy")]
    need += [os.path.join(last, f"{cur.MODEL_NAME}.npz"), os.path.join(root, f"stage_{i}.json")]
    missing = [f for f in need if not os.path.exists(f)]
    if missing or not np.isfinite(res["train_loss"]).all():
        raise AssertionError(f"stage {i}: missing {missing} or losses {res['train_loss']}")
    final = flat_params(res["params"])
    moved = frozen = 0
    if i > 0:
        got = loaded.pop(cfg.version, None)
        if got is None:
            raise AssertionError(f"stage {i} loaded no checkpoint")
        with np.load(os.path.join(ver, f"curriculum_{i - 1}", "best",
                                  f"{cur.MODEL_NAME}.npz")) as prev:
            keys = [k for k in prev.files if not k.startswith("__")]
            for k in keys:
                if not np.array_equal(got[k], prev[k]):
                    raise AssertionError(f"stage {i}: {k} after the load differs from stage "
                                         f"{i - 1}'s best")
        fresh = sorted(set(got) - set(keys))
        if fresh != (sorted(k for k in got if k.startswith("calibrator/")) if i == 6 else []):
            raise AssertionError(f"stage {i}: leaves not in stage {i - 1}'s best: {fresh}")
        if cfg.activate_attention_transfer:
            on = {n.replace(".", "/") for n, t in trainable_labels(res["params"], cfg).items()
                  if t}
            for k in got:
                same = np.array_equal(final[k], got[k])
                if k not in on and not same:
                    raise AssertionError(f"stage {i}: frozen {k} changed")
                if k.startswith("calibrator/") and same:
                    raise AssertionError(f"stage {i}: calibrator leaf {k} never moved")
                frozen += k not in on
                moved += k.startswith("calibrator/")
    elif loaded.pop(cfg.version, None) is not None:
        raise AssertionError("stage 0 loaded a checkpoint")
    train = [c for kind, c in counters if kind == "train"]
    evals = [c for kind, c in counters if kind == "eval"]
    if len(train) != 1:
        raise AssertionError(f"stage {i}: {len(train)} training loaders")
    (train,) = train
    pq = train.by_route["per_question"]
    shared = sum(c.relating for c in evals) + train.by_route["shared"]
    # kernel 2 differentiates the pair tail; a stage that freezes what feeds it
    # (the calibrator stages) takes it out of autograd
    tail_trains = not (cfg.freeze_featurizer and cfg.freeze_relation_network
                       and cfg.freeze_embedding_network)
    want = [pq, pq if tail_trains else 0, shared, shared]
    if (launches != want or (st["split"] == "bal") != (train.by_route["per_question"] > 0)
            or shared <= 0):
        raise AssertionError(f"stage {i}: launches (fwd, bwd, pair_mlp, contract) {launches}, "
                             f"want {want} (training steps relating by route "
                             f"{train.by_route}; {shared} shared-route relating batches)")
    steps = train.batches
    extra = (f"; frozen leaves unchanged {frozen}, calibrator leaves moved {moved}"
             if cfg.activate_attention_transfer else "")
    log(f"[10] stage {i} ({', '.join(st['fams'][:2])}{'...' if len(st['fams']) > 2 else ''}; "
        f"lengths {list(st['lens'])}, {st['split']}, batch {cfg.train_batch_size}/"
        f"{cfg.test_batch_size}, {cfg.epoch_num} epochs): {row['seconds']!r} s, {steps} steps "
        f"= {steps / max(row['seconds'], 1e-9)!r} steps/s (validation and test included); "
        f"training: {train.relating} of {steps} steps relate, by route {train.by_route}; eval "
        f"batches "
        f"{sum(c.batches for c in evals)}, {sum(c.relating for c in evals)} relating (shared); "
        f"launches {launches}; epoch losses {np.asarray(res['train_loss'])[:, 0].tolist()}; "
        f"test accuracy {row['test_acc_overall']!r}{extra}")


DAEMON_CLIENTS = 8  # phase 11's HTTP client threads
DAEMON_PASSES = 3  # phase 11's passes of the 64 requests over HTTP
EXPORT_WORKERS = 6  # phase 11's export processes (export is host work, one core each)
# phase 11's weights: not the daemon's own random ones (seed 0), so its
# answers show that it loaded them from the checkpoint
DAEMON_WEIGHTS_SEED = 11


def trace_diff(got: dict, want: dict) -> float:
    """Raise unless two ``ServingEngine.trace`` entries have the same hops
    (branch, op, token) and answers; returns the largest difference of their
    attentions and probabilities (exp of the log-probabilities)."""
    hops = [[(h["branch"], h["op"], h["token"]) for h in e["hops"]] for e in (got, want)]
    if hops[0] != hops[1] or got["answers"] != want["answers"]:
        raise AssertionError(f"trace {got['question_id']}: hops or answers differ: "
                             f"{hops[0]} {got['answers']} vs {hops[1]} {want['answers']}")
    att = max((float(np.abs(np.subtract(a["attention"], b["attention"])).max())
               for a, b in zip(got["hops"], want["hops"])), default=0.0)
    p = float(np.abs(np.exp(got["log_probability"]) - np.exp(want["log_probability"])).max())
    return max(att, p)


def served_rate(eng, groups, what: str) -> dict:
    """``groups`` (one list of questions per canonical spec) served one
    ``answer_many`` after another, so each spec's requests ride one batch at
    the same rung in every run: requests/s and p50 latency."""
    t0 = time.perf_counter()
    results = [r for g in groups for r in eng.answer_many(g)]
    seconds = time.perf_counter() - t0
    return {"what": what, "requests_per_s": len(results) / seconds,
            "p50_ms": statistics.median(r.latency_ms for r in results),
            "answers": [r.answers for r in results]}


def http_json(base: str, path: str, payload=None, timeout: float = 300):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class Daemon:
    """``python -m dfol_vqa_tpu_torch.http_frontend`` in a subprocess, its
    output drained by a thread; ``base`` is its URL once it listens."""

    def __init__(self, args):
        import re
        import threading

        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dfol_vqa_tpu_torch.http_frontend", *args], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": ROOT})
        self.lines, self.base = [], None
        self._ready = threading.Event()

        def drain():
            for line in self.proc.stdout:
                self.lines.append(line.rstrip())
                m = re.search(r"listening on (http://[\d.]+:\d+)", line)
                if m:
                    self.base = m.group(1)
                    self._ready.set()
            self._ready.set()

        self._thread = threading.Thread(target=drain, daemon=True)
        self._thread.start()

    def wait_listening(self, timeout: float = 300) -> str:
        self._ready.wait(timeout)
        if self.base is None:
            raise AssertionError("the daemon did not start listening:\n" + "\n".join(self.lines))
        return self.base

    def stop(self) -> int:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=60)
        self._thread.join(timeout=60)
        return self.proc.returncode


def phase_daemon(device, stamp: str) -> dict:
    """Phase 11: the serving deployment at production widths (the demo
    engine: 2048-d boxes, oracle 512, E=300, H=256, R=8, O=24, bf16
    transfer, max_batch 32) on phase 4's 64 requests. Returns kernel 1's
    launches in the artifact engine's run.

    1. Trace: one question per relating spec, ``ServingEngine.trace`` on the
       card vs the CPU engine (hops and answers equal, attentions and
       probabilities within ``EVAL_P_ATOL``), and the JAX trace golden on
       the card (within ``GOLDEN_ATOL``).
    2. Artifact: ``export_serving_set`` on the card at every rung 1-32 with
       traces, loaded into a fresh engine with ``Interpreter.forward``
       forbidden; its answers equal the live card engine's and the CPU
       engine's, it makes no live step, and kernel 1 launches at least once
       per relating spec and at most once per relating request. A CPU
       artifact is refused by the card engine. Requests/s and p50 of the
       live and the artifact engine, in turns, each spec's requests as one
       batch (so every run meets the steps the first one read; reported).
    3. Daemon: the weights (from ``DAEMON_WEIGHTS_SEED``) saved as an npz
       checkpoint, the daemon started on its own random weights (seed 0)
       with ``--ckpt``, ``--artifact`` and ``--warmup`` (every module read
       before it listens); 64 requests
       from ``DAEMON_CLIENTS`` threads equal the CPU engine's, ``/healthz``
       names cuda and the card, ``/v1/trace`` equals step 1's traces,
       ``/stats`` shows steps from the artifact only; requests/s over HTTP
       (reported). The daemon must exit cleanly on SIGINT."""
    import tempfile

    from dfol_vqa_tpu_torch.export import export_serving_set, load_serving_set
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter, spec_needs_relations
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro
    from dfol_vqa_tpu_torch.serve import build_demo_engine, demo_config
    from dfol_vqa_tpu_torch.train import checkpoint

    t_phase = time.perf_counter()
    params = Interpreter(demo_config(), GQAOntology()).init_params(
        torch.Generator().manual_seed(DAEMON_WEIGHTS_SEED))
    demo = dict(max_batch=32, seed=0, params=params)
    _, _, world, eng = build_demo_engine(device=device, **demo)
    _, _, _, cpu_eng = build_demo_engine(device="cpu", **demo)
    tmp = tempfile.TemporaryDirectory()
    daemon = None
    try:
        groups = {}
        for q in serve_questions(world):
            groups.setdefault(eng._prepare(q)[0], []).append(q)
        groups = list(groups.values())
        qs = [q for g in groups for q in g]  # in spec order, as served_rate serves them
        specs = [eng._prepare(q)[0] for q in qs]
        relating = [spec_needs_relations(k) for k in specs]
        first = {}
        for q, k, r in zip(qs, specs, relating):
            if r:
                first.setdefault(k, q)
        # export and start the daemon first: it reads every module (--warmup)
        # while this process traces and checks and serves the artifact, and
        # idles while this process is timed
        art, ckpt = os.path.join(tmp.name, "art"), os.path.join(tmp.name, "ckpt")
        manifest = export_serving_set(eng, qs, art, include_traces=True,
                                      workers=EXPORT_WORKERS)
        checkpoint.save(ckpt, "best", eng.params)
        daemon = Daemon(["--port", "0", "--ckpt", ckpt, "--artifact", art, "--warmup"])
        # 1. trace
        traces = {q["question_id"]: eng.trace(q) for q in first.values()}
        worst = max(trace_diff(traces[q["question_id"]], cpu_eng.trace(q))
                    for q in first.values())
        if not worst <= EVAL_P_ATOL:
            raise AssertionError(f"card traces differ from the CPU's by {worst} > {EVAL_P_ATOL}")
        n = check_trace_golden(device, GOLDEN_ATOL)
        log(f"[11] trace: {len(first)} relating specs traced on the card vs the CPU, hops and "
            f"answers equal, attentions and probabilities within {worst!r} <= {EVAL_P_ATOL}; "
            f"JAX trace golden: {n} requests within {GOLDEN_ATOL} ({stamp})")

        # 2. artifact
        t0 = time.perf_counter()
        loaded = load_serving_set(art, engine=eng)
        load_s = time.perf_counter() - t0
        log(f"[11] artifact: {manifest['n_specs']} specs x rungs {manifest['batch_sizes']} + "
            f"traces = {len(manifest['executables'])} modules exported on the card by "
            f"{EXPORT_WORKERS} processes in {manifest['export_seconds']!r} s, "
            f"{manifest['artifact_mb']!r} MB; manifest checked in {load_s!r} s ({stamp})")
        _, _, _, cpu_art_eng = build_demo_engine(device="cpu", start=False, **demo)
        export_serving_set(cpu_art_eng, [next(iter(first.values()))],
                           os.path.join(tmp.name, "cpu_art"), batch_sizes=[1])
        cpu_art_eng.stop()
        try:
            load_serving_set(os.path.join(tmp.name, "cpu_art"), engine=eng)
        except ValueError as e:
            if "device_type" not in str(e):
                raise
            log(f"[11] a CPU artifact offered to the card engine is refused: {e}")
        else:
            raise AssertionError("the card engine accepted an artifact exported on the CPU")

        want_cpu = [r.answers for r in cpu_eng.answer_many(qs)]
        eng.warmup(qs)
        forward = Interpreter.forward

        def refuse(*_a, **_k):
            raise AssertionError("Interpreter.forward called by the artifact engine")

        Interpreter.forward = refuse
        try:
            _, _, _, art_eng = build_demo_engine(device=device, executables=loaded, **demo)
            try:
                ro.LAUNCHES = 0
                cold = served_rate(art_eng, groups, "artifact, first")
                launches = ro.LAUNCHES
                got = cold["answers"]
                daemon.wait_listening()
                rates = []
                for e, what in ((eng, "live"), (art_eng, "artifact"), (art_eng, "artifact"),
                                (eng, "live")):
                    Interpreter.forward = forward if e is eng else refuse
                    rates.append(served_rate(e, groups, what))
                stats = dict(art_eng.stats)
            finally:
                art_eng.stop()
        finally:
            Interpreter.forward = forward
        want_live = rates[0]["answers"]
        if got != want_live or got != want_cpu or any(r["answers"] != got for r in rates):
            bad = sum(a != b for a, b in zip(got, want_cpu))
            raise AssertionError(f"artifact answers differ: {bad}/{len(qs)} from the CPU engine's")
        if stats["compiled_steps"] != 0 or stats["aot_steps"] <= 0:
            raise AssertionError(f"the artifact engine made live steps: {stats}")
        keys = {k for k, r in zip(specs, relating) if r}
        check_launches(launches, keys, relating)
        log(f"[11] artifact engine (Interpreter.forward forbidden) served {len(qs)} requests, "
            f"a batch per spec, at {cold['requests_per_s']!r} requests/s (each module read at "
            f"its first use): answers == live card engine == CPU "
            f"engine, compiled_steps 0, aot_steps {stats['aot_steps']}, relation_oracle "
            f"launches {launches} for {sum(relating)} relating requests of {len(keys)} specs "
            f"({stamp})")
        log("[11] in turns, a batch per spec, requests/s and p50 ms: " + "; ".join(
            f"{r['what']} {r['requests_per_s']!r} / {r['p50_ms']!r}" for r in rates)
            + f" ({stamp})")

        # 3. daemon
        base = daemon.wait_listening()
        health = http_json(base, "/healthz")
        name = torch.cuda.get_device_name(0) if eng.device.type == "cuda" else "cpu"
        if health != {"ok": True, "device": eng.device.type, "device_name": name}:
            raise AssertionError(f"/healthz: {health}")
        passes = []  # (seconds, modules read in the pass): a module is read at first use
        for _ in range(DAEMON_PASSES):
            aot = http_json(base, "/stats")["aot_steps"]
            results = [None] * len(qs)

            def client(c):
                for i in range(c, len(qs), DAEMON_CLIENTS):
                    results[i] = http_json(base, "/v1/answer", {"question": qs[i]})["answers"]

            t0 = time.perf_counter()
            with ThreadPoolExecutor(DAEMON_CLIENTS) as pool:
                list(pool.map(client, range(DAEMON_CLIENTS)))
            passes.append((time.perf_counter() - t0,
                           http_json(base, "/stats")["aot_steps"] - aot))
            if results != want_cpu:
                bad = sum(a != b for a, b in zip(results, want_cpu))
                raise AssertionError(f"{bad}/{len(qs)} daemon answers differ from the CPU "
                                     "engine's")
        worst = max(trace_diff(http_json(base, "/v1/trace", {"question": q}),
                               traces[q["question_id"]]) for q in first.values())
        if not worst <= GOLDEN_ATOL:
            raise AssertionError(f"/v1/trace differs from the in-process trace by {worst}")
        dstats = http_json(base, "/stats")
        if dstats["compiled_steps"] != 0 or dstats["trace_steps"] != 0 \
                or dstats["aot_steps"] <= 0:
            raise AssertionError(f"the daemon made live steps: {dstats}")
        log(f"[11] daemon (--ckpt, --artifact; {' | '.join(daemon.lines[:3])}): healthz "
            f"{health}; {len(qs)} requests from {DAEMON_CLIENTS} client threads, "
            f"{DAEMON_PASSES} passes, requests/s over HTTP (modules read in the pass): "
            + ", ".join(f"{len(qs) / t!r} ({n})" for t, n in passes)
            + f"; answers == CPU engine; /v1/trace == "
            f"in-process traces (max diff {worst!r}); /stats aot_steps {dstats['aot_steps']}, "
            f"compiled_steps 0, trace_steps 0, batches {dstats['batches']}, p50 "
            f"{dstats['latency'].get('p50_ms')!r} ms ({stamp})")
        rc, daemon = daemon.stop(), None
        if rc != 0:
            raise AssertionError(f"the daemon exited with {rc}")
    finally:
        if daemon is not None:
            daemon.stop()
        eng.stop()
        cpu_eng.stop()
        tmp.cleanup()
    log(f"[11] phase 11 took {time.perf_counter() - t_phase!r} s, CPU references included")
    return {"relation_oracle_fwd": launches}


# ------------------------------------------------------------ phase 12: mesh

MESH_CHILD_TIMEOUT = 240  # seconds a phase-12 child may take (the tests give theirs 120)


def config_dict(cfg) -> dict:
    """A ``Config`` as the dict ``Config.from_yaml`` takes (JSON-safe)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def mesh_features(spec: dict):
    """The feature source a mesh job names: SyntheticFeatures or the
    planted world (``evalset.demo_world``)."""
    from dfol_vqa_tpu_torch.data import evalset
    from dfol_vqa_tpu_torch.data.features import SyntheticFeatures
    from dfol_vqa_tpu_torch.ontology import GQAOntology

    if spec["kind"] == "planted":
        return evalset.demo_world(GQAOntology(), tiny=spec.get("tiny", False))
    return SyntheticFeatures(box_dim=spec["box_dim"], min_objects=spec["min_objects"],
                             max_objects=spec["max_objects"])


def mesh_loader(cfg, ont, features, datasets, batch: int, num_shards=1, shard_index=0):
    """An unshuffled ``BatchLoader`` over ``datasets`` (question lists) at
    ``batch`` rows, on the given shard."""
    from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
    from dfol_vqa_tpu_torch.data.dataset import ProgramDataset
    from dfol_vqa_tpu_torch.data.loader import BatchLoader

    compiler = ProgramCompiler(ont, object_num=cfg.tpu.max_object_num,
                               rel_slots=cfg.tpu.rel_table_size)
    return BatchLoader([ProgramDataset(qs, ont) for qs in datasets], compiler, features, batch,
                       cfg.tpu.max_object_num, shuffle=False, prefetch=0,
                       num_shards=num_shards, shard_index=shard_index, keep_original=True)


def answer_rows(lb, rows) -> dict:
    """{question id: its row of ``rows`` (numpy, one per question)} of a
    batch's real questions."""
    rows = np.asarray(rows)
    return {qid: rows[qi].tolist() for qi, qid in enumerate(lb.compiled.question_ids)
            if lb.compiled.question_mask[qi] > 0}


def tie_rows(lb, lp) -> dict:
    """{question id: whether a float32 near-tie decides its answer}
    (``near_ties``) of a batch's real questions, from its log-probabilities."""
    lp = np.asarray(lp)
    return answer_rows(lb, near_ties(lb.spec.terminal_op, lp, lb.arrays["opt_mask"]).reshape(
        len(lp), -1).any(axis=1))


def check_mesh_flags(got: dict, want: dict, ties: dict, what: str) -> int:
    """The mesh's answer flags by question id against the reference's:
    the same questions, equal flags except where the reference's answer is
    a near-tie. Returns the count of tie-decided answers that differ."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: questions {sorted(set(got) ^ set(want))[:4]} on one "
                             "side only")
    differ = [q for q in want if got[q] != want[q]]
    if any(not ties[q] for q in differ):
        raise AssertionError(f"{what}: answer flags differ for {differ[:4]}")
    return len(differ)


def reference_update(cfg, before: dict, grads: dict, moments: dict, t0: int) -> dict:
    """The parameters after one step of the port's optimizer on the CPU from
    ``before`` with Adam's ``moments`` after ``t0`` steps, on ``grads``
    (flat numpy dicts by checkpoint key)."""
    from dfol_vqa_tpu_torch.convert import params_from_numpy
    from dfol_vqa_tpu_torch.train.optim import Optimizer

    params = params_from_numpy(before)
    opt = Optimizer(cfg, params)
    for name, p in params.named_parameters():
        key = name.replace(".", "/")
        p.grad = torch.from_numpy(np.array(grads[key], np.float32))
        if key in moments and opt.adam is not None:
            m, v = moments[key]
            opt.adam.state[p] = {"step": torch.tensor(float(t0)),
                                 "exp_avg": torch.from_numpy(np.array(m)),
                                 "exp_avg_sq": torch.from_numpy(np.array(v))}
    opt.step()
    return flat_params(params)


def check_mesh_step(cfg, rec: dict, want_loss: float, want_grads: dict, rtol: float,
                    what: str) -> dict:
    """A mesh step's record (``loss``, ``grads``, ``before``, ``after``,
    ``moments``, ``t0``: the whole tree, gathered) against the reference
    step on the union batch from the same parameters and Adam state: the
    loss within ``TRAIN_LOSS_RTOL``, every gradient leaf within ``rtol`` of
    its largest value, the parameters after it within ``adam_bound`` of the
    reference optimizer's on the reference gradients. Returns the worst
    gradient error and share of the Adam bound."""
    from dfol_vqa_tpu_torch.convert import params_from_numpy

    if not abs(rec["loss"] - want_loss) <= TRAIN_LOSS_RTOL * abs(want_loss):
        raise AssertionError(f"{what}: loss {rec['loss']!r}, reference {want_loss!r}")
    delta, worst = {}, 0.0
    for key, (err, mag) in leaf_errors(rec["grads"], want_grads).items():
        delta[key] = rtol * max(1.0, mag)
        if not err <= delta[key]:
            raise AssertionError(f"{what}: gradient {key} off by {err!r} > {rtol} x {mag!r}")
        worst = max(worst, err / max(mag, 1e-30))
    trainable = trainable_keys(cfg, params_from_numpy(rec["before"]))
    want = reference_update(cfg, rec["before"], want_grads, rec["moments"], rec["t0"])
    bound = adam_bound(cfg, trainable, [(want_grads, rec["grads"], rec["before"], delta)],
                       rec["moments"], rec["t0"])
    used = 0.0
    for key, b in bound.items():
        gap = np.abs(rec["after"][key].astype(np.float64) - want[key])
        if not (np.isfinite(rec["after"][key]).all() and np.all(gap <= b)):
            raise AssertionError(f"{what}: parameter {key} {float(gap.max())!r} from the "
                                 f"reference's, beyond the Adam bound")
        if np.any(b > 0):
            used = max(used, float(np.max(gap / np.where(b > 0, b, np.inf))))
    return {"grad_err": worst, "bound_share": used}


def train_job_config(job: dict, spec: dict):
    """The ``Config`` of a mesh job that trains (``job["train"]`` =
    ``spec``): one epoch at ``train_chunk=spec["chunk"]`` with a mid-epoch
    validation every ``spec["every"]`` steps."""
    from dfol_vqa_tpu_torch.config import Config

    cfg = Config.from_yaml(job["config"])
    cfg.epoch_num = 1
    cfg.tpu.train_chunk = spec["chunk"]
    cfg.checkpointing_frequency = spec["every"]
    return cfg


def mesh_train(job: dict, mesh, features, datasets) -> dict:
    """``VQATrainer.train`` under ``mesh`` (``train_job_config``) over this
    rank's shard of ``datasets``, validating on the job's eval files; rank 0
    writes the trained leaves to ``trained.npz``. Returns {"validation_steps":
    the global steps at which ``test_epoch`` ran}."""
    from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.parallel.mesh import batch_sharding
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    cfg = train_job_config(job, job["train"])
    ont = GQAOntology()
    shards, index, rows = batch_sharding(mesh, job["batch"])
    loader = mesh_loader(cfg, ont, features, datasets, rows, shards, index)
    with open(job["eval"]["datasets"]) as f:
        eval_sets = json.load(f)
    shards, index, rows = batch_sharding(mesh, job["eval"]["batch"])
    val = mesh_loader(cfg, ont, features, eval_sets, rows, shards, index)
    trainer = VQATrainer(cfg, Interpreter(cfg, ont), mesh=mesh)
    steps, real = [], trainer.test_epoch

    def test_epoch(loader, params):
        steps.append(trainer.global_step)
        return real(loader, params)

    trainer.test_epoch = test_epoch
    with np.load(job["weights"]) as w:
        params = params_from_numpy({k: w[k] for k in w.files}).to(mesh.device)
    trainer.train(loader, val, params)
    if mesh.rank == 0:
        np.savez(os.path.join(job["out"], "trained.npz"),
                 **{k: np.asarray(v) for k, v in flatten(params_to_numpy(params)).items()})
    return {"validation_steps": steps}


def mesh_worker(job_path: str) -> None:
    """One rank of a mesh job (``run_mesh_job``): join the mesh, train
    ``steps`` lockstep steps on this rank's shard through
    ``VQATrainer.train_step``, recording each step whole (rank 0: the
    parameters before and after it, the reduced gradients and Adam's
    moments, gathered from the shards) and every rank's answer flags by
    question id; with ``reference == "single"`` rank 0 also holds each step
    against the single-process step on the union batch on its own device
    (``check_mesh_step``). Then, as the job asks, ``test_epoch`` and
    ``predict`` under the mesh, and a checkpoint (rank 0 writes it). Writes
    ``rank<r>.json`` (and rank 0 ``records.npz``) to ``out``. Imports no
    JAX; builds no kernel (the parent built them)."""
    import torch.distributed as dist

    from dfol_vqa_tpu_torch.config import Config
    from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_params
    from dfol_vqa_tpu_torch.train.optim import build_optimizer
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    with open(job_path) as f:
        job = json.load(f)
    if job["device"].startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = Config.from_yaml(job["config"])
    mesh = make_mesh(job["mesh_shape"], job["mesh_axes"], device=job["device"],
                     fsdp=job["fsdp"], init_method=job["init"], rank=job["rank"],
                     world_size=job["world"], backend=job.get("backend"))
    ont = GQAOntology()
    features = mesh_features(job["features"])
    with open(job["datasets"]) as f:
        datasets = json.load(f)
    if job.get("train"):  # the trainer's own loop under the mesh, chunked
        result = dict(mesh_train(job, mesh, features, datasets), rank=mesh.rank)
        with open(os.path.join(job["out"], f"rank{mesh.rank}.json"), "w") as f:
            json.dump(result, f)
        dist.barrier()
        dist.destroy_process_group()
        return
    shards, index, rows = batch_sharding(mesh, job["batch"])
    loader = mesh_loader(cfg, ont, features, datasets, rows, shards, index)
    interp = Interpreter(cfg, ont)
    trainer = VQATrainer(cfg, interp, mesh=mesh)
    with np.load(job["weights"]) as w:
        start = {k: w[k] for k in w.files}
    params = params_from_numpy(start).to(mesh.device)
    state = shard_params(mesh, params)
    opt = build_optimizer(cfg, params, state)
    single = job.get("reference") == "single" and mesh.rank == 0
    if single:
        ref_trainer = VQATrainer(cfg, interp, device=mesh.device)
        union = iter(mesh_loader(cfg, ont, features, datasets, job["batch"]))

    def whole(pairs) -> dict:
        return {name.replace(".", "/"): state.whole(name, t).cpu().numpy().copy()
                for name, t in pairs}

    step_record: dict = {}
    real_step = opt.step

    def recorded_step():
        grads = whole((n, p.grad) for n, p in state.masters())
        moments, t0 = {}, 0
        adam = opt.adam.state if opt.adam is not None else {}
        for name, p in state.masters():
            if p in adam:
                moments[name.replace(".", "/")] = tuple(
                    state.whole(name, adam[p][k]).cpu().numpy().copy()
                    for k in ("exp_avg", "exp_avg_sq"))
                t0 = int(adam[p]["step"])
        step_record.update(grads=grads, moments=moments, t0=t0)
        real_step()

    opt.step = recorded_step
    records, flags, checks, losses = [], [], [], []
    launches = [0, 0, 0, 0]
    for t, ((lb, count),) in enumerate(trainer.mesh_groups(loader, 1)):
        if t >= job["steps"]:
            break
        before = flat_params_of(state)
        working = state.gather()
        step_flags = {}
        if lb is not None:
            _, o, m, arrays = to_device_batch(lb, mesh.device)
            with torch.no_grad():
                out = interp.forward(working, o, m, arrays, lb.spec)
            step_flags = answer_rows(lb, out["answer_flags"].cpu().numpy())
        step_flags = {q: f for part in mesh.gather_objects(step_flags) for q, f in part.items()}
        flags.append(step_flags)
        c0 = launch_counts() if mesh.device.type == "cuda" else [0, 0, 0, 0]
        loss = trainer.train_step(state, opt, lb, count=count)
        c1 = launch_counts() if mesh.device.type == "cuda" else [0, 0, 0, 0]
        launches = [a + b - c for a, b, c in zip(launches, c1, c0)]
        dist.all_reduce(loss, group=mesh.data_group)
        losses.append(float(loss))
        rec = dict(step_record, before=before, after=flat_params_of(state), loss=float(loss),
                   count=count)
        if mesh.rank == 0 and not single:
            records.append(rec)
        if single:
            ub = next(union)
            ref = params_from_numpy(before).to(mesh.device)
            want_loss = ref_trainer.compute_grads(ref, ub).item()
            with torch.no_grad():
                _, o, m, arrays = to_device_batch(ub, mesh.device)
                out = interp.forward(ref, o, m, arrays, ub.spec)
            what = f"{job['name']} step {t}"
            checks.append(check_mesh_step(cfg, rec, want_loss, grads_of(ref), job["rtol"], what))
            lp = out["log_probability"].cpu().numpy()
            checks[-1]["tie_flips"] = check_mesh_flags(
                step_flags, answer_rows(ub, out["answer_flags"].cpu().numpy()),
                tie_rows(ub, lp), what)
    result = {"rank": mesh.rank, "data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
              "flags": flags, "losses": losses, "launches": launches, "checks": checks,
              "placement": {k: [v.data_dim, v.model_dim] for k, v in state.placement.items()},
              "backend": str(dist.get_backend()), "world": dist.get_world_size()}
    if job.get("time") and lb is not None:
        # the mesh step against the single-process step on the same rows, in turns
        # (one rank: the union's); host clock around synchronized steps
        opt.step = real_step
        one = params_from_numpy(flat_params_of(state)).to(mesh.device)
        one_opt = build_optimizer(cfg, one)
        plain = VQATrainer(cfg, interp, device=mesh.device)
        times = {"mesh": [], "single": []}
        for name in ["mesh", "single", "single", "mesh"] * 3:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if name == "mesh":
                trainer.train_step(state, opt, lb, count=count)
            else:
                plain.train_step(one, one_opt, lb)
            torch.cuda.synchronize()
            times[name].append(1000 * (time.perf_counter() - t1))
        result["step_ms"] = {k: (statistics.median(v), min(v), max(v))
                             for k, v in times.items()}
    if job.get("eval"):
        ev = job["eval"]
        with open(ev["datasets"]) as f:
            eval_sets = json.load(f)
        shards, index, rows = batch_sharding(mesh, ev["batch"])
        eval_loader = mesh_loader(cfg, ont, features, eval_sets, rows, shards, index)
        out_dir = os.path.join(job["out"], f"files{mesh.rank}")
        os.makedirs(out_dir, exist_ok=True)
        hard = VQATrainer(cfg, interp, mesh=mesh, hardset_path=os.path.join(out_dir, "hardset"))
        error, _ = hard.test(eval_loader, state)
        result["test_error"] = error.tolist()
        result["test_counts"] = hard.last_test_counts.tolist()
        pred_path = os.path.join(out_dir, "predictions.json")
        if trainer.writes_files:
            with open(pred_path, "w") as f:
                result["predictions"] = trainer.predict(eval_loader, state, f)
        else:
            result["predictions"] = trainer.predict(eval_loader, state, None)
        trainer._save(os.path.join(job["out"], f"ckpt{mesh.rank}"), state, sync=True)
    if mesh.rank == 0 and records:
        flat = {}
        for t, rec in enumerate(records):
            for part in ("before", "after", "grads"):
                flat.update({f"{t}/{part}/{k}": v for k, v in rec[part].items()})
            flat.update({f"{t}/moments/{k}/{i}": mv[i] for k, mv in rec["moments"].items()
                         for i in (0, 1)})
            flat[f"{t}/t0"] = np.asarray(rec["t0"])
            flat[f"{t}/loss"] = np.asarray(rec["loss"])
            flat[f"{t}/count"] = np.asarray(rec["count"])
        np.savez(os.path.join(job["out"], "records.npz"), **flat)
    with open(os.path.join(job["out"], f"rank{mesh.rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def flat_params_of(state) -> dict:
    """A ``ShardedParams``' whole leaves as a flat numpy dict (a collective)."""
    return {name.replace(".", "/"): t.cpu().numpy().copy()
            for name, t in state.full_tensors().items()}


def read_records(path: str) -> list:
    """``records.npz`` -> the per-step records ``check_mesh_step`` takes."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    out = []
    for t in range(1 + max(int(k.split("/", 1)[0]) for k in data)):
        rec = {"before": {}, "after": {}, "grads": {}, "moments": {}}
        for k, v in data.items():
            step, part, *rest = k.split("/")
            if int(step) != t:
                continue
            if part in ("before", "after", "grads"):
                rec[part]["/".join(rest)] = v
            elif part == "moments":
                key = "/".join(rest[:-1])
                m = rec["moments"].setdefault(key, [None, None])
                m[int(rest[-1])] = v
            else:
                rec[part] = v.item()
        rec["moments"] = {k: tuple(v) for k, v in rec["moments"].items()}
        out.append(rec)
    return out


def run_mesh_job(job: dict, world: int, workdir: str, timeout: float) -> list:
    """Run ``job`` in ``world`` processes (``mesh_worker``, rendezvous
    through a file under ``workdir``; ``parallel/launch.run_processes``),
    each with ``timeout`` seconds; kill them all and raise when one fails or
    times out. Returns each rank's JSON result."""
    from dfol_vqa_tpu_torch.parallel.launch import run_processes

    os.makedirs(workdir, exist_ok=True)
    job = dict(job, world=world, out=workdir, init="file://" + os.path.join(workdir, "rdv"))
    commands = []
    for rank in range(world):
        path = os.path.join(workdir, f"job{rank}.json")
        with open(path, "w") as f:
            json.dump(dict(job, rank=rank), f)
        commands.append([sys.executable, "-c",
                         f"import chip_smoke; chip_smoke.mesh_worker({path!r})"])
    run_processes(commands, workdir, timeout, f"mesh job {job['name']}", cwd=ROOT,
                  env=dict(os.environ, PYTHONPATH=ROOT))
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


MESH_STEPS = 3  # lockstep steps per phase-12 layout: one shared-route, two per-question
MESH_KERNELS = ("relation_oracle_fwd", "relation_oracle_bwd", "pair_mlp_fwd", "shared_contract_fwd")
# (name, mesh_shape, mesh_axes, fsdp) of the two-rank layouts over gloo on one card
GLOO_LAYOUTS = (("gloo data", [2], ["data"], False), ("gloo data+fsdp", [2], ["data"], True),
                ("gloo model", [1, 2], ["data", "model"], False))


def mesh_phase_job(workdir: str) -> dict:
    """Phase 12's shared job: ``sample_config`` widths (``trainset.
    demo_train_config``, float32 h2 stream as phase 7's compare steps), O=100,
    global batch 80, random weights from seed 0; an ``exist`` file of 80
    questions on 8 images (its step takes the shared route: kernels 3, 4)
    and 160 ``verify_rel`` questions over all images (two per-question
    steps: kernels 1, 2), on the planted world."""
    from dfol_vqa_tpu_torch.convert import flatten, params_to_numpy
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology

    os.makedirs(workdir, exist_ok=True)
    ont = GQAOntology()
    cfg = trainset.demo_train_config(stream_dtype="float32")
    world = evalset.demo_world(ont)
    sets = (evalset.eval_datasets(world, (("exist", 2, 80),), 80, 8)
            + trainset.train_datasets(world, (("verify_rel", 1, 160),)))
    paths = {"datasets": os.path.join(workdir, "datasets.json"),
             "weights": os.path.join(workdir, "weights.npz")}
    with open(paths["datasets"], "w") as f:
        json.dump(sets, f)
    params = Interpreter(cfg, ont).init_params(torch.Generator().manual_seed(0))
    np.savez(paths["weights"], **flatten(params_to_numpy(params)))
    return dict(paths, config=config_dict(cfg), features={"kind": "planted"},
                batch=cfg.train_batch_size, steps=MESH_STEPS, device="cuda:0",
                reference="single", rtol=TRAIN_GRAD_RTOL)


def placement_counts(placement: dict) -> dict:
    """{(data dim, model dim): number of leaves} of a layout's placement."""
    out: dict = {}
    for v in placement.values():
        out[str(tuple(v))] = out.get(str(tuple(v)), 0) + 1
    return out


def mesh_layout_report(name: str, res: list) -> list:
    """Log one layout's run and check that every rank launched kernels 1-4
    in its steps (one shared-route step, two per-question ones); returns
    the launches summed over its ranks."""
    want = [MESH_STEPS - 1, MESH_STEPS - 1, 1, 1]
    for r in res:
        if r["launches"] != want:
            raise AssertionError(f"{name}: rank {r['rank']} launched (fwd, bwd, pair_mlp, "
                                 f"contract) {r['launches']} times in its steps, not {want}")
    checks = res[0]["checks"]
    log(f"[12] {name}: world {res[0]['world']} over {res[0]['backend']}, placement "
        f"(data dim, model dim): leaves {placement_counts(res[0]['placement'])}, steps "
        f"{len(res[0]['losses'])} (losses {res[0]['losses']}) held against the single-process "
        f"step on the union batch: worst gradient error by step "
        f"{[c['grad_err'] for c in checks]} (gate {TRAIN_GRAD_RTOL}), largest share of the "
        f"Adam bound {[c['bound_share'] for c in checks]}, tie-decided flips "
        f"{[c['tie_flips'] for c in checks]}; launches per rank {want}")
    return [sum(r["launches"][i] for r in res) for i in range(4)]


def phase_mesh(device, stamp: str) -> dict:
    """Phase 12 (a) and (b): the training mesh on the card; returns the
    kernels' launches in the mesh steps of every rank of every layout."""
    import tempfile

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="dfol_mesh_")
    base = mesh_phase_job(work)
    n = torch.cuda.device_count()
    model = [n // 2, 2] if n > 1 else [1, 1]
    nccl = [(f"nccl data x{n}", [n], ["data"], False, True),
            (f"nccl data+fsdp x{n}", [n], ["data"], True, False),
            (f"nccl data x model {model}", model, ["data", "model"], False, False)]
    jobs = [(name, shape, axes, fsdp, timed, n, None) for name, shape, axes, fsdp, timed in nccl]
    jobs += [(name, shape, axes, fsdp, False, 2, "gloo") for name, shape, axes, fsdp
             in GLOO_LAYOUTS]

    def run(job):
        name, shape, axes, fsdp, timed, world, backend = job
        spec = dict(base, name=name, mesh_shape=shape, mesh_axes=axes, fsdp=fsdp, time=timed)
        if backend:
            spec["backend"] = backend
        return run_mesh_job(spec, world, os.path.join(work, name.replace(" ", "_")),
                            MESH_CHILD_TIMEOUT)

    # the timed layout alone, then the others side by side
    results = {jobs[0][0]: run(jobs[0])}
    with ThreadPoolExecutor(len(jobs) - 1) as pool:
        results.update(zip([j[0] for j in jobs[1:]], pool.map(run, jobs[1:])))
    totals = [0, 0, 0, 0]
    for name, res in results.items():
        totals = [a + b for a, b in zip(totals, mesh_layout_report(name, res))]
    ms = results[jobs[0][0]][0]["step_ms"]
    log(f"[12] one-rank mesh step (NCCL, {n} process) {ms['mesh']!r} ms against the "
        f"single-process step {ms['single']!r} ms (median, min, max of 6 in turns) on the "
        f"same per-question batch of 80 ({stamp})")
    log(f"[12] layouts run: " + "; ".join(
        f"{name}: world {res[0]['world']}, {res[0]['backend']}" for name, res in results.items())
        + f"; phase 12 (a, b) took {time.perf_counter() - t0!r} s")
    return dict(zip(MESH_KERNELS, totals))


BF16_GOLDEN_MIX = (("exist", 2, 16), ("verify_rel", 1, 16), ("query_attr", 1, 16))
# two bfloat16 ULPs of a leaf's largest gradient (one is 2^-7 of it at
# most): a gradient that passes a bf16 cast's backward is rounded to bf16,
# and where the card's float32 sum and the CPU's straddle a rounding
# boundary the two differ by a bf16 step; the embedding head takes two such
# rounded parts (the attribute head's product and the relation rows). Phase
# 12's readings: 2^-16 at a leaf whose largest value is 4.24e-3 (3.7e-3 of
# it; per-question step) and 5.2e-3 (shared step), against phase 7's 3e-4
BF16_GRAD_RTOL = 2.0 ** -6


def bf16_config(stream_dtype: str = "bfloat16"):
    """The bf16 cells' configuration: ``evalset.demo_eval_config`` (sample
    widths, O=100, dropout 0 for training) at ``compute_dtype="bfloat16"``,
    with the shared route's plain tail the per-question einsum (XLA:CPU
    refuses the contract-then-gather product at bf16, so the golden's JAX
    side cannot take that tail; the card takes the kernel route anyway)."""
    from dfol_vqa_tpu_torch.data import trainset

    cfg = trainset.demo_train_config(stream_dtype=stream_dtype)
    cfg.tpu.compute_dtype = "bfloat16"
    cfg.tpu.rel_contract_then_gather = False
    return cfg


def bf16_golden_setup(ont):
    """(cfg, world, question files, the port's weights from seed 0 on the
    CPU) of the bf16 golden: three batches of 16 questions on 2 images
    each (the shared route) at production widths."""
    from dfol_vqa_tpu_torch.data import evalset
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter

    cfg = bf16_config()
    world = evalset.demo_world(ont)
    datasets = evalset.eval_datasets(world, BF16_GOLDEN_MIX, 16, 2, seed=7)
    params = Interpreter(cfg, ont).init_params(torch.Generator().manual_seed(0))
    return cfg, world, datasets, params


def objects_digest(objects: np.ndarray) -> str:
    """sha256 of an array's float32 bytes."""
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(objects, np.float32).tobytes()).hexdigest()


def check_bf16_golden(device, atol: float) -> tuple:
    """The port at ``compute_dtype="bfloat16"`` against the JAX golden
    ``torch_port_golden_bf16.npz`` on ``device``: the regenerated weights
    and batches (their digests) equal the golden's,
    log-probabilities within ``atol`` (``saturated_lp_check``), answer flags
    equal but for float32 near-ties. Returns (batches, tie flips)."""
    from dfol_vqa_tpu_torch.data import evalset
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology

    golden = np.load(BF16_GOLDEN)
    ont = GQAOntology()
    cfg, world, datasets, params = bf16_golden_setup(ont)
    if datasets != json.loads(str(golden["datasets"])):
        raise AssertionError("the bf16 golden's question files differ from the regenerated ones")
    for name, p in params.named_parameters():
        if objects_digest(p.detach().numpy()) != str(golden["param_sha256/"
                                                             + name.replace(".", "/")]):
            raise AssertionError(f"the regenerated weights' {name} differ from the golden's")
    params = params.to(device)
    interp = Interpreter(cfg, ont)
    n = flips = 0
    for k, lb in enumerate(evalset.eval_loader(cfg, ont, world, datasets)):
        p = f"batch/{k}/"
        if objects_digest(lb.objects) != str(golden[p + "objects_sha256"]):
            raise AssertionError(f"bf16 golden batch {k}: the objects differ")
        lp = forward_lp(interp, params, lb, device)
        ok, _, err = saturated_lp_check(lp, golden[p + "log_probability"], atol)
        if not (np.isfinite(lp).all() and ok.all()):
            raise AssertionError(f"bf16 golden batch {k}: log_probability off by {err!r}")
        want = answer_rows(lb, golden[p + "answer_flags"])
        _, o, m, arrays = to_device_batch(lb, device)
        with torch.inference_mode():
            got = answer_rows(lb, interp.forward(params, o, m, arrays, lb.spec)[
                "answer_flags"].cpu().numpy())
        flips += check_mesh_flags(got, want, tie_rows(lb, golden[p + "log_probability"]),
                                  f"bf16 golden batch {k}")
        n += 1
    if n != len(datasets):
        raise AssertionError(f"{n} bf16 golden batches, the golden has {len(datasets)}")
    return n, flips


class KernelRouteOnCpu:
    """Within it the CPU takes the card's per-question route: the relation-
    oracle pair tail through its plain version, bf16 products only for
    h_s / h_o, as on the card (``interpreter.per_question_kernel_route``
    ignores the device). The reference the card's per-question route is held
    against at ``compute_dtype="bfloat16"``, where the plain ``rel_cache``
    casts every product (JAX's CPU formulation, tests/test_torch_bf16.py)."""

    def __enter__(self):
        from dfol_vqa_tpu_torch.models import interpreter

        self._real = interpreter.per_question_kernel_route
        interpreter.per_question_kernel_route = (
            lambda cfg, device: cfg.tpu.use_pallas and cfg.oracle_output_dim == 1)
        return self

    def __exit__(self, *exc):
        from dfol_vqa_tpu_torch.models import interpreter

        interpreter.per_question_kernel_route = self._real


def bf16_gate_control(cfg, ont, params_cpu, lb, device) -> tuple:
    """The control of ``BF16_GRAD_RTOL``: the card's step at
    ``compute_dtype="float32"`` held against the CPU's bfloat16 step from the
    same weights on ``lb``. A step that skipped the bf16 casts must fail the
    gate, so the worst leaf's gradient error over its largest value has to
    exceed it. Returns (that leaf, the ratio). Its launches count on no
    path."""
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    cfg32 = copy.deepcopy(cfg)
    cfg32.tpu.compute_dtype = "float32"
    p_gpu, p_cpu = copy.deepcopy(params_cpu).to(device), copy.deepcopy(params_cpu)
    VQATrainer(cfg32, Interpreter(cfg32, ont), device=device).compute_grads(p_gpu, lb)
    VQATrainer(cfg, Interpreter(cfg, ont), device="cpu").compute_grads(p_cpu, lb)
    ratios = {k: err / max(mag, 1e-30)
              for k, (err, mag) in leaf_errors(grads_of(p_gpu), grads_of(p_cpu)).items()}
    key = max(ratios, key=ratios.get)
    if not ratios[key] > BF16_GRAD_RTOL:
        raise AssertionError(f"the float32 step passes the bf16 gradient gate {BF16_GRAD_RTOL}: "
                             f"worst {key} {ratios[key]!r}")
    return key, ratios[key]


def phase_bf16(device, stamp: str) -> dict:
    """Phase 12 (c): ``compute_dtype="bfloat16"`` on the card. The demo
    burst (phase 4's 64 requests, kernel 1 fed by bf16 h_s / h_o products)
    and one eval batch per route (sample widths, O=100, 80 questions: kernel
    1 per-question, kernel 4 shared with the plain bf16 trunk, kernel 3
    never) against the CPU port (the per-question route in the card's
    formulation, ``KernelRouteOnCpu``): answers equal, probabilities within
    ``EVAL_P_ATOL``; the seventh JAX golden; one training step per route
    (kernels 1 and 2; kernel 4) against the CPU under phase 7's gates but
    for the gradients' limit, ``BF16_GRAD_RTOL``, whose control
    (``bf16_gate_control``) must fail it.
    Returns the launches of the burst, the eval batches and the steps."""
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.ops import pair_mlp as pm
    from dfol_vqa_tpu_torch.serve import build_demo_engine

    t0 = time.perf_counter()
    launches = dict.fromkeys(MESH_KERNELS, 0)
    with KernelRouteOnCpu():
        _, _, world, eng = build_demo_engine(device=device, max_batch=32, seed=0)
        _, _, _, cpu_eng = build_demo_engine(device="cpu", max_batch=32, seed=0)
        try:
            for e in (eng, cpu_eng):  # before any request: the engines' shared config
                e.cfg.tpu.compute_dtype = "bfloat16"
            pm.LAUNCHES = 0
            launches["relation_oracle_fwd"] += phase_serve(eng, cpu_eng, world, stamp, tag="12")
            if pm.LAUNCHES:
                raise AssertionError("the pair-MLP kernel launched in serving")
        finally:
            eng.stop()
            cpu_eng.stop()
        n, flips = check_bf16_golden(device, GOLDEN_ATOL)
        log(f"[12] JAX bf16 golden (production widths, {n} shared-route batches of 16): "
            f"log_probability within {GOLDEN_ATOL}, answer flags equal ({flips} near-tie flips)")
        ont = GQAOntology()
        cfg = bf16_config()
        world = evalset.demo_world(ont)
        routes = {
            "per_question": list(trainset.train_loader(cfg, ont, world, trainset.train_datasets(
                world, (("verify_rel", 1, 80),), seed=12)))[:1],
            "shared": list(trainset.train_loader(cfg, ont, world, evalset.eval_datasets(
                world, (("exist", 2, 80),), 80, 8, seed=12), shuffle=False))[:1]}
        params_cpu = Interpreter(cfg, ont).init_params(torch.Generator().manual_seed(0))
        params = copy.deepcopy(params_cpu).to(device)
        interp = Interpreter(cfg, ont)
        want_eval = {"per_question": [1, 0, 0, 0], "shared": [0, 0, 0, 1]}
        for route, batches in routes.items():
            (lb,) = batches
            before = launch_counts()
            lp = forward_lp(interp, params, lb, device)
            got = [a - b for a, b in zip(launch_counts(), before)]
            if got != want_eval[route]:
                raise AssertionError(f"bf16 {route} eval batch launched {got}, not "
                                     f"{want_eval[route]}")
            launches = {k: launches[k] + g for k, g in zip(MESH_KERNELS, got)}
            lp_cpu = forward_lp(interp, params_cpu, lb, "cpu")
            err = lp_error(lp, lp_cpu)
            if err[0] > EVAL_P_ATOL:
                raise AssertionError(f"bf16 {route} eval: probability card vs CPU {err!r}")
            _, o, m, arrays = to_device_batch(lb, device)
            with torch.inference_mode():
                flags = interp.forward(params, o, m, arrays, lb.spec)["answer_flags"].cpu().numpy()
            _, o, m, arrays = to_device_batch(lb, "cpu")
            with torch.inference_mode():
                flags_cpu = interp.forward(params_cpu, o, m, arrays, lb.spec)["answer_flags"].numpy()
            flips = check_mesh_flags(answer_rows(lb, flags), answer_rows(lb, flags_cpu),
                                     tie_rows(lb, lp_cpu), f"bf16 {route} eval")
            log(f"[12] bf16 eval, {route} route ({lb.spec.terminal_op}, U_pad "
                f"{lb.objects.shape[0]}, B {len(lb.arrays['img_index'])}): card vs CPU "
                f"{err!r}, answers equal ({flips} near-tie flips), launches {got} ({stamp})")
            want_steps = [1, 1, 0, 0] if route == "per_question" else [0, 0, 0, 1]
            res = card_vs_cpu_steps(cfg, ont, params_cpu, batches, device, f"bf16 {route}",
                                    want_steps, limits={0: BF16_GRAD_RTOL})
            launches = {k: launches[k] + g for k, g in zip(MESH_KERNELS, res["launches"])}
            log(f"[12] bf16 training step, {route} route: {res['text']}; launches "
                f"{res['launches']} ({stamp})")
            key, ratio = bf16_gate_control(cfg, ont, params_cpu, lb, device)
            log(f"[12] bf16 gate control, {route} route: the card's float32 step against the "
                f"CPU's bf16 step, worst {key} {ratio!r} of its largest gradient > "
                f"{BF16_GRAD_RTOL} ({stamp})")
    log(f"[12] phase 12 (c) took {time.perf_counter() - t0!r} s")
    return launches


# ------------------------------------------------------ phase 13: chunked dispatch

CHUNK = 8  # phase 13's tpu.train_chunk / eval_chunk (Config's default)
CHUNK_BATCHES = 11  # (a), (b): a chunk of 8, then a tail of 3
CHUNK_EPOCHS = 3  # passes over them: warm-up and capture, then replays
CHUNK_DROPOUT = 0.1  # (e): sample_config.yaml's dropout


def record_validation(trainer) -> list:
    """Wrap ``trainer.test_epoch`` to record (global step, error vector) at
    each call; returns the list it fills."""
    seen, real = [], trainer.test_epoch

    def test_epoch(loader, params):
        err = real(loader, params)
        seen.append((trainer.global_step, np.asarray(err, np.float32)))
        return err

    trainer.test_epoch = test_epoch
    return seen


def params_gap(got: dict, want: dict, lr: float, steps: int) -> float:
    """The train loop tests' rule for two runs of ``steps`` Adam steps: every
    element within 2 lr a step (a sign flip of a near-zero gradient), and
    99% of each leaf within 1e-3 lr a step; raises otherwise. Returns the
    largest gap in units of lr."""
    if set(got) != set(want):
        raise AssertionError(f"leaves differ: {sorted(set(got) ^ set(want))[:4]}")
    worst = 0.0
    for k, v in want.items():
        diff = np.abs(got[k].astype(np.float64) - v)
        if diff.max() > 2 * lr * steps or np.mean(diff <= 1e-3 * lr * steps) <= 0.99:
            raise AssertionError(f"{k}: {diff.max()!r} from the reference after {steps} steps "
                                 f"(lr {lr})")
        worst = max(worst, float(diff.max()) / lr)
    return worst


def chunk_golden_setup(ont):
    """(cfg, world, files, train loader, validation loader) of the chunk
    golden: tiny widths, dropout 0, lr 1e-3, weight decay 0 (a leaf without
    a gradient keeps its value, so the stored change compresses),
    ``train_chunk=eval_chunk=8``
    with ``pad_chunks``, ``checkpointing_frequency=3``, one epoch of 11
    shuffled ``exist`` batches of 16, the tiny mix on the shared route for
    validation. Numpy only, so the card rebuilds the same batches."""
    from dfol_vqa_tpu_torch.data import evalset, trainset

    cfg = trainset.demo_train_config(tiny=True)
    cfg.epoch_num = 1
    cfg.checkpointing_frequency = 3
    cfg.learning_rate = 1e-3
    cfg.weight_decay = 0.0
    cfg.tpu.train_chunk = cfg.tpu.eval_chunk = CHUNK
    cfg.tpu.pad_chunks = True
    world = evalset.demo_world(ont, tiny=True)
    files = {"train": trainset.train_datasets(
                 world, (("exist", 2, CHUNK_BATCHES * trainset.TINY_BATCH),), seed=11),
             "validation": evalset.eval_datasets(world, trainset.TINY_MIX, trainset.TINY_BATCH,
                                                 evalset.TINY_IMAGES_PER_BATCH, seed=4)}
    train_ld = trainset.train_loader(cfg, ont, world, files["train"], seed=1)
    val_ld = trainset.train_loader(cfg, ont, world, files["validation"], shuffle=False)
    return cfg, world, files, train_ld, val_ld


def check_chunk_golden(device) -> dict:
    """``VQATrainer.train`` at the chunk golden's schedule on ``device``
    (``chunk_golden_setup``) against JAX's: the global steps of validation
    equal, each validation's error vector equal, the epoch loss within
    1e-4 relative, the trained parameters within ``params_gap``'s rule.
    Returns {"steps", "gap_lr", "graphs"}."""
    from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    golden = np.load(CHUNK_GOLDEN)
    ont = GQAOntology()
    cfg, _, files, train_ld, val_ld = chunk_golden_setup(ont)
    for name, f in files.items():
        if json.dumps(f, sort_keys=True) != str(golden[f"datasets/{name}"]):
            raise AssertionError(f"the chunk golden's {name} files differ from the setup's")
    start = {k[len("params/"):]: golden[k] for k in golden.files if k.startswith("params/")}
    params = params_from_numpy(start).to(device)
    trainer = VQATrainer(cfg, Interpreter(cfg, ont), device=device)
    seen = record_validation(trainer)
    _, _, losses = trainer.train(train_ld, val_ld, params)
    steps = [s for s, _ in seen]
    if steps != golden["validation_steps"].tolist():
        raise AssertionError(f"validation at steps {steps}, JAX's at "
                             f"{golden['validation_steps'].tolist()}")
    errors = np.stack([e for _, e in seen])
    if not np.array_equal(errors, golden["validation_errors"]):
        raise AssertionError(f"validation errors {errors[:, 0]} != JAX's "
                             f"{golden['validation_errors'][:, 0]}")
    if not np.allclose(losses, golden["losses"], rtol=1e-4, atol=0):
        raise AssertionError(f"epoch loss {losses} != JAX's {golden['losses']}")
    want = {k: v + golden["update/" + k] for k, v in start.items()}
    gap = params_gap(flatten(params_to_numpy(params)), want, cfg.learning_rate, CHUNK_BATCHES)
    return {"steps": steps, "gap_lr": gap, "graphs": trainer.train_graph_stats}


def copy_train_state(dst_params, dst_opt, src_params, src_opt) -> None:
    """``src``'s parameters and Adam state into ``dst``'s tensors, in place."""
    with torch.no_grad():
        for a, b in zip(dst_opt._state_tensors(), src_opt._state_tensors()):
            a.copy_(b)
        for a, b in zip(dst_params.parameters(), src_params.parameters()):
            a.copy_(b)


def train_state(params, opt) -> list:
    return [t.detach().clone() for t in list(params.parameters()) + opt._state_tensors()]


def update_errors(got: list, want: list, start: list) -> tuple:
    """(worst |got - want| over each leaf's largest |want - start|, leaves
    bitwise equal): the update gate of ``TRAIN_GRAD_RTOL``."""
    worst, same = 0.0, 0
    for g, w, s in zip(got, want, start):
        err = float((g.double() - w.double()).abs().max())
        scale = float((w.double() - s.double()).abs().max())
        same += bool(torch.equal(g, w))
        if err > TRAIN_GRAD_RTOL * scale and err > 0:
            raise AssertionError(f"a leaf of shape {tuple(g.shape)} after a chunk is {err!r} "
                                 f"from the eager path's, over {TRAIN_GRAD_RTOL} x its largest "
                                 f"change {scale!r}")
        worst = max(worst, err / scale if scale > 0 else 0.0)
    return worst, same


def timed_loop(run) -> tuple:
    """(host ms until ``run()`` returns, ms until the card is done)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    enqueue = 1000 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return enqueue, 1000 * (time.perf_counter() - t0)


def profiled_idle(run) -> str:
    """``run()`` under ``torch.profiler``: the device's idle share, or
    "not measured" when the profiler saw no device event."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = 1000 * (time.perf_counter() - t0)
    busy, _ = device_time(prof)
    return ("not measured (the profiler saw no device event)" if busy is None else
            repr(1 - busy / wall))


def in_turns(runs: dict, rounds: int = 2) -> dict:
    """{name: [(enqueue ms, wall ms), ...]} of each zero-argument run, in
    turns (a, b, b, a, ...), after one untimed run of each."""
    for run in runs.values():
        run()
    out = {name: [] for name in runs}
    order = (list(runs) + list(runs)[::-1]) * rounds
    for name in order:
        out[name].append(timed_loop(runs[name]))
    return out


def chunk_train_route(route: str, cfg, ont, world, params_cpu, device, stamp: str) -> dict:
    """Phase 13 (a) / (b) on one relation route: returns the main run's
    launches (the graphed side's chunks, replays included)."""
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.data.transfer import chunk_prefetch
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter, spec_needs_relations
    from dfol_vqa_tpu_torch.train.graphs import GraphCache
    from dfol_vqa_tpu_torch.train.optim import Optimizer
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    n_q = CHUNK_BATCHES * trainset.PRODUCTION_BATCH
    if route == "per_question":
        sets = trainset.train_datasets(world, (("exist", 2, n_q),), seed=13)
        loader = trainset.train_loader(cfg, ont, world, sets, seed=13)
    else:
        sets = evalset.eval_datasets(world, (("exist", 2, n_q),), trainset.PRODUCTION_BATCH,
                                     evalset.PRODUCTION_IMAGES_PER_BATCH, seed=13)
        loader = trainset.train_loader(cfg, ont, world, sets, shuffle=False)
    batches = list(loader)
    for lb in batches:
        U, B = lb.objects.shape[0], len(lb.arrays["img_index"])
        if not spec_needs_relations(lb.spec) or (U * 2 <= B) != (route == "shared"):
            raise AssertionError(f"a {lb.spec.terminal_op} batch with U={U}, B={B} is off "
                                 f"the {route} route")
    groups = list(chunk_prefetch(batches, CHUNK, device))
    if [len(g[0]) for g in groups] != [CHUNK, CHUNK_BATCHES - CHUNK]:
        raise AssertionError(f"{route}: groups {[len(g[0]) for g in groups]}")
    graphed = VQATrainer(cfg, Interpreter(cfg, ont), device=device)
    eager = VQATrainer(cfg, Interpreter(cfg, ont), device=device)
    eager.graphs = GraphCache(device, capture=False)
    params, p_eager = copy.deepcopy(params_cpu).to(device), copy.deepcopy(params_cpu).to(device)
    opt, o_eager = Optimizer(cfg, params), Optimizer(cfg, p_eager)
    opt.static_grads()
    o_eager.static_grads()

    def eager_steps(group, objects, obj_mask, arrays):
        for i, lb in enumerate(group):
            eager._grads(p_eager, objects[i], obj_mask[i], {k: v[i] for k, v in arrays.items()},
                         lb.spec)
            o_eager.step()

    # the main run: CHUNK_EPOCHS passes of chunks through the graphs, each
    # chunk held against the eager per-step path from the same state
    torch.cuda.synchronize()
    worst, same, leaves, main = 0.0, 0, 0, [0, 0, 0, 0]
    for epoch in range(CHUNK_EPOCHS):
        for group, objects, obj_mask, arrays in groups:
            copy_train_state(p_eager, o_eager, params, opt)
            start = train_state(p_eager, o_eager)
            c0 = launch_counts()
            graphed._train_chunk(params, opt, group, objects, obj_mask, arrays, None)
            main = [m + b - a for m, a, b in zip(main, c0, launch_counts())]
            eager_steps(group, objects, obj_mask, arrays)
            w, s = update_errors(train_state(params, opt), train_state(p_eager, o_eager), start)
            worst, same, leaves = max(worst, w), same + s, leaves + len(start)
    chunks = CHUNK_EPOCHS * len(groups)
    steps = CHUNK_EPOCHS * CHUNK_BATCHES
    want = [steps] * 2 + [0, 0] if route == "per_question" else [0, 0] + [steps] * 2
    if main != want:
        raise AssertionError(f"{route}: {chunks} chunks launched (fwd, bwd, pair_mlp, "
                             f"contract) {main}, not {want}")
    stats = graphed.graphs.stats()
    if stats["graphs"] != len(groups) or stats["replays"] != chunks - len(groups):
        raise AssertionError(f"{route}: graphs {stats}")
    # the eager chunk of the short tail under pad_chunks runs its real steps
    # only: every leaf bitwise where the per-step path leaves it
    group, objects, obj_mask, arrays = groups[-1]
    copy_train_state(p_eager, o_eager, params, opt)
    eager._train_chunk(p_eager, o_eager, group, objects, obj_mask, arrays, None)
    tail = train_state(p_eager, o_eager)
    copy_train_state(p_eager, o_eager, params, opt)
    eager_steps(group, objects, obj_mask, arrays)
    moved = sum(not torch.equal(a, b) for a, b in zip(tail, train_state(p_eager, o_eager)))
    if moved:
        raise AssertionError(f"{route}: {moved} leaves of the eager tail chunk differ from the "
                             "per-step path's")
    log(f"[13] {route} route, {CHUNK_BATCHES} batches of {trainset.PRODUCTION_BATCH} at "
        f"train_chunk={CHUNK} with pad_chunks (groups {CHUNK} and {CHUNK_BATCHES - CHUNK}, a "
        f"graph each), {CHUNK_EPOCHS} passes: {chunks} chunks ({len(groups)} eager, "
        f"{len(groups)} captured, {chunks - 2 * len(groups)} replayed), each against the card's "
        f"eager per-step path from the same state: worst leaf update error {worst!r} of its "
        f"largest change (gate {TRAIN_GRAD_RTOL}), {same} of {leaves} leaf checks bitwise "
        f"equal; the eager tail chunk of {len(group)} (no padded step) equals the "
        f"per-step path in all {len(tail)} parameters and Adam tensors; launches (fwd, "
        f"bwd, pair_mlp, contract) {main}, one a step, replays counted; graphs "
        f"{stats['graphs']}, capture "
        f"{stats['capture_seconds']} s, pool {stats['pool_bytes']} bytes ({stamp})")

    # time: the chunk graphs against the eager one-step path, loader and
    # transfer outside, in turns
    def chunked():
        for g, o, m, a in groups:
            graphed._train_chunk(params, opt, g, o, m, a, None)

    def per_step():
        for g, o, m, a in groups:
            eager_steps(g, o, m, a)

    times = in_turns({"per_step": per_step, "chunked": chunked})
    idle = {"per_step": profiled_idle(per_step), "chunked": profiled_idle(chunked)}
    text = "; ".join(
        f"{name}: {statistics.median(w for _, w in t) / CHUNK_BATCHES!r} ms per step "
        f"(runs {[round(w, 3) for _, w in t]} ms), host enqueue "
        f"{statistics.median(e for e, _ in t) / CHUNK_BATCHES!r} ms per step, idle share "
        f"{idle[name]}" for name, t in times.items())
    log(f"[13] {route} route, one pass of {CHUNK_BATCHES} steps, median of 4 in turns: "
        f"{text} ({stamp})")
    return dict(zip(("relation_oracle_fwd", "relation_oracle_bwd", "pair_mlp_fwd",
                     "shared_contract_fwd"), main))


def chunk_eval(ont, params_cpu, device, stamp: str) -> dict:
    """Phase 13 (d): returns the launches of the main run (the chunked
    ``_eval_chunked`` pass after warm-up and capture)."""
    from dfol_vqa_tpu_torch.data import evalset
    from dfol_vqa_tpu_torch.data.transfer import group_batches
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    world = evalset.demo_world(ont)
    sides = {}
    for chunk in (CHUNK, 1):
        cfg = evalset.demo_eval_config()
        cfg.tpu.eval_chunk = chunk
        sides[chunk] = VQATrainer(cfg, Interpreter(cfg, ont), device=device)
    datasets = evalset.eval_datasets(world, evalset.PRODUCTION_MIX, evalset.PRODUCTION_BATCH,
                                     evalset.PRODUCTION_IMAGES_PER_BATCH)
    batches = list(evalset.eval_loader(sides[1].cfg, ont, world, datasets))
    n_q = sum(len(d) for d in datasets)
    params = copy.deepcopy(params_cpu).to(device)
    g8, g1 = sides[CHUNK], sides[1]
    for _ in range(2):  # eager warm-up, then capture (and replay)
        g8.test_epoch(batches, params)
    relating = RouteCounter(batches, "shared")
    list(relating)
    torch.cuda.synchronize()
    c0 = launch_counts()
    outs8 = [(b, {k: v.clone() for k, v in o.items()}) for b, o in g8._eval_chunked(batches,
                                                                                   params)]
    torch.cuda.synchronize()
    main = [b - a for a, b in zip(c0, launch_counts())]
    if main != [0, 0, relating.relating, relating.relating]:
        raise AssertionError(f"chunked eval launched {main}, not kernels 3 and 4 "
                             f"{relating.relating} times")
    outs1 = list(g1._eval_chunked(batches, params))
    lp_err = 0.0
    for (b8, o8), (b1, o1) in zip(outs8, outs1):
        for k in ("answer_flags", "match"):
            if not torch.equal(o8[k], o1[k]):
                raise AssertionError(f"chunked eval: {k} of a {b8.spec.terminal_op} batch "
                                     "differs from eval_chunk=1")
        lp_err = max(lp_err, float((o8["log_probability"] - o1["log_probability"]).abs().max()))
    if not lp_err <= GOLDEN_ATOL:
        raise AssertionError(f"chunked eval: log_probability {lp_err!r} from eval_chunk=1")
    errors = {c: t.test_epoch(batches, params) for c, t in sides.items()}
    preds = {c: t.predict(batches, params, io.StringIO()) for c, t in sides.items()}
    if not np.array_equal(errors[CHUNK], errors[1]) or preds[CHUNK] != preds[1]:
        raise AssertionError("chunked test_epoch / predict differ from eval_chunk=1")
    times = in_turns({"eval_chunk=1": lambda: g1.test_epoch(batches, params),
                      f"eval_chunk={CHUNK}": lambda: g8.test_epoch(batches, params)})
    enq = {}
    for name, t in (("eval_chunk=1", g1), (f"eval_chunk={CHUNK}", g8)):
        enq[name] = timed_loop(lambda t=t: [o for _, o in t._eval_chunked(batches, params)])[0]
    idle = {"eval_chunk=1": profiled_idle(lambda: g1.test_epoch(batches, params)),
            f"eval_chunk={CHUNK}": profiled_idle(lambda: g8.test_epoch(batches, params))}
    stats = g8.graphs.stats()
    text = "; ".join(
        f"{name}: {n_q / (statistics.median(w for _, w in t) / 1000)!r} questions/s, "
        f"{statistics.median(w for _, w in t) / len(batches)!r} ms per batch (runs "
        f"{[round(w, 3) for _, w in t]} ms), host enqueue {enq[name] / len(batches)!r} ms per "
        f"batch, idle share {idle[name]}" for name, t in times.items())
    log(f"[13] (d) chunked eval of {n_q} questions ({len(batches)} batches of "
        f"{evalset.PRODUCTION_BATCH}, groups "
        f"{[len(g) for g in group_batches(batches, CHUNK)]}, "
        f"bf16 h2 stream): answers, matches, test_epoch errors and predict equal to "
        f"eval_chunk=1, log_probability within {lp_err!r}; launches (fwd, bwd, pair_mlp, "
        f"contract) {main} ({relating.relating} relating batches); graphs {stats['graphs']}, replays {stats['replays']}, capture "
        f"{stats['capture_seconds']} s, pool {stats['pool_bytes']} bytes; median of 4 in "
        f"turns: {text} ({stamp})")
    return dict(zip(("relation_oracle_fwd", "relation_oracle_bwd", "pair_mlp_fwd",
                     "shared_contract_fwd"), main))


def chunk_dropout(ont, params_cpu, device, stamp: str) -> None:
    """Phase 13 (e): a chunk of two deduplicated batches (the shared route's
    plain tails, as dropout sends them) at ``dropout=0.1``, run three
    times from one state: eagerly, captured and replayed, replayed. The
    replays draw new masks, so their losses differ."""
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.data.transfer import chunk_prefetch
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.train.optim import Optimizer
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    cfg = trainset.demo_train_config()
    cfg.dropout = CHUNK_DROPOUT
    cfg.tpu.train_chunk = 2
    world = evalset.demo_world(ont)
    sets = evalset.eval_datasets(world, (("exist", 2, 2 * trainset.PRODUCTION_BATCH),),
                                 trainset.PRODUCTION_BATCH, evalset.PRODUCTION_IMAGES_PER_BATCH,
                                 seed=17)
    (group,) = list(chunk_prefetch(list(trainset.train_loader(cfg, ont, world, sets,
                                                              shuffle=False)), 2, device))
    trainer = VQATrainer(cfg, Interpreter(cfg, ont), device=device)
    params = copy.deepcopy(params_cpu).to(device)
    opt = Optimizer(cfg, params)
    opt.static_grads()
    gen = torch.Generator(device=device).manual_seed(0)
    start = train_state(params, opt)
    losses, c0 = [], launch_counts()
    for _ in range(3):
        with torch.no_grad():
            for t, s in zip(list(params.parameters()) + opt._state_tensors(), start):
                t.copy_(s)
        losses.append(trainer._train_chunk(params, opt, *group, gen).cpu().numpy())
    launched = [b - a for a, b in zip(c0, launch_counts())]
    if not all(np.isfinite(x).all() for x in losses) or np.array_equal(losses[1], losses[2]):
        raise AssertionError(f"dropout chunk: losses {losses}: two replays drew the same masks")
    if launched[2:] != [0, 0] or launched[:2] != [0, 0]:
        raise AssertionError(f"dropout chunk launched {launched}: dropout takes the plain tails")
    log(f"[13] (e) a chunk of 2 shared-route batches at dropout={CHUNK_DROPOUT} (plain tails, "
        f"no kernel: launches {launched}), eager then two replays from one state: losses "
        f"{[x.tolist() for x in losses]}, the replays' differ (new masks each); capture {trainer.graphs.capture_seconds} s ({stamp})")


def phase_chunk(device, stamp: str) -> dict:
    """Phase 13: chunked dispatch as one CUDA graph per chunk. Returns the
    launches of its main runs by path."""
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology

    t0 = time.perf_counter()
    ont = GQAOntology()
    cfg = trainset.demo_train_config(stream_dtype="float32")
    cfg.tpu.train_chunk = CHUNK
    world = evalset.demo_world(ont)
    params_cpu = Interpreter(cfg, ont).init_params(torch.Generator().manual_seed(0))
    paths = {}
    for route in ("per_question", "shared"):
        paths[f"chunk_{route}"] = chunk_train_route(route, cfg, ont, world, params_cpu, device,
                                                    stamp)
    res = check_chunk_golden(device)
    log(f"[13] (c) JAX chunk golden (tiny widths, train_chunk={CHUNK}, checkpointing_frequency"
        f"=3, {CHUNK_BATCHES} batches): validation at global steps {res['steps']} as JAX's, "
        f"error vectors equal, parameters at most {res['gap_lr']!r} lr from JAX's; graphs "
        f"{res['graphs']} ({stamp})")
    paths["chunk_eval"] = chunk_eval(ont, params_cpu, device, stamp)
    chunk_dropout(ont, params_cpu, device, stamp)
    log(f"[13] phase 13 took {time.perf_counter() - t0!r} s")
    return paths

# phase 14: serving over a device mesh in one process, and the graft entry points
MESH_SERVE_SHAPES = ((2,), (4,), (2, 2), (4, 2))  # (a): logical meshes of the one card
SCALING_BURSTS = 8  # (d): phase 4's mix drawn 8 times (512 requests) per timed run


def mesh_serve_check(eng, qs, want, what: str) -> tuple:
    """Serve ``qs`` on the mesh engine ``eng``, the relating requests first
    and then the others; the answers must equal ``want`` (the CPU engine's,
    which the single-card engine's equal), and kernel 1 must launch once per
    relating group (``stats["batches"]``; each group runs whole on one data
    row) and never for the others. Returns (kernel 1's launches, relating
    groups, seconds)."""
    from dfol_vqa_tpu_torch.models.interpreter import spec_needs_relations
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro

    relating = [spec_needs_relations(eng._prepare(q)[0]) for q in qs]
    got: list = [None] * len(qs)
    counts = {}
    t0 = time.perf_counter()
    for rel in (True, False):
        idx = [i for i, r in enumerate(relating) if r == rel]
        groups = eng.stats["batches"]
        ro.LAUNCHES = 0
        for i, res in zip(idx, eng.answer_many([qs[i] for i in idx])):
            got[i] = res.answers
        counts[rel] = (ro.LAUNCHES, eng.stats["batches"] - groups)
    seconds = time.perf_counter() - t0
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"{what}: {bad}/{len(qs)} answers differ from the CPU engine's")
    (launches, groups), (others, _) = counts[True], counts[False]
    if launches != groups or groups <= 0 or others != 0:
        raise AssertionError(f"{what}: the relation_oracle kernel launched {launches} times for "
                             f"{groups} relating groups, and {others} times for the others")
    return launches, groups, seconds


def mesh_scaling(world, mixes: dict, served: dict, stamp: str) -> int:
    """(d), only where this process sees two cards or more (logical devices
    of one card would measure nothing): the meshes ``(n,)``, ``(n/2, 2)``
    (n even) and ``(1, n)`` (n > 2) over the n cards, warmed up, serve
    ``mixes`` (phases 4 and 8's requests) as the CPU engine did
    (``served``), kernel 1 once per relating group (``mesh_serve_check``);
    then requests/s of each mesh against the single-card engine, in turns,
    on bursts of phase 4's mix at ``max_batch=32``. Returns kernel 1's
    launches in the checks."""
    from dfol_vqa_tpu_torch.parallel.mesh import make_local_mesh
    from dfol_vqa_tpu_torch.serve import build_demo_engine

    n = torch.cuda.device_count()
    if n < 2:
        log(f"[14] (d) scaling over cards not measured: this machine has {n} card(s) ({stamp}); "
            f"the logical meshes of (a) share one card and would measure nothing")
        return 0
    cards = [torch.device("cuda", i) for i in range(n)]
    shapes = ([(n,)] + ([(n // 2, 2)] if n % 2 == 0 else [])
              + ([(1, n)] if n > 2 else []))
    qs = [q for b in range(SCALING_BURSTS) for q in serve_questions(world, seed=5000 + 100 * b)]
    engines = {"one card": build_demo_engine(device=cards[0], max_batch=32, seed=0)[3]}
    for shape in shapes:
        engines[f"mesh {shape}"] = build_demo_engine(
            mesh=make_local_mesh(shape, devices=cards), max_batch=32, seed=0)[3]
    fwd = 0
    try:
        for eng in engines.values():
            eng.warmup(qs + mixes["8"])
        for shape in shapes:
            for tag, mix in mixes.items():
                launches, groups, secs = mesh_serve_check(
                    engines[f"mesh {shape}"], mix, served[tag],
                    f"mesh {shape} over {n} cards, phase {tag}'s requests")
                fwd += launches
                log(f"[14] (d) mesh {shape} over {n} cards, phase {tag}'s {len(mix)} in "
                    f"{secs!r} s: answers == CPU engine, kernel 1 once per relating group "
                    f"({groups}) ({stamp})")
        rates: dict = {k: [] for k in engines}
        answers = {}
        for name in list(engines) + list(engines)[::-1]:  # in turns
            t0 = time.perf_counter()
            res = engines[name].answer_many(qs)
            rates[name].append(len(qs) / (time.perf_counter() - t0))
            answers[name] = [r.answers for r in res]
        if any(a != answers["one card"] for a in answers.values()):
            raise AssertionError("(d) a mesh over the cards answered otherwise than one card")
        log(f"[14] (d) {len(qs)} requests at max_batch=32, requests/s in turns: " + "; ".join(
            f"{k} {v}" for k, v in rates.items()) + f" ({n} cards, {stamp})")
    finally:
        for eng in engines.values():
            eng.stop()
    return fwd


def phase_serving_mesh(world, served: dict, device, stamp: str) -> dict:
    """Phase 14: serving over a device mesh in one process and the graft
    entry points. (a) the demo engine at production widths on the logical
    meshes ``MESH_SERVE_SHAPES`` of the card (warmed up on every data row):
    phase 4's 64 and phase 8's 68 requests, answers equal to the CPU
    engine's (``served``, which phases 4 and 8 held equal to the single-card
    engine's), kernel 1 once per relating group; (b) the first JAX golden
    through a (2, 2) tiny mesh engine; (c) the ``cur7`` calibrator engine
    on (2, 2) against phase 9's CPU answers, its GloVe constant on each
    replica's device; (d) scaling over real cards (``mesh_scaling``); (e)
    ``graft_entry.entry()`` on the card against the CPU from the same
    weights, and ``dryrun_multichip(2)`` as two gloo ranks on the card (and
    over NCCL on every card where there are two or more). Returns the
    kernels' launches of its main runs."""
    from dfol_vqa_tpu_torch import graft_entry
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.parallel.mesh import make_local_mesh
    from dfol_vqa_tpu_torch.serve import ServingEngine, build_demo_engine
    from dfol_vqa_tpu_torch.train import graphs

    t0 = time.perf_counter()
    mixes = {"4": serve_questions(world), "8": serve_questions(world, SERVE_TERMINALS_MIX, 2000)}
    fwd = 0
    for shape in MESH_SERVE_SHAPES:
        mesh = make_local_mesh(shape, devices=[device] * int(np.prod(shape)))
        _, _, _, eng = build_demo_engine(mesh=mesh, max_batch=32, seed=0)
        try:
            info = eng.warmup(mixes["4"] + mixes["8"])
            runs = []
            for tag, qs in mixes.items():
                launches, groups, secs = mesh_serve_check(eng, qs, served[tag],
                                                          f"mesh {shape}, phase {tag}'s requests")
                fwd += launches
                runs.append(f"phase {tag}'s {len(qs)} in {secs!r} s, {groups} relating groups")
            log(f"[14] (a) mesh {shape} of {device}: warmup {info['runs']} runs of "
                f"{info['specs']} specs in {info['seconds']!r} s; " + "; ".join(runs)
                + f"; answers == CPU engine == single card, kernel 1 once per relating group "
                f"({stamp})")
        finally:
            eng.stop()
    n = check_golden(device, GOLDEN_ATOL,
                     mesh=make_local_mesh((2, 2), devices=[device] * 4))
    log(f"[14] (b) JAX golden through a (2, 2) mesh engine: {n} requests, answers equal, "
        f"log_probability within {GOLDEN_ATOL}")
    ont = GQAOntology()
    cfg = calibrator_config(objects=24)
    eng = ServingEngine(cfg, ont, model_params(cfg, ont), features=world, max_batch=32,
                        transfer_dtype="bfloat16",
                        mesh=make_local_mesh((2, 2), devices=[device] * 4))
    try:
        eng.warmup(mixes["4"])
        launches, groups, _ = mesh_serve_check(eng, mixes["4"], served["9"], "cur7 on (2, 2)")
        fwd += launches
        for row in range(eng.mesh.n_data):
            lead, _ = eng._replica(row)
            if eng._constants(lead)["embedding"].device != lead:
                raise AssertionError(f"cur7 on (2, 2): row {row}'s GloVe constant is not on "
                                     f"{lead}")
        keys = [k for k in eng.interp._index_cache if k[0] == "embedding"]
    finally:
        eng.stop()
    log(f"[14] (c) cur7 calibrator engine on (2, 2): phase 4's requests == phase 9's CPU "
        f"answers, {groups} relating groups, GloVe constant cached as {keys}")
    fwd += mesh_scaling(world, mixes, served, stamp)
    fn, args = graft_entry.entry(device=device)
    fn_cpu, args_cpu = graft_entry.entry(device="cpu")
    before = graphs.launch_counts()
    with torch.no_grad():
        lp = fn(*args).cpu().numpy()
    entry_launches = [b - a for a, b in zip(before, graphs.launch_counts())]
    with torch.no_grad():
        lp_cpu = fn_cpu(*args_cpu).numpy()
    err = float(np.abs(lp - lp_cpu).max())
    if not (np.isfinite(lp).all() and err <= GOLDEN_ATOL):
        raise AssertionError(f"graft_entry.entry() on the card off the CPU's by {err}")
    dry = [graft_entry.dryrun_multichip(2, device=str(device))]
    if torch.cuda.device_count() >= 2:
        dry.append(graft_entry.dryrun_multichip(torch.cuda.device_count(), device="cuda"))
    log(f"[14] (e) graft_entry.entry(): log_probability {lp.tolist()} within {err!r} of the "
        f"CPU's, launches (fwd, bwd, pair_mlp, contract) {entry_launches}; dryrun_multichip: "
        + "; ".join(f"mesh {d['mesh']} over {d['backend']} (rank 0 on {d['device']}), loss "
                    f"{d['loss']!r}, launches {d['launches']}" for d in dry))
    log(f"[14] phase 14 took {time.perf_counter() - t0!r} s")
    totals = [a + sum(d["launches"][i] for d in dry) for i, a in enumerate(entry_launches)]
    totals[0] += fwd
    return dict(zip(MESH_KERNELS, totals))


def phase_pinned(device=None, stamp: str = None) -> None:
    """Phase 15 (module docstring): the loader's page-locked object blocks
    on the training route, and a block's reuse held back until its copy
    has read it."""
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.data.loader import can_pin
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer
    from dfol_vqa_tpu_torch.utils import profiling

    device = device or torch.device("cuda", 0)
    stamp = stamp or card()
    if not can_pin():
        raise AssertionError("the loader cannot page-lock memory on the card's host")
    ont = GQAOntology()
    cfg = trainset.demo_train_config()
    cfg.epoch_num, cfg.tpu.train_chunk = 1, 4
    world = evalset.demo_world(ont)
    files = trainset.train_datasets(world, (("exist", 2, 5 * cfg.train_batch_size),), seed=5)
    seen = []

    class Seen:
        def __init__(self, loader):
            self.loader = loader

        def __len__(self):
            return len(self.loader)

        def __iter__(self):
            for b in self.loader:
                seen.append(b.block is not None and b.block.is_pinned())
                yield b

    interp = Interpreter(cfg, ont)
    params = interp.init_params(torch.Generator().manual_seed(0), device)
    profiling.clear()
    VQATrainer(cfg, interp, device=device).train(
        Seen(trainset.train_loader(cfg, ont, world, files, seed=1)), None, params)
    stages = [r[4] for r in profiling.recorded() if r[0] == "transfer.stage"]
    if seen != [True] * 5 or sorted(s["batches"] for s in stages) != [1, 4] or \
            any(s["pinned"] != s["batches"] for s in stages):
        raise AssertionError(f"[15] training route: blocks page-locked {seen}, "
                             f"transfer.stage tags {stages}")
    log(f"[15] training route: 5 batches, every block page-locked; transfer.stage {stages}")

    # (b) a block dropped while its copy waits behind a spin kernel; the
    # allocator's cache emptied first, so that a block it wrongly took back
    # would be the first it hands out again
    O = cfg.tpu.max_object_num
    features = bulk_features(world)
    ids = list(world.image_ids)
    first, others = ids[:48], [ids[16 + k:64] + ids[:k] for k in range(8)]
    empty_cache = getattr(torch._C, "_host_emptyCache", None)

    def dropped_copy(view: bool):
        if empty_cache is not None:
            empty_cache()
        g = features.gather_unique(first, O, pinned=True)
        want = torch.from_numpy(g.objects.copy())
        src = torch.from_numpy(g.objects) if view else g.pinned
        if not src.is_pinned():
            raise AssertionError("[15] the gather's block is not page-locked")
        ptr = g.pinned.data_ptr()
        torch.cuda._sleep(10_000_000_000)  # ~5 s at 1.98 GHz: the copy waits behind it
        on_card = src.to(device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        del g, src
        later = [features.gather_unique(o, O, pinned=True) for o in others]
        if copied.query():
            raise AssertionError("[15] the copy ran before the later gathers ended")
        reused = sum(x.pinned.data_ptr() == ptr for x in later)
        torch.cuda.synchronize()
        return torch.equal(on_card.cpu(), want), reused

    with torch.cuda.device(device):
        equal, reused = dropped_copy(view=False)
        if not equal or reused:
            raise AssertionError(f"[15] a dropped block was handed out before its copy: "
                                 f"device tensor equal {equal}, block reused {reused} times")
        control = dropped_copy(view=True)
    stats = {k: v for k, v in torch.cuda.host_memory_stats().items()
             if k.startswith(("allocations.", "allocated_bytes.", "reserved_bytes.",
                              "num_host_alloc"))}
    log(f"[15] dropped batch: device tensor equal to its bytes, block held until the copy "
        f"ran; control (copy from a from_numpy view): equal {control[0]}, block reused "
        f"{control[1]} times; cache emptied first: {empty_cache is not None}; pinned host "
        f"memory {stats}; {stamp}")


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
    _, _, _, cpu_eng = build_demo_engine(device="cpu", max_batch=32, seed=0)
    try:
        records = [phase_kernels(eng, stamp), phase_bwd_kernel(eng, stamp)]
        records += phase_shared_kernels(eng.params, eng.cfg, device, stamp)
        phase_cache_dtype(device, stamp)
        served: dict = {}  # CPU answers of phases 4, 8 and 9, for phase 14
        serve = {"relation_oracle_fwd": phase_serve(eng, cpu_eng, world, stamp, answers=served)}
        serve_int8 = {"relation_oracle_fwd": phase_serve_int8(eng, cpu_eng, world, device,
                                                              stamp)}
        t8 = time.perf_counter()
        serve8 = {"relation_oracle_fwd": phase_serve(eng, cpu_eng, world, stamp,
                                                     SERVE_TERMINALS_MIX, tag="8", seed=2000,
                                                     answers=served)}
        t8 = time.perf_counter() - t8
    finally:
        eng.stop()
        cpu_eng.stop()
    n = check_golden(device, GOLDEN_ATOL)
    log(f"[5] JAX golden: {n} requests, answers equal, log_probability within {GOLDEN_ATOL}")
    n = check_eval_golden(device, GOLDEN_ATOL)
    log(f"[5] JAX eval golden: {n} loader batches, answers, test_epoch error and predict "
        f"equal, log_probability within {GOLDEN_ATOL}")
    paths = {"serve": serve, "eval": phase_eval(device, stamp), "train": phase_train(device, stamp)}
    t0 = time.perf_counter()
    n, ties = check_terminals_golden(device, GOLDEN_ATOL, GOLDEN_GRAD_RTOL)
    log(f"[8] JAX terminals golden: {n} terminal batches x (soft, hard), log_probability within "
        f"{GOLDEN_ATOL}, answer flags and matches equal ({ties} inside a near-tie), the "
        f"supervision terminals' loss and gradients within {GOLDEN_GRAD_RTOL} relative")
    paths["terminals_serve"] = serve8
    paths["terminals_eval"] = phase_terminals_eval(device, stamp)
    paths["terminals_train"] = phase_terminals_train(device, stamp)
    log(f"[8] phase 8 took {t8 + time.perf_counter() - t0!r} s, CPU references included")
    paths["calibrator"] = phase_calibrator(world, device, stamp, served)
    paths["serve_int8"] = serve_int8
    paths["curriculum"] = phase_curriculum(device, stamp)
    paths["daemon"] = phase_daemon(device, stamp)
    paths["mesh"] = phase_mesh(device, stamp)
    paths["bf16"] = phase_bf16(device, stamp)
    paths.update(phase_chunk(device, stamp))
    paths["serving_mesh"] = phase_serving_mesh(world, served, device, stamp)
    phase_pinned(device, stamp)
    # each path's counts were set to 0 just before its main run and read just after
    for rec in records:
        rec["launches"] = sum(run.get(rec["name"], 0) for run in paths.values())
        if rec["launches"] <= 0:
            raise AssertionError(f"{rec['name']} never launched on a main path")
    log(f"launches by main path: {paths}")
    jax_modules = [m for m in sys.modules if m.split(".")[0] in ("jax", "dfol_vqa_tpu")]
    if jax_modules:
        raise AssertionError(f"the port imported JAX or the JAX package: {jax_modules[:5]}")

    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
