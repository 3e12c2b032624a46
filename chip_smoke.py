"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each reported on its own line(s):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every CUDA kernel of the serving path from ``csrc/`` (nvcc,
   sm_90a) and its seconds;
3. each kernel against its plain PyTorch version at the serving path's
   shapes (the relation-oracle pair tail at B=32, O=24 and O=100, H=256,
   E=300, R=8): max abs difference (tolerance 1e-4: f32 sums in another
   order) and median CUDA-event times of both;
4. the serving engine (``build_demo_engine`` at production dims: 2048-d
   boxes, 512-d oracle, E=300, H=256, O=24, bf16 transfer) answers 64
   planted-world requests (exist with 0-2 hops, verify_rel, query_attr) on
   the card; the answers must equal the same engine and weights on the CPU
   (plain path), and every kernel must have launched during the run;
5. the JAX golden (``tests/data/torch_port_golden.npz``): the port on the
   card must give JAX's answers and its log-probabilities within 1e-4.

Then one JSON line with each kernel's launches, error and times, and last
the result line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before the result line. TF32 is off for matmuls and cuDNN.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
KERNEL_ATOL = 1e-4
GOLDEN_ATOL = 1e-4

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro
    from dfol_vqa_tpu_torch.serve import build_demo_engine

    device = torch.device("cuda", 0)
    stamp = card()
    log(f"[1] card: {stamp}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, tf32 matmul/cudnn off")

    built = ro.build()
    log(f"[2] built relation_oracle in {built.seconds!r} s: {' '.join(built.command)}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2]   {line.strip()}")

    _, _, world, eng = build_demo_engine(device=device, max_batch=32, seed=0)
    try:
        record = phase_kernels(eng, stamp)
        record["launches"] = phase_serve(eng, world, stamp)
    finally:
        eng.stop()
    n = check_golden(device, GOLDEN_ATOL)
    log(f"[5] JAX golden: {n} requests, answers equal, log_probability within {GOLDEN_ATOL}")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
