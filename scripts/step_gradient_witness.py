"""Training-step gradients on the card and on the CPU: which side is off.

``chip_smoke.py`` holds each training step on the card against the CPU
plain path's step from the same parameters. Where the two differ, this
script says which side is off: for phase 9's calibrator configuration
(``chip_smoke.calibrator_config``: ``cur7`` at its widths, batch 80,
O=100, the output head drawn at random by ``chip_smoke.model_params``) it
takes the first ``--steps`` steps of a route on the card, and before each
one computes the gradients from the card's parameters:

- ``card``: the card in float32, TF32 off (as ``chip_smoke.py`` runs);
- ``card_tf32``: the card with TF32 matmuls on, a control of lower precision;
- ``card_reversed``: the card on the batch with its questions in reverse
  order (the same sums in another float32 order);
- ``cpu``, ``cpu_reversed``: the CPU plain path in float32, both orders;
- ``f64``: the CPU plain path in float64 (``float64_grads``).

Per step it prints pairs of them in the measure of
``chip_smoke.card_vs_cpu_steps``: the worst leaf's max |a - b| over that
leaf's largest |b|.

    python3 scripts/step_gradient_witness.py [--route shared|per_question] [--steps 3]

Needs one CUDA card (the float64 pass runs on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def float64_plain_path():
    """The port's plain path computing in float64: new tensors default to
    float64, ``Tensor.float`` casts to float64 and the attribute and
    relation caches are kept in float64."""
    from dfol_vqa_tpu_torch.models import oracle as om

    real = torch.Tensor.float, om.resolve_cache_dtype, torch.get_default_dtype()
    torch.Tensor.float = lambda self, *args, **kw: self.to(torch.float64)
    om.resolve_cache_dtype = lambda cfg, batch: torch.float64
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float, om.resolve_cache_dtype = real[:2]
        torch.set_default_dtype(real[2])


def float64_grads(cfg, ont, params, lb) -> tuple:
    """(loss, {checkpoint key: gradient}) of one training batch ``lb`` on
    the CPU in float64 from ``params`` (a CPU ``OracleParams``): the
    parameters, objects, batch arrays, GloVe features, caches and the h2
    stream (``tpu.rel_stream_dtype``) all in float64."""
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter

    cfg64 = copy.deepcopy(cfg)
    cfg64.tpu.rel_stream_dtype = "float64"
    p64 = copy.deepcopy(params).double()
    interp = Interpreter(cfg64, ont)
    interp._emb_matrix = interp.embedding_matrix.astype(np.float64)
    _, objs, mask, arrays = to_device_batch(lb, "cpu")
    arrays = {k: v.double() if v.is_floating_point() else v for k, v in arrays.items()}
    with float64_plain_path():
        out = interp.forward(p64, objs.double(), mask, arrays, lb.spec, is_training=True)
        loss = out["loss"] / torch.clamp(torch.sum(arrays["question_mask"]), min=1.0)
        loss.backward()
    if loss.dtype != torch.float64:
        raise AssertionError(f"the float64 pass computed its loss in {loss.dtype}")
    grads = {name.replace(".", "/"): (p.grad.detach().numpy().copy() if p.grad is not None
                                      else np.zeros(tuple(p.shape)))
             for name, p in p64.named_parameters()}
    return loss.item(), grads


def reversed_batch(lb):
    """``lb`` with its questions in reverse order: every array whose leading
    dimension is the batch's (``img_index``'s) reversed along it."""
    out = copy.copy(lb)
    B = len(lb.arrays["img_index"])
    out.arrays = {k: (np.ascontiguousarray(v[::-1]) if np.ndim(v) and len(v) == B else v)
                  for k, v in lb.arrays.items()}
    return out


def worst_vs(got: dict, ref: dict) -> tuple:
    """(max over leaves of max |got - ref| / max |ref|, that leaf), leaves
    whose reference is all zero left out."""
    return max((float(np.abs(got[k].astype(np.float64) - r).max() / np.abs(r).max()), k)
               for k, r in ref.items() if np.any(r))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=("shared", "per_question"), default="shared")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_gradient_witness: needs one CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dfol_vqa_tpu_torch.data import evalset, trainset
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.train.optim import Optimizer
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    device = torch.device("cuda", 0)
    stamp = cs.card()
    ont = GQAOntology()
    cfg = cs.calibrator_config()
    world = evalset.demo_world(ont)
    if args.route == "shared":
        sets = evalset.eval_datasets(world, trainset.PRODUCTION_MIX, trainset.PRODUCTION_BATCH,
                                     evalset.PRODUCTION_IMAGES_PER_BATCH)
        batches = list(trainset.train_loader(cfg, ont, world, sets, shuffle=False))
    else:
        batches = list(trainset.train_loader(
            cfg, ont, world, trainset.train_datasets(world, trainset.PRODUCTION_MIX)))
    params = cs.model_params(cfg, ont)
    p_gpu, p_cpu = copy.deepcopy(params).to(device), copy.deepcopy(params)
    gpu = VQATrainer(cfg, Interpreter(cfg, ont), device=device)
    cpu = VQATrainer(cfg, Interpreter(cfg, ont), device="cpu")
    opt = Optimizer(cfg, p_gpu)
    rows = []
    for k, lb in enumerate(batches[:args.steps]):
        t0 = time.perf_counter()
        with torch.no_grad():
            for mine, card_p in zip(p_cpu.parameters(), p_gpu.parameters()):
                mine.copy_(card_p.cpu())
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        gpu.compute_grads(p_gpu, lb)
        g_tf32 = cs.grads_of(p_gpu)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        gpu.compute_grads(p_gpu, lb)
        g_gpu = cs.grads_of(p_gpu)
        l_cpu = cpu.compute_grads(p_cpu, lb).item()
        g_cpu = cs.grads_of(p_cpu)
        cpu.compute_grads(p_cpu, reversed_batch(lb))
        g_cpu_rev = cs.grads_of(p_cpu)
        l_64, g_64 = float64_grads(cfg, ont, p_cpu, lb)
        gpu.compute_grads(p_gpu, reversed_batch(lb))
        g_gpu_rev = cs.grads_of(p_gpu)
        l_gpu = gpu.compute_grads(p_gpu, lb).item()  # leaves the step's own gradients
        row = {"step": k, "terminal": lb.spec.terminal_op,
               "loss": {"card": l_gpu, "cpu": l_cpu, "f64": l_64},
               "card_vs_cpu": worst_vs(g_gpu, g_cpu),
               "card_tf32_vs_cpu": worst_vs(g_tf32, g_cpu),
               "cpu_reversed_vs_cpu": worst_vs(g_cpu_rev, g_cpu),
               "card_reversed_vs_card": worst_vs(g_gpu_rev, g_gpu),
               "card_vs_f64": worst_vs(g_gpu, g_64), "cpu_vs_f64": worst_vs(g_cpu, g_64),
               "card_tf32_vs_f64": worst_vs(g_tf32, g_64),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        opt.step()  # the card's float32 gradients are still in .grad
    print(f"float64 witness, calibrator configuration, {args.route} route ({stamp})")
    print(json.dumps({"route": args.route, "card": stamp, "steps": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
