"""The weight-free serving artifact: the engine's step set, exported.

Port of ``dfol_vqa_tpu/export.py``. ``export_serving_set`` exports the
serving engine's steps (``ServingEngine._make_step``: one per canonical
``BucketSpec`` x batch rung, and with ``include_traces`` one
``_make_trace_step`` per spec at rung 1) with ``torch.export`` and writes
each with ``torch.export.save``. A step takes the parameters as an input
(``serve.param_tensors``), so no module file holds a weight and one
artifact serves any checkpoint of the same configuration.
``load_serving_set`` checks the manifest and maps each module to a
``StoredStep``, which the engine reads from its file at the key's first
use (as the JAX engine compiles a deserialized module at first use): a
loading host runs the programs and never calls ``Interpreter.forward``.

Artifact layout (a directory):

    manifest.json   the engine's widths and ladders, the device, the
                    torch version, the size, and one entry per module:
                    {spec, meta, batch, kind, file}
    NNNN.pt2        one torch.export program

The relation route is chosen while a step is exported: on a CUDA device
the per-question route is kernel 1 (the operator
``dfol_vqa_tpu_torch::relation_oracle_fwd``, a node of the program that
launches the kernel when the loaded step runs), on the CPU its plain
version. So an artifact is bound to the device type it was exported on,
and ``load_serving_set`` refuses it on an engine of another.

    python -m dfol_vqa_tpu_torch.export --out DIR [--cpu] [--tiny] [--workers N]

exports the demo engine's set for a sample of the planted world's
families, reloads it, and checks that a fresh engine serves from it the
live engine's answers without making a live step.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import torch

from dfol_vqa_tpu_torch.compiler.program_compiler import SUPERVISION_OPS, BucketSpec, _pad_ladder
# the operator must be registered before a program that calls it is loaded
from dfol_vqa_tpu_torch.ops import relation_oracle  # noqa: F401

MANIFEST = "manifest.json"
FORMAT = "dfol_vqa_tpu_torch.serving_set.v1"


# ------------------------------------------------------- spec/meta <-> json


def spec_to_json(spec: BucketSpec) -> dict:
    d = dataclasses.asdict(spec)
    d["grid"] = [list(g) for g in spec.grid]
    return d


def spec_from_json(d: dict) -> BucketSpec:
    d = dict(d)
    d["grid"] = tuple(tuple(int(x) for x in g) for g in d["grid"])
    return BucketSpec(**d)


def meta_to_json(meta: Tuple) -> list:
    return [list(m) if isinstance(m, tuple) else m for m in meta]


def meta_from_json(rows: list) -> Tuple:
    out = []
    for m in rows[:-1]:
        k, shape, dtype, off = m
        out.append((str(k), tuple(int(s) for s in shape), str(dtype), int(off)))
    return tuple(out) + ((int(rows[-1][0]),),)


# ------------------------------------------------------------------- export


def _policy(engine) -> dict:
    """The engine fields an artifact must match to be served by it."""
    return {
        "device_type": engine.device.type,
        "object_num": engine.cfg.tpu.max_object_num,
        "transfer_dtype": engine.transfer_dtype,
        "rel_table_size": engine.cfg.tpu.rel_table_size,
        "option_pad_ladder": list(engine.cfg.tpu.option_pad_ladder),
        "seg_ladder": list(engine.seg_ladder),
        "fill_ladder": list(engine.fill_ladder),
    }


def _reachable_rungs(engine) -> list:
    top = _pad_ladder(engine.max_batch, engine.batch_ladder)
    return [b for b in engine.batch_ladder if b <= top]


class _Step(torch.nn.Module):
    """A step callable as the module ``torch.export`` traces: it holds no
    parameter, the weights arrive as its first input."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, params, objects, obj_mask, arrays, consts):
        return self.fn(params, objects, obj_mask, arrays, consts)


class StoredStep:
    """One module of an artifact, read from its file at first use."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> torch.export.ExportedProgram:
        return torch.export.load(self.path)

    def module(self) -> torch.nn.Module:
        """The step callable (``ServingEngine`` calls this once per key)."""
        return self.load().module()


def export_serving_set(engine, questions: Sequence[dict], out_dir: str,
                       batch_sizes: Optional[Sequence[int]] = None,
                       include_traces: bool = False, workers: int = 1) -> dict:
    """Export every canonical spec in ``questions`` x batch rungs (default:
    every rung the engine's policy can produce) to ``out_dir``, on the
    engine's device and with its current weights as example inputs.
    Returns the manifest. Mirrors ``ServingEngine.warmup`` (the same
    ``_prepare``/``_assemble`` path), so the keys match live traffic's.

    ``workers`` > 1 shares the modules out to that many processes (spawned,
    each with an engine built from this one's configuration, weights and
    ladders): export is host work, about a second a module, one core each."""
    from dfol_vqa_tpu_torch.serve import _Request

    if engine.mesh is not None:
        raise ValueError("export is single-device; build the engine without a mesh")
    if batch_sizes is None:
        batch_sizes = _reachable_rungs(engine)
    reps: Dict[BucketSpec, object] = {}
    for q in questions:
        if q["program"]["last_op"]["operator"] in SUPERVISION_OPS:
            continue
        key, cb = engine._prepare(q)
        if key not in reps:
            objs, mask = engine.features.batch([q["imageId"]], engine.cfg.tpu.max_object_num)
            reps[key] = _Request(q, objs[0], mask[0], cb)

    os.makedirs(out_dir, exist_ok=True)
    entries, jobs = [], []
    for key, r in sorted(reps.items(), key=lambda kv: repr(kv[0])):
        # the trace step always runs at batch rung 1
        for B, kind in [(B, "eval") for B in batch_sizes] + [(1, "trace")] * include_traces:
            lb, _ = engine._assemble(key, [r], pad_to=B)
            fname = f"{len(entries):04d}.pt2"
            entries.append({"spec": spec_to_json(lb.spec), "meta": meta_to_json(lb.meta),
                            "batch": B, "kind": kind, "file": fname})
            jobs.append((r.question, r.objects, r.obj_mask, B, kind,
                         os.path.join(out_dir, fname)))
    t0 = time.perf_counter()
    if workers <= 1:
        _export_jobs(engine, jobs)
    else:
        recipe = _recipe(engine)
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            for fut in [pool.submit(_export_worker, recipe, jobs[i::workers])
                        for i in range(min(workers, len(jobs)))]:
                fut.result()
    seconds = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(out_dir, e["file"])) for e in entries)
    manifest = {
        "format": FORMAT,
        **_policy(engine),
        "device_name": (torch.cuda.get_device_name(engine.device)
                        if engine.device.type == "cuda" else "cpu"),
        "torch_version": torch.__version__,
        "batch_sizes": list(batch_sizes),
        "n_specs": len(reps),
        "export_seconds": seconds,
        "export_workers": workers,
        "artifact_mb": nbytes / 1e6,
        "executables": entries,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _export_jobs(engine, jobs) -> None:
    """Export and save each (question, objects, obj_mask, rung, kind, path)."""
    from dfol_vqa_tpu_torch.serve import _Request

    for q, objects, obj_mask, B, kind, path in jobs:
        key, cb = engine._prepare(q)
        lb, _ = engine._assemble(key, [_Request(q, objects, obj_mask, cb)], pad_to=B)
        make = engine._make_step if kind == "eval" else engine._make_trace_step
        with torch.no_grad():
            ep = torch.export.export(_Step(make(lb.spec, lb.meta)), engine._inputs(lb),
                                     strict=False)
        if ep.state_dict:
            raise AssertionError(f"exported step holds parameters: {sorted(ep.state_dict)[:3]}")
        # torch.export.save would also write the example inputs: the weights
        ep.example_inputs = None
        torch.export.save(ep, path)


def _recipe(engine) -> dict:
    """What a worker process needs to build an engine like ``engine``."""
    return {"cfg": engine.cfg, "ontology": engine.interp.ont,
            "params": copy.deepcopy(engine.params).to("cpu"), "device": str(engine.device),
            "max_batch": engine.max_batch, "batch_ladder": engine.batch_ladder,
            "seg_ladder": engine.seg_ladder, "fill_ladder": engine.fill_ladder,
            "transfer_dtype": engine.transfer_dtype}


def _export_worker(recipe: dict, jobs) -> None:
    from dfol_vqa_tpu_torch.serve import ServingEngine

    engine = ServingEngine(**recipe, start=False)
    try:
        _export_jobs(engine, jobs)
    finally:
        engine.stop()


def load_serving_set(in_dir: str, engine=None) -> Dict[tuple, StoredStep]:
    """Read an artifact's manifest into the ``executables`` mapping
    ``ServingEngine`` takes: (spec, meta) -> ``StoredStep``, and (spec,
    meta, "trace") for trace modules. No model code runs.

    Pass the consuming ``engine`` to check that it can serve the artifact:
    a device type, object count, transfer dtype, table size or ladder that
    differs, or a batch rung the engine's policy can reach that the
    artifact lacks, raises ``ValueError`` (the engine would otherwise miss
    the keys, or run a program recorded for another device)."""
    with open(os.path.join(in_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"unrecognized artifact format: {manifest.get('format')}")
    if engine is not None:
        for k, v in _policy(engine).items():
            if manifest.get(k) != v:
                raise ValueError(f"artifact/engine mismatch on {k}: artifact has "
                                 f"{manifest.get(k)!r}, engine expects {v!r}")
        missing = set(_reachable_rungs(engine)) - set(manifest["batch_sizes"])
        if missing:
            raise ValueError(f"artifact lacks batch rungs {sorted(missing)} that the engine's "
                             f"policy can produce (has {manifest['batch_sizes']})")
    out: Dict[tuple, object] = {}
    for e in manifest["executables"]:
        key = (spec_from_json(e["spec"]), meta_from_json(e["meta"]))
        if e.get("kind", "eval") == "trace":
            key = key + ("trace",)
        path = os.path.join(in_dir, e["file"])
        if not os.path.isfile(path):
            raise ValueError(f"artifact module {path} is missing")
        out[key] = StoredStep(path)
    return out


# ---------------------------------------------------------------------- CLI


def sample_questions(world, lengths=(0, 1, 2), n_per: int = 2, seed: int = 3) -> list:
    """``n_per`` planted-world questions of every family at every length."""
    from dfol_vqa_tpu_torch.data.planted import ALL_FAMILIES

    qs = []
    for fi, fam in enumerate(ALL_FAMILIES):
        for li, ln in enumerate(lengths):
            qs.extend(world.generate_family(fam, n_per, length=ln, seed=seed + 10 * fi + li,
                                            id_prefix=f"x{fam}{ln}-"))
    return qs


def main(argv=None) -> int:
    """Export the demo engine's set, reload it into a fresh engine that may
    not call ``Interpreter.forward``, and compare its answers with the live
    engine's; prints one JSON summary, ``ok`` true when they agree."""
    import argparse

    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.serve import build_demo_engine

    ap = argparse.ArgumentParser(prog="python -m dfol_vqa_tpu_torch.export")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--cpu", action="store_true", help="export and serve on the CPU")
    ap.add_argument("--tiny", action="store_true", help="small demo dims")
    ap.add_argument("--objects", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--workers", type=int, default=1, help="export processes")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to export for the CPU")

    demo = dict(tiny=args.tiny, objects=args.objects, max_batch=args.max_batch, device=device)
    _, _, world, live = build_demo_engine(**demo)
    qs = sample_questions(world, lengths=(0, 1) if args.tiny else (0, 1, 2))
    try:
        manifest = export_serving_set(live, qs, args.out, include_traces=True,
                                      workers=args.workers)
        want = [r.answers for r in live.answer_many(qs)]
    finally:
        live.stop()
    t0 = time.perf_counter()
    _, _, _, probe = build_demo_engine(**demo, start=False)
    loaded = load_serving_set(args.out, engine=probe)
    probe.stop()
    load_s = time.perf_counter() - t0
    forward = Interpreter.forward
    Interpreter.forward = _refuse_forward
    try:
        _, _, _, eng = build_demo_engine(**demo, executables=loaded)
        try:
            got = [r.answers for r in eng.answer_many(qs)]
            trace = eng.trace(qs[0])
        finally:
            eng.stop()
    finally:
        Interpreter.forward = forward
    agree = sum(a == b for a, b in zip(got, want))
    summary = {
        "ok": agree == len(qs) and eng.stats["compiled_steps"] == 0 and bool(trace["hops"]),
        "device": manifest["device_name"], "n_specs": manifest["n_specs"],
        "modules": len(manifest["executables"]), "export_seconds": manifest["export_seconds"],
        "artifact_mb": manifest["artifact_mb"], "load_seconds": load_s,
        "answers_agree": f"{agree}/{len(qs)}", "aot_steps": eng.stats["aot_steps"],
        "compiled_steps": eng.stats["compiled_steps"], "trace_steps": eng.stats["trace_steps"],
    }
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


def _refuse_forward(*_args, **_kwargs):
    raise AssertionError("Interpreter.forward called on an engine serving an artifact")


if __name__ == "__main__":
    raise SystemExit(main())
