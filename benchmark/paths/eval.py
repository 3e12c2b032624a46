"""Offline evaluation of a question file: ``VQATrainer.predict`` passes.

Set-up builds the scenes and the question files from the seed, the weights
on the device and the loader, and runs two passes (the first runs each
chunk eagerly, the second captures its CUDA graph). The window runs whole
passes until ``--seconds`` have gone by; the rate is every question of
those passes over their seconds. ``predict`` is the offline entry point
whose outputs are per question (``test_epoch`` returns error rates only),
so the answers of the last pass are judged: whole loader batches drawn from
the seed, each question's answers against the reference's scores of its
batch, on the shared-image route as the program runs it.
"""

from __future__ import annotations

import functools
import io
import time

import numpy as np

from benchmark import weights, work
from benchmark.harness import Ctx
from benchmark.reference.check import Reference, answer_gap, precision, served_gap
from benchmark.reference.ontology import GQAOntology as RefOntology
from benchmark.trace import Spans, Trace
from benchmark.traffic import mix

TRACE_SECONDS = 3.0  # passes that start this close to the window's end are traced


class TimedLoader:
    """The loader handed to the trainer: iterates ``loader`` and adds up the
    wait in its ``next()`` (``wait_s``, ``batches``)."""

    def __init__(self, loader, span=None):
        self.loader = loader
        self.span = span or Spans(False)
        self.wait_s = 0.0
        self.batches = 0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            with self.span("loader"):
                try:
                    batch = next(it)
                except StopIteration:
                    return
            self.wait_s += time.perf_counter() - t
            self.batches += 1
            yield batch


def batches_of(files, batch: int):
    """The loader's batches of an unshuffled pass: each file's questions in
    runs of ``batch``."""
    return [qs[i:i + batch] for qs in files for i in range(0, len(qs), batch)]


def run(ctx: Ctx):
    import torch
    from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
    from dfol_vqa_tpu_torch.config import Config
    from dfol_vqa_tpu_torch.data.dataset import ProgramDataset
    from dfol_vqa_tpu_torch.data.loader import BatchLoader
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    from benchmark.scenes import Scenes

    spec, dev = ctx.spec, torch.device(ctx.device)
    cfg = Config.from_yaml(ctx.config_file)
    ont = GQAOntology()
    O = cfg.tpu.max_object_num
    world = mix.make_world(RefOntology(), spec, O, cfg.box_features_dim, ctx.seed, ctx.device)
    files = mix.eval_files(world, spec, ctx.seed)
    if dev.type == "cuda":  # the peak read after the window is the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    interp = Interpreter(cfg, ont)
    params = interp.init_params(torch.Generator().manual_seed(0), dev)
    values = weights.draw(params, ctx.seed, dev)
    trainer = VQATrainer(cfg, interp, device=dev)
    served_lp = observe_log_probability(trainer)
    span = Spans(ctx.trace)
    loader = TimedLoader(BatchLoader(
        [ProgramDataset(qs, ont) for qs in files],
        ProgramCompiler(ont, object_num=O, rel_slots=cfg.tpu.rel_table_size,
                        option_pad_ladder=cfg.tpu.option_pad_ladder),
        Scenes(world), cfg.test_batch_size, O, shuffle=False), span)
    for _ in range(2):
        trainer.predict(loader, params, io.StringIO())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    tracer = Trace(ctx.obs["scratch"]) if ctx.trace else None
    if tracer is not None:
        tracer.prime()
    ctx.setup_done()

    loader.wait_s, loader.batches = 0.0, 0
    passes, pass_s, start = 0, [], time.perf_counter()
    while True:
        if (tracer is not None and tracer.prof is None
                and time.perf_counter() - start >= ctx.seconds - TRACE_SECONDS):
            tracer.start()
        t = time.perf_counter()
        with span("predict"):
            preds = trainer.predict(loader, params, io.StringIO())
        pass_s.append(time.perf_counter() - t)
        passes += 1
        if time.perf_counter() - start >= ctx.seconds:
            break
    window_s = time.perf_counter() - start
    ctx.note(f"window: {passes} passes in {window_s:.2f} s; first passes "
             f"{[round(s, 3) for s in pass_s[:4]]} s, "
             f"median {sorted(pass_s)[len(pass_s) // 2]:.3f} s")
    if tracer is not None:
        tracer.stop()
    per_pass = sum(len(qs) for qs in files)
    flop = sum(_batch_flop(cfg, world, b) for b in batches_of(files, cfg.test_batch_size))
    ctx.attempted, ctx.failed = per_pass, per_pass - len(preds)
    ctx.obs.update(questions=passes * per_pass, window_s=window_s, passes=passes,
                   loader_wait_s=loader.wait_s, loader_batches=loader.batches, tracer=tracer,
                   cfg=cfg, model_flop=passes * flop)
    answers = {p["questionId"]: (p["prediction"] if isinstance(p["prediction"], list)
                                 else [p["prediction"]]) for p in preds}
    del trainer, params
    return functools.partial(judge, ctx, world, files, answers, served_lp, values)


def observe_log_probability(trainer) -> dict:
    """Question id -> (log-probability tensor of its batch, row) as the
    trainer's eval loop (``_eval_chunked``, which ``predict`` reads) made
    it, kept on the device; the wrapper passes everything through
    unchanged."""
    seen: dict = {}
    chunked = trainer._eval_chunked

    def observed(loader, params):
        for batch, out in chunked(loader, params):
            lp = out["log_probability"]
            for row, (qid, m) in enumerate(zip(batch.compiled.question_ids,
                                               batch.compiled.question_mask)):
                if m > 0:
                    seen[qid] = (lp, row)
            yield batch, out

    trainer._eval_chunked = observed
    return seen


def _batch_flop(cfg, world, questions) -> float:
    """A loader batch's model FLOP: each scene once, each question's own."""
    flop = 0.0
    for im in {q["imageId"] for q in questions}:
        flop += work.image_flop(cfg, int(world.n[world._index[im]]))
    for q in questions:
        n = int(world.n[world._index[q["imageId"]]])
        flop += work.question_flop(cfg, n, mix.relation_tokens(q), mix.calibrator_steps(q))
    return flop


def judge(ctx: Ctx, world, files, answers, served_lp, values, control: bool = False) -> None:
    """The widest served gap (``check.served_gap``) over the sampled
    batches' questions, against the reference's scores of each batch on
    the shared-image route. With ``control`` the reference at TF32 serves
    in the program's place."""
    batches = batches_of(files, ctx.spec["batch"])
    rng = np.random.default_rng([ctx.seed, 7])
    pick = sorted(rng.choice(len(batches), min(len(batches), ctx.spec["check"]["batches"]),
                             replace=False).tolist())
    ref = Reference(ctx.config_file, values, ctx.device)
    gaps, answer, checked = [], 0.0, 0
    for b in pick:
        qs = batches[b]
        with precision(tf32=False):
            scores = ref.option_scores(qs, world, shared=True)
        if control:
            with precision(tf32=True):
                low = ref.option_scores(qs, world, shared=True)
            got = [([o for o, v in s.items() if v == max(s.values())],
                    s["yes"] if set(s) == {"yes", "no"} else list(s.values())) for s in low]
        else:
            got = []
            for q in qs:
                lp, row = served_lp.get(q["question_id"], (None, None))
                got.append((answers.get(q["question_id"], []),
                            lp[row].double().cpu().numpy() if lp is not None else []))
        gaps += [served_gap(a, lp, s) for (a, lp), s in zip(got, scores)]
        answer = max([answer] + [answer_gap(a, s) for (a, _), s in zip(got, scores)])
        checked += len(qs)
    ctx.note(f"{'control' if control else 'program'} gaps: {sum(g > 0 for g in gaps)} of "
             f"{len(gaps)} nonzero, widest {[float(g) for g in sorted(gaps)[-3:]]}, "
             f"mean {float(np.mean(gaps)) if gaps else None!r}, "
             f"widest answer gap {float(answer)!r}")
    ctx.check("served_gap", max(gaps, default=float("inf")), ctx.spec["check"]["served_gap"])
    ctx.obs["checked"] = checked
