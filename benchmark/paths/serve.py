"""Online serving: ``ServingEngine.submit`` under an open-loop schedule.

Set-up builds the scenes and the window's requests from the seed, the
weights on the device, the engine, and warms up every canonical spec the
window's requests use at every batch rung (``ServingEngine.warmup``) with a
stand-in of each request structure, so that the window's own questions
still meet an empty plan cache. The window submits each request at its due
time from one thread; a request's latency runs from when it was due to the
host readback of its answer (the future's completion), so a stall counts
against every request it delays. Then the reference scores a sample of the
finished requests, drawn from the seed and holding the longest programs.
"""

from __future__ import annotations

import copy
import functools
import threading
import time
from typing import List, Optional

import numpy as np

from benchmark import weights, work
from benchmark.harness import Ctx
from benchmark.reference.check import Reference, answer_gap, precision, served_gap
from benchmark.reference.ontology import GQAOntology as RefOntology
from benchmark.trace import Spans, Trace
from benchmark.traffic import mix

TRACE_SECONDS = 3.0  # the traced slice: the window's last seconds of arrivals
# the batch rungs warmed up: below the knee a spec's group holds a few rows
# (``serve.rows_per_group``); a larger rung meets eager PyTorch, which
# compiles nothing, in the window
WARM_RUNGS = (1, 2, 4, 8)


def stand_in(q: dict) -> dict:
    """A request of the same structure (the same canonical spec) that the
    window does not send: the plan cache keys the whole question."""
    out = copy.deepcopy(q)
    out["question_id"] = "warmup-" + str(q["question_id"])
    return out


def structure(q: dict) -> str:
    """What decides a request's spec: terminal, op sequence per branch, the
    queried category or option count."""
    last = q["program"]["last_op"]
    ops = "|".join(",".join(op["operator"] for op in br) for br in q["program"]["branches"])
    arg = ""
    if last["operator"] in ("query_attr", "all_same", "all_different", "two_same",
                            "two_different"):
        arg = str(last["arguments"][0])
    elif last["operator"] in ("choose_attr", "verify_attrs"):
        arg = str(len(last["arguments"][0]))
    return f"{last['operator']}:{ops}:{arg}"


def run(ctx: Ctx):
    """Set up, warm up and serve the window; returns the judge, which the
    caller runs once the program's state is freed (``judge(control)``)."""
    import torch
    from dfol_vqa_tpu_torch.config import Config
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.serve import ServingEngine

    from benchmark.scenes import Scenes

    spec, dev = ctx.spec, torch.device(ctx.device)
    cfg = Config.from_yaml(ctx.config_file)
    ont = GQAOntology()
    world = mix.make_world(RefOntology(), spec, cfg.tpu.max_object_num, cfg.box_features_dim,
                           ctx.seed, ctx.device)
    requests = mix.serve_requests(world, spec, ctx.seconds, ctx.seed)
    ctx.note(f"{len(requests)} requests on {len(world.ids)} scenes")
    if dev.type == "cuda":  # the peak read after the window is the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = Interpreter(cfg, ont).init_params(torch.Generator().manual_seed(0), dev)
    values = weights.draw(params, ctx.seed, dev)
    eng = ServingEngine(cfg, ont, params, features=Scenes(world), device=dev, **spec["engine"])
    served_lp = observe_log_probability(eng, Interpreter)
    try:
        reps = {}
        for _, q in requests:
            reps.setdefault(structure(q), stand_in(q))
        warm = eng.warmup(list(reps.values()), batch_sizes=WARM_RUNGS)
        ctx.note(f"warm-up: {warm['specs']} specs x rungs {WARM_RUNGS}, {warm['runs']} runs in "
                 f"{warm['seconds']:.1f} s")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        span = Spans(ctx.trace)
        tracer = Trace(ctx.obs["scratch"]) if ctx.trace else None
        if tracer is not None:
            tracer.prime()
        ctx.setup_done()

        before = dict(eng.stats)
        lat, served, submit_s, late_s, rungs = open_loop(
            eng, world, requests, span, tracer, max(0.0, ctx.seconds - TRACE_SECONDS))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if tracer is not None and tracer.prof is not None:
            tracer.stop()
    finally:
        Interpreter.forward = served_lp.pop("__forward__")
    after = dict(eng.stats)
    n = len(requests)
    ctx.attempted = n
    ctx.failed = sum(a is None for a in served)
    big = sum(1 for r in rungs if r > max(WARM_RUNGS))
    ok = sorted(x for x in lat if x != float("inf"))
    quarter = [sorted(lat[k * n // 4:(k + 1) * n // 4]) for k in range(4)]
    ctx.note("median latency by quarter of the window (ms): "
             + ", ".join(f"{q[len(q) // 2]:.1f}" for q in quarter if q))
    ctx.note(f"{len(ok)}/{n} answered, median {ok[len(ok) // 2] if ok else None!r} ms, "
             f"latest submit {max(late_s) * 1e3:.2f} ms late, "
             f"{after['batches'] - before['batches']} groups, {big} requests in groups past "
             f"rung {max(WARM_RUNGS)}")
    obs = ctx.obs
    obs.update(latencies_ms=lat, window_s=ctx.seconds, submit_s=submit_s, late_s=late_s,
               requests=after["requests"] - before["requests"],
               batches=after["batches"] - before["batches"], tracer=tracer, cfg=cfg)
    obs["model_flop"] = sum(
        _request_flop(cfg, world, q) for (_, q), a in zip(requests, served) if a is not None)
    eng.stop()
    return functools.partial(judge, ctx, world, requests, served, served_lp, values)


def observe_log_probability(eng, interpreter_class) -> dict:
    """Question id -> (log-probability tensor of its group, row): what each
    served answer was decided from, kept on the device as the step made
    it. The interpreter's ``forward`` (class-wide, restored from the
    ``"__forward__"`` entry after the window) leaves its output with the
    thread, and the engine's ``_dispatch`` pairs it with the group's
    requests; both pass everything through unchanged."""
    seen: dict = {"__forward__": interpreter_class.forward}
    local = threading.local()
    forward, dispatch = interpreter_class.forward, eng._dispatch

    def observed_forward(self, *a, **k):
        out = forward(self, *a, **k)
        local.lp = out["log_probability"]
        return out

    def observed_dispatch(key, group, *a, **k):
        res = dispatch(key, group, *a, **k)
        for row, r in enumerate(group):
            seen[r.question["question_id"]] = (local.lp, row)
        return res

    interpreter_class.forward = observed_forward
    eng._dispatch = observed_dispatch
    return seen


def open_loop(eng, world, requests, span, tracer=None, trace_from: float = 0.0):
    """Submit each request at its due time from this thread; returns
    (latency ms from due to readback, inf where missing; answers, None
    where missing; submit seconds; how late each submit started; the batch
    rung each answered request rode in). Waits for
    the answers up to a minute past the last due time. ``tracer`` starts
    ``trace_from`` seconds into the schedule."""
    n = len(requests)
    done: List[Optional[float]] = [None] * n
    answers: List[Optional[list]] = [None] * n
    lock = threading.Lock()

    def finish(i: int, fut) -> None:
        t = time.perf_counter()
        try:
            res = fut.result()
        except Exception:  # the request failed: it stays missing
            return
        with lock:
            done[i], answers[i] = t, res.answers
            rungs.append(res.batch_size)

    submit_s, late_s, futures, rungs = [], [], [], []
    start = time.perf_counter()
    due = [start + t for t, _ in requests]
    for i, (_, q) in enumerate(requests):
        if tracer is not None and tracer.prof is None and due[i] - start >= trace_from:
            tracer.start()
        with span("wait_schedule"):
            wait = due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        scene, mask = world.scene(q["imageId"])
        t1 = time.perf_counter()
        late_s.append(t1 - due[i])
        try:
            with span("submit"):
                fut = eng.submit(q, scene, mask)
        except Exception:  # refused: missing
            continue
        submit_s.append(time.perf_counter() - t1)
        futures.append(fut)
        fut.add_done_callback(functools.partial(finish, i))
    deadline = time.perf_counter() + 60.0
    for fut in futures:
        try:
            fut.exception(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:  # a request not back a minute past the close: missing
            pass
    with lock:
        lat = [(d - due[i]) * 1e3 if d is not None else float("inf") for i, d in enumerate(done)]
        return lat, list(answers), submit_s, late_s, rungs


def _request_flop(cfg, world, q) -> float:
    n = int(world.n[world._index[q["imageId"]]])
    return (work.image_flop(cfg, n)
            + work.question_flop(cfg, n, mix.relation_tokens(q), mix.calibrator_steps(q)))


def sample(requests, served, k: int, seed: int) -> List[int]:
    """``k`` finished requests drawn from the seed, the longest programs
    (most ops) among them first."""
    fin = [i for i, a in enumerate(served) if a is not None]
    if not fin:
        return []
    length = lambda i: sum(len(b) for b in requests[i][1]["program"]["branches"])  # noqa: E731
    longest = max(length(i) for i in fin)
    must = [i for i in fin if length(i) == longest][: max(1, k // 8)]
    rng = np.random.default_rng([seed, 7])
    rest = [i for i in fin if i not in set(must)]
    pick = rng.choice(len(rest), min(len(rest), k - len(must)), replace=False) if rest else []
    return sorted(must + [rest[j] for j in pick])


def judge(ctx: Ctx, world, requests, served, served_lp, values, control: bool = False) -> None:
    """The widest served gap (``check.served_gap``: answers and the
    log-probabilities they came from, against the reference's) over the
    sample. With ``control`` the reference at TF32 serves in the program's
    place."""
    idx = sample(requests, served, ctx.spec["check"]["requests"], ctx.seed)
    ref = Reference(ctx.config_file, values, ctx.device)
    qs = [requests[i][1] for i in idx]
    with precision(tf32=False):
        scores = ref.option_scores(qs, world)
    if control:
        with precision(tf32=True):
            low = ref.option_scores(qs, world)
        got = [(_argmax_answers(s), list(s.values()) if set(s) != {"yes", "no"} else s["yes"])
               for s in low]
    else:
        got = []
        for i in idx:
            lp, row = served_lp[requests[i][1]["question_id"]]
            got.append((served[i], lp[row].double().cpu().numpy()))
    gaps = [served_gap(a, lp, s) for (a, lp), s in zip(got, scores)]
    answer = max((answer_gap(a, s) for (a, _), s in zip(got, scores)), default=0.0)
    gap = max(gaps, default=float("inf"))
    ctx.note(f"{'control' if control else 'program'} gaps: {sum(g > 0 for g in gaps)} of "
             f"{len(gaps)} nonzero, widest {[float(g) for g in sorted(gaps)[-3:]]}, "
             f"mean {float(np.mean(gaps)) if gaps else None!r}, "
             f"widest answer gap {float(answer)!r}")
    ctx.check("served_gap", gap, ctx.spec["check"]["served_gap"])
    ctx.obs["checked"] = len(idx)


def _argmax_answers(scores) -> list:
    best = max(scores.values())
    return [o for o, v in scores.items() if v == best]
