"""Training: one ``VQATrainer.train`` call over a shuffled question set.

The trainer is handed a feed (``Feed``) in place of its loader, which
draws the port's shuffled ``BatchLoader`` and orders set-up and window
inside the one ``train`` call (``train`` builds its optimizer and its CUDA
graphs per call, so set-up and window share it):

1. Warm-up: for every chunk length k = 1..``train_chunk`` and every group
   key (spec, layout, object shape), two runs of k batches (one batch of
   the key, repeated), so that every chunk the window can form has run
   eagerly and been captured; the last run is a whole chunk, which closes
   itself. The feed then waits for the trainer to take every warm-up step
   and the device to drain.
2. The checked steps, on the path the window takes: the start state is put
   back in place, at the addresses the CUDA graphs read (the initial
   weights copied into the parameters, Adam's state zeroed as before its
   first step, the dropout generator seeded as ``train`` seeded it). Then
   three steps: a group of one batch (the one-step path) and a group of
   two (a replay of the captured two-step graph), each closed by a batch
   of another spec. The feed waits at step boundaries for the trainer
   (``global_step``) to read the optimizer's state after the first of them
   and the parameters after the third (before the next step runs).
3. The window: the loader's own shuffled passes, one after another, until
   ``--seconds`` have gone by; its end is the end of ``train``.

The optimizer is observed by wrapping the trainer module's
``build_optimizer`` for the call, and the step losses and the dropout
generator by wrapping the trainer's ``_train_groups``: both pass everything
through unchanged.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List

import torch

from benchmark import weights, work
from benchmark.harness import Ctx
from benchmark.reference.check import Reference, leaf_gaps, moving_leaves, precision
from benchmark.reference.ontology import GQAOntology as RefOntology
from benchmark.trace import Spans, Trace
from benchmark.traffic import mix

TRACE_SECONDS = 3.0  # the traced slice: the window's last seconds
CHECKED_STEPS = 3


class Feed:
    """The iterable ``VQATrainer.train`` takes as its loader (module
    docstring). ``reset()`` and ``probe(step)`` are called on the feed's
    thread once the trainer has taken every step before and the device has
    drained; ``probe``'s ``step`` counts the checked steps."""

    def __init__(self, loader, trainer, group_key, n_keys: int, chunk: int, seconds: float,
                 reset, probe, span, on_window=None, batch_flop=None, note=None):
        self.loader, self.trainer, self.key, self.n_keys = loader, trainer, group_key, n_keys
        self.note = note or (lambda msg: None)
        self.chunk, self.seconds, self.reset, self.probe, self.span = (chunk, seconds, reset,
                                                                       probe, span)
        self.on_window, self.batch_flop = on_window, batch_flop
        self.window_flop = 0.0
        self.checked: List[list] = []  # the question ids of the checked steps' batches
        self.checked_from = None  # the trainer's global step of the first checked step
        self.window_start = None
        self.window_questions = 0
        self.wait_s, self.batches = 0.0, 0
        self._stock: Dict[tuple, list] = {}
        self._it = None

    def __len__(self):
        return len(self.loader)

    def _next(self):
        t = time.perf_counter()
        with self.span("loader"):
            while True:
                if self._it is None:
                    self._it = iter(self.loader)
                try:
                    b = next(self._it)
                    break
                except StopIteration:  # the next pass
                    self._it = None
        self.wait_s += time.perf_counter() - t
        self.batches += 1
        return b

    def _take(self, key=None, avoid=None, terminal=None):
        """A batch of group key ``key`` (any key but ``avoid``; a question
        terminal other than ``terminal``), from stock or the loader;
        batches of other keys go to stock."""
        def fits(k, b):
            return ((key is None or k == key) and k != avoid
                    and (terminal is None or b.spec.terminal_op != terminal))

        for k, stock in self._stock.items():
            if stock and fits(k, stock[0]):
                return stock.pop(0)
        while True:
            b = self._next()
            k = self.key(b)
            if fits(k, b):
                return b
            self._stock.setdefault(k, []).append(b)

    def _wait_steps(self, n: int) -> None:
        while self.trainer.global_step < n:
            time.sleep(0.0005)
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def __iter__(self):
        # 1. warm-up: two runs of every length per key, the last a whole chunk,
        # each run one batch of the key repeated (the steps are set-up's, so
        # they need not differ; the loader's cost is the window's); every
        # key (one per question file) is drawn from the loader first
        pool = {}
        while len(pool) < self.n_keys:
            b = self._next()
            pool.setdefault(self.key(b), b)
        keys = list(pool)
        steps = 0
        for k in range(1, self.chunk + 1):
            for _ in range(2):
                for key in keys:
                    for _ in range(k):
                        yield pool[key]
                        steps += 1
        self._wait_steps(steps)
        self.note(f"warm-up: {steps} steps over {len(keys)} keys")
        # 2. the checked steps from the start state: [b1], [b2, b3], each group
        # closed by another key; b2 and b3 are questions, not statements (whose
        # loss the random weights saturate at 0), so that the chunk's steps
        # move the weights
        self.reset()
        self.checked_from = steps
        b1 = self._take()
        b2 = self._take(avoid=self.key(b1), terminal="end")
        b3 = self._take(key=self.key(b2))
        b4 = self._take(avoid=self.key(b2))
        self.checked = [list(b.compiled.question_ids) for b in (b1, b2, b3)]
        yield b1
        yield b2
        self._wait_steps(steps + 1)
        self.probe(1)
        yield b3
        yield b4
        self._wait_steps(steps + CHECKED_STEPS)
        self.probe(CHECKED_STEPS)
        self.note("checked steps taken")
        # 3. the window: the loader's shuffled passes until the deadline
        self._stock.clear()
        self._it = None
        self.wait_s, self.batches = 0.0, 0
        self.window_start = time.perf_counter()
        if self.on_window is not None:
            self.on_window()
        while time.perf_counter() - self.window_start < self.seconds:
            b = self._next()
            self.window_questions += b.batch_size
            if self.batch_flop is not None:
                self.window_flop += self.batch_flop(b)
            yield b


def run(ctx: Ctx):
    from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
    from dfol_vqa_tpu_torch.config import Config
    from dfol_vqa_tpu_torch.data.dataset import ProgramDataset
    from dfol_vqa_tpu_torch.data.loader import BatchLoader
    from dfol_vqa_tpu_torch.data.transfer import group_key
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology
    from dfol_vqa_tpu_torch.train import trainer as trainer_module

    from benchmark.scenes import Scenes

    spec, dev = ctx.spec, torch.device(ctx.device)
    cfg = Config.from_yaml(ctx.config_file)
    ont = GQAOntology()
    O = cfg.tpu.max_object_num
    world = mix.make_world(RefOntology(), spec, O, cfg.box_features_dim, ctx.seed, ctx.device)
    files = mix.train_files(world, spec, ctx.seed)
    ctx.note(f"{sum(map(len, files))} questions in {len(files)} files on {len(world.ids)} scenes")
    by_id = {q["question_id"]: q for qs in files for q in qs}
    if dev.type == "cuda":  # the peak read after the window is the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    interp = Interpreter(cfg, ont)
    params = interp.init_params(torch.Generator().manual_seed(0), dev)
    values = weights.draw(params, ctx.seed, dev)
    initial = {k: v.clone() for k, v in values.items()}
    trainer = trainer_module.VQATrainer(cfg, interp, device=dev)
    loader = BatchLoader([ProgramDataset(qs, ont) for qs in files],
                         ProgramCompiler(ont, object_num=O, rel_slots=cfg.tpu.rel_table_size,
                                         option_pad_ladder=cfg.tpu.option_pad_ladder),
                         Scenes(world), cfg.train_batch_size, O, shuffle=True, seed=ctx.seed)

    seen: Dict[str, object] = {"opts": [], "losses": [], "replays": []}
    probed: Dict[int, Dict[str, torch.Tensor]] = {}

    def replays() -> int:
        return sum(g.replays for g in trainer.graphs.graphs)

    def reset() -> None:
        """The start state again, in place (the CUDA graphs read these
        addresses): the initial weights, Adam's state as before its first
        step, the dropout generator as ``train`` seeded it."""
        opt = seen["opts"][-1]
        with torch.no_grad():
            for n, p in params.named_parameters():
                p.copy_(initial[n])
            for p in opt.trainable:
                for t in opt.adam.state.get(p, {}).values():
                    if torch.is_tensor(t):
                        t.zero_()
        seen["generator"].manual_seed(ctx.seed)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seen["replays"].append(replays())

    def probe(step: int) -> None:
        seen["replays"].append(replays())
        if step == 1:
            opt = seen["opts"][-1]
            names = {id(p): n for n, p in params.named_parameters()}
            # Adam's first moment after one step is 0.1 of the gradient it
            # got; an optimizer that never stepped holds none (a zero gradient)
            probed[1] = {names[id(p)]: opt.adam.state[p]["exp_avg"].detach() / 0.1
                         if "exp_avg" in opt.adam.state.get(p, {}) else torch.zeros_like(p)
                         for p in opt.trainable}
        else:
            probed[step] = {n: p.detach().clone() for n, p in params.named_parameters()}

    tracer = Trace(ctx.obs["scratch"]) if ctx.trace else None
    if tracer is not None:
        tracer.prime()

    image_flop = {im: work.image_flop(cfg, int(world.n[i])) for i, im in enumerate(world.ids)}
    question_flop = {qid: work.question_flop(cfg, int(world.n[world._index[q["imageId"]]]),
                                             mix.relation_tokens(q), 0)
                     for qid, q in by_id.items()}

    def batch_flop(b) -> float:
        """A batch's forward FLOP, each scene once, times 3 for the
        backward of every (trainable) part."""
        ids = [i for i, m in zip(b.compiled.question_ids, b.compiled.question_mask) if m > 0]
        return 3.0 * (sum(image_flop[by_id[i]["imageId"]] for i in set(ids))
                      + sum(question_flop[i] for i in ids))

    feed = Feed(loader, trainer, group_key, len(files), max(1, cfg.tpu.train_chunk), ctx.seconds,
                reset, probe, Spans(ctx.trace), ctx.setup_done, batch_flop, ctx.note)

    def capture(*a, **k):
        opt = original(*a, **k)
        seen["opts"].append(opt)
        return opt

    groups = trainer._train_groups

    def observed(loader, state, opt, generator, *a, **k):
        seen["generator"] = generator
        for losses, counts in groups(loader, state, opt, generator, *a, **k):
            first = trainer.global_step  # the group's first step (train adds it after)
            if feed.checked_from is not None:
                seen["losses"] += [x.detach().clone() for i, x in enumerate(losses)
                                   if 0 <= first + i - feed.checked_from < CHECKED_STEPS]
            yield losses, counts

    failure: List[BaseException] = []

    def body() -> None:
        try:
            trainer.train(feed, None, params, seed=ctx.seed)
        except BaseException as e:  # re-raised on the main thread
            failure.append(e)

    original = trainer_module.build_optimizer
    trainer_module.build_optimizer = capture
    trainer._train_groups = observed
    # the trainer runs on a thread of its own, so that the profiler starts
    # and stops on this one (it must) for the window's last seconds
    worker = threading.Thread(target=body, name="bench-train")
    try:
        worker.start()
        while tracer is not None and worker.is_alive():
            if (feed.window_start is not None
                    and time.perf_counter() - feed.window_start >= ctx.seconds - TRACE_SECONDS):
                tracer.start()
                break
            time.sleep(0.01)
        worker.join()
    finally:
        trainer_module.build_optimizer = original
    if failure:
        raise failure[0]
    r = seen["replays"]
    ctx.note(f"checked steps: graph replays {r[1] - r[0]} in the first, {r[2] - r[1]} in the "
             f"second and third" if len(r) == 3 else "checked steps not taken")
    ctx.note(f"window: {feed.batches} batches, {feed.window_questions} questions; "
             f"graphs {trainer.train_graph_stats}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - feed.window_start
    if tracer is not None and tracer.prof is not None:
        tracer.stop()
    ctx.attempted = feed.window_questions
    ctx.obs.update(questions=feed.window_questions, window_s=window_s, tracer=tracer, cfg=cfg,
                   loader_wait_s=feed.wait_s, loader_batches=feed.batches,
                   model_flop=feed.window_flop)
    program = {"losses": [float(x) for x in seen["losses"][:CHECKED_STEPS]],
               "grad1": {k: v.cpu() for k, v in probed.get(1, {}).items()},
               "final": {k: v.cpu() for k, v in probed.get(CHECKED_STEPS, {}).items()}}
    batches = [[by_id[i] for i in ids] for ids in feed.checked]
    del trainer, params, probed
    return functools.partial(judge, ctx, world, batches, program, initial)


def judge(ctx: Ctx, world, batches, program, initial, control=None) -> None:
    """Each checked step's loss, the first gradient as the optimizer got
    it and the parameters' change after the three, against the
    reference's (``check.leaf_gaps``); leaves whose reference gradient is
    under a thousandth of the median leaf's are left out of the last two.
    ``control``: "tf32" puts the reference at TF32 in the program's place,
    "half_batch" the reference with half of each batch left out."""
    ref = Reference(ctx.config_file, initial, ctx.device)
    with precision(tf32=False):
        losses, grad1, final = ref.train_steps(batches, world, ctx.seed)
    if control:
        low = Reference(ctx.config_file, initial, ctx.device)
        with precision(tf32=control == "tf32"):
            l2, g2, f2 = low.train_steps(batches, world, ctx.seed, half=control == "half_batch")
        program = {"losses": l2, "grad1": g2, "final": f2}
    limits = ctx.spec["check"]
    if len(program["losses"]) < len(losses) or not program["grad1"] or not program["final"]:
        ctx.check("loss", float("inf"), limits["loss"])
        return
    keep = moving_leaves(grad1)
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program["losses"], losses))
    grad_gap, grad_at = leaf_gaps(program["grad1"], grad1, keep)
    change = {k: final[k] - initial[k] for k in keep}
    got = {k: program["final"][k].to(initial[k].device) - initial[k] for k in keep}
    change_gap, change_at = leaf_gaps(got, change, keep)
    ctx.note(f"{control or 'program'}: losses {program['losses']!r} vs "
             f"{losses!r}; grad gap {grad_gap!r} at {grad_at}; change gap {change_gap!r} at "
             f"{change_at}; {len(keep)} of {len(grad1)} leaves move")
    ctx.check("loss", loss_gap, limits["loss"])
    ctx.check("grad", grad_gap, limits["grad"])
    ctx.check("change", change_gap, limits["change"])
    ctx.obs["moving_leaves"] = len(keep)
