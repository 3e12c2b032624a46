"""The reference's side of ``correct``: what the plain path says about the
questions a run answered and the steps it took.

* ``Reference.option_scores`` scores each question's answer options (its
  query options, or ``yes`` / ``no``) in log-probability, from the raw
  question and scene, question by question, or batch by batch where the
  program's route shares images (``shared=True``: the offline files).
* ``answer_gap`` is how far below the reference's best option the worst
  of the program's answers lies: 0 where the answers are the reference's,
  about the rounding where a near-tie flips, and large where an answer is
  wrong.
* ``Reference.train_steps`` repeats a run's first training steps from the
  same weights, batches and dropout seed, and ``leaf_gaps`` compares
  per-leaf norms as the contract says (the gap between the program's norm
  and the reference's, over the larger of the reference's leaf norm and
  its median leaf norm).

Nothing here imports the program: it reads the program's outputs only to
judge them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.config import Config
from benchmark.reference.features import Scenes
from benchmark.reference.interpreter import Interpreter, question_type_of
from benchmark.reference.ontology import GQAOntology
from benchmark.reference.optim import build_optimizer
from benchmark.reference.program_compiler import ProgramCompiler, batch_arrays
from benchmark.reference.types import QuestionType
from benchmark.weights import copy_into


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products with TF32 off (the reference), or on (its control)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def answer_gap(answers: Sequence[str], scores: Dict[str, float]) -> float:
    """best - score of the worst answer given; inf for no answer or one
    that is not an option."""
    if not answers:
        return math.inf
    best = max(scores.values())
    return max(best - scores.get(a, -math.inf) for a in answers)


def served_gap(answers: Sequence[str], lp, scores: Dict[str, float]) -> float:
    """How far one served question departs from the reference: the larger
    of its answer gap and the widest gap between the log-probabilities it
    was served from (``lp``: its option axis, or its log-probability of
    "yes") and the reference's, relative where they exceed 1 in size."""
    gap = answer_gap(answers, scores)
    want = [scores["yes"]] if set(scores) == {"yes", "no"} else list(scores.values())
    got = np.atleast_1d(np.asarray(lp, np.float64))[:len(want)]
    if len(got) < len(want):
        return math.inf
    for g, w in zip(got, want):
        if not (math.isfinite(g) and math.isfinite(w)):
            gap = max(gap, 0.0 if g == w else math.inf)
        else:
            gap = max(gap, abs(g - w) / max(1.0, abs(w)))
    return gap


def _binary_scores(lp: float) -> Dict[str, float]:
    p_no = -math.expm1(lp)
    return {"yes": lp, "no": math.log(p_no) if p_no > 0 else -math.inf}


class Reference:
    """The plain float32 path of one configuration with the run's weights,
    on ``device``."""

    def __init__(self, config_file: str, values: Dict[str, torch.Tensor], device):
        self.cfg = Config.from_yaml(config_file)
        self.ont = GQAOntology()
        self.interp = Interpreter(self.cfg, self.ont)
        self.device = torch.device(device)
        self.params = self.interp.init_params(torch.Generator().manual_seed(0), self.device)
        copy_into(self.params, values)
        tpu = self.cfg.tpu
        self.compiler = ProgramCompiler(self.ont, object_num=tpu.max_object_num,
                                        rel_slots=tpu.rel_table_size,
                                        option_pad_ladder=tpu.option_pad_ladder)

    def _tensors(self, cb, objects, obj_mask, img_index=None):
        arrays = batch_arrays(cb)
        if img_index is not None:
            arrays["img_index"] = img_index
        d = self.device
        arrays = {k: torch.as_tensor(np.asarray(v), device=d) for k, v in arrays.items()
                  if isinstance(v, np.ndarray)}
        return (torch.as_tensor(np.asarray(objects, np.float32), device=d),
                torch.as_tensor(np.asarray(obj_mask, np.float32), device=d), arrays)

    def _scores(self, spec, cb, lp: np.ndarray) -> List[Dict[str, float]]:
        qtype = question_type_of(spec.terminal_op)
        out = []
        for qi in range(len(cb.image_ids)):
            if qtype == QuestionType.QUERY:
                opts = cb.option_strings[qi]
                out.append({o: float(lp[qi, k]) for k, o in enumerate(opts)})
            else:
                out.append(_binary_scores(float(lp[qi])))
        return out

    @torch.no_grad()
    def option_scores(self, questions: Sequence[dict], world, shared: bool = False
                      ) -> List[Dict[str, float]]:
        """Per question: answer option -> log-probability. ``shared``: the
        questions are one loader batch on shared scenes (one terminal), run
        as the program's shared-image route runs them."""
        O = self.cfg.tpu.max_object_num
        if shared:
            spec, cb = self.compiler.compile(list(questions))
            objects, mask, img_index = Scenes(world).batch_unique(cb.image_ids, O)
            out = self.interp.forward(self.params, *self._tensors(cb, objects, mask, img_index),
                                      spec)
            return self._scores(spec, cb, out["log_probability"].double().cpu().numpy())
        scores = []
        for q in questions:
            spec, cb = self.compiler.compile([q])
            objects, mask = Scenes(world).batch([q["imageId"]], O)
            out = self.interp.forward(self.params, *self._tensors(cb, objects, mask), spec)
            scores += self._scores(spec, cb, out["log_probability"].double().cpu().numpy())
        return scores

    def train_steps(self, batches: Sequence[Sequence[dict]], world, seed: int,
                    half: bool = False
                    ) -> Tuple[List[float], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The program's first steps again: each batch (its questions in the
        program's order) through forward, loss over its real questions,
        backward and the optimizer, dropout masks drawn from a generator
        seeded as the trainer seeds its own. Returns (losses, the gradient
        of step 1 as the optimizer got it, the parameters after the last
        step), leaves by name. ``half`` plants a fault: each batch's second
        half of questions is left out and the loss is the mean over the
        rest."""
        cfg, O = self.cfg, self.cfg.tpu.max_object_num
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        opt = build_optimizer(cfg, self.params)
        opt.static_grads()
        names = {id(p): n for n, p in self.params.named_parameters()}
        losses, grad1 = [], {}
        for step, questions in enumerate(batches):
            spec, cb = self.compiler.compile(list(questions))
            objects, mask, img_index = Scenes(world).batch_unique(cb.image_ids, O)
            objects, mask, arrays = self._tensors(cb, objects, mask, img_index)
            if half:
                qm = arrays["question_mask"]
                arrays["question_mask"] = qm * (torch.arange(len(qm), device=qm.device)
                                                < len(qm) // 2).to(qm.dtype)
            for p in self.params.parameters():
                if p.grad is not None:
                    p.grad.zero_()
            out = self.interp.forward(self.params, objects, mask, arrays, spec,
                                      is_training=True, generator=gen)
            n = torch.clamp(torch.sum(arrays["question_mask"]), min=1.0)
            loss = out["loss"] / n
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if step == 0:
                grad1 = {names[id(p)]: opt.adam.state[p]["exp_avg"].detach() / 0.1
                         for p in opt.trainable}
        final = {n: p.detach().clone() for n, p in self.params.named_parameters()}
        return losses, grad1, final


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              keep: Optional[Sequence[str]] = None) -> Tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and the median
    leaf's; (gap, leaf name). ``keep`` limits the leaves compared."""
    names = sorted(keep if keep is not None else reference)
    ref = {n: float(torch.linalg.vector_norm(reference[n].double())) for n in names}
    med = float(np.median(list(ref.values())))
    worst, at = 0.0, ""
    for n in names:
        got = float(torch.linalg.vector_norm(program[n].double().to(reference[n].device)))
        gap = abs(got - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst:
            worst, at = gap, n
    return worst, at


def moving_leaves(grad: Dict[str, torch.Tensor], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient norm is at least ``share`` of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {n: float(torch.linalg.vector_norm(g.double())) for n, g in grad.items()}
    med = float(np.median(list(norms.values())))
    return sorted(n for n, v in norms.items() if v >= share * med)
