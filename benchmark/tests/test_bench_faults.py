"""Each fault a cell can have, planted under the timed path, turns ``correct``
false: the harness runs whole (on the CPU, at tiny widths, with no look for
a card) while the program is broken underneath."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.tests.tiny import run_tiny  # noqa: E402

from dfol_vqa_tpu_torch.models.interpreter import Interpreter  # noqa: E402
from dfol_vqa_tpu_torch.train.optim import Optimizer  # noqa: E402
from dfol_vqa_tpu_torch.train.trainer import VQATrainer  # noqa: E402


def _altered_answers(monkeypatch):
    """The answer flags inverted where the executor produces them."""
    original = Interpreter._answers_and_metrics

    def altered(self, *a, **k):
        out = original(self, *a, **k)
        out["answer_flags"] = ~out["answer_flags"]
        return out

    monkeypatch.setattr(Interpreter, "_answers_and_metrics", altered)


@pytest.mark.parametrize("cell", ["cur7-serve-rel", "cur7-eval-file", "cur5-train-shuffled"])
def test_a_sound_run_is_correct(tmp_path, cell):
    assert run_tiny(tmp_path, cell, seconds=0.5)["correct"]


@pytest.mark.parametrize("cell", ["cur7-serve-rel", "cur7-eval-file"])
def test_an_altered_answer_fails(tmp_path, monkeypatch, cell):
    _altered_answers(monkeypatch)
    assert not run_tiny(tmp_path, cell, seconds=0.5)["correct"]


def test_a_step_that_leaves_the_state_unchanged_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(Optimizer, "step", lambda self, valid=None: None)
    out = run_tiny(tmp_path, "cur5-train-shuffled", seconds=0.5)
    assert not out["correct"] and out["checks"]["change"]["value"] >= 0.99


def test_half_the_batch_left_out_fails(tmp_path, monkeypatch):
    """Half of each batch's questions masked out, the loss the mean over the
    rest."""
    original = VQATrainer._grads

    def half(self, params, objects, obj_mask, arrays, spec, *a, **k):
        qm = arrays["question_mask"]
        keep = (torch.arange(qm.shape[0], device=qm.device) < qm.shape[0] // 2).to(qm.dtype)
        return original(self, params, objects, obj_mask, {**arrays, "question_mask": qm * keep},
                        spec, *a, **k)

    monkeypatch.setattr(VQATrainer, "_grads", half)
    out = run_tiny(tmp_path, "cur5-train-shuffled", seconds=0.5)
    assert not out["correct"] and out["checks"]["loss"]["value"] > 1e-3


def test_the_reference_with_half_a_batch_fails(tmp_path):
    """The planted fault of ``control.py --fault half_batch``: the reference
    put in the program's place with half of each batch left out."""
    out = run_tiny(tmp_path, "cur5-train-shuffled", seconds=0.5, control="half_batch")
    assert not out["correct"] and out["checks"]["loss"]["value"] > 1e-3


def test_other_dropout_masks_in_a_chunk_fail(tmp_path, monkeypatch):
    """A chunk's steps (the path of the CUDA graphs' replays) drawing their
    dropout masks from a generator other than the run's."""
    original = VQATrainer._train_chunk

    def other_masks(self, params, opt, group, objects, obj_mask, arrays, generator):
        other = torch.Generator(device=objects.device).manual_seed(12345)
        return original(self, params, opt, group, objects, obj_mask, arrays, other)

    monkeypatch.setattr(VQATrainer, "_train_chunk", other_masks)
    out = run_tiny(tmp_path, "cur5-train-shuffled", seconds=0.5)
    assert not out["correct"] and out["checks"]["loss"]["value"] > 1e-4
