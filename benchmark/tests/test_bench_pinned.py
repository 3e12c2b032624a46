"""The reader of ``transfer.stage``'s ``pinned`` tag,
``metrics/transfer.pinned_batches.train.py``, on a synthetic span record and
a stub tracer: batches counted by the spans that end in the traced slice;
None without a tracer, off the training path, with a program that records
no spans, and with one whose spans carry no ``pinned`` tag."""

import os
import sys
from types import SimpleNamespace

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

from benchmark import harness  # noqa: E402
from dfol_vqa_tpu_torch.utils import profiling  # noqa: E402

NAME = "transfer.pinned_batches.train"
T0_S, WINDOW_S = 100.0, 1.0  # the traced slice: 100 s to 101 s on perf_counter


def sp(a_ms, b_ms, **tags):
    return ("transfer.stage", 7, int(T0_S * 1e9 + a_ms * 1e6), int(T0_S * 1e9 + b_ms * 1e6),
            tags)


# 4 of 4, 0 of 1 and 1 of 1 end in the slice: 5 of 6; the first ends before
# it and the last after it
RECORD = [sp(-30, -20, batches=2, pinned=0), sp(10, 20, batches=4, pinned=4),
          sp(300, 305, batches=1, pinned=0), sp(600, 605, batches=1, pinned=1),
          sp(995, 1010, batches=3, pinned=0)]


@pytest.fixture
def obs(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: list(RECORD))
    return {"path": "train", "tracer": SimpleNamespace(_t0=T0_S, window_s=WINDOW_S)}


def test_the_manifest_names_the_reader_for_the_training_cell():
    m = {x["name"]: x for x in harness.load_manifest()["per_layer"]}[NAME]
    assert m["workloads"] == ["cur5-train-shuffled"] and m["moves"] == "train_questions_per_s"
    assert m["layer"] == "data loader" and m["unit"] == "%" and m["better"] == "higher"


def test_reader_on_a_synthetic_record(obs):
    assert harness.read_metric(NAME, obs) == pytest.approx(500.0 / 6, rel=1e-12)


def test_reader_is_none_without_a_tag_to_read(obs, monkeypatch):
    assert harness.read_metric(NAME, dict(obs, tracer=None)) is None
    assert harness.read_metric(NAME, dict(obs, path="eval")) is None
    untagged = [(n, t, a, b, {"batches": x["batches"]}) for n, t, a, b, x in RECORD]
    monkeypatch.setattr(profiling, "recorded", lambda: untagged)
    assert harness.read_metric(NAME, obs) is None  # a program without the tag
    monkeypatch.delattr(profiling, "recorded")  # a program without the recorder
    assert harness.read_metric(NAME, obs) is None
