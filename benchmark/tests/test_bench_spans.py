"""The readers of the port's spans (``benchmark/spans.py`` and the seven
``metrics/*.train.py`` that use it) on a synthetic span record and a stub
tracer: each span clipped to the traced slice S, batches and steps counted
by the spans that end in S, the trainer's thread told by its
``train.step`` spans, kernels put on the spans' clock; None without a
tracer, off the training path, or with a program that records no spans."""

import os
import sys
from types import SimpleNamespace

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

from benchmark import harness, spans  # noqa: E402
from dfol_vqa_tpu_torch.utils import profiling  # noqa: E402

T0_S, WINDOW_S = 100.0, 1.0  # S: 100 s to 101 s on perf_counter
TRAINER, PRODUCER, WORKER = 11, 22, 33
OFF = 5_000_000_000  # the trace clock's offset from perf_counter_ns


def at(ms):
    """``ms`` milliseconds after the start of S, in perf_counter ns."""
    return int(T0_S * 1e9 + ms * 1e6)


def sp(name, thread, a, b, **tags):
    return (name, thread, at(a), at(b), tags)


RECORD = [
    # loader.scenes: 10 ms of the first inside S, 50, and 10 of one that ends
    # after S (not counted): 70 ms over 2 batches
    sp("loader.scenes", PRODUCER, -20, 10),
    sp("loader.scenes", PRODUCER, 100, 150),
    sp("loader.scenes", PRODUCER, 990, 1020),
    # assemble: programs 10 + batch 30 + batch 20, one batch span outside S:
    # 60 ms over 2 batches
    sp("loader.programs", PRODUCER, 200, 210),
    sp("loader.batch", PRODUCER, 210, 240),
    sp("loader.batch", PRODUCER, 300, 320),
    sp("loader.batch", PRODUCER, -50, -40),
    # stage: 40 ms for 4 batches, 5 ms for 1, 5 ms of a span ending after S:
    # 50 ms over 5 batches
    sp("transfer.stage", WORKER, 400, 440, batches=4),
    sp("transfer.stage", TRAINER, 500, 505, batches=1),
    sp("transfer.stage", WORKER, 995, 1010, batches=2),
    # steps: 5 + 20 + 10 ms counted over 4 + 1 + 2 steps, 2 ms of one that
    # ends after S: 37 ms over 7 steps, 4 of them replayed
    sp("train.step", TRAINER, -5, 5, steps=4, route="replay"),
    sp("train.step", TRAINER, 600, 620, steps=1, route="eager"),
    sp("train.step", TRAINER, 700, 710, steps=2, route="capture"),
    sp("train.step", TRAINER, 998, 1003, steps=3, route="replay"),
    # the trainer's waits: 20 + 20 ms; a wait on another thread is not its
    sp("transfer.wait", TRAINER, 5, 25),
    sp("transfer.wait", TRAINER, 580, 600),
    sp("transfer.wait", WORKER, 0, 1000),
    sp("train.readback", TRAINER, 1001, 1002),
]
# kernels (name, ts us, dur us, grid) at 10-15 ms and 585-600 ms, and one
# before S: the trainer waits with the card idle 5 + 10 + 5 ms of 1000
KERNELS = [("k", (at(ms) - OFF) / 1e3, dur * 1e3, (1,))
           for ms, dur in ((10, 5), (585, 15), (-30, 10))]

EXPECTED = {
    "loader.scenes_ms.train": 35.0,
    "loader.assemble_ms.train": 30.0,
    "transfer.stage_ms.train": 10.0,
    "train.data_wait_ms.train": 40.0 / 7,
    "train.enqueue_ms.train": 37.0 / 7,
    "train.graph_steps.train": 400.0 / 7,
    "device.idle_data_wait.train": 2.0,
}


@pytest.fixture
def obs(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: list(RECORD))
    monkeypatch.setattr(profiling, "trace_offset_ns", lambda base_ns=None: OFF)
    tracer = SimpleNamespace(_t0=T0_S, window_s=WINDOW_S, kernels=list(KERNELS))
    return {"path": "train", "tracer": tracer}


def test_the_manifest_names_each_reader_for_the_training_cell():
    m = {x["name"]: x for x in harness.load_manifest()["per_layer"]}
    for name in EXPECTED:
        assert m[name]["workloads"] == ["cur5-train-shuffled"]
        assert m[name]["moves"] == "train_questions_per_s"


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_record(obs, name):
    assert harness.read_metric(name, obs) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_is_none_without_spans_to_read(obs, monkeypatch, name):
    assert harness.read_metric(name, dict(obs, tracer=None)) is None
    assert harness.read_metric(name, dict(obs, path="eval")) is None
    monkeypatch.delattr(profiling, "recorded")  # a program without the recorder
    assert harness.read_metric(name, obs) is None


def test_clipping_and_counting_helpers():
    s = (at(0), at(1000))
    assert spans.ms(spans.clipped(RECORD, s, ("loader.scenes",))) == pytest.approx(70.0)
    assert len(spans.ending(RECORD, s, "loader.scenes")) == 2
    assert spans.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert spans.outside([(0, 10), (20, 30)], [(5, 25), (8, 9)]) == 10.0
    assert spans.per(1.0, 0) is None


def test_no_train_step_in_the_slice_gives_no_idle_share(obs, monkeypatch):
    monkeypatch.setattr(profiling, "recorded",
                        lambda: [r for r in RECORD if r[0] != "train.step"])
    assert harness.read_metric("device.idle_data_wait.train", obs) is None
    assert harness.read_metric("train.enqueue_ms.train", obs) is None
