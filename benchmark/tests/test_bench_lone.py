"""The reader ``train.lone_replays.train`` on a planted span record: the
share of the lone training steps (``train.step`` spans with ``steps`` 1
that end in the traced slice S) that replayed a CUDA graph. 0 for the
parent's lone steps, which are tagged "eager"; 100 for replays; the chunk
spans around them (``steps`` >= 2) change nothing; None where no lone step
ends in S, without a tracer, off the training path, or with a program that
records no spans."""

import os
import sys
from types import SimpleNamespace

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

from benchmark import harness  # noqa: E402
from dfol_vqa_tpu_torch.utils import profiling  # noqa: E402

NAME = "train.lone_replays.train"
T0_S, WINDOW_S = 50.0, 1.0  # S: 50 s to 51 s on perf_counter
TRAINER = 7


def at(ms):
    return int(T0_S * 1e9 + ms * 1e6)


def sp(a, b, steps, route):
    return ("train.step", TRAINER, at(a), at(b), {"steps": steps, "route": route})


def lone(route):
    """Four lone steps: three end in S, one ends after it (not counted)."""
    return [sp(-5, 10, 1, route), sp(95, 120, 1, route), sp(395, 410, 1, route),
            sp(990, 1010, 1, "eager")]


CHUNKS = [sp(500 + 10 * i, 505 + 10 * i, 8, r)
          for i, r in enumerate(("replay", "capture", "warm", "eager"))]


def planted(monkeypatch, record):
    monkeypatch.setattr(profiling, "recorded", lambda: list(record))
    return {"path": "train", "tracer": SimpleNamespace(_t0=T0_S, window_s=WINDOW_S, kernels=[])}


def test_the_manifest_names_the_reader():
    m = {x["name"]: x for x in harness.load_manifest()["per_layer"]}[NAME]
    assert m["workloads"] == ["cur5-train-shuffled"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "%", "higher", "program_counter", "model step", "train_questions_per_s")
    assert os.path.exists(os.path.join(BENCH, "metrics", f"{NAME}.py"))


@pytest.mark.parametrize("chunks", [[], CHUNKS], ids=["alone", "among_chunks"])
@pytest.mark.parametrize("route,want", [("eager", 0.0), ("replay", 100.0)])
def test_reads_the_replayed_share_of_the_lone_steps(monkeypatch, chunks, route, want):
    obs = planted(monkeypatch, lone(route) + chunks)
    assert harness.read_metric(NAME, obs) == pytest.approx(want)


@pytest.mark.parametrize("chunks", [[], CHUNKS], ids=["alone", "among_chunks"])
def test_a_capture_among_replays_reads_two_of_three(monkeypatch, chunks):
    record = lone("replay")
    record[1] = sp(95, 120, 1, "capture")
    obs = planted(monkeypatch, record + chunks)
    assert harness.read_metric(NAME, obs) == pytest.approx(200.0 / 3)


def test_none_without_a_lone_step_in_the_slice(monkeypatch):
    obs = planted(monkeypatch, CHUNKS + [sp(990, 1010, 1, "replay")])
    assert harness.read_metric(NAME, obs) is None
    obs = planted(monkeypatch, lone("replay"))
    assert harness.read_metric(NAME, dict(obs, tracer=None)) is None
    assert harness.read_metric(NAME, dict(obs, path="eval")) is None
    monkeypatch.delattr(profiling, "recorded")  # a program without the recorder
    assert harness.read_metric(NAME, obs) is None
