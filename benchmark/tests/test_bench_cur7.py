"""The deployed stage's training cell, ``cur7-train-calib``: its manifest
entries resolve to their files, its two readers (``calib.enqueue_ms.train``,
``train.grad_params.train``) on a planted span record, and a tiny run of
the cell on the CPU that the check passes and the half-batch fault fails."""

import json
import os
import sys
from types import SimpleNamespace

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

from benchmark import harness  # noqa: E402
from dfol_vqa_tpu_torch.utils import profiling  # noqa: E402

CELL, CONFIG = "cur7-train-calib", "dfol-cur7"
NEW = ("calib.enqueue_ms.train", "train.grad_params.train")
T0_S, WINDOW_S = 50.0, 1.0  # S: 50 s to 51 s on perf_counter
TRAINER = 7
GRAD, ALL = 148_404, 2_481_548  # cur7's calibrator and every parameter element


def at(ms):
    return int(T0_S * 1e9 + ms * 1e6)


def sp(name, a, b, **tags):
    return (name, TRAINER, at(a), at(b), tags)


ELEMS = {"grad_elems": GRAD, "param_elems": ALL}
RECORD = [
    # calib.passes: 4 ms of one that starts before S, 6 and 5 ms inside it,
    # 3 ms of one that ends after S (not counted): 18 ms over 3 spans
    sp("calib.passes", -2, 4, steps=24),
    sp("calib.passes", 100, 106, steps=30),
    sp("calib.passes", 400, 405, steps=18),
    sp("calib.passes", 997, 1004, steps=24),
    # the steps around them; the replays ran no Python, so no calib.passes
    sp("train.step", -5, 10, steps=1, route="eager", **ELEMS),
    sp("train.step", 95, 120, steps=1, route="eager", **ELEMS),
    sp("train.step", 300, 302, steps=4, route="replay", **ELEMS),
    sp("train.step", 395, 410, steps=1, route="eager", **ELEMS),
    sp("train.step", 990, 1010, steps=1, route="eager", **ELEMS),
]


@pytest.fixture
def obs(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: list(RECORD))
    return {"path": "train", "tracer": SimpleNamespace(_t0=T0_S, window_s=WINDOW_S, kernels=[])}


def test_the_cell_and_its_configuration_resolve_to_their_files():
    m = harness.load_manifest()
    cell = harness.cell_entry(m, CELL)
    assert cell["config"] == CONFIG and cell["chips"] == 1
    config = harness.config_entry(m, CONFIG)
    assert config["file"] == "benchmark/configs/dfol-cur7.yaml"
    assert config["reduced"] == harness.config_entry(m, "dfol-cur5")["reduced"]
    assert os.path.exists(os.path.join(harness.ROOT, config["file"]))
    with open(os.path.join(BENCH, "workloads", f"{CELL}.json")) as f:
        spec = json.load(f)
    assert spec["path"] == "train" and len(spec["mix"]) == 6
    assert sum(n for _, _, n in spec["mix"]) == 5600
    assert [x["name"] for x in harness.metrics_of(m, CELL, trace=False)] == [
        "train_questions_per_s", "setup_s"]
    assert [x["name"] for x in harness.metrics_of(m, CELL, trace=True)] == list(NEW)
    for x in m["per_layer"]:
        assert (CELL in x.get("workloads", [])) == (x["name"] in NEW), x["name"]


def test_calib_enqueue_reads_ms_per_span_ending_in_the_slice(obs):
    assert harness.read_metric("calib.enqueue_ms.train", obs) == pytest.approx(18.0 / 3)


def test_grad_params_reads_the_trained_share_of_the_elements(obs):
    assert harness.read_metric("train.grad_params.train", obs) == pytest.approx(
        100.0 * GRAD / ALL)
    assert round(harness.read_metric("train.grad_params.train", obs), 2) == 5.98


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_is_none_without_its_spans(obs, monkeypatch, name):
    assert harness.read_metric(name, dict(obs, tracer=None)) is None
    assert harness.read_metric(name, dict(obs, path="eval")) is None
    # the parent's program: train.step spans without the tags, no calib.passes
    untagged = [(n, t, a, b, {k: v for k, v in tags.items() if k not in ELEMS})
                for n, t, a, b, tags in RECORD if n == "train.step"]
    monkeypatch.setattr(profiling, "recorded", lambda: untagged)
    assert harness.read_metric(name, obs) is None
    monkeypatch.delattr(profiling, "recorded")  # a program without the recorder
    assert harness.read_metric(name, obs) is None


def test_a_slice_of_replays_only_has_no_calibrator_enqueue(obs, monkeypatch):
    """A graph replay runs no Python, so no calib.passes ends in such a
    slice; the trained share still reads from its steps."""
    replays = [sp("train.step", 10 * i, 10 * i + 1, steps=8, route="replay", **ELEMS)
               for i in range(50)]
    monkeypatch.setattr(profiling, "recorded", lambda: replays)
    assert harness.read_metric("calib.enqueue_ms.train", obs) is None
    assert harness.read_metric("train.grad_params.train", obs) == pytest.approx(
        100.0 * GRAD / ALL)


def test_a_tiny_run_is_correct_and_the_half_batch_fault_is_not(tmp_path):
    from benchmark.tests.tiny import run_tiny

    out = run_tiny(tmp_path, CELL, seed=2147483659, seconds=0.5)
    assert out["correct"] and out["metrics"]["train_questions_per_s"]["value"] > 0
    fault = run_tiny(tmp_path, CELL, seed=2147483659, seconds=0.5, control="half_batch")
    assert not fault["correct"]
