"""The manifest keeps to the benchmark's contract, and the harness is driven
by data: a configuration, a cell or a per-layer metric is added by adding
files, which the harness finds by the names in ``BENCHMARK.json``."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"] and M["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
        assert w["config"] in {c["name"] for c in M["configs"]}
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(M)) <= 64 * 1024


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        # every cell that reports a per-layer metric reports the metric it moves
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in M["workloads"]:
        reported = harness.metrics_of(M, w["name"], trace=False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.metrics_of(M, w["name"], trace=True)


def test_every_name_has_its_file():
    for w in M["workloads"]:
        path = os.path.join(BENCH, "workloads", f"{w['name']}.json")
        spec = json.load(open(path))
        assert os.path.exists(os.path.join(BENCH, "paths", f"{spec['path']}.py"))
        assert spec["check"], w["name"]
    for m in M["end_to_end"] + M["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py")), m["name"]


def test_the_result_line_has_the_contract_keys(tmp_path):
    from benchmark.tests.tiny import run_tiny

    out = run_tiny(tmp_path, "cur5-train-shuffled", seconds=0.5)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cur5-train-shuffled",
                          "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_a_cell_a_config_and_a_metric_are_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a cell and a per-layer
    metric by new files and new manifest entries only; a tiny run of the new
    cell in a fresh interpreter reads the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads(json.dumps(M))
    cfg = dict(m["configs"][0], name="dfol-cur5-copy", file="benchmark/configs/dfol-cur5-copy.yaml")
    shutil.copy(root / m["configs"][0]["file"], root / cfg["file"])
    m["configs"].append(cfg)
    base = harness.cell_entry(M, "cur5-train-shuffled")
    m["workloads"].append(dict(base, name="cur5-copy-train", config="dfol-cur5-copy"))
    shutil.copy(root / "benchmark/workloads/cur5-train-shuffled.json",
                root / "benchmark/workloads/cur5-copy-train.json")
    for e in m["end_to_end"]:
        if e["name"] == "train_questions_per_s":
            e["workloads"].append("cur5-copy-train")
    m["per_layer"].append({"name": "train.batches", "unit": "batches", "better": "higher",
                           "source": "program_counter", "layer": "data loader",
                           "moves": "train_questions_per_s", "workloads": ["cur5-copy-train"]})
    (root / "benchmark/metrics/train.batches.py").write_text(
        "def read(obs):\n    return obs.get('loader_batches')\n")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(root)!r}, {ROOT!r}]\n"
        "from benchmark import harness\n"
        "from benchmark.tests.tiny import tiny_spec, tiny_config\n"
        "from benchmark.run import execute\n"
        f"assert harness.BENCH_DIR == {str(root / 'benchmark')!r}\n"
        "man = harness.load_manifest()\n"
        "ctx = harness.Ctx(cell='cur5-copy-train', spec=tiny_spec('cur5-copy-train'),\n"
        f"    config_file=tiny_config({str(tmp_path)!r}, 'cur5-copy-train'), seed=5,\n"
        "    seconds=0.5, trace=False, device='cpu')\n"
        f"ctx.obs['scratch'] = {str(tmp_path)!r}\n"
        "out = execute(ctx, man, 1)\n"
        "names = [m['name'] for m in harness.metrics_of(man, 'cur5-copy-train', True)]\n"
        "assert 'train.batches' in names, names\n"
        "out['layer'] = harness.read_metric('train.batches', ctx.obs)\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and "train_questions_per_s" in out["metrics"] and out["layer"] > 0
