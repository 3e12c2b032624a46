"""Isolation: nothing the benchmark runs imports JAX or the JAX package, and
the reference imports nothing of the program. Top-level module names (the
part before the first dot) are compared whole: ``dfol_vqa_tpu_torch``
begins with ``dfol_vqa_tpu`` and is not it."""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

JAX = {"jax", "jaxlib", "flax", "dfol_vqa_tpu"}


def _sources(sub=""):
    top = os.path.join(BENCH, sub)
    for dirpath, _, names in os.walk(top):
        if "tests" in os.path.relpath(dirpath, BENCH).split(os.sep):
            continue
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_of_the_benchmark_imports_jax(path):
    assert not set(_imported_tops(path)) & JAX


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    tops = set(_imported_tops(path))
    assert "dfol_vqa_tpu_torch" not in tops and not tops & JAX


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dfol_vqa_tpu_torch_fake", object())
    assert "dfol_vqa_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dfol_vqa_tpu.fake", object())
    assert "dfol_vqa_tpu.fake" in harness.forbidden_modules()


def test_a_run_loads_no_jax_in_a_fresh_interpreter(tmp_path):
    """A whole tiny training run (program, reference, metrics) in a fresh
    interpreter leaves no JAX module in ``sys.modules``."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark.tests.tiny import run_tiny\n"
        f"out = run_tiny({str(tmp_path)!r}, 'cur5-train-shuffled', seconds=0.5)\n"
        "bad = sorted({m for m in sys.modules if m.split('.', 1)[0] in "
        "('jax', 'jaxlib', 'flax', 'dfol_vqa_tpu')})\n"
        "print(json.dumps({'correct': out['correct'], 'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    last = res.stdout.strip().splitlines()[-1]
    assert '"bad": []' in last and '"correct": true' in last, last
