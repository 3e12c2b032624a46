"""The port's preprocessing copies against the JAX package's modules.

* ``normalize``/``singularize_word`` on the words of
  ``tests/test_preprocess.py`` and the golden singularization table;
* ``GQAPreprocessor.parse_question`` on its semantic cases (and with
  ``discard_global``), and ``preprocess`` with segregation by terminal and
  by length: the same programs and output files;
* ``GQAProgramVerifier`` on valid and invalid programs: the same verdicts
  and the same ``ParserError`` messages;
* ``preprocess_cli.main`` of both packages on one GQA-style question file:
  the same JSON files and h5 files with equal arrays.
"""

import copy
import json
import os

import h5py
import numpy as np
import pytest

from dfol_vqa_tpu.compiler import normalize as jnormalize
from dfol_vqa_tpu.compiler import preprocess as jpreprocess
from dfol_vqa_tpu.compiler import preprocess_cli as jcli
from dfol_vqa_tpu.compiler import verifier as jverifier
from dfol_vqa_tpu.ontology import GQAOntology as JOntology
from dfol_vqa_tpu_torch.compiler import normalize as tnormalize
from dfol_vqa_tpu_torch.compiler import preprocess as tpreprocess
from dfol_vqa_tpu_torch.compiler import preprocess_cli as tcli
from dfol_vqa_tpu_torch.compiler import verifier as tverifier
from dfol_vqa_tpu_torch.ontology import GQAOntology as TOntology

from tests.helpers import op, question
from tests.test_preprocess import SEMANTIC_CASES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["Cars", "glasses", "shelves", "dress", "  Red  ", "teddy bears", "boxes", "ponies",
         "knives", "children", "tennis", "cactus", "octopus", "delicious", "curious"]


@pytest.fixture(scope="module")
def ontologies():
    return TOntology(), JOntology()


@pytest.fixture(scope="module")
def preprocessors(ontologies):
    t, j = ontologies
    return (tpreprocess.GQAPreprocessor(t._op_map, True),
            jpreprocess.GQAPreprocessor(j._op_map, True))


def test_normalize_equals_jax():
    with open(os.path.join(ROOT, "tests", "golden_singularize.json")) as f:
        golden = json.load(f)
    words = WORDS + sorted(golden)[:400]
    assert [tnormalize.normalize(w) for w in words] == [jnormalize.normalize(w) for w in words]
    assert ([tnormalize.singularize_word(w) for w in words]
            == [jnormalize.singularize_word(w) for w in words])


@pytest.mark.parametrize("case", sorted(SEMANTIC_CASES))
@pytest.mark.parametrize("discard_global", [False, True])
def test_parse_question_equals_jax(preprocessors, case, discard_global):
    t, j = preprocessors  # parse_question edits its argument's operations in place
    assert (t.parse_question(copy.deepcopy(SEMANTIC_CASES[case]), discard_global=discard_global)
            == j.parse_question(copy.deepcopy(SEMANTIC_CASES[case]),
                                discard_global=discard_global))


def test_discard_global_equals_jax(preprocessors):
    t, j = preprocessors
    q = {"semantic": [{"operation": "select", "argument": "scene", "dependencies": []},
                      {"operation": "exist", "argument": "?", "dependencies": [0]}],
         "answer": "yes", "imageId": "i"}
    for flag in (False, True):
        assert t.parse_question(copy.deepcopy(q), discard_global=flag) == j.parse_question(
            copy.deepcopy(q), discard_global=flag)


def question_file(tmp_path):
    """A GQA-style question file: every semantic case three times on images
    of the GQA vocabulary (the h5 codec encodes image ids), and a global
    question."""
    images = JOntology()._images
    data = {f"{case}-{k}": {**SEMANTIC_CASES[case], "imageId": images[3 * n + k]}
            for n, case in enumerate(sorted(SEMANTIC_CASES)) for k in range(3)}
    data["global"] = {"semantic": [{"operation": "select", "argument": "scene",
                                    "dependencies": []},
                                   {"operation": "exist", "argument": "?", "dependencies": [0]}],
                      "answer": "yes", "imageId": images[99]}
    path = tmp_path / "questions.json"
    path.write_text(json.dumps(data))
    return path


def read_dir(d) -> dict:
    """Every file under ``d``: JSON lines as text, h5 files as their arrays."""
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if name.endswith(".h5"):
            with h5py.File(path, "r") as hf:
                out[name] = {k: np.asarray(hf[k]) for k in hf.keys()}
        else:
            with open(path) as f:
                out[name] = f.read()
    return out


@pytest.mark.parametrize("segregate_length", [False, True])
def test_preprocess_files_equal_jax(preprocessors, tmp_path, segregate_length):
    t, j = preprocessors
    src = question_file(tmp_path)
    for name, pre in (("port", t), ("jax", j)):
        (tmp_path / name).mkdir()
        pre.preprocess(str(src), str(tmp_path / name / "out.json"), True, segregate_length)
    assert read_dir(tmp_path / "port") == read_dir(tmp_path / "jax")
    assert len(os.listdir(tmp_path / "port")) >= 4


def verifier_cases():
    return {
        "good": question([[op("select", "car"), op("filter", "red")]], op("exist")),
        "two_branch": question([[op("select", "car")], [op("select", "dog")]], op("and")),
        "relate": question([[op("select", "car"), op("relate", "on", False, "table")]],
                           op("exist")),
        "bad_terminal": question([[op("select", "car")]], op("filter", "red")),
        "bad_vocab": question([[op("select", "car"), op("filter", "xyzzy123")]], op("exist")),
        "bad_branches": question([[op("select", "car")]], op("and")),
        "bad_first": question([[op("filter", "red")]], op("exist")),
        "bad_relate": question([[op("select", "car"), op("relate", "red", False, "table")]],
                               op("exist")),
        "no_last_op": {"program": {"branches": []}},
        "bad_verify": question([[op("select", "car")]], op("verify_attrs")),
    }


@pytest.mark.parametrize("case", sorted(verifier_cases()))
def test_verifier_equals_jax(ontologies, case):
    t, j = ontologies
    program = verifier_cases()[case]["program"]
    results = []
    for mod, ont in ((tverifier, t), (jverifier, j)):
        try:
            results.append(("ok", mod.GQAProgramVerifier(ont).verify(program)))
        except mod.ParserError as e:
            results.append(("ParserError", str(e)))
    assert results[0] == results[1]
    assert (results[0][0] == "ok") == (case in ("good", "two_branch", "relate"))


@pytest.mark.parametrize("flags", [["-b", "-g"], ["-b", "-g", "-l"]])
def test_preprocess_cli_equals_jax(tmp_path, flags):
    """``python -m ...compiler.preprocess_cli questions.json out_dir -b -g
    [-l]`` of both packages: the same JSON files and h5 arrays."""
    src = question_file(tmp_path)
    tcli.main([str(src), str(tmp_path / "port")] + flags)
    jcli.main([str(src), str(tmp_path / "jax")] + flags)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "h5_questions", "p_questions"]
    for sub in ("p_questions", "h5_questions"):
        port, want = read_dir(tmp_path / "port" / sub), read_dir(tmp_path / "jax" / sub)
        assert list(port) == list(want) and port
        for name in want:
            if isinstance(want[name], dict):
                assert list(port[name]) == list(want[name])
                for k, v in want[name].items():
                    assert port[name][k].dtype == v.dtype, (name, k)
                    np.testing.assert_array_equal(port[name][k], v, err_msg=f"{name}/{k}")
            else:
                assert port[name] == want[name], name
