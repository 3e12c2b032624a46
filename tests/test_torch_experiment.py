"""The port's experiment runner and CLI against the JAX package's, on the CPU.

Tiny widths; the questions are synthetic h5 files on ``SyntheticFeatures``
scenes: training questions each on its own image (batches of 6: the
per-question relation route), validation and test questions three to an
image (batches of 12 on 4 images: the shared-image route). Both packages start from the same npz, placed in each run's
``best/``, and run with ``load_model="best"``, dropout 0 and
``tpu.train_chunk=1`` (the JAX trainer checks checkpoints at dispatch
boundaries; the port after every step):

* ``run`` (training, then test): losses within rtol 1e-4, the training and
  test error vectors equal, the parameters within ``assert_params_close``;
* the CLI's test-only mode (``-t -l best``), ``-p``, ``-p -u`` and ``-o``:
  test errors, prediction files and hardset files equal;
* ``parameter_count`` equal to JAX's for ``sample_config``, ``cur6`` and
  F = 4;
* ``run(visualize=True)``: the traces file equals JAX's;
* what the port cannot run raises: a mesh shape against a world of one
  process, ``DFOL_DISTRIBUTED`` without a rendezvous; the CLI without
  ``-c`` raises where no card is.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from dfol_vqa_tpu.compiler.h5_codec import ProgramH5Codec
from dfol_vqa_tpu.config import Config as JConfig
from dfol_vqa_tpu.data.synthetic import generate_questions
from dfol_vqa_tpu.experiments import experiment as jexperiment
from dfol_vqa_tpu.experiments import gqa_experiment as jcli
from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu.train import checkpoint as jckpt
from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.convert import flatten, params_to_numpy
from dfol_vqa_tpu_torch.experiments import experiment as texperiment
from dfol_vqa_tpu_torch.experiments import gqa_experiment as tcli
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ontology import GQAOntology as TOntology

from tests.test_torch_train_loop import assert_params_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "configs", "sample_config.yaml")
CUR6 = os.path.join(ROOT, "configs", "curriculum_training", "cur6_classifier-direct-ll.yaml")
LR = 1e-3


@pytest.fixture(scope="module")
def data(ontology, tmp_path_factory):
    """h5 question files (exist and query_attr, with relate hops) and the
    shared starting weights; returns (root, config dict, npz path)."""
    root = tmp_path_factory.mktemp("experiment")
    codec = ProgramH5Codec(ontology)
    for split, seed, per_image in (("train", 0, 1), ("val", 1, 3), ("test", 2, 3)):
        d = root / split
        d.mkdir()
        for term in ("exist", "query_attr"):
            qs = generate_questions(ontology, 12, terminal=term, length=1, seed=seed)
            for i, q in enumerate(qs):
                q["imageId"] = ontology._images[(seed * 100 + i // per_image) % 500]
            codec.write_h5(qs, str(d / f"p_{split}_{term}.h5"))
    cfg = {
        "model_name": "tiny", "version": "t0",
        "train_path": str(root / "train"), "validation_path": str(root / "val"),
        "test_path": str(root / "test"),
        "epoch_num": 2, "repetition_num": 1, "train_batch_size": 6, "test_batch_size": 12,
        "box_features_dim": 32, "oracle_input_dim": 16, "word_embedding_dim": 12,
        "featurizer_layers_config": [], "attribute_network_layers_config": [8],
        "relation_network_layers_config": [8], "learning_rate": LR, "dropout": 0.0,
        "verbose": False, "ckeckpointing_frequency": 3,
        "tpu": {"max_object_num": 6, "rel_table_size": 4, "train_chunk": 1},
    }
    jcfg = JConfig.from_yaml(dict(cfg))
    jparams = JInterpreter(jcfg, ontology).init_params(jax.random.PRNGKey(3))
    jckpt.save(str(root / "start"), "tiny", jparams)
    return root, cfg, str(root / "start" / "tiny.npz")


def run_dir(data, tmp_path, name, **over) -> str:
    """A config file for one package's run under ``tmp_path/name``, with
    the shared weights in its ``best/``."""
    _, cfg, npz = data
    cfg = {**cfg, "model_path": str(tmp_path / name), **over}
    best = tmp_path / name / cfg["model_name"] / cfg["version"] / "best"
    best.mkdir(parents=True)
    with open(npz, "rb") as src, open(best / "tiny.npz", "wb") as dst:
        dst.write(src.read())
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def jax_flat(params) -> dict:
    return flatten(jax.tree.map(np.asarray, params))


def test_run_matches_jax(data, tmp_path):
    """Training from the shared ``best/`` (two epochs, mid-epoch checkpoints
    every 3 steps), then the test pass from the best checkpoint."""
    port = texperiment.GQAObjectBoxExperiment().run(run_dir(data, tmp_path, "port"),
                                                    load_model="best", device="cpu")
    want = jexperiment.GQAObjectBoxExperiment().run(run_dir(data, tmp_path, "jax"),
                                                    load_model="best")
    assert set(port) == set(want)
    np.testing.assert_allclose(port["train_loss"], want["train_loss"], rtol=1e-4, atol=0)
    np.testing.assert_array_equal(port["train_error"], want["train_error"])
    np.testing.assert_array_equal(port["test_error"], want["test_error"])
    np.testing.assert_array_equal(port["test_counts"], want["test_counts"])
    assert port["test_counts"][0] == 24
    steps = 2 * 4  # two epochs of two 6-question batches per file
    assert_params_close(flatten(params_to_numpy(port["params"])), jax_flat(want["params"]),
                        LR, steps)
    for sub in ("best", "last"):
        for name in ("port", "jax"):
            assert (tmp_path / name / "tiny" / "t0" / sub / "tiny.npz").exists(), (name, sub)
    for arr in ("losses", "errors"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / "tiny" / "t0" / "best" /
                                              f"{arr}.npy"),
                                      port["train_loss" if arr == "losses" else "train_error"])


def read_tree(d) -> dict:
    """Every file under ``d`` by relative path: JSON parsed, other text as
    lines."""
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            path = os.path.join(base, f)
            with open(path) as fh:
                text = fh.read()
            try:
                out[os.path.relpath(path, d)] = json.loads(text)
            except json.JSONDecodeError:
                out[os.path.relpath(path, d)] = text.splitlines()
    return out


@pytest.mark.parametrize("flags", [["-t", "-l", "best"], ["-t", "-l", "best", "-p"],
                                   ["-t", "-l", "best", "-p", "-u"]])
def test_cli_test_and_predict_match_jax(data, tmp_path, flags):
    runs = {}
    for name, main, extra in (("port", tcli.main, ["-c"]), ("jax", jcli.main, [])):
        runs[name] = main([run_dir(data, tmp_path, name), "-s", "0"] + flags + extra)
    if "-u" in flags:  # a submission writes the predictions and skips the test
        assert runs["port"]["test_error"] is None and runs["jax"]["test_error"] is None
    else:
        np.testing.assert_array_equal(runs["port"]["test_error"], runs["jax"]["test_error"])
        assert runs["port"]["train_loss"] is None
    preds = {name: read_tree(tmp_path / name / "predictions") if "-p" in flags else {}
             for name in runs}
    assert preds["port"] == preds["jax"]
    if "-p" in flags:
        (pred,) = preds["port"].values()
        assert len(pred) == 24 and all("prediction" in p for p in pred)


def test_cli_hardset_matches_jax(data, tmp_path):
    runs = {}
    for name, main, extra in (("port", tcli.main, ["-c"]), ("jax", jcli.main, [])):
        hard = tmp_path / f"hard_{name}"
        runs[name] = main([run_dir(data, tmp_path, name), "-t", "-l", "best", "-o", str(hard)]
                          + extra)
    port, want = read_tree(tmp_path / "hard_port"), read_tree(tmp_path / "hard_jax")
    assert port == want
    assert {"hard.json", "easy.json"} <= set(port)
    # one JSON line per mined question in hard/hard_<op>.json and easy/easy_<op>.json
    mined = [v for k, v in port.items() if os.path.dirname(k) in ("hard", "easy")]
    assert sum(len(v) if isinstance(v, list) else 1 for v in mined) == 24
    np.testing.assert_array_equal(runs["port"]["test_error"], runs["jax"]["test_error"])


@pytest.mark.parametrize("which", ["sample_config", "cur6", "F4"])
def test_parameter_count_equals_jax(ontology, which):
    path = CUR6 if which == "cur6" else SAMPLE
    over = {"oracle_output_dim": 4, "operator_layers_config": [8]} if which == "F4" else {}
    jcfg = dataclasses.replace(JConfig.from_yaml(path), **over)
    tcfg = dataclasses.replace(Config.from_yaml(path), **over)
    want = JInterpreter(jcfg, ontology).parameter_count(
        JInterpreter(jcfg, ontology).init_params(jax.random.PRNGKey(0)))
    interp = Interpreter(tcfg, TOntology())
    got = interp.parameter_count(interp.init_params(torch.Generator().manual_seed(0)))
    assert got == want > 0


def check_visualize_matches_jax(data, tmp_path, monkeypatch):
    """``run(visualize=True, load_model="best")`` in each package, each in a
    directory of its own: the port's ``visualizations/traces.json`` holds
    JAX's entries (ops, tokens, answers equal; attentions and
    log-probabilities within 1e-5), and the test errors are equal."""
    runs, traces = {}, {}
    for name, pkg in (("port", texperiment), ("jax", jexperiment)):
        cfg_path = run_dir(data, tmp_path, name)
        (tmp_path / f"cwd_{name}").mkdir()
        monkeypatch.chdir(tmp_path / f"cwd_{name}")
        kw = {"device": "cpu"} if name == "port" else {}
        runs[name] = pkg.GQAObjectBoxExperiment().run(cfg_path, is_training=False,
                                                      load_model="best", visualize=True, **kw)
        traces[name] = json.loads((tmp_path / f"cwd_{name}" / "visualizations"
                                   / "traces.json").read_text())
    assert len(traces["port"]) == len(traces["jax"]) == 24
    for got, want in zip(traces["port"], traces["jax"]):
        assert {k: got[k] for k in ("question_id", "image_id", "terminal_op", "answer")} == {
            k: want[k] for k in ("question_id", "image_id", "terminal_op", "answer")}
        np.testing.assert_allclose(got["log_probability"], want["log_probability"], atol=1e-5)
        assert [(h["branch"], h["op"], h["token"]) for h in got["hops"]] == [
            (h["branch"], h["op"], h["token"]) for h in want["hops"]]
        for hg, hw in zip(got["hops"], want["hops"]):
            np.testing.assert_allclose(hg["attention"], hw["attention"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(runs["port"]["test_error"], runs["jax"]["test_error"])


@pytest.mark.parametrize("case", ["visualize", "mesh", "distributed"])
def test_unported_modes_raise(data, tmp_path, monkeypatch, case):
    """The mesh is ported (``tests/test_torch_mesh.py``); what it cannot
    run raises before anything is written: ``tpu.mesh_shape=[2]`` in a
    world of one process (no launch) raises for the world size, and
    ``DFOL_DISTRIBUTED`` without a rendezvous raises for that. ``visualize``
    is ported too: its case holds the run against JAX's
    (``check_visualize_matches_jax``)."""
    if case == "visualize":
        check_visualize_matches_jax(data, tmp_path, monkeypatch)
        return
    over = {"tpu": {"max_object_num": 6, "mesh_shape": [2], "mesh_axes": ["data"]}} \
        if case == "mesh" else {}
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    if case == "distributed":
        monkeypatch.setenv("DFOL_DISTRIBUTED", "1")
    error, match = ((ValueError, "this launch has 1 process") if case == "mesh"
                    else (RuntimeError, "no rendezvous"))
    with pytest.raises(error, match=match):
        texperiment.GQAObjectBoxExperiment().run(
            run_dir(data, tmp_path, "port", **over), is_training=False, device="cpu")
    assert not (tmp_path / "port" / "tiny" / "t0" / "last").exists()
    assert not torch.distributed.is_initialized()


def test_cli_without_cpu_flag_needs_a_card(data, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="-c"):
        tcli.main([run_dir(data, tmp_path, "port"), "-t"])
