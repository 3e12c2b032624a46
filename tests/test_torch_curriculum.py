"""The port's curriculum chain (``experiments/curriculum.py``) against the JAX
package's curriculum script (``scripts/curriculum_run.py``), on the CPU.

* ``write_datasets``: every h5 file of every split equal, array by array;
  the JSON-lines files compile to the same tensors; a ``sizes`` entry
  changes its file only, and forked workers write the same files;
* ``stage_dir``: the symlinks, idempotent;
* the artifact: the same JSON from the same stage rows;
* two hand-overs run by both chains at their defaults (the tiny overrides,
  the planted world) at ``--scale 0.05 --epoch-scale 0.01`` (two epochs a
  stage): stages 0 -> 1 and 5 -> 6 (the
  calibrator's partial load). The stage rows' test accuracies are equal and
  each stage's epoch losses within rtol 1e-4; the port's hand-over loads
  every leaf of stage i-1's ``best/`` bitwise, and stage 6's calibrator
  starts fresh. The JAX script runs in a subprocess, as it runs its stages.
  Both start each stage from the JAX package's initial weights (the port's
  ``Interpreter.init_params`` is replaced by the JAX draw for the same
  config and seed), so the two chains see the same numbers. The family
  sets are cut to one or two families (``CUTS``): the JAX script compiles
  every bucket of every stage on the CPU, 50-180 s a stage at the full
  sets, and the hand-over logic does not depend on them.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest

from dfol_vqa_tpu.config import Config as JConfig
from dfol_vqa_tpu.data.planted import PlantedWorld as JPlantedWorld
from dfol_vqa_tpu.models.interpreter import Interpreter as JInterpreter
from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
from dfol_vqa_tpu_torch.convert import flatten, params_from_numpy, params_to_numpy
from dfol_vqa_tpu_torch.data.dataset import ProgramDataset
from dfol_vqa_tpu_torch.data.planted import PlantedWorld as TPlantedWorld
from dfol_vqa_tpu_torch.experiments import curriculum as tc
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ontology import GQAOntology as TOntology
from dfol_vqa_tpu_torch.train.trainer import VQATrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import curriculum_run as jc  # noqa: E402

SCALE = 0.05
# (stages, T1, T2 = T3 = T4): the family sets of each hand-over's two chains
CUTS = {"0to1": ([0, 1], ["exist"], ["exist", "verify_rel"]),
        "5to6": ([5, 6], ["exist"], ["exist"])}


def worlds(ontology, n_images=96, box_dim=16):
    kw = dict(box_dim=box_dim, n_nouns=6, n_attrs=6, n_images=n_images, min_objects=3,
              max_objects=8, noise=0.1, seed=0, image_id_space="vocab")
    return TPlantedWorld(TOntology(), **kw), JPlantedWorld(ontology, **kw)


def questions(ds) -> list:
    return [ds[i] for i in range(len(ds))]


def h5_arrays(path) -> dict:
    with h5py.File(path, "r") as hf:
        return {k: np.asarray(hf[k]) for k in hf.keys()}


@pytest.mark.parametrize("fmt", ["h5", "json"])
def test_write_datasets_equal_jax(ontology, tmp_path, fmt):
    """h5: every file's arrays equal the JAX script's. JSON lines (hosts
    without h5py): each file's questions compile to the same tensors as the
    JAX script's h5 file, read back by the loaders' ``ProgramDataset``."""
    tw, jw = worlds(ontology)
    tont = TOntology()
    port = tc.write_datasets(tw, tont, str(tmp_path / "port"), SCALE, fmt)
    want = jc.write_datasets(jw, ontology, str(tmp_path / "jax"), SCALE)
    assert list(port) == list(want) and len(port) == 4 * len(tc.T4) * 3
    assert port == tc.dataset_paths(str(tmp_path / "port"), fmt)
    compiler = ProgramCompiler(tont, object_num=8, rel_slots=8)
    for key in want:
        if fmt == "h5":
            got, exp = h5_arrays(port[key]), h5_arrays(want[key])
        else:
            got, exp = ({f.name: getattr(cb, f.name) for f in dataclasses.fields(cb)
                         if isinstance(getattr(cb, f.name), np.ndarray)}
                        for _, cb in (compiler.compile(questions(ProgramDataset(path, tont)))
                                      for path in (port[key], want[key])))
        assert list(got) == list(exp) and got, key
        for k in exp:
            assert got[k].dtype == exp[k].dtype, (key, k)
            np.testing.assert_array_equal(got[k], exp[k], err_msg=f"{key} {k}")


@pytest.mark.parametrize("workers", [0, 2])
def test_write_datasets_sizes(ontology, tmp_path, workers):
    """A ``sizes`` entry sets that one file's question count, and leaves
    every other file as the default writes it; forked workers write the
    same files as one process."""
    tw, _ = worlds(ontology)
    tont = TOntology()
    base = tc.write_datasets(tw, tont, str(tmp_path / "base"), SCALE, "json")
    key = ("all", "exist", 1)
    got = tc.write_datasets(tw, tont, str(tmp_path / "sized"), SCALE, "json", {key: 37},
                            workers)
    assert list(got) == list(base)
    for k in base:
        with open(got[k]) as f, open(base[k]) as g:
            mine, want = f.read(), g.read()
        if k == key:
            assert mine.count("\n") == 37 and want.count("\n") == int(500 * SCALE)
        else:
            assert mine == want, k


def test_stage_dir(tmp_path):
    files = []
    for name in ("a.h5", "b.h5"):
        (tmp_path / name).write_text("x")
        files.append(str(tmp_path / name))
    d = tc.stage_dir(str(tmp_path), "train_cur0", files)
    assert sorted(os.listdir(d)) == ["a.h5", "b.h5"]
    assert all(os.path.realpath(os.path.join(d, f)) == os.path.realpath(tmp_path / f)
               for f in ("a.h5", "b.h5"))
    assert tc.stage_dir(str(tmp_path), "train_cur0", files) == d  # idempotent


def test_artifact_equals_jax(ontology, tmp_path):
    tw, jw = worlds(ontology, n_images=512, box_dim=32)  # the JAX script's artifact's world
    rows = [dict(stage=i, version=f"curriculum_{i}", families=tc.T4, lengths=[0, 1],
                 train_split="all", epochs=2, learning_rate=1e-3, calibrator=i >= 6,
                 device="cpu", backend="cpu", test_acc_overall=0.5 + 0.05 * i,
                 test_acc_per_family={}, seconds=1.0) for i in range(8)]

    class Args:
        noise, scale, epoch_scale, json = 0.1, SCALE, 0.1, None

    for name, write, world in (("port", tc.write_artifact, tw), ("jax", jc._write_artifact, jw)):
        Args.out = str(tmp_path / name)
        os.makedirs(Args.out)
        write(Args, world, rows, 10.0)
    port = json.loads((tmp_path / "port" / "CURRICULUM.json").read_text())
    assert port == json.loads((tmp_path / "jax" / "CURRICULUM.json").read_text())
    assert port["calibrator_gain"] == pytest.approx(0.1)


def cut_families(t1, t4, stages) -> dict:
    """A curriculum module's family sets and stages with T1 = ``t1`` and T2 = T3 = T4
    = ``t4``."""
    return dict(T1=t1, T2=t4, T3=t4, T4=t4,
                STAGES=[dict(st, fams=t1 if st["i"] == 0 else t4) for st in stages])


JAX_RUNNER = """
import json, sys
{source}
sys.path.insert(0, {scripts!r})
import curriculum_run as cr
t1, t4 = json.loads(sys.argv[1])
vars(cr).update({cut}(t1, t4, cr.STAGES))
cr.main(sys.argv[2:])
"""


def jax_initial_params(ontology):
    """The port's ``Interpreter.init_params`` replaced by the JAX package's
    draw for the same config and the JAX experiment's key (seed 0)."""
    def init_params(self, generator, device="cpu"):
        jcfg = JConfig.from_yaml(dataclasses.asdict(self.cfg))
        jp = JInterpreter(jcfg, ontology).init_params(jax.random.PRNGKey(0))
        return params_from_numpy(jax.tree.map(np.asarray, jp)).to(device)
    return init_params


def best_dir(out, stage):
    return os.path.join(out, "runs", tc.MODEL_NAME, f"curriculum_{stage}", "best")


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_hand_over_matches_jax(ontology, tmp_path, monkeypatch, cut):
    stages, t1, t4 = CUTS[cut]
    args = ["--scale", str(SCALE), "--epoch-scale", "0.01", "--stages", ",".join(map(str, stages))]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    runner = JAX_RUNNER.format(scripts=os.path.join(ROOT, "scripts"), cut="cut_families",
                               source=inspect.getsource(cut_families))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", runner, json.dumps([t1, t4])] + args
        + ["--out", jout, "--jit-cache", str(tmp_path / "jit")],
        cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        for name, value in cut_families(t1, t4, tc.STAGES).items():
            monkeypatch.setattr(tc, name, value)
        monkeypatch.setattr(Interpreter, "init_params", jax_initial_params(ontology))
        loaded = {}
        load_into = VQATrainer._load_into

        def spy(self, path, params):
            load_into(self, path, params)
            # copies: on the CPU the arrays share the parameters' memory
            loaded[self.cfg.version] = {k: np.array(v)
                                        for k, v in flatten(params_to_numpy(params)).items()}

        monkeypatch.setattr(VQATrainer, "_load_into", spy)
        rows, results = tc.main(args + ["--out", tout, "--cpu"])
        out, _ = jax_run.communicate(timeout=900)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0, out[-3000:]
    assert [r["stage"] for r in rows] == stages
    for row in rows:
        i = row["stage"]
        with open(os.path.join(jout, f"stage_{i}.json")) as f:
            want = json.load(f)
        for key in ("families", "lengths", "train_split", "epochs", "learning_rate",
                    "calibrator", "test_acc_overall", "test_acc_per_family"):
            assert row[key] == want[key], (i, key)
        np.testing.assert_allclose(np.load(os.path.join(best_dir(tout, i), "losses.npy")),
                                   np.load(os.path.join(best_dir(jout, i), "losses.npy")),
                                   rtol=1e-4, atol=0, err_msg=f"stage {i}")
        assert np.isfinite(results[i]["train_loss"]).all()
    # the hand-over: stage i-1's best/ loaded bitwise; the first stage loads
    # nothing (no earlier best/); stage 6's calibrator is absent and fresh
    first, second = stages
    assert f"curriculum_{first}" not in loaded
    got = loaded[f"curriculum_{second}"]
    with np.load(os.path.join(best_dir(tout, first), f"{tc.MODEL_NAME}.npz")) as prev:
        keys = [k for k in prev.files if not k.startswith("__")]
        for k in keys:
            np.testing.assert_array_equal(got[k], prev[k], err_msg=k)
    calibrator = sorted(k for k in got if k.startswith("calibrator/"))
    assert bool(calibrator) == (second == 6)
    assert not set(calibrator) & set(keys)
    if calibrator:
        cfg = dict(tc.stage_config(tc.STAGES[6], tout, tc.dataset_paths(tout), 1.0, 3e-3,
                                   tc.TINY_OVERRIDES))
        from dfol_vqa_tpu_torch.config import Config

        fresh = flatten(params_to_numpy(jax_initial_params(ontology)(
            Interpreter(Config.from_yaml(cfg), TOntology()), None)))
        for k in calibrator:
            np.testing.assert_array_equal(got[k], fresh[k], err_msg=k)
