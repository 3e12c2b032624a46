"""The port's host modules: its own copies of the JAX package's numpy-only
modules, and nothing of the JAX package in the port.

* an ``ast`` scan of every module of ``dfol_vqa_tpu_torch`` and of
  ``chip_smoke.py``: no import of ``jax`` or of ``dfol_vqa_tpu``;
* the port's entry modules imported in a fresh interpreter (this process
  has JAX loaded by ``tests/conftest.py``) leave neither ``jax`` nor any
  ``dfol_vqa_tpu`` module in ``sys.modules``;
* each copy equals the JAX module it copies: configurations, the ontology
  and its metadata asset, the program compiler's batches, the planted
  world's features and questions, the synthetic question and supervision
  generators, and the loader's batches in the shuffled (training) and the
  deduplicated (evaluation) layout; the preprocessing modules
  (``compiler/normalize``, ``preprocess``, ``preprocess_cli``, ``verifier``)
  by source text, imports renamed (their behaviour against JAX is
  ``tests/test_torch_preprocess.py``);
* the CUDA build hash covers the headers in ``csrc/``, and the package
  data ships every source in ``csrc/``.
"""

import ast
import dataclasses
import fnmatch
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tomllib

import numpy as np
import pytest

from dfol_vqa_tpu import config as jconfig
from dfol_vqa_tpu import ontology as jontology
from dfol_vqa_tpu.compiler import program_compiler as jcompiler
from dfol_vqa_tpu.data import dataset as jdataset
from dfol_vqa_tpu.data import loader as jloader
from dfol_vqa_tpu.data import planted as jplanted
from dfol_vqa_tpu.data import synthetic as jsynthetic
from dfol_vqa_tpu_torch import config as tconfig
from dfol_vqa_tpu_torch import ontology as tontology
from dfol_vqa_tpu_torch.compiler import program_compiler as tcompiler
from dfol_vqa_tpu_torch.data import evalset, trainset
from dfol_vqa_tpu_torch.data import planted as tplanted
from dfol_vqa_tpu_torch.data import synthetic as tsynthetic
from dfol_vqa_tpu_torch.ops import cuda_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "dfol_vqa_tpu_torch")
PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(PORT) if "_build" not in d for f in fs if f.endswith(".py")
) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "dfol_vqa_tpu")


def imported_modules(path: str):
    """Every module name an import statement of ``path`` names, at any depth
    (function-level imports included)."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_nothing_of_jax(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("module", ["dfol_vqa_tpu_torch.serve", "dfol_vqa_tpu_torch.train.trainer",
                                    "dfol_vqa_tpu_torch.data.evalset",
                                    "dfol_vqa_tpu_torch.data.trainset",
                                    "dfol_vqa_tpu_torch.experiments.gqa_experiment",
                                    "dfol_vqa_tpu_torch.experiments.curriculum",
                                    "dfol_vqa_tpu_torch.compiler.preprocess_cli",
                                    "dfol_vqa_tpu_torch.export",
                                    "dfol_vqa_tpu_torch.http_frontend",
                                    "dfol_vqa_tpu_torch.viz",
                                    "dfol_vqa_tpu_torch.utils.profiling",
                                    "dfol_vqa_tpu_torch.graft_entry",
                                    "dfol_vqa_tpu_torch.parallel.launch"])
def test_port_module_loads_no_jax(module):
    code = ("import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'dfol_vqa_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_experiment_modules_are_scanned():
    for name in ("__init__", "experiment", "gqa_experiment", "curriculum"):
        assert os.path.join("dfol_vqa_tpu_torch", "experiments", name + ".py") in PORT_FILES


def test_serving_modules_are_scanned():
    for name in ("export.py", "http_frontend.py", "viz.py", os.path.join("utils", "profiling.py"),
                 os.path.join("utils", "__init__.py")):
        assert os.path.join("dfol_vqa_tpu_torch", name) in PORT_FILES


def test_entry_and_mesh_modules_are_scanned():
    for name in ("graft_entry.py", os.path.join("parallel", "mesh.py"),
                 os.path.join("parallel", "launch.py")):
        assert os.path.join("dfol_vqa_tpu_torch", name) in PORT_FILES


@pytest.mark.parametrize("module", ["normalize", "preprocess", "preprocess_cli", "verifier"])
def test_compiler_copy_source_equals_jax(module):
    """The copy is the JAX module's text with ``dfol_vqa_tpu`` renamed to
    ``dfol_vqa_tpu_torch`` and a note after the docstring's first line."""
    rel = os.path.join("compiler", module + ".py")
    with open(os.path.join(ROOT, "dfol_vqa_tpu", rel)) as f:
        lines = re.sub(r"\bdfol_vqa_tpu\b", "dfol_vqa_tpu_torch", f.read()).split("\n")
    note = [f"The PyTorch port's own copy of ``dfol_vqa_tpu/compiler/{module}.py``, which it "
            "must not import",
            "(the port imports nothing of the JAX package); it behaves exactly as",
            "that module, and tests/test_torch_host.py holds the two equal.", ""]
    with open(os.path.join(PORT, rel)) as f:
        assert f.read() == "\n".join(lines[:2] + note + lines[2:])


@pytest.mark.parametrize("yaml_path", [None, "configs/sample_config.yaml"])
def test_config_copy_equals_jax(yaml_path):
    def load(mod):
        if yaml_path is None:
            return mod.Config()
        return mod.Config.from_yaml(os.path.join(ROOT, yaml_path))

    assert dataclasses.asdict(load(tconfig)) == dataclasses.asdict(load(jconfig))


def assert_same(a, b, where="value"):
    """Equal, recursively: numpy arrays by value and dtype, dataclasses by
    field, containers by item."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{k}]")
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def ontologies():
    return tontology.GQAOntology(), jontology.GQAOntology()


def test_metadata_asset_copy_equals_jax():
    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert tontology.DEFAULT_METADATA_PATH.startswith(PORT)
    assert sha(tontology.DEFAULT_METADATA_PATH) == sha(jontology.DEFAULT_METADATA_PATH)


@pytest.mark.parametrize("what", ["state", "embedding_matrix", "options"])
def test_ontology_copy_equals_jax(ontologies, what):
    t, j = ontologies
    if what == "state":
        state = {k: v for k, v in vars(j).items() if not k.startswith("_embedding")}
        assert_same({k: vars(t)[k] for k in state}, state, "ontology")
    elif what == "embedding_matrix":
        assert_same(t.embedding_matrix(), j.embedding_matrix(), "embedding_matrix")
    else:
        cats = [None] + sorted(j._attribute_dict)
        assert_same([t.option_tokens(c, None) for c in cats],
                    [j.option_tokens(c, None) for c in cats], "option_tokens")
        assert t.max_option_count() == j.max_option_count()


def tiny_worlds(ontologies):
    t, j = ontologies
    kw = dict(box_dim=32, n_nouns=6, n_attrs=4, n_images=48, min_objects=4, max_objects=8,
              noise=0.1, seed=0)
    return tplanted.PlantedWorld(t, **kw), jplanted.PlantedWorld(j, **kw)


def test_planted_world_copy_equals_jax(ontologies):
    tw, jw = tiny_worlds(ontologies)
    assert tw.image_ids == jw.image_ids
    assert_same(tw.batch(tw.image_ids, 8), jw.batch(jw.image_ids, 8), "batch")
    for fam in tplanted.ALL_FAMILIES:
        assert_same(tw.generate_family(fam, 6, length=1, seed=3, id_prefix="q"),
                    jw.generate_family(fam, 6, length=1, seed=3, id_prefix="q"), fam)


@pytest.mark.parametrize("terminal", tplanted.ALL_FAMILIES)
def test_synthetic_questions_copy_equals_jax(ontologies, terminal):
    t, j = ontologies
    kw = dict(length=2, seed=3, neg_prob=0.3, wildcard_prob=0.2)
    assert_same(tsynthetic.generate_questions(t, 8, terminal, **kw),
                jsynthetic.generate_questions(j, 8, terminal, **kw), terminal)


@pytest.mark.parametrize("terminal", ["object_attr", "object_rel", "scene"])
def test_synthetic_supervision_copy_equals_jax(ontologies, terminal):
    t, j = ontologies
    assert_same(tsynthetic.generate_supervision_questions(t, 8, terminal, n_objects=5, seed=4),
                jsynthetic.generate_supervision_questions(j, 8, terminal, n_objects=5, seed=4),
                terminal)


def question_sets(world, kind):
    if kind == "eval":
        return evalset.eval_datasets(world, evalset.TINY_MIX, evalset.TINY_BATCH,
                                     evalset.TINY_IMAGES_PER_BATCH)
    return trainset.train_datasets(world, trainset.TINY_MIX)


@pytest.mark.parametrize("kind", ["eval", "train"])
def test_program_compiler_copy_equals_jax(ontologies, kind):
    t, j = ontologies
    tw, _ = tiny_worlds(ontologies)
    tc = tcompiler.ProgramCompiler(t, object_num=8, rel_slots=8)
    jc = jcompiler.ProgramCompiler(j, object_num=8, rel_slots=8)
    for qs in question_sets(tw, kind):
        for lo in range(0, len(qs), 16):
            batch = qs[lo:lo + 16]
            (ts, tb), (js, jb) = tc.compile(batch), jc.compile(batch)
            assert_same(ts, js, "spec")
            assert_same(tb, jb, "compiled")


@pytest.mark.parametrize("layout", ["shuffled", "deduplicated"])
def test_batch_loader_copy_equals_jax(ontologies, layout):
    t, j = ontologies
    tw, jw = tiny_worlds(ontologies)
    cfg = trainset.demo_train_config(tiny=True)
    if layout == "shuffled":
        sets = question_sets(tw, "train")
        port = trainset.train_loader(cfg, t, tw, sets, shuffle=True, seed=1)
        batch, shuffle = cfg.train_batch_size, True
    else:
        sets = question_sets(tw, "eval")
        port = evalset.eval_loader(cfg, t, tw, sets)
        batch, shuffle = cfg.test_batch_size, False
    jc = jcompiler.ProgramCompiler(j, object_num=8, rel_slots=cfg.tpu.rel_table_size)
    jax_loader = jloader.BatchLoader([jdataset.ProgramDataset(qs, j) for qs in sets], jc, jw,
                                     batch, 8, shuffle=shuffle, seed=1)
    for epoch in range(2):  # a shuffled loader reshuffles per pass
        got, want = list(port), list(jax_loader)
        assert len(got) == len(want) > 0
        for k, (a, b) in enumerate(zip(got, want)):
            where = f"epoch {epoch} batch {k}"
            assert_same(a.spec, b.spec, where + " spec")
            assert_same(a.objects, b.objects, where + " objects")
            assert_same(a.obj_mask, b.obj_mask, where + " obj_mask")
            assert_same(a.arrays, b.arrays, where + " arrays")
            assert_same(a.compiled, b.compiled, where + " compiled")


def test_build_hash_covers_headers(tmp_path):
    """An edited header in ``csrc/`` changes the digest of a source that
    does not name it on the command line, so the library rebuilds."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    sources = [str(csrc / "relation_oracle.cu")]
    before = cuda_build._digest(sources, str(csrc))
    assert cuda_build._digest(sources, str(csrc)) == before
    header = csrc / "pair_tail_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = cuda_build._digest(sources, str(csrc))
    assert edited != before
    (csrc / "new_tile.cuh").write_text("#pragma once\n")
    assert cuda_build._digest(sources, str(csrc)) != edited


def test_package_data_ships_every_native_source():
    """An installed package builds its libraries from the files its package
    data names: each source and header in ``csrc/`` (the CUDA kernels and
    the loader's ``scene_gather.cpp``) matches one of its globs."""
    root = os.path.dirname(cuda_build.PACKAGE_DIR)
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["dfol_vqa_tpu_torch"]
    rel = os.path.relpath(cuda_build.CSRC_DIR, cuda_build.PACKAGE_DIR)
    files = sorted(os.listdir(cuda_build.CSRC_DIR))
    assert "scene_gather.cpp" in files
    for name in files:
        assert any(fnmatch.fnmatch(f"{rel}/{name}", g) for g in globs), name
