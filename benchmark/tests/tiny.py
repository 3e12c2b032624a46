"""Tiny cells for the CPU tests: the manifest's cells at tiny widths, driven
through the harness on the CPU (``run.execute``), with no look for a card."""

from __future__ import annotations

import copy
import json
import os

import yaml

from benchmark import harness
from benchmark.run import execute

TINY_WIDTHS = {"box_features_dim": 32, "oracle_input_dim": 24, "word_embedding_dim": 16,
               "attribute_network_layers_config": [16], "relation_network_layers_config": [16],
               "attention_transfer_state_dim": 8, "verbose": False}
TINY_WORLD = {"scenes": 24, "min_objects": 4, "max_objects": 8, "nouns": 6, "attrs": 4,
              "noise": 0.1}


# the configuration of each cell built here, whether or not BENCHMARK.json
# runs it yet (PERF.md, Open questions)
CONFIG_OF = {"cur5-train-shuffled": "dfol-cur5", "cur7-serve-rel": "dfol-cur7",
             "cur7-eval-file": "dfol-cur7"}


def config_file(cell: str) -> str:
    """The cell's configuration file, as the manifest names it or else as
    ``CONFIG_OF`` does."""
    manifest = harness.load_manifest()
    try:
        entry = harness.config_entry(manifest, harness.cell_entry(manifest, cell)["config"])
        return os.path.join(harness.ROOT, entry["file"])
    except KeyError:
        return os.path.join(harness.BENCH_DIR, "configs", f"{CONFIG_OF[cell]}.yaml")


def tiny_config(tmp_path, cell: str) -> str:
    """The cell's configuration file at tiny widths and 8 objects."""
    with open(config_file(cell)) as f:
        d = yaml.safe_load(f)
    d.update(TINY_WIDTHS)
    d["tpu"]["max_object_num"] = 8
    d["train_batch_size"] = d["test_batch_size"] = 16
    d["tpu"]["train_chunk"] = d["tpu"]["eval_chunk"] = 2  # a short warm-up
    # the port stores the pair code in tpu.rel_stream_dtype on the card's
    # kernel route only; its CPU route keeps float32, as the reference must here
    d["tpu"]["rel_stream_dtype"] = "float32"
    path = os.path.join(str(tmp_path), f"{cell}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def tiny_spec(cell: str) -> dict:
    """The cell's workload file with a tiny world and traffic."""
    with open(os.path.join(harness.BENCH_DIR, "workloads", f"{cell}.json")) as f:
        spec = json.load(f)
    spec = copy.deepcopy(spec)
    spec["world"] = dict(TINY_WORLD)
    if spec["path"] == "serve":
        spec["rate_per_s"] = 40
        spec["engine"] = {"max_batch": 4, "max_delay_ms": 5}
        spec["check"]["requests"] = 24
    elif spec["path"] == "eval":
        spec["batch"], spec["images_per_batch"] = 16, 4
        spec["mix"] = [["exist", 2, 32], ["verify_rel", 1, 16], ["query_attr", 1, 16]]
        spec["check"]["batches"] = 2
    else:
        spec["mix"] = [[f, h, 32] for f, h, _ in spec["mix"]]
    return spec


def run_tiny(tmp_path, cell: str, seed: int = 3, seconds: float = 1.0, spec=None,
             control=None) -> dict:
    manifest = harness.load_manifest()
    ctx = harness.Ctx(cell=cell, spec=spec or tiny_spec(cell),
                      config_file=tiny_config(tmp_path, cell), seed=seed, seconds=seconds,
                      trace=False, device="cpu")
    ctx.obs["scratch"] = str(tmp_path)
    return execute(ctx, manifest, 1, control=control)


def small_spec(cell: str) -> dict:
    """The cell's workload at its published widths with little traffic: the
    card tests' size."""
    with open(os.path.join(harness.BENCH_DIR, "workloads", f"{cell}.json")) as f:
        spec = json.load(f)
    spec["world"] = dict(spec["world"], scenes=64)
    if spec["path"] == "serve":
        spec["rate_per_s"] = 60
        spec["check"]["requests"] = 96
    elif spec["path"] == "eval":
        spec["mix"] = [[f, h, min(c, 160)] for f, h, c in spec["mix"]]
        spec["check"]["batches"] = 4
    else:
        spec["mix"] = [[f, h, 160] for f, h, _ in spec["mix"]]
    return spec


def run_small(tmp_path, cell: str, seed: int, control=None, seconds: float = 2.0) -> dict:
    """The cell on the card at its configuration's widths (``small_spec``)."""
    manifest = harness.load_manifest()
    ctx = harness.Ctx(cell=cell, spec=small_spec(cell), config_file=config_file(cell), seed=seed,
                      seconds=seconds, trace=False, device="cuda")
    ctx.obs["scratch"] = str(tmp_path)
    return execute(ctx, manifest, 1, control=control)
