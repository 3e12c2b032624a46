"""The reference's 8-stage curriculum, end to end, on a planted world.

Port of ``scripts/curriculum_run.py``: the same stage family sets (T1-T4),
the Train-All vs Train-Balanced alternation, ``-l best`` checkpoint
forwarding (stage i starts from stage i-1's ``best/``) and the calibrator
on the frozen oracle in stages 6-7, each stage one
``GQAObjectBoxExperiment.run`` of its shipped configuration
(``configs/curriculum_training/cur{i}_classifier-direct-ll.yaml``) over
planted-world question files (exact answers, held-out test scenes).

    python -m dfol_vqa_tpu_torch.experiments.curriculum [--noise 0.35] \
        [--scale 1.0] [--epoch-scale 1.0] [--out DIR] [--json PATH] \
        [--stages 0,1,...] [--seed 0] [--stage-lr 6:1e-3] [--resume] [--cpu]

It runs on the CUDA card; ``--cpu`` runs on the CPU (without a card and
without ``--cpu`` it raises). The defaults reproduce the JAX script's: its
planted world (32-d boxes, 6 nouns, 512 images, 3-8 objects) and its tiny
overrides of the stage files (``TINY_OVERRIDES``), so the two chains can be
compared on the CPU. ``run_stage`` takes the overrides as an argument; an
empty dict keeps the stage files' own widths and batch sizes. The program
files are h5, as the JAX script writes them; ``write_datasets(fmt="json")``
writes the JSON-lines files the loaders also read, for hosts without
``h5py``.

The JAX script runs each stage in a subprocess of its own, because XLA
never drops a compiled executable and eight stages of them exhaust the
host. The port compiles nothing: the kernels are built once per process
and PyTorch frees a stage's tensors when its run returns, so the stages
run in one process.

Per stage it writes ``stage_N.json`` (test accuracy overall and per family
on a fixed test set of all families and lengths), and after all eight the
artifact (``--json``, default ``OUT/CURRICULUM.json``).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import shutil
import time
import zlib
from typing import Optional

import numpy as np
import torch
import yaml

from dfol_vqa_tpu_torch.experiments.experiment import GQAObjectBoxExperiment
from dfol_vqa_tpu_torch.train.trainer import OP_INDEX

# Curriculum family sets (reference README.md:88-96)
T1 = ["exist"]
T2 = T1 + ["verify_attrs", "query_attr", "choose_attr"]
T3 = T2 + ["choose_rel", "verify_rel", "and", "or", "two_different", "two_same"]
T4 = T3 + ["compare", "all_same", "all_different"]

STAGES = [
    dict(i=0, fams=T1, lens=(0, 1), split="all", epochs=60, lr=3e-3),
    dict(i=1, fams=T2, lens=(0, 1), split="all", epochs=30, lr=3e-3),
    dict(i=2, fams=T3, lens=(0, 1), split="all", epochs=18, lr=3e-3),
    dict(i=3, fams=T4, lens=(0, 1), split="bal", epochs=14, lr=1.5e-3),
    dict(i=4, fams=T4, lens=(0, 1, 2), split="all", epochs=12, lr=1.5e-3),
    dict(i=5, fams=T4, lens=(0, 1, 2), split="bal", epochs=10, lr=1e-3),
    dict(i=6, fams=T4, lens=(0, 1, 2), split="all", epochs=12, lr=3e-3),
    dict(i=7, fams=T4, lens=(0, 1, 2), split="bal", epochs=8, lr=1e-3),
]

MODEL_NAME = "classifier-direct-ll"
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "curriculum_training")
SPLITS = ("all", "bal", "val", "test")

# the JAX script's overrides of the stage files' widths and batch sizes
# (curriculum_run.py:246-261), on its planted world (WORLD)
TINY_OVERRIDES = dict(
    train_batch_size=32, test_batch_size=64,
    box_features_dim=32, oracle_input_dim=24, word_embedding_dim=16,
    featurizer_layers_config=[],
    attribute_network_layers_config=[16],
    relation_network_layers_config=[16],
    attention_transfer_state_dim=16,
    weight_decay=1e-10,
    ckeckpointing_frequency=10_000, verbose=False,
    tpu={"max_object_num": 8, "rel_table_size": 4},
)
WORLD = dict(box_dim=32, n_nouns=6, n_attrs=9, n_images=512, min_objects=3, max_objects=8,
             image_id_space="vocab")


def _write_json(qs, path):
    with open(path, "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in qs)


def _write_file(world, write, job):
    split, fam, L, n, balanced, image_slice, path = job
    qs = world.generate_family(
        fam, n, length=L,
        # deterministic across processes (builtin hash is PYTHONHASHSEED-randomised)
        seed=zlib.crc32(f"{split}/{fam}/{L}".encode()) % (2**31),
        balanced=balanced, image_slice=image_slice, id_prefix=f"{split}_{fam}_{L}_",
    )
    write(qs, path)


_FORKED: Optional[tuple] = None  # (world, write) that write_datasets' forked workers inherit


def _write_file_forked(job):
    _write_file(*_FORKED, job)


def write_datasets(world, ontology, root: str, scale: float, fmt: str = "h5",
                   sizes: Optional[dict] = None, workers: int = 0):
    """Master split dirs: train-all / train-balanced / val / test program
    files per (family, length); scenes are disjoint between train and
    val/test. ``fmt="h5"`` writes the int32 HDF5 encoding, as the JAX
    script does; ``fmt="json"`` the JSON-lines program files that the
    loaders read as well, for hosts without ``h5py``. ``sizes`` maps
    (split, family, length) to a question count that replaces the scaled
    one for that file (a full batch of one file, say). ``workers`` > 0
    writes the files in that many forked processes (each file has its own
    seed, so the files are the same); the workers touch no device."""
    global _FORKED
    if fmt == "h5":
        from dfol_vqa_tpu_torch.compiler.h5_codec import ProgramH5Codec

        write = ProgramH5Codec(ontology).write_h5
    elif fmt == "json":
        write = _write_json
    else:
        raise ValueError(f"fmt must be h5 or json, got {fmt!r}")
    counts = {"all": int(500 * scale), "bal": int(320 * scale),
              "val": int(96 * scale), "test": int(128 * scale)}
    slices = {"all": (0.0, 0.85), "bal": (0.0, 0.85),
              "val": (0.85, 0.925), "test": (0.925, 1.0)}
    balanced = {"all": False, "bal": True, "val": True, "test": True}
    made, jobs = {}, []
    for split in counts:
        d = os.path.join(root, f"data_{split}")
        os.makedirs(d, exist_ok=True)
        for fam in T4:
            for L in (0, 1, 2):
                made[(split, fam, L)] = path = os.path.join(d, f"p_{split}_{fam}_{L}.{fmt}")
                jobs.append((split, fam, L, (sizes or {}).get((split, fam, L), counts[split]),
                             balanced[split], slices[split], path))
    if workers > 0:
        _FORKED = (world, write)
        try:
            with mp.get_context("fork").Pool(workers) as pool:
                pool.map(_write_file_forked, jobs, chunksize=1)
        finally:
            _FORKED = None
    else:
        for job in jobs:
            _write_file(world, write, job)
    return made


def dataset_paths(root: str, fmt: str = "h5") -> dict:
    """The (split, family, length) -> path map that ``write_datasets``
    writes under ``root``."""
    return {(split, fam, L): os.path.join(root, f"data_{split}",
                                          f"p_{split}_{fam}_{L}.{fmt}")
            for split in SPLITS for fam in T4 for L in (0, 1, 2)}


def prepare_datasets(world, ontology, root: str, scale: float, stamp: str,
                     fmt: str = "h5", sizes: Optional[dict] = None, workers: int = 0) -> dict:
    """``write_datasets`` at ``scale`` in ``fmt`` (with ``sizes``, by
    ``workers``) once per ``root``: a second call with the same ``stamp``
    reuses the files, another stamp raises."""
    os.makedirs(root, exist_ok=True)
    marker = os.path.join(root, ".datasets_done")
    if os.path.exists(marker):
        with open(marker) as f:
            have = f.read()
        if have != stamp:
            raise SystemExit(f"{root} holds datasets for '{have}' but this run wants "
                             f"'{stamp}' — use a fresh --out dir")
        return dataset_paths(root, fmt)
    made = write_datasets(world, ontology, root, scale, fmt, sizes, workers)
    with open(marker, "w") as f:
        f.write(stamp)
    return made


def stage_dir(root, name, files):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    for f in files:
        dst = os.path.join(d, os.path.basename(f))
        if not os.path.exists(dst):
            os.symlink(os.path.abspath(f), dst)
    return d


def full_test_dir(root: str, made: dict) -> str:
    """The fixed full test set: all families, all lengths, unseen scenes."""
    return stage_dir(root, "test_full", [made[("test", f, L)] for f in T4 for L in (0, 1, 2)])


def stage_config(st: dict, root: str, made: dict, epoch_scale: float, lr: float,
                 overrides: dict) -> dict:
    """Stage ``st``'s shipped configuration as a dict, pointed at the
    planted files under ``root`` (no GQA features, no GloVe file, no
    images), ``max(2, epochs x epoch_scale)`` epochs of one repetition,
    learning rate ``lr``, dropout 0; then ``overrides`` (``TINY_OVERRIDES``
    for the JAX script's widths, ``{}`` for the stage file's own)."""
    i, split = st["i"], st["split"]
    train_files = [made[(split, f, L)] for f in st["fams"] for L in st["lens"]]
    val_files = [made[("val", f, L)] for f in st["fams"] for L in st["lens"]]
    with open(os.path.join(CONFIG_DIR, f"cur{i}_{MODEL_NAME}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(
        train_path=stage_dir(root, f"train_cur{i}", train_files),
        validation_path=stage_dir(root, f"val_cur{i}", val_files),
        test_path=full_test_dir(root, made),
        train_object_path=None, train_object_info_path=None,
        word_embedding_file=None, image_path=None,
        model_path=os.path.join(root, "runs"),
        epoch_num=max(2, int(st["epochs"] * epoch_scale)), repetition_num=1,
        learning_rate=lr, dropout=0.0,
    )
    cfg.update(overrides)
    return cfg


def forward_best(root: str, i: int, version: str) -> Optional[str]:
    """``-l best`` forwarding: seed stage ``i``'s ``best/`` with a copy of
    stage i-1's (reference curriculum workflow, README.md:81-83), unless it
    has one; returns the copied directory, or None."""
    if i == 0:
        return None
    src = os.path.join(root, "runs", MODEL_NAME, f"curriculum_{i - 1}", "best")
    dst = os.path.join(root, "runs", MODEL_NAME, version, "best")
    if os.path.isdir(src) and not os.path.isdir(dst):
        shutil.copytree(src, dst)
        return dst
    return None


class PlantedCurriculumExperiment(GQAObjectBoxExperiment):
    """The GQA experiment with the planted world as its feature source."""

    def __init__(self, world):
        self._world = world

    def build_features(self, cfg, logger):
        return self._world


def run_stage(experiment, st: dict, root: str, made: dict, epoch_scale: float, lr: float,
              seed: int, device, overrides: dict) -> tuple:
    """Stage ``st``: its configuration (``stage_config``), the hand-over
    (``forward_best``), one ``experiment.run(..., load_model="best")``;
    writes ``stage_N.json`` and returns (row, the run's result dict)."""
    i = st["i"]
    cfg = stage_config(st, root, made, epoch_scale, lr, overrides)
    forward_best(root, i, cfg["version"])
    t1 = time.time()
    res = experiment.run(dict(cfg), is_training=True, load_model="best", seed=seed,
                         device=device)
    dt = time.time() - t1

    err = np.asarray(res["test_error"], np.float64).flatten()
    names = ["over_all"] + list(OP_INDEX.keys())
    acc = {k: round(1.0 - v, 4) for k, v in zip(names, err.tolist())}
    # omit EMPTY test buckets (zero questions — e.g. the supervision
    # families, which T4 excludes): they'd render as fake 1.0 accuracies
    counts = res.get("test_counts")
    if counts is not None:
        empty = {names[j] for j in range(len(names)) if counts[j] == 0}
        acc = {k: v for k, v in acc.items() if k not in empty}
    row = dict(
        stage=i, version=cfg["version"], families=st["fams"],
        lengths=list(st["lens"]), train_split=st["split"], epochs=cfg["epoch_num"],
        learning_rate=lr,
        calibrator=bool(cfg.get("activate_attention_transfer")),
        device=(torch.cuda.get_device_name(device) if torch.device(device).type == "cuda"
                else "cpu"),
        backend=torch.device(device).type,
        test_acc_overall=acc["over_all"],
        test_acc_per_family={k: v for k, v in acc.items() if k != "over_all"},
        seconds=round(dt, 1),
    )
    with open(os.path.join(root, f"stage_{i}.json"), "w") as f:
        json.dump(row, f, indent=1)
    return row, res


def write_artifact(args, world, results, total_seconds):
    artifact = dict(
        device=(results[0].get("device") if results else None),
        backend=(results[0].get("backend") if results else None),
        world=dict(nouns=world.nouns,
                   categories=[[c, o] for c, o in world.categories],
                   n_images=len(world.image_ids), noise=args.noise,
                   box_dim=world.box_dim, scale=args.scale, epoch_scale=args.epoch_scale),
        test_set=dict(families=T4, lengths=[0, 1, 2],
                      questions_per_file=int(128 * args.scale),
                      scenes="held-out (image_slice 0.925-1.0)"),
        stages=results,
        trajectory=[r["test_acc_overall"] for r in results],
        calibrator_gain=(
            round(results[-1]["test_acc_overall"] - results[5]["test_acc_overall"], 4)
            if len(results) == 8 else None),
        total_seconds=round(total_seconds, 1),
    )
    out_json = args.json or os.path.join(args.out, "CURRICULUM.json")
    with open(out_json, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"[curriculum] wrote {out_json}")
    print(json.dumps({"trajectory": artifact["trajectory"],
                      "calibrator_gain": artifact["calibrator_gain"]}))
    return artifact


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--noise", type=float, default=0.35)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="dataset size multiplier (0.25 for a quick pilot)")
    ap.add_argument("--epoch-scale", type=float, default=1.0)
    ap.add_argument("--out", default="curriculum_run",
                    help="output directory (datasets, checkpoints, stage rows)")
    ap.add_argument("--json", default=None, help="artifact output path")
    ap.add_argument("--stages", default=None, help="comma list, e.g. 0,1,2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--stage-lr", default=None,
                    help="per-stage LR overrides, e.g. '6:1e-3,7:5e-4'")
    ap.add_argument("--resume", action="store_true",
                    help="skip stages whose stage_N.json already exists in --out "
                         "(crash recovery; checkpoints and datasets are reused)")
    return ap.parse_args(argv)


def main(argv=None):
    """The CLI, on the JAX script's planted world (``WORLD``) and widths
    (``TINY_OVERRIDES``). Returns the stage rows and, for the stages run
    here, their ``run`` results."""
    from dfol_vqa_tpu_torch.data.planted import PlantedWorld
    from dfol_vqa_tpu_torch.ontology import GQAOntology

    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the curriculum runs on the card; pass --cpu to "
                           "run it on the CPU")
    device = "cpu" if args.cpu else "cuda"
    root = args.out
    os.makedirs(root, exist_ok=True)
    ontology = GQAOntology()
    world = PlantedWorld(ontology, noise=args.noise, seed=args.seed, **WORLD)
    print(f"[curriculum] planted world: nouns={world.nouns} "
          f"categories={world.categories} noise={args.noise}", flush=True)

    t0 = time.time()
    made = prepare_datasets(world, ontology, root, args.scale,
                            f"scale={args.scale} noise={args.noise} seed={args.seed}")
    print(f"[curriculum] datasets ready in {time.time() - t0:.1f}s", flush=True)

    lr_over = {}
    if args.stage_lr:
        for part in args.stage_lr.split(","):
            k, v = part.split(":")
            lr_over[int(k)] = float(v)
    run_stages = ([int(s) for s in args.stages.split(",")] if args.stages
                  else [st["i"] for st in STAGES])
    experiment = PlantedCurriculumExperiment(world)
    rows, results = [], {}
    for st in STAGES:
        i = st["i"]
        if i not in run_stages:
            continue
        stage_json = os.path.join(root, f"stage_{i}.json")
        if args.resume and os.path.exists(stage_json):
            with open(stage_json) as f:
                rows.append(json.load(f))
            print(f"[curriculum] stage {i} already done — skipping "
                  f"(acc={rows[-1]['test_acc_overall']})", flush=True)
            continue
        row, results[i] = run_stage(experiment, st, root, made, args.epoch_scale,
                                    lr_over.get(i, st["lr"]), args.seed, device,
                                    TINY_OVERRIDES)
        rows.append(row)
        print(f"[curriculum] stage {i} done in {row['seconds']:.0f}s: "
              f"overall test acc={row['test_acc_overall']:.4f}", flush=True)

    if len(rows) == len(STAGES):
        write_artifact(args, world, rows, time.time() - t0)
    return rows, results


if __name__ == "__main__":
    main()
