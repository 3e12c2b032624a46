"""The graft entry points of the port: a forward on the flagship model and a
dry run over a device mesh.

Port of the repository's ``__graft_entry__.py`` (which stays the JAX
package's):

* ``entry(device)`` returns ``(fn, example_args)``: ``fn(params, objects,
  obj_mask, arrays)`` is the interpreter's forward on the flagship model
  (``Config()`` widths with the attention-transfer calibrator on, O=16,
  batch 8, ``exist`` questions of length 2), giving ``log_probability``;
  ``params`` is the name -> tensor dict of ``serve.param_tensors``.
* ``dryrun_multichip(n)`` runs one training step (forward, backward, Adam)
  and one eval dispatch over an ``(n/2, 2)`` ``('data', 'model')`` mesh
  when n is even and > 2 (FSDP over ``data``, the concept head split over
  ``model``), else over ``(n,)``, through the training mesh of
  ``parallel/mesh.py``: one process per rank, which this function spawns
  itself with a file rendezvous (``parallel/launch.run_processes``), as
  JAX's dry run provisions its own devices. Rank r runs on card r over
  NCCL; ``device="cpu"`` runs the ranks on the CPU over gloo.

    python -m dfol_vqa_tpu_torch.graft_entry N
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRYRUN_TIMEOUT = 600  # seconds a dry run's processes may take together


def _build(batch_size: int = 8, object_num: int = 16, length: int = 2, seed: int = 0,
           device="cuda", num_shards: int = 1, shard_index: int = 0):
    """JAX's flagship setup: ``Config()`` (2048-d boxes -> 512-d oracle,
    300-d GloVe, V=2,335) with the calibrator on, weights drawn from
    ``seed`` on the CPU and moved to ``device``, and the first
    ``BatchLoader`` batch of ``batch_size`` ``exist`` questions of
    ``length`` (shard ``shard_index`` of ``num_shards``: ``batch_size /
    num_shards`` of them). Returns (cfg, interpreter, params, batch)."""
    from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
    from dfol_vqa_tpu_torch.config import Config
    from dfol_vqa_tpu_torch.data.dataset import ProgramDataset
    from dfol_vqa_tpu_torch.data.features import SyntheticFeatures
    from dfol_vqa_tpu_torch.data.loader import BatchLoader
    from dfol_vqa_tpu_torch.data.synthetic import generate_questions
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter
    from dfol_vqa_tpu_torch.ontology import GQAOntology

    cfg = Config()
    cfg.tpu.max_object_num = object_num
    cfg.activate_attention_transfer = True
    ont = GQAOntology()
    interp = Interpreter(cfg, ont)
    params = interp.init_params(torch.Generator().manual_seed(seed), device=device)
    qs = generate_questions(ont, batch_size, terminal="exist", length=length, seed=seed)
    compiler = ProgramCompiler(ont, object_num=object_num, rel_slots=cfg.tpu.rel_table_size)
    feats = SyntheticFeatures(box_dim=cfg.box_features_dim, min_objects=4,
                              max_objects=object_num)
    loader = BatchLoader([ProgramDataset(qs, ont)], compiler, feats, batch_size // num_shards,
                         object_num, shuffle=False, prefetch=0, num_shards=num_shards,
                         shard_index=shard_index)
    return cfg, interp, params, next(iter(loader))


def entry(device="cuda"):
    """(fn, example_args): the flagship model's forward and its inputs on
    ``device``; ``fn(*example_args)`` is the batch's (8,) log-probability."""
    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.serve import bind_params, param_tensors

    cfg, interp, params, batch = _build(device=device)
    spec = batch.spec

    def fn(params_by_name, objects, obj_mask, arrays):
        out = interp.forward(bind_params(params, params_by_name), objects, obj_mask, arrays,
                             spec)
        return out["log_probability"]

    _, objects, obj_mask, arrays = to_device_batch(batch, device)
    return fn, (param_tensors(params), objects, obj_mask, arrays)


def dryrun_layout(n_devices: int) -> tuple:
    """(mesh_shape, mesh_axes) of a dry run over ``n_devices``, JAX's."""
    if n_devices > 2 and n_devices % 2 == 0:
        return (n_devices // 2, 2), ("data", "model")
    return (n_devices,), ("data",)


def _dryrun_rank(job_path: str) -> None:
    """One rank of ``dryrun_multichip``: join the mesh, take one training
    step on this data rank's rows of the global batch and one eval forward,
    and write what rank 0 reports to ``rank<r>.json``."""
    import torch.distributed as dist

    from dfol_vqa_tpu_torch.data.transfer import to_device_batch
    from dfol_vqa_tpu_torch.parallel.mesh import make_mesh, shard_params
    from dfol_vqa_tpu_torch.train import graphs
    from dfol_vqa_tpu_torch.train.optim import build_optimizer
    from dfol_vqa_tpu_torch.train.trainer import VQATrainer

    with open(job_path) as f:
        job = json.load(f)
    n, rank = job["world"], job["rank"]
    shape, axes = dryrun_layout(n)
    device = f"cuda:{rank}" if job["device"] == "cuda" else job["device"]
    if device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(shape, axes, device=device, fsdp=shape[0] > 1, init_method=job["init"],
                     rank=rank, world_size=n, backend=job["backend"])
    batch_size = max(2 * mesh.n_data, 4)
    cfg, interp, params, batch = _build(batch_size=batch_size, object_num=8, length=2,
                                        device=mesh.device, num_shards=mesh.n_data,
                                        shard_index=mesh.data_rank)
    state = shard_params(mesh, params)
    opt = build_optimizer(cfg, params, state)
    trainer = VQATrainer(cfg, interp, mesh=mesh)
    # the global count and the global batch's flags (types.batch_flags)
    ((batch, count),) = next(trainer.mesh_groups([batch], 1))
    before = graphs.launch_counts() if mesh.device.type == "cuda" else [0, 0, 0, 0]
    generator = torch.Generator(mesh.device).manual_seed(mesh.seed(0))
    loss = trainer.train_step(state, opt, batch, generator, count=count)
    dist.all_reduce(loss, group=mesh.data_group)
    # the eval dispatch on the same mesh: forward only, this data rank's rows
    working = state.gather()
    _, objects, obj_mask, arrays = to_device_batch(batch, mesh.device)
    with torch.no_grad():
        out = interp.forward(working, objects, obj_mask, arrays, batch.spec)
    state.release()
    after = graphs.launch_counts() if mesh.device.type == "cuda" else [0, 0, 0, 0]
    rows = mesh.gather_objects({"log_p": out["log_probability"].cpu().numpy().tolist(),
                                "flag_rows": int(out["answer_flags"].shape[0])})
    result = {"rank": rank, "mesh": dict(zip(axes, shape)), "loss": float(loss),
              "log_p": [x for r in rows for x in r["log_p"]],
              "flag_rows": sum(r["flag_rows"] for r in rows), "batch_size": batch_size,
              "launches": [b - a for a, b in zip(before, after)],
              "backend": str(dist.get_backend()), "device": str(mesh.device)}
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = DRYRUN_TIMEOUT) -> dict:
    """One sharded training step and one sharded eval dispatch over
    ``n_devices`` ranks (``dryrun_layout``), each rank a process of its own.
    ``device``: "cuda" (rank r on card r, NCCL; raises with fewer than
    ``n_devices`` cards), one card that every rank shares, e.g. "cuda:0"
    (gloo), or "cpu" (gloo). Asserts a finite loss, finite
    log-probabilities and the global batch's answer flags, prints JAX's
    ``dryrun_multichip ok`` line and returns rank 0's report (with every
    rank's kernel launches under ``launches``)."""
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) on real devices sees only "
                           f"{torch.cuda.device_count()} card(s)")
    from dfol_vqa_tpu_torch.parallel.launch import run_processes

    work = tempfile.mkdtemp(prefix="dfol_dryrun_")
    try:
        job = {"world": n_devices, "device": device, "out": work,
               "backend": "nccl" if device == "cuda" else "gloo",
               "init": "file://" + os.path.join(work, "rdv")}
        commands = []
        for rank in range(n_devices):
            path = os.path.join(work, f"job{rank}.json")
            with open(path, "w") as f:
                json.dump(dict(job, rank=rank), f)
            commands.append([sys.executable, "-c", "from dfol_vqa_tpu_torch import graft_entry; "
                             f"graft_entry._dryrun_rank({path!r})"])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
        run_processes(commands, work, timeout, f"dryrun_multichip({n_devices})", cwd=ROOT,
                      env=env)
        reports = []
        for rank in range(n_devices):
            with open(os.path.join(work, f"rank{rank}.json")) as f:
                reports.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rep = reports[0]
    log_p = np.asarray(rep["log_p"])
    if not np.isfinite(rep["loss"]):
        raise AssertionError(f"non-finite loss in multichip dryrun: {rep['loss']}")
    if not np.all(np.isfinite(log_p)):
        raise AssertionError("non-finite eval log-probs in multichip dryrun")
    if rep["flag_rows"] != rep["batch_size"] or len(log_p) != rep["batch_size"]:
        raise AssertionError(f"multichip dryrun answered {rep['flag_rows']} of "
                             f"{rep['batch_size']} questions")
    rep["launches"] = [sum(r["launches"][i] for r in reports) for i in range(4)]
    print(f"dryrun_multichip ok: mesh={rep['mesh']} loss={rep['loss']:.4f} "
          f"eval_logp_mean={float(log_p.mean()):.4f}")
    return rep


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
