"""Training, offline evaluation and prediction: the JAX package's
``VQATrainer``.

Port of ``dfol_vqa_tpu/train/trainer.py``: ``train`` (per step: forward,
the loss normalised by the batch's real questions, backward, clip + decay +
Adam from ``train/optim.py``; per epoch the loss and error arrays,
mid-epoch validation and saves every ``checkpointing_frequency`` steps,
best/last checkpoints, the crash save in ``finally``, ``losses.npy`` and
``errors.npy``), the 17-bucket per-terminal-op error accounting
(``OP_INDEX``, ``test_epoch`` with ``last_test_counts``), ``test``
(optionally loading a checkpoint first), ``predict`` (prediction JSON, GQA
submission mode), ``decode_answers`` and hard/easy example mining. Batches
come from the JAX package's numpy-only ``BatchLoader``, whose batches
deduplicate images: a relating batch whose unique images U satisfy
U * 2 <= B takes the shared-image relation route, any other the
per-question route (``Interpreter.build_world``).

Each batch is copied to the device (``data/transfer.to_device_batch``).
Evaluation runs ``Interpreter.forward`` under ``torch.inference_mode()``;
its outputs stay on the device and are read back once, after the last batch
(per batch only when hardset mining needs the answers). Training keeps each
step's loss on the device and reads the epoch's losses back once. The JAX
package's ``tpu.train_chunk`` / ``eval_chunk`` / ``pad_chunks`` scan fusion
exists to amortise an RPC to a remote TPU per dispatch; the port dispatches
one batch at a time, and whether it needs the fusion is a measurement for
later (ROADMAP queue 5).
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dfol_vqa_tpu.config import Config
from dfol_vqa_tpu.data.loader import LoadedBatch
from dfol_vqa_tpu_torch.data.transfer import to_device_batch
from dfol_vqa_tpu_torch.models.interpreter import (
    Interpreter,
    decode_answer_flags,
    question_type_of,
)
from dfol_vqa_tpu_torch.models.oracle import OracleParams
from dfol_vqa_tpu_torch.train import checkpoint as ckpt
from dfol_vqa_tpu_torch.train.optim import Optimizer, build_optimizer
from dfol_vqa_tpu_torch.types import QuestionType

# per-terminal-op metric buckets (reference trainer.py:64-83)
OP_INDEX = OrderedDict(
    [
        ("query_attr", 1), ("choose_attr", 2), ("verify_attrs", 3), ("choose_rel", 4),
        ("verify_rel", 5), ("exist", 6), ("and", 7), ("or", 8), ("all_same", 9),
        ("all_different", 10), ("two_same", 11), ("two_different", 12), ("compare", 13),
        ("object_attr", 14), ("object_rel", 15), ("scene", 16),
    ]
)
ERROR_DIM = len(OP_INDEX) + 1


def readback(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Device tensors -> float32 numpy arrays of the same shapes, with one
    device-to-host copy for all of them."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).float() for t in tensors]).cpu().numpy()
    parts = np.split(flat, np.cumsum([t.numel() for t in tensors])[:-1])
    return [p.reshape(tuple(t.shape)) for p, t in zip(parts, tensors)]


class VQATrainer:
    """Trains and evaluates on one device (``device``, default CPU);
    ``params`` passed to its methods live on that device."""

    def __init__(
        self,
        cfg: Config,
        interpreter: Interpreter,
        logger: Optional[logging.Logger] = None,
        hardset_path: Optional[str] = None,
        device="cpu",
    ):
        self.cfg = cfg
        self.interp = interpreter
        self.logger = logger or logging.getLogger("dfol_vqa_tpu_torch")
        self.device = torch.device(device)
        self.global_step = 0
        self.last_test_counts: Optional[np.ndarray] = None
        self._hardset_path = hardset_path
        self._hardset: Optional[dict] = None
        self._easyset: Optional[dict] = None
        self._best_error = np.inf

    # ------------------------------------------------------------- utilities

    def _prepare_output_metric_dict(self, error: np.ndarray) -> dict:
        return dict(zip(["over_all"] + list(OP_INDEX.keys()), error.flatten().tolist()))

    def decode_answers(self, flags: np.ndarray, batch: LoadedBatch) -> List[List[str]]:
        """Answer flags (host) -> answer-string lists (ties kept, in option
        order), as the serving engine decodes them."""
        return decode_answer_flags(flags, batch.spec, batch.compiled)

    # ------------------------------------------------------------------ train

    def compute_grads(self, params: OracleParams, batch: LoadedBatch,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward and backward on ``batch``: sets the ``.grad`` of
        ``params`` (None for a parameter the batch does not reach) and
        returns the loss normalised by the batch's real questions, a 0-d
        tensor on the device (not read back)."""
        _, objects, obj_mask, arrays = to_device_batch(batch, self.device)
        for p in params.parameters():
            p.grad = None
        out = self.interp.forward(params, objects, obj_mask, arrays, batch.spec,
                                  is_training=True, generator=generator)
        loss = out["loss"] / torch.clamp(torch.sum(arrays["question_mask"]), min=1.0)
        loss.backward()
        return loss.detach()

    def train_step(self, params: OracleParams, opt: Optimizer, batch: LoadedBatch,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``compute_grads``, then one optimizer step; returns the loss."""
        loss = self.compute_grads(params, batch, generator)
        opt.step()
        return loss

    def train(
        self,
        train_loader,
        validation_loader,
        params: OracleParams,
        *,
        metric_index: int = 0,
        last_export_path_base: Optional[str] = None,
        best_export_path_base: Optional[str] = None,
        seed: int = 0,
        load_model: Optional[str] = None,
        reset_step: bool = False,
    ) -> Tuple[OracleParams, np.ndarray, np.ndarray]:
        """``cfg.repetition_num`` x ``cfg.epoch_num`` epochs over
        ``train_loader``, updating ``params`` in place; returns
        (params, errors (ERROR_DIM, epochs, reps), losses (epochs, reps)), as
        the JAX trainer does.

        Per repetition ``load_model`` ("best"/"last") reloads that checkpoint
        (a missing file is skipped) and ``reset_step`` zeroes the step; the
        optimizer state carries over. Per epoch: the loss is the
        question-weighted mean of the step losses; with ``validation_loader``
        the epoch's error vector comes from ``test_epoch``, a lower
        ``errors[metric_index]`` saves "best", and every
        ``checkpointing_frequency`` steps a mid-epoch validation saves "last"
        (and "best" when not worse). "last" is saved synchronously in a
        ``finally`` after every epoch, so a step that raises still leaves the
        last good parameters on disk. ``losses.npy`` and ``errors.npy`` go to
        ``best_export_path_base``.

        Two differences from the JAX trainer. It dispatches one step at a
        time and checks ``checkpointing_frequency`` after every step; JAX
        checks at dispatch boundaries, which are every step only with
        ``tpu.train_chunk=1``. Randomness (dropout masks) comes from a
        ``torch.Generator`` seeded with ``seed``, so with dropout on the masks
        differ from JAX's; the repository trains with ``dropout=0.0``."""
        cfg = self.cfg
        opt = build_optimizer(cfg, params)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        errors = np.zeros((ERROR_DIM, cfg.epoch_num, cfg.repetition_num), np.float32)
        losses = np.zeros((cfg.epoch_num, cfg.repetition_num), np.float32)
        self._best_error = np.inf

        for rep in range(cfg.repetition_num):
            ckpt.wait_pending()  # a reload must see complete files
            path = {"best": best_export_path_base, "last": last_export_path_base}.get(load_model)
            if path:
                try:
                    self._load_into(path, params)
                except FileNotFoundError:
                    pass
            if reset_step:
                self.global_step = 0
            for epoch in range(cfg.epoch_num):
                start = time.time()
                try:
                    step_losses: List[torch.Tensor] = []
                    sizes: List[int] = []
                    next_ckpt = self.global_step + cfg.checkpointing_frequency
                    for batch in train_loader:
                        step_losses.append(self.train_step(params, opt, batch, generator))
                        sizes.append(batch.batch_size)
                        self.global_step += 1
                        if validation_loader is not None and self.global_step >= next_ckpt:
                            next_ckpt = self.global_step + cfg.checkpointing_frequency
                            self._checkpoint_mid_epoch(validation_loader, params, metric_index,
                                                       last_export_path_base,
                                                       best_export_path_base)
                    if step_losses:
                        ls = readback([torch.stack(step_losses)])[0]
                        losses[epoch, rep] = float(ls @ np.asarray(sizes, np.float64)) / max(
                            sum(sizes), 1)
                    if validation_loader is not None:
                        errors[:, epoch, rep] = self.test_epoch(validation_loader, params)
                finally:
                    if last_export_path_base:
                        ckpt.wait_pending()
                        self._save(last_export_path_base, params, sync=True)
                if (validation_loader is not None and best_export_path_base
                        and errors[metric_index, epoch, rep] < self._best_error):
                    self._best_error = errors[metric_index, epoch, rep]
                    self._save(best_export_path_base, params)
                if cfg.verbose:
                    self.logger.info(
                        "Rep %d, Epoch %d: Step %d, Best Err %.5f: error=%s, loss=%.5f (%.1fs)",
                        rep + 1, epoch + 1, self.global_step, self._best_error,
                        self._prepare_output_metric_dict(errors[:, epoch, rep]),
                        losses[epoch, rep], time.time() - start)

        ckpt.wait_pending()  # every asynchronous write is on disk before returning
        if best_export_path_base:
            os.makedirs(best_export_path_base, exist_ok=True)
            np.save(os.path.join(best_export_path_base, "losses"), losses, allow_pickle=False)
            np.save(os.path.join(best_export_path_base, "errors"), errors, allow_pickle=False)
        return params, errors, losses

    def _checkpoint_mid_epoch(self, validation_loader, params: OracleParams, metric_index: int,
                              last_export_path_base: Optional[str],
                              best_export_path_base: Optional[str]) -> None:
        """Validate, save "last", and "best" when the error is not worse."""
        err = self.test_epoch(validation_loader, params)
        if last_export_path_base:
            self._save(last_export_path_base, params)
        if best_export_path_base and err[metric_index] <= self._best_error:
            self._best_error = err[metric_index]
            self._save(best_export_path_base, params)
        if self.cfg.verbose:
            self.logger.info("Checkpointing: Step %d, Best Err %.5f: error=%s", self.global_step,
                             self._best_error, self._prepare_output_metric_dict(err))

    def _batches(self, loader, params: OracleParams
                 ) -> Iterator[Tuple[LoadedBatch, Dict[str, torch.Tensor]]]:
        """(batch, outputs on the device) for every batch of ``loader``."""
        for batch in loader:
            _, objects, obj_mask, arrays = to_device_batch(batch, self.device)
            with torch.inference_mode():
                out = self.interp.forward(params, objects, obj_mask, arrays, batch.spec)
            yield batch, out

    # ------------------------------------------------------------------- test

    def test_epoch(self, loader, params: OracleParams) -> np.ndarray:
        """One evaluation pass with 17-bucket error accounting: returns the
        error rate per bucket (0 for an empty bucket); the per-bucket
        question counts land in ``last_test_counts``."""
        batches: List[LoadedBatch] = []
        matches: List = []
        for batch, out in self._batches(loader, params):
            batches.append(batch)
            if self._hardset is not None:
                match = readback([out["match"]])[0] * batch.compiled.question_mask
                self._mine_hardset(batch, match)
                matches.append(match)
            else:
                matches.append(out["match"])
        if self._hardset is None:
            matches = readback(matches)
        error = np.zeros(ERROR_DIM, np.float32)
        total = np.zeros(ERROR_DIM, np.float32)
        for batch, match in zip(batches, matches):
            qm = batch.compiled.question_mask
            match = match * qm
            n = qm.sum()
            err = float(n - match.sum())
            # terminals without a bucket (e.g. 'end') count toward over_all only
            op_i = OP_INDEX.get(batch.spec.terminal_op)
            error[0] += err
            total[0] += n
            if op_i is not None:
                error[op_i] += err
                total[op_i] += n
        self.last_test_counts = total.copy()
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(total > 0, error / np.maximum(total, 1), 0.0)

    def test(self, loader, params: OracleParams, import_path_base: Optional[str] = None):
        """``test_epoch`` (after loading ``import_path_base`` when given)
        with hardset dumps; returns (error, seconds)."""
        if import_path_base is not None:
            params = self.load(import_path_base, params)
        if self._hardset_path is not None:
            self._hardset, self._easyset = {}, {}
        start = time.time()
        error = self.test_epoch(loader, params)
        duration = time.time() - start
        if self._hardset_path is not None:
            self._dump_hardsets()
        if self.cfg.verbose:
            self.logger.info("error=%s", self._prepare_output_metric_dict(error))
            self.logger.info("Time spent: %s seconds", duration)
        return error, duration

    # ---------------------------------------------------------------- predict

    def predict(self, loader, params: OracleParams, out_file,
                import_path_base: Optional[str] = None, is_submission: bool = False):
        """Predictions for every real question, written to ``out_file`` as
        JSON and returned."""
        if import_path_base is not None:
            params = self.load(import_path_base, params)
        batches, flags = [], []
        for batch, out in self._batches(loader, params):
            batches.append(batch)
            flags.append(out["answer_flags"])
        predictions: List[dict] = []
        for batch, f in zip(batches, readback(flags)):
            answers = self.decode_answers(f > 0.5, batch)
            qtype = question_type_of(batch.spec.terminal_op)
            qm = batch.compiled.question_mask
            for qi, qid in enumerate(batch.compiled.question_ids):
                if qm[qi] == 0:
                    continue
                ans = answers[qi]
                if is_submission:
                    predictions.append({"questionId": qid, "prediction": ans[0] if ans else ""})
                elif qtype == QuestionType.QUERY:
                    predictions.append({
                        "questionId": qid,
                        "prediction": ans,
                        "type": "open" if batch.spec.terminal_op == "query_attr" else "binary",
                        "options": batch.compiled.option_strings[qi],
                    })
                else:
                    predictions.append({"questionId": qid,
                                        "prediction": ans[0] if ans else "",
                                        "type": "binary"})
        json.dump(predictions, out_file)
        return predictions

    # ---------------------------------------------------------------- hardset

    def _mine_hardset(self, batch: LoadedBatch, match: np.ndarray):
        if batch.compiled.original is None:
            return
        os.makedirs(os.path.join(self._hardset_path, "hard"), exist_ok=True)
        os.makedirs(os.path.join(self._hardset_path, "easy"), exist_ok=True)
        op = batch.spec.terminal_op
        hard_f = os.path.join(self._hardset_path, "hard", f"hard_{op}.json")
        easy_f = os.path.join(self._hardset_path, "easy", f"easy_{op}.json")
        with open(hard_f, "a") as hf, open(easy_f, "a") as ef:
            for qi, q in enumerate(batch.compiled.original):
                if batch.compiled.question_mask[qi] == 0:
                    continue
                qid = batch.compiled.question_ids[qi]
                if match[qi] >= 1.0:
                    ef.write(json.dumps(q) + "\n")
                    self._easyset[qid] = q
                else:
                    hf.write(json.dumps(q) + "\n")
                    self._hardset[qid] = q

    def _dump_hardsets(self):
        with open(os.path.join(self._hardset_path, "hard.json"), "w") as f:
            json.dump(self._hardset, f)
        with open(os.path.join(self._hardset_path, "easy.json"), "w") as f:
            json.dump(self._easyset, f)

    # ------------------------------------------------------------ checkpoints

    def _save(self, export_path_base: str, params: OracleParams, sync: bool = False) -> None:
        ckpt.save(export_path_base, self.cfg.model_name, params, self.global_step,
                  backend=self.cfg.tpu.checkpoint_backend,
                  async_write=self.cfg.tpu.async_save and not sync)

    def load(self, import_path_base: str, params: OracleParams) -> OracleParams:
        params, self.global_step = ckpt.load(import_path_base, self.cfg.model_name, params)
        return params

    def _load_into(self, import_path_base: str, params: OracleParams) -> None:
        """``load``, copied into ``params`` in place (the optimizer holds
        references to its tensors)."""
        loaded = self.load(import_path_base, params)
        with torch.no_grad():
            for p, q in zip(params.parameters(), loaded.parameters()):
                p.copy_(q)
