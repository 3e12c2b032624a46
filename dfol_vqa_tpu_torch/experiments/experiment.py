"""Experiment runner: config -> ontology -> model -> trainer -> loops.

Port of ``dfol_vqa_tpu/experiments/experiment.py``, the template-method
experiment layer mirroring ExperimentBase (reference:
src/nsvqa/base_experiment.py:11-134): YAML (or dict) config, logging setup,
best/last checkpoint directories under
``model_path/model_name/version/{best,last}``, build steps overridable by
subclasses, then train -> predict -> test, with the same return dict.

It runs on ``device`` (the card unless the caller asks for the CPU). Under
``torchrun`` (or with ``DFOL_DISTRIBUTED``, a multi-host launch, or a
``tpu.mesh_shape`` of more than one device) it runs on a device mesh
(``parallel/mesh.py``): one process per device, the mesh built from
``tpu.mesh_shape`` / ``tpu.mesh_axes`` / ``tpu.fsdp`` over the launch's
processes (a shape that does not cover them exactly raises), each loader
sharded by data rank at ``batch_size / n_data`` rows, and the trainer
stepping in lockstep; rank 0 writes the files. ``visualize`` runs the
visualization epoch (``viz.visualize_loop``) over the test set, one
question a batch, on one device.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from dfol_vqa_tpu_torch.compiler.program_compiler import ProgramCompiler
from dfol_vqa_tpu_torch.config import Config
from dfol_vqa_tpu_torch.data.dataset import GQADataManager
from dfol_vqa_tpu_torch.data.features import FeatureSource, GQAHdf5Features, SyntheticFeatures
from dfol_vqa_tpu_torch.data.loader import BatchLoader
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ontology import GQAOntology
from dfol_vqa_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    distributed_requested,
    make_mesh,
)
from dfol_vqa_tpu_torch.train.trainer import VQATrainer


class ExperimentBase:
    mesh: Optional[Mesh] = None

    def build_ontology(self, cfg: Config, logger) -> GQAOntology:
        raise NotImplementedError

    def build_interpreter(self, cfg: Config, ontology, logger) -> Interpreter:
        raise NotImplementedError

    def build_features(self, cfg: Config, logger) -> FeatureSource:
        raise NotImplementedError

    def build_compiler(self, cfg: Config, ontology, shuffle_choose: bool) -> ProgramCompiler:
        return ProgramCompiler(
            ontology,
            object_num=cfg.tpu.max_object_num,
            rel_slots=cfg.tpu.rel_table_size,
            option_pad_ladder=cfg.tpu.option_pad_ladder,
            shuffle_choose=shuffle_choose,
        )

    def build_loader(
        self, cfg: Config, path, ontology, features, batch_size: int,
        shuffle: bool, keep_original: bool = False,
    ) -> Optional[BatchLoader]:
        if path is None:
            return None
        manager = GQADataManager(path, ontology, cfg.in_memory)
        compiler = self.build_compiler(cfg, ontology, shuffle_choose=shuffle)
        num_shards, shard_index, rows = batch_sharding(self.mesh, batch_size)
        return BatchLoader(
            manager.datasets, compiler, features, rows, cfg.tpu.max_object_num,
            shuffle=shuffle,
            num_shards=num_shards,
            shard_index=shard_index,
            keep_original=keep_original,
            num_workers=cfg.tpu.loader_workers,
            group_chunk=(cfg.tpu.train_chunk
                         if cfg.tpu.group_specs and shuffle else 0),
        )

    def run(
        self,
        config_file,
        is_training: bool = True,
        load_model: Optional[str] = None,
        reset_step: bool = False,
        predict: bool = False,
        visualize: bool = False,
        seed: Optional[int] = 0,
        hardset_path: Optional[str] = None,
        is_submission: bool = False,
        device="cuda",
    ):
        cfg = Config.from_yaml(config_file)
        self.mesh = None
        if distributed_requested(cfg):
            if visualize:
                raise ValueError("visualize runs on one device, not under a device mesh")
            self.mesh = make_mesh(cfg.tpu.mesh_shape, cfg.tpu.mesh_axes, device=device,
                                  fsdp=cfg.tpu.fsdp)
            device = self.mesh.device

        logging.basicConfig(
            level=logging.DEBUG if cfg.verbose else logging.INFO,
            format="[%(levelname)s] %(asctime)s - %(name)s: %(message)s",
        )
        logger = logging.getLogger(f"{cfg.model_name} ({cfg.version})")

        best_path = os.path.join(os.path.relpath(cfg.model_path), cfg.model_name, cfg.version, "best")
        last_path = os.path.join(os.path.relpath(cfg.model_path), cfg.model_name, cfg.version, "last")
        os.makedirs(best_path, exist_ok=True)
        os.makedirs(last_path, exist_ok=True)

        ontology = self.build_ontology(cfg, logger)
        interp = self.build_interpreter(cfg, ontology, logger)
        features = self.build_features(cfg, logger)
        trainer = VQATrainer(cfg, interp, logger, hardset_path=hardset_path, device=device,
                             mesh=self.mesh)

        params = interp.init_params(torch.Generator().manual_seed(seed or 0), device)
        if not is_training:  # training reloads per repetition inside train()
            if load_model == "best":
                params = trainer.load(best_path, params)
            elif load_model == "last":
                params = trainer.load(last_path, params)
        if reset_step:
            trainer.global_step = 0

        if cfg.verbose:
            logger.info("The model parameter count is %d.", interp.parameter_count(params))

        train_error, train_loss = None, None
        if is_training:
            logger.info("Starting the training phase...")
            train_loader = self.build_loader(
                cfg, cfg.train_path, ontology, features, cfg.train_batch_size, shuffle=True
            )
            val_loader = self.build_loader(
                cfg, cfg.validation_path, ontology, features, cfg.test_batch_size, shuffle=False
            )
            params, train_error, train_loss = trainer.train(
                train_loader, val_loader, params,
                metric_index=cfg.metric_index,
                last_export_path_base=last_path,
                best_export_path_base=best_path,
                seed=seed or 0,
                load_model=load_model,
                reset_step=reset_step,
            )

        import_path = {"best": best_path, "last": last_path}.get(load_model)
        test_error = test_time = None

        if visualize:
            from dfol_vqa_tpu_torch.viz import visualize_loop

            viz_loader = self.build_loader(
                cfg, cfg.test_path, ontology, features, 1, shuffle=False, keep_original=True
            )
            visualize_loop(trainer, interp, viz_loader, params, cfg.image_path, import_path)
        elif predict:
            prediction_path = os.path.join(
                os.path.relpath(cfg.model_path), "predictions", cfg.model_name, cfg.version
            )
            os.makedirs(prediction_path, exist_ok=True)
            test_loader = self.build_loader(
                cfg, cfg.test_path, ontology, features, cfg.test_batch_size, shuffle=False
            )
            file_name = os.path.basename(str(cfg.test_path))
            if trainer.writes_files:
                with open(os.path.join(prediction_path, f"prediction_{file_name}.json"),
                          "w") as f:
                    trainer.predict(test_loader, params, f, import_path_base=import_path,
                                    is_submission=is_submission)
            else:
                trainer.predict(test_loader, params, None, import_path_base=import_path,
                                is_submission=is_submission)

        if not is_submission and cfg.test_path is not None:
            test_loader = self.build_loader(
                cfg, cfg.test_path, ontology, features, cfg.test_batch_size,
                shuffle=False, keep_original=hardset_path is not None,
            )
            test_error, test_time = trainer.test(test_loader, params, import_path_base=import_path)

        return {
            "params": params,
            "train_loss": train_loss,
            "train_error": train_error,
            "test_error": test_error,
            "test_time": test_time,
            # per-bucket test question counts (0 = empty bucket, no signal)
            "test_counts": getattr(trainer, "last_test_counts", None),
        }


class GQAObjectBoxExperiment(ExperimentBase):
    """Concrete GQA experiment (gqa_interpreter_experiments.py:81-264)."""

    def build_ontology(self, cfg: Config, logger) -> GQAOntology:
        if cfg.verbose:
            logger.info("Building the ontology...")
        if cfg.vocabulary_file:
            return GQAOntology(
                attribute_json_path=cfg.attribute_file,
                class_json_path=cfg.class_file,
                vocab_json_file=cfg.vocabulary_file,
                relation_json_path=cfg.relation_file,
                embedding_file=cfg.word_embedding_file,
                embedding_dim=cfg.word_embedding_dim,
            )
        return GQAOntology(
            metadata_path=cfg.metadata_file,
            embedding_file=cfg.word_embedding_file,
            embedding_dim=cfg.word_embedding_dim,
        )

    def build_interpreter(self, cfg: Config, ontology, logger) -> Interpreter:
        if cfg.verbose:
            logger.info("Building the interpreter (cached oracle mode)...")
        return Interpreter(cfg, ontology)

    def build_features(self, cfg: Config, logger) -> FeatureSource:
        if cfg.train_object_path and os.path.isdir(cfg.train_object_path):
            if cfg.verbose:
                logger.info("Using GQA HDF5 object features from %s", cfg.train_object_path)
            return GQAHdf5Features(
                cfg.train_object_path, cfg.h5_prefix, cfg.h5_chunk_num,
                cfg.train_object_info_path,
            )
        logger.warning("No GQA object features found; using synthetic scenes.")
        return SyntheticFeatures(box_dim=cfg.box_features_dim)
