"""Typed configuration schema with the reference YAML surface.

A frozen copy of the PyTorch port's module of the same name, for the
benchmark's reference (``benchmark/reference/__init__.py``).

The upstream framework consumes one flat ~45-key YAML dict with no schema
(reference: CONFIG_YAML.md:1-107, loaded in base_experiment.py:43-47 and
probed with ``'key' in config`` all over). We keep the exact same YAML keys
(including the upstream typo ``ckeckpointing_frequency``) so reference
config files load unchanged, but validate them into a typed dataclass, and
add a ``tpu`` section for the TPU-native knobs (mesh shape, static-shape
padding ladders, dtypes).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import yaml


@dataclass
class TPUConfig:
    """TPU-native execution knobs (new; no reference analog)."""

    max_object_num: int = 48  # dense object-axis padding (GQA h5 max is 100)
    rel_table_size: int = 8  # per-question relation-table slots R
    option_pad_ladder: Tuple[int, ...] = (2, 4, 8, 16, 32, 64, 128, 192)
    branch_len_ladder: Tuple[int, ...] = (2, 4, 6, 8, 10)
    mesh_shape: Tuple[int, ...] = (1,)  # (data,) or (data, model)
    mesh_axes: Tuple[str, ...] = ("data",)
    compute_dtype: str = "float32"  # matmul input dtype ("bfloat16" on TPU)
    rel_stream_dtype: str = "bfloat16"  # HBM storage dtype of the shared
    # O^2 pair code h2 on the Pallas path. The kernel is h2-gather
    # bandwidth-bound, and at JAX's default TPU matmul precision f32
    # operands are decomposed to bf16 for the MXU anyway, so bf16 storage
    # is BIT-IDENTICAL to the f32-stored default-precision path while
    # halving the dominant HBM traffic (O=100: 0.73 -> 0.57 ms/batch).
    # Set "float32" when running under jax.default_matmul_precision-style
    # full-precision overrides.
    cache_dtype: str = "float32"  # HBM storage dtype of the oracle's
    # likelihood CACHES: the (U, V+1, O) attribute cache and the
    # (B, R, O, O) relation cache — the two largest eval-step HBM writers
    # (the step is bandwidth-bound, BENCH r3 mfu_ladder). "bfloat16" halves
    # that traffic; every consumer gathers then upcasts, so all fuzzy-logic
    # arithmetic stays fp32 — only the stored log-likelihoods round
    # (~0.4% relative). Unlike rel_stream_dtype this is NOT bit-identical:
    # near-ties within bf16 epsilon can flip, so the default stays fp32
    # (bitwise reference parity) and production serving/bench enable bf16,
    # with answer-losslessness pinned by tests/test_bf16.py fuzz sweeps.
    # "auto" picks per-dims from the measured table below (VERDICT r4
    # item 6): bf16's halved stream only wins once the batch is large
    # enough that bandwidth, not dispatch latency, limits the step.

    rel_route: str = "auto"  # shared-image relation-path route at O >= 64
    # on TPU: "pallas" (fused pair-MLP + shared-contract Mosaic kernels),
    # "xla" (same math XLA-lowered + contract-then-gather), or "auto" =
    # measured per-dims table (scripts/o100_route_table.py, O100_ROUTE.json)

    def resolve_rel_route(self, o: int, batch: int) -> str:
        """Kernel vs XLA tail for the shared-image relation path.

        Measured table (O100_ROUTE.json, TPU v5e, r5): after the
        vocab-major attribute cache and contract-then-gather landed, the
        XLA tail beats the Mosaic kernel route at O=100/B=32 (0.333 vs
        0.377 ms full model — the kernel's VMEM win no longer covers its
        launch overhead there); the kernel keeps winning at the
        bandwidth-saturating batch (B=256)."""
        if self.rel_route != "auto":
            return self.rel_route
        return "xla" if batch < 256 else "pallas"

    def resolve_cache_dtype(self, batch: int) -> str:
        """Storage dtype for the likelihood caches at this batch size.

        Measured table (BENCH_DETAIL_r04 mfu_ladder, TPU v5e): bf16 caches
        LOSE at batch 32 (60.6k -> 60.1k qps at O=100 — the step is
        dispatch/latency-bound and the extra converts don't pay) and WIN at
        batch >= 256 (52.2k -> 55.1k at O=100, 419k -> 487k at O=24/1024 —
        bandwidth-bound, stream halving dominates)."""
        if self.cache_dtype != "auto":
            return self.cache_dtype
        return "bfloat16" if batch >= 256 else "float32"
    vocab_pad_multiple: int = 128  # pad the embedding head's vocab dim to a
    # lane multiple (2335 -> 2432): MXU-aligned matmuls + evenly shardable
    # over the model mesh axis; padded columns are never addressed (codes
    # are 1..2335)
    use_pallas: bool = True  # fused Pallas relation kernels (Mosaic); only
    # engaged when the backend is TPU — CPU always takes the XLA paths
    # (interpret-mode kernels would be a silent slowdown)
    fused_pair_mlp: bool = True  # Mosaic path only: compute the O^2 pair
    # MLP trunk in a Pallas kernel that keeps every hidden activation in
    # VMEM (ops/pallas/pair_mlp.py) instead of round-tripping each
    # (U, O_pad, O_pad, H) layer through HBM. Falls back to XLA when
    # inter-layer dropout is active or compute_dtype != float32.
    rel_contract_then_gather: bool = True  # shared-image relation path,
    # XLA tail (small O / CPU): contract the per-unique-image pair code h2
    # (U, O, O, E) against the RELATION sub-vocabulary (E, K~333) once,
    # then gather the per-question (B, R, O, O) slices — instead of
    # gathering h2 to (B, O, O, E) and contracting per question. Bytes go
    # from ~2*B*O^2*E to ~2*U*O^2*K: at GQA's ~10 questions/image this is
    # ~10x less relation-path HBM traffic at large batch (the r4 mfu_ladder
    # O=24 batch>=256 droop). Same contraction (identical values; order of
    # the E-reduction unchanged), so parity holds to float addition
    # associativity. Disable to force the per-question formulation.
    train_chunk: int = 8  # same-bucket train steps fused into one device
    # dispatch (lax.scan); amortizes per-dispatch RPC on remote frontends
    # (~4x train throughput on the remote-TPU frontend, BENCH r1/r2). The
    # production default; checkpointing triggers at chunk boundaries so
    # fusion is never broken. Set to 1 to dispatch per step. Composes with
    # a device mesh: the chunk (scan) axis stays unsharded while the
    # per-step batch axes shard over 'data' (parallel/mesh.py
    # shard_train_chunk; chunked+sharded == unsharded sequence, tested).
    eval_chunk: int = 8  # same-bucket eval batches fused into one device
    # dispatch (interpreter.step_packed_many lax.scan) in test_epoch /
    # predict — the eval-side analog of train_chunk; amortizes the
    # per-dispatch RPC on remote frontends. 1 = dispatch per batch.
    pad_chunks: bool = True  # pad partial train/eval chunks up to the full
    # chunk length (duplicating the tail batch; padded train steps are
    # n_valid-gated no-ops) so EVERY tail length shares one executable per
    # bucket spec. Without it each distinct tail length k is a fresh XLA
    # compile — a cold curriculum stage paid up to chunk extra compiles per
    # spec, and on a degraded shared compile service one stray compile
    # stalled a stage ~40 min (CURRICULUM_r03 stage 4/6 cold times).
    group_specs: bool = False  # opt-in: reorder each training epoch so
    # same-bucket batches run in chunk-length runs (loader group_chunk).
    # Makes real mixed-family epochs chunk-shaped (the proportional-random
    # order yields mostly runs of 1-3, so fused dispatch rarely engages);
    # deviates from the reference's i.i.d. file sampling ORDER (the batch
    # multiset per epoch is unchanged), so off by default.
    rel_block_size: int = 0  # 0 = no chunking of the O^2 relation pass
    donate_state: bool = True
    fsdp: bool = False  # ZeRO-3 analog: shard params/optimizer state over
    # the data axis (parallel/mesh.py param_sharding); all-gather-on-use
    loader_workers: int = 0  # >0: fork that many batch-producer processes
    # (host compile/collate is GIL-bound; see data/loader.py)
    async_save: bool = True  # overlap checkpoint file writes with the next
    # train chunk (train/checkpoint.py wait_pending drains; crash-saves are
    # always synchronous). Host snapshot stays synchronous — donation safety.
    checkpoint_backend: str = "npz"  # "npz" (single atomic file) or "orbax"
    # (directory; async/multi-host-friendly — each host writes only its
    # addressable shards); load() auto-detects either format
    debug_checks: bool = False  # opt-in loud-failure guards for invariants
    # the compiler guarantees but hand-built batches can violate; currently:
    # the contract-then-gather relation path NaN-poisons any non-pad
    # rel_token outside the relation sub-vocabulary (which would otherwise
    # silently score as logsigmoid(bias) instead of the per-question path's
    # real-embedding contraction — see models/oracle.py). Off in
    # production: the check adds a select over the (B, R, O^2) result.


@dataclass
class Config:
    # identity / paths (CONFIG_YAML.md:3-31)
    model_name: str = "model"
    version: str = "v0"
    train_path: Optional[str] = None
    train_object_path: Optional[str] = None
    train_object_info_path: Optional[str] = None
    validation_path: Optional[str] = None
    test_path: Optional[str] = None
    image_path: Optional[str] = None
    model_path: str = "./runs"
    attribute_file: Optional[str] = None
    class_file: Optional[str] = None
    relation_file: Optional[str] = None
    frequency_file: Optional[str] = None
    word_embedding_file: Optional[str] = None
    vocabulary_file: Optional[str] = None
    metadata_file: Optional[str] = None  # consolidated asset (new)
    h5_prefix: str = "gqa_objects"
    h5_chunk_num: int = 16

    # loop control (CONFIG_YAML.md:35-41)
    repetition_num: int = 1
    epoch_num: int = 1
    error_dim: int = 1
    metric_index: int = 0

    # optimisation (CONFIG_YAML.md:43-55)
    train_batch_size: int = 80
    test_batch_size: int = 80
    learning_rate: float = 1e-4
    weight_decay: float = 1e-10
    dropout: float = 0.1
    clip_norm: float = 0.65
    l1_lambda: float = 0.0

    # misc
    verbose: bool = True
    max_cache_size: int = 100000

    # model dims (CONFIG_YAML.md:59-67)
    box_features_dim: int = 2048
    oracle_input_dim: int = 512
    oracle_output_dim: int = 1
    word_embedding_dim: int = 300
    relation_features_dim: Optional[int] = None

    # oracle architecture (CONFIG_YAML.md:69-79)
    classifier_oracle: bool = True
    featurizer_layers_config: Optional[List[int]] = field(default_factory=list)
    attribute_network_layers_config: Optional[List[int]] = field(default_factory=lambda: [256])
    relation_network_layers_config: Optional[List[int]] = field(default_factory=lambda: [256])
    operator_layers_config: Optional[List[int]] = field(default_factory=list)
    normalize_oracle: bool = True

    # freezing (CONFIG_YAML.md:81-87)
    freeze_featurizer: bool = False
    freeze_attribute_network: bool = False
    freeze_relation_network: bool = False
    freeze_embedding_network: bool = False
    freeze_embedding_bias: bool = False

    # attention transfer / calibration (CONFIG_YAML.md:89-93)
    activate_attention_transfer: bool = False
    attention_transfer_state_dim: int = 50
    freeze_attention_network: bool = False
    apply_modulation_everywhere: bool = True

    # inference behavior (CONFIG_YAML.md:95-99)
    trainable_gate: bool = False
    likelihood_threshold: float = 0.0
    hard_mode: bool = False
    first_answer: bool = False

    # runtime (CONFIG_YAML.md:101-107)
    cpu_cores_num: Optional[int] = None
    in_memory: bool = True
    gpu_num: Optional[int] = None  # reference GPU count; here = device count cap
    checkpointing_frequency: int = 1000

    tpu: TPUConfig = field(default_factory=TPUConfig)

    # ------------------------------------------------------------------ utils

    @property
    def attr_input_dim(self) -> int:
        """Oracle attribute input: featurized objects ‖ 4 positional dims
        (gqa_interpreter_experiments.py:147)."""
        base = (
            self.oracle_input_dim
            if self.featurizer_layers_config is not None
            else self.box_features_dim
        )
        return base + 4

    @property
    def rel_input_dim(self) -> int:
        """Relation oracle input: subj ‖ obj ‖ dist,angle,h_side,v_side
        (gqa_interpreter_experiments.py:167, batch_gqa_boxfeatures_pipeline.py:256-279)."""
        if self.relation_features_dim is not None:
            return self.relation_features_dim
        return 2 * self.attr_input_dim + 4

    @property
    def embedding_input_dim(self) -> int:
        """gqa_interpreter_experiments.py:150."""
        if self.attribute_network_layers_config is None:
            return self.attr_input_dim
        return self.word_embedding_dim

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        d = dict(d)
        # upstream typo kept as an accepted alias (CONFIG_YAML.md:105)
        if "ckeckpointing_frequency" in d:
            d.setdefault("checkpointing_frequency", d.pop("ckeckpointing_frequency"))
        tpu_dict = d.pop("tpu", {}) or {}
        known = {f.name for f in dataclasses.fields(Config)}
        unknown = {k: v for k, v in d.items() if k not in known}
        clean = {k: v for k, v in d.items() if k in known}
        cfg = Config(**clean)
        tpu_known = {f.name for f in dataclasses.fields(TPUConfig)}
        tpu_clean = {k: (tuple(v) if isinstance(v, list) else v) for k, v in tpu_dict.items() if k in tpu_known}
        cfg.tpu = TPUConfig(**tpu_clean)
        cfg._extras = unknown  # preserved for forward-compat probing
        return cfg

    @staticmethod
    def from_yaml(path_or_dict) -> "Config":
        """Accepts a YAML path or a dict, like base_experiment.py:43-47."""
        if isinstance(path_or_dict, dict):
            return Config.from_dict(path_or_dict)
        with open(path_or_dict, "r") as f:
            return Config.from_dict(yaml.safe_load(f))

    def get(self, key, default=None):
        if hasattr(self, key):
            return getattr(self, key)
        return getattr(self, "_extras", {}).get(key, default)
