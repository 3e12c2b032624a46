"""dfol_vqa_tpu_torch: the PyTorch/CUDA port of dfol_vqa_tpu.

The JAX package stays the reference; this package keeps its module names and
public tensor layouts and runs on an NVIDIA Hopper card (H100), with every
TPU kernel on a ported path rewritten by hand in CUDA C++ (``csrc/``).
It imports ``torch`` and never ``jax``; the numpy-only host modules
(ontology, config, program compiler, loader, features, planted world) are
shared with ``dfol_vqa_tpu``.

Ported so far — the serving slice: ``logic``, ``types``, ``nn``,
``models.featurizer``, ``models.oracle``, ``ops.cells``,
``ops.relation_oracle`` (+ ``csrc/relation_oracle.cu``),
``models.interpreter``, ``data.transfer``, ``serve`` and ``convert``; the
offline-evaluation slice: ``oracle.rel_cache_shared``, ``ops.pair_mlp``
(+ ``csrc/pair_mlp.cu``), ``ops.shared_contract`` (+
``csrc/shared_contract.cu``), ``train.trainer``, ``train.checkpoint`` and
``data.evalset``.
"""

__version__ = "0.1.0"
