"""dfol_vqa_tpu_torch: the PyTorch/CUDA port of dfol_vqa_tpu.

The JAX package stays the reference; this package keeps its module names and
public tensor layouts and runs on an NVIDIA Hopper card (H100), with every
TPU kernel rewritten by hand in CUDA C++ (``csrc/``).
It imports ``torch``, and nothing of ``jax`` or of ``dfol_vqa_tpu``: it
carries its own copies of the numpy-only host modules (``ontology``,
``config``, ``compiler``, ``data.dataset``, ``data.loader``,
``data.features``, ``data.planted``). Its entry points run on the card
unless the caller passes ``device="cpu"``.

Ported so far — the serving slice: ``logic``, ``types``, ``nn``,
``models.featurizer``, ``models.oracle``, ``ops.cells``,
``ops.relation_oracle`` (+ ``csrc/relation_oracle.cu``),
``models.interpreter``, ``data.transfer``, ``serve`` and ``convert``; the
offline-evaluation slice: ``oracle.rel_cache_shared``, ``ops.pair_mlp``
(+ ``csrc/pair_mlp.cu``), ``ops.shared_contract`` (+
``csrc/shared_contract.cu``), ``train.trainer``, ``train.checkpoint`` and
``data.evalset``; the training slice: the loss in ``models.interpreter``,
the backward kernel of ``ops.relation_oracle`` (+
``csrc/relation_oracle_bwd.cu``), autograd for ``ops.pair_mlp`` and
``ops.shared_contract``, ``train.optim``, ``VQATrainer.train``,
asynchronous checkpoints and ``data.trainset``; then the host modules'
copies, and kernels 1 and 2 on the tensor cores (``csrc/pair_tail_tile.cuh``);
every terminal, the calibrator and F > 1; and the user entry points:
``experiments`` (the experiment CLI and the curriculum chain) and the
preprocessing CLI ``compiler.preprocess_cli``.
"""

__version__ = "0.1.0"
