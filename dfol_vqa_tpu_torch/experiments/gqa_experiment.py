"""CLI entry point (reference: src/gqa_interpreter_experiments.py:266-283).

    python -m dfol_vqa_tpu_torch.experiments.gqa_experiment config.yaml -s 0 \
        [-t] [-l best|last] [-p] [-o hardset_dir] [-u] [-r] [-c]

Port of ``dfol_vqa_tpu/experiments/gqa_experiment.py`` with the same flags.
It runs on the CUDA card; ``-c`` runs on the CPU instead. Without ``-c`` and
without a card it raises rather than carry on on the CPU. Under ``torchrun``
it trains over a device mesh, one process per device (``tpu.mesh_shape``
must cover the processes; ``parallel/mesh.py``):

    torchrun --nproc-per-node 4 -m dfol_vqa_tpu_torch.experiments.gqa_experiment cfg.yaml
    torchrun --standalone --nproc-per-node 2 \
        -m dfol_vqa_tpu_torch.experiments.gqa_experiment cfg.yaml -c   # 2 CPU processes

``--local_rank`` is accepted and ignored (``LOCAL_RANK`` picks the card).
"""

import argparse

import torch

from dfol_vqa_tpu_torch.experiments.experiment import GQAObjectBoxExperiment


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", help="The configuration yaml file")
    parser.add_argument("-t", "--test", help="The test mode", action="store_true")
    parser.add_argument("-l", "--load_model", help="Load the previous model (last|best)")
    parser.add_argument("-c", "--cpu_mode", help="Run on CPU", action="store_true")
    parser.add_argument("-r", "--reset", help="Reset the global step", action="store_true")
    parser.add_argument("-s", "--seed", help="Random seed", type=int, default=0)
    parser.add_argument("-p", "--predict", help="Make predictions", action="store_true")
    parser.add_argument("-v", "--visualize", help="Visualize reasoning", action="store_true")
    parser.add_argument("-o", "--hardset_path", help="The output path for hardset",
                        type=str, default=None)
    parser.add_argument("-u", "--submission", help="Is the prediction file for submission",
                        action="store_true")
    parser.add_argument("--local_rank", default=0, type=int)
    args = parser.parse_args(argv)

    if not args.cpu_mode and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this CLI runs on the card; pass -c (--cpu_mode) "
                           "to run on the CPU")

    experiment = GQAObjectBoxExperiment()
    return experiment.run(
        args.config,
        is_training=not args.test,
        load_model=args.load_model,
        reset_step=args.reset,
        predict=args.predict,
        visualize=args.visualize,
        seed=args.seed,
        hardset_path=args.hardset_path,
        is_submission=args.submission,
        device="cpu" if args.cpu_mode else "cuda",
    )


if __name__ == "__main__":
    main()
