"""Preprocessing CLI (reference: src/gqa_preprocess.py:365-398).

The PyTorch port's own copy of ``dfol_vqa_tpu/compiler/preprocess_cli.py``, which it must not import
(the port imports nothing of the JAX package); it behaves exactly as
that module, and tests/test_torch_host.py holds the two equal.

    python -m dfol_vqa_tpu_torch.compiler.preprocess_cli questions.json out_dir -b -g [-l]
"""

import argparse
import os
from os.path import isfile, join, split, splitext

from dfol_vqa_tpu_torch.compiler.preprocess import GQAPreprocessor
from dfol_vqa_tpu_torch.ontology import GQAOntology


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("input_file", help="The input file")
    parser.add_argument("output_path", help="The output path")
    parser.add_argument("-b", "--h5", help="Generate h5 format", action="store_true")
    parser.add_argument("-l", "--length_segregation", help="Segregate based on length",
                        action="store_true")
    parser.add_argument("-g", "--discard_global", help="Discard global questions",
                        action="store_true")
    args = parser.parse_args(argv)

    ontology = GQAOntology()
    gqap = GQAPreprocessor(ontology._op_map, True)

    input_path, input_file = split(args.input_file)
    if isfile(args.input_file):
        input_file, _ = splitext(input_file)

    output_path = join(args.output_path, "p_" + input_file)
    os.makedirs(output_path, exist_ok=True)
    gqap.preprocess(
        args.input_file,
        join(output_path, "p_" + input_file + ".json"),
        True,
        args.length_segregation,
        discard_global=args.discard_global,
    )

    if args.h5:
        from dfol_vqa_tpu_torch.compiler.h5_codec import ProgramH5Codec
        import json

        codec = ProgramH5Codec(ontology)
        h5_output_path = join(args.output_path, "h5_" + input_file)
        os.makedirs(h5_output_path, exist_ok=True)
        for f in sorted(os.listdir(output_path)):
            if not f.endswith(".json"):
                continue
            with open(join(output_path, f)) as fh:
                qs = [json.loads(line) for line in fh if line.strip()]
            if qs:
                codec.write_h5(qs, join(h5_output_path, splitext(f)[0] + ".h5"))


if __name__ == "__main__":
    main()
