"""kaiju (PyTorch/CUDA port): taxonomic read classification CLI.

Flag surface of the reference `kaiju` binary (src/kaiju.cpp:427-451).
This port classifies `-a mem` with a taxonomy on the GPU:

    python -m kaiju_tpu_torch.tools.kaiju -t nodes.dmp -f db.fmi \
        -i reads.fastq -a mem -o out.tsv
"""

from __future__ import annotations

import argparse
import sys

from ..io.fastx import read_reads
from ..io.taxonomy import Taxonomy, parse_nodes_dmp
from .common import (
    add_engine_args,
    classify_stream,
    config_from_args,
    load_index,
    make_runner,
    open_output,
)


def build_parser():
    ap = argparse.ArgumentParser(prog="kaiju-tpu-torch", description=__doc__)
    ap.add_argument("-t", dest="nodes", required=True, help="nodes.dmp file")
    ap.add_argument("-p", dest="protein", action="store_true",
                    help="input sequences are protein sequences")
    add_engine_args(ap)
    return ap


def main(argv=None, device=None):
    """Run the CLI; device: None for the GPU, "cpu" for the plain
    versions on the CPU."""
    args = build_parser().parse_args(argv)
    if args.protein and args.input2:
        print("Error: Protein input only supports one input file.", file=sys.stderr)
        return 1
    cfg = config_from_args(args)
    index = load_index(args.fmi)
    tax = Taxonomy(parse_nodes_dmp(args.nodes))
    runner = make_runner(index, tax, cfg, args=args, device=device)
    out = open_output(args.output)
    reads = read_reads(args.input1, args.input2)
    try:
        classify_stream(runner, reads, out, cfg, args.batch_size)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
