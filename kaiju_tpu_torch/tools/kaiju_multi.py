"""kaiju-multi (PyTorch/CUDA port): classify several samples with one
index load (reference: src/kaiju-multi.cpp).

-i, -j and -o take comma-separated lists, one entry a sample; the index,
the taxonomy and the engine are made once and the samples run one after
another through them, each into its own output file, or all to stdout in
sample order without -o.  The modes are those of the port's `kaiju`, on
the GPU, --mesh-index and --dist-* included (with many processes each
sample's stream ends at a barrier of all of them):

    python -m kaiju_tpu_torch.tools.kaiju_multi -t nodes.dmp -f db.fmi \
        -i s1.fastq,s2.fastq -o s1.tsv,s2.tsv [-a mem] [-v]
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
    print_verbose_parameters,
)


def main(argv=None, device=None):
    """Run the CLI; device: None for the GPU (with many processes, the
    process's share of its machine's cards; with --mesh-index in one
    process, every visible card), "cpu" for the plain versions on the CPU,
    or a list of devices, the process's cards with --mesh-index or many
    processes (tools.common.make_runner)."""
    ap = argparse.ArgumentParser(prog="kaiju-multi-tpu-torch",
                                 description=__doc__)
    ap.add_argument("-t", dest="nodes", required=True, help="nodes.dmp file")
    add_engine_args(ap)
    args = ap.parse_args(argv)

    in1 = args.input1.split(",")
    in2 = args.input2.split(",") if args.input2 else [None] * len(in1)
    outs = args.output.split(",") if args.output else [None] * len(in1)
    if len(in2) != len(in1):
        print("Error: -i and -j lists have different lengths", file=sys.stderr)
        return 1
    if args.output and len(outs) != len(in1):
        print("Error: -i and -o lists have different lengths", file=sys.stderr)
        return 1

    cfg = config_from_args(args)
    if cfg.verbose:
        print_verbose_parameters(cfg, args, multi=True)
    index = load_index(args.fmi)
    tax = Taxonomy(parse_nodes_dmp(args.nodes))
    runner = make_runner(index, tax, cfg, args=args, device=device)

    try:
        for f1, f2, fo in zip(in1, in2, outs):
            out = open(fo, "w") if fo else sys.stdout
            try:
                classify_stream(runner, read_reads(f1, f2), out, cfg,
                                args.batch_size)
            finally:
                if fo:
                    out.close()
    finally:
        if hasattr(runner, "close"):  # the threads of a run over cards
            runner.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
