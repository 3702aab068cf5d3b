"""kaiju (PyTorch/CUDA port): taxonomic read classification CLI.

Flag surface of the reference `kaiju` binary (src/kaiju.cpp:427-451).
This port classifies Greedy (the default) and `-a mem` with a taxonomy on
the GPU, with or without the verbose columns of `-v`; `-d` traces each
read on stderr through the exact host engine.  Without `-v` and `-d`,
`--mesh-index S` splits the index into S shards over every card of the
process, each card classifying its share of every batch, and the run
may be split over N processes, each writing its share of the reads:

    python -m kaiju_tpu_torch.tools.kaiju -t nodes.dmp -f db.fmi \
        -i reads.fastq -o out.tsv [-a mem] [-v] [--mesh-index S]
        [--dist-nprocs N --dist-coordinator host:port --dist-pid p]
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
    print_verbose_parameters,
)


def build_parser():
    ap = argparse.ArgumentParser(prog="kaiju-tpu-torch", description=__doc__)
    ap.add_argument("-t", dest="nodes", required=True, help="nodes.dmp file")
    ap.add_argument("-p", dest="protein", action="store_true",
                    help="input sequences are protein sequences")
    add_engine_args(ap)
    return ap


def main(argv=None, device=None):
    """Run the CLI; device: None for the GPU (with many processes, the
    process's share of its machine's cards; with --mesh-index in one
    process, every visible card), "cpu" for the plain versions on the CPU,
    or a list of devices, the process's cards with --mesh-index or many
    processes (tools.common.make_runner)."""
    args = build_parser().parse_args(argv)
    if args.protein and args.input2:
        print("Error: Protein input only supports one input file.", file=sys.stderr)
        return 1
    cfg = config_from_args(args)
    if cfg.verbose:
        print_verbose_parameters(cfg, args)
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
        if hasattr(runner, "close"):  # the threads of a run over cards
            runner.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
