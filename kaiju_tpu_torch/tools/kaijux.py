"""kaijux (PyTorch/CUDA port): taxonomy-free DNA read search
(reference: src/kaijux.cpp).

Searches the reads against a protein database without a taxonomy and
reports, for each classified read, the names of the matching database
sequences; MEM (`-a mem`) or Greedy (the default), with or without `-v`,
on the GPU:

    python -m kaiju_tpu_torch.tools.kaijux -f db.fmi -i reads.fastq \
        [-j reads_2.fastq] -o out.tsv [-a mem] [-v]
"""

from __future__ import annotations

import argparse
import sys

from ..io.fastx import read_reads
from .common import (
    add_engine_args,
    classify_stream,
    config_from_args,
    load_index,
    make_runner,
    open_output,
)


def main(argv=None, device=None):
    """Run the CLI; device: None for the GPU, "cpu" for the plain
    versions on the CPU."""
    ap = argparse.ArgumentParser(prog="kaijux-tpu-torch", description=__doc__)
    add_engine_args(ap)
    args = ap.parse_args(argv)
    cfg = config_from_args(args, taxonomy_free=True)
    index = load_index(args.fmi)
    runner = make_runner(index, None, cfg, args=args, device=device)
    out = open_output(args.output)

    # the two files of a pair are searched as independent reads under one
    # name (reference: README.md:335-343)
    def reads():
        for name, s1, s2 in read_reads(args.input1, args.input2):
            yield name, s1, None
            if s2 is not None:
                yield name, s2, None

    try:
        classify_stream(runner, reads(), out, cfg, args.batch_size)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
