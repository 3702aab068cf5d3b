"""kaijup (PyTorch/CUDA port): taxonomy-free protein search
(reference: src/kaijup.cpp).

Searches protein sequences against a protein database without a taxonomy
and reports the names of the matching database sequences, on the GPU:

    python -m kaiju_tpu_torch.tools.kaijup -f db.fmi -i proteins.faa \
        -o out.tsv [-a mem] [-v]
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
    ap = argparse.ArgumentParser(prog="kaijup-tpu-torch", description=__doc__)
    add_engine_args(ap, protein_tool=True)
    args = ap.parse_args(argv)
    cfg = config_from_args(args, taxonomy_free=True, protein=True)
    index = load_index(args.fmi)
    runner = make_runner(index, None, cfg, args=args, device=device)
    out = open_output(args.output)
    reads = ((n, s, None) for n, s, _ in read_reads(args.input1))
    try:
        classify_stream(runner, reads, out, cfg, args.batch_size)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
