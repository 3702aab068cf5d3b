"""kaiju-tpu-mkdb (PyTorch/CUDA port): build a ktx index from a
taxon-labeled protein FASTA.

Equivalent of kaiju-mkbwt + kaiju-mkfmi (reference: src/bwt/mkbwt.c,
mkfmi.c) in one step: linear-time native suffix sorting, plain-array
output with a text copy (``text.npy``), which turns on the Bloom screen
and the text-compare hybrid of the classifier.  Can also convert an
existing reference .fmi (no text copy).  The output directory is
byte-identical to ``kaiju_tpu.tools.mkdb``'s:

    python -m kaiju_tpu_torch.tools.mkdb -o db.ktx [--kmer] db.faa
"""

from __future__ import annotations

import argparse
import sys
import time

from ..index import fmi_reader, native_builder
from ..index.py_builder import read_fasta_records


def main(argv=None, device=None):
    """Run the CLI; device: where --kmer builds the seed tables through
    kernel A (None for the GPU, "cpu" for the plain version)."""
    ap = argparse.ArgumentParser(prog="kaiju-tpu-torch-mkdb",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("-o", dest="output", required=True, help="output ktx directory")
    ap.add_argument("-e", dest="chpt_exp", type=int, default=3,
                    help="SA sample spacing exponent (default 3)")
    ap.add_argument("-a", dest="alphabet", default="ACDEFGHIKLMNPQRSTVWY",
                    help="letter alphabet (terminator is implicit), or "
                         "DNA / RNA / protein (reference: mkbwt.c:882-903)")
    ap.add_argument("-r", dest="revcomp", action="store_true",
                    help="append the reverse complement of every sequence "
                         "(DNA only; reference: readFasta.c:187-205)")
    ap.add_argument("-l", dest="length_mb", type=float, default=0.0,
                    help="length of the concatenated sequence in millions "
                         "(required when reading FASTA from stdin; "
                         "reference: mkbwt_vars.h:263, mkbwt.c:950)")
    ap.add_argument("-s", dest="revsort", action="store_true",
                    help="terminators sort as reversed sequences instead "
                         "of input order (reference: mkbwt.c:803-817)")
    ap.add_argument("-c", dest="case_sens", action="store_true",
                    help="case-sensitive sequence reading")
    ap.add_argument("--from-fmi", dest="from_fmi",
                    help="convert a reference .fmi instead of building from FASTA")
    ap.add_argument("--kmer", dest="kmer", action="store_true",
                    help="also precompute k-mer seed tables (on the device)")
    ap.add_argument("--aot", dest="aot", action="store_true",
                    help="prebuild the device programs next to the index "
                         "(not ported yet)")
    ap.add_argument("-t", dest="nodes", default=None,
                    help="nodes.dmp (for --aot)")
    ap.add_argument("--aot-batch", dest="aot_batch", type=int, default=None,
                    help="read-batch bucket to prebuild (for --aot)")
    ap.add_argument("input", nargs="?", help="protein FASTA (headers: acc_taxid)")
    args = ap.parse_args(argv)
    if args.aot or args.aot_batch is not None:
        raise NotImplementedError(
            "--aot / --aot-batch: warm start is ROADMAP.md queue 1 item 11")

    t0 = time.time()
    if args.from_fmi:
        index = fmi_reader.read_fmi(args.from_fmi)
    else:
        if not args.input:
            ap.error("need an input FASTA (or --from-fmi); use '-' to "
                     "read from stdin")
        if args.input == "-" and args.length_mb <= 0:
            # mirror the reference's stdin contract (mkbwt.c:950): the
            # hint sizes its mmap; our in-memory reader only needs the
            # flag surface, so we enforce presence but not the value
            ap.error("need -l (length in millions) when reading from "
                     "stdin")
        records = read_fasta_records(args.input)
        print(f"read {len(records)} sequences", file=sys.stderr)
        from ..index.alphabet import (
            NAMED_ALPHABETS,
            revcomp_dna,
            trans_table,
        )

        alphabet = NAMED_ALPHABETS.get(args.alphabet, "*" + args.alphabet)
        if args.revcomp:
            # the reference documents -r as "Works only for DNA"
            # (mkbwt_vars.h:266); revcomp_dna complements A<->T, so an
            # RNA alphabet (*ACGUN) would silently wildcard-corrupt
            # every reverse strand — reject it
            if args.alphabet != "DNA":
                ap.error("-r (reverse complement) works only for DNA")
            records = records + [
                (name, revcomp_dna(seq)) for name, seq in records
            ]
        import numpy as np

        table = trans_table(alphabet, case_sens=args.case_sens)
        names_in = [name for name, _ in records]
        seqs = []
        for _, seq in records:
            raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
            codes = table[raw]
            seqs.append(codes[codes > 0].astype(np.uint8))
        if args.revsort:
            # terminator order = ascending order of REVERSED sequences
            # (reference: mkbwt.c compare_strings_reverse / revSortSeqs);
            # feeding records in that order makes the builders' natural
            # input-order terminator tie-break produce the revsort BWT
            order = sorted(
                range(len(seqs)), key=lambda i: bytes(seqs[i][::-1])
            )
            names_in = [names_in[i] for i in order]
            seqs = [seqs[i] for i in order]
        index = native_builder.build_index_from_codes(
            names_in, seqs, chpt_exp=args.chpt_exp, alphabet=alphabet
        )
    print(
        f"index built in {time.time()-t0:.1f}s: length={index.length} "
        f"nseq={index.nseq}",
        file=sys.stderr,
    )
    index.save(args.output)
    if args.kmer:
        from ..ops.device_index import DeviceIndex
        from ..ops.kmer import KmerTables, default_depth

        t0 = time.time()
        KmerTables.load_or_build(index, args.output, default_depth(index),
                                 device_index=DeviceIndex(index, device))
        print(f"k-mer seed tables built in {time.time()-t0:.1f}s", file=sys.stderr)
    print(f"saved to {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
