"""kaiju-tpu-mkdb (PyTorch/CUDA port): build a ktx index from a
taxon-labeled protein FASTA.

Equivalent of kaiju-mkbwt + kaiju-mkfmi (reference: src/bwt/mkbwt.c,
mkfmi.c) in one step: linear-time native suffix sorting, plain-array
output with a text copy (``text.npy``), which turns on the Bloom screen
and the text-compare hybrid of the classifier.  Can also convert an
existing reference .fmi (no text copy).  The output directory is
byte-identical to ``kaiju_tpu.tools.mkdb``'s:

    python -m kaiju_tpu_torch.tools.mkdb -o db.ktx [--kmer] db.faa
    python -m kaiju_tpu_torch.tools.mkdb -o db.ktx --aot -t nodes.dmp db.faa

``--aot`` (warm start, ``kaiju_tpu``'s flag) implies ``--kmer`` and pays
beside the index what a fresh classify process would pay: it builds every
kernel library into ``db.ktx/aot/<key>/`` (``utils/aot.py``), then
classifies one synthetic batch of ``--aot-batch`` reads in each mode with
those libraries, which writes the seed tables and, on an index with a
text copy, both Bloom bitmaps.  Unlike their first-use caches, it raises
when it cannot write them.
"""

from __future__ import annotations

import argparse
import os
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
                    help="prebuild the kernel libraries next to the index "
                         "and write the seed tables and Bloom bitmaps of "
                         "both modes there, so that no classify process "
                         "pays them (requires -t; implies --kmer)")
    ap.add_argument("-t", dest="nodes", default=None,
                    help="nodes.dmp (needed by --aot: the warm-up batch "
                         "is classified with the taxonomy)")
    ap.add_argument("--aot-batch", dest="aot_batch", type=int,
                    default=4096, help="reads of the warm-up batch of "
                    "--aot (default 4096)")
    ap.add_argument("input", nargs="?", help="protein FASTA (headers: acc_taxid)")
    args = ap.parse_args(argv)
    if args.aot and not args.nodes:
        ap.error("--aot needs -t nodes.dmp (the warm-up batch is "
                 "classified with the taxonomy)")

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
    if args.aot:
        t0 = time.time()
        prebuild_aot(index, args.output, args.nodes, args.aot_batch, device)
        print(f"warm start prebuilt in {time.time()-t0:.1f}s",
              file=sys.stderr)
    elif args.kmer:
        build_kmer(index, args.output, device)
    print(f"saved to {args.output}", file=sys.stderr)
    return 0


def build_kmer(index, ktx_dir: str, device=None) -> int:
    """The seed tables of the default depth (--kmer), through kernel A on
    `device`, saved in ktx_dir/kmer<depth>; returns the depth."""
    from ..ops.device_index import DeviceIndex
    from ..ops.kmer import KmerTables, default_depth

    t0 = time.time()
    K = default_depth(index)
    KmerTables.load_or_build(index, ktx_dir, K,
                             device_index=DeviceIndex(index, device))
    print(f"k-mer seed tables built in {time.time()-t0:.1f}s", file=sys.stderr)
    return K


def prebuild_aot(index, ktx_dir: str, nodes_path: str, batch: int = 4096,
                 device=None) -> None:
    """Warm start (--aot): on the card, build every kernel library into
    utils.aot.prebuilt_dir(ktx_dir) and load from there; then the seed
    tables of --kmer; then classify one synthetic batch (random.Random(7),
    200-base reads, as kaiju_tpu's prebuild_aot) through MemPipeline and
    GreedyPipeline in their default configurations, which writes their
    seed tables and, on an index with a text copy, their Bloom bitmaps
    beside the index.  Prints each step's seconds on stderr.  With
    device="cpu" (asked for, not a fallback) no library is built: the
    tables and bitmaps come from the plain versions.  Raises when a file
    it should write is not there afterwards."""
    import random

    from .. import kernels
    from ..engine.config import KaijuConfig
    from ..engine.greedy import GreedyPipeline
    from ..engine.mem import MemPipeline
    from ..io.taxonomy import Taxonomy, parse_nodes_dmp
    from ..ops.device_index import resolve_device
    from ..utils import aot

    dev = resolve_device(device)
    if dev.type == "cuda":
        t0 = time.time()
        runs = kernels.LOADER["nvcc_runs"]
        path = aot.prebuild(ktx_dir, dev)
        if kernels.use_prebuilt(ktx_dir, dev) != path:
            raise RuntimeError(f"{path}: not found under its own key")
        print(f"  kernel libraries: {kernels.LOADER['nvcc_runs'] - runs} "
              f"built by nvcc in {time.time()-t0:.1f}s into {path}",
              file=sys.stderr)
    else:
        print("  device cpu: no kernel library built; the seed tables and "
              "bitmaps come from the plain versions", file=sys.stderr)
    def tables(K):
        return os.path.join(ktx_dir, f"kmer{K}", f"si1_{K}.npy")

    written = [tables(build_kmer(index, ktx_dir, dev))]
    tax = Taxonomy(parse_nodes_dmp(nodes_path))
    rng = random.Random(7)
    reads = [
        (
            f"aot{i}",
            "".join(rng.choice("ACGT") for _ in range(200)),
            None,
        )
        for i in range(batch)
    ]
    for mode, cls, kw in (
        ("mem", MemPipeline, dict(seg=True, use_Evalue=False)),
        ("greedy", GreedyPipeline, {}),
    ):
        t0 = time.time()
        cfg = KaijuConfig(mode=mode, **kw)
        pipe = cls(index, tax, cfg, device=dev, kmer_cache_dir=ktx_dir)
        t1 = time.time()
        pipe.classify_batch(reads)
        print(f"  {mode}: seed tables and bitmap {t1-t0:.1f}s, one batch "
              f"of {batch} reads {time.time()-t1:.1f}s", file=sys.stderr)
        written.append(tables(pipe.seed_K))
        if pipe._bloom is not None:
            _words, m, lb = pipe._bloom
            written.append(os.path.join(ktx_dir, f"bloom_m{m}_lb{lb}.npy"))
    if dev.type == "cuda":
        print("  libraries loaded from the prebuilt directory: " + ", ".join(
            s for s, d in sorted(kernels.ORIGIN.items()) if d == path),
            file=sys.stderr)
    missing = sorted({p for p in written if not os.path.isfile(p)})
    if missing:
        raise OSError(f"--aot could not write {missing}")


if __name__ == "__main__":
    sys.exit(main())
