"""kaiju-tpu-torch-convertNR: build a taxon-labeled protein FASTA from NCBI nr.

Equivalent of the reference kaiju-convertNR (reference:
src/kaiju-convertNR.cpp:24-313): loads prot.accession2taxid (optionally
gzipped) with merged.dmp remapping, drops records containing excluded
accessions, computes the LCA of all \\x01-separated header accessions,
keeps records whose LCA lies under the include list (default Bacteria=2,
Archaea=2157, Viruses=10239), and emits headers ">"[firstAcc_]taxid with
sequences restricted to the 20-letter amino-acid alphabet.
"""

from __future__ import annotations

import argparse
import gzip
import sys

from ..io.taxonomy import Taxonomy, parse_merged_dmp, parse_nodes_dmp

AA20 = set("ARNDCQEGHILKMFPSTWYV")


def open_maybe_gz(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    # gzip sniff: the NCBI files are sometimes gzipped without suffix
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


def read_include_list(path: str | None, nodes) -> set[int]:
    """Taxon include list (reference: kaiju-convertNR.cpp:103-144)."""
    if not path:
        print(
            "No taxa list specified, using Archaea, Bacteria, and Viruses.",
            file=sys.stderr,
        )
        return {2, 2157, 10239}
    include: set[int] = set()
    with open(path) as fh:
        for line in fh:
            digits = ""
            started = False
            for ch in line:
                if ch.isdigit():
                    digits += ch
                    started = True
                elif started:
                    break
            if not digits:
                continue
            taxid = int(digits)
            if taxid in nodes:
                include.add(taxid)
            else:
                print(
                    f"Warning: Taxon ID {taxid} was not found in taxonomic "
                    "tree. Skipping.",
                    file=sys.stderr,
                )
    return include


def load_acc2taxid(path: str, nodes, merged, verbose=False) -> dict[str, int]:
    """(reference: kaiju-convertNR.cpp:146-194)."""
    acc2taxid: dict[str, int] = {}
    with open_maybe_gz(path) as fh:
        fh.readline()  # header
        for line in fh:
            if len(line) <= 1:
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            acc = parts[1]
            try:
                taxid = int(parts[2])
            except ValueError:
                continue
            if taxid not in nodes:
                if taxid in merged:
                    taxid = merged[taxid]
                    if taxid in nodes:
                        acc2taxid[acc] = taxid
                continue
            acc2taxid[acc] = taxid
    return acc2taxid


def keep_under_includes(lca: int, nodes, include: set[int]) -> bool:
    """Climb from lca toward the root, stopping before the root itself
    (reference: kaiju-convertNR.cpp:272-280)."""
    tid = lca
    while tid in nodes and tid != 1:
        if tid in include:
            return True
        tid = nodes[tid]
    return False


def filter_seq_line(line: str) -> str:
    return "".join(c for c in line if c in AA20)


def convert_nr(
    nr_in, out, nodes, merged, acc2taxid, include, excluded,
    add_acc=False, verbose=False,
):
    tax = Taxonomy(nodes)
    first = True
    skip = True
    for line in nr_in:
        line = line.rstrip("\n")
        if not line:
            continue
        if line[0] == ">":
            ids = set()
            first_acc = ""
            skip = False
            start = 1
            # accessions are separated from descriptions by ' ' and from
            # each other by \x01 (reference: kaiju-convertNR.cpp:231-258)
            while True:
                end = line.find(" ", start)
                if end < 0:
                    break
                acc = line[start:end]
                if acc in excluded:
                    skip = True
                    break
                taxid = acc2taxid.get(acc, 0)
                if taxid > 0:
                    if add_acc and not first_acc:
                        first_acc = acc
                    ids.add(taxid)
                elif verbose:
                    print(f"Accession {acc} has no taxon id", file=sys.stderr)
                nxt = line.find("\x01", end + 1)
                if nxt < 0:
                    break
                start = nxt + 1
            if skip:
                continue
            skip = True
            if ids:
                lca = next(iter(ids)) if len(ids) == 1 else tax.lca(sorted(ids))
                if lca not in nodes:
                    continue
                if keep_under_includes(lca, nodes, include):
                    if not first:
                        out.write("\n")
                    first = False
                    if add_acc:
                        out.write(f">{first_acc}_{lca}\n")
                    else:
                        out.write(f">{lca}\n")
                    skip = False
        else:
            if not skip:
                # sequence lines concatenate with NO newline; records are
                # separated by the "\n" written before the next header
                # (reference: kaiju-convertNR.cpp:296-305)
                out.write(filter_seq_line(line))
    out.write("\n")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaiju-tpu-torch-convertNR", description=__doc__)
    ap.add_argument("-t", dest="nodes", required=True, help="nodes.dmp")
    ap.add_argument("-m", dest="merged", required=True, help="merged.dmp")
    ap.add_argument("-g", dest="acc2taxid", required=True,
                    help="prot.accession2taxid[.gz]")
    ap.add_argument("-i", dest="input", help="nr FASTA (default: stdin)")
    ap.add_argument("-o", dest="output", required=True)
    ap.add_argument("-e", dest="excluded", help="excluded accession list")
    ap.add_argument("-l", dest="list", help="taxon include-list file")
    ap.add_argument("-a", dest="add_acc", action="store_true",
                    help="prefix DB names with the first accession")
    ap.add_argument("-v", dest="verbose", action="store_true")
    args = ap.parse_args(argv)

    nodes = parse_nodes_dmp(args.nodes)
    merged = parse_merged_dmp(args.merged)
    include = read_include_list(args.list, nodes)
    acc2taxid = load_acc2taxid(args.acc2taxid, nodes, merged, args.verbose)
    excluded = set()
    if args.excluded:
        with open(args.excluded) as fh:
            excluded = {ln.rstrip("\n") for ln in fh if ln.rstrip("\n")}
    src = open(args.input) if args.input else sys.stdin
    with open(args.output, "w") as out:
        convert_nr(src, out, nodes, merged, acc2taxid, include, excluded,
                   args.add_acc, args.verbose)
    if args.input:
        src.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
