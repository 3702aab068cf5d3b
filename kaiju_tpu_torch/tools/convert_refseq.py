"""kaiju-tpu-torch-convertRefSeq: taxon-labeled FASTA from RefSeq WP proteins.

Equivalent of the reference kaiju-convertRefSeq (reference:
src/kaiju-convertRefSeq.cpp:24-269): loads prot.accession2taxid.FULL
keeping only WP_ accessions, remaps through merged.dmp, and keeps
records (read from stdin or -i) whose taxon lies under the include list.
"""

from __future__ import annotations

import argparse
import sys

from ..io.taxonomy import parse_merged_dmp, parse_nodes_dmp
from .convert_nr import (
    filter_seq_line,
    keep_under_includes,
    open_maybe_gz,
    read_include_list,
)


def load_acc2taxid_full(path: str, nodes, merged, verbose=False):
    """Two-column accession2taxid.FULL, WP_ only
    (reference: kaiju-convertRefSeq.cpp:137-196; NOTE: the reference
    truncates the accession's last character on the merged.dmp remap
    branch — substr(0, start-1) — which we deliberately reproduce for
    bit-parity with the binary)."""
    acc2taxid: dict[str, int] = {}
    with open_maybe_gz(path) as fh:
        fh.readline()
        for line in fh:
            if len(line) <= 1:
                continue
            tab = line.find("\t")
            if tab < 0:
                print(f"Error parsing line: {line}", file=sys.stderr)
                continue
            if not line.startswith("WP_"):
                continue
            try:
                taxid = int(line[tab + 1 :].split()[0])
            except (ValueError, IndexError):
                continue
            if taxid == 0:
                continue
            if taxid not in nodes:
                if taxid in merged:
                    taxid = merged[taxid]
                    if taxid in nodes:
                        acc2taxid[line[: tab - 1]] = taxid
                continue
            acc2taxid[line[:tab]] = taxid
    return acc2taxid


def convert_refseq(src, out, nodes, acc2taxid, include, add_acc=False,
                   verbose=False):
    first = True
    skip = True
    for line in src:
        line = line.rstrip("\n")
        if not line:
            continue
        if line[0] == ">":
            tax_id = 0
            acc = ""
            skip = True
            end = line.find(" ", 1)
            if end >= 0:
                acc = line[1:end]
                tax_id = acc2taxid.get(acc, 0)
                if tax_id > 0 and keep_under_includes(tax_id, nodes, include):
                    skip = False
                elif tax_id == 0 and verbose:
                    print(f"Accession {acc} was not found", file=sys.stderr)
            if not skip:
                if not first:
                    out.write("\n")
                first = False
                if add_acc:
                    out.write(f">{acc}_{tax_id}\n")
                else:
                    out.write(f">{tax_id}\n")
        else:
            if not skip:
                # concatenated, newline only before the next header
                out.write(filter_seq_line(line))
    out.write("\n")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaiju-tpu-torch-convertRefSeq",
                                 description=__doc__)
    ap.add_argument("-t", dest="nodes", required=True, help="nodes.dmp")
    ap.add_argument("-m", dest="merged", required=True, help="merged.dmp")
    ap.add_argument("-g", dest="acc2taxid", required=True,
                    help="prot.accession2taxid.FULL[.gz]")
    ap.add_argument("-i", dest="input", help="FASTA (default: stdin)")
    ap.add_argument("-o", dest="output", required=True)
    ap.add_argument("-l", dest="list", help="taxon include-list file")
    ap.add_argument("-a", dest="add_acc", action="store_true")
    ap.add_argument("-v", dest="verbose", action="store_true")
    args = ap.parse_args(argv)

    nodes = parse_nodes_dmp(args.nodes)
    merged = parse_merged_dmp(args.merged)
    include = read_include_list(args.list, nodes)
    acc2taxid = load_acc2taxid_full(args.acc2taxid, nodes, merged,
                                    args.verbose)
    src = open(args.input) if args.input else sys.stdin
    with open(args.output, "w") as out:
        convert_refseq(src, out, nodes, acc2taxid, include, args.add_acc,
                       args.verbose)
    if args.input:
        src.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
