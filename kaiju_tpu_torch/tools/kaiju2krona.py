"""kaiju-tpu-torch-kaiju2krona: convert kaiju TSV output to Krona text
(reference: src/kaiju2krona.cpp): per-taxon read counts followed by the
root-to-leaf name lineage.  Output rows are sorted by taxon id (the
reference iterates a hash map, so its row order is unspecified)."""

from __future__ import annotations

import argparse
import sys

from ..io.taxonomy import parse_names_dmp, parse_nodes_dmp_with_rank
from .kaiju2table import _taxid_from_line


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaiju-tpu-torch-kaiju2krona",
                                 description=__doc__)
    ap.add_argument("-t", dest="nodes", required=True)
    ap.add_argument("-n", dest="names", required=True)
    ap.add_argument("-i", dest="input", required=True)
    ap.add_argument("-o", dest="output", required=True)
    ap.add_argument("-u", dest="count_unclassified", action="store_true")
    ap.add_argument("-l", dest="ranks_list", default="")
    ap.add_argument("-v", dest="verbose", action="store_true")
    args = ap.parse_args(argv)

    nodes, node2rank = parse_nodes_dmp_with_rank(args.nodes)
    node2name = parse_names_dmp(args.names)
    ranks_set = set(r for r in args.ranks_list.split(",") if r)

    counts: dict[int, int] = {}
    unclassified = 0
    with open(args.input) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line[0] != "C":
                unclassified += 1
                continue
            taxid = _taxid_from_line(line)
            if taxid is None:
                print(f"Found bad taxon id in line: {line}", file=sys.stderr)
                continue
            counts[taxid] = counts.get(taxid, 0) + 1

    with open(args.output, "w") as out:
        for taxid in sorted(counts):
            if taxid not in nodes:
                print(
                    f"Warning: Taxon ID {taxid} found in input file is not "
                    f"contained in taxonomic tree file {args.nodes}.",
                    file=sys.stderr,
                )
                continue
            if taxid not in node2name:
                print(
                    f"Warning: Taxon ID {taxid} found in input file is not "
                    f"contained in names.dmp file {args.names}.",
                    file=sys.stderr,
                )
                continue
            lineage = []
            node = taxid
            if not ranks_set or node2rank.get(node) in ranks_set:
                lineage.append(node2name[node])
            while node in nodes and node != nodes[node]:
                parent = nodes[node]
                if parent in node2name and (
                    not ranks_set or node2rank.get(parent) in ranks_set
                ):
                    lineage.insert(0, node2name[parent])
                node = parent
            out.write(str(counts[taxid]))
            for nm in lineage:
                out.write("\t" + nm)
            out.write("\n")
        if args.count_unclassified and unclassified > 0:
            out.write(f"{unclassified}\tUnclassified\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
