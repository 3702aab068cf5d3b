"""kaiju-tpu-torch-addTaxonNames: append taxon name (or lineage path) columns
(reference: src/kaiju-addTaxonNames.cpp)."""

from __future__ import annotations

import argparse
import sys

from ..io.taxonomy import parse_names_dmp, parse_nodes_dmp_with_rank
from .kaiju2table import _taxid_from_line


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaiju-tpu-torch-addTaxonNames",
                                 description=__doc__)
    ap.add_argument("-t", dest="nodes", required=True)
    ap.add_argument("-n", dest="names", required=True)
    ap.add_argument("-i", dest="input", required=True)
    ap.add_argument("-o", dest="output")
    ap.add_argument("-u", dest="filter_unclassified", action="store_true")
    ap.add_argument("-p", dest="full_path", action="store_true")
    ap.add_argument("-r", dest="ranks", default="",
                    help="comma-separated ranks to print")
    ap.add_argument("-v", dest="verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.full_path and args.ranks:
        print("Use either -p or -r, not both.", file=sys.stderr)
        return 1

    nodes, node2rank = parse_nodes_dmp_with_rank(args.nodes)
    node2name = parse_names_dmp(args.names)
    ranks_list = [r for r in args.ranks.split(",") if r]
    ranks_set = set(ranks_list)

    def name_of(taxid):
        if taxid not in node2name:
            print(
                f"Warning: Taxon ID {taxid} is not found in file {args.names}.",
                file=sys.stderr,
            )
            return f"taxonid:{taxid}"
        return node2name[taxid]

    out = open(args.output, "w") if args.output else sys.stdout
    path_cache: dict[int, str] = {}
    with open(args.input) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line[0] != "C":
                if not args.filter_unclassified:
                    out.write(line + "\n")
                continue
            taxid = _taxid_from_line(line)
            if taxid is None or taxid not in nodes or taxid not in node2name:
                if taxid is not None and taxid not in nodes:
                    print(
                        f"Warning: Taxon ID {taxid} in output file is not "
                        f"contained in taxonomic tree file {args.nodes}.",
                        file=sys.stderr,
                    )
                elif taxid is not None:
                    print(
                        f"Warning: Taxon ID {taxid} in output file is not "
                        f"found in file {args.names}.",
                        file=sys.stderr,
                    )
                out.write(line + "\n")
                continue
            if args.full_path or ranks_list:
                if taxid in path_cache:
                    out.write(line + "\t" + path_cache[taxid] + "\n")
                    continue
                vals = {r: "NA" for r in ranks_list}
                lineage = []
                node = taxid
                while node in nodes and node != nodes[node]:
                    if ranks_list:
                        rk = node2rank.get(node)
                        if rk and rk != "no rank" and rk in ranks_set:
                            vals[rk] = name_of(node)
                    else:
                        lineage.insert(0, name_of(node))
                    node = nodes[node]
                if ranks_list:
                    text = "".join(f"{vals[r]}; " for r in ranks_list)
                else:
                    text = "".join(f"{x}; " for x in lineage)
                path_cache[taxid] = text
                out.write(line + "\t" + text + "\n")
            else:
                out.write(line + "\t" + name_of(taxid) + "\n")
    if args.output:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
