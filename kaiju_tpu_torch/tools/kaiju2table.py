"""kaiju-tpu-torch-kaiju2table: summary table per taxonomic rank
(reference: src/kaiju2table.cpp).

Counts classified reads per taxon from column 3 of kaiju output, sums
counts up the tree (viruses stay at their own node), filters by -m percent
or -c count, and prints `file percent reads taxon_id taxon_name` rows plus
the summary rows.  Percent arithmetic replicates the reference's
float/double mixing exactly.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.taxonomy import (
    Taxonomy,
    parse_names_dmp,
    parse_nodes_dmp_with_rank,
)

VIRUSES = 10239  # (reference: kaiju2table.cpp:36)
VALID_RANKS = ("phylum", "class", "order", "family", "genus", "species")


def _f32(x):
    return np.float32(x)


def _taxid_from_line(line: str):
    """Taxon id = digits after the 2nd tab (reference: kaiju2table.cpp:196-200)."""
    t1 = line.find("\t")
    t2 = line.find("\t", t1 + 1)
    if t2 < 0:
        return None
    j = t2 + 1
    n = len(line)
    while j < n and line[j].isdigit():
        j += 1
    if j == t2 + 1:
        return None
    return int(line[t2 + 1 : j])


def summarize_file(path, nodes, tax, ranks):
    counts: dict[int, int] = {}
    unclassified = 0
    totalreads = 0
    total_virus_reads = 0
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            totalreads += 1
            if line[0] != "C":
                unclassified += 1
                continue
            taxid = _taxid_from_line(line)
            if taxid is None:
                print(f"Error: Found bad taxon id in line: {line}", file=sys.stderr)
                continue
            if taxid not in nodes:
                print(
                    f"Warning: Taxon ID {taxid} is not contained in nodes file.",
                    file=sys.stderr,
                )
                continue
            if tax.is_ancestor(VIRUSES, taxid):
                total_virus_reads += 1
            counts[taxid] = counts.get(taxid, 0) + 1

    summarized: dict[int, int] = {}
    for taxid in sorted(counts):
        reads = counts[taxid]
        if tax.is_ancestor(VIRUSES, taxid):
            summarized[taxid] = summarized.get(taxid, 0) + reads if taxid in summarized else reads
            continue
        node = taxid
        while node in nodes and node != nodes[node]:
            summarized[node] = summarized.get(node, 0) + reads
            node = nodes[node]
    return counts, summarized, unclassified, totalreads, total_virus_reads


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaiju-tpu-torch-kaiju2table",
                                 description=__doc__)
    ap.add_argument("-t", dest="nodes", required=True)
    ap.add_argument("-n", dest="names", required=True)
    ap.add_argument("-r", dest="rank", required=True, choices=VALID_RANKS)
    ap.add_argument("-o", dest="output", required=True)
    ap.add_argument("-m", dest="min_percent", type=float, default=0.0)
    ap.add_argument("-c", dest="min_count", type=int, default=0)
    ap.add_argument("-e", dest="expand_viruses", action="store_true")
    ap.add_argument("-u", dest="filter_unclassified", action="store_true")
    ap.add_argument("-p", dest="full_path", action="store_true")
    ap.add_argument("-l", dest="ranks_list", default="")
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("inputs", nargs="+")
    args = ap.parse_args(argv)
    if args.min_percent > 0 and args.min_count > 0:
        print("Either specify -m or -c, not both.", file=sys.stderr)
        return 1
    if args.ranks_list and args.full_path:
        print("Please use either option -p or -l, but not both.", file=sys.stderr)
        return 1

    ranks_list = [r for r in args.ranks_list.split(",") if r] if args.ranks_list else []
    ranks_set = set(ranks_list)
    if ranks_list and args.rank not in ranks_set:
        print(f"Specified rank {args.rank} is not in -l list", file=sys.stderr)
        return 1

    nodes, node2rank = parse_nodes_dmp_with_rank(args.nodes)
    node2name = parse_names_dmp(args.names)
    tax = Taxonomy(nodes)

    def name_of(taxid):
        if taxid not in node2name:
            print(
                f"Warning: Taxon ID {taxid} is not found in file {args.names}.",
                file=sys.stderr,
            )
            return f"taxonid:{taxid}"
        return node2name[taxid]

    out = open(args.output, "w")
    out.write("file\tpercent\treads\ttaxon_id\ttaxon_name\n")
    for path in args.inputs:
        counts, summarized, unclassified, totalreads, total_virus = summarize_file(
            path, nodes, tax, node2rank
        )
        if args.filter_unclassified:
            totalreads -= unclassified

        at_rank_sum = 0
        below_percent = 0
        below_count = 0
        rows = []  # (count, taxid) sorted desc by count, FIFO ties
        for taxid in sorted(summarized):
            count = summarized[taxid]
            if tax.is_ancestor(VIRUSES, taxid):
                rows.append((count, taxid))
                continue
            if taxid not in node2rank:
                print(f"Error: No rank specified for taxonid {taxid}", file=sys.stderr)
                continue
            if node2rank[taxid] == args.rank:
                if count >= args.min_count:
                    percent = float(_f32(_f32(count) / _f32(totalreads) * _f32(100)))
                    if percent >= args.min_percent:
                        rows.append((count, taxid))
                    else:
                        below_percent += count
                else:
                    below_count += count
                at_rank_sum += count
        rows.sort(key=lambda x: -x[0])  # stable: FIFO on ties

        above = totalreads - at_rank_sum
        if not args.filter_unclassified:
            above -= unclassified
        above -= total_virus

        for count, taxid in rows:
            if not args.expand_viruses and tax.is_ancestor(VIRUSES, taxid):
                continue
            percent = float(_f32(_f32(count) / _f32(totalreads)) * _f32(100.0))
            out.write(f"{path}\t{percent:.6f}\t{count}\t{taxid}")
            if args.full_path or ranks_list:
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
                    out.write("\t" + "".join(f"{vals[r]};" for r in ranks_list))
                else:
                    out.write("\t" + "".join(f"{x};" for x in lineage))
            else:
                out.write(f"\t{name_of(taxid)}")
            out.write("\n")

        def _dbl_pct(x, t):
            # (float)x/(float)t * 100.0 -> float division, double multiply,
            # passed straight to fprintf (reference: kaiju2table.cpp:350-359)
            return float(np.float64(_f32(x) / _f32(t)) * 100.0)

        def _f32_pct(x, t):
            # same but assigned to a float variable before printing
            # (reference: kaiju2table.cpp:342, 346)
            return float(_f32(np.float64(_f32(x) / _f32(t)) * 100.0))

        if not args.expand_viruses:
            pv = _f32_pct(total_virus, totalreads) if total_virus > 0 else 0.0
            out.write(f"{path}\t{pv:.6f}\t{total_virus}\t{VIRUSES}\tViruses\n")
        pa = _f32_pct(above, totalreads) if above > 0 else 0.0
        out.write(
            f"{path}\t{pa:.6f}\t{above}\tNA\t"
            f"cannot be assigned to a (non-viral) {args.rank}\n"
        )
        if args.min_count > 0:
            p = _dbl_pct(below_count, totalreads)
            out.write(
                f"{path}\t{p:.6f}\t{below_count}\tNA\tbelong to a (non-viral) "
                f"{args.rank} having less than {args.min_count} reads\n"
            )
        if args.min_percent > 0:
            p = _dbl_pct(below_percent, totalreads)
            out.write(
                f"{path}\t{p:.6f}\t{below_percent}\tNA\tbelong to a (non-viral) "
                f"{args.rank} with less than {args.min_percent:g}% of all reads\n"
            )
        denom = totalreads + unclassified if args.filter_unclassified else totalreads
        p = _dbl_pct(unclassified, denom)
        out.write(f"{path}\t{p:.6f}\t{unclassified}\tNA\tunclassified\n")
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
