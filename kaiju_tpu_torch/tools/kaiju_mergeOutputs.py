"""kaiju-tpu-torch-mergeOutputs: merge two name-aligned classification files
(reference: src/kaiju-mergeOutputs.cpp).  Conflict resolution: '1', '2',
'lca' or 'lowest'; optional score precedence from column 4 (-s)."""

from __future__ import annotations

import argparse
import sys


def _parse(line: str, use_score: bool, path: str, count: int):
    """(classified, name, taxid_str, score_str) per the reference parsing
    (reference: kaiju-mergeOutputs.cpp:110-150)."""
    c = line[0]
    if c not in "CU":
        raise ValueError(
            f"Line {count} in file {path} does not start with C or U."
        )
    t1 = line.find("\t")
    t2 = line.find("\t", t1 + 1)
    if t1 < 0 or t2 < 0:
        raise ValueError(f"Could not parse line {count} in file {path}")
    name = line[t1 + 1 : t2]
    score = "0"
    if use_score and c == "C":
        t3 = line.find("\t", t2 + 1)
        if t3 < 0:
            raise ValueError(
                f"No score column (4th col) found in line {count} in file {path}"
            )
        taxid = line[t2 + 1 : t3]
        j = t3 + 1
        while j < len(line) and (line[j].isdigit() or line[j] == "."):
            j += 1
        score = line[t3 + 1 : j]
    else:
        j = t2 + 1
        while j < len(line) and line[j].isdigit():
            j += 1
        taxid = line[t2 + 1 : j]
    return c, name, taxid, score


def _calc_lca(nodes: dict[int, int], id1: str, id2: str) -> str:
    """(reference: kaiju-mergeOutputs.cpp:355-400): note the climb starts
    from node2's PARENT."""
    try:
        n1, n2 = int(id1), int(id2)
    except ValueError:
        print("Warning: Bad number in taxon id", file=sys.stderr)
        return "0"
    if n1 not in nodes and n2 not in nodes:
        return "0"
    if n1 not in nodes:
        return str(n2)
    if n2 not in nodes:
        return str(n1)
    lineage1 = {n1}
    node = n1
    while node in nodes and node != nodes[node]:
        lineage1.add(nodes[node])
        node = nodes[node]
    lca = n2
    while True:
        lca = nodes[lca]
        if lca in lineage1 or lca == nodes[lca]:
            break
    return str(lca)


def _is_ancestor(nodes, id1: str, id2: str) -> bool:
    try:
        n1, n2 = int(id1), int(id2)
    except ValueError:
        return False
    if n1 not in nodes or n2 not in nodes:
        return False
    if n1 == n2:
        return True
    while n2 in nodes and n2 != nodes[n2]:
        n2 = nodes[n2]
        if n2 == n1:
            return True
    return False


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaiju-tpu-torch-mergeOutputs",
                                 description=__doc__)
    ap.add_argument("-i", dest="input1", required=True)
    ap.add_argument("-j", dest="input2", required=True)
    ap.add_argument("-o", dest="output")
    ap.add_argument("-c", dest="conflict", default="1",
                    choices=["1", "2", "lca", "lowest"])
    ap.add_argument("-s", dest="use_score", action="store_true")
    ap.add_argument("-t", dest="nodes", default="")
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("-d", dest="debug", action="store_true")
    args = ap.parse_args(argv)
    if args.conflict in ("lca", "lowest") and not args.nodes:
        print("Error: conflict mode lca/lowest requires -t nodes.dmp", file=sys.stderr)
        return 1

    nodes = {}
    if args.nodes:
        from ..io.taxonomy import parse_nodes_dmp

        nodes = parse_nodes_dmp(args.nodes)

    out = open(args.output, "w") if args.output else sys.stdout
    stats = dict(count=0, c1=0, c2=0, c12=0, c3=0, c1n2=0, c2n1=0)
    with open(args.input1) as f1, open(args.input2) as f2:
        for line1 in f1:
            line1 = line1.rstrip("\n")
            stats["count"] += 1
            count = stats["count"]
            line2 = f2.readline()
            if not line2:
                print(
                    f"Error: File {args.input1} has more lines then file "
                    f"{args.input2}",
                    file=sys.stderr,
                )
                break
            line2 = line2.rstrip("\n")
            c1, name1, id1, s1 = _parse(line1, args.use_score, args.input1, count)
            c2, name2, id2, s2 = _parse(line2, args.use_score, args.input2, count)
            if name1 != name2:
                print(
                    "Error: Read names are not identical between the two "
                    f"input files on line {count}",
                    file=sys.stderr,
                )
                break
            if c1 == "C" and c2 == "C":
                score_out = s1
                if args.use_score:
                    d1, d2 = float(s1), float(s2)
                if id1 == id2:
                    lca = id1
                    if args.use_score:
                        score_out = s2 if d2 > d1 else s1
                elif not args.use_score or d1 == d2:
                    if args.conflict == "1":
                        lca = id1
                    elif args.conflict == "2":
                        lca = id2
                    elif args.conflict == "lowest":
                        if _is_ancestor(nodes, id1, id2):
                            lca = id2
                        elif _is_ancestor(nodes, id2, id1):
                            lca = id1
                        else:
                            lca = _calc_lca(nodes, id1, id2)
                        if lca == "0":
                            lca = id1
                    else:
                        lca = _calc_lca(nodes, id1, id2)
                        if lca == "0":
                            lca = id1
                else:
                    if d1 > d2:
                        lca, score_out = id1, s1
                    else:
                        lca, score_out = id2, s2
                stats["c1"] += 1
                stats["c2"] += 1
                stats["c12"] += 1
                stats["c3"] += 1
                out.write(
                    f"C\t{name1}\t{lca}"
                    + (f"\t{score_out}\n" if args.use_score else "\n")
                )
            elif c1 == "C":
                stats["c1"] += 1
                stats["c1n2"] += 1
                stats["c3"] += 1
                out.write(
                    f"C\t{name1}\t{id1}" + (f"\t{s1}\n" if args.use_score else "\n")
                )
            elif c2 == "C":
                stats["c2"] += 1
                stats["c2n1"] += 1
                stats["c3"] += 1
                out.write(
                    f"C\t{name1}\t{id2}" + (f"\t{s2}\n" if args.use_score else "\n")
                )
            else:
                out.write(f"U\t{name1}\t0\n")
        else:
            extra = f2.readline()
            if extra and extra.rstrip("\n"):
                print(
                    f"Warning: File {args.input2} has more lines then file "
                    f"{args.input1}",
                    file=sys.stderr,
                )
    if args.output:
        out.close()
    if args.verbose:
        c = max(stats["count"], 1)
        print(f"Number of all reads in input:\t{stats['count']:10d}", file=sys.stderr)
        for label, key in [
            ("         classified in file1:", "c1"),
            ("            but not in file2:", "c1n2"),
            ("         classified in file2:", "c2"),
            ("            but not in file1:", "c2n1"),
            ("          classified in both:", "c12"),
            ("         combined classified:", "c3"),
        ]:
            print(
                f"{label}\t{stats[key]:10d}  {stats[key] / c * 100.0:6.2f}%",
                file=sys.stderr,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
