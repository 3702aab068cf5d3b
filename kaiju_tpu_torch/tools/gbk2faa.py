"""kaiju-tpu-torch-gbk2faa: GenBank flatfile -> taxon-labeled protein FASTA.

Equivalent of the reference kaiju-gbk2faa.pl (reference:
util/kaiju-gbk2faa.pl:26-66): extracts /translation fields, headers are
">protein-id_taxid" with the taxid from /db_xref="taxon:<ID>"; B->D and
Z->E substitutions (the higher-scoring disambiguation) and only the
20-letter alphabet retained (case-insensitively, as in the perl regex).
"""

from __future__ import annotations

import argparse
import gzip
import re
import sys

_TAXON = re.compile(r'/db_xref="taxon:(\d+)"')
_PROT = re.compile(r'/protein_id="([^"]+)"')
_TRANS_ONE = re.compile(r'\s+/translation="([^"]+)"')
_TRANS_OPEN = re.compile(r'\s+/translation="([^"]+)$')
_BZ = str.maketrans("BZ", "DE")
_NON_AA = re.compile(r"[^ARNDCQEGHILKMFPSTWYV]", re.IGNORECASE)


def _clean(seq: str) -> str:
    return _NON_AA.sub("", seq.translate(_BZ))


def gbk2faa(src, out) -> None:
    taxid = None
    protein_id = None
    in_translation = False
    for line in src:
        line = line.rstrip("\n")
        m = _TAXON.search(line)
        if m:
            taxid = m.group(1)
            continue
        m = _PROT.search(line)
        if m:
            protein_id = m.group(1)
            continue
        m = _TRANS_ONE.search(line)
        if m:
            if taxid is None:
                raise SystemExit("No taxon id found in gbk file")
            out.write(f">{protein_id}_{taxid}\n{_clean(m.group(1))}\n")
            continue
        m = _TRANS_OPEN.search(line)
        if m:
            if taxid is None:
                raise SystemExit("No taxon id found in gbk file")
            out.write(f">{protein_id}_{taxid}\n{_clean(m.group(1))}\n")
            in_translation = True
            continue
        if in_translation:
            if '"' in line:
                in_translation = False
            out.write(_clean(line) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaiju-tpu-torch-gbk2faa", description=__doc__)
    ap.add_argument("input", help="GenBank flatfile (.gbk / .gbff[.gz])")
    ap.add_argument("output", help="output FASTA")
    args = ap.parse_args(argv)
    opener = gzip.open if args.input.endswith(".gz") else open
    with opener(args.input, "rt") as src, open(args.output, "w") as out:
        gbk2faa(src, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
