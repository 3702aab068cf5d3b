"""kaiju-tpu-torch-makedb: download + convert + index a reference database.

Equivalent of the reference kaiju-makedb shell pipeline (reference:
util/kaiju-makedb:23-433): one command per source database that downloads
the NCBI/proGenomes/RVDB data, converts it to a taxon-labeled protein
FASTA (via the convertNR/convertRefSeq/gbk2faa equivalents in this
package) and builds the index with this package's ``tools.mkdb`` (the
ktx format, byte-identical to ``kaiju_tpu.tools.mkdb``'s).  ``--aot``
passes ``--aot -t nodes.dmp`` on to ``tools.mkdb``: the kernel libraries
are prebuilt beside the index and the seed tables and Bloom bitmaps
written there (``utils/aot.py``).

Databases: refseq, refseq_nr, refseq_ref, progenomes, viruses, plasmids,
fungi, nr, nr_euk, rvdb — the same set and data sources as the reference
(util/kaiju-makedb:133).

The eukaryote include-list (-s nr_euk / refseq_nr) and the excluded-
accession list default to the curated files shipped in
kaiju_tpu_torch/data/ (data parity with reference
util/kaiju-taxonlistEuk.tsv and util/kaiju-excluded-accessions.txt;
override with --taxon-list / --excluded).

The download modes (``urllib.request``) are copied unchanged and have not
been run by any test: the tests run without network, so they drive this
tool only through ``--no-download`` and ``--index-only``.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import gzip
import os
import re
import subprocess
import sys
import tarfile
import urllib.request

TAXDUMP = "https://ftp.ncbi.nlm.nih.gov/pub/taxonomy/taxdump.tar.gz"
NR = "https://ftp.ncbi.nih.gov/blast/db/FASTA/nr.gz"
PROT_A2T = "https://ftp.ncbi.nlm.nih.gov/pub/taxonomy/accession2taxid/prot.accession2taxid.gz"
PROT_A2T_FULL = "https://ftp.ncbi.nlm.nih.gov/pub/taxonomy/accession2taxid/prot.accession2taxid.FULL.gz"
REFSEQ_RELEASE = "https://ftp.ncbi.nlm.nih.gov/refseq/release"
ASSEMBLY = "https://ftp.ncbi.nlm.nih.gov/genomes/refseq/{group}/assembly_summary.txt"
PROGENOMES = "https://progenomes.embl.de/data/repGenomes/progenomes3.proteins.representatives.fasta.bz2"
RVDB = "https://rvdb-prot.pasteur.fr/files/U-RVDBv29.0-prot.fasta.xz"

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
DEFAULT_EXCLUDED = os.path.join(DATA_DIR, "excluded-accessions.txt")
DEFAULT_TAXONLIST = os.path.join(DATA_DIR, "taxonlistEuk.tsv")

# fallback include list if the data file is absent (reference:
# kaiju-convertNR.cpp:103-108 and util/kaiju-taxonlistEuk.tsv's scope:
# fungi + microbial eukaryotes)
EUK_TAXA = [
    4751,    # Fungi
    554915,  # Amoebozoa
    302456,  # Bigyra
    33630,   # Alveolata
    33682,   # Euglenozoa
    543769,  # Rhizaria
    5719,    # Parabasalia
    5738,    # Diplomonadida
    66288,   # Oxymonadida
    193075,  # Retortamonadidae
    2611341, # Metamonada
    207245,  # Fornicata
    136087,  # Malawimonadidae
    339960,  # Apusomonadidae
    2611352, # Discoba
    2608240, # Ancyromonadida
    2489521, # CRuMs
    42452,   # Breviatea
    2686027, # Provora
    2683617, # Hemimastigophora
    38254,   # Glaucocystophyceae
    3027,    # Cryptophyceae
    2830,    # Haptophyta
    33090,   # Viridiplantae (green algae scope)
    2763,    # Rhodophyta
]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def fetch(url: str, dest_dir: str, clobber: bool = False) -> str:
    os.makedirs(dest_dir, exist_ok=True)
    out = os.path.join(dest_dir, url.rsplit("/", 1)[1])
    if os.path.exists(out) and not clobber:
        return out
    log(f"downloading {url}")
    tmp = out + ".part"
    urllib.request.urlretrieve(url, tmp)
    os.replace(tmp, out)
    return out


def fetch_many(urls, dest_dir, jobs=5):
    with cf.ThreadPoolExecutor(max_workers=jobs) as ex:
        return list(ex.map(lambda u: fetch(u, dest_dir), urls))


def fetch_taxdump(workdir: str, download: bool) -> None:
    if download:
        tgz = fetch(TAXDUMP, workdir)
        with tarfile.open(tgz) as tf:
            for member in ("nodes.dmp", "names.dmp", "merged.dmp"):
                tf.extract(member, workdir)
    for f in ("nodes.dmp", "merged.dmp"):
        if not os.path.exists(os.path.join(workdir, f)):
            raise SystemExit(f"missing {f} (run without --no-download)")


def assembly_urls(summary_paths, status=None, category=None):
    """Filter assembly_summary.txt like the reference awk pipelines
    (reference: util/kaiju-makedb:214,241,272)."""
    urls = []
    for path in summary_paths:
        with open(path) as fh:
            for line in fh:
                if line.startswith("#"):
                    continue
                f = line.rstrip("\n").split("\t")
                if len(f) < 20 or f[10] != "latest":
                    continue
                if not f[19].startswith("https:"):
                    continue
                if status and f[11] != status:
                    continue
                if category and f[4] not in category:
                    continue
                base = f[19].rsplit("/", 1)[1]
                urls.append(f"{f[19]}/{base}_genomic.gbff.gz")
    return urls


def refseq_release_urls(group: str, maxn: int = 99):
    return [
        f"{REFSEQ_RELEASE}/{group}/{group}.{i}.genomic.gbff.gz"
        for i in range(1, maxn + 1)
    ]


def fetch_release(group: str, dest: str, jobs: int):
    """Numbered release files: stop at the first missing index."""
    got = []
    i = 1
    while True:
        url = f"{REFSEQ_RELEASE}/{group}/{group}.{i}.genomic.gbff.gz"
        try:
            got.append(fetch(url, dest))
        except Exception:
            break
        i += 1
    return got


def gbk_to_faa_all(source_dir: str, jobs: int):
    from .gbk2faa import main as gbk_main

    files = [
        os.path.join(source_dir, f)
        for f in sorted(os.listdir(source_dir))
        if f.endswith(".gbff.gz")
    ]

    def conv(path):
        out = path + ".faa"
        if not os.path.exists(out):
            gbk_main([path, out])
        return out

    with cf.ThreadPoolExecutor(max_workers=jobs) as ex:
        return list(ex.map(conv, files))


_HDR_TAXID = re.compile(r"^(>.+)_(\d+)$")


def merge_faa(faa_paths, merged_dmp: str, out_path: str):
    """Concatenate FASTAs, rewriting taxon ids through merged.dmp
    (reference: util/kaiju-makedb:222 inline perl)."""
    from ..io.taxonomy import parse_merged_dmp

    merged = parse_merged_dmp(merged_dmp)
    with open(out_path, "w") as out:
        for path in faa_paths:
            with open(path) as fh:
                for line in fh:
                    line = line.rstrip("\n")
                    m = _HDR_TAXID.match(line)
                    if m:
                        tid = int(m.group(2))
                        out.write(f"{m.group(1)}_{merged.get(tid, tid)}\n")
                    else:
                        out.write(line + "\n")


def build_index(faa: str, prefix: str, sa_exp: int, nodes_dmp=None,
                aot=False, device=None):
    from .mkdb import main as mkdb_main

    log(f"building ktx index from {faa}")
    cargs = ["-o", prefix + ".ktx", "-e", str(sa_exp)]
    if aot and nodes_dmp:
        # prebuild the kernel libraries, seed tables and bitmaps beside
        # the index, so that no classify process pays them (mkdb --aot)
        cargs += ["--aot", "-t", nodes_dmp]
    rc = mkdb_main(cargs + [faa], device=device)
    if rc:
        raise SystemExit("index build failed")


def write_taxon_list(workdir: str) -> str:
    if os.path.exists(DEFAULT_TAXONLIST):
        return DEFAULT_TAXONLIST
    path = os.path.join(workdir, "taxonlist-euk.tsv")
    with open(path, "w") as fh:
        fh.write("2\n2157\n10239\n")
        for t in EUK_TAXA:
            fh.write(f"{t}\n")
    return path


def main(argv=None, device=None):
    """Run the CLI; device: where --aot prebuilds (None for the GPU, "cpu"
    for the plain versions), handed to tools.mkdb."""
    ap = argparse.ArgumentParser(prog="kaiju-tpu-torch-makedb",
                                 description=__doc__)
    ap.add_argument("-s", dest="db", required=True,
                    choices=["refseq", "refseq_nr", "refseq_ref",
                             "progenomes", "viruses", "plasmids", "fungi",
                             "nr", "nr_euk", "rvdb"])
    ap.add_argument("-t", dest="threads", type=int, default=5)
    ap.add_argument("--no-download", dest="download", action="store_false")
    ap.add_argument("--index-only", action="store_true")
    ap.add_argument("--aot", action="store_true",
                    help="prebuild the kernel libraries, seed tables and "
                         "bitmaps after the index build (see "
                         "kaiju-tpu-torch-mkdb --aot)")
    ap.add_argument("--taxon-list",
                    help="taxon include-list file (default: shipped "
                    "data/taxonlistEuk.tsv)")
    ap.add_argument("--excluded",
                    help="excluded-accession list file (default: shipped "
                    "data/excluded-accessions.txt)")
    ap.add_argument("-w", dest="workdir", default=".",
                    help="working directory")
    args = ap.parse_args(argv)

    db = args.db
    w = args.workdir
    dbdir = os.path.join(w, db)
    src = os.path.join(dbdir, "source")
    faa = os.path.join(dbdir, f"kaiju_db_{db}.faa")
    merged_dmp = os.path.join(w, "merged.dmp")
    nodes_dmp = os.path.join(w, "nodes.dmp")
    sa_exp = 5 if db in ("nr", "nr_euk", "refseq_nr", "refseq_ref") else 3
    download = args.download and not args.index_only

    fetch_taxdump(w, download)

    if not args.index_only:
        if db in ("nr", "nr_euk"):
            if download:
                fetch(NR, dbdir)
                fetch(PROT_A2T, dbdir)
            from .convert_nr import main as conv

            cargs = ["-m", merged_dmp, "-t", nodes_dmp,
                     "-g", os.path.join(dbdir, "prot.accession2taxid.gz"),
                     "-a", "-o", faa,
                     "-i", os.path.join(dbdir, "nr.gz")]
            excluded = args.excluded or (
                DEFAULT_EXCLUDED if os.path.exists(DEFAULT_EXCLUDED)
                else None
            )
            if excluded:  # reference: util/kaiju-makedb:172,196
                cargs += ["-e", excluded]
            if db == "nr_euk":
                cargs += ["-l", args.taxon_list or write_taxon_list(w)]
            conv(cargs)
        elif db in ("refseq_nr", "refseq_ref"):
            if db == "refseq_ref":
                if download:
                    summaries = [
                        fetch(ASSEMBLY.format(group=g), dbdir)
                        for g in ("archaea", "bacteria")
                    ]
                    urls = assembly_urls(
                        summaries,
                        category={"representative genome",
                                  "reference genome"},
                    )
                    fetch_many(urls, src, args.threads)
                    fetch_release("viral", src, args.threads)
                faas = gbk_to_faa_all(src, args.threads)
                merge_faa(faas, merged_dmp, faa)
            else:  # refseq_nr: WP proteins + accession2taxid.FULL
                if download:
                    fetch_release("complete", src, args.threads)
                    fetch(PROT_A2T_FULL, dbdir)
                from .convert_refseq import main as conv

                # stream-concatenate the numbered wp_protein files
                cat = os.path.join(dbdir, "all_wp.faa")
                with open(cat, "w") as out:
                    for f in sorted(os.listdir(src)):
                        if "wp_protein" in f and f.endswith(".faa.gz"):
                            with gzip.open(os.path.join(src, f), "rt") as fh:
                                out.write(fh.read())
                cargs = ["-m", merged_dmp, "-t", nodes_dmp,
                         "-g", os.path.join(dbdir,
                                            "prot.accession2taxid.FULL.gz"),
                         "-a", "-o", faa, "-i", cat,
                         "-l", args.taxon_list or write_taxon_list(w)]
                conv(cargs)
        elif db in ("viruses", "plasmids", "fungi", "refseq"):
            if download:
                if db == "viruses":
                    fetch_release("viral", src, args.threads)
                elif db == "plasmids":
                    fetch_release("plasmid", src, args.threads)
                elif db == "fungi":
                    summary = fetch(ASSEMBLY.format(group="fungi"), dbdir)
                    fetch_many(assembly_urls([summary]), src, args.threads)
                else:  # refseq: complete bacterial+archaeal + viral
                    summaries = [
                        fetch(ASSEMBLY.format(group=g), dbdir)
                        for g in ("archaea", "bacteria")
                    ]
                    urls = assembly_urls(summaries, status="Complete Genome")
                    fetch_many(urls, src, args.threads)
                    fetch_release("viral", src, args.threads)
            faas = gbk_to_faa_all(src, args.threads)
            merge_faa(faas, merged_dmp, faa)
        elif db == "progenomes":
            import bz2

            if download:
                fetch(PROGENOMES, src)
                fetch_release("viral", src, args.threads)
            rep = os.path.join(src, "representatives.proteins.faa")
            with bz2.open(os.path.join(src, PROGENOMES.rsplit("/", 1)[1]),
                          "rt") as fh, open(rep, "w") as out:
                # headers ">taxid.acc" -> ">acc_taxid"
                pat = re.compile(r">(\d+)\.(\S+)")
                bad = re.compile(r"[^ARNDCQEGHILKMFPSTWYV]", re.IGNORECASE)
                for line in fh:
                    line = line.rstrip("\n")
                    m = pat.match(line)
                    if m:
                        out.write(f">{m.group(2)}_{m.group(1)}\n")
                    else:
                        s = bad.sub("", line.translate(
                            str.maketrans("BZ", "DE")))
                        if s:
                            out.write(s + "\n")
            faas = gbk_to_faa_all(src, args.threads) + [rep]
            merge_faa(faas, merged_dmp, faa)
        elif db == "rvdb":
            if download:
                fetch(RVDB, dbdir)
                fetch(PROT_A2T, dbdir)
            import lzma

            # load accession -> taxid (column 2/3 of prot.accession2taxid)
            a2t = {}
            with gzip.open(os.path.join(dbdir, "prot.accession2taxid.gz"),
                           "rt") as fh:
                fh.readline()
                for line in fh:
                    p = line.rstrip("\n").split("\t")
                    if len(p) >= 3:
                        a2t[p[1]] = p[2]
            pat = re.compile(r">[^\|]+\|[^\|]+\|([^\|]+)")
            with lzma.open(os.path.join(dbdir, RVDB.rsplit("/", 1)[1]),
                           "rt") as fh, open(faa, "w") as out:
                keep = False
                for line in fh:
                    line = line.rstrip("\n")
                    m = pat.match(line)
                    if line.startswith(">"):
                        keep = False
                        if m and m.group(1) in a2t:
                            out.write(f">{m.group(1)}_{a2t[m.group(1)]}\n")
                            keep = True
                    elif keep:
                        out.write(line + "\n")

    if not os.path.exists(faa):
        raise SystemExit(f"missing {faa}")
    build_index(faa, os.path.join(dbdir, f"kaiju_db_{db}"), sa_exp,
                nodes_dmp=nodes_dmp, aot=args.aot, device=device)
    log(f"Done. Use {os.path.join(dbdir, f'kaiju_db_{db}.ktx')} with "
        "kaiju-tpu-torch, plus nodes.dmp and names.dmp.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
