"""The port's host tools against kaiju_tpu's, on the CPU: kaiju2table,
kaiju2krona, kaiju-addTaxonNames, kaiju-mergeOutputs, convertNR,
convertRefSeq, gbk2faa and makedb of kaiju_tpu_torch/tools/ must write
the files of their kaiju_tpu/tools/ counterparts on the same inputs, byte
for byte.  The inputs come from a seed: a ranked taxonomy with names (a
few taxa without a name), two name-aligned kaiju TSVs with -v columns
(made with numpy, no classifier run), nr and RefSeq inputs as
tests/test_db_pipeline.py writes them and its GenBank text.  No tool here
runs on a device, and nothing compiles XLA."""

import gzip
import os
import random

import numpy as np
import pytest

from kaiju_tpu.tools import convert_nr as jax_convert_nr
from kaiju_tpu.tools import convert_refseq as jax_convert_refseq
from kaiju_tpu.tools import gbk2faa as jax_gbk2faa
from kaiju_tpu.tools import kaiju2krona as jax_kaiju2krona
from kaiju_tpu.tools import kaiju2table as jax_kaiju2table
from kaiju_tpu.tools import kaiju_addTaxonNames as jax_add_names
from kaiju_tpu.tools import kaiju_mergeOutputs as jax_merge
from kaiju_tpu.tools import makedb as jax_makedb
from kaiju_tpu_torch.tools import (convert_nr, convert_refseq, gbk2faa,
                                   kaiju2krona, kaiju2table,
                                   kaiju_addTaxonNames, kaiju_mergeOutputs,
                                   makedb, mkdb)

from conftest import random_protein
from test_db_pipeline import make_nr_inputs, write_taxonomy

RANKS = ("phylum", "class", "order", "family", "genus", "species")
VIRUSES = 10239


def write_ranked_taxonomy(workdir, seed=17):
    """nodes.dmp with ranks and names.dmp of a random tree: root, the
    cellular superkingdoms (2, 2157, 2759) under 131567, each with a chain
    of the six ranks that branches and sometimes skips a rank, strains of
    no rank under some species; viruses (10239) with unranked families.
    Returns (nodes path, names path, leaf taxa, all taxa)."""
    rng = np.random.default_rng(seed)
    rows = [(1, 1, "no rank"), (131567, 1, "no rank"),
            (VIRUSES, 1, "superkingdom")]
    rows += [(t, 131567, "superkingdom") for t in (2, 2157, 2759)]
    nxt = [1000]

    def new(parent, rank):
        nxt[0] += int(rng.integers(1, 40))
        rows.append((nxt[0], parent, rank))
        return nxt[0]

    leaves = []
    for top in (2, 2157, 2759):
        level = [top]
        for rank in RANKS:
            below = []
            for p in level:
                for _ in range(int(rng.integers(1, 3))):
                    if rank not in ("phylum", "species") and rng.random() < 0.15:
                        continue  # this rank skipped under p
                    below.append(new(p, rank))
            level = below or level
        for sp in level:
            leaves.append(sp)
            if rng.random() < 0.3:
                leaves.append(new(sp, "no rank"))  # a strain
    for _ in range(4):
        fam = new(VIRUSES, "no rank" if rng.random() < 0.5 else "family")
        for _ in range(2):
            leaves.append(new(new(fam, "genus"), "species"))
    leaves.append(new(VIRUSES, "species"))
    nodes = os.path.join(workdir, "nodes.dmp")
    names = os.path.join(workdir, "names.dmp")
    with open(nodes, "w") as fh:
        for t, p, r in rows:
            fh.write(f"{t}\t|\t{p}\t|\t{r}\t|\t\t|\n")
    unnamed = {t for t, _p, _r in rows[6:] if rng.random() < 0.04}
    with open(names, "w") as fh:
        for t, _p, r in rows:
            fh.write(f"{t}\t|\tsyn {t}\t|\t\t|\tsynonym\t|\n")
            if t not in unnamed:
                fh.write(f"{t}\t|\tTaxon {t} {r}\t|\t\t|\tscientific name\t|\n")
    return nodes, names, leaves, [t for t, _p, _r in rows]


def write_kaiju_tsvs(workdir, leaves, taxa, seed=18, n=300):
    """Two kaiju TSVs of the same n read names with -v columns (score,
    taxa, accessions, fragments on C lines): mostly leaves, some inner
    taxa, a few taxa outside nodes.dmp; the second agrees with the first
    on about a third of the reads."""
    rng = np.random.default_rng(seed)
    inner = [t for t in taxa if t not in leaves]
    paths = []
    first = None
    for k in range(2):
        lines = []
        for r in range(n):
            if k and rng.random() < 0.35:
                lines.append(first[r])
                continue
            name = f"read{r:04d}_{int(rng.integers(0, 10**6))}"
            if k:
                name = first[r].split("\t")[1]
            u = rng.random()
            if u < 0.25:
                lines.append(f"U\t{name}\t0\n")
                continue
            if u < 0.28:
                taxid = int(rng.choice([424242, 31337]))
            elif u < 0.4:
                taxid = int(rng.choice(inner))
            else:
                taxid = int(rng.choice(leaves))
            score = int(rng.integers(11, 400))
            ids = rng.choice(leaves, size=int(rng.integers(1, 4)))
            accs = ",".join(f"ACC{int(i)}.1" for i in ids) + ","
            frag = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), 14))
            lines.append(f"C\t{name}\t{taxid}\t{score}\t"
                         + ",".join(str(int(i)) for i in ids) + ",\t"
                         + f"{accs}\t{frag},\n")
        first = first or lines
        path = os.path.join(workdir, f"kaiju{k + 1}.out")
        with open(path, "w") as fh:
            fh.writelines(lines)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def tax_env(tmp_path_factory):
    w = str(tmp_path_factory.mktemp("tools"))
    nodes, names, leaves, taxa = write_ranked_taxonomy(w)
    k1, k2 = write_kaiju_tsvs(w, leaves, taxa)
    return {"w": w, "nodes": nodes, "names": names, "k1": k1, "k2": k2}


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _both(tmp_path, jax_main, port_main, argv_of, name="out"):
    """Run both mains on argv_of(output path); their files, which must be
    equal, and the return code."""
    jout, tout = str(tmp_path / f"jax_{name}"), str(tmp_path / f"port_{name}")
    rc_j, rc_t = jax_main(argv_of(jout)), port_main(argv_of(tout))
    assert rc_j == rc_t
    got, want = _read(tout), _read(jout)
    assert got == want
    return got, rc_t


def test_taxonomy_and_tsvs_exercise_the_tools(tax_env):
    """The seeded inputs hold what the tools branch on: every rank,
    unnamed and unknown taxa, viruses, U lines and disagreeing files."""
    text = open(tax_env["nodes"]).read()
    for rank in RANKS + ("superkingdom", "no rank"):
        assert f"|\t{rank}\t|" in text
    lines1 = open(tax_env["k1"]).read().splitlines()
    lines2 = open(tax_env["k2"]).read().splitlines()
    assert len(lines1) == len(lines2) == 300
    assert [ln.split("\t")[1] for ln in lines1] == [
        ln.split("\t")[1] for ln in lines2]
    assert 0 < sum(a != b for a, b in zip(lines1, lines2)) < 300
    assert any(ln.startswith("U") for ln in lines1)
    assert any("\t424242\t" in ln or "\t31337\t" in ln for ln in lines1)
    names = open(tax_env["names"]).read()
    assert 0 < names.count("synonym") - names.count("scientific name")


@pytest.mark.parametrize("rank", ["species", "genus"])
@pytest.mark.parametrize("extra", [
    [], ["-u"], ["-p"], ["-e"], ["-m", "2.0"], ["-c", "5"],
    ["-l", "superkingdom,phylum,genus,species"]],
    ids=["plain", "u", "p", "e", "m", "c", "l"])
def test_kaiju2table_matches_jax(tax_env, tmp_path, rank, extra):
    e = tax_env
    got, rc = _both(tmp_path, jax_kaiju2table.main, kaiju2table.main,
                    lambda out: ["-t", e["nodes"], "-n", e["names"], "-r",
                                 rank, "-o", out, *extra, e["k1"], e["k2"]])
    assert rc == 0 and got.startswith(b"file\tpercent\treads")


@pytest.mark.parametrize("extra", [[], ["-u"],
                                   ["-l", "superkingdom,phylum,genus"]],
                         ids=["plain", "u", "l"])
def test_kaiju2krona_matches_jax(tax_env, tmp_path, extra):
    e = tax_env
    got, rc = _both(tmp_path, jax_kaiju2krona.main, kaiju2krona.main,
                    lambda out: ["-t", e["nodes"], "-n", e["names"], "-i",
                                 e["k1"], "-o", out, *extra])
    assert rc == 0 and got.count(b"\n") > 10


@pytest.mark.parametrize("extra", [[], ["-p"], ["-r", "superkingdom,species"],
                                   ["-u"]], ids=["plain", "p", "r", "u"])
def test_add_taxon_names_matches_jax(tax_env, tmp_path, extra):
    e = tax_env
    got, rc = _both(tmp_path, jax_add_names.main, kaiju_addTaxonNames.main,
                    lambda out: ["-t", e["nodes"], "-n", e["names"], "-i",
                                 e["k1"], "-o", out, *extra])
    assert rc == 0 and got.count(b"\n") <= 300 and got.count(b"\tTaxon ")


@pytest.mark.parametrize("score", [False, True], ids=["", "s"])
@pytest.mark.parametrize("conflict", ["1", "2", "lca", "lowest"])
def test_merge_outputs_matches_jax(tax_env, tmp_path, conflict, score):
    e = tax_env
    got, rc = _both(tmp_path, jax_merge.main, kaiju_mergeOutputs.main,
                    lambda out: ["-i", e["k1"], "-j", e["k2"], "-c",
                                 conflict, "-t", e["nodes"], "-o", out,
                                 *(["-s"] if score else [])])
    assert rc == 0 and got.count(b"\n") == 300


@pytest.fixture(scope="module")
def nr_env(tmp_path_factory):
    w = str(tmp_path_factory.mktemp("nr"))
    nodes, merged = write_taxonomy(w)
    a2t, nr, excluded = make_nr_inputs(w, random.Random(7))
    inc = os.path.join(w, "include.txt")
    with open(inc, "w") as fh:
        fh.write("2759\n10239\n")
    return {"nodes": nodes, "merged": merged, "a2t": a2t, "nr": nr,
            "excluded": excluded, "include": inc}


@pytest.mark.parametrize("extra", [["-e", "excluded", "-a"], [],
                                   ["-l", "include", "-a"]],
                         ids=["excluded_a", "plain", "list_a"])
def test_convert_nr_matches_jax(nr_env, tmp_path, extra):
    e = nr_env
    flags = [e.get(x, x) for x in extra]
    got, rc = _both(tmp_path, jax_convert_nr.main, convert_nr.main,
                    lambda out: ["-t", e["nodes"], "-m", e["merged"], "-g",
                                 e["a2t"], "-i", e["nr"], "-o", out, *flags])
    assert rc == 0 and got.count(b">") >= 2


def _refseq_inputs(w):
    rng = random.Random(8)
    a2t = os.path.join(w, "prot.accession2taxid.FULL.gz")
    with gzip.open(a2t, "wt") as fh:
        fh.write("accession.version\ttaxid\n")
        for acc, tid in (("WP_000001.1", 21), ("WP_000002.1", 40),
                         ("WP_000003.1", 99), ("XP_000004.1", 21),
                         ("WP_000005.1", 50)):
            fh.write(f"{acc}\t{tid}\n")
    fasta = os.path.join(w, "in.faa")
    with open(fasta, "w") as fh:
        for acc in ("WP_000001.1", "WP_000002.1", "WP_000003.1",
                    "XP_000004.1", "WP_000005.1"):
            fh.write(f">{acc} some protein\n")
            seq = random_protein(rng, 30)
            fh.write(seq[:15] + "bz*\n" + seq[15:] + "\n")
    return a2t, fasta


@pytest.mark.parametrize("extra", [["-a"], [], ["-l", "include", "-a"]],
                         ids=["a", "plain", "list_a"])
def test_convert_refseq_matches_jax(nr_env, tmp_path, extra):
    e = nr_env
    a2t, fasta = _refseq_inputs(str(tmp_path))
    flags = [e.get(x, x) for x in extra]
    got, rc = _both(tmp_path, jax_convert_refseq.main, convert_refseq.main,
                    lambda out: ["-t", e["nodes"], "-m", e["merged"], "-g",
                                 a2t, "-i", fasta, "-o", out, *flags])
    assert rc == 0 and got.count(b">") >= 2


GBK = (
    'LOCUS       X\n'
    'FEATURES\n'
    '     source          1..100\n'
    '                     /db_xref="taxon:562"\n'
    '     CDS             1..30\n'
    '                     /protein_id="AAA1.1"\n'
    '                     /translation="MKVLAAGBZTT"\n'
    '     CDS             31..90\n'
    '                     /protein_id="AAA2.1"\n'
    '                     /translation="MKVLAAGXTTARNDCQEGHILKM\n'
    '                     FPSTWYVARNDbzCQEGHILKM\n'
    '                     FPSTW"\n'
    '//\n'
)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_gbk2faa_matches_jax(tmp_path, gz):
    """test_gbk2faa_matches_reference's GenBank text, plain and gzipped,
    held to kaiju_tpu's gbk2faa (the perl reference is not needed)."""
    gbk = str(tmp_path / ("x.gbff.gz" if gz else "x.gbk"))
    with (gzip.open(gbk, "wt") if gz else open(gbk, "w")) as fh:
        fh.write(GBK)
    got, rc = _both(tmp_path, jax_gbk2faa.main, gbk2faa.main,
                    lambda out: [gbk, out])
    assert rc == 0 and got.startswith(b">AAA1.1_562\n")


def _tree(path):
    files = {}
    for root, _dirs, names in os.walk(path):
        for n in names:
            p = os.path.join(root, n)
            files[os.path.relpath(p, path)] = _read(p)
    return files


def _viruses_workdir(w):
    rng = random.Random(9)
    dbdir = os.path.join(w, "viruses")
    os.makedirs(dbdir)
    write_taxonomy(w)
    with open(os.path.join(dbdir, "kaiju_db_viruses.faa"), "w") as fh:
        for i in range(12):
            fh.write(f">ACC{i}.1_50\n{random_protein(rng, 60)}\n")
    return os.path.join(dbdir, "kaiju_db_viruses.ktx")


def test_makedb_index_only_matches_jax(tmp_path):
    """makedb -s viruses --index-only: the port's ktx directory equals
    kaiju_tpu's file for file and byte for byte."""
    jw, tw = str(tmp_path / "jax"), str(tmp_path / "port")
    jktx, tktx = _viruses_workdir(jw), _viruses_workdir(tw)
    assert jax_makedb.main(["-s", "viruses", "--index-only", "-w", jw]) == 0
    assert makedb.main(["-s", "viruses", "--index-only", "-w", tw],
                       device="cpu") == 0
    want, got = _tree(jktx), _tree(tktx)
    assert "text.npy" in got and sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_makedb_nr_euk_uses_the_shipped_lists(tmp_path):
    """makedb -s nr_euk --no-download on local inputs reads the port's own
    data/ lists (excluded accessions, eukaryote include list) and writes
    kaiju_tpu's FASTA and ktx directory byte for byte."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(makedb.__file__)))
    assert makedb.DATA_DIR == os.path.join(pkg, "data")
    assert os.path.isfile(makedb.DEFAULT_EXCLUDED)
    assert os.path.isfile(makedb.DEFAULT_TAXONLIST)
    out = {}
    for tag, run in (("jax", jax_makedb.main), ("port", makedb.main)):
        w = str(tmp_path / tag)
        os.makedirs(os.path.join(w, "nr_euk"))
        nodes, _merged = write_taxonomy(w)
        with open(nodes, "a") as fh:  # Fungi, on the shipped include list
            fh.write("4751\t|\t2759\t|\tkingdom\t|\n")
            fh.write("4890\t|\t4751\t|\tspecies\t|\n")
        a2t, nr, _exc = make_nr_inputs(w, random.Random(7))
        with gzip.open(a2t, "at") as fh:
            fh.write("FUN1\tFUN1.1\t4890\t0\n")
        with open(nr, "a") as fh:
            fh.write(">FUN1.1 a fungal protein\n"
                     + random_protein(random.Random(3), 50) + "\n")
        os.replace(nr, os.path.join(w, "nr_euk", "nr.gz"))
        os.replace(a2t, os.path.join(w, "nr_euk",
                                     "prot.accession2taxid.gz"))
        argv = ["-s", "nr_euk", "--no-download", "-w", w]
        assert (run(argv) if tag == "jax" else run(argv, device="cpu")) == 0
        out[tag] = _tree(os.path.join(w, "nr_euk"))
    assert sorted(out["port"]) == sorted(out["jax"])
    for name in out["jax"]:
        assert out["port"][name] == out["jax"][name], name
    assert b"_4890\n" in out["port"]["kaiju_db_nr_euk.faa"]


def test_makedb_aot_passes_through_to_mkdb(tmp_path, monkeypatch):
    """makedb --aot hands mkdb --aot -t nodes.dmp and its device, as
    kaiju_tpu's makedb hands its flags."""
    tktx = _viruses_workdir(str(tmp_path))
    seen = []

    def spy(argv, device=None):
        seen.append((list(argv), device))
        return 0

    monkeypatch.setattr(mkdb, "main", spy)
    assert makedb.main(["-s", "viruses", "--index-only", "--aot", "-w",
                        str(tmp_path)], device="cpu") == 0
    (argv, device), = seen
    nodes = os.path.join(str(tmp_path), "nodes.dmp")
    assert argv[:2] == ["-o", tktx] and device == "cpu"
    assert argv[argv.index("--aot") + 1:argv.index("--aot") + 3] == [
        "-t", nodes]
    assert argv[-1].endswith("kaiju_db_viruses.faa")
