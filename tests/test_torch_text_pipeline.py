"""The port's pipelines and CLI on the text-carrying index that mkdb
writes, on the CPU: MemPipeline and GreedyPipeline with their Bloom
screen and text-compare hybrid on must write the TSV of kaiju_tpu's
MemFastPipeline and GreedyDevicePipeline (with theirs on) and of the host
ExactClassifier, byte for byte; tools.kaiju.main classifies on a .ktx
built by the port's tools.mkdb; and that .ktx is byte-identical, file by
file, to kaiju_tpu.tools.mkdb's.

The JAX pipelines run in one fresh subprocess: this jaxlib can crash
compiling the hybrid programs in a process that has already compiled many
others (tests/test_mem_fast.py:116-120)."""

import json
import os
import random
import subprocess
import sys

import pytest

from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.engine.core import ExactClassifier, format_output_line
from kaiju_tpu.index import py_builder as jax_py_builder
from kaiju_tpu.io.taxonomy import Taxonomy
from kaiju_tpu.tools import mkdb as jax_mkdb
from kaiju_tpu_torch.engine import greedy as tgreedy
from kaiju_tpu_torch.engine import mem as tmem
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.io.taxonomy import Taxonomy as TorchTaxonomy
from kaiju_tpu_torch.tools import kaiju as tkaiju
from kaiju_tpu_torch.tools import mkdb

from conftest import make_db_records, write_fasta, write_nodes_dmp
from readgen import (make_protein_reads, make_reads, reverse_translate,
                     write_fastq)
from test_exact_parity import _diff, _lowcomp_reads

# (name, mode, SEG, protein input, two batches)
CONFIGS = {
    "mem_seg": ("mem", True, False, True),
    "mem_noseg": ("mem", False, False, False),
    "mem_protein": ("mem", True, True, False),
    "greedy_seg": ("greedy", True, False, True),
    "greedy_noseg": ("greedy", False, False, False),
    "greedy_protein": ("greedy", True, True, False),
}

WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.engine.core import format_output_line
from kaiju_tpu.engine.greedy_device import GreedyDevicePipeline
from kaiju_tpu.engine.mem_fast import MemFastPipeline
from kaiju_tpu.index import py_builder
from kaiju_tpu.io.taxonomy import Taxonomy, parse_nodes_dmp

job = json.load(open(sys.argv[1]))
index = py_builder.build_index(job["records"])
assert index.text is not None
tax = Taxonomy(parse_nodes_dmp(job["nodes_dmp"]))
P_PAD, F_PAD = 65536, 16384
out, aot = {}, {}
for name, (mode, seg, protein, split) in job["configs"].items():
    reads = [tuple(r) for r in job["protein" if protein else "dna"]]
    batches = ([reads[: len(reads) // 2], reads[len(reads) // 2:]] if split
               else [reads])
    cfg = KaijuConfig(mode=mode, seg=seg, use_Evalue=mode == "greedy",
                      input_is_protein=protein)
    Pipe = MemFastPipeline if mode == "mem" else GreedyDevicePipeline
    pipe = Pipe(index, tax, cfg)
    assert pipe._hyb_arrays()[0] is not None  # the hybrid is on
    assert pipe._bloom_words is not None  # and the screen
    # one padded shape and capacities that fit every batch: one compile a
    # path (results never depend on shapes or capacities)
    pipe._caps.update(pmax={512: P_PAD}, fmax={512: F_PAD})
    caps = [(pipe._m2, P_PAD), (pipe._msm, 16384)]
    if mode == "greedy":
        caps += [(pipe._mn, 16384), (pipe._mv, 65536), (pipe._mt, 16384),
                 (pipe._mh, 65536)]
    for m, v in caps:
        m[P_PAD] = v
    pipe._aot = aot.setdefault(mode, pipe._aot)
    out[name] = "".join(format_output_line(n, r, False)
                        for res in pipe.classify_stream(batches)
                        for n, r in res)
json.dump(out, open(sys.argv[2], "w"))
"""


def _tsv(results):
    return "".join(format_output_line(n, r, False) for n, r in results)


def _config(mode, seg, protein):
    return KaijuConfig(mode=mode, seg=seg, use_Evalue=mode == "greedy",
                       input_is_protein=protein)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = random.Random(131)
    records = make_db_records(rng, nseq=40)
    work = tmp_path_factory.mktemp("torch_text_pipeline")
    nodes_dmp = str(work / "nodes.dmp")
    nodes = write_nodes_dmp(nodes_dmp)
    dna = make_reads(rng, records, n=150) + _lowcomp_reads(rng, records, n=30)
    protein = make_protein_reads(rng, records, n=60)
    for t in range(40):  # long exact copies (matches outlive the burn-in),
        _, prot = records[rng.randrange(len(records))]  # some mutated,
        plen = min(len(prot), rng.randint(25, 160))  # some ending at a
        st = (len(prot) - plen if t % 4 == 3  # sequence's end
              else rng.randrange(0, len(prot) - plen + 1))
        sub = prot[st:st + plen]
        if t % 4 == 1:
            x = rng.randrange(plen)
            sub = sub[:x] + ("W" if sub[x] != "W" else "C") + sub[x + 1:]
        dna.append((f"long{t}", reverse_translate(rng, sub)))
        protein.append((f"plong{t}", sub))
    for t in range(6):  # periodic motifs: more ties than T, host replay
        _, prot = records[rng.randrange(len(records))]
        st = rng.randrange(0, len(prot) - 14)
        dna.append((f"rep{t}", reverse_translate(
            rng, ("W" + prot[st:st + 14]) * 9)))
    job = {"records": records, "nodes_dmp": nodes_dmp, "configs": CONFIGS,
           "dna": [(n, s, None) for n, s in dna],
           "protein": [(n, s, None) for n, s in protein]}
    job_path, out_path = str(work / "job.json"), str(work / "jax.json")
    with open(job_path, "w") as fh:
        json.dump(job, fh)
    proc = subprocess.run([sys.executable, "-c", WORKER, job_path, out_path],
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out_path) as fh:
        jax_tsv = json.load(fh)
    fasta = str(work / "db.faa")
    write_fasta(records, fasta)
    return {
        "records": records, "nodes": nodes, "nodes_dmp": nodes_dmp,
        "work": work, "fasta": fasta,
        "jidx": jax_py_builder.build_index(records),
        "tidx": py_builder.build_index(records),
        "dna": job["dna"], "protein": job["protein"], "jax": jax_tsv,
    }


@pytest.mark.parametrize("name", list(CONFIGS))
def test_text_index_tsv_matches_jax_and_exact(env, name):
    """SEG on and off, -p, a two-batch stream, for each path: the port
    with its screen and hybrid on writes the JAX pipelines' TSV (theirs on
    too) and the ExactClassifier's."""
    mode, seg, protein, split = CONFIGS[name]
    items = [tuple(r) for r in env["protein" if protein else "dna"]]
    batches = [items[: len(items) // 2], items[len(items) // 2:]] if split \
        else [items]
    cfg = _config(mode, seg, protein)
    engine = tmem if mode == "mem" else tgreedy
    Pipe = tmem.MemPipeline if mode == "mem" else tgreedy.GreedyPipeline
    pipe = Pipe(env["tidx"], TorchTaxonomy(env["nodes"]), cfg, device="cpu")
    assert pipe._bloom is not None and pipe._hyb is not None
    engine.reset_counts()
    port = "".join(_tsv(r) for r in pipe.classify_stream(batches))
    exact = _tsv(ExactClassifier(env["jidx"], Taxonomy(env["nodes"]), cfg)
                 .classify_batch(items))
    assert port == exact, _diff(port, exact)
    assert port == env["jax"][name], _diff(port, env["jax"][name])
    assert engine.HOST_REPLAY["reads"] == len(items)
    assert port.count("C\t") > len(items) // 3


@pytest.fixture(scope="module")
def ktx(env):
    """The .ktx that the port's mkdb writes, with its seed tables."""
    path = str(env["work"] / "mkdb.ktx")
    assert mkdb.main(["-o", path, "--kmer", env["fasta"]], device="cpu") == 0
    return path


@pytest.mark.parametrize("mode", ["greedy", "mem"])
def test_cli_main_on_mkdb_ktx(env, ktx, mode):
    """tools.kaiju.main(..., device="cpu") on the port mkdb's .ktx (text
    copy and seed tables): the ExactClassifier's TSV, with the screen's
    bitmap cached next to the index."""
    assert os.path.exists(os.path.join(ktx, "text.npy"))
    work = env["work"]
    fq = str(work / "reads.fastq")
    reads = [tuple(r) for r in env["dna"]]
    write_fastq([(n, s) for n, s, _ in reads], fq)
    out = str(work / f"out_{mode}.tsv")
    flags = ["-a", "mem"] if mode == "mem" else []
    rc = tkaiju.main(["-t", env["nodes_dmp"], "-f", ktx, "-i", fq, *flags,
                      "-o", out, "-b", "64"], device="cpu")
    assert rc == 0
    cfg = _config(mode, True, False)
    exact = _tsv(ExactClassifier(env["jidx"], Taxonomy(env["nodes"]), cfg)
                 .classify_batch(reads))
    with open(out) as fh:
        got = fh.read()
    assert got == exact, _diff(got, exact)
    m = 11 if mode == "mem" else 7
    assert any(f.startswith(f"bloom_m{m}_") for f in os.listdir(ktx))


def _tree(path):
    files = {}
    for root, _dirs, names in os.walk(path):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, path)] = fh.read()
    return files


@pytest.mark.parametrize("kmer", [False, True])
def test_mkdb_output_matches_jax(env, kmer):
    """The port's mkdb writes kaiju_tpu.tools.mkdb's directory, file by
    file and byte for byte (text copy included; with --kmer, the seed
    tables of the default depth, built through kernel A's plain version)."""
    work = env["work"]
    flags = ["--kmer"] if kmer else []
    jdir, tdir = str(work / f"jax_{kmer}.ktx"), str(work / f"port_{kmer}.ktx")
    assert jax_mkdb.main(["-o", jdir, *flags, env["fasta"]]) == 0
    assert mkdb.main(["-o", tdir, *flags, env["fasta"]], device="cpu") == 0
    want, got = _tree(jdir), _tree(tdir)
    assert "text.npy" in got
    assert any(n.startswith("kmer") for n in got) == kmer
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    with pytest.raises(SystemExit) as exc:  # --aot needs -t, as in JAX
        mkdb.main(["-o", tdir, "--aot", env["fasta"]], device="cpu")
    assert exc.value.code == 2
