"""The port's Greedy pipeline (kaiju_tpu_torch.engine.greedy.GreedyPipeline
and the `kaiju` CLI with its default flags) on the CPU: its TSV must be
byte-identical to kaiju_tpu's GreedyDevicePipeline and to the host
ExactClassifier, on an index without a text copy (the .fmi
configuration)."""

import os
import random

import pytest
import torch

from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.engine.core import ExactClassifier, format_output_line
from kaiju_tpu.engine.greedy_device import GreedyDevicePipeline
from kaiju_tpu.index import py_builder as jax_py_builder
from kaiju_tpu.io.taxonomy import Taxonomy
from kaiju_tpu.ops import device_index as jdev
from kaiju_tpu.ops.kmer import KmerTables as JaxKmerTables
from kaiju_tpu_torch.engine import greedy as tgreedy
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.io.taxonomy import Taxonomy as TorchTaxonomy
from kaiju_tpu_torch.tools import kaiju as tkaiju

from conftest import make_db_records, write_nodes_dmp
from readgen import (make_protein_reads, make_reads, reverse_translate,
                     write_fastq)
from test_exact_parity import _diff, _lowcomp_reads

P_PAD, F_PAD = 65536, 16384  # one padded JAX shape for every config here


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = random.Random(101)
    records = make_db_records(rng, nseq=40)
    jidx = jax_py_builder.build_index(records)
    jidx.text = None  # no text copy: no Bloom screen, no hybrid
    tidx = py_builder.build_index(records)
    tidx.text = None
    work = tmp_path_factory.mktemp("torch_greedy_pipeline")
    nodes = write_nodes_dmp(str(work / "nodes.dmp"))
    reads = make_reads(rng, records, n=150) + _lowcomp_reads(rng, records, n=40)
    for t in range(6):  # periodic motifs: more ties than T or positions
        _, prot = records[rng.randrange(len(records))]  # than R: replay
        st = rng.randrange(0, len(prot) - 14)
        reads.append((f"rep{t}", reverse_translate(
            rng, ("W" + prot[st:st + 14]) * (24 if t < 2 else 9))))
    # one fragment of 520 aa or more (whole DB proteins, no stop): replay
    long_prot = "".join(p for _n, p in records)[:540]
    reads.append(("long0", reverse_translate(rng, long_prot)))
    return {
        "rng": rng, "records": records, "jidx": jidx, "tidx": tidx,
        "nodes": nodes, "work": work, "reads": reads,
        # one JAX device index and host-built seed tables for every config
        "jax_dev": jdev.DeviceIndex(jidx),
        "jax_kmer": JaxKmerTables.build(jidx, 5),
    }


def _tsv(results):
    return "".join(format_output_line(n, r, False) for n, r in results)


def _exact(env, cfg, items):
    """ExactClassifier's TSV, computed once per configuration and reads."""
    key = (repr(cfg), tuple(n for n, _s1, _s2 in items))
    cache = env.setdefault("exact", {})
    if key not in cache:
        cache[key] = _tsv(ExactClassifier(
            env["jidx"], Taxonomy(env["nodes"]), cfg).classify_batch(items))
    return cache[key]


def _port(env, cfg, batches, **attrs):
    pipe = tgreedy.GreedyPipeline(env["tidx"], TorchTaxonomy(env["nodes"]),
                                  cfg, device="cpu")
    for k, v in attrs.items():
        setattr(pipe, k, v)
    return "".join(_tsv(r) for r in pipe.classify_stream(batches))


def _three_way(env, cfg, items, split=None):
    """(port TSV, JAX GreedyDevicePipeline TSV, ExactClassifier TSV)."""
    batches = [items[:split], items[split:]] if split else [items]
    port = _port(env, cfg, batches)
    tax = Taxonomy(env["nodes"])
    jax_pipe = GreedyDevicePipeline(env["jidx"], tax, cfg,
                                    device_index=env["jax_dev"],
                                    kmer_tables=env["jax_kmer"])
    assert jax_pipe._hyb_arrays()[0] is None and jax_pipe._bloom_words is None
    # one padded shape and lane capacities that fit every batch here, and
    # one shared executable cache: a single XLA:CPU compile serves every
    # config (results never depend on shapes or capacities)
    jax_pipe._caps.update(pmax={512: P_PAD}, fmax={512: F_PAD})
    for m, v in ((jax_pipe._m2, P_PAD), (jax_pipe._msm, 16384),
                 (jax_pipe._mn, 16384), (jax_pipe._mv, 65536),
                 (jax_pipe._mt, 16384), (jax_pipe._mh, 65536)):
        m[P_PAD] = v
    jax_pipe._aot = env.setdefault("jax_aot", jax_pipe._aot)
    jax = "".join(_tsv(r) for r in jax_pipe.classify_stream(batches))
    return port, jax, _exact(env, cfg, items)


@pytest.mark.parametrize("seg", [True, False])
def test_greedy_tsv_matches_jax_and_exact(env, seg):
    """SEG on and off; a two-batch stream; reads replayed for ties past T,
    positions past R and a fragment of 512 aa or more."""
    items = [(n, s, None) for n, s in env["reads"]]
    cfg = KaijuConfig(mode="greedy", seg=seg)
    tgreedy.reset_counts()
    port, jax, exact = _three_way(env, cfg, items, split=len(items) // 2)
    assert port == exact, _diff(port, exact)
    assert port == jax, _diff(port, jax)
    assert port.count("\nC\t") > 60
    counts = tgreedy.HOST_REPLAY
    assert counts["reads"] == len(items)
    # the replay path ran, for each kind of read the data holds
    assert counts["host"] >= 1 and counts["tie_over"] >= 1
    assert counts["need_more"] >= 1 and counts["scratch"] == 0


def test_greedy_tsv_protein_input(env):
    items = [(n, s, None) for n, s in
             make_protein_reads(random.Random(102), env["records"], n=80)]
    cfg = KaijuConfig(mode="greedy", input_is_protein=True)
    port, jax, exact = _three_way(env, cfg, items)
    assert port == exact, _diff(port, exact)
    assert port == jax, _diff(port, jax)


def test_greedy_tsv_paired_reads(env):
    rng = random.Random(103)
    r1 = make_reads(rng, env["records"], n=60)
    r2 = make_reads(rng, env["records"], n=60)
    items = [(r1[i][0], r1[i][1], r2[i][1]) for i in range(60)]
    cfg = KaijuConfig(mode="greedy")
    port, jax, exact = _three_way(env, cfg, items)
    assert port == exact, _diff(port, exact)
    assert port == jax, _diff(port, jax)


def test_greedy_evalue_gate_kills_reads(env):
    """A strict -E: the float64 gate turns reads with a best score into
    unclassified lines, the same ones on all three sides."""
    items = [(n, s, None) for n, s in env["reads"][:120]]
    cfg = KaijuConfig(mode="greedy", min_Evalue=1e-9)
    port, jax, exact = _three_way(env, cfg, items)
    assert port == exact, _diff(port, exact)
    assert port == jax, _diff(port, jax)
    ungated = _port(env, KaijuConfig(mode="greedy"), [items])
    killed = port.count("U\t") - ungated.count("U\t")
    assert 10 < killed < ungated.count("C\t")


def test_scratch_overflow_replays(env):
    """One source slot a read: the reads that need more are flagged
    FLAG_SCRATCH and replayed, and the TSV still equals the
    ExactClassifier's."""
    items = [(n, s, None) for n, s in env["reads"]]
    cfg = KaijuConfig(mode="greedy")
    tgreedy.reset_counts()
    port = _port(env, cfg, [items], VCAP=1)
    exact = _exact(env, cfg, items)
    assert port == exact, _diff(port, exact)
    assert tgreedy.HOST_REPLAY["scratch"] > 5


def test_cli_default_flags_on_saved_ktx(env, monkeypatch):
    """tools.kaiju.main with no mode flag runs Greedy (-e 3, -s 65, -m 11,
    -l 7, SEG, -E 0.01) on a saved .ktx and writes the ExactClassifier's
    TSV; the last batch holds only reads too short for a fragment.  With
    --mesh-index 2 it writes the same TSV on the index in two shards; many
    processes without a coordinator exit with kaiju_tpu's message; without
    a card and without device="cpu" it raises."""
    work = env["work"]
    ktx = str(work / "db.ktx")
    env["tidx"].save(ktx)
    assert not os.path.exists(os.path.join(ktx, "text.npy"))
    fq = str(work / "reads.fastq")
    reads = env["reads"][:128] + [(f"short{i}", "ACGTTG" * (i % 5))
                                  for i in range(64)]
    write_fastq(reads, fq)
    out = str(work / "out.tsv")
    nodes = str(work / "nodes.dmp")
    tgreedy.reset_counts()
    rc = tkaiju.main(["-t", nodes, "-f", ktx, "-i", fq, "-o", out, "-b", "64"],
                     device="cpu")
    assert rc == 0
    assert tgreedy.HOST_REPLAY["reads"] == len(reads)
    cfg = KaijuConfig()
    assert (cfg.mode, cfg.mismatches, cfg.min_score, cfg.use_Evalue) == (
        "greedy", 3, 65, True)
    exact = _exact(env, cfg, [(n, s, None) for n, s in reads])
    with open(out) as fh:
        got = fh.read()
    assert got == exact, _diff(got, exact)
    mesh_out = str(work / "out_mesh.tsv")
    assert tkaiju.main(["-t", nodes, "-f", ktx, "-i", fq, "-o", mesh_out,
                        "-b", "64", "--mesh-index", "2"], device="cpu") == 0
    with open(mesh_out) as fh:
        assert fh.read() == got
    with pytest.raises(SystemExit, match="needs --dist-coordinator"):
        tkaiju.main(["-t", nodes, "-f", ktx, "-i", fq, "--dist-nprocs", "2"],
                    device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkaiju.main(["-t", nodes, "-f", ktx, "-i", fq, "-o", out])
