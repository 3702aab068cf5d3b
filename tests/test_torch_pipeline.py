"""The port's MEM pipeline (kaiju_tpu_torch.engine.mem.MemPipeline and the
`kaiju -a mem` CLI) on the CPU: its TSV must be byte-identical to
kaiju_tpu's MemFastPipeline and to the host ExactClassifier, on an index
without a text copy (the .fmi configuration)."""

import os
import random

import pytest

from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.engine.core import ExactClassifier, format_output_line
from kaiju_tpu.engine.mem_fast import MemFastPipeline
from kaiju_tpu.index import py_builder as jax_py_builder
from kaiju_tpu.io.taxonomy import Taxonomy
from kaiju_tpu_torch.engine import mem as tmem
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.io.taxonomy import Taxonomy as TorchTaxonomy
from kaiju_tpu_torch.tools import kaiju as tkaiju

from conftest import make_db_records, write_nodes_dmp
from readgen import (make_protein_reads, make_reads, reverse_translate,
                     write_fastq)
from test_exact_parity import _diff, _lowcomp_reads


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = random.Random(61)
    records = make_db_records(rng, nseq=40)
    jidx = jax_py_builder.build_index(records)
    jidx.text = None  # no text copy: unscreened, FM-only on both sides
    tidx = py_builder.build_index(records)
    tidx.text = None
    work = tmp_path_factory.mktemp("torch_pipeline")
    nodes = write_nodes_dmp(str(work / "nodes.dmp"))
    reads = make_reads(rng, records, n=150) + _lowcomp_reads(rng, records, n=40)
    for t in range(8):  # periodic motifs: more ties than T, host replay
        _, prot = records[rng.randrange(len(records))]
        st = rng.randrange(0, len(prot) - 14)
        reads.append((f"rep{t}", reverse_translate(rng, ("W" + prot[st : st + 14]) * 9)))
    return {
        "rng": rng, "records": records, "jidx": jidx, "tidx": tidx,
        "nodes": nodes, "work": work, "reads": reads,
    }


def _tsv(results):
    return "".join(format_output_line(n, r, False) for n, r in results)


def _three_way(env, cfg, items, split=None):
    """(port TSV, JAX MemFastPipeline TSV, ExactClassifier TSV)."""
    batches = [items[:split], items[split:]] if split else [items]
    pipe = tmem.MemPipeline(env["tidx"], TorchTaxonomy(env["nodes"]), cfg,
                            device="cpu")
    port = "".join(_tsv(r) for r in pipe.classify_stream(batches))
    tax = Taxonomy(env["nodes"])
    jax_pipe = MemFastPipeline(env["jidx"], tax, cfg)
    assert jax_pipe._hyb_arrays()[0] is None and jax_pipe._bloom_words is None
    # one padded shape and lane capacities that fit every batch here, and
    # one shared executable cache: a single XLA:CPU compile serves every
    # config (results never depend on shapes or capacities)
    jax_pipe._caps.update(pmax={512: 65536}, fmax={512: 16384})
    jax_pipe._m2[65536] = 65536
    jax_pipe._msm[65536] = 16384
    jax_pipe._aot = env.setdefault("jax_aot", jax_pipe._aot)
    jax = "".join(_tsv(r) for r in jax_pipe.classify_stream(batches))
    exact = _tsv(ExactClassifier(env["jidx"], tax, cfg).classify_batch(items))
    return port, jax, exact


@pytest.mark.parametrize("seg", [True, False])
def test_mem_tsv_matches_jax_and_exact(env, seg):
    """SEG on and off; a two-batch stream."""
    items = [(n, s, None) for n, s in env["reads"]]
    cfg = KaijuConfig(mode="mem", seg=seg, use_Evalue=False)
    tmem.reset_counts()
    port, jax, exact = _three_way(env, cfg, items, split=len(items) // 2)
    assert port == exact, _diff(port, exact)
    assert port == jax, _diff(port, jax)
    assert port.count("\nC\t") > 60
    assert tmem.HOST_REPLAY["reads"] == len(items)
    assert tmem.HOST_REPLAY["flagged"] > 0  # the replay path ran


def test_mem_tsv_protein_input(env):
    items = [(n, s, None) for n, s in
             make_protein_reads(random.Random(62), env["records"], n=80)]
    cfg = KaijuConfig(mode="mem", seg=True, use_Evalue=False,
                      input_is_protein=True)
    port, jax, exact = _three_way(env, cfg, items)
    assert port == exact, _diff(port, exact)
    assert port == jax, _diff(port, jax)


def test_mem_tsv_paired_reads(env):
    rng = random.Random(63)
    r1 = make_reads(rng, env["records"], n=60)
    r2 = make_reads(rng, env["records"], n=60)
    items = [(r1[i][0], r1[i][1], r2[i][1]) for i in range(60)]
    cfg = KaijuConfig(mode="mem", seg=True, use_Evalue=False)
    port, jax, exact = _three_way(env, cfg, items)
    assert port == exact, _diff(port, exact)
    assert port == jax, _diff(port, jax)


def test_cli_main_on_saved_ktx(env):
    """tools.kaiju.main(..., device="cpu") on a saved .ktx writes the
    ExactClassifier's TSV; the last batch holds only reads too short for
    a fragment."""
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
    rc = tkaiju.main(["-t", nodes, "-f", ktx, "-i", fq, "-a", "mem",
                      "-o", out, "-b", "64"], device="cpu")
    assert rc == 0
    cfg = KaijuConfig(mode="mem", seg=True, use_Evalue=False)
    items = [(n, s, None) for n, s in reads]
    exact = _tsv(ExactClassifier(env["jidx"], Taxonomy(env["nodes"]), cfg)
                 .classify_batch(items))
    with open(out) as fh:
        got = fh.read()
    assert got == exact, _diff(got, exact)
    for other in ([], ["-a", "mem", "-v"], ["-a", "mem", "-d"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tkaiju.main(["-t", nodes, "-f", ktx, "-i", fq, *other],
                        device="cpu")


def test_mixed_depth_taxa_follow_the_reference(env):
    """Taxa at several depths (species, genus, superkingdom, one absent
    from the tree): the port's LCA lifts to the shallowest taxon and climbs
    like the reference, so its TSV equals the ExactClassifier's."""
    rng = random.Random(64)
    records = []
    for i, (name, seq) in enumerate(env["records"]):
        taxid = [101, 100, 10, 102, 999, 201][i % 6]
        records.append((f"{name.rsplit('_', 1)[0]}_{taxid}", seq))
    idx = py_builder.build_index(records)
    idx.text = None
    items = [(n, s, None) for n, s in make_reads(rng, records, n=150)]
    cfg = KaijuConfig(mode="mem", seg=True, use_Evalue=False)
    pipe = tmem.MemPipeline(idx, TorchTaxonomy(env["nodes"]), cfg, device="cpu")
    port = _tsv(pipe.classify_batch(items))
    exact = _tsv(ExactClassifier(idx, Taxonomy(env["nodes"]), cfg)
                 .classify_batch(items))
    assert port == exact, _diff(port, exact)
    assert "\t100\n" in port and "\t10\n" in port
