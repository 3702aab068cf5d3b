"""The port's index-sharded Greedy path on the CPU
(kaiju_tpu_torch.parallel.sharded_fused.ShardedGreedyPipeline, K16f):
its device rows (lca, best, flags, n_ids) and its results against
kaiju_tpu's ShardedGreedyClassifier (mesh 4 x 2, -e 2, the DB and reads
of tests/test_sharded.py's sharded Greedy test, 64 of them) on an index
without and with a text copy, and the TSV of `kaiju --mesh-index S` with the default flags
(S = 1 to 4; 3 leaves a padded last shard) through main(..., device="cpu")
against the port's unsharded TSV and the host ExactClassifier.

Where the port flags a read FLAG_TIE_ORDER, it replays the read through
ExactClassifier, and kaiju_tpu through GreedyFastPipeline, which carries
the Greedy tie-order fault (ROADMAP.md queue 3): there the port's result
must be the ExactClassifier's.

The JAX program runs once, in one fresh subprocess started by the
module's fixture, so that its XLA:CPU compiles overlap the port's runs."""

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
from kaiju_tpu_torch.engine.config import KaijuConfig as TorchConfig
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.io.taxonomy import Taxonomy as TorchTaxonomy
from kaiju_tpu_torch.ops.greedy import FLAG_SCRATCH, FLAG_TIE_ORDER
from kaiju_tpu_torch.parallel.sharded_fused import ShardedGreedyPipeline
from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex
from kaiju_tpu_torch.tools import kaiju as tkaiju

from conftest import make_db_records, write_nodes_dmp
from readgen import make_reads, reverse_translate, write_fastq
from test_exact_parity import _diff, _lowcomp_reads
from test_torch_hybrid_hosts import text_view

N_INDEX = 2  # index shards of the JAX classifier (mesh 4 x 2)
MISMATCHES = 2

WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.index import py_builder
from kaiju_tpu.io.taxonomy import Taxonomy, parse_nodes_dmp
from kaiju_tpu.parallel import multihost
from kaiju_tpu.parallel.sharded_fused import ShardedGreedyClassifier
from kaiju_tpu.parallel.sharded_index import make_mesh

job = json.load(open(sys.argv[1]))
assert len(jax.devices()) == 8
tax = Taxonomy(parse_nodes_dmp(job["nodes_dmp"]))
cfg = KaijuConfig(mode="greedy", mismatches=job["mismatches"])
reads = [tuple(r) for r in job["reads"]]
out = {}
for tag in ("fmi", "text"):
    idx = py_builder.build_index(job["records"])
    if tag == "fmi":
        idx.text = None
    cls = ShardedGreedyClassifier(idx, tax, cfg,
                                  make_mesh(n_index_shards=job["n_index"]),
                                  n_index=job["n_index"])
    state = cls.submit_batch(reads)
    per, caps, dev_out = state[1], state[4], state[5]
    rows = multihost.local_rows(dev_out)
    # the device rows of the first dispatch, when no capacity overflowed
    # (a retry would replace them)
    n2, ns, nn, nv, nt, want_h = (int(x) for x in rows[0][per, :6])
    m2, ms, mn, mv, mt = caps
    assert (n2 <= m2 and ns <= ms and nn <= mn and nv <= mv and nt <= mt
            and want_h <= max(mv // 4, 2048)), "capacity retry"
    res = cls.collect_batch(state)
    out[tag] = {
        "per": per,
        "rows": [np.asarray(rows[d][:per, :4]).tolist()
                 for d in sorted(rows)],
        "results": [[bool(r.classified), int(r.lca), int(r.score)]
                    for _n, r in res],
    }
json.dump(out, open(sys.argv[2], "w"))
"""


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = random.Random(31)
    records = make_db_records(rng, nseq=16)
    work = tmp_path_factory.mktemp("torch_sharded_greedy")
    nodes_dmp = str(work / "nodes.dmp")
    nodes = write_nodes_dmp(nodes_dmp)
    reads = [(n, s, None) for n, s in make_reads(rng, records, n=64)]
    job = {"records": records, "nodes_dmp": nodes_dmp, "reads": reads,
           "n_index": N_INDEX, "mismatches": MISMATCHES}
    job_path, out_path = str(work / "job.json"), str(work / "jax.json")
    with open(job_path, "w") as fh:
        json.dump(job, fh)
    proc = subprocess.Popen([sys.executable, "-c", WORKER, job_path,
                             out_path], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)

    def jax_out():
        if "jax_json" not in env_:
            _out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-3000:]
            with open(out_path) as fh:
                env_["jax_json"] = json.load(fh)
        return env_["jax_json"]

    index = {}
    for tag in ("fmi", "text"):
        index[tag] = py_builder.build_index(records)
        if tag == "fmi":
            index[tag].text = None
    env_ = {"records": records, "nodes": nodes, "nodes_dmp": nodes_dmp,
            "work": work, "jax": jax_out, "reads": reads, "index": index,
            "jidx": jax_py_builder.build_index(records)}
    yield env_
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _cache(env, tag):
    """The seed tables' (and the text index's bitmaps') cache of an index,
    shared by the tests of this file."""
    path = env["work"] / f"cache_{tag}"
    path.mkdir(exist_ok=True)
    return str(path)


def _exact(env, cfg, items):
    return ExactClassifier(env["jidx"], Taxonomy(env["nodes"]),
                           cfg).classify_batch(items)


def _norm(res):
    return (res.classified, res.lca if res.classified else 0,
            res.score if res.classified else 0)


@pytest.mark.parametrize("tag", ["fmi", "text"])
def test_sharded_greedy_rows_match_sharded_classifier(env, tag):
    """ShardedGreedyPipeline's device rows equal ShardedGreedyClassifier's
    read by read (the port's own flags, FLAG_SCRATCH and FLAG_TIE_ORDER,
    aside), and its results equal classify_reads', except on the reads
    the port flags FLAG_TIE_ORDER, where they equal ExactClassifier's.  On
    the text index E's last level switches to text comparison and F reads
    the virtual rows, on both sides."""
    cfg = TorchConfig(mode="greedy", mismatches=MISMATCHES)
    pipe = ShardedGreedyPipeline(env["index"][tag],
                                 TorchTaxonomy(env["nodes"]), cfg, N_INDEX,
                                 device="cpu",
                                 kmer_cache_dir=_cache(env, tag))
    assert (pipe._hyb is not None) == (tag == "text")
    assert pipe.dev.S == N_INDEX and pipe.dev.rec.S == N_INDEX
    reads = env["reads"]
    state = pipe.submit_batch(reads)
    rows = state[2].numpy()
    results = pipe.collect_batch(state)
    want = env["jax"]()[tag]
    per = want["per"]
    exact = _exact(env, KaijuConfig(mode="greedy", mismatches=MISMATCHES),
                   reads)
    for g, (name, res) in enumerate(results):
        d, r = divmod(g, per)
        lca, best, flags, n_ids = rows[g].tolist()
        if not flags & FLAG_SCRATCH:
            w = want["rows"][d][r]
            assert (lca, best, flags & 3, n_ids) == (
                w[0], w[1], w[2] & 3, w[3]), name
        if flags & FLAG_TIE_ORDER:
            assert _norm(res) == _norm(exact[g][1]), name
        else:
            assert list(_norm(res)) == want["results"][g], name
    assert (rows[:, 1] > 0).sum() > 30
    assert sum(res.classified for _n, res in results) > 25


def test_hosts_greedy_rows_with_hybrid_match_sharded_classifier(env):
    """Over a group on several hosts (shard 0 of N_INDEX remote, its rows,
    samples and text rows served in rounds by the in-process server of
    tests/test_torch_hybrid_hosts.py), ShardedGreedyPipeline runs the
    hybrid on the text index (X's last-level stop, Y in stages "switch"
    and "text", U's virtual tie rows, V, Q, W), and its device rows equal
    ShardedGreedyClassifier's with the hybrid (the port's own flags
    aside), read by read."""
    cfg = TorchConfig(mode="greedy", mismatches=MISMATCHES)
    idx = env["index"]["text"]
    view = text_view(ShardedIndex(idx, N_INDEX, "cpu"), (0,))
    pipe = ShardedGreedyPipeline(idx, TorchTaxonomy(env["nodes"]), cfg,
                                 N_INDEX, kmer_cache_dir=_cache(env, "text"),
                                 view=view)
    assert pipe._hyb is not None and pipe.dev.exchange is view.exchange
    reads = env["reads"]
    rows = pipe.submit_batch(reads)[2].numpy()
    want = env["jax"]()["text"]
    per = want["per"]
    for g in range(len(reads)):
        d, r = divmod(g, per)
        lca, best, flags, n_ids = rows[g].tolist()
        if not flags & FLAG_SCRATCH:
            w = want["rows"][d][r]
            assert (lca, best, flags & 3, n_ids) == (
                w[0], w[1], w[2] & 3, w[3]), reads[g][0]
    assert (rows[:, 1] > 0).sum() > 30
    assert view.exchange.stages.get("switch", 0) > 0


def test_cli_mesh_index_greedy_tsv(env, monkeypatch):
    """kaiju --mesh-index S with the default flags (Greedy -e 3, SEG,
    -E 0.01) through main(..., device="cpu"), S = 1, 2, 3, 4, on the text
    index, writes the port's unsharded TSV byte for byte, and it is the
    ExactClassifier's; S = 3 leaves a padded last shard.  Reads with more
    ties than T, or with taxa cut by the id cap, replay on the host."""
    monkeypatch.setenv("KAIJU_TPU_CACHE", _cache(env, "text"))
    work = env["work"]
    ktx = str(work / "db_text.ktx")
    env["index"]["text"].save(ktx)
    rng = random.Random(37)
    records = env["records"]
    reads = make_reads(rng, records, n=48) + _lowcomp_reads(rng, records, 8)
    for t in range(4):  # periodic motifs: more ties than T, host replay
        _, prot = records[rng.randrange(len(records))]
        st = rng.randrange(0, len(prot) - 14)
        reads.append((f"rep{t}", reverse_translate(
            rng, ("W" + prot[st:st + 14]) * 9)))
    fq = str(work / "reads_cli.fastq")
    write_fastq(reads, fq)
    argv = ["-t", env["nodes_dmp"], "-f", ktx, "-i", fq, "-b", "48"]
    tsv = {}
    for S in (0, 1, 2, 3, 4):
        out = str(work / f"out_greedy_{S}.tsv")
        mesh = ["--mesh-index", str(S)] if S else []
        assert tkaiju.main(argv + mesh + ["-o", out], device="cpu") == 0
        with open(out) as fh:
            tsv[S] = fh.read()
    exact = "".join(format_output_line(n, r, False) for n, r in _exact(
        env, KaijuConfig(), [(n, s, None) for n, s in reads]))
    for S in (1, 2, 3, 4):
        assert tsv[S] == tsv[0], (S, _diff(tsv[S], tsv[0]))
    assert tsv[0] == exact, _diff(tsv[0], exact)
    assert tsv[0].count("\nC\t") > 20
    nb = env["jidx"].bwt.shape[0] // 128
    padded = [S for S in (2, 3, 4) if S * -(-nb // S) > nb]
    assert 3 in padded, (nb, padded)


N_DATA = 4  # data rows of the JAX mesh (4 x 2), CPU slots of the port


@pytest.mark.parametrize("tag", ["fmi", "text"])
def test_greedy_rows_over_cpu_slots_match_data_rows(env, tag):
    """kaiju --mesh-index 2 over 4 CPU slots: each slot's
    ShardedGreedyPipeline (engine.pipeline.CardShare, the shards placed by
    ShardedIndex.on_cards) classifies local_rows(64, 4, c), and its rows
    equal ShardedGreedyClassifier's data row c on its 4 x 2 mesh (the
    port's own flags aside, as above)."""
    from kaiju_tpu_torch.engine.pipeline import CardShare
    from kaiju_tpu_torch.parallel.multihost import local_rows
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    cfg = TorchConfig(mode="greedy", mismatches=MISMATCHES)
    tax = TorchTaxonomy(env["nodes"])
    views = ShardedIndex.on_cards(env["index"][tag], N_INDEX,
                                  ["cpu"] * N_DATA)
    share = CardShare(lambda c: ShardedGreedyPipeline(
        env["index"][tag], tax, cfg, N_INDEX,
        kmer_cache_dir=_cache(env, tag), view=views[c]), ["cpu"] * N_DATA)
    want = env["jax"]()[tag]
    reads = env["reads"]
    try:
        jobs = share.submit_batch(reads)
        assert [c for c, _f in jobs] == list(range(N_DATA))
        for c, job in jobs:
            lo, hi = local_rows(len(reads), N_DATA, c)
            assert (lo, hi) == (c * want["per"], (c + 1) * want["per"])
            rows = job.result()[2].numpy()
            assert rows.shape[0] == hi - lo
            for r, (lca, best, flags, n_ids) in enumerate(rows.tolist()):
                if not flags & FLAG_SCRATCH:
                    w = want["rows"][c][r]
                    assert (lca, best, flags & 3, n_ids) == (
                        w[0], w[1], w[2] & 3, w[3]), reads[lo + r][0]
    finally:
        share.close()


@pytest.mark.parametrize("D", [2, 4])
def test_cli_mesh_index_greedy_over_cpu_slots(env, monkeypatch, D):
    """kaiju --mesh-index S with the default flags through main(...,
    device=["cpu"] * D), S = 1, 2, 4, on the text index, writes the
    one-card TSV byte for byte."""
    monkeypatch.setenv("KAIJU_TPU_CACHE", _cache(env, "text"))
    work = env["work"]
    if "slot_tsv" not in env:
        ktx = str(work / "db_slots.ktx")
        env["index"]["text"].save(ktx)
        rng = random.Random(41)
        reads = make_reads(rng, env["records"], n=60)
        fq = str(work / "reads_slots.fastq")
        write_fastq(reads, fq)
        argv = ["-t", env["nodes_dmp"], "-f", ktx, "-i", fq]
        out = str(work / "out_slots_one.tsv")
        assert tkaiju.main(argv + ["-o", out], device="cpu") == 0
        with open(out) as fh:
            env["slot_tsv"] = argv, fh.read()
    argv, one = env["slot_tsv"]
    assert one.count("\nC\t") > 20
    for S in (1, 2, 4):
        out = str(work / f"out_slots_{D}_{S}.tsv")
        assert tkaiju.main(argv + ["--mesh-index", str(S), "-o", out],
                           device=["cpu"] * D) == 0
        with open(out) as fh:
            got = fh.read()
        assert got == one, (D, S, _diff(got, one))
