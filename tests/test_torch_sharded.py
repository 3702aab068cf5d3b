"""The port's index-sharded path on the CPU (kaiju_tpu_torch.parallel, K16):
the shard layout and the owner-computes rank against kaiju_tpu's
ShardedIndexArrays and _sharded_fmindex (for S that does not divide the
block count, so the last shard is padded), sharded_extend_all and
sharded_sa_lookup against make_sharded_extend_all / make_sharded_sa_lookup
on the 8-device virtual CPU mesh (after tests/test_sharded.py),
ShardedMemPipeline's rows against ShardedMemClassifier.classify on an index
without and with a text copy (the hybrid's virtual rows), kernel N's plain
version (the rounds' server across hosts: RANK and ROW against
_sharded_fmindex, LF and SAMPLE walks against get_suffix), and the TSV of
`kaiju -a mem --mesh-index S` through main(..., device="cpu") against the
port's unsharded TSV and the host ExactClassifier.

The JAX programs run in one fresh subprocess, started with the module's
fixture, so that their XLA:CPU compiles overlap the port's runs."""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.engine.core import ExactClassifier, format_output_line
from kaiju_tpu.index import py_builder as jax_py_builder
from kaiju_tpu.io.taxonomy import Taxonomy
from kaiju_tpu.parallel.sharded_index import ShardedIndexArrays
from kaiju_tpu_torch.engine.config import KaijuConfig as TorchConfig
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.index.alphabet import encode_protein
from kaiju_tpu_torch.io.taxonomy import Taxonomy as TorchTaxonomy
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.parallel.sharded_fused import ShardedMemPipeline
from kaiju_tpu_torch.parallel.sharded_index import (ShardedIndex,
                                                    sharded_extend_all,
                                                    sharded_extend_all_plain,
                                                    sharded_sa_lookup,
                                                    sharded_sa_lookup_plain)
from kaiju_tpu_torch.tools import kaiju as tkaiju

from conftest import make_db_records, write_nodes_dmp
from readgen import make_reads, reverse_translate, write_fastq
from test_exact_parity import _diff, _lowcomp_reads
from test_torch_hybrid_hosts import text_view

RANK_SHARDS = (2, 3, 4)  # 2 and 4 leave a padded last shard (nb = 27)
EXTEND_SHARDS = (2, 4)
N_DATA = 4  # data-axis shards of the JAX classify (mesh 4 x 2)

WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.engine.fragments_native import NativeFragmenter
from kaiju_tpu.index import py_builder
from kaiju_tpu.index.alphabet import trans_table
from kaiju_tpu.io.taxonomy import Taxonomy, parse_nodes_dmp
from kaiju_tpu.parallel import sharded_index as shx
from kaiju_tpu.parallel.sharded_fused import ShardedMemClassifier

job = json.load(open(sys.argv[1]))
assert len(jax.devices()) == 8
index = py_builder.build_index(job["records"])
out = {"fmindex": {}, "extend_all": {}}
c = np.asarray(job["rank_c"], np.int32)
k = np.asarray(job["rank_k"], np.int32)
for S in job["rank_shards"]:
    sh = shx.ShardedIndexArrays(index, S)
    devices = jax.devices()[:len(jax.devices()) // S * S]
    mesh = shx.make_mesh(n_index_shards=S, devices=devices)

    def body(blocks_s, occ_s, base, C, c, k, nb_s=sh.nb_s):
        return shx._sharded_fmindex(blocks_s[0], occ_s[0], base, C, nb_s,
                                    c, k)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(
        P("index"), P("index"), None, None, None, None), out_specs=P(),
        check_vma=False))
    out["fmindex"][S] = np.asarray(fn(sh.blocks_sh, sh.occ_local,
                                      sh.shard_base, sh.C, c, k)).tolist()
codes = np.asarray(job["codes"], np.uint8)
flen = np.asarray(job["flen"], np.int32)
for S in job["extend_shards"]:
    sh = shx.ShardedIndexArrays(index, S)
    fn = shx.make_sharded_extend_all(shx.make_mesh(n_index_shards=S), sh)
    out["extend_all"][S] = [np.asarray(a).tolist() for a in fn(
        sh.blocks_sh, sh.occ_local, sh.shard_base, sh.C, codes, flen)]
sh = shx.ShardedIndexArrays(index, 4)
fn = shx.make_sharded_sa_lookup(shx.make_mesh(n_index_shards=4), sh)
ks = np.asarray(job["sa_k"], np.int32)
out["sa_lookup"] = [np.asarray(a).tolist() for a in fn(
    sh.blocks_sh, sh.occ_local, sh.shard_base, sh.C, sh.sa_seq_sh,
    sh.sa_off_sh, ks)]

tax = Taxonomy(parse_nodes_dmp(job["nodes_dmp"]))
cfg = KaijuConfig(mode="mem", seg=True, use_Evalue=False)
reads = [tuple(r) for r in job["reads"]]
per = len(reads) // job["n_data"]
frag = NativeFragmenter("mem", cfg.min_fragment_length, cfg.min_score,
                        cfg.seg, False)
trans = trans_table(index.alphabet)
out["classify"] = {}
for tag in ("fmi", "text"):
    idx = py_builder.build_index(job["records"])
    if tag == "fmi":
        idx.text = None
    cls = ShardedMemClassifier(idx, tax, cfg, shx.make_mesh(n_index_shards=2),
                               n_index=2)
    shards, flat_cap, F_cap = [], 8192, 512
    for d in range(job["n_data"]):
        frags, orders = frag.run(reads[d * per:(d + 1) * per])
        assert len(frags) <= F_cap
        flat = np.zeros(flat_cap, np.uint8)
        off = np.zeros(F_cap + 1, np.int32)
        pos = 0
        for fi, f in enumerate(frags):
            e = trans[np.frombuffer(f.encode(), np.uint8)]
            off[fi] = pos
            flat[pos:pos + len(e)] = e
            pos += len(e)
        off[len(frags):] = pos
        rf = np.full((per, cls.S), -1, np.int32)
        for r, o in enumerate(orders):
            rf[r, :len(o)] = o[:cls.S]
        shards.append((flat, off, rf))
    out["classify"][tag] = np.asarray(cls.classify(shards)).tolist()
json.dump(out, open(sys.argv[2], "w"))
"""


def _fragments(rng, records, alphabet, n, L):
    """n random substrings of the DB proteins as a 0-padded code matrix."""
    codes = np.zeros((n, L), dtype=np.uint8)
    flen = np.zeros(n, dtype=np.int32)
    for fi in range(n):
        _, prot = records[rng.randrange(len(records))]
        ln = rng.randint(6, min(L - 2, len(prot)))
        st = rng.randrange(0, len(prot) - ln + 1)
        e = encode_protein(prot[st:st + ln], alphabet)
        codes[fi, :len(e)] = e
        flen[fi] = len(e)
    return codes, flen


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = random.Random(31)
    records = make_db_records(rng, nseq=40)
    work = tmp_path_factory.mktemp("torch_sharded")
    nodes_dmp = str(work / "nodes.dmp")
    nodes = write_nodes_dmp(nodes_dmp)
    tidx = py_builder.build_index(records)
    length = tidx.length
    rank_k = np.tile(np.arange(length + 1), 21)
    rank_c = np.repeat(np.arange(21), length + 1)
    codes, flen = _fragments(rng, records, tidx.alphabet, 16, 32)
    sa_k = [rng.randrange(tidx.nseq, length) for _ in range(64)]
    reads = [(n, s, None) for n, s in make_reads(rng, records, n=64)]
    job = {"records": records, "nodes_dmp": nodes_dmp, "reads": reads,
           "rank_shards": RANK_SHARDS, "rank_c": rank_c.tolist(),
           "rank_k": rank_k.tolist(), "extend_shards": EXTEND_SHARDS,
           "codes": codes.tolist(), "flen": flen.tolist(), "sa_k": sa_k,
           "n_data": N_DATA}
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

    notext = py_builder.build_index(records)
    notext.text = None
    env_ = {
        "records": records, "nodes": nodes, "nodes_dmp": nodes_dmp,
        "work": work, "jax": jax_out, "rank_c": rank_c, "rank_k": rank_k,
        "codes": codes, "flen": flen, "sa_k": sa_k, "reads": reads,
        "index": {"fmi": notext, "text": tidx},
        "jidx": jax_py_builder.build_index(records),
    }
    yield env_
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("S", RANK_SHARDS)
def test_shard_layout_matches_sharded_index_arrays(env, S):
    """Shard o of rec holds blocks [o nb_s, (o + 1) nb_s) and an end row:
    its bytes are ShardedIndexArrays' blocks_sh[o] and its occ words
    occ_local[o] + shard_base[o] (so the owner's row needs no shard_base
    addition); the last shard is padded the same way (bytes 31, the last
    occ row); SA samples and text rows split as kaiju_tpu splits them."""
    jsh = ShardedIndexArrays(env["jidx"], S)
    sh = ShardedIndex(env["index"]["text"], S, "cpu")
    assert (sh.nb_s, sh.ns_s, sh.ntb_s) == (jsh.nb_s, jsh.ns_s, jsh.ntb_s)
    nb = env["jidx"].bwt.shape[0] // 128
    assert (S * sh.nb_s > nb) == (S != 3)
    for o in range(S):
        rows = sh.rec.parts[o].numpy()
        assert rows.shape == (sh.nb_s + 1, 64)
        blocks = rows[:sh.nb_s, 32:].view(np.uint8).reshape(sh.nb_s, 128)
        np.testing.assert_array_equal(blocks, jsh.blocks_sh[o])
        np.testing.assert_array_equal(rows[:, :32],
                                      jsh.occ_local[o] + jsh.shard_base[o])
        np.testing.assert_array_equal(sh.sa_seq.parts[o].numpy(),
                                      jsh.sa_seq_sh[o])
        np.testing.assert_array_equal(sh.sa_off.parts[o].numpy(),
                                      jsh.sa_off_sh[o])
        np.testing.assert_array_equal(
            sh.text.parts[o].numpy(),
            jsh.textp_sh[o][:, :128].reshape(-1).view(np.uint8))
    pad = S * sh.nb_s - nb
    if pad:
        assert (jsh.blocks_sh[-1][sh.nb_s - pad:] == 31).all()


@pytest.mark.parametrize("S", RANK_SHARDS)
def test_sharded_rank_matches_sharded_fmindex(env, S):
    """FMindex(c, k) from the owner's row, for every letter and every k in
    [0, length], equals kaiju_tpu's owner-computes + psum rank and the
    unsharded rank."""
    idx = env["index"]["text"]
    sh = ShardedIndex(idx, S, "cpu")
    c = torch.from_numpy(env["rank_c"].astype(np.int32))
    k = torch.from_numpy(env["rank_k"].astype(np.int32))
    got = tdev.rank(sh.rec, sh.C, c, k).numpy()
    want = env["jax"]()["fmindex"][str(S)]
    np.testing.assert_array_equal(got, np.asarray(want))
    dv = tdev.DeviceIndex(idx, "cpu")
    np.testing.assert_array_equal(got, tdev.rank(dv.rec, dv.C, c, k).numpy())


@pytest.mark.parametrize("S", EXTEND_SHARDS)
def test_sharded_extend_all_matches_jax(env, S):
    sh = ShardedIndex(env["index"]["text"], S, "cpu")
    codes = torch.from_numpy(env["codes"])
    flen = torch.from_numpy(env["flen"])
    got = sharded_extend_all(sh, codes, flen)
    want = env["jax"]()["extend_all"][str(S)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, p in zip(got, sharded_extend_all_plain(sh, codes, flen)):
        assert torch.equal(g, p)
    assert (got[2] - got[1] > 1).any()  # ties exercised


def test_sharded_sa_lookup_matches_jax_and_get_suffix(env):
    sh = ShardedIndex(env["index"]["text"], 4, "cpu")
    k = torch.tensor(env["sa_k"], dtype=torch.int32)
    iseq, pos = sharded_sa_lookup(sh, k)
    for g, p in zip((iseq, pos), sharded_sa_lookup_plain(sh, k)):
        assert torch.equal(g, p)
    want = env["jax"]()["sa_lookup"]
    np.testing.assert_array_equal(iseq.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want[1]))
    for n, kk in enumerate(env["sa_k"]):
        assert (int(iseq[n]), int(pos[n])) == env["jidx"].get_suffix(kk)


@pytest.mark.parametrize("S", RANK_SHARDS)
def test_fm_serve_rank_and_row_match_sharded_fmindex(env, S):
    """Kernel N's plain version answers RANK (c, k) and ROW k (the 20
    letters at once) from the owner shard as kaiju_tpu's owner-computes +
    psum rank does, for every letter and every k in [0, N]: k = N, the
    terminators' rows, a shard's first row and the padded last shard's
    end row among them."""
    idx = env["index"]["text"]
    sh = ShardedIndex(idx, S, "cpu")
    c = torch.from_numpy(env["rank_c"].astype(np.int32))
    k = torch.from_numpy(env["rank_k"].astype(np.int32))
    want = np.asarray(env["jax"]()["fmindex"][str(S)])
    q = torch.stack([(tdev.Q_RANK << 8) | c, k], 1)
    got, bad = tdev.fm_serve(sh.rec, sh.C, sh.sa_seq, sh.sa_off, q, 1)
    np.testing.assert_array_equal(got[:, 0].numpy(), want)
    ks = torch.arange(idx.length + 1, dtype=torch.int32)
    q = torch.stack([torch.full_like(ks, tdev.Q_ROW << 8), ks], 1)
    rows, bad = tdev.fm_serve(sh.rec, sh.C, sh.sa_seq, sh.sa_off, q, 20)
    by_c = want.reshape(21, idx.length + 1)  # rank_c repeats c over k
    np.testing.assert_array_equal(rows.numpy().T, by_c[1:])
    assert int(bad) == 0
    if S != 3:  # the padded last shard's end row serves k = N
        assert sh.rec.owner(torch.tensor([idx.length >> 7])) == S - 1


@pytest.mark.parametrize("S", [2, 4])
def test_fm_serve_lf_and_sample_walk_to_get_suffix(env, S):
    """Walks driven by kernel N's plain version alone, an LF query a step
    and a SAMPLE query (seq, off) at a sampled row, reach get_suffix's
    (sequence, offset), walks that end at a terminator included."""
    idx = env["index"]["text"]
    sh = ShardedIndex(idx, S, "cpu")
    ks = list(env["sa_k"])
    check = (1 << sh.chpt_exp) - 1
    k = torch.tensor(ks, dtype=torch.int32)
    steps = torch.zeros_like(k)
    out = {}
    todo = list(range(len(ks)))
    while todo:
        kk = k[todo]
        at = (kk & check) == 0
        slot = torch.clamp((kk >> sh.chpt_exp) - ((sh.nseq - 1)
                                                  >> sh.chpt_exp) - 1,
                           0, sh.sa_seq.shape[0] - 1)
        op = torch.where(at, tdev.Q_SAMPLE << 8, tdev.Q_LF << 8)
        q = torch.stack([op, torch.where(at, slot, kk)], 1).to(torch.int32)
        ans, _bad = tdev.fm_serve(sh.rec, sh.C, sh.sa_seq, sh.sa_off, q, 2)
        nxt = []
        for t, w in enumerate(todo):
            a0, a1 = int(ans[t, 0]), int(ans[t, 1])
            if bool(at[t]):
                out[w] = (a0, a1 + int(steps[w]))
            elif a0 < 0:  # a terminator: ~(the content rank)
                out[w] = (~a0, int(steps[w]))
            else:
                k[w], steps[w] = a0, steps[w] + 1
                nxt.append(w)
        todo = nxt
    ends = 0
    for w, kk in enumerate(ks):
        assert out[w] == env["jidx"].get_suffix(kk), kk
        ends += int(out[w][1] == int(steps[w]) and (int(k[w]) & check) != 0)
    assert ends > 0  # walks that end at a terminator


def _cache(env, tag):
    """The seed tables' (and the text index's bitmaps') cache of an index,
    shared by the tests of this file."""
    path = env["work"] / f"cache_{tag}"
    path.mkdir(exist_ok=True)
    return str(path)


@pytest.mark.parametrize("tag", ["fmi", "text"])
def test_sharded_pipeline_rows_match_sharded_classifier(env, tag):
    """ShardedMemPipeline's device rows (lca, score, flags, n_ids) equal
    ShardedMemClassifier.classify's, read by read (mesh 4 x 2), as
    tests/test_sharded.py holds the JAX rows to MemFastPipeline; on the text
    index B screens and G finishes narrow lanes as virtual rows."""
    cfg = TorchConfig(mode="mem", seg=True, use_Evalue=False)
    pipe = ShardedMemPipeline(env["index"][tag], TorchTaxonomy(env["nodes"]),
                              cfg, 2, device="cpu",
                              kmer_cache_dir=_cache(env, tag))
    assert (pipe._hyb is not None) == (tag == "text")
    reads = env["reads"]
    _reads, oflow, rows = pipe.submit_batch(reads)
    rows = rows.numpy()
    want = np.asarray(env["jax"]()["classify"][tag])
    per = len(reads) // N_DATA
    assert not oflow.any()
    for g in range(len(reads)):
        d, r = divmod(g, per)
        assert rows[g].tolist() == want[d, r].tolist(), reads[g][0]
    assert (rows[:, 1] > 0).sum() > 30


def test_hosts_pipeline_rows_with_hybrid_match_sharded_classifier(env):
    """Over a group on several hosts (shard 1 of 2 remote, its rows,
    samples and text rows served in rounds by the in-process server of
    tests/test_torch_hybrid_hosts.py), ShardedMemPipeline runs the hybrid
    on the text index (O's stop, Y in stages "switch" and "text", C, W, Q,
    W), and its device rows equal ShardedMemClassifier.classify's with the
    hybrid, read by read."""
    cfg = TorchConfig(mode="mem", seg=True, use_Evalue=False)
    idx = env["index"]["text"]
    view = text_view(ShardedIndex(idx, 2, "cpu"), (1,))
    pipe = ShardedMemPipeline(idx, TorchTaxonomy(env["nodes"]), cfg, 2,
                              kmer_cache_dir=_cache(env, "text"), view=view)
    assert pipe._hyb is not None and pipe.dev.exchange is view.exchange
    reads = env["reads"]
    _reads, oflow, rows = pipe.submit_batch(reads)
    rows = rows.numpy()
    want = np.asarray(env["jax"]()["classify"]["text"])
    per = len(reads) // N_DATA
    assert not oflow.any()
    for g in range(len(reads)):
        d, r = divmod(g, per)
        assert rows[g].tolist() == want[d, r].tolist(), reads[g][0]
    assert view.exchange.stages.get("switch", 0) > 0
    assert view.exchange.stages.get("text", 0) > 0


@pytest.mark.parametrize("tag, shards", [("fmi", (1, 2)), ("text", (2, 4))],
                         ids=["fmi", "text"])
def test_cli_mesh_index_tsv(env, monkeypatch, tag, shards):
    """kaiju -a mem --mesh-index S (S = 1, 2, 4) through main(...,
    device="cpu") writes the port's unsharded TSV byte for byte, and it is
    the ExactClassifier's; reads with more ties than T replay on the host.
    On the text index Greedy (the default) with --mesh-index 4 writes its
    unsharded TSV (tests/test_torch_sharded_greedy.py holds it to
    ExactClassifier's)."""
    monkeypatch.setenv("KAIJU_TPU_CACHE", _cache(env, tag))
    work = env["work"]
    ktx = str(work / f"db_{tag}.ktx")
    if not os.path.exists(ktx):
        env["index"][tag].save(ktx)
    rng = random.Random(33)
    records = env["records"]
    reads = make_reads(rng, records, n=100) + _lowcomp_reads(rng, records, 20)
    for t in range(6):  # periodic motifs: more ties than T, host replay
        _, prot = records[rng.randrange(len(records))]
        st = rng.randrange(0, len(prot) - 14)
        reads.append((f"rep{t}", reverse_translate(
            rng, ("W" + prot[st:st + 14]) * 9)))
    fq = str(work / f"reads_{tag}.fastq")
    write_fastq(reads, fq)
    argv = ["-t", env["nodes_dmp"], "-f", ktx, "-i", fq, "-a", "mem"]
    tsv = {}
    for S in (0, *shards):
        out = str(work / f"out_{tag}_{S}.tsv")
        mesh = ["--mesh-index", str(S)] if S else []
        assert tkaiju.main(argv + mesh + ["-o", out], device="cpu") == 0
        with open(out) as fh:
            tsv[S] = fh.read()
    exact_cls = ExactClassifier(env["jidx"], Taxonomy(env["nodes"]),
                                KaijuConfig(mode="mem", seg=True,
                                            use_Evalue=False))
    exact = "".join(format_output_line(n, r, False) for n, r in
                    exact_cls.classify_batch([(n, s, None) for n, s in reads]))
    for S in shards:
        assert tsv[S] == tsv[0], _diff(tsv[S], tsv[0])
    assert tsv[0] == exact, _diff(tsv[0], exact)
    assert tsv[0].count("\nC\t") > 50
    if tag == "text":  # Greedy, the default mode, runs on shards too
        greedy = {}
        for S in (0, 4):
            out = str(work / f"out_{tag}_greedy_{S}.tsv")
            mesh = ["--mesh-index", str(S)] if S else []
            assert tkaiju.main(["-t", env["nodes_dmp"], "-f", ktx, "-i", fq,
                                *mesh, "-o", out], device="cpu") == 0
            with open(out) as fh:
                greedy[S] = fh.read()
        assert greedy[4] == greedy[0], _diff(greedy[4], greedy[0])


SLOTS = 4  # CPU slots standing in for the cards of one process


@pytest.mark.parametrize("D, S", [(1, 3), (2, 1), (2, 4), (3, 4), (4, 2),
                                  (4, 4)])
def test_layout_over_cards_follows_the_rule(env, D, S):
    """ShardedIndex.on_cards over D CPU slots: slot c holds shard c mod S
    (D >= S) or the shards o with o mod D = c (D < S), each allocated once
    on each slot that holds it, and reads every other shard o in place
    from slot o mod D; layout() reports both with their bytes; D = 1 is
    the one-card layout."""
    views = ShardedIndex.on_cards(env["index"]["text"], S, ["cpu"] * D)
    one = ShardedIndex(env["index"]["text"], S, "cpu")
    arrays = ("rec", "sa_seq", "sa_off", "text")
    for c, v in enumerate(views):
        lay = v.layout()
        want = [c % S] if D >= S else [o for o in range(S) if o % D == c]
        assert lay["held"] == want and v.slot == c
        assert lay["reads"] == {o: o % D for o in range(S) if o not in want}
        assert lay["opened"] == {}
        for a in arrays:
            sh = getattr(v, a)
            assert sh.peer == frozenset(lay["reads"])
            assert lay["bytes_held"][a] == sum(sh.parts[o].nbytes
                                               for o in want)
            assert lay["bytes_read"][a] == sum(sh.parts[o].nbytes
                                               for o in lay["reads"])
            for o in range(S):
                holder = views[o % D if o in lay["reads"] else c]
                assert sh.parts[o] is getattr(holder, a).parts[o]
                assert torch.equal(sh.parts[o], getattr(one, a).parts[o])
    if D == 1:
        assert views[0].layout()["held"] == one.layout()["held"]
    allocated = {id(getattr(v, a).parts[o]) for v in views for a in arrays
                 for o in v.held}
    assert len(allocated) == len(arrays) * sum(len(v.held) for v in views)


@pytest.mark.parametrize("tag", ["fmi", "text"])
def test_pipeline_rows_over_cpu_slots_match_data_rows(env, tag):
    """kaiju --mesh-index 2 over 4 CPU slots: each slot's ShardedMemPipeline
    (engine.pipeline.CardShare, one worker thread a slot, the shards
    placed by ShardedIndex.on_cards) classifies local_rows(64, 4, c), and
    its rows equal ShardedMemClassifier's data row c on its 4 x 2 mesh."""
    from kaiju_tpu_torch.engine.pipeline import CardShare

    cfg = TorchConfig(mode="mem", seg=True, use_Evalue=False)
    tax = TorchTaxonomy(env["nodes"])
    views = ShardedIndex.on_cards(env["index"][tag], 2, ["cpu"] * N_DATA)
    share = CardShare(lambda c: ShardedMemPipeline(
        env["index"][tag], tax, cfg, 2, kmer_cache_dir=_cache(env, tag),
        view=views[c]), ["cpu"] * N_DATA)
    try:
        jobs = share.submit_batch(env["reads"])
        want = np.asarray(env["jax"]()["classify"][tag])
        assert [c for c, _f in jobs] == list(range(N_DATA))
        for c, job in jobs:
            _reads, oflow, rows = job.result()
            assert not oflow.any()
            assert rows.numpy().tolist() == want[c].tolist(), c
    finally:
        share.close()


def _slot_fastq(env):
    """The reads of the slot runs (seeded; repeats that replay on the
    host) and the text index, written once for the module."""
    if "slot_fq" not in env:
        work = env["work"]
        ktx = str(work / "db_slots.ktx")
        env["index"]["text"].save(ktx)
        rng = random.Random(35)
        records = env["records"]
        reads = make_reads(rng, records, n=90)
        for t in range(4):
            _, prot = records[rng.randrange(len(records))]
            st = rng.randrange(0, len(prot) - 14)
            reads.append((f"rep{t}", reverse_translate(
                rng, ("W" + prot[st:st + 14]) * 9)))
        fq = str(work / "reads_slots.fastq")
        write_fastq(reads, fq)
        argv = ["-t", env["nodes_dmp"], "-f", ktx, "-i", fq, "-a", "mem"]
        out = str(work / "out_slots_one.tsv")
        assert tkaiju.main(argv + ["-o", out], device="cpu") == 0
        with open(out) as fh:
            env["slot_fq"] = argv, fh.read()
    return env["slot_fq"]


@pytest.mark.parametrize("D", [2, SLOTS])
def test_cli_mesh_index_over_cpu_slots(env, monkeypatch, D):
    """kaiju -a mem --mesh-index S through main(..., device=["cpu"] * D),
    S = 1, 2, 4, on the text index, writes the one-card TSV byte for
    byte."""
    monkeypatch.setenv("KAIJU_TPU_CACHE", _cache(env, "text"))
    argv, one = _slot_fastq(env)
    assert one.count("\nC\t") > 40
    for S in (1, 2, 4):
        out = str(env["work"] / f"out_slots_{D}_{S}.tsv")
        assert tkaiju.main(argv + ["--mesh-index", str(S), "-o", out],
                           device=["cpu"] * D) == 0
        with open(out) as fh:
            got = fh.read()
        assert got == one, (D, S, _diff(got, one))
