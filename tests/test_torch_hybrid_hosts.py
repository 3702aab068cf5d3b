"""The text-compare hybrid over the shards of a group of processes on
several hosts, without processes: the plain versions of kernel Y
(ops/hybrid.py switch_hosts, the switch in rounds of stages "switch" and
"text"), of O with B's hybrid stop (sw_steps), of X's last-level stop
and U's virtual tie rows, and of W's and V's list forms with the virtual
rows' ids, driven in rounds by an in-process server that answers with
N's plain version (fm_serve, TEXT rows included) on the whole index, with
the shards of tests/test_torch_hosts.py remote: against the one-host
switch_plain, mem_extend_plain with sw_steps, fused_mem_classify and
greedy_search_plain with the hybrid, bit for bit.  Also N's TEXT answer
against the text bytes, a compare that crosses a text row's start onto a
remote shard, and the pipelines' rule for the hybrid across hosts.  No
JAX program runs here (kaiju_tpu's sharded rows with the hybrid are
compared in tests/test_torch_sharded.py and
tests/test_torch_sharded_greedy.py).  Integer outputs, tolerance 0."""

import copy
import random

import numpy as np
import pytest
import torch

from kaiju_tpu_torch.engine import pipeline as tpipeline
from kaiju_tpu_torch.engine.config import KaijuConfig
from kaiju_tpu_torch.engine.pipeline import _bucket
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.io.taxonomy import Taxonomy
from kaiju_tpu_torch.ops import classify, greedy, hybrid, search
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.parallel.sharded_fused import (ShardedGreedyPipeline,
                                                    ShardedMemPipeline)
from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

from conftest import make_db_records, write_nodes_dmp
from readgen import make_reads, reverse_translate
from test_torch_hosts import LocalExchange, hosts_view

S = 4
REMOTE = {"one": (2,), "two": (1, 3)}
BLOCK = 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small tensor ops, for which torch's
    intra-op threads add CPU time and no speed; one thread for this file
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TextExchange(LocalExchange):
    """LocalExchange whose server answers TEXT rows too, counts its rounds
    by stage and checks that each query of Y's stages is for a remote
    shard (a parked rank pair may have one end here)."""

    def __init__(self, view, whole):
        super().__init__(view, whole)
        self.stages: dict = {}

    def all_agree(self, flag):
        return bool(flag)

    def serve(self, queries, width, stage):
        self.stages[stage] = self.stages.get(stage, 0) + 1
        self.served += queries.shape[0]
        v, w = self.sh, self.whole
        if stage in ("switch", "text"):
            dest = tdev.query_shard(v.rec, v.sa_seq, queries, v.text)
            assert not bool(v.rec.here[dest].any())
        ans, bad = tdev.fm_serve(w.rec, w.C, w.sa_seq, w.sa_off, queries,
                                 width, w.text)
        assert int(bad) == 0
        return ans


def text_view(sh, remote):
    view = hosts_view(sh, remote)
    view.exchange = TextExchange(view, sh)
    return view


def _reads(rng, records, n):
    """make_reads' reads and long exact copies, every other one with a
    point mutation: matches that outlive B's burn-in, and variants for the
    Greedy levels."""
    reads = [(name, s, None) for name, s in make_reads(rng, records, n=n)]
    for t in range(40):
        _, prot = records[rng.randrange(len(records))]
        plen = min(len(prot), rng.randint(hybrid.S1_STEPS + 10, 150))
        st = rng.randrange(0, len(prot) - plen + 1)
        dna = reverse_translate(rng, prot[st:st + plen])
        if t % 2:
            x = rng.randrange(len(dna))
            dna = dna[:x] + "ACGT"[("ACGT".index(dna[x]) + 1) % 4] + \
                dna[x + 1:]
        reads.append((f"long{t}", dna, None))
    return reads


def _batch(pipe, reads):
    flat, chars, frag_off, n_frags, _k, rf_rows, _o = pipe._fragmenter.run(
        reads, pipe.S_SLOTS, _bucket)
    return (torch.from_numpy(flat[:chars].copy()),
            torch.from_numpy(frag_off[:n_frags + 1].copy()),
            torch.from_numpy(rf_rows.copy()))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = random.Random(222)
    records = make_db_records(rng, nseq=40)
    work = tmp_path_factory.mktemp("torch_hybrid_hosts")
    tax = Taxonomy(write_nodes_dmp(str(work / "nodes.dmp")))
    index = py_builder.build_index(records)
    assert index.text is not None
    reads = _reads(rng, records, 120)
    mcfg = KaijuConfig(mode="mem", seg=True, use_Evalue=False)
    gcfg = KaijuConfig(mode="greedy", seg=True, use_Evalue=False,
                       mismatches=3)
    sh = ShardedIndex(index, S, "cpu")
    mem = ShardedMemPipeline(index, tax, mcfg, S, device="cpu",
                             kmer_cache_dir=str(work))
    grd = ShardedGreedyPipeline(index, tax, gcfg, S, device="cpu",
                                kmer_cache_dir=str(work))
    return {"index": index, "tax": tax, "work": work, "sh": sh,
            "td": tdev.DeviceIndex(index, "cpu"), "mem": mem, "greedy": grd,
            "mem_batch": _batch(mem, reads),
            "greedy_batch": _batch(grd, reads), "mcfg": mcfg, "gcfg": gcfg}


def _switch_both(env, view, s0, s1, qg, avail, flat):
    """Y in rounds on the view, and switch_plain on the one-host index."""
    td = env["td"]
    got = hybrid.switch_in_rounds(view, view.exchange, s0, s1, qg, avail,
                                  flat, view.rank_start)
    want = hybrid.switch_plain(s0, s1, qg, avail, flat, td.text,
                               td.rank_start, td.rec, td.C, td.sa_seq,
                               td.sa_off, td.nseq, td.chpt_exp)
    return got, want


def _mem_switched(env):
    """The MEM batch's switched lanes (B with the hybrid's stop, screened):
    (s0, s1, qg, avail) of each."""
    sh, pipe = env["sh"], env["mem"]
    flat, frag_off, _rf = env["mem_batch"]
    K, j0 = pipe.seed_K, pipe.cfg.min_fragment_length - 1
    i, s0, s1 = search.mem_extend_plain(
        sh.rec, sh.C, *pipe._seed, flat, frag_off, K, j0, bloom=pipe._bloom,
        sw_steps=hybrid.S1_STEPS)
    lanes = hybrid.switched(i, s0, s1, frag_off, K + hybrid.S1_STEPS)
    base = search._lane_fragments(frag_off, flat.shape[0])[2]
    return s0[lanes], s1[lanes], base[lanes] + i[lanes], i[lanes]


@pytest.mark.parametrize("which", list(REMOTE))
def test_y_in_rounds_equals_switch_plain(env, which):
    """Y's start, resume and finish forms in the rounds of stages "switch"
    and "text" give switch_plain's (maxext, n_ach, ids) on the MEM batch's
    switched lanes, with the shards of REMOTE[which] (their rows, samples
    and text rows) on another host."""
    view = text_view(env["sh"], REMOTE[which])
    flat = env["mem_batch"][0]
    lanes = _mem_switched(env)
    assert lanes[0].shape[0] > 20
    got, want = _switch_both(env, view, *lanes, flat)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert view.exchange.stages.get("switch", 0) > 0
    assert view.exchange.stages.get("text", 0) > 0


def test_y_compare_crosses_onto_a_remote_shard(env):
    """Occurrences whose text lies just past a shard's first text byte,
    with queries that copy the text before them: each compare crosses the
    row's start onto the shard before, which is remote, and Y's reach
    equals switch_plain's past the boundary."""
    index, sh, td = env["index"], env["sh"], env["td"]
    text = np.asarray(index.text)
    # every SA row's text position
    k = torch.arange(index.length, dtype=torch.int32)
    iseq, pos = tdev.sa_walk(td.rec, td.C, td.sa_seq, td.sa_off, td.nseq,
                             td.chpt_exp, k)
    p_of = (td.rank_start[iseq.long()] + pos).numpy()
    row_of = {int(p): r for r, p in enumerate(p_of)}
    per = sh.ntb_s * BLOCK  # text bytes a shard
    codes, lanes = [], []
    for o in (1, 2, 3):
        b = o * per
        for p in range(b + 1, b + 60):
            if p not in row_of or not (text[p - 70:p] > 0).all():
                continue
            q = np.array(text[p - 70:p], dtype=np.uint8)
            codes.append(q)
            lanes.append((row_of[p], 70 * len(codes)))
            if len(lanes) % 6 == 0:
                break
    assert len(lanes) >= 6
    flat = torch.from_numpy(np.concatenate(codes))
    r, qg = (torch.tensor(c, dtype=torch.int32) for c in zip(*lanes))
    s0, s1 = r, r + 1
    avail = torch.full_like(r, 70)
    view = text_view(sh, (0, 1, 2))  # the shard before each o remote
    got, want = _switch_both(env, view, s0, s1, qg, avail, flat)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    p = torch.from_numpy(p_of[r.numpy()])
    b = (p // per) * per
    assert bool((got[0] > p - b).all())  # past each shard's first byte
    assert view.exchange.stages.get("text", 0) > 0


@pytest.mark.parametrize("which", list(REMOTE))
def test_o_with_sw_steps_equals_b(env, which):
    """O with sw_steps = S1_STEPS in rounds ends every lane where B's plain
    version with the same stop and screen does (the step count rebuilt
    from a parked lane's position); some lanes stop for the switch."""
    sh, pipe = env["sh"], env["mem"]
    view = text_view(sh, REMOTE[which])
    flat, frag_off, _rf = env["mem_batch"]
    args = (*pipe._seed, flat, frag_off, pipe.seed_K,
            pipe.cfg.min_fragment_length - 1)
    kw = {"bloom": pipe._bloom, "sw_steps": hybrid.S1_STEPS}
    want = search.mem_extend_plain(sh.rec, sh.C, *args, **kw)
    out, parked, queries = search.mem_extend_hosts(view.rec, view.C, *args,
                                                   **kw)
    view.exchange.rounds("extend", parked, queries, 1, lambda pk, ans:
                         search.mem_extend_hosts(
                             view.rec, view.C, *args, out=out, parked=pk,
                             answers=ans.reshape(-1, 2), **kw)[1:])
    for g, w in zip(out, want):
        assert torch.equal(g, w)
    assert view.exchange.served > 0
    sw = hybrid.switched(*out, frag_off, pipe.seed_K + hybrid.S1_STEPS)
    assert int(sw.sum()) > 20


@pytest.mark.parametrize("which", list(REMOTE))
def test_mem_batch_with_hybrid_equals_fused_mem_classify(env, which):
    """ShardedMemPipeline on a hosts view runs fused_mem_classify_hosts
    with the hybrid (O, Y, C, W, Q, W): its rows equal the one-host
    fused_mem_classify's with the hybrid, and rounds ran in the stages
    "switch" and "text"."""
    pipe0 = env["mem"]
    view = text_view(env["sh"], REMOTE[which])
    pipe = ShardedMemPipeline(env["index"], env["tax"], env["mcfg"], S,
                              kmer_cache_dir=str(env["work"]), view=view)
    assert pipe._hyb is not None
    got = pipe._device_rows(*env["mem_batch"])
    td = env["td"]
    flat, frag_off, rf = env["mem_batch"]
    cfg = env["mcfg"]
    want = classify.fused_mem_classify(
        td.rec, td.C, pipe0._seed, flat, frag_off, rf, td.sa_seq, td.sa_off,
        td.seq_tax, pipe0._parent, pipe0._depth, pipe0.seed_K,
        cfg.min_fragment_length - 1, cfg.min_fragment_length, search.TIE_CAP,
        pipe0.R_BUDGET, cfg.max_match_ids, td.nseq, td.chpt_exp,
        bloom=pipe0._bloom, hyb=(td.text, td.rank_start))
    assert torch.equal(got, want)
    st = view.exchange.stages
    assert st.get("switch", 0) > 0 and st.get("text", 0) > 0
    assert (want[:, 1] > hybrid.S1_STEPS + pipe0.seed_K).sum() > 10


@pytest.mark.parametrize("e", [1, 3])
def test_greedy_search_hosts_with_hybrid_equals_e(env, e):
    """U, X (with its last-level stop) and Y in rounds give the one-host
    greedy_search_plain's (best, flags, g_s0, g_s1, sw_ids) with the
    hybrid, bit for bit; at -e 1 some ties are virtual rows."""
    sh, td, pipe = env["sh"], env["td"], env["greedy"]
    view = text_view(sh, REMOTE["two"])
    flat, frag_off, rf = env["greedy_batch"]
    lanes = search.mem_extend_plain(sh.rec, sh.C, *pipe._seed, flat,
                                    frag_off, pipe.seed_K, pipe.lmap - 1,
                                    bloom=pipe._bloom)
    cfg = env["gcfg"]
    tail = (pipe._tables, pipe.lmap, cfg.min_fragment_length, cfg.min_score,
            e, cfg.max_matches_SI)
    got = greedy.greedy_search_hosts(
        view, view.exchange, *lanes, flat, frag_off, rf, *tail,
        hyb=(view.text, view.rank_start))
    want = greedy.greedy_search_plain(
        *lanes, flat, frag_off, rf, td.rec, td.C, *tail,
        hyb=(td.text, td.rank_start, td.sa_seq, td.sa_off, td.nseq,
             td.chpt_exp))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    st = view.exchange.stages
    assert st.get("switch", 0) > 0
    assert bool((want[2] >= hybrid.VBASE).any()) or e == 3
    assert bool((want[0] > 0).any())


def test_greedy_batch_with_hybrid_equals_fused_greedy_classify(env):
    """ShardedGreedyPipeline on a hosts view runs
    fused_greedy_classify_hosts with the hybrid (O, U, X, Y, V, Q, W): its
    rows equal the one-host fused_greedy_classify's with the hybrid."""
    pipe0, td = env["greedy"], env["td"]
    view = text_view(env["sh"], REMOTE["one"])
    pipe = ShardedGreedyPipeline(env["index"], env["tax"], env["gcfg"], S,
                                 kmer_cache_dir=str(env["work"]), view=view)
    assert pipe._hyb is not None
    got = pipe._device_rows(*env["greedy_batch"])
    flat, frag_off, rf = env["greedy_batch"]
    cfg = env["gcfg"]
    want = greedy.fused_greedy_classify(
        td.rec, td.C, pipe0._seed, flat, frag_off, rf, td.sa_seq, td.sa_off,
        td.seq_tax, pipe0._parent, pipe0._depth, pipe0._tables,
        pipe0.seed_K, pipe0.lmap, cfg.min_fragment_length, cfg.min_score,
        cfg.mismatches, cfg.max_matches_SI, pipe0.R_BUDGET,
        cfg.max_match_ids, td.nseq, td.chpt_exp, pipe0.VCAP,
        bloom=pipe0._bloom, hyb=(td.text, td.rank_start))
    assert torch.equal(got, want)
    assert view.exchange.stages.get("switch", 0) > 0


def test_n_text_answer_is_the_text_bytes(env):
    """N's TEXT answer is the 128 text bytes of the row as 32 words,
    little endian; the last row of each shard too."""
    sh, index = env["sh"], env["index"]
    text = np.asarray(index.text)
    nrows = -(-text.shape[0] // BLOCK)
    rows = torch.tensor(sorted({0, 1, nrows - 1, *(o * sh.ntb_s - 1 for o
                                                   in range(1, S))}),
                        dtype=torch.int32)
    q = torch.stack([torch.full_like(rows, tdev.Q_TEXT << 8), rows], 1)
    ans, bad = tdev.fm_serve(sh.rec, sh.C, sh.sa_seq, sh.sa_off, q,
                             hybrid.TEXT_WORDS, sh.text)
    assert int(bad) == 0
    padded = np.zeros(S * sh.ntb_s * BLOCK, np.uint8)
    padded[:text.shape[0]] = text
    want = padded.reshape(-1, BLOCK)[rows.numpy()].view("<i4")
    np.testing.assert_array_equal(ans.numpy(), want)
    owner = tdev.query_shard(sh.rec, sh.sa_seq, q, sh.text)
    assert owner.tolist() == [min(int(r) // sh.ntb_s, S - 1) for r in rows]


def test_pipelines_turn_the_hybrid_on_as_kaiju_tpu(env, monkeypatch):
    """Over a hosts view both pipelines take the hybrid exactly when the
    index has a text copy and fewer than VBASE positions, and not on an
    index without text or past VBASE positions."""
    index, tax, work = env["index"], env["tax"], str(env["work"])
    for cls, cfg in ((ShardedMemPipeline, env["mcfg"]),
                     (ShardedGreedyPipeline, env["gcfg"])):
        on = cls(index, tax, cfg, S, kmer_cache_dir=work,
                 view=text_view(env["sh"], REMOTE["one"]))
        assert on._hyb is not None and on._hyb[0] is on.dev.text
        with monkeypatch.context() as m:
            m.setattr(tpipeline, "VBASE", index.length)
            big = cls(index, tax, cfg, S, kmer_cache_dir=work,
                      view=text_view(env["sh"], REMOTE["one"]))
        assert big._hyb is None
        bare = copy.copy(index)
        bare.text = None
        off = cls(bare, tax, cfg, S, kmer_cache_dir=work,
                  view=text_view(ShardedIndex(bare, S, "cpu"), REMOTE["one"]))
        assert off.dev.exchange is not None and off._hyb is None
