"""The port's rounds over shards on several hosts (kaiju_tpu_torch.
parallel.exchange, kernels N, O, Q and W), without processes: the plain
versions of O (mem_extend_hosts), Q (walk_hosts) and W (read_lca_list,
lca_resolved) driven in rounds by an in-process server that answers
with N's plain version (fm_serve) on the whole index, with every shard
remote and with half of them remote, against the one-host plain versions
(mem_extend_plain, sa_walk, read_lca_plain) exactly, flags included; the
MEM batch's rows of fused_mem_classify_hosts against fused_mem_classify;
and D's, F's and W's interval sums with sizes near 2^31.  N's RANK, ROW, LF
and SAMPLE against kaiju_tpu run in tests/test_torch_sharded.py, the
processes in tests/test_torch_multihost.py.  No JAX program runs here."""

import copy
import random

import numpy as np
import pytest
import torch

from kaiju_tpu_torch.engine.config import KaijuConfig
from kaiju_tpu_torch.engine.mem import MemPipeline
from kaiju_tpu_torch.engine.pipeline import _bucket
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.io.taxonomy import Taxonomy
from kaiju_tpu_torch.ops import classify, search
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.parallel import exchange
from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

from conftest import make_db_records, write_nodes_dmp
from readgen import make_reads

S = 4
REMOTE = {"all": (0, 1, 2, 3), "half": (1, 3)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small tensor ops, for which torch's
    intra-op threads add CPU time and no speed; one thread for this file
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class LocalExchange(exchange.Exchange):
    """The rounds of one process whose remote shards a server in this
    process answers with N's plain version on the whole index; the
    lockstep is this process's own parked count."""

    def __init__(self, view, whole):
        self.sh = view
        self.whole = whole
        self.served = 0

    def parked_anywhere(self, n, stage):
        return n > 0

    def serve(self, queries, width, stage):
        self.served += queries.shape[0]
        ans, bad = tdev.fm_serve(self.whole.rec, self.whole.C,
                                 self.whole.sa_seq, self.whole.sa_off,
                                 queries, width)
        assert int(bad) == 0
        return ans


def hosts_view(sh, remote):
    """A copy of ShardedIndex sh whose shards in `remote` lie on another
    host (parts None), with an exchange that serves them."""
    view = copy.copy(sh)
    for name in ("rec", "sa_seq", "sa_off", "text"):
        a = getattr(sh, name)
        if a is None:
            continue
        setattr(view, name, tdev.Shards(
            [None if o in remote else p for o, p in enumerate(a.parts)],
            a.per, a.shape[0], a.device, like=a.parts[0]))
    view.remote = {o: 0 for o in remote}
    view.exchange = LocalExchange(view, sh)
    return view


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = random.Random(191)
    records = make_db_records(rng, nseq=40)
    work = tmp_path_factory.mktemp("torch_hosts")
    nodes = write_nodes_dmp(str(work / "nodes.dmp"))
    index = py_builder.build_index(records)
    index.text = None
    reads = [(n, s, None) for n, s in make_reads(rng, records, n=96)]
    cfg = KaijuConfig(mode="mem", seg=True, use_Evalue=False)
    pipe = MemPipeline(index, Taxonomy(nodes), cfg, device="cpu",
                       kmer_cache_dir=str(work))
    flat, chars, frag_off, n_frags, _k, rf_rows, _o = pipe._fragmenter.run(
        reads, pipe.S_SLOTS, _bucket)
    batch = {"flat": torch.from_numpy(flat[:chars].copy()),
             "frag_off": torch.from_numpy(frag_off[:n_frags + 1].copy()),
             "rf_rows": torch.from_numpy(rf_rows.copy())}
    return {"index": index, "pipe": pipe, "batch": batch,
            "sh": ShardedIndex(index, S, "cpu")}


@pytest.mark.parametrize("which", list(REMOTE))
def test_o_in_rounds_equals_b(env, which):
    """O's plain version, its parked lanes answered in rounds, ends every
    lane where B's plain version does; the lanes park on the remote rows
    only."""
    pipe, sh, b = env["pipe"], env["sh"], env["batch"]
    view = hosts_view(sh, REMOTE[which])
    K, j0 = pipe.seed_K, pipe.cfg.min_fragment_length - 1
    want = search.mem_extend_plain(sh.rec, sh.C, *pipe._seed, b["flat"],
                                   b["frag_off"], K, j0)
    out, parked, queries = search.mem_extend_hosts(
        view.rec, view.C, *pipe._seed, b["flat"], b["frag_off"], K, j0)
    assert parked.shape[0] > 0 and queries.shape == (parked.shape[0], 2, 2)
    owners = view.rec.owner(queries[:, :, 1] >> 7)
    assert not bool(view.rec.here[owners].all(1).any())  # a remote row each
    ex = view.exchange
    ex.rounds("extend", parked, queries, 1, lambda pk, ans:
              search.mem_extend_hosts(view.rec, view.C, *pipe._seed,
                                      b["flat"], b["frag_off"], K, j0,
                                      out=out, parked=pk,
                                      answers=ans.reshape(-1, 2))[1:])
    for g, w in zip(out, want):
        assert torch.equal(g, w)
    assert ex.served > 0


@pytest.mark.parametrize("which", list(REMOTE))
def test_q_in_rounds_equals_sa_walk(env, which):
    """Q's plain version walks SA rows to the ids of the one-host sa_walk,
    its parked steps answered in rounds by LF and SAMPLE queries."""
    sh, index = env["sh"], env["index"]
    view = hosts_view(sh, REMOTE[which])
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(rng.integers(index.nseq, index.length,
                                         400).astype(np.int32))
    want, _pos = tdev.sa_walk(sh.rec, sh.C, sh.sa_seq, sh.sa_off, sh.nseq,
                              sh.chpt_exp, rows)
    seq = torch.empty_like(rows)
    parked, queries = tdev.walk_hosts(view.rec, view.C, view.sa_seq,
                                      view.nseq, view.chpt_exp, seq,
                                      rows=rows)
    kinds = set((queries[:, 0, 0] >> 8).tolist())
    assert kinds == {tdev.Q_LF, tdev.Q_SAMPLE}
    assert bool((seq[parked[:, 0].long()] == -1).all())
    view.exchange.rounds("walk", parked, queries, 1, lambda pk, ans:
                         tdev.walk_hosts(view.rec, view.C, view.sa_seq,
                                         view.nseq, view.chpt_exp, seq,
                                         parked=pk,
                                         answers=ans.reshape(-1)))
    assert torch.equal(seq, want)


@pytest.mark.parametrize("which", list(REMOTE))
def test_w_and_rounds_equal_d(env, which):
    """The hosts form of the MEM batch, O -> C -> W list -> Q -> W
    resolved in rounds, gives D's rows (lca, score, flags, n_ids) exactly,
    at the pipeline's R and at R = 4 (need_more set)."""
    pipe, sh, b = env["pipe"], env["sh"], env["batch"]
    view = hosts_view(sh, REMOTE[which])
    cfg = pipe.cfg
    K, j0 = pipe.seed_K, cfg.min_fragment_length - 1
    for R in (pipe.R_BUDGET, 4):
        tail = (sh.seq_tax, pipe._parent, pipe._depth, K, j0,
                cfg.min_fragment_length, search.TIE_CAP, R,
                cfg.max_match_ids)
        want = classify.fused_mem_classify(
            sh.rec, sh.C, pipe._seed, b["flat"], b["frag_off"], b["rf_rows"],
            sh.sa_seq, sh.sa_off, *tail, sh.nseq, sh.chpt_exp)
        got = classify.fused_mem_classify_hosts(
            view, view.exchange, pipe._seed, b["flat"], b["frag_off"],
            b["rf_rows"], *tail)
        assert torch.equal(got, want)
        assert (want[:, 1] > 0).sum() > 40
        if R == 4:
            assert bool((want[:, 2] & classify.FLAG_NEED_MORE).any())


def test_w_list_and_resolved_split_d(env):
    """W's list form gives D's first R positions (slot order, then tie
    order) and W's resolved form, on their sa_walk ids, D's rows
    (read_lca_rows)."""
    pipe, sh, b = env["pipe"], env["sh"], env["batch"]
    cfg = pipe.cfg
    i, s0, s1 = search.mem_extend_plain(
        sh.rec, sh.C, *pipe._seed, b["flat"], b["frag_off"], pipe.seed_K,
        cfg.min_fragment_length - 1)
    stats = search.mem_stats_plain(i, s0, s1, b["frag_off"],
                                   cfg.min_fragment_length, search.TIE_CAP)
    R = pipe.R_BUDGET
    pos, info = classify.read_lca_list(*stats[:2], *stats[3:], b["rf_rows"],
                                       R)
    listed = pos >= 0
    assert torch.equal(listed.sum(1, dtype=torch.int32), info[:, 0])
    seq = torch.full_like(pos, -1)
    seq[listed] = tdev.sa_walk(sh.rec, sh.C, sh.sa_seq, sh.sa_off, sh.nseq,
                               sh.chpt_exp, pos[listed])[0]
    got = classify.read_lca_rows(info, *classify.lca_resolved(
        info, seq, sh.seq_tax, pipe._parent, pipe._depth, R,
        cfg.max_match_ids)[:3])
    want = classify.read_lca_plain(
        *stats[:2], *stats[3:], b["rf_rows"], sh.rec, sh.C, sh.sa_seq,
        sh.sa_off, sh.seq_tax, pipe._parent, pipe._depth, R,
        cfg.max_match_ids, sh.nseq, sh.chpt_exp)
    assert torch.equal(got, want)


def test_one_host_paths_refuse_remote_shards(env):
    """A remote shard reaches the hosts forms only: the sharded kernels'
    check and the plain versions' reads refuse it."""
    view = hosts_view(env["sh"], (2,))
    with pytest.raises(ValueError, match="lies on another host"):
        tdev.shard_args(torch.device("cpu"), view.rec)
    tdev.shard_args(torch.device("cpu"), view.rec, hosts=True)
    k = torch.arange(env["index"].length, dtype=torch.int32)
    with pytest.raises(ValueError, match="lies on another host"):
        tdev.sa_walk(view.rec, view.C, view.sa_seq, view.sa_off, view.nseq,
                     view.chpt_exp, k)
    assert view.rec.table[2] == 0 and view.rec.table[1] != 0


def _near_2_31_ranges(rng, n_reads, G, length, R):
    """G ranges a read, each starting at a valid SA row and 2^30 to
    2^31 - 2^20 long, so that their int32 sum wraps."""
    s0 = rng.integers(0, length - R, (n_reads, G)).astype(np.int64)
    size = rng.integers(1 << 30, (1 << 31) - (1 << 20), (n_reads, G))
    s1 = np.minimum(s0 + size, (1 << 31) - 1)
    return (torch.from_numpy(s0.astype(np.int32)),
            torch.from_numpy(s1.astype(np.int32)))


@pytest.mark.parametrize("G", [4, 128])
def test_interval_sums_near_2_31(env, G):
    """D's, F's and W's list form count the positions of S x T ranges
    near 2^31 without wrapping: their int64 sum passes R, and R positions
    hold at most R <= cap taxa, so every read is flagged need_more."""
    sh, pipe = env["sh"], env["pipe"]
    rng = np.random.default_rng(G)
    R, cap = 8, 64
    g_s0, g_s1 = _near_2_31_ranges(rng, 6, G, env["index"].length, R)
    sizes64 = (g_s1.long() - g_s0.long()).clamp(min=0)
    assert bool((sizes64.sum(1) > (1 << 32)).all())  # an int32 sum wraps
    _lca, _n, need_more, _order = classify.ranges_lca_plain(
        g_s0, g_s1, sh.rec, sh.C, sh.sa_seq, sh.sa_off, sh.seq_tax,
        pipe._parent, pipe._depth, R, cap, sh.nseq, sh.chpt_exp)
    assert bool((need_more == 1).all())  # total > R, at most R taxa
    # D and W's list form: one fragment a read, its ties the G ranges
    T = G
    maxl = torch.full((6,), 20, dtype=torch.int32)
    tie_cnt = torch.full((6,), T, dtype=torch.int32)
    rf_rows = torch.arange(6, dtype=torch.int32)[:, None]
    rows = classify.read_lca_plain(
        maxl, tie_cnt, g_s0, g_s1, rf_rows, sh.rec, sh.C, sh.sa_seq,
        sh.sa_off, sh.seq_tax, pipe._parent, pipe._depth, R, cap, sh.nseq,
        sh.chpt_exp)
    assert bool(((rows[:, 2] & classify.FLAG_NEED_MORE) != 0).all())
    pos, info = classify.read_lca_list(maxl, tie_cnt, g_s0, g_s1, rf_rows, R)
    assert bool((info[:, 0] == R).all()) and bool((info[:, 1] > R).all())
    assert torch.equal(pos[:, :1], g_s0[:, :1])
    want = g_s0[:, :1] + torch.arange(R, dtype=torch.int32)
    assert torch.equal(pos, want)  # the first range holds them all
