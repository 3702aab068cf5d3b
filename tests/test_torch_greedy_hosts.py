"""Greedy over the shards of a group of processes on several hosts, without
processes (kaiju_tpu_torch.ops.greedy greedy_search_hosts and
fused_greedy_classify_hosts): the plain versions of kernels U
(greedy_levels: level 0, each level's fan-out and settle), X
(greedy_variants_hosts) and V (ranges_lca_list, finished by W's
lca_resolved), with O and Q, driven in rounds by the in-process server of
tests/test_torch_hosts.py (N's plain version on the whole index), with
every, half and no shard remote, at -e 0, 1, 3 and 5: E's plain version
with no hybrid (best, flags, g_s0, g_s1), FLAG_SCRATCH under a small vcap,
F's (tie_order and need_more included), B's at Greedy's j0 and screen,
the whole batch's rows of fused_greedy_classify, and kaiju_tpu's
fused_greedy_classify rows at -e 3 (one JAX program, in a module fixture).
The DB and reads are tests/test_torch_greedy.py's: two peptides in 26
species each, periodic reads past R positions and T ties.  Integer
outputs, tolerance 0.  The kernels are held against these plain versions
in tests/test_torch_kernels.py, the processes in
tests/test_torch_multihost.py."""

import pytest
import torch

from kaiju_tpu_torch.index import py_builder as torch_py_builder
from kaiju_tpu_torch.ops import bloom, classify, greedy, search
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

from test_torch_greedy import (CAP, K, LMAP, MFL, MIN_SCORE, R, T, _fragments,
                               _jax_rows, _same_as_jax, env)  # noqa: F401
from test_torch_hosts import hosts_view

S = 4
REMOTE = {"all": (0, 1, 2, 3), "half": (1, 3), "none": ()}
_t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small tensor ops, for which torch's
    intra-op threads add CPU time and no speed; one thread for this file
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hosts(env):  # noqa: F811
    """The port's side of env: the index in S shards, with and without its
    text copy, the batch of env's reads and tie reads, B's lanes at
    Greedy's j0, the tables and the JAX rows at -e 3."""
    tidx = torch_py_builder.build_index(env["records"])
    sh_text = ShardedIndex(tidx, S, "cpu")
    words, m, lb = bloom.load_words(tidx, None, LMAP)
    screen = bloom.BloomScreen(words, m, lb, "cpu").args
    tidx.text = None
    sh = ShardedIndex(tidx, S, "cpu")
    reads = env["reads"] + env["tie_reads"]
    flat, chars, frag_off, n_frags, _k, rf, _o = _fragments(reads)
    batch = (_t(flat[:chars].copy()), _t(frag_off[:n_frags + 1].copy()),
             _t(rf.copy()))
    seed = tuple(_t(a) for a in env["seed"])
    lanes = search.mem_extend_plain(sh.rec, sh.C, *seed, batch[0], batch[1],
                                    K, LMAP - 1)
    return {"sh": sh, "sh_text": sh_text, "screen": screen, "reads": reads,
            "batch": batch, "seed": seed, "lanes": lanes,
            "tables": tuple(_t(a) for a in env["tables"]),
            "par": _t(env["par"]), "dep": _t(env["dep"]),
            "jax": _jax_rows(env, reads, 3)}


def _search(h, e, view=None, vcap=greedy.VCAP):
    """greedy_search_hosts on the view (with its server), or E's plain
    version (no hybrid) on the whole index."""
    sh, (flat, frag_off, rf) = h["sh"], h["batch"]
    args = (flat, frag_off, rf)
    tail = (h["tables"], LMAP, MFL, MIN_SCORE, e, T, vcap)
    if view is None:
        return greedy.greedy_search_plain(*h["lanes"], *args, sh.rec, sh.C,
                                          *tail)[:4]
    return greedy.greedy_search_hosts(view, view.exchange, *h["lanes"], *args,
                                      *tail)


@pytest.mark.parametrize("e", [0, 1, 3, 5])
@pytest.mark.parametrize("which", list(REMOTE))
def test_levels_and_variants_in_rounds_equal_e(hosts, which, e):
    """U's forms and X's steps in rounds give E's (best, flags, g_s0,
    g_s1) exactly; X parks on the remote rows only."""
    view = hosts_view(hosts["sh"], REMOTE[which])
    got = _search(hosts, e, view)
    want = _search(hosts, e)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (view.exchange.served > 0) == (e > 0 and which != "none")
    assert (want[0] > 0).sum() > 100
    assert bool((want[1] & greedy.FLAG_TIE_OVER).any())


def test_small_vcap_flags_the_reads_e_flags(hosts):
    """With one source slot a read and level, U flags the reads that need
    more with FLAG_SCRATCH and a zero row, exactly as E does."""
    view = hosts_view(hosts["sh"], REMOTE["half"])
    got = _search(hosts, 3, view, vcap=1)
    want = _search(hosts, 3, vcap=1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    over = (got[1] & greedy.FLAG_SCRATCH) != 0
    assert 0 < int(over.sum()) < over.shape[0]
    assert not bool(got[0][over].any()) and not bool(got[2][over].any())


@pytest.mark.parametrize("R_, cap", [(R, CAP), (4, CAP), (R, 2)],
                         ids=["R32-cap20", "R4", "cap2"])
def test_v_around_the_walks_equals_f(hosts, R_, cap):
    """V, Q's walks in rounds and W's resolved form (ranges) give F's
    (lca, n_ids, need_more, tie_order) on the reads' tie ranges (ties over
    more than cap + 1 taxa; past R positions)."""
    sh = hosts["sh"]
    view = hosts_view(sh, REMOTE["half"])
    _best, _flags, g_s0, g_s1 = _search(hosts, 3)
    tail = (sh.seq_tax, hosts["par"], hosts["dep"], R_, cap)
    want = classify.ranges_lca_plain(g_s0, g_s1, sh.rec, sh.C, sh.sa_seq,
                                     sh.sa_off, *tail, sh.nseq, sh.chpt_exp)
    pos, info = classify.ranges_lca_list(g_s0, g_s1, R_)
    listed = pos >= 0
    assert torch.equal(listed.sum(1, dtype=torch.int32), info[:, 0])
    rows = pos[listed]
    ids = torch.empty_like(rows)
    parked, queries = tdev.walk_hosts(view.rec, view.C, view.sa_seq,
                                      view.nseq, view.chpt_exp, ids, rows=rows)
    view.exchange.rounds("walk", parked, queries, 1, lambda pk, ans:
                         tdev.walk_hosts(view.rec, view.C, view.sa_seq,
                                         view.nseq, view.chpt_exp, ids,
                                         parked=pk, answers=ans.reshape(-1)))
    seq = torch.full_like(pos, -1)
    seq[listed] = ids
    got = classify.lca_resolved(info, seq, *tail, ranges=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert view.exchange.served > 0
    need_more, tie_order = want[2], want[3]
    # R = 4 holds fewer taxa than the cap: the reads past it need more;
    # else the cap may cut taxa of several ranges
    assert bool((need_more if R_ == 4 else tie_order).any())


def test_o_at_greedy_parameters_equals_b(hosts):
    """O at Greedy's j0 = Lmap - 1 with the Lmap-mer screen, in rounds with
    every shard remote, ends every lane where B's plain version does with
    the same screen; the screen drops lanes."""
    sh = hosts["sh_text"]
    view = hosts_view(sh, REMOTE["all"])
    flat, frag_off, _rf = hosts["batch"]
    args = (*hosts["seed"], flat, frag_off, K, LMAP - 1)
    screen = hosts["screen"]
    assert screen[1] == LMAP
    want = search.mem_extend_plain(sh.rec, sh.C, *args, bloom=screen)
    out, parked, queries = search.mem_extend_hosts(view.rec, view.C, *args,
                                                   bloom=screen)
    view.exchange.rounds("extend", parked, queries, 1, lambda pk, ans:
                         search.mem_extend_hosts(
                             view.rec, view.C, *args, bloom=screen, out=out,
                             parked=pk, answers=ans.reshape(-1, 2))[1:])
    for g, w in zip(out, want):
        assert torch.equal(g, w)
    assert view.exchange.served > 0
    assert not torch.equal(want[0], hosts["lanes"][0])  # lanes screened


@pytest.mark.parametrize("which", ["all", "half"])
def test_whole_batch_equals_fused_greedy_classify(hosts, which):
    """fused_greedy_classify_hosts (O, U, X, Q and V in rounds) gives the
    rows of the one-host fused_greedy_classify with no hybrid, flags
    included, and kaiju_tpu's rows at -e 3."""
    sh = hosts["sh"]
    view = hosts_view(sh, REMOTE[which])
    flat, frag_off, rf = hosts["batch"]
    tail = (hosts["par"], hosts["dep"], hosts["tables"], K, LMAP, MFL,
            MIN_SCORE, 3, T, R, CAP)
    got = greedy.fused_greedy_classify_hosts(
        view, view.exchange, hosts["seed"], flat, frag_off, rf, sh.seq_tax,
        *tail)
    want = greedy.fused_greedy_classify(
        sh.rec, sh.C, hosts["seed"], flat, frag_off, rf, sh.sa_seq,
        sh.sa_off, sh.seq_tax, *tail, sh.nseq, sh.chpt_exp)
    assert torch.equal(got, want)
    _same_as_jax(got.numpy(), hosts["jax"])
    flags = got[:, 2]
    for bit in (greedy.FLAG_TIE_OVER, classify.FLAG_NEED_MORE,
                greedy.FLAG_TIE_ORDER):
        assert bool((flags & bit).any())
