"""The contract kernels D and F are held to, on the CPU: the port's plain
versions ranges_lca_plain and read_lca_plain against a host oracle, and
against kaiju_tpu's fused_classify.ranges_lca where every kept taxon lies
at one depth (where the JAX tail's mixed-depth fault, ROADMAP 3c, cannot
show).

The index is a small py_builder index of 40 records; its sequences map
to leaves of a seeded taxonomy of NCBI's depth (readgen.DeepTaxonomy cut
to a few thousand nodes: species 20-40 levels deep) with a second root
and some taxa absent.  The oracle walks each SA position on the host
(KaijuIndex.get_suffix), keeps the capped unique set in the reference's
order (ConsumerThread.cpp:799-845) and takes the port's Taxonomy.lca
(util.cpp:194-263); where the kept taxa lie under two roots, which never
meet, it gives the first present taxon's root, where the bounded climb of
the plain versions and the kernels ends (the reference would not end).
Integer outputs, tolerance 0."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaiju_tpu.ops import device_index as jdev
from kaiju_tpu.ops import fused_classify as jfc
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.io.taxonomy import Taxonomy
from kaiju_tpu_torch.ops import classify
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.tools.readgen import DeepTaxonomy

from conftest import make_db_records

RS = (4, 32, 64)
CAPS = (1, 20, 40)
B, G = 48, 20  # reads; ranges a read (F)
FN, T, S = 160, 8, 6  # fragment rows, ties a row, slots a read (D)
ABSENT = 19_999  # a taxid inside the dense arrays but not in the tree


def _trees(seed):
    """(the small deep tree, a Taxonomy of it with a second root, that
    Taxonomy's parent and depth arrays)."""
    t = DeepTaxonomy(seed, n_species=3000, max_taxid=20_000, width=40)
    nodes = {int(x): int(t.parent[x])
             for x in np.concatenate([t.internal, t.species])}
    second = min(x for x, p in nodes.items() if p == 1 and x != 1)
    nodes[second] = second  # a clade of level 1 becomes a root
    tax = Taxonomy(nodes)
    par, dep = tax.dense_arrays()
    return t, tax, par, dep, second


@pytest.fixture(scope="module")
def env():
    rng = random.Random(11)
    records = make_db_records(rng, nseq=40)
    idx = py_builder.build_index(records)
    t, tax, par, dep, second = _trees(13)
    nr = np.random.default_rng(17)
    # mixed: leaves of five clades 3-15 levels above random species, so
    # that the LCAs fall at many depths, one under the second root, a
    # shared taxon, absent taxa
    clades = t.ancestor(t.species[nr.integers(0, len(t.species), 5)],
                        nr.integers(3, 16, 5))
    mixed = t.leaves_under(nr, clades[np.arange(idx.nseq) % 5])
    mixed[7] = t.leaves_under(nr, [second])[0]
    mixed[::9] = ABSENT
    mixed[4] = mixed[5]
    # level: leaves of one depth under the first root, from three clades
    roots = np.array([_root(tax, int(x)) for x in t.species])
    d0 = np.bincount(dep[t.species[roots == 1]]).argmax()
    pool = t.species[(dep[t.species] == d0) & (roots == 1)]
    top = t.ancestor(pool, np.full(len(pool), 6))
    groups = [pool[top == c] for c in np.unique(top)]
    groups = sorted(groups, key=len)[-3:]
    level = np.array([g[nr.integers(0, len(g))] for g in
                      (groups[i % 3] for i in range(idx.nseq))])
    level[::11] = ABSENT
    ranges = _ranges(nr, idx.nseq, idx.length)
    stats = _stats(nr, idx.nseq, idx.length)
    td = tdev.DeviceIndex(idx, "cpu")
    # each SA position's sequence, walked on the host
    walked = np.array([idx.get_suffix(k)[0] for k in range(idx.length)],
                      dtype=np.int64)
    return {"idx": idx, "td": td, "tax": tax, "walked": walked,
            "par": torch.from_numpy(par), "dep": torch.from_numpy(dep),
            "seq_tax": {"mixed": mixed.astype(np.int32),
                        "level": level.astype(np.int32)},
            "ranges": ranges, "stats": stats}


def _root(tax, t):
    while tax.nodes[t] != t:
        t = tax.nodes[t]
    return t


def _ranges(nr, nseq, length):
    """g_s0, g_s1 int32 [B, G] inside [nseq, length), the SA rows of
    suffixes that start with a letter (a search never reaches the
    terminators' rows): a few ranges a read, some empty, some reversed;
    read 0 none, read 1 one position, read 2 one wide range, read 3 every
    range wide."""
    s0 = nr.integers(nseq, length, (B, G))
    size = nr.integers(-2, 9, (B, G)) * (nr.random((B, G)) < 0.3)
    size[0] = 0
    size[1] = 0
    size[1, 7] = 1
    size[2] = 0
    size[2, 0] = length
    size[3] = 40
    s1 = np.clip(s0 + size, 0, length)
    return s0.astype(np.int32), s1.astype(np.int32)


def _stats(nr, nseq, length):
    """read_lca's inputs: maxl, tie_cnt [FN], tie_s0, tie_s1 [FN, T]
    (inside [nseq, length)), rf_rows [B, S] (-1 pads; read 0 all pads)."""
    maxl = nr.integers(0, 5, FN).astype(np.int32)
    tie_cnt = nr.integers(0, T + 3, FN).astype(np.int32)
    s0 = nr.integers(nseq, length, (FN, T))
    size = nr.integers(0, 6, (FN, T)) * (nr.random((FN, T)) < 0.5)
    size[:4] = 30
    s1 = np.minimum(s0 + size, length)
    rf = nr.integers(-1, FN, (B, S)).astype(np.int32)
    rf[0] = -1
    return (maxl, tie_cnt, s0.astype(np.int32), s1.astype(np.int32), rf)


def _oracle_tail(env, seq_tax, ranges, R, cap):
    """(lca, n_ids, need_more, cut, n_ranges) of one read's ranges [(s0,
    s1)], with the reference's semantics."""
    tax = env["tax"]
    pos, total, n_ranges = [], 0, 0
    for a, b in ranges:
        size = max(b - a, 0)
        n_ranges += size > 0
        total += size
        pos += list(range(a, a + size))[:max(R - len(pos), 0)]
    kept, n_uniq, seen = [], 0, set()
    for k in pos:
        t = int(seq_tax[env["walked"][k]])
        if t in seen:
            continue
        seen.add(t)
        if n_uniq <= cap:
            kept.append(t)
        n_uniq += 1
    need_more = total > R and n_uniq <= cap
    cut = n_uniq > cap + 1 or (total > R and n_uniq > cap)
    if not kept:
        lca = 0
    elif len(kept) == 1:
        lca = kept[0]
    else:
        present = [t for t in kept if t in tax.nodes]
        if len({_root(tax, t) for t in present}) > 1:
            lca = _root(tax, present[0])  # a forest: the bounded climb
        else:
            lca = tax.lca(kept)
    return lca, len(kept), int(need_more), int(cut), n_ranges


def _plain_args(env, mode):
    td = env["td"]
    return (td.rec, td.C, td.sa_seq, td.sa_off,
            torch.from_numpy(env["seq_tax"][mode]), env["par"], env["dep"])


@pytest.mark.parametrize("mode", ["mixed", "level"])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("R", RS)
def test_ranges_lca_plain_matches_oracle(env, R, cap, mode):
    s0, s1 = env["ranges"]
    got = classify.ranges_lca_plain(
        torch.from_numpy(s0), torch.from_numpy(s1), *_plain_args(env, mode),
        R, cap, env["idx"].nseq, env["idx"].chpt_exp)
    want = np.array([_oracle_tail(env, env["seq_tax"][mode],
                                  list(zip(s0[b], s1[b])), R, cap)
                     for b in range(B)], dtype=np.int64)
    lca, n_ids, need_more, order = (g.numpy() for g in got)
    np.testing.assert_array_equal(lca, want[:, 0])
    np.testing.assert_array_equal(n_ids, want[:, 1])
    np.testing.assert_array_equal(need_more, want[:, 2])
    np.testing.assert_array_equal(order, (want[:, 4] > 1) & (want[:, 3] > 0))
    assert (n_ids > 1).sum() > 10 and lca[0] == 0 and n_ids[1] == 1
    assert order.any() if cap == 1 else need_more.any() or cap < 40
    dep = env["dep"].numpy()  # LCAs at several depths
    assert len(np.unique(dep[np.clip(lca, 0, len(dep) - 1)])) > 2


@pytest.mark.parametrize("mode", ["mixed", "level"])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("R", RS)
def test_read_lca_plain_matches_oracle(env, R, cap, mode):
    maxl, tie_cnt, s0, s1, rf = env["stats"]
    got = classify.read_lca_plain(
        *(torch.from_numpy(a) for a in env["stats"]),
        *_plain_args(env, mode), R, cap, env["idx"].nseq,
        env["idx"].chpt_exp).numpy()
    for b in range(B):
        rows = [r for r in rf[b] if r >= 0]
        longest = max([int(maxl[r]) for r in rows], default=0)
        contrib = [r for r in rf[b] if r >= 0 and longest > 0
                   and maxl[r] == longest]
        ranges = [(s0[r, t], s1[r, t]) for r in contrib for t in range(T)]
        lca, n_ids, need_more, _cut, _n = _oracle_tail(
            env, env["seq_tax"][mode], ranges, R, cap)
        over = any(tie_cnt[r] > T for r in contrib)
        want = [lca if longest > 0 else 0, longest,
                int(over) * classify.FLAG_TIE_OVER
                + need_more * classify.FLAG_NEED_MORE, n_ids]
        assert got[b].tolist() == want, b
    assert (got[:, 3] > 1).sum() > 10 and got[0].tolist() == [0, 0, 0, 0]
    assert (got[:, 2] & classify.FLAG_TIE_OVER).any()


@pytest.fixture(scope="module")
def jax_tails(env):
    """kaiju_tpu's ranges_lca on the ranges with every taxon at one depth,
    for each R and cap (one compile an R)."""
    idx = env["idx"]
    jd = jdev.DeviceIndex(idx)
    s0, s1 = (jnp.asarray(a) for a in env["ranges"])
    contrib = s1 > s0

    def walk_fn(kf):
        return jfc._sa_walk_local(jd.rec, jd.C, jd.sa_seq, jd.sa_off,
                                  idx.nseq, idx.chpt_exp, kf)

    out = {}
    for R in RS:
        fn = jax.jit(lambda st, par, dep, cap, R=R: jfc.ranges_lca(
            s0, s1, contrib, walk_fn, st, par, dep, R, cap, idx.nseq,
            idx.chpt_exp))
        for cap in CAPS:
            res = fn(jnp.asarray(env["seq_tax"]["level"]),
                     jnp.asarray(env["par"].numpy()),
                     jnp.asarray(env["dep"].numpy()), cap)
            out[R, cap] = tuple(np.asarray(r) for r in res)
    return out


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("R", RS)
def test_ranges_lca_plain_matches_jax_at_one_depth(env, jax_tails, R, cap):
    s0, s1 = env["ranges"]
    got = classify.ranges_lca_plain(
        torch.from_numpy(s0), torch.from_numpy(s1),
        *_plain_args(env, "level"), R, cap, env["idx"].nseq,
        env["idx"].chpt_exp)
    lca, n_ids, need_more, total = jax_tails[R, cap]
    np.testing.assert_array_equal(got[0].numpy(), lca)
    np.testing.assert_array_equal(got[1].numpy(), n_ids)
    np.testing.assert_array_equal(got[2].numpy(), need_more)
    assert (n_ids > 1).sum() > 10 and (total > R).any()
