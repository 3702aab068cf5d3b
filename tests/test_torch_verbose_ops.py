"""The plain versions of the verbose path's kernels against kaiju_tpu, on
the CPU: H (sa_lookup) against sa_lookup_fused, I (extend_from and its
code-row form) against extend_from_flat and extend_from_rec, J
(extend_all) against extend_all over blocks/occ, K (greedy_map) against
fused_greedy_map's row set, screened and unscreened, and the MEM search
wrapper (mem_search, B -> C) against fused_mem_search2.  The inputs are
made from a seed with numpy; every output is an integer, tolerance 0.  The
kernels themselves are held against these plain versions in
tests/test_torch_kernels.py."""

import random

import numpy as np
import pytest
import torch

from kaiju_tpu.index import py_builder as jax_py_builder
from kaiju_tpu.index.alphabet import encode_protein
from kaiju_tpu.ops import bloom as jbloom
from kaiju_tpu.ops import device_index as jdev
from kaiju_tpu.ops.fused_mem2 import fused_greedy_map, fused_mem_search2
from kaiju_tpu.ops.kmer import KmerTables as JaxKmerTables
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.ops import search

import test_torch_kernels
from conftest import make_db_records
from test_torch_search import _fragments

K, LMAP, MIN_LEN, T = search.SEED_K, 7, 11, search.TIE_CAP


@pytest.fixture(scope="module")
def env():
    rng = random.Random(141)
    records = make_db_records(rng, nseq=40)
    jidx = jax_py_builder.build_index(records)
    jd = jdev.DeviceIndex(jidx)
    td = tdev.DeviceIndex.from_arrays(
        np.asarray(jd.rec), np.asarray(jd.C), np.asarray(jd.sa_seq),
        np.asarray(jd.sa_off), jidx.seq_taxids, "cpu", nseq=jidx.nseq,
        chpt_exp=jidx.chpt_exp,
    )
    frags = [f for f in _fragments(rng, records) if f]
    enc = [encode_protein(f, jidx.alphabet) for f in frags]
    frag_off = np.zeros(len(enc) + 1, dtype=np.int32)
    frag_off[1:] = np.cumsum([len(e) for e in enc])
    return {
        "jidx": jidx, "jd": jd, "td": td, "enc": enc, "frag_off": frag_off,
        "flat": np.concatenate(enc).astype(np.uint8),
        "seed": JaxKmerTables.build(jidx, K).planar_seed(K),
    }


def _t(a, dtype=np.int32):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sa_lookup_matches_sa_lookup_fused(env):
    """Random positions, every sampled slot, the terminator rows and the
    pad position kaiju_tpu fills its fixed shape with: iseq and pos."""
    jidx, jd, td = env["jidx"], env["jd"], env["td"]
    e = jidx.chpt_exp
    rng = np.random.default_rng(7)
    pad_k = ((jidx.nseq + (1 << e) - 1) >> e) << e
    k = np.concatenate([
        rng.integers(0, jidx.length, 3000),
        np.arange(0, jidx.length, 1 << e),
        np.arange(jidx.nseq),
        [pad_k] * 5,
    ]).astype(np.int32)
    want = jdev.sa_lookup_fused(jd.rec, jd.C, jd.sa_seq, jd.sa_off,
                                jidx.nseq, e, k)
    got = tdev.sa_lookup(td.rec, td.C, td.sa_seq, td.sa_off, td.nseq, e,
                         _t(k))
    _equal(got, want)
    assert torch.equal(got[0], tdev.sa_lookup_plain(
        td.rec, td.C, td.sa_seq, td.sa_off, td.nseq, e, _t(k))[0])


def _lanes(env, n, seed):
    """Resumed-extension lanes over the flat fragments: the interval of a
    fragment's letter at j, or a random interval, resumed at i = j (some
    at i = 0 or from the fragment's end); a substitution at a position
    below i, at -1, or past i; some lanes inactive."""
    jidx, frag_off = env["jidx"], env["frag_off"]
    C = np.asarray(env["jd"].C)
    flat = env["flat"]
    rng = np.random.default_rng(seed)
    f = rng.integers(0, len(env["enc"]), n)
    flen = frag_off[f + 1] - frag_off[f]
    j = (rng.random(n) * flen).astype(np.int64)
    j[::17] = flen[::17] - 1
    base = frag_off[f]
    c = flat[base + j].astype(np.int64)
    s0, s1 = C[c], C[c + 1]
    rnd = rng.random(n) < 0.2
    s0 = np.where(rnd, rng.integers(0, jidx.length, n), s0)
    s1 = np.where(rnd, np.minimum(jidx.length, s0 + rng.integers(1, 400, n)),
                  s1)
    start = j.copy()
    start[::23] = 0
    kind = rng.integers(0, 3, n)
    pos = np.where(kind == 0, -1, np.where(
        kind == 1, (rng.random(n) * np.maximum(start, 1)).astype(np.int64),
        start + 1))
    sub = rng.integers(1, 21, n)
    act = rng.random(n) < 0.85
    s0 = np.where(act, s0, 0)
    s1 = np.where(act, s1, 1)  # kaiju_tpu's pad lane
    return base, pos, sub, start, s0, s1, act


def test_extend_from_matches_extend_from_flat(env):
    jd, td = env["jd"], env["td"]
    base, pos, sub, start, s0, s1, act = _lanes(env, 4000, 8)
    want = jdev.extend_from_flat(
        jd.rec2, jd.C, env["flat"], *(np.asarray(a, np.int32) for a in
                                      (base, pos, sub, start, s0, s1)), act)
    got = tdev.extend_from(td.rec, td.C, _t(env["flat"], np.uint8),
                           *(_t(a) for a in (base, pos, sub, start, s0, s1)),
                           _t(act, bool))
    _equal(got, want)
    # inactive lanes come back unchanged; active ones moved somewhere
    for g, a in zip(got, (start, s0, s1)):
        np.testing.assert_array_equal(g.numpy()[~act], a[~act])
    assert (got[0].numpy()[act] < start[act]).sum() > 1000


def test_extend_rows_matches_extend_from_rec(env):
    """The code-row form (kaiju_tpu's extend_from_rec over paired records
    from build_paired_records): lane t reads row t, no substitution."""
    jd, td = env["jd"], env["td"]
    base, _pos, _sub, start, s0, s1, act = _lanes(env, 1500, 9)
    frag_off, flat = env["frag_off"], env["flat"]
    L = int(np.diff(frag_off).max())
    codes = np.zeros((len(base), L), dtype=np.uint8)
    for t, b in enumerate(base):
        f = np.searchsorted(frag_off, b, side="right") - 1
        codes[t, : frag_off[f + 1] - b] = flat[b:frag_off[f + 1]]
    rec2 = jdev.build_paired_records(np.asarray(jd.rec))
    np.testing.assert_array_equal(np.asarray(jd.rec2), rec2)
    lanes = (np.asarray(a, np.int32) for a in (start, s0, s1))
    want = jdev.extend_from_rec(rec2, jd.C, codes, *lanes, act)
    got = tdev.extend_rows(td.rec, td.C, _t(codes, np.uint8), _t(start),
                           _t(s0), _t(s1), _t(act, bool))
    _equal(got, want)


def test_extend_all_matches_extend_all(env):
    """J's plain version over the fused records against kaiju_tpu's
    extend_all over blocks/occ, on a 0-padded code matrix (every lane,
    the invalid ones too)."""
    jd, td, enc = env["jd"], env["td"], env["enc"]
    L = max(len(e) for e in enc) + 5
    codes = np.zeros((len(enc), L), dtype=np.uint8)
    for t, e in enumerate(enc):
        codes[t, : len(e)] = e
    flen = np.asarray([len(e) for e in enc], dtype=np.int32)
    want = jdev.extend_all(jd.blocks, jd.occ, jd.C, codes, flen)
    got = tdev.extend_all(td.rec, td.C, _t(codes, np.uint8), _t(flen))
    _equal(got, want)
    valid = np.arange(L)[None, :] < flen[:, None]
    assert (got[2].numpy() > got[1].numpy())[valid].mean() > 0.9


@pytest.mark.parametrize("screened", [False, True])
def test_greedy_map_rows_match_fused_greedy_map(env, screened):
    """K's plain version on B's lanes (the plain mem_extend, with the
    Lmap-mer bitmap or without) gives the row set of fused_greedy_map
    (with the same bitmap or without): the JAX program evaluates a subset
    of the lanes, B all of them, and a lane B screens out has length 0."""
    jidx, jd, td = env["jidx"], env["jd"], env["td"]
    flat, frag_off = env["flat"], env["frag_off"]
    words, m, lb = (jbloom.load_words(jidx, None, LMAP) if screened
                    else (None, 0, 0))
    P, F = 16384, 256
    assert flat.shape[0] <= P and len(frag_off) - 1 <= F
    jflat = np.zeros(P, dtype=np.uint8)
    jflat[: flat.shape[0]] = flat
    joff = np.full(F + 1, frag_off[-1], dtype=np.int32)
    joff[: len(frag_off)] = frag_off
    packed = np.asarray(fused_greedy_map(
        jd.rec, jd.C, env["seed"], jflat, joff, None, words, K, LMAP - 1,
        LMAP, P, P, P, m, lb, 4))
    n = int(packed[P, 0])
    assert n <= P
    want = packed[:n]
    bloom = None if words is None else (
        torch.from_numpy(words.view(np.int32)), m, lb)
    lanes = search.mem_extend(td.rec, td.C, *(torch.from_numpy(a) for a in
                                              env["seed"]),
                              _t(flat, np.uint8), _t(frag_off), K, LMAP - 1,
                              bloom=bloom)
    rows, n_rows = search.greedy_map(*lanes, _t(frag_off), LMAP)
    got = rows[: int(n_rows)].numpy()

    def order(r):
        return r[np.lexsort((-r[:, 1], r[:, 0]))]

    assert got.shape == want.shape and n > 500
    np.testing.assert_array_equal(order(got), order(want))
    # the plain version's rows ascend in (f, j)
    np.testing.assert_array_equal(got, got[np.lexsort((got[:, 1], got[:, 0]))])


def _k_rule(i, s0, s1, frag_off, lmap):
    """Kernel K's rule in numpy, a fragment at a time: jstop = the largest
    j with i <= 1 (-1 if none), then a row (f, j, i, s0, s1) for every j
    >= jstop with j - i + 1 >= lmap, in ascending (f, j)."""
    rows = []
    for f in range(frag_off.shape[0] - 1):
        st, en = int(frag_off[f]), int(frag_off[f + 1])
        ii = i[st:en]
        stops = np.flatnonzero(ii <= 1)
        jstop = int(stops[-1]) if stops.size else -1
        for j in range(max(jstop, 0), en - st):
            if j - ii[j] + 1 >= lmap:
                rows.append((f, j, ii[j], s0[st + j], s1[st + j]))
    return np.asarray(rows, dtype=np.int32).reshape(-1, 5)


@pytest.mark.parametrize("case", test_torch_kernels.K_CASES)
def test_greedy_map_plain_matches_numpy_rule(case):
    """K's plain version (the wrapper on CPU tensors) against a numpy
    model of the rule on K's corner cases (test_torch_kernels.k_corner),
    row for row and count; no JAX."""
    for args in test_torch_kernels.k_corner(case):
        rows, n = search.greedy_map(*args)
        want = _k_rule(*(a.numpy() for a in args[:4]), args[4])
        assert int(n) == want.shape[0] == rows.shape[0]
        np.testing.assert_array_equal(rows.numpy(), want)


def test_mem_search_matches_fused_mem_search2(env):
    """The host wrapper of the -v path (B -> C, screened at m = -m) gives
    fused_mem_search2's (maxl, tie_cnt, tie_j, tie_s0, tie_s1) rows."""
    jidx, jd, td = env["jidx"], env["jd"], env["td"]
    flat, frag_off = env["flat"], env["frag_off"]
    words, m, lb = jbloom.load_words(jidx, None, MIN_LEN)
    P, F = 16384, 256
    jflat = np.zeros(P, dtype=np.uint8)
    jflat[: flat.shape[0]] = flat
    joff = np.full(F + 1, frag_off[-1], dtype=np.int32)
    joff[: len(frag_off)] = frag_off
    packed = np.asarray(fused_mem_search2(
        jd.rec, jd.C, env["seed"], jflat, joff, None, words, K, MIN_LEN - 1,
        MIN_LEN, P, T, P, m, lb, 4))
    nf = len(frag_off) - 1
    want = (packed[:nf, 0], packed[:nf, 1], packed[:nf, 2:2 + T],
            packed[:nf, 2 + T:2 + 2 * T], packed[:nf, 2 + 2 * T:2 + 3 * T])
    got = search.mem_search(
        td.rec, td.C, tuple(torch.from_numpy(a) for a in env["seed"]),
        _t(flat, np.uint8), _t(frag_off), K, MIN_LEN - 1, MIN_LEN, T,
        bloom=(torch.from_numpy(words.view(np.int32)), m, lb))
    _equal(got, want)
    assert (want[1] > T).any()  # fragments past the tie cap
