"""The port's CUDA kernels against their plain PyTorch versions, on a small
index.  Every test here needs a card and skips without one; the file
imports neither jax nor kaiju_tpu nor conftest, so it also runs on a
machine with only PyTorch:

    python -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -q
"""

import random

import numpy as np
import pytest
import torch

from kaiju_tpu_torch.engine.fragments_native import NativeFragmenter2
from kaiju_tpu_torch.engine.pipeline import _bucket
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.index.alphabet import trans_table
from kaiju_tpu_torch.io.taxonomy import Taxonomy
from kaiju_tpu_torch.ops import bloom, classify, greedy, hybrid, search
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.ops.kmer import KmerTables
from kaiju_tpu_torch.tools.readgen import make_reads, reverse_translate

pytestmark = pytest.mark.cuda

AA = "ACDEFGHIKLMNPQRSTVWY"
MIN_LEN, T, CAP = 11, 8, 20
NODES = {1: 1, 10: 1, 100: 10, 200: 10, 101: 100, 102: 100, 201: 200}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def env():
    rng = random.Random(71)
    base = "".join(rng.choice(AA) for _ in range(120))
    records = []
    for i in range(60):  # random proteins, shared and duplicated content
        kind = i % 4
        if kind == 0:
            seq = "".join(rng.choice(AA) for _ in range(rng.randint(40, 300)))
        elif kind == 1:
            seq = "".join(rng.choice(AA) for _ in range(20)) + base[10:70]
        elif kind == 2:
            seq = base
        else:
            seq = base[: rng.randint(20, 110)]
        records.append((f"ACC{i:04d}.1_{[101, 102, 201, 100][i % 4]}", seq))
    idx = py_builder.build_index(records)
    reads = [(n, s, None) for n, s in make_reads(rng, records, n=300)]
    for t in range(10):  # periodic motifs: more ties than T
        st = rng.randrange(0, 100)
        reads.append((f"rep{t}", reverse_translate(rng, ("W" + base[st : st + 14]) * 9), None))
    reads += [(f"short{i}", "ACGTTG" * (i % 3), None) for i in range(6)]
    kt = KmerTables.build(idx, search.SEED_K)
    par, dep = Taxonomy(NODES).dense_arrays()
    tables = greedy.greedy_scoring_tables(idx.alphabet, trans_table(idx.alphabet))
    return {
        "idx": idx, "reads": reads, "dv": tdev.DeviceIndex(idx, "cpu"),
        "seed": tuple(torch.from_numpy(a) for a in kt.planar_seed(search.SEED_K)),
        "par": torch.from_numpy(par), "dep": torch.from_numpy(dep),
        "tables": tuple(torch.from_numpy(a) for a in tables),
    }


def _batch(env, S, mode="mem"):
    frag = NativeFragmenter2(mode, MIN_LEN, 65, True, False)
    flat, chars, frag_off, n_frags, _k, rf_rows, _o = frag.run(
        env["reads"], S, _bucket)
    return (torch.from_numpy(flat[:chars]),
            torch.from_numpy(frag_off[: n_frags + 1]),
            torch.from_numpy(rf_rows))


def _args(env, flat, frag_off, rf_rows, R, dev):
    dv = env["dv"]

    def to(t):
        return t.to(dev)

    return (to(dv.rec), to(dv.C), tuple(to(a) for a in env["seed"]),
            to(flat), to(frag_off), to(rf_rows), to(dv.sa_seq),
            to(dv.sa_off), to(dv.seq_tax), to(env["par"]), to(env["dep"]),
            search.SEED_K, MIN_LEN - 1, MIN_LEN, T, R, CAP, dv.nseq,
            dv.chpt_exp)


def test_update_si_kernel_matches_plain(env, cuda):
    idx, dv = env["idx"], env["dv"]
    rng = np.random.default_rng(3)
    n = 20000
    c = torch.from_numpy(rng.integers(1, idx.alen, n).astype(np.int32))
    s0 = torch.from_numpy(rng.integers(0, idx.length, n).astype(np.int32))
    s1 = torch.clamp(s0 + torch.from_numpy(rng.integers(1, 300, n).astype(np.int32)),
                     max=idx.length)
    s0[:3] = torch.tensor([0, 128, idx.length], dtype=torch.int32)
    want = tdev.update_si_plain(dv.rec, dv.C, c, s0, s1)
    got = tdev.update_si(*(t.to(cuda) for t in (dv.rec, dv.C, c, s0, s1)))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_search_kernels_match_plain(env, cuda):
    dv = env["dv"]
    flat, frag_off, _rf = _batch(env, 16)
    ext = (dv.rec, dv.C, *env["seed"], flat, frag_off, search.SEED_K,
           MIN_LEN - 1)
    want = search.mem_extend_plain(*ext)
    got = search.mem_extend(*(a.to(cuda) if isinstance(a, torch.Tensor)
                              else a for a in ext))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    want_s = search.mem_stats_plain(*want, frag_off, MIN_LEN, T)
    got_s = search.mem_stats(*got, frag_off.to(cuda), MIN_LEN, T)
    torch.cuda.synchronize()
    for g, w in zip(got_s, want_s):
        assert torch.equal(g.cpu(), w)
    assert (want_s[1] > T).any()  # tie overflow exercised


@pytest.mark.parametrize("S,R", [(16, 32), (2, 4)])
def test_fused_mem_classify_kernels_match_plain(env, cuda, S, R):
    flat, frag_off, rf_rows = _batch(env, S)
    want = classify.fused_mem_classify(
        *_args(env, flat, frag_off, rf_rows, R, "cpu"))
    got = classify.fused_mem_classify(
        *_args(env, flat, frag_off, rf_rows, R, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert (want[:, 1] > 0).sum() > 100
    if S == 2:
        assert (want[:, 2] & classify.FLAG_TIE_OVER).any()
        assert (want[:, 2] & classify.FLAG_NEED_MORE).any()


def test_batch_without_fragments(env, cuda):
    """Reads too short for a fragment: no lanes, every read unclassified."""
    env = dict(env, reads=[(f"s{i}", "ACGTTG" * (i % 5), None) for i in range(40)])
    flat, frag_off, rf_rows = _batch(env, 16)
    assert flat.numel() == 0
    want = classify.fused_mem_classify(
        *_args(env, flat, frag_off, rf_rows, 32, "cpu"))
    got = classify.fused_mem_classify(
        *_args(env, flat, frag_off, rf_rows, 32, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert not want.any()


def _greedy_args(env, reads, mismatches, dev, vcap=greedy.VCAP):
    """fused_greedy_classify's arguments at the main path's settings
    (K = 5, Lmap = 7, -m 11, -s 65, T = 20, R = 32, cap = 20)."""
    env = dict(env, reads=reads)
    flat, frag_off, rf_rows = _batch(env, 16, "greedy")
    dv = env["dv"]

    def to(t):
        return t.to(dev)

    return (to(dv.rec), to(dv.C), tuple(to(a) for a in env["seed"]),
            to(flat), to(frag_off), to(rf_rows), to(dv.sa_seq), to(dv.sa_off),
            to(dv.seq_tax), to(env["par"]), to(env["dep"]),
            tuple(to(a) for a in env["tables"]), search.SEED_K, 7, MIN_LEN, 65,
            mismatches, 20, 32, CAP, dv.nseq, dv.chpt_exp, vcap)


@pytest.mark.parametrize("mismatches,vcap", [(0, greedy.VCAP), (1, greedy.VCAP),
                                             (3, greedy.VCAP), (5, greedy.VCAP),
                                             (3, 1)])
def test_greedy_kernels_match_plain(env, cuda, mismatches, vcap):
    """E and F each against their plain version on the same inputs, then
    the whole B -> E -> F batch; vcap = 1 makes reads outgrow E's
    scratch."""
    cpu = _greedy_args(env, env["reads"], mismatches, "cpu", vcap)
    gpu = _greedy_args(env, env["reads"], mismatches, cuda, vcap)
    (rec, C, seed, flat, frag_off, rf_rows, sa_seq, sa_off, seq_tax, par,
     dep, tables, K, lmap, mfl, min_score, e, T, R, cap, nseq, chpt_exp,
     vc) = gpu
    lanes = search.mem_extend(rec, C, *seed, flat, frag_off, K, lmap - 1)
    e_args = (flat, frag_off, rf_rows, rec, C, tables, lmap, mfl, min_score,
              e, T, vc)
    got = greedy.greedy_search(*lanes, *e_args)
    want = greedy.greedy_search_plain(
        *(t.cpu() for t in lanes), *(a.cpu() if isinstance(a, torch.Tensor)
                                     else a for a in e_args[:5]),
        tuple(t.cpu() for t in tables), *e_args[6:])
    torch.cuda.synchronize()
    assert got[4] is None and want[4] is None  # no hybrid, no id slots
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g.cpu(), w)
    f_args = (rec, C, sa_seq, sa_off, seq_tax, par, dep, R, cap, nseq, chpt_exp)
    got_f = classify.ranges_lca(got[2], got[3], *f_args)
    want_f = classify.ranges_lca_plain(
        want[2], want[3], *(a.cpu() if isinstance(a, torch.Tensor) else a
                            for a in f_args))
    torch.cuda.synchronize()
    for g, w in zip(got_f, want_f):
        assert torch.equal(g.cpu(), w)
    rows = greedy.fused_greedy_classify(*gpu)
    want_rows = greedy.fused_greedy_classify(*cpu)
    torch.cuda.synchronize()
    assert torch.equal(rows.cpu(), want_rows)
    assert (want_rows[:, 1] > 0).sum() > 100
    assert not want_rows[-6:].any()  # the reads without a fragment
    if vcap == 1:
        assert (want_rows[:, 2] & greedy.FLAG_SCRATCH).any()
    elif mismatches >= 3:
        assert (want_rows[:, 2] & (greedy.FLAG_TIE_OVER
                                   | greedy.FLAG_NEED_MORE)).any()


def test_greedy_batch_without_fragments(env, cuda):
    reads = [(f"s{i}", "ACGTTG" * (i % 5), None) for i in range(40)]
    got = greedy.fused_greedy_classify(*_greedy_args(env, reads, 3, cuda))
    want = greedy.fused_greedy_classify(*_greedy_args(env, reads, 3, "cpu"))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert not want.any()


def test_wrappers_refuse_bad_cuda_inputs(env, cuda):
    dv = env["dv"]
    rec, C = dv.rec.to(cuda), dv.C.to(cuda)
    k = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        tdev.update_si(rec, C, k, k, k)
    k32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="on cpu"):
        tdev.update_si(rec, C, k32, k32, k32)
    args = list(_greedy_args(env, env["reads"][:8], 3, cuda))
    lanes = search.mem_extend(*args[:2], *args[2], *args[3:5], 5, 6)
    e_args = [*lanes, *args[3:6], *args[:2], args[11], 7, MIN_LEN, 65, 3, 20]
    bad = list(e_args)
    bad[0] = lanes[0].long()
    with pytest.raises(TypeError, match="int32"):
        greedy.greedy_search(*bad)
    bad = list(e_args)
    bad[5] = args[5].cpu()
    with pytest.raises(ValueError, match="on cpu"):
        greedy.greedy_search(*bad)
    bad = list(e_args)
    bad[5] = torch.full((8, 33), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="slots"):
        greedy.greedy_search(*bad)
    g = torch.zeros((4, 20), dtype=torch.int32, device=cuda)
    f_args = [*args[:2], *args[6:11], 32, CAP, args[20], args[21]]
    with pytest.raises(ValueError, match="shape"):
        classify.ranges_lca(g, g[:, :10].contiguous(), *f_args)
    with pytest.raises(ValueError, match="not contiguous"):
        classify.ranges_lca(g[:, ::2], g[:, ::2], *f_args)
    with pytest.raises(ValueError, match="R must"):
        classify.ranges_lca(g, g, *f_args[:7], 4096, *f_args[8:])


# ---------------------------------------------------------------------------
# the text-carrying index: B's Bloom screen, G, and D/E/F with virtual rows
# ---------------------------------------------------------------------------


def _screen(env, m, dev):
    idx = env["idx"]
    lb = bloom.bloom_lb(idx.length)
    return bloom.BloomScreen(bloom.fill_from_text(idx.text, m, lb), m, lb,
                             dev).args


def _to(a, dev):
    return a.to(dev) if isinstance(a, torch.Tensor) else a


@pytest.mark.parametrize("m,mode", [(11, "mem"), (7, "greedy")])
def test_bloom_screen_kernel_matches_plain(env, cuda, m, mode):
    """B with the screen at the main path's windows (MEM -m 11, Greedy
    Lmap 7) against its plain version; the screen drops lanes."""
    dv = env["dv"]
    flat, frag_off, _rf = _batch(env, 16, mode)
    ext = (dv.rec, dv.C, *env["seed"], flat, frag_off, search.SEED_K, m - 1)
    want = search.mem_extend_plain(*ext, bloom=_screen(env, m, "cpu"))
    got = search.mem_extend(*(_to(a, cuda) for a in ext),
                            bloom=_screen(env, m, cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    unscreened = search.mem_extend_plain(*ext)
    assert (want[2] - want[1] < unscreened[2] - unscreened[1]).any()


def test_text_extend_kernel_matches_plain(env, cuda):
    """G on the lanes that B stops after the seed and S1_STEPS steps:
    every output equal, ids included; the virtual rows hold the ids of the
    intervals that the FM steps end on."""
    dv = env["dv"]
    flat, frag_off, _rf = _batch(env, 16)
    K = search.SEED_K
    scr = _screen(env, MIN_LEN, "cpu")
    lanes = search.mem_extend_plain(dv.rec, dv.C, *env["seed"], flat,
                                    frag_off, K, MIN_LEN - 1, bloom=scr,
                                    sw_steps=hybrid.S1_STEPS)
    g_args = (flat, frag_off, K + hybrid.S1_STEPS, dv.text, dv.rank_start,
              dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.nseq, dv.chpt_exp)
    sw = hybrid.switched(*lanes, frag_off, K + hybrid.S1_STEPS)
    assert sw.sum() > 50
    want = hybrid.text_extend_plain(*lanes, *g_args)
    got = hybrid.text_extend(*(_to(a, cuda) for a in (*lanes, *g_args)))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    fm = search.mem_extend_plain(dv.rec, dv.C, *env["seed"], flat, frag_off,
                                 K, MIN_LEN - 1, bloom=scr)
    assert torch.equal(want[0], fm[0])
    assert torch.equal(want[2] - want[1], fm[2] - fm[1])


@pytest.mark.parametrize("S,R", [(16, 32), (2, 4)])
def test_fused_mem_classify_hybrid_kernels_match_plain(env, cuda, S, R):
    """B (screened) -> G -> C -> D with virtual rows, against the plain
    versions, and against the rows without screen and hybrid."""
    dv = env["dv"]
    flat, frag_off, rf_rows = _batch(env, S)

    def run(dev):
        return classify.fused_mem_classify(
            *_args(env, flat, frag_off, rf_rows, R, dev),
            bloom=_screen(env, MIN_LEN, dev),
            hyb=(dv.text.to(dev), dv.rank_start.to(dev)))

    want = run("cpu")
    got = run(cuda)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    plain = classify.fused_mem_classify(
        *_args(env, flat, frag_off, rf_rows, R, "cpu"))
    assert torch.equal(want, plain)


@pytest.mark.parametrize("mismatches", [1, 3])
def test_greedy_hybrid_kernels_match_plain(env, cuda, mismatches):
    """E with its last-level hybrid and F with the virtual rows, each
    against its plain version, then B (screened) -> E -> F whole, equal to
    the rows without screen and hybrid."""
    dv = env["dv"]
    gpu = _greedy_args(env, env["reads"], mismatches, cuda)
    (rec, C, seed, flat, frag_off, rf_rows, sa_seq, sa_off, seq_tax, par,
     dep, tables, K, lmap, mfl, min_score, e, T, R, cap, nseq, chpt_exp,
     vc) = gpu
    text, rank_start = dv.text.to(cuda), dv.rank_start.to(cuda)
    lanes = search.mem_extend(rec, C, *seed, flat, frag_off, K, lmap - 1,
                              bloom=_screen(env, lmap, cuda))
    e_args = (flat, frag_off, rf_rows, rec, C, tables, lmap, mfl, min_score,
              e, T, vc)
    hyb = (text, rank_start, sa_seq, sa_off, nseq, chpt_exp)
    got = greedy.greedy_search(*lanes, *e_args, hyb=hyb)
    want = greedy.greedy_search_plain(
        *(_to(a, "cpu") for a in (*lanes, *e_args[:5])),
        tuple(t.cpu() for t in tables), *e_args[6:],
        hyb=tuple(_to(a, "cpu") for a in hyb))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert (want[2] >= hybrid.VBASE).any()  # virtual tie rows exercised
    f_args = (rec, C, sa_seq, sa_off, seq_tax, par, dep, R, cap, nseq,
              chpt_exp)
    got_f = classify.ranges_lca(got[2], got[3], *f_args, sw_ids=got[4])
    want_f = classify.ranges_lca_plain(
        want[2], want[3], *(_to(a, "cpu") for a in f_args), sw_ids=want[4])
    torch.cuda.synchronize()
    for g, w in zip(got_f, want_f):
        assert torch.equal(g.cpu(), w)
    rows = greedy.fused_greedy_classify(
        *gpu, bloom=_screen(env, lmap, cuda), hyb=(text, rank_start))
    plain_rows = greedy.fused_greedy_classify(
        *_greedy_args(env, env["reads"], mismatches, "cpu"))
    torch.cuda.synchronize()
    assert torch.equal(rows.cpu(), plain_rows)


# ---------------------------------------------------------------------------
# the verbose paths: H (sa_lookup), I (extend_from), J (extend_all), K
# (greedy_map)
# ---------------------------------------------------------------------------


def test_sa_lookup_kernel_matches_plain(env, cuda):
    """H on random positions, every sampled slot, the terminator rows and
    a sampled pad position: iseq and pos equal."""
    idx, dv = env["idx"], env["dv"]
    e = dv.chpt_exp
    rng = np.random.default_rng(11)
    k = torch.from_numpy(np.concatenate([
        rng.integers(0, idx.length, 20000), np.arange(0, idx.length, 1 << e),
        np.arange(idx.nseq), [((idx.nseq + (1 << e) - 1) >> e) << e],
    ]).astype(np.int32))
    args = (dv.rec, dv.C, dv.sa_seq, dv.sa_off)
    want = tdev.sa_lookup_plain(*args, dv.nseq, e, k)
    got = tdev.sa_lookup(*(a.to(cuda) for a in args), dv.nseq, e, k.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _extend_lanes(env, n, seed):
    """Lanes over a MEM batch's flat codes: the interval of the letter at
    j resumed at i = j, a substitution below i or none, some inactive."""
    dv = env["dv"]
    flat, frag_off, _rf = _batch(env, 16)
    rng = np.random.default_rng(seed)
    off = frag_off.numpy()
    f = rng.integers(0, off.shape[0] - 1, n)
    flen = off[f + 1] - off[f]
    keep = flen > 0
    f, flen = f[keep], flen[keep]
    j = (rng.random(f.shape[0]) * flen).astype(np.int64)
    base = off[f]
    c = flat.numpy()[base + j].astype(np.int64)
    C = dv.C.numpy()
    pos = np.where(rng.random(f.shape[0]) < 0.5, -1,
                   (rng.random(f.shape[0]) * np.maximum(j, 1)).astype(np.int64))
    act = rng.random(f.shape[0]) < 0.9
    cols = (base, pos, rng.integers(1, 21, f.shape[0]), j,
            np.where(act, C[c], 0), np.where(act, C[c + 1], 1))
    return (flat, *(torch.from_numpy(np.asarray(a, np.int32)) for a in cols),
            torch.from_numpy(act))


def test_extend_from_kernel_matches_plain(env, cuda):
    """I in its flat form (substitutions, inactive lanes unchanged) and in
    its code-row form."""
    dv = env["dv"]
    lanes = _extend_lanes(env, 30000, 12)
    want = tdev.extend_from_plain(dv.rec, dv.C, *lanes)
    got = tdev.extend_from(dv.rec.to(cuda), dv.C.to(cuda),
                           *(a.to(cuda) for a in lanes))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    act = lanes[-1]
    assert torch.equal(want[0][~act], lanes[4][~act])
    assert (want[0][act] < lanes[4][act]).float().mean() > 0.5
    codes = torch.randint(1, 21, (500, 40), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(13))
    start = torch.full((500,), 40, dtype=torch.int32)
    s0 = torch.zeros(500, dtype=torch.int32)
    s1 = torch.full((500,), dv.rec.shape[0] * 128, dtype=torch.int32)
    s1 = torch.clamp(s1, max=env["idx"].length)
    act = torch.ones(500, dtype=torch.bool)
    want = tdev.extend_rows(dv.rec, dv.C, codes, start, s0, s1, act)
    got = tdev.extend_rows(*(a.to(cuda) for a in (dv.rec, dv.C, codes, start,
                                                  s0, s1, act)))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_extend_all_kernel_matches_plain(env, cuda):
    """J on a MEM batch's fragments as a 0-padded code matrix."""
    dv = env["dv"]
    flat, frag_off, _rf = _batch(env, 16)
    off = frag_off.numpy()
    flen = np.diff(off).astype(np.int32)
    L = int(flen.max()) + 3
    codes = np.zeros((flen.shape[0], L), dtype=np.uint8)
    for t in range(flen.shape[0]):
        codes[t, : flen[t]] = flat.numpy()[off[t]:off[t + 1]]
    codes, flen = torch.from_numpy(codes), torch.from_numpy(flen)
    want = tdev.extend_all_plain(dv.rec, dv.C, codes, flen)
    got = tdev.extend_all(dv.rec.to(cuda), dv.C.to(cuda), codes.to(cuda),
                          flen.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("screened", [False, True])
def test_greedy_map_kernel_matches_plain(env, cuda, screened):
    """K on B's lanes of a Greedy batch (Lmap 7, screened or not): the
    same row set (rows sorted by (f, -j)) and count."""
    dv = env["dv"]
    flat, frag_off, _rf = _batch(env, 16, "greedy")
    ext = (dv.rec, dv.C, *env["seed"], flat, frag_off, search.SEED_K, 6)
    scr = _screen(env, 7, "cpu") if screened else None
    lanes = search.mem_extend_plain(*ext, bloom=scr)
    want, n_want = search.greedy_map_plain(*lanes, frag_off, 7)
    rows, n = search.greedy_map(*(t.to(cuda) for t in lanes),
                                frag_off.to(cuda), 7)
    torch.cuda.synchronize()
    assert int(n) == int(n_want) == want.shape[0] > 100
    got = rows[: int(n)].cpu().numpy()

    def order(r):
        return r[np.lexsort((-r[:, 1], r[:, 0]))]

    np.testing.assert_array_equal(order(got), order(want.numpy()))


# ---------------------------------------------------------------------------
# the coroutine runner of the taxonomy-free tools (engine.batch): A, H, I
# and J at the launch shapes BatchRunner gives them
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runner_calls(env):
    """The arguments of every kernel call of a taxonomy-free Greedy (-e 3)
    and MEM run of BatchRunner on the CPU, by wrapper name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    from kaiju_tpu_torch.engine import batch
    from kaiju_tpu_torch.engine.config import KaijuConfig

    names = ("extend_all", "extend_rows", "update_si", "sa_lookup")
    calls = {n: [] for n in names}
    real = {n: getattr(batch, n) for n in names}

    def spy(name):
        def call(*args):
            calls[name].append(args)
            return real[name](*args)
        return call

    try:
        for n in names:
            setattr(batch, n, spy(n))
        for mode in ("greedy", "mem"):
            cfg = KaijuConfig(mode=mode, taxonomy_free=True,
                              use_Evalue=mode == "greedy")
            batch.BatchRunner(env["idx"], None, cfg, device="cpu") \
                .classify_batch(env["reads"][:120])
    finally:
        for n in names:
            setattr(batch, n, real[n])
    assert all(calls[n] for n in names)
    return calls


def _same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_batch_extend_rows_kernel_matches_plain(runner_calls, cuda):
    """I's code-row form on the runner's ExtendFrom lanes, and on the same
    lanes with inactive ones, lanes from start_i 0 and lanes whose
    interval is empty."""
    for args in runner_calls["extend_rows"][:20]:
        _same(tdev.extend_rows(*(a.to(cuda) for a in args)),
              tdev.extend_rows(*args))
    rec, C, codes, start, s0, s1, act = max(
        runner_calls["extend_rows"], key=lambda a: a[2].shape[0])
    act, start, s1 = act.clone(), start.clone(), s1.clone()
    act[::3] = False
    start[1::5] = 0
    s1[2::7] = s0[2::7]
    args = (rec, C, codes, start, s0, s1, act)
    want = tdev.extend_rows(*args)
    _same(tdev.extend_rows(*(a.to(cuda) for a in args)), want)
    assert torch.equal(want[0][~act], start[~act])


def test_batch_sa_lookup_kernel_matches_plain(env, runner_calls, cuda):
    """H on the runner's SaLookup rounds, on one chunk of max_match_ids + 6
    = 26 positions, and on sampled slots."""
    dv = env["dv"]
    calls = list(runner_calls["sa_lookup"])
    e = dv.chpt_exp
    for k in (torch.arange(1000, 1026, dtype=torch.int32),
              torch.arange(0, env["idx"].length, 1 << e, dtype=torch.int32)):
        calls.append((dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.nseq, e, k))
    for rec, C, sa_seq, sa_off, nseq, chpt, k in calls:
        want = tdev.sa_lookup_plain(rec, C, sa_seq, sa_off, nseq, chpt, k)
        got = tdev.sa_lookup(*(a.to(cuda) for a in (rec, C, sa_seq, sa_off)),
                             nseq, chpt, k.to(cuda))
        _same(got, want)


def test_batch_update_si_kernel_matches_plain(runner_calls, cuda):
    """A on the runner's Probes rounds, and on the largest round with
    empty intervals (s1 = s0) mixed in."""
    for args in runner_calls["update_si"]:
        _same(tdev.update_si(*(a.to(cuda) for a in args)),
              tdev.update_si_plain(*args))
    rec, C, c, s0, s1 = max(runner_calls["update_si"],
                            key=lambda a: a[2].shape[0])
    s1 = s1.clone()
    s1[::2] = s0[::2]
    want = tdev.update_si_plain(rec, C, c, s0, s1)
    _same(tdev.update_si(*(a.to(cuda) for a in (rec, C, c, s0, s1))), want)
    assert not want[2][::2].any()


def test_batch_extend_all_kernel_matches_plain(runner_calls, cuda):
    """J on each length-bucket group of the runner's warm-up: [F, Lmax]
    codes, exact sizes."""
    for args in runner_calls["extend_all"]:
        _same(tdev.extend_all(*(a.to(cuda) for a in args)),
              tdev.extend_all_plain(*args))
    assert len(runner_calls["extend_all"]) > 1  # several buckets


@pytest.mark.parametrize("mode", ["mem", "greedy"])
def test_batch_runner_on_the_card_matches_cpu(env, cuda, mode):
    """BatchRunner's taxonomy-free lines on the card equal its lines on
    the CPU (the plain versions)."""
    from kaiju_tpu_torch.engine.batch import BatchRunner
    from kaiju_tpu_torch.engine.config import KaijuConfig

    cfg = KaijuConfig(mode=mode, taxonomy_free=True,
                      use_Evalue=mode == "greedy")
    reads = env["reads"][:200]
    want = BatchRunner(env["idx"], None, cfg, device="cpu") \
        .classify_to_lines(reads)
    got = BatchRunner(env["idx"], None, cfg).classify_to_lines(reads)
    assert got == want
    assert sum(ln.startswith("C") for ln in want) > 50


# ---------------------------------------------------------------------------
# P1, P2 (gather_rows, gather_sum) and the sharded instantiations (K16)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 33, 1000, 4099])
def test_gather_kernels_match_plain(cuda, n):
    """P1 and P2 on random rows (sums that wrap int32), for N not a
    multiple of 32 or of the rows a warp takes; an index outside the table
    raises before a launch."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.ops import gather

    rng = np.random.default_rng(n)
    tab = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (3000, 128),
                                        dtype=np.int32))
    idx = torch.from_numpy(rng.integers(0, 3000, n).astype(np.int32))
    for fn, plain in ((gather.gather_rows, gather.gather_rows_plain),
                      (gather.gather_sum, gather.gather_sum_plain)):
        got = fn(tab.to(cuda), idx.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), plain(tab, idx))
    kernels.reset_counts()
    for bad in (-1, 3000):
        with pytest.raises(IndexError):
            gather.gather_rows(tab.to(cuda), torch.tensor(
                [0, bad], dtype=torch.int32, device=cuda))
    assert kernels.LAUNCHES["gather_rows"] == 0


@pytest.mark.parametrize("S", [1, 2, 3])
def test_sharded_kernels_match_unsharded(env, cuda, S):
    """A, J, H, B (screened, stopping the narrow lanes), G and D launched on
    the index in S shards (S = 3 leaves a padded last shard) equal their
    unsharded launches on the same inputs; only the sharded kernels
    launch."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.parallel.sharded_index import (ShardedIndex,
                                                        sharded_extend_all,
                                                        sharded_sa_lookup)

    idx = env["idx"]
    dv = tdev.DeviceIndex(idx, cuda)
    sh = ShardedIndex(idx, S, cuda)
    flat, frag_off, rf_rows = (t.to(cuda) for t in _batch(env, 16))
    seed = tuple(a.to(cuda) for a in env["seed"])
    rng = np.random.default_rng(S)
    k = torch.from_numpy(rng.integers(0, idx.length, 5000).astype(np.int32))
    c = torch.from_numpy(rng.integers(1, idx.alen, 5000).astype(np.int32))
    s1 = torch.clamp(k + 200, max=idx.length)
    off = frag_off.cpu().numpy()
    flen = np.diff(off).astype(np.int32)
    codes = np.zeros((flen.shape[0], int(flen.max())), dtype=np.uint8)
    for t in range(flen.shape[0]):
        codes[t, :flen[t]] = flat.cpu().numpy()[off[t]:off[t + 1]]
    codes = torch.from_numpy(codes).to(cuda)
    flen = torch.from_numpy(flen).to(cuda)
    scr = _screen(env, MIN_LEN, cuda)
    K, sw_len = search.SEED_K, search.SEED_K + hybrid.S1_STEPS
    tax = (dv.seq_tax, env["par"].to(cuda), env["dep"].to(cuda), 32, CAP,
           dv.nseq, dv.chpt_exp)

    def run(ix, sharded):
        kernels.reset_counts()
        k_ = k.to(cuda)
        out = {
            "A": tdev.update_si(ix.rec, ix.C, c.to(cuda), k_, s1.to(cuda)),
            "J": (sharded_extend_all(ix, codes, flen) if sharded else
                  tdev.extend_all(ix.rec, ix.C, codes, flen)),
            "H": (sharded_sa_lookup(ix, k_) if sharded else tdev.sa_lookup(
                ix.rec, ix.C, ix.sa_seq, ix.sa_off, ix.nseq, ix.chpt_exp,
                k_)),
        }
        lanes = search.mem_extend(ix.rec, ix.C, *seed, flat, frag_off, K,
                                  MIN_LEN - 1, bloom=scr,
                                  sw_steps=hybrid.S1_STEPS)
        g = hybrid.text_extend(*lanes, flat, frag_off, sw_len, ix.text,
                               ix.rank_start, ix.rec, ix.C, ix.sa_seq,
                               ix.sa_off, ix.nseq, ix.chpt_exp)
        stats = search.mem_stats(*g[:3], frag_off, MIN_LEN, T)
        out["B"], out["G"] = lanes, g
        out["D"] = classify.read_lca(*stats[:2], *stats[3:], rf_rows, ix.rec,
                                     ix.C, ix.sa_seq, ix.sa_off, *tax,
                                     sw_ids=g[3])
        torch.cuda.synchronize()
        return out, dict(kernels.LAUNCHES)

    want, flat_counts = run(dv, False)
    got, counts = run(sh, True)
    for name, w in want.items():
        w = w if isinstance(w, tuple) else (w,)
        g = got[name] if isinstance(got[name], tuple) else (got[name],)
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b.cpu()), name
    index_kernels = ("update_si", "extend_all", "sa_lookup", "mem_extend",
                     "text_extend", "read_lca")
    for name in index_kernels:
        assert flat_counts[name] == 1 and counts[name] == 0, name
        assert counts[name + "_sharded"] == 1, name
    assert hybrid.switched(*want["B"], frag_off, sw_len).sum() > 50


@pytest.mark.parametrize("S", [1, 2, 3])
def test_sharded_greedy_kernels_match_unsharded(env, cuda, S):
    """E with its last level's hybrid and F with the virtual rows (K16f)
    launched on the index in S shards (S = 3 leaves a padded last shard)
    equal their unsharded launches on the same inputs and the plain
    versions on the same shards on the CPU; only the sharded kernels
    launch."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    idx = env["idx"]
    (rec, C, seed, flat, frag_off, rf_rows, _sa_seq, _sa_off, _seq_tax, par,
     dep, tables, K, lmap, mfl, min_score, e, T, R, cap, nseq, chpt_exp,
     vc) = _greedy_args(env, env["reads"], 3, cuda)
    lanes = search.mem_extend(rec, C, *seed, flat, frag_off, K, lmap - 1,
                              bloom=_screen(env, lmap, cuda))

    def run(ix, dev):
        kernels.reset_counts()
        found = greedy.greedy_search(
            *(_to(a, dev) for a in (*lanes, flat, frag_off, rf_rows)),
            ix.rec, ix.C, tuple(t.to(dev) for t in tables), lmap, mfl,
            min_score, e, T, vc, hyb=(ix.text, ix.rank_start, ix.sa_seq,
                                      ix.sa_off, nseq, chpt_exp))
        tail = classify.ranges_lca(found[2], found[3], ix.rec, ix.C,
                                   ix.sa_seq, ix.sa_off, ix.seq_tax,
                                   par.to(dev), dep.to(dev), R, cap, nseq,
                                   chpt_exp, sw_ids=found[4])
        if dev != "cpu":
            torch.cuda.synchronize()
        return [t.cpu() for t in (*found, *tail)], dict(kernels.LAUNCHES)

    want, flat_counts = run(tdev.DeviceIndex(idx, cuda), cuda)
    got, counts = run(ShardedIndex(idx, S, cuda), cuda)
    plain, _c = run(ShardedIndex(idx, S, "cpu"), "cpu")
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w) and torch.equal(g, p)
    for name in ("greedy_search", "ranges_lca"):
        assert flat_counts[name] == 1 and counts[name] == 0, name
        assert counts[name + "_sharded"] == 1, name
    assert (want[2] >= hybrid.VBASE).any()  # virtual tie rows exercised


@pytest.fixture(scope="module")
def big_dbs():
    """Two toy databases of the big-index layout (K17): one whose last
    shard is full at S = 2 (N = 128 x 2 x 196), one that leaves it
    padded."""
    from kaiju_tpu_torch.parallel.big_index import build_db

    return {"full": build_db(None, 50_000, 2, 25, True),
            "padded": build_db(None, 300_000, 2, 13, True)}


@pytest.mark.parametrize("name,S", [("padded", 1), ("padded", 3),
                                    ("full", 2)])
def test_big_kernels_match_plain(big_dbs, cuda, tmp_path, name, S):
    """L (big_extend_all) and M (big_sa_walk) on the card equal their plain
    versions on the CPU on every lane, with reads shorter than L, a code 0
    inside a read and lanes at k = N on a full last shard; each launches
    once a call."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.ops import big_mem
    from kaiju_tpu_torch.parallel.big_index import BigIndex, save_sharded_ktx
    from kaiju_tpu_torch.tools.big_classify import make_reads

    db = big_dbs[name]
    save_sharded_ktx(None, db, str(tmp_path), S)
    gpu, cpu = (BigIndex.load(str(tmp_path), d) for d in (cuda, "cpu"))
    reads = make_reads(db, 64, 40)[0]
    reads[0, 20:] = 0
    reads[1, 7] = 0
    reads[2] = 20
    codes = torch.from_numpy(reads)
    kernels.reset_counts()
    got = big_mem.big_extend_all(gpu, codes.to(cuda))
    kf = torch.where(got[2] > got[1], got[1], -1).reshape(-1)
    ids = big_mem.big_sa_walk(gpu, kf)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["big_extend_all"] == 1
    assert kernels.LAUNCHES["big_sa_walk"] == 1
    want = big_mem.big_extend_all_plain(cpu, codes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    want_ids = big_mem.big_sa_walk_plain(cpu, kf.cpu())
    assert torch.equal(ids.cpu(), want_ids)
    assert (want_ids >= 0).sum() > 1000
    if name == "full":
        assert (want[2] == db["N"]).any()  # intervals that end at k = N
    with pytest.raises(TypeError):
        big_mem.big_sa_walk(gpu, kf.int())
    with pytest.raises(TypeError):
        big_mem.big_extend_all(gpu, codes.to(cuda).int())


# ---------------------------------------------------------------------------
# edge cases of B's block lists and E's shared-memory views and windows,
# on hand-laid batches, on the flat index (S = 0) and in S shards
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def edge_env():
    """A small index with homopolymer runs and a shared gene, its seed and
    scoring tables, and the letter codes of its alphabet."""
    rng = random.Random(5)
    base = "".join(rng.choice(AA) for _ in range(150))
    records = [(f"ACC{i:04d}.1_{[101, 102, 201, 100][i % 4]}",
                "".join(rng.choice(AA) for _ in range(rng.randint(40, 300))))
               for i in range(40)]
    records += [("HOMO1.1_101", "A" * 400), ("HOMO2.1_201", "G" * 60 + "A" * 300),
                ("BASE1.1_102", base), ("BASE2.1_201", base[:90] + "W" + base[91:])]
    idx = py_builder.build_index(records)
    kt = KmerTables.build(idx, search.SEED_K)
    tables = greedy.greedy_scoring_tables(idx.alphabet, trans_table(idx.alphabet))
    par, dep = Taxonomy(NODES).dense_arrays()
    return {"idx": idx, "records": [s for _, s in records], "base": base,
            "trans": trans_table(idx.alphabet), "dv": tdev.DeviceIndex(idx, "cpu"),
            "seed": tuple(torch.from_numpy(a) for a in kt.planar_seed(search.SEED_K)),
            "tables": tuple(torch.from_numpy(a) for a in tables),
            "par": torch.from_numpy(par), "dep": torch.from_numpy(dep)}


def _edge_index(env, S, dev):
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    return (tdev.DeviceIndex(env["idx"], dev) if S == 0
            else ShardedIndex(env["idx"], S, dev))


def _layout(env, frags):
    """flat uint8 codes and frag_off int32 of protein fragments (any may be
    empty)."""
    codes = [np.array([env["trans"][ord(ch)] for ch in f], dtype=np.uint8)
             for f in frags]
    flat = np.concatenate(codes) if codes else np.zeros(0, np.uint8)
    off = np.zeros(len(frags) + 1, dtype=np.int32)
    off[1:] = np.cumsum([len(f) for f in frags])
    return torch.from_numpy(flat.astype(np.uint8)), torch.from_numpy(off)


def _piece(env, rng, n, mutate=0):
    """n letters cut from the DB's records (random letters past their
    length), with `mutate` point substitutions."""
    out = ""
    while len(out) < n:
        s = rng.choice(env["records"])
        st = rng.randrange(0, len(s))
        out += s[st:st + n - len(out)]
    out = list(out)
    for _ in range(mutate):
        out[rng.randrange(n)] = rng.choice(AA)
    return "".join(out)


def _edge_fragments(env, case):
    rng = random.Random(case)
    if case == "long":  # one homopolymer extension among thousands of lanes
        frags = [_piece(env, rng, rng.randint(0, 20)) for _ in range(3000)]
        frags.insert(1500, "A" * 300)
    elif case == "edges":  # starts on warp and block edges; P = 4,680
        frags = [_piece(env, rng, n) for n in
                 (32, 32, 192, 768, 1024, 1, 31, 33, 255, 257, 1023, 1025, 7)]
    else:  # "empty": empty fragments, 600 in one block (past its staging)
        frags = []
        for t in range(200):
            frags += [""] * (600 if t == 100 else rng.randint(0, 2))
            frags.append(_piece(env, rng, rng.randint(5, 40)))
    return frags


@pytest.mark.parametrize("S", [0, 1, 2, 3])
@pytest.mark.parametrize("case", ["long", "edges", "empty", "screened"])
def test_mem_extend_edge_batches_match_plain(edge_env, cuda, case, S):
    """B against its plain version on the flat index, with and without the
    hybrid's stop: one 300-step homopolymer lane among 3,000 short
    fragments; fragment starts on warp and block edges with P not a
    multiple of a block; empty fragments, 600 of them inside one block;
    and a screen that drops every lane."""
    env = edge_env
    dv = env["dv"]
    flat, frag_off = _layout(env, _edge_fragments(
        env, "long" if case == "screened" else case))
    ix = _edge_index(env, S, cuda)
    seed = tuple(a.to(cuda) for a in env["seed"])
    lb = bloom.bloom_lb(env["idx"].length)
    words = torch.zeros(1 << (lb - 5), dtype=torch.int32)
    for j0, sw in ((MIN_LEN - 1, 0), (6, hybrid.S1_STEPS)):
        scr = (words, 7, lb) if case == "screened" else None
        want = search.mem_extend_plain(dv.rec, dv.C, *env["seed"], flat,
                                       frag_off, search.SEED_K, j0, bloom=scr,
                                       sw_steps=sw)
        got = search.mem_extend(
            ix.rec, ix.C, *seed, flat.to(cuda), frag_off.to(cuda),
            search.SEED_K, j0, sw_steps=sw,
            bloom=None if scr is None else (words.to(cuda), 7, lb))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (case, S, j0)
        pos, _f, base, _n = search._lane_fragments(frag_off, flat.shape[0])
        if case == "screened":
            assert torch.equal(want[0], pos - base + 1)  # nothing evaluated
        elif case == "long" and sw == 0:
            assert int((pos - base - want[0]).max()) > 250  # the long chain


def _edge_reads(env, case):
    """(fragments, rf_rows) of Greedy reads: "long" has a read of 640
    positions (past E's shared-memory views) among short ones; "variants"
    has reads of mutated pieces, whose many planned nodes make levels of
    many sources: eight of 150 letters (1,200 positions, more than 32
    sources), four of 120 (480 positions, in the views, more than 16), and
    short ones between."""
    rng = random.Random(case)
    reads = []
    for r in range(300):
        if case == "long" and r % 50 == 0:
            reads.append([_piece(env, rng, 80, 2) for _ in range(8)])
        elif case == "long" or r % 3 == 2:
            reads.append([_piece(env, rng, rng.randint(8, 40), 1)
                          for _ in range(rng.randint(0, 6))])
        elif r % 3 == 0:
            reads.append([_piece(env, rng, 150, 15) for _ in range(8)])
        else:
            reads.append([_piece(env, rng, 120, 12) for _ in range(4)])
    frags, rows = [], np.full((len(reads), 8), -1, dtype=np.int32)
    for r, fr in enumerate(reads):
        for t, f in enumerate(fr):
            rows[r, t] = len(frags)
            frags.append(f)
    return frags, torch.from_numpy(rows)


@pytest.mark.parametrize("S", [0, 1, 2, 3])
@pytest.mark.parametrize("case,vcap", [("long", greedy.VCAP),
                                       ("variants", greedy.VCAP),
                                       ("variants", 8)])
@pytest.mark.parametrize("hyb", [False, True])
def test_greedy_search_edge_reads_match_plain(edge_env, cuda, case, vcap,
                                              hyb, S):
    """E against its plain version at -e 3: a read too long for its
    shared-memory views, which takes the global scratch path; levels with
    more than 32 sources (more than one window of variants); and with vcap
    8 reads that outgrow their scratch (FLAG_SCRATCH, a zero row), with
    and without the last level's hybrid (whose ids then go through windows
    of vcap variants)."""
    env = edge_env
    dv = env["dv"]
    frags, rf_rows = _edge_reads(env, case)
    flat, frag_off = _layout(env, frags)
    lanes = search.mem_extend_plain(dv.rec, dv.C, *env["seed"], flat,
                                    frag_off, search.SEED_K, 6)
    e_args = (7, MIN_LEN, 65, 3, 20, vcap)
    want = greedy.greedy_search_plain(
        *lanes, flat, frag_off, rf_rows, dv.rec, dv.C, env["tables"],
        *e_args, hyb=(dv.text, dv.rank_start, dv.sa_seq, dv.sa_off, dv.nseq,
                      dv.chpt_exp) if hyb else None)
    ix = _edge_index(env, S, cuda)
    got = greedy.greedy_search(
        *(t.to(cuda) for t in (*lanes, flat, frag_off, rf_rows)), ix.rec,
        ix.C, tuple(t.to(cuda) for t in env["tables"]), *e_args,
        hyb=(ix.text, ix.rank_start, ix.sa_seq, ix.sa_off, dv.nseq,
             dv.chpt_exp) if hyb else None)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g.cpu(), w)
    flags = want[1]
    assert (want[0] > 0).sum() > 20
    if vcap == 8:
        over = (flags & greedy.FLAG_SCRATCH) > 0
        assert over.any() and not want[2][over].any()
    elif case == "variants":  # levels of more than 32 and more than 16
        for cap, reads in ((32, slice(0, None, 3)), (16, slice(1, None, 3))):
            few = greedy.greedy_search_plain(
                *lanes, flat, frag_off, rf_rows, dv.rec, dv.C,
                env["tables"], *e_args[:-1], cap)
            assert (few[1][reads] & greedy.FLAG_SCRATCH).any(), cap
