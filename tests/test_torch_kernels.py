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


def _j_matrix(env, frags):
    """codes uint8 [F, L] (0-padded) and flen int32 [F] of fragments."""
    L = max([len(f) for f in frags], default=0)
    codes = np.zeros((len(frags), L), dtype=np.uint8)
    for t, f in enumerate(frags):
        codes[t, :len(f)] = [env["trans"][ord(ch)] for ch in f]
    return codes, np.array([len(f) for f in frags], dtype=np.int32)


def _j_case(env, case):
    """J's corner cases as (codes, flen)."""
    rng = random.Random(case)
    if case == "long":  # fragments longer than a tile (64 lanes)
        frags = [_piece(env, rng, n) for n in (63, 64, 65, 127, 128, 129,
                                               200, 300)]
        frags += ["A" * 300, env["base"],
                  env["base"][:90] + "W" + env["base"][91:]]
        frags += [_piece(env, rng, rng.randint(1, 30)) for _ in range(40)]
    elif case == "exact":  # DB substrings and repeated letters: lanes merge
        frags = [_piece(env, rng, rng.randint(1, 64)) for _ in range(300)]
        frags += ["A" * 1, "A" * 17, "A" * 64, "G" * 60 + "A" * 4,
                  env["base"][10:40] * 2]
        frags += [_piece(env, rng, 40, mutate=2) for _ in range(50)]
    elif case == "many":  # more fragments than a block takes (64)
        frags = [_piece(env, rng, rng.randint(0, 12)) for _ in range(60_000)]
    else:  # "edges": flen 0 over letters, flen past L or below 0, letter 0
        frags = [_piece(env, rng, rng.randint(1, 50)) for _ in range(200)]
    rng.shuffle(frags)
    codes, flen = _j_matrix(env, frags)
    if case == "edges":
        codes[:, 5] = np.where(np.arange(len(frags)) % 3 == 0, 0, codes[:, 5])
        flen[:10] = 0
        flen[10:20] = codes.shape[1] + 7
        flen[20:25] = -3
    return torch.from_numpy(codes), torch.from_numpy(flen)


@pytest.mark.parametrize("S", [0, 2, 4])
@pytest.mark.parametrize("case", ["long", "exact", "edges", "many", "empty"])
def test_extend_all_corner_cases_match_plain(edge_env, cuda, case, S):
    """J on fragments longer than a tile, on exact DB substrings and
    repeated letters (lanes merge into a neighbour's trajectory, most end
    at i = 0), on flen 0, past L and below 0 and a letter 0 inside, on
    60,000 short fragments, and on F * L = 0; flat (S = 0) and in S
    shards, one launch a call."""
    from kaiju_tpu_torch import kernels

    dv = edge_env["dv"]
    ix = _edge_index(edge_env, S, cuda)
    name = "extend_all" + ("_sharded" if S else "")
    shapes = ([(0, 10), (5, 0)] if case == "empty" else [None])
    for shape in shapes:
        if shape is None:
            codes, flen = _j_case(edge_env, case)
        else:
            codes = torch.zeros(shape, dtype=torch.uint8)
            flen = torch.full((shape[0],), shape[1], dtype=torch.int32)
        want = tdev.extend_all_plain(dv.rec, dv.C, codes, flen)
        kernels.reset_counts()
        got = tdev.extend_all(ix.rec, ix.C, codes.to(cuda), flen.to(cuda))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == int(codes.numel() > 0)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert torch.equal(g.cpu(), w)
        if case == "exact":
            j = torch.arange(codes.shape[1])
            valid = j < flen[:, None]
            assert (want[0][valid] == 0).float().mean() > 0.5


def _i_lanes(env, case):
    """I's corner cases: lanes resumed at start_i = j inside fragments of
    DB pieces from the interval of the letter at j; (flat, base, pos,
    sub, start_i, s0, s1, act).  2,037 lanes: the last warp partly
    filled."""
    rng = random.Random(case)
    nrng = np.random.default_rng(len(case))
    if case == "mixed":  # chains of 0 to ~300 steps in one launch
        frags = ["A" * 300, env["base"]]
        frags += [_piece(env, rng, rng.randint(1, 150)) for _ in range(200)]
        frags += ["".join(rng.choice(AA) for _ in range(30))
                  for _ in range(200)]
    else:
        frags = [_piece(env, rng, rng.randint(1, 80), mutate=rng.randint(0, 2))
                 for _ in range(400)]
    flat, off = _layout(env, frags)
    off = off.numpy()
    flen = np.diff(off)
    n = 2037
    f = nrng.choice(np.flatnonzero(flen > 0), n)
    j = (nrng.random(n) * flen[f]).astype(np.int64)
    if case == "mixed":
        j = np.where(nrng.random(n) < 0.5, flen[f] - 1, j)
    if case == "zero":  # lanes at i = 0
        j[::2] = 0
    c = flat.numpy()[off[f] + j].astype(np.int64)
    C = env["dv"].C.numpy()
    if case == "none":
        pos = np.full(n, -1)
    elif case == "first":  # the substitution at the first step
        pos = j - 1
    else:
        pos = np.where(nrng.random(n) < 0.5, -1,
                       (nrng.random(n) * j).astype(np.int64))
    act = (nrng.random(n) < 0.5 if case == "inactive"
           else np.ones(n, dtype=bool))
    cols = (off[f], pos, nrng.integers(1, 21, n), j, C[c], C[c + 1])
    return (flat, *(torch.from_numpy(np.asarray(a, np.int32)) for a in cols),
            torch.from_numpy(act))


@pytest.mark.parametrize("case", ["first", "none", "inactive", "zero",
                                  "mixed"])
def test_extend_from_corner_cases_match_plain(edge_env, cuda, case):
    """I on pos = start_i - 1, pos = -1, inactive lanes, lanes at i = 0
    and lanes whose chains run from 0 to ~300 steps in one launch, in its
    flat form and in its code-row form (each lane's codes with its
    substitution), one launch a call."""
    from kaiju_tpu_torch import kernels

    dv = edge_env["dv"]
    lanes = _i_lanes(edge_env, case)
    want = tdev.extend_from_plain(dv.rec, dv.C, *lanes)
    kernels.reset_counts()
    got = tdev.extend_from(dv.rec.to(cuda), dv.C.to(cuda),
                           *(a.to(cuda) for a in lanes))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["extend_from"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    flat, base, pos, sub, start, s0, s1, act = lanes
    steps = start - want[0]
    assert torch.equal(want[0][~act], start[~act])
    if case == "mixed":
        assert int(steps.max()) >= 100 and int((steps[act] == 0).sum()) > 0
    L = max(int(start.max()), 1)
    x = torch.arange(L, dtype=torch.int32)
    codes = flat[torch.clamp(base[:, None] + x, max=flat.shape[0] - 1).long()]
    codes = torch.where(x == pos[:, None], sub[:, None].to(torch.uint8), codes)
    rows = tdev.extend_rows(*(a.to(cuda) for a in (
        dv.rec, dv.C, codes.contiguous(), start, s0, s1, act)))
    torch.cuda.synchronize()
    for g, w in zip(rows, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("screened", [False, True])
def test_greedy_map_kernel_matches_plain(env, cuda, screened):
    """K on B's lanes of a Greedy batch (Lmap 7, screened or not): the
    same row set (rows sorted by (f, -j)) and count, and the same rows
    row for row (both ascend in (f, j))."""
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
    np.testing.assert_array_equal(got, want.numpy())


K_CASES = ["one", "long", "empty", "none", "all", "jstop_last", "no_jstop",
           "many", "order"]


def k_corner(case):
    """Kernel K's argument tuples (i, s0, s1, frag_off, lmap), CPU int32,
    for a corner case, made with numpy from a seed: one fragment (the
    lazy launch); fragments past the kernel's 64 positions in registers
    (200-400); empty fragments (first, last and between); no row (n = 0);
    every lane at or past jstop emitting (lmap = 1); jstop at each
    fragment's last position; jstop = -1 (no lane reaches i <= 1); 60,000
    fragments of 0-12 positions; and, for the kernel's row order across
    blocks and launches, 5,000 fragments of 1-100 positions, then 100,
    then the 5,000 again (three tuples).  A lane j of a fragment has a
    match of length L in 0..j+1 and i = j - L + 1, as B gives it, except
    where the case fixes i."""
    rng = np.random.default_rng(K_CASES.index(case) + 160)
    lmap = 7
    if case == "one":
        flen = [45]
    elif case == "long":
        flen = rng.integers(200, 401, 50)
    elif case == "empty":
        flen = np.where(rng.random(300) < 0.4, 0, rng.integers(1, 90, 300))
        flen[[0, 1, -1]] = 0
    elif case == "many":
        flen = rng.integers(0, 13, 60_000)
    elif case == "order":
        flen = rng.integers(1, 101, 5_000)
    else:
        flen = rng.integers(1, 120, 400)
    flen = np.asarray(flen, dtype=np.int64)
    off = np.zeros(flen.shape[0] + 1, dtype=np.int64)
    off[1:] = np.cumsum(flen)
    j = np.arange(off[-1]) - np.repeat(off[:-1], flen)
    i = j - (rng.random(j.shape[0]) * (j + 2)).astype(np.int64) + 1
    if case == "none":
        lmap = 1_000
    elif case == "all":  # jstop = 1, every later lane of length >= 1
        lmap = 1
        i = np.where(j < 2, j, 2)
    elif case == "jstop_last":
        i = np.maximum(i, 2)
        i[off[1:][flen > 0] - 1] = 0
    elif case == "no_jstop":
        i = np.maximum(i, 2)
    s0 = rng.integers(0, 1 << 30, j.shape[0])
    s1 = s0 + rng.integers(1, 50, j.shape[0])

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32))

    args = (t(i), t(s0), t(s1), t(off), lmap)
    if case != "order":
        return [args]
    a2 = (*(x[: off[100]] for x in args[:3]), t(off[:101]), lmap)
    return [args, a2, args]


@pytest.mark.parametrize("case", K_CASES)
def test_greedy_map_corner_cases_match_plain(cuda, case):
    """K on its corners (k_corner), one launch a call: the count and the
    rows equal the plain version's row for row, in ascending (f, j)."""
    from kaiju_tpu_torch import kernels

    for args in k_corner(case):
        want, n_want = search.greedy_map_plain(*args)
        kernels.reset_counts()
        rows, n = search.greedy_map(*(a.to(cuda) for a in args[:4]),
                                    args[4])
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["greedy_map"] == 1
        assert int(n) == int(n_want) == want.shape[0]
        assert torch.equal(rows[: int(n)].cpu(), want)
        if case == "none":
            assert int(n) == 0
        elif case == "all":  # a lane of one position makes its row too
            flen = args[3][1:] - args[3][:-1]
            assert int(n) == int((flen - 1).clamp(min=1).sum())
        elif case != "empty":
            assert int(n) > 0


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


# ---------------------------------------------------------------------------
# the cards of one process: launches on the tensors' card, peer access,
# shards read in place from another card (--mesh-index over cards)
# ---------------------------------------------------------------------------


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (a kernel on one card reading "
                    "shards of the other)")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_launch_goes_to_the_card_of_its_tensors(env, two_cards):
    """Every library's runtime takes the card of PyTorch's device guard as
    current (kt_device), so a launch with tensors on cuda:1 while cuda:0
    is current runs on cuda:1, equal to the plain version; tensors on two
    cards raise, in the wrapper's checks and in kernels.launch."""
    from kaiju_tpu_torch import kernels

    c0, c1 = two_cards
    for src in kernels.SOURCES:
        for card in (c1, c0):
            with torch.cuda.device(card):
                assert kernels.library_device(src) == card.index, src
    dv = env["dv"]
    rng = np.random.default_rng(5)
    n = 5000
    c = torch.from_numpy(rng.integers(1, env["idx"].alen, n).astype(np.int32))
    s0 = torch.from_numpy(rng.integers(0, env["idx"].length, n)
                          .astype(np.int32))
    s1 = torch.clamp(s0 + 300, max=env["idx"].length)
    want = tdev.update_si_plain(dv.rec, dv.C, c, s0, s1)
    with torch.cuda.device(c0):
        got = tdev.update_si(*(t.to(c1) for t in (dv.rec, dv.C, c, s0, s1)))
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(c1)
    for g, w in zip(got, want):
        assert g.device == c1 and torch.equal(g.cpu(), w)
    on1 = [t.to(c1) for t in (dv.rec, dv.C, s0, s1)]
    with pytest.raises(ValueError, match="c: on cuda:0, expected cuda:1"):
        tdev.update_si(on1[0], on1[1], c.to(c0), on1[2], on1[3])
    out = [torch.empty(n, dtype=dt, device=c1)
           for dt in (torch.int32, torch.int32, torch.bool)]
    before = kernels.LAUNCHES["update_si"]
    with pytest.raises(ValueError, match="kt_update_si: tensor arguments on "
                       "cuda:1 and cuda:0"):
        kernels.launch("update_si", on1[0], on1[0].shape[0], on1[1],
                       c.to(c0), on1[2], on1[3], n, *out)
    assert kernels.LAUNCHES["update_si"] == before


def test_peer_enable_between_two_cards(two_cards):
    """kt_peer_enable: both ways, again (already enabled counts as
    success), the caller's current card restored; Shards read on cuda:0
    accept a part on cuda:1 placed there for a peer read, and the plain
    versions refuse it."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.parallel import peer_shards

    c0, c1 = two_cards
    lib = peer_shards._peer_lib()
    with torch.cuda.device(c1):
        for reader, holder in ((0, 1), (1, 0), (0, 1)):
            assert lib.kt_peer_enable(reader, holder) == 0
            assert kernels.library_device("peer") == 1
            assert torch.cuda.current_device() == 1
    peer_shards.enable_peer(c0, c1)
    tab = torch.arange(4096 * 128, dtype=torch.int32, device=c1).view(4096,
                                                                      128)
    idx = torch.tensor([5, 4095, 0, 77], dtype=torch.int32, device=c0)
    sh = tdev.Shards([tab[:2048].to(c0), tab[2048:].clone()], 2048, 4096,
                     c0, peer=[1])
    sh.check("tab", torch.int32, c0, 2048)
    with pytest.raises(ValueError, match="shard 1 lies on cuda:1"):
        sh[idx]
    alone = tdev.Shards(sh.parts, 2048, 4096, c0)
    with pytest.raises(ValueError, match="on cuda:1, expected cuda:0"):
        alone.check("tab", torch.int32, c0, 2048)


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_kernels_read_shards_of_another_card(env, two_cards, S):
    """The index in S shards over two cards (ShardedIndex.on_cards): card
    0's view holds the even shards and reads the odd ones in place on
    cuda:1.  J, H, B (screened), G, C, D and E, F launched there equal
    their launches on the same index with every shard copied to cuda:0;
    only the sharded kernels launch."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.parallel.sharded_index import (ShardedIndex,
                                                        sharded_extend_all,
                                                        sharded_sa_lookup)

    c0, c1 = two_cards
    idx = env["idx"]
    view = ShardedIndex.on_cards(idx, S, [c0, c1])[0]
    assert view.layout()["reads"] == {o: 1 for o in range(1, S, 2)}
    assert all(view.rec.parts[o].device == c1 for o in view.reads)
    local = ShardedIndex(idx, S, c0)
    flat, frag_off, rf_rows = (t.to(c0) for t in _batch(env, 16))
    seed = tuple(a.to(c0) for a in env["seed"])
    off = frag_off.cpu().numpy()
    flen = np.diff(off).astype(np.int32)
    codes = np.zeros((flen.shape[0], int(flen.max())), dtype=np.uint8)
    for t in range(flen.shape[0]):
        codes[t, :flen[t]] = flat.cpu().numpy()[off[t]:off[t + 1]]
    codes = torch.from_numpy(codes).to(c0)
    flen = torch.from_numpy(flen).to(c0)
    scr = _screen(env, MIN_LEN, c0)
    K, sw_len = search.SEED_K, search.SEED_K + hybrid.S1_STEPS
    (_rec, _C, _seed, gflat, gfrag_off, grf_rows, _sq, _so, _st, par, dep,
     tables, _K, lmap, mfl, min_score, e, T_, R, cap, nseq, chpt_exp,
     vc) = _greedy_args(env, env["reads"], 3, c0)

    def run(ix):
        kernels.reset_counts()
        out = {"J": sharded_extend_all(ix, codes, flen)}
        out["H"] = sharded_sa_lookup(ix, out["J"][1][out["J"][2]
                                                     > out["J"][1]])
        lanes = search.mem_extend(ix.rec, ix.C, *seed, flat, frag_off, K,
                                  MIN_LEN - 1, bloom=scr,
                                  sw_steps=hybrid.S1_STEPS)
        g = hybrid.text_extend(*lanes, flat, frag_off, sw_len, ix.text,
                               ix.rank_start, ix.rec, ix.C, ix.sa_seq,
                               ix.sa_off, ix.nseq, ix.chpt_exp)
        stats = search.mem_stats(*g[:3], frag_off, MIN_LEN, T)
        out["B"], out["G"] = lanes, g
        out["D"] = classify.read_lca(
            *stats[:2], *stats[3:], rf_rows, ix.rec, ix.C, ix.sa_seq,
            ix.sa_off, ix.seq_tax, par, dep, 32, CAP, ix.nseq, ix.chpt_exp,
            sw_ids=g[3])
        glanes = search.mem_extend(ix.rec, ix.C, *seed, gflat, gfrag_off, K,
                                   lmap - 1, bloom=_screen(env, lmap, c0))
        found = greedy.greedy_search(
            *glanes, gflat, gfrag_off, grf_rows, ix.rec, ix.C, tables, lmap,
            mfl, min_score, e, T_, vc, hyb=(ix.text, ix.rank_start,
                                            ix.sa_seq, ix.sa_off, nseq,
                                            chpt_exp))
        out["E"] = found
        out["F"] = classify.ranges_lca(found[2], found[3], ix.rec, ix.C,
                                       ix.sa_seq, ix.sa_off, ix.seq_tax, par,
                                       dep, R, cap, nseq, chpt_exp,
                                       sw_ids=found[4])
        torch.cuda.synchronize(c0)
        torch.cuda.synchronize(c1)
        return out, dict(kernels.LAUNCHES)

    got, counts = run(view)
    want, _c = run(local)
    for name, w in want.items():
        w = w if isinstance(w, tuple) else (w,)
        g = got[name] if isinstance(got[name], tuple) else (got[name],)
        for a, b in zip(g, w):
            if b is None:
                assert a is None, name
                continue
            assert a.device == c0 and torch.equal(a.cpu(), b.cpu()), name
    for name in ("extend_all", "sa_lookup", "mem_extend", "text_extend",
                 "read_lca", "greedy_search", "ranges_lca"):
        assert counts[name] == 0 and counts[name + "_sharded"] >= 1, name
    assert got["H"][0].numel() > 100


@pytest.fixture(scope="module")
def nccl_pair(tmp_path_factory):
    """Two processes of tests/torch_exchange_worker.py on cuda:0 and
    cuda:1, labelled hosts a and b, each with a hosts view at S = 4 whose
    other host's shards are remote: its exchange over NCCL (a card a
    slot), then a twin over gloo's staged form on the same inputs; the
    two reports."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from kaiju_tpu_torch import kernels

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (a process on each, over NCCL)")
    for src in ("fm_serve", "walk_hosts", "peer"):  # built before the pair
        kernels.load(src)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    work = tmp_path_factory.mktemp("nccl_pair")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests",
                                      "torch_exchange_worker.py"),
         coord, str(p), str(work / f"p{p}.json")], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(2)]
    try:
        logs = [proc.communicate(timeout=300)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert [proc.returncode for proc in procs] == [0, 0], "\n".join(
        log[-3000:] for log in logs)
    reports = []
    for p in range(2):
        with open(work / f"p{p}.json") as fh:
            reports.append(json.load(fh))
    return reports


def test_nccl_rounds_on_two_cards_answer_as_n_plain(nccl_pair):
    """Every slot has a card of its own, so the exchange runs over NCCL,
    with no copy: one round of N's four query kinds to every shard equals
    N's plain version on the whole index."""
    for p, rep in enumerate(nccl_pair):
        r = rep["nccl"]
        assert r["backend"] == "nccl" and not r["staged"]
        assert r["remote"] == [o for o in range(4) if o % 2 != p]
        assert r["serve_equal"], p
        assert r["counts"]["seed"]["sent"] > 0
        assert all(k["copy_s"] == 0 for k in r["counts"].values())


def test_nccl_walks_on_two_cards_match_plain(nccl_pair):
    """Q's walks in rounds over NCCL end where the plain SA walk on the
    whole index ends."""
    for p, rep in enumerate(nccl_pair):
        r = rep["nccl"]
        assert r["parked"] > 0 and r["counts"]["walk"]["rounds"] > 1
        assert r["walk_equal"], p


def test_nccl_rounds_on_two_cards_equal_the_staged_gloo_form(nccl_pair):
    """The gloo twin (pinned host buffers) on the same inputs gives the
    same answers in the same rounds, queries, sent and bytes."""
    for p, rep in enumerate(nccl_pair):
        g = rep["gloo"]
        assert g["backend"] == "gloo" and g["staged"]
        assert g["serve_equal"] and g["walk_equal"] and rep["same"], p
        for stage, k in rep["nccl"]["counts"].items():
            for f in ("rounds", "queries", "sent", "bytes"):
                assert g["counts"][stage][f] == k[f], (p, stage, f)
        assert g["counts"]["walk"]["copy_s"] > 0


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


@pytest.fixture(scope="module")
def big_ix(big_dbs, tmp_path_factory):
    """{(db name, S): (the BigIndex on the card, on the CPU)}, loaded at
    first use."""
    from kaiju_tpu_torch.parallel.big_index import BigIndex, save_sharded_ktx

    cache = {}

    def get(name, S):
        if (name, S) not in cache:
            path = str(tmp_path_factory.mktemp(f"big_{name}_{S}"))
            save_sharded_ktx(None, big_dbs[name], path, S)
            cache[name, S] = tuple(BigIndex.load(path, d)
                                   for d in ("cuda", "cpu"))
        return cache[name, S]

    return get


BIG_CASES = [("padded", 1), ("padded", 2), ("padded", 3), ("full", 2)]


@pytest.mark.parametrize("L", [1, 40, 64, 100])
@pytest.mark.parametrize("name,S", BIG_CASES)
def test_big_extend_all_edge_cases(big_dbs, big_ix, cuda, name, S, L):
    """L on exact substrings of the DB (their lanes take up to L - 1
    steps, and merge into their neighbours' once their match is unique),
    the demo's reads and a read of only code 0, R x L not a multiple of
    the block's lanes (L = 100: reads cut across blocks), equal to its
    plain version; one launch a call."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.ops import big_mem
    from kaiju_tpu_torch.tools.big_classify import make_reads

    db = big_dbs[name]
    gpu, cpu = big_ix(name, S)
    rng = np.random.default_rng(S * 100 + L)
    starts = db["starts"][rng.integers(0, db["nseq"], size=40)]
    exact = np.stack([db["text"][p:p + L] for p in starts])
    reads = np.concatenate([exact, np.zeros((1, L), np.uint8),
                            make_reads(db, 26, L, seed=S)[0]])
    codes = torch.from_numpy(reads)
    kernels.reset_counts()
    got = big_mem.big_extend_all(gpu, codes.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["big_extend_all"] == 1
    want = big_mem.big_extend_all_plain(cpu, codes)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    i = want[0][:40].long()
    assert (i == 0).all()  # every exact lane reached its read's start
    assert (want[0][40] == torch.arange(L)).all()  # the code-0 read
    assert (want[1][40] == cpu.C[1]).all() and (want[2][40] == cpu.C[2]).all()


def _lf(cpu, k):
    """(BWT letter, LF result) of SA rows k int64 on the CPU index."""
    from kaiju_tpu_torch.ops import big_mem

    rows = cpu.rec[k >> 7]
    c = rows[:, 32:].contiguous().view(torch.uint8).gather(
        1, (k & 127)[:, None])[:, 0].long()
    return c, big_mem.big_rank_plain(cpu, c, k)


def _hand_kf(cpu, N):
    """M's hand-laid kf arrays: {case: int64 [n]}."""
    gen = torch.Generator().manual_seed(N)
    k = torch.arange(N, dtype=torch.int64)
    sampled = (k >= cpu.first) & (((k - cpu.first) & ((1 << cpu.e) - 1))
                                  == 0)
    c, lf = _lf(cpu, k)
    term = k[(c == 0) & ~sampled]  # a terminator at once
    lf_term = torch.isin(lf, term) & (c > 0) & ~sampled
    before = k[lf_term]  # one step before a terminator
    plain = k[~sampled & (c > 0)]
    pick = plain[torch.randint(0, plain.numel(), (8,), generator=gen)]
    runs = torch.cat([pick[:5],
                      pick[1].repeat(31), pick[2].repeat(32),
                      pick[3].repeat(33), pick[4].repeat(100),
                      torch.tensor([-1]), pick[4].repeat(40),
                      k[sampled][:3].repeat_interleave(20)])
    many = torch.randint(0, N, (700_000,), generator=gen)
    many[::7] = -1
    return {"all -1": torch.full((100,), -1, dtype=torch.int64),
            "all one row": pick[0].repeat(100),
            "runs across warps": runs,
            "sampled": k[sampled][:50],
            "terminator": term[:50],
            "one step before a terminator": before[:50],
            "n = 1": pick[5:6], "n = 31": runs[3:34], "n = 33": runs[40:73],
            "many heads": many}


@pytest.mark.parametrize("name,S", BIG_CASES)
def test_big_sa_walk_edge_cases(big_dbs, big_ix, cuda, name, S):
    """M on hand-laid kf, each array equal to its plain version: all -1;
    all one row; runs of 31, 32, 33 and 100 across warp boundaries and
    a run cut by -1; rows already sampled; terminators at once and one
    step before; n = 1, 31 and 33; 700,000 random rows (more heads than
    the card's groups, taken in chunks); one launch a call."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.ops import big_mem

    gpu, cpu = big_ix(name, S)
    for case, kf in _hand_kf(cpu, big_dbs[name]["N"]).items():
        assert kf.numel(), case
        kernels.reset_counts()
        got = big_mem.big_sa_walk(gpu, kf.to(cuda))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["big_sa_walk"] == 1, case
        want = big_mem.big_sa_walk_plain(cpu, kf)
        assert torch.equal(got.cpu(), want), case
        if case == "all -1":
            assert (want == -1).all()
        else:
            assert (want >= 0).any(), case


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


# ---------------------------------------------------------------------------
# edge cases of D's and F's warp-parallel tail (csrc/lca_common.cuh), on
# hand-laid ranges, on the flat index (S = 0) and in 2 and 4 shards
# ---------------------------------------------------------------------------

OUTSIDE = 25_000  # taxids past the dense arrays of lca_env's tree


@pytest.fixture(scope="module")
def lca_env(edge_env):
    """A taxonomy of NCBI's depth cut small (readgen.DeepTaxonomy: species
    20-40 levels deep) with a second root, its dense arrays, clades at
    several depths, and the sequence of each SA row of edge_env's index."""
    from kaiju_tpu_torch.tools.readgen import DeepTaxonomy

    t = DeepTaxonomy(23, n_species=3000, max_taxid=20_000, width=40)
    nodes = {int(x): int(t.parent[x])
             for x in np.concatenate([t.internal, t.species])}
    second = min(x for x, p in nodes.items() if p == 1 and x != 1)
    nodes[second] = second
    par, dep = Taxonomy(nodes).dense_arrays()
    nr = np.random.default_rng(29)
    clades = t.ancestor(t.species[nr.integers(0, len(t.species), 5)],
                        nr.integers(3, 16, 5))
    dv = edge_env["dv"]
    n = edge_env["idx"].length
    walked, _p = tdev.sa_walk(dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.nseq,
                              dv.chpt_exp, torch.arange(n, dtype=torch.int32))
    return {"tree": t, "second": second, "clades": clades, "nr": nr,
            "par": torch.from_numpy(par), "dep": torch.from_numpy(dep),
            "walked": walked.numpy()}


def _lca_case(env, lenv, case):
    """(g_s0, g_s1 int32 [B, G], seq_tax, sw_ids or None, R, cap) of a
    case: ranges inside the SA rows of letters [nseq, length)."""
    idx, t, nr = env["idx"], lenv["tree"], lenv["nr"]
    nseq, n = idx.nseq, idx.length
    rng = np.random.default_rng(len(case))
    distinct = t.species[rng.choice(len(t.species), nseq, replace=False)]
    seq_tax = t.leaves_under(rng, lenv["clades"][np.arange(nseq) % 5])
    R, cap, sw_ids = 32, 20, None
    B, G = 64, 20
    s0 = rng.integers(nseq, n, (B, G))
    size = rng.integers(1, 4, (B, G)) * (rng.random((B, G)) < 0.12)
    if case in ("wide", "cap40"):  # n > 32 positions a read
        R = 1024
        size = rng.integers(0, 400, (B, G)) * (rng.random((B, G)) < 0.5)
        if case == "cap40":  # more than a warp of kept taxa
            cap, seq_tax = 40, distinct
    elif case == "absent":  # ids of depth 0, inside the arrays and past
        seq_tax = np.flatnonzero(lenv["dep"].numpy() == 0)[1:nseq + 1]
        seq_tax[::2] = OUTSIDE + np.arange(0, nseq, 2)
    elif case == "outside":
        seq_tax = np.full(nseq, OUTSIDE)
    elif case == "two_roots":
        seq_tax[::2] = t.leaves_under(rng, [lenv["second"]] * len(seq_tax[::2]))
    elif case == "virtual":  # virtual rows of the hybrid beside real ones
        sw_ids = torch.from_numpy(rng.integers(0, nseq, 40).astype(np.int32))
        v = rng.random((B, G)) < 0.3
        s0 = np.where(v, hybrid.VBASE + rng.integers(0, 32, (B, G)), s0)
        size = np.where(v, rng.integers(1, 9, (B, G)), size)
    elif case.startswith("around_cap"):
        # n_uniq = cap, cap + 1, cap + 2 with R - 1, R, R + 1 positions:
        # one position a range, the first u from u sequences of their own
        # taxon, the rest repeats of the first
        R, cap = (64, 40) if case.endswith("64") else (32, 20)
        seq_tax = distinct
        rows = [np.flatnonzero(lenv["walked"][nseq:] == i)[0] + nseq
                for i in range(nseq)]
        B, G = 9, R + 1
        s0 = np.zeros((B, G), dtype=np.int64)
        size = np.zeros((B, G), dtype=np.int64)
        for b, (u, tot) in enumerate((u, tot) for u in (cap, cap + 1, cap + 2)
                                     for tot in (R - 1, R, R + 1)):
            pos = [rows[i] for i in range(u)] + [rows[0]] * (tot - u)
            s0[b, :tot], size[b, :tot] = pos, 1
    s1 = np.where(s0 >= hybrid.VBASE, s0 + size, np.minimum(s0 + size, n))
    return (torch.from_numpy(s0.astype(np.int32)),
            torch.from_numpy(s1.astype(np.int32)),
            torch.from_numpy(np.asarray(seq_tax, dtype=np.int32)), sw_ids, R,
            cap)


def _slots(g_s0, g_s1, rng):
    """D's inputs holding F's ranges: each read's ranges as the ties of
    its slots (T a slot, in slot order) that reach its longest, behind a
    slot that does not and beside a pad; a tenth of the reads with more
    ties than T."""
    B, G = g_s0.shape
    ns = -(-G // T)
    pad = ns * T - G
    s0 = torch.nn.functional.pad(g_s0, (0, pad)).reshape(B * ns, T)
    s1 = torch.nn.functional.pad(g_s1, (0, pad)).reshape(B * ns, T)
    F = B * ns
    junk = torch.from_numpy(rng.integers(0, 50, (B, T)).astype(np.int32))
    tie_s0 = torch.cat([s0, junk]).contiguous()
    tie_s1 = torch.cat([s1, junk + 3]).contiguous()
    maxl = torch.cat([torch.full((F,), 10, dtype=torch.int32),
                      torch.full((B,), 5, dtype=torch.int32)])
    tie_cnt = torch.from_numpy(np.where(rng.random(F + B) < 0.1, T + 1, T)
                               .astype(np.int32))
    rf = np.full((B, ns + 2), -1, dtype=np.int32)
    rf[:, 0] = F + np.arange(B)
    rf[:, 2:] = np.arange(F).reshape(B, ns)
    return maxl, tie_cnt, tie_s0, tie_s1, torch.from_numpy(rf)


LCA_CASES = ["deep", "wide", "cap40", "absent", "outside", "two_roots",
             "around_cap", "around_cap 64", "virtual"]


@pytest.mark.parametrize("S", [0, 2, 4])
@pytest.mark.parametrize("case", LCA_CASES)
def test_lca_edge_reads_match_plain(edge_env, lca_env, cuda, case, S):
    """D and F against their plain versions, on the flat index and in 2 and
    4 shards: ranges on a tree of NCBI depth; R = 1024 with reads of more
    than 32 positions; cap 40, so that the kept taxa exceed a warp; every
    taxon absent from the tree; a single kept taxon outside the arrays;
    two roots; n_uniq exactly cap, cap + 1 and cap + 2 beside R - 1, R and
    R + 1 positions (R = 32 and 64); the hybrid's virtual rows."""
    from kaiju_tpu_torch import kernels

    env = edge_env
    dv = env["dv"]
    g_s0, g_s1, seq_tax, sw_ids, R, cap = _lca_case(env, lca_env, case)
    par, dep = lca_env["par"], lca_env["dep"]
    tail = (seq_tax, par, dep, R, cap, dv.nseq, dv.chpt_exp)
    want_f = classify.ranges_lca_plain(g_s0, g_s1, dv.rec, dv.C, dv.sa_seq,
                                       dv.sa_off, *tail, sw_ids=sw_ids)
    d_in = _slots(g_s0, g_s1, np.random.default_rng(S))
    want_d = classify.read_lca_plain(*d_in, dv.rec, dv.C, dv.sa_seq,
                                     dv.sa_off, *tail, sw_ids=sw_ids)
    ix = _edge_index(env, S, cuda)
    on = (seq_tax.to(cuda), par.to(cuda), dep.to(cuda), *tail[3:])
    sw = None if sw_ids is None else sw_ids.to(cuda)
    kernels.reset_counts()
    got_f = classify.ranges_lca(g_s0.to(cuda), g_s1.to(cuda), ix.rec, ix.C,
                                ix.sa_seq, ix.sa_off, *on, sw_ids=sw)
    got_d = classify.read_lca(*(a.to(cuda) for a in d_in), ix.rec, ix.C,
                              ix.sa_seq, ix.sa_off, *on, sw_ids=sw)
    torch.cuda.synchronize()
    suffix = "_sharded" if S else ""
    assert kernels.LAUNCHES["ranges_lca" + suffix] == 1
    assert kernels.LAUNCHES["read_lca" + suffix] == 1
    for g, w in zip(got_f, want_f):
        assert torch.equal(g.cpu(), w), case
    assert torch.equal(got_d.cpu(), want_d), case
    # D on the same ranges gives F's LCA and ids
    assert torch.equal(want_d[:, 0], want_f[0])
    assert torch.equal(want_d[:, 3], want_f[1])
    lca, n_ids, need_more, order = want_f
    total = (g_s1 - g_s0).clamp(min=0).sum(1)
    if case == "deep":
        assert len(set(dep[lca.clamp(max=len(dep) - 1).long()].tolist())) > 3
    elif case == "wide":
        assert (total > 32).sum() > 10 and (n_ids > 1).any()
    elif case == "cap40":
        assert (n_ids > 32).any()
    elif case == "absent":
        assert ((n_ids > 1) & (lca == 0)).any()
        assert (lca >= OUTSIDE).any() and ((lca > 0) & (lca < OUTSIDE)).any()
    elif case == "outside":
        assert (lca == OUTSIDE).sum() > 10 and n_ids.max() == 1
    elif case == "two_roots":
        assert (lca == lca_env["second"]).any() and (lca == 1).any()
    elif case.startswith("around_cap"):
        assert n_ids.tolist() == [cap] * 3 + [cap + 1] * 6
        assert need_more.tolist() == [0, 0, 1] + [0] * 6
        assert order.tolist() == [0, 0, 0, 0, 0, 1, 1, 1, 1]
    elif case == "virtual":
        assert (g_s0 >= hybrid.VBASE).any() and (n_ids > 1).any()


# ---------------------------------------------------------------------------
# edge cases of G's block lists and of the group walk to a text position
# (csrc/text_common.cuh) that G, E and H share, on the flat index (S = 0)
# and in 4 shards
# ---------------------------------------------------------------------------

BLOCK = 256  # positions a block of kernel G's first pass


@pytest.fixture(scope="module")
def rep_env():
    """A small index of gene families, family w holding w copies of a
    core of 150 letters (w = 1..8, and 10, past the widest switch), each
    between flanks of its own, odd copy c with a point substitution at
    core position 30 + 10 c; G's lanes on fragments cut from the cores,
    each piece starting a block of 256 positions, the last piece the last
    fragment, after 40 empty fragments (more fragment starts than a
    warp's 32 positions hold)."""
    rng = random.Random(12)

    def rand(n):
        return "".join(rng.choice(AA) for _ in range(n))

    cores = {w: rand(150) for w in (*range(1, 9), 10)}
    records = []
    for w, core in cores.items():
        for c in range(w):
            body = list(core)
            if c % 2:
                x = 30 + 10 * c
                body[x] = AA[(AA.index(body[x]) + 1) % 20]
            records.append((f"F{w}C{c}.1_{[101, 102, 201, 100][c % 4]}",
                            rand(rng.randint(20, 60)) + "".join(body)
                            + rand(rng.randint(20, 60))))
    records += [(f"R{i}.1_{[101, 102, 201, 100][i % 4]}",
                 rand(rng.randint(40, 300))) for i in range(30)]
    idx = py_builder.build_index(records)
    trans = trans_table(idx.alphabet)
    # pieces of 24, 40 and 130 letters, each starting a block of G's
    # first pass: blocks listing from a few to hundreds of occurrences
    frags = []
    for w in cores:
        for st, n in ((100, 24), (0, 40), (10, 130)):
            frags += [cores[w][st:st + n], rand(BLOCK - n)]
    frags += [rand(BLOCK - 7), *[""] * 40, cores[5][5:145]]
    codes = [np.array([trans[ord(ch)] for ch in f], dtype=np.uint8)
             for f in frags]
    off = np.zeros(len(frags) + 1, dtype=np.int32)
    off[1:] = np.cumsum([len(f) for f in frags])
    flat = torch.from_numpy(np.concatenate(codes))
    frag_off = torch.from_numpy(off)
    dv = tdev.DeviceIndex(idx, "cpu")
    seed = tuple(torch.from_numpy(a) for a in KmerTables.build(
        idx, search.SEED_K).planar_seed(search.SEED_K))
    lanes = search.mem_extend_plain(dv.rec, dv.C, *seed, flat, frag_off,
                                    search.SEED_K, MIN_LEN - 1,
                                    sw_steps=hybrid.S1_STEPS)
    fm = search.mem_extend_plain(dv.rec, dv.C, *seed, flat, frag_off,
                                 search.SEED_K, MIN_LEN - 1)
    return {"idx": idx, "dv": dv, "flat": flat, "frag_off": frag_off,
            "lanes": lanes, "fm": fm}


def _g_args(env, ix, dev):
    sw_len = search.SEED_K + hybrid.S1_STEPS
    return (*(_to(a, dev) for a in (*env["lanes"], env["flat"],
                                     env["frag_off"])),
            sw_len, ix.text, ix.rank_start, ix.rec, ix.C, ix.sa_seq,
            ix.sa_off, env["dv"].nseq, env["dv"].chpt_exp)


def _runs(mask):
    """The lengths of the runs of True in a bool [P] tensor."""
    at = torch.nonzero(mask).squeeze(1).numpy()
    return [len(r) for r in np.split(at, np.flatnonzero(np.diff(at) != 1)
                                     + 1) if len(r)]


@pytest.mark.parametrize("S", [0, 4])
def test_text_extend_group_cases_match_plain(rep_env, cuda, S):
    """G against its plain version, every output equal (the ids, in SA
    order, included): intervals of 1 to 8 occurrences, ties among them
    (all or some of an interval's occurrences reaching the longest
    extension), runs of more than 32 switched lanes, switched lanes in the
    last fragment, behind more than 32 empty fragments."""
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    env = rep_env
    dv = env["dv"]
    args = _g_args(env, dv, "cpu")
    want = hybrid.text_extend_plain(*args)
    i, s0, s1 = env["lanes"]
    frag_off = env["frag_off"]
    sw = hybrid.switched(i, s0, s1, frag_off, args[5])
    width, n_ach = (s1 - s0)[sw], (want[2] - want[1])[sw]
    assert set(width.tolist()) == set(range(1, 9))
    assert (n_ach > 1).any() and (n_ach < width).any()
    assert max(_runs(sw)) >= 32
    assert sw[int(frag_off[-2]):].any()
    assert int((frag_off == frag_off[-2]).sum()) > 32
    # the virtual rows hold what the FM steps end on
    assert torch.equal(want[0], env["fm"][0])
    assert torch.equal(want[2] - want[1], env["fm"][2] - env["fm"][1])
    ix = (tdev.DeviceIndex(env["idx"], cuda) if S == 0
          else ShardedIndex(env["idx"], S, cuda))
    got = hybrid.text_extend(*_g_args(env, ix, cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _walks(dv, length):
    """(LF steps, ended at a terminator) of the walk from every SA
    position of dv's index, as sa_walk takes them."""
    check = (1 << dv.chpt_exp) - 1
    k = torch.arange(length, dtype=torch.int32)
    steps = torch.zeros_like(k)
    term = torch.zeros(length, dtype=torch.bool)
    todo = torch.nonzero(k & check).squeeze(1)
    while todo.numel():
        kk = k[todo]
        rows = dv.rec[torch.clamp(kk >> 7, max=dv.rec.shape[0] - 1).long()]
        c = tdev._block_bytes(rows).gather(1, (kk & 127).long()[:, None])[:, 0]
        kn = tdev.rank(dv.rec, dv.C, c, kk)
        end = c == 0
        term[todo[end]] = True
        todo, kn = todo[~end], kn[~end]
        steps[todo] += 1
        k[todo] = kn
        todo = todo[(kn & check) != 0]
    return steps, term


@pytest.mark.parametrize("S", [0, 4])
@pytest.mark.parametrize("n", [500, 40_000, 90_000, 300_000])
def test_sa_lookup_walk_cases_match_plain(rep_env, cuda, n, S):
    """H against its plain version on n positions (a group of 8 lanes
    each; up to 2,400,000 threads at n = 300,000): positions at a sampled
    slot (no step), walks that end at a terminator at once and after
    steps, every walk of the index's maximal length, and random
    positions."""
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    env = rep_env
    idx, dv = env["idx"], env["dv"]
    steps, term = _walks(dv, idx.length)
    pos = torch.arange(idx.length, dtype=torch.int32)
    zero = pos[(pos & ((1 << dv.chpt_exp) - 1)) == 0]
    cases = (zero, pos[term & (steps == 0)], pos[term & (steps > 0)],
             pos[steps == steps.max()])
    assert all(c.numel() for c in cases) and int(steps.max()) >= 20
    rng = np.random.default_rng(n)
    k = torch.cat([*cases, torch.from_numpy(
        rng.integers(0, idx.length, n).astype(np.int32))])[:n]
    args = (dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.nseq, dv.chpt_exp)
    want = tdev.sa_lookup_plain(*args, k)
    ix = (tdev.DeviceIndex(idx, cuda) if S == 0
          else ShardedIndex(idx, S, cuda))
    got = tdev.sa_lookup(ix.rec, ix.C, ix.sa_seq, ix.sa_off, dv.nseq,
                         dv.chpt_exp, k.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# kernel C on hand-laid lanes, and kernel A's two forms on the flat index
# and in 2 and 4 shards
# ---------------------------------------------------------------------------

# fragment lengths around C's group of 8 lanes and its 64 registers
STATS_LENGTHS = (0, 1, 7, 8, 9, 32, 33, 63, 64, 65, 128, 129, 300)
STATS_CASES = ("random", "ties", "no_jstop", "mixed")


def stats_lanes(seed, lengths, case):
    """(i, s0, s1, frag_off) int32 of hand-laid B lanes, one fragment of
    each length.  "random": i_j uniform in 0..j + 1 (j + 1: a lane that
    matched nothing); "ties": every lane from j = 11 on a match of 12
    letters, the last lane reaching i <= 1 at j = 12, so a fragment of n
    positions has n - 12 ties (more than T past 20); "no_jstop": i_j >= 2
    on every lane; "mixed": matches of 9 to 13 letters, a twentieth of
    the lanes reaching i = 1."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, dtype=np.int64)
    off = np.zeros(len(lengths) + 1, dtype=np.int64)
    off[1:] = np.cumsum(lengths)
    P = int(off[-1])
    j = np.arange(P) - np.repeat(off[:-1], lengths)
    if case == "random":
        i = rng.integers(0, j + 2)
    elif case == "ties":
        i = np.where(j >= 11, j - 11, j + 1)
    elif case == "no_jstop":
        i = rng.integers(2, j + 4)
    else:
        i = np.maximum(j + 1 - rng.choice([9, 11, 12, 12, 13, 13], P), 0)
        i[rng.random(P) < 0.05] = 1
    s0 = rng.integers(0, 1 << 24, P)
    s1 = s0 + rng.integers(0, 40, P)
    return tuple(torch.from_numpy(a.astype(np.int32))
                 for a in (i, s0, s1, off))


@pytest.mark.parametrize("case", [*STATS_CASES, "phase 3"])
def test_mem_stats_fragment_cases_match_plain(cuda, case):
    """C against its plain version on fragments of 0 to 300 positions in
    a shuffled order (groups of one warp hold fragments of unlike
    lengths), and at phase 3's size: 634,026 positions in fragments of
    random lengths, about 25 a fragment (the MEM batch's mean)."""
    rng = np.random.default_rng(len(case))
    if case == "phase 3":
        lengths = []
        while sum(lengths) < 634_026:
            lengths.append(int(rng.integers(0, 50)))
        lengths[-1] -= sum(lengths) - 634_026
        i, s0, s1, off = stats_lanes(9, lengths, "mixed")
    else:
        lengths = rng.permutation(np.repeat(STATS_LENGTHS, 5))
        i, s0, s1, off = stats_lanes(9, lengths, case)
    want = search.mem_stats_plain(i, s0, s1, off, MIN_LEN, T)
    got = search.mem_stats(i.to(cuda), s0.to(cuda), s1.to(cuda),
                           off.to(cuda), MIN_LEN, T)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if case == "ties":
        assert int(want[1].max()) > T


def _letter_intervals(env):
    """Previous intervals of A's letters form: the index's depth-2 and
    depth-3 seed intervals (live and dead), intervals that cross a block
    boundary, end at the end row (s1 = N) or lie in one block, and dead
    ones (s0 == s1, s0 > s1)."""
    idx = env["idx"]
    kt = KmerTables.build(idx, 3)
    N = idx.length
    extra = [(0, N), (100, 300), (127, 128), (128, 129), (N - 5, N),
             (N - 200, N), (5, 5), (9, 3), (0, 0), (256, 250)]
    s0 = np.concatenate([kt.tables[1][0], kt.tables[2][0],
                         [a for a, _ in extra]])
    s1 = np.concatenate([kt.tables[1][1], kt.tables[2][1],
                         [b for _, b in extra]])
    return (torch.from_numpy(s0.astype(np.int32)),
            torch.from_numpy(s1.astype(np.int32)))


@pytest.mark.parametrize("S", [0, 2, 4])
def test_update_si_letters_kernel_matches_plain(env, cuda, S):
    """A's letters form against its plain version on the flat index and
    in S shards, and against update_si_plain on the repeated probes; only
    its own instantiation launches."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    dv = env["dv"]
    s0, s1 = _letter_intervals(env)
    want = tdev.update_si_letters_plain(dv.rec, dv.C, s0, s1)
    n = s0.shape[0]
    c = torch.arange(1, 21, dtype=torch.int32).repeat_interleave(n)
    r0, r1, ok = tdev.update_si_plain(dv.rec, dv.C, c, s0.repeat(20),
                                      s1.repeat(20))
    keep = ok & (s0 < s1).repeat(20)
    assert torch.equal(want[0], torch.where(keep, r0, 0).view(20, n))
    assert torch.equal(want[1], torch.where(keep, r1, 0).view(20, n))
    ix = (tdev.DeviceIndex(env["idx"], cuda) if S == 0
          else ShardedIndex(env["idx"], S, cuda))
    kernels.reset_counts()
    got = tdev.update_si_letters(ix.rec, ix.C, s0.to(cuda), s1.to(cuda))
    torch.cuda.synchronize()
    name = "update_si_letters" + ("_sharded" if S else "")
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {name: 1}
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int((want[0] < want[1]).sum()) > 100


@pytest.mark.parametrize("S", [0, 2, 4])
def test_update_si_kernel_cases_match_plain(env, cuda, S):
    """A's probe form against its plain version on the flat index and in
    S shards: random probes of every code of C, both ends in one block
    and in two, ends at 0, at block boundaries and at N (the end row)."""
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    idx, dv = env["idx"], env["dv"]
    rng = np.random.default_rng(30 + S)
    n = 30_000
    c = rng.integers(0, dv.C.shape[0], n).astype(np.int32)
    s0 = rng.integers(0, idx.length + 1, n).astype(np.int32)
    s1 = np.minimum(s0 + rng.integers(0, 300, n), idx.length).astype(np.int32)
    ends = np.array([0, 127, 128, 129, idx.length - 1, idx.length,
                     idx.length // 128 * 128], dtype=np.int32)
    s0[:7], s1[:7] = ends, ends[::-1].copy()
    s0[7:14], s1[7:14] = ends, np.full(7, idx.length, dtype=np.int32)
    c, s0, s1 = (torch.from_numpy(a) for a in (c, s0, s1))
    want = tdev.update_si_plain(dv.rec, dv.C, c, s0, s1)
    ix = (tdev.DeviceIndex(idx, cuda) if S == 0
          else ShardedIndex(idx, S, cuda))
    got = tdev.update_si(ix.rec, ix.C, c.to(cuda), s0.to(cuda), s1.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("S", [0, 2])
def test_kmer_tables_on_the_card_match_host(env, cuda, S):
    """KmerTables.build_device through A's letters form on the card, on
    the flat index and in S shards, equals the host build."""
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    idx = env["idx"]
    ix = (tdev.DeviceIndex(idx, cuda) if S == 0
          else ShardedIndex(idx, S, cuda))
    got = KmerTables.build_device(idx, 4, ix)
    want = KmerTables.build(idx, 4)
    for (g0, g1), (w0, w1) in zip(got.tables, want.tables):
        np.testing.assert_array_equal(g0, w0)
        np.testing.assert_array_equal(g1, w1)


WARM_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from kaiju_tpu_torch import kernels
from kaiju_tpu_torch.tools import kaiju
ktx, nodes, fq, out = sys.argv[2:6]
for mode, flags in (("mem", ["-a", "mem"]), ("greedy", [])):
    assert kaiju.main(["-t", nodes, "-f", ktx, "-i", fq, *flags,
                       "-o", out + mode + ".tsv"]) == 0
print(json.dumps({"origin": kernels.ORIGIN, "loader": kernels.LOADER,
                  "launches": kernels.LAUNCHES}))
"""


def test_mkdb_aot_libraries_load_in_a_fresh_process(cuda, tmp_path,
                                                    monkeypatch):
    """mkdb --aot builds every library into db.ktx/aot/<key>/; a fresh
    kaiju process (MEM, then Greedy) loads each library it uses from there
    with no nvcc run, reads the seed tables instead of building them, and
    writes the TSV of the same reads classified in this process."""
    import json
    import os
    import subprocess
    import sys

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.tools import kaiju, mkdb
    from kaiju_tpu_torch.tools.readgen import write_fastq
    from kaiju_tpu_torch.utils import aot

    monkeypatch.setattr(kernels, "_prebuilt", None)
    monkeypatch.delenv("KAIJU_TPU_CACHE", raising=False)
    rng = random.Random(91)
    records = [(f"ACC{i:04d}.1_{[101, 102, 201, 100][i % 4]}",
                "".join(rng.choice(AA) for _ in range(rng.randint(60, 400))))
               for i in range(300)]
    fasta, nodes = str(tmp_path / "db.faa"), str(tmp_path / "nodes.dmp")
    with open(fasta, "w") as fh:
        fh.writelines(f">{n}\n{s}\n" for n, s in records)
    with open(nodes, "w") as fh:
        fh.writelines(f"{t}\t|\t{p}\t|\tspecies\t|\n" for t, p in NODES.items())
    fq = str(tmp_path / "reads.fastq")
    write_fastq(make_reads(rng, records, n=500), fq)
    ktx = str(tmp_path / "db.ktx")
    assert mkdb.main(["-o", ktx, "--aot", "-t", nodes, "--aot-batch", "256",
                      fasta]) == 0
    pre = aot.prebuilt_dir(ktx)
    assert sorted(f for f in os.listdir(pre) if f.endswith(".so")) == sorted(
        f"lib{s}.so" for s in kernels.SOURCES)
    assert aot.read_manifest(pre)["key"] == os.path.basename(pre)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", WARM_WORKER, repo, ktx, nodes, fq,
         str(tmp_path / "warm_")], capture_output=True, text=True,
        timeout=600, env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["loader"]["nvcc_runs"] == 0
    assert set(got["origin"].values()) == {pre}
    assert {"mem_extend", "mem_stats", "read_lca", "greedy_search",
            "ranges_lca"} <= set(got["origin"])
    assert got["launches"]["update_si_letters"] == 0  # tables read
    for mode, flags in (("mem", ["-a", "mem"]), ("greedy", [])):
        out = str(tmp_path / f"here_{mode}.tsv")
        assert kaiju.main(["-t", nodes, "-f", ktx, "-i", fq, *flags,
                           "-o", out]) == 0
        with open(out) as a, open(str(tmp_path / f"warm_{mode}.tsv")) as b:
            here, warm = a.read(), b.read()
        assert here == warm and here.count("\n") == 500
        assert here.count("C\t") > 100


# ---------------------------------------------------------------------------
# kernels N, O, Q, W: a group of processes on several hosts
# ---------------------------------------------------------------------------


class _Server:
    """Rounds within this process: the remote shards' queries answered by
    kernel N (or its plain version) on a view that reads every shard."""

    def __init__(self, whole):
        self.whole = whole

    def parked_anywhere(self, n, stage):
        return n > 0

    def serve(self, queries, width, stage):
        w = self.whole
        ans, bad = tdev.fm_serve(w.rec, w.C, w.sa_seq, w.sa_off, queries,
                                 width, w.text)
        assert int(bad) == 0
        return ans

    def rounds(self, stage, parked, queries, width, resume):
        from kaiju_tpu_torch.parallel.exchange import Exchange

        Exchange.rounds(self, stage, parked, queries, width, resume)


def _hosts_view(sh, remote):
    import copy

    view = copy.copy(sh)
    for name in ("rec", "sa_seq", "sa_off", "text"):
        a = getattr(sh, name)
        if a is not None:
            setattr(view, name, tdev.Shards(
                [None if o in remote else p for o, p in enumerate(a.parts)],
                a.per, a.shape[0], a.device, like=a.parts[0]))
    view.exchange = _Server(sh)
    return view


def _sorted_rows(t, key=0):
    t = t.cpu()
    return t[torch.argsort(t[:, key].long() if t.dim() == 2
                           else t[:, 0, key].long(), stable=True)]


@pytest.mark.parametrize("S", [2, 3])
def test_fm_serve_kernel_matches_plain(env, cuda, S):
    """N's RANK, ROW, LF and SAMPLE (k = 0, a block's start, k = N, the
    padded last shard) equal its plain version; a query to a remote shard
    counts in bad and leaves its answer 0."""
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    idx = env["idx"]
    sh_c, sh_g = ShardedIndex(idx, S, "cpu"), ShardedIndex(idx, S, cuda)
    rng = np.random.default_rng(S)
    n = 6000
    k = rng.integers(0, idx.length + 1, n).astype(np.int32)
    k[:4] = [0, 128, idx.length, idx.length - 1]
    kind = rng.integers(0, 4, n).astype(np.int32)
    c = rng.integers(1, idx.alen, n).astype(np.int32)
    # a walk's LF step reads a row below N; a sample, a slot
    x = np.where(kind == tdev.Q_SAMPLE, k % sh_c.sa_seq.shape[0],
                 np.where(kind == tdev.Q_LF, np.minimum(k, idx.length - 1),
                          k))
    op = kind << 8 | np.where(kind == tdev.Q_RANK, c, 0)
    q = torch.from_numpy(np.stack([op, x], 1).astype(np.int32))
    want, _b = tdev.fm_serve_plain(sh_c.rec, sh_c.C, sh_c.sa_seq, sh_c.sa_off,
                                   q, 20)
    got, bad = tdev.fm_serve(sh_g.rec, sh_g.C, sh_g.sa_seq, sh_g.sa_off,
                             q.to(cuda), 20)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and int(bad) == 0
    view = _hosts_view(sh_g, (S - 1,))
    got, bad = tdev.fm_serve(view.rec, view.C, view.sa_seq, view.sa_off,
                             q.to(cuda), 20)
    far = ~view.rec.here.cpu()[tdev.query_shard(sh_c.rec, sh_c.sa_seq, q)]
    assert int(bad) == int(far.sum()) > 0
    assert torch.equal(got.cpu()[~far], want[~far])
    assert not got.cpu()[far].any()


@pytest.mark.parametrize("remote", [(1,), (0, 2), (0, 1, 2)],
                         ids=["one", "two", "all"])
def test_hosts_kernels_in_rounds_match_plain(env, cuda, remote):
    """O, Q and W on the index in 3 shards with the shards `remote` on
    another host: each launch on a round's own arguments equals its plain
    version (parked lanes compared as sets), and the rounds end where B, H
    and D end; fused_mem_classify_hosts gives fused_mem_classify's rows."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    idx = env["idx"]
    views = {d: _hosts_view(ShardedIndex(idx, 3, d), remote)
             for d in ("cpu", cuda)}
    flat, frag_off, rf_rows = _batch(env, 16)
    seed = env["seed"]

    def ext(d, **kw):
        v = views[d]
        return search.mem_extend_hosts(
            v.rec, v.C, *(a.to(d) for a in seed), flat.to(d),
            frag_off.to(d), search.SEED_K, MIN_LEN - 1, **kw)

    kernels.reset_counts()
    out_c, pk_c, q_c = ext("cpu")
    out_g, pk_g, q_g = ext(cuda)
    assert torch.equal(out_g.cpu(), out_c) and pk_c.shape[0] > 0
    assert torch.equal(_sorted_rows(pk_g), _sorted_rows(pk_c))
    order_g = torch.argsort(pk_g[:, 0].cpu().long())
    order_c = torch.argsort(pk_c[:, 0].long())
    assert torch.equal(q_g.cpu()[order_g], q_c[order_c])
    ans = views["cpu"].exchange.serve(q_c.reshape(-1, 2), 1, "extend")
    res_c = ext("cpu", out=out_c, parked=pk_c, answers=ans.view(-1, 2))
    ans_g = ans.view(-1, 2)[order_c][torch.argsort(order_g)].to(cuda)
    res_g = ext(cuda, out=out_g, parked=pk_g, answers=ans_g.contiguous())
    assert torch.equal(res_g[0].cpu(), res_c[0])
    assert torch.equal(_sorted_rows(res_g[1]), _sorted_rows(res_c[1]))
    want = classify.fused_mem_classify(
        *_args(env, flat, frag_off, rf_rows, 32, "cpu"))
    v = views[cuda]
    got = classify.fused_mem_classify_hosts(
        v, v.exchange, tuple(a.to(cuda) for a in seed), flat.to(cuda),
        frag_off.to(cuda), rf_rows.to(cuda), v.seq_tax, env["par"].to(cuda),
        env["dep"].to(cuda), search.SEED_K, MIN_LEN - 1, MIN_LEN, T, 32, CAP)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for name in ("mem_extend_hosts", "walk_hosts", "read_lca_hosts",
                 "fm_serve"):
        assert kernels.LAUNCHES[name] > 0, name
    # Q alone: its start and one resume on the same arguments
    rng = np.random.default_rng(len(remote))
    rows = torch.from_numpy(rng.integers(idx.nseq, idx.length,
                                         3000).astype(np.int32))
    seq_c = torch.empty_like(rows)
    seq_g = torch.empty_like(rows).to(cuda)
    w = {d: views[d] for d in views}
    pk_c, q_c = tdev.walk_hosts(w["cpu"].rec, w["cpu"].C, w["cpu"].sa_seq,
                                idx.nseq, idx.chpt_exp, seq_c, rows=rows)
    pk_g, q_g = tdev.walk_hosts(w[cuda].rec, w[cuda].C, w[cuda].sa_seq,
                                idx.nseq, idx.chpt_exp, seq_g,
                                rows=rows.to(cuda))
    assert torch.equal(seq_g.cpu(), seq_c)
    assert torch.equal(_sorted_rows(pk_g), _sorted_rows(pk_c))
    order_g = torch.argsort(pk_g[:, 0].cpu().long())
    order_c = torch.argsort(pk_c[:, 0].long())
    assert torch.equal(q_g.cpu()[order_g], q_c[order_c])
    views["cpu"].exchange.rounds("walk", pk_c, q_c, 1, lambda pk, a:
                                 tdev.walk_hosts(
                                     w["cpu"].rec, w["cpu"].C,
                                     w["cpu"].sa_seq, idx.nseq, idx.chpt_exp,
                                     seq_c, parked=pk, answers=a.reshape(-1)))
    views[cuda].exchange.rounds("walk", pk_g, q_g, 1, lambda pk, a:
                                tdev.walk_hosts(
                                    w[cuda].rec, w[cuda].C, w[cuda].sa_seq,
                                    idx.nseq, idx.chpt_exp, seq_g, parked=pk,
                                    answers=a.reshape(-1).contiguous()))
    dv = env["dv"]
    want = tdev.sa_walk(dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.nseq,
                        dv.chpt_exp, rows)[0]
    torch.cuda.synchronize()
    assert torch.equal(seq_c, want) and torch.equal(seq_g.cpu(), want)


@pytest.mark.parametrize("G", [4, 128])
def test_lca_interval_sums_near_2_31_match_plain(env, cuda, G):
    """D, F and W's list form on ranges whose int32 sum wraps (each 2^30
    to 2^31 long): equal to their plain versions, every read flagged
    need_more (total > R) as an int64 sum says."""
    dv = env["dv"]
    rng = np.random.default_rng(G)
    B, R = 8, 8
    s0 = rng.integers(0, dv.rec.shape[0] * 128 - 200, (B, G))
    s1 = np.minimum(s0 + rng.integers(1 << 30, (1 << 31) - (1 << 20),
                                      (B, G)), (1 << 31) - 1)
    g_s0 = torch.from_numpy(s0.astype(np.int32))
    g_s1 = torch.from_numpy(s1.astype(np.int32))
    tail = (dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.seq_tax, env["par"],
            env["dep"], R, CAP, dv.nseq, dv.chpt_exp)

    def to(a):
        return a.to(cuda) if isinstance(a, torch.Tensor) else a

    want = classify.ranges_lca(g_s0, g_s1, *tail)
    got = classify.ranges_lca(to(g_s0), to(g_s1), *map(to, tail))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool((want[2] == 1).all())
    maxl = torch.full((B,), 20, dtype=torch.int32)
    tie_cnt = torch.full((B,), G, dtype=torch.int32)
    rf_rows = torch.arange(B, dtype=torch.int32)[:, None]
    d_args = (maxl, tie_cnt, g_s0, g_s1, rf_rows)
    want = classify.read_lca(*d_args, *tail)
    got = classify.read_lca(*map(to, d_args), *map(to, tail))
    assert torch.equal(got.cpu(), want)
    assert bool(((want[:, 2] & classify.FLAG_NEED_MORE) != 0).all())
    want = classify.read_lca_list(*d_args, R)
    got = classify.read_lca_list(*map(to, d_args), R)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool((want[1][:, 1] > R).all())
    want = classify.ranges_lca_list(g_s0, g_s1, R)
    got = classify.ranges_lca_list(to(g_s0), to(g_s1), R)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool((want[1][:, 1] > R).all())


# ---------------------------------------------------------------------------
# kernels U, X, V: Greedy over a group of processes on several hosts
# ---------------------------------------------------------------------------

GREEDY_PARAMS = (7, MIN_LEN, 65, 3, 20, greedy.VCAP)  # Lmap mfl -s -e T vcap


def _same_state(got, want):
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g.cpu(), w), name


@pytest.mark.parametrize("remote", [(1,), (0, 2), (0, 1, 2)],
                         ids=["one", "two", "all"])
def test_greedy_hosts_kernels_match_plain(env, cuda, remote):
    """U's three forms (level 0, each level's fan-out, counts and list, and
    settle), X's start form and a resume form on the index in 3 shards with
    the shards `remote` on another host, and V with W's resolved form
    (ranges), each on the same arguments as its plain version (parked variants compared as
    sets); the levels end at E's (best, flags, g_s0, g_s1)."""
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    idx, dv = env["idx"], env["dv"]
    views = {d: _hosts_view(ShardedIndex(idx, 3, d), remote)
             for d in ("cpu", cuda)}
    flat, frag_off, rf_rows = _batch(env, 16, "greedy")
    Lmap, mfl, min_score, e, T_, vcap = GREEDY_PARAMS
    lanes = search.mem_extend_plain(dv.rec, dv.C, *env["seed"], flat,
                                    frag_off, search.SEED_K, Lmap - 1)
    B, P = rf_rows.shape[0], flat.shape[0]
    arg = {d: tuple(a.to(d) for a in (flat, frag_off, rf_rows))
           + (tuple(t.to(d) for t in env["tables"]), GREEDY_PARAMS)
           for d in views}
    st = {d: greedy.level_state(B, P, T_, vcap, e, d) for d in views}
    for d in views:
        greedy.greedy_levels(0, 0, *arg[d], st[d],
                             lanes=tuple(t.to(d) for t in lanes))
    _same_state(st[cuda], st["cpu"])
    parked_any = 0
    for level in range(1, e + 1):
        counts = {d: greedy.greedy_levels(1, level, *arg[d], st[d])
                  for d in views}
        assert torch.equal(counts[cuda].cpu(), counts["cpu"])
        voff = torch.cat([torch.zeros(1, dtype=torch.int32),
                          torch.cumsum(counts["cpu"], 0, dtype=torch.int32)])
        var = {d: greedy.greedy_levels(1, level, *arg[d], st[d],
                                       voff=voff.to(d)) for d in views}
        assert torch.equal(var[cuda].cpu(), var["cpu"])
        out = {d: torch.full((var[d].shape[0], 3), -1, dtype=torch.int32,
                             device=d) for d in views}
        vr = {d: (views[d].rec, views[d].C, arg[d][0], var[d], out[d])
              for d in views}
        pk = {d: greedy.greedy_variants_hosts(*vr[d]) for d in views}
        assert torch.equal(out[cuda].cpu(), out["cpu"])
        assert torch.equal(_sorted_rows(pk[cuda][0]), _sorted_rows(pk["cpu"][0]))
        order = {d: torch.argsort(pk[d][0][:, 0].cpu().long()) for d in views}
        assert torch.equal(pk[cuda][1].cpu()[order[cuda]],
                           pk["cpu"][1][order["cpu"]])
        parked_any += pk["cpu"][0].shape[0]
        if pk["cpu"][0].shape[0]:  # one resume on the same answers
            ans = views["cpu"].exchange.serve(pk["cpu"][1].reshape(-1, 2), 1,
                                              "variants").view(-1, 2)
            ans_g = ans[order["cpu"]][torch.argsort(order[cuda])]
            pk["cpu"] = greedy.greedy_variants_hosts(
                *vr["cpu"], parked=pk["cpu"][0], answers=ans)
            pk[cuda] = greedy.greedy_variants_hosts(
                *vr[cuda], parked=pk[cuda][0],
                answers=ans_g.to(cuda).contiguous())
            assert torch.equal(out[cuda].cpu(), out["cpu"])
            assert torch.equal(_sorted_rows(pk[cuda][0]),
                               _sorted_rows(pk["cpu"][0]))
        for d in views:
            views[d].exchange.rounds(
                "variants", *pk[d], 1, lambda p, a, d=d:
                greedy.greedy_variants_hosts(*vr[d], parked=p,
                                             answers=a.reshape(-1, 2)))
            greedy.greedy_levels(2, level, *arg[d], st[d], voff=voff.to(d),
                                 var=var[d], vout=out[d])
        assert torch.equal(out[cuda].cpu(), out["cpu"])
        _same_state(st[cuda], st["cpu"])
    assert parked_any > 0
    want = greedy.greedy_search_plain(*lanes, flat, frag_off, rf_rows, dv.rec,
                                      dv.C, env["tables"], Lmap, mfl,
                                      min_score, e, T_)
    for g, w in zip((st["cpu"].best, st["cpu"].flags, st["cpu"].g_s0,
                     st["cpu"].g_s1), want):
        assert torch.equal(g, w)
    # V around the walks, on the ties' ranges
    R = 32
    lists = {d: classify.ranges_lca_list(st[d].g_s0, st[d].g_s1, R)
             for d in views}
    for g, w in zip(lists[cuda], lists["cpu"]):
        assert torch.equal(g.cpu(), w)
    pos, info = lists["cpu"]
    seq = torch.full_like(pos, -1)
    seq[pos >= 0] = tdev.sa_walk(dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.nseq,
                                 dv.chpt_exp, pos[pos >= 0])[0]
    tail = (dv.seq_tax, env["par"], env["dep"], R, CAP)
    got = classify.lca_resolved(info.to(cuda), seq.to(cuda),
                                *(t.to(cuda) for t in tail[:3]), R, CAP,
                                ranges=True)
    want = classify.ranges_lca_plain(st["cpu"].g_s0, st["cpu"].g_s1, dv.rec,
                                     dv.C, dv.sa_seq, dv.sa_off, *tail,
                                     dv.nseq, dv.chpt_exp)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool((info[:, 1] > R).any())


@pytest.mark.parametrize("mismatches,vcap", [(0, greedy.VCAP),
                                             (3, greedy.VCAP), (3, 1)])
def test_greedy_hosts_batch_on_the_card_matches_b_e_f(env, cuda, mismatches,
                                                      vcap):
    """fused_greedy_classify_hosts on the card, every shard local (O, U, X,
    Q and V, the rounds with nothing parked), gives the rows of B -> E -> F
    with no hybrid on the card; vcap = 1 flags reads FLAG_SCRATCH."""
    from kaiju_tpu_torch import kernels as tk
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    gpu = _greedy_args(env, env["reads"], mismatches, cuda, vcap)
    (rec, C, seed, flat, frag_off, rf_rows, sa_seq, sa_off, seq_tax, par,
     dep, tables, K, lmap, mfl, min_score, e, T_, R, cap, _n, _c, vc) = gpu
    want = greedy.fused_greedy_classify(*gpu)
    view = _hosts_view(ShardedIndex(env["idx"], 3, cuda), ())
    tk.reset_counts()
    got = greedy.fused_greedy_classify_hosts(
        view, view.exchange, seed, flat, frag_off, rf_rows, seq_tax, par,
        dep, tables, K, lmap, mfl, min_score, e, T_, R, cap, vc)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    for name in ("mem_extend_hosts", "greedy_levels", "ranges_lca_hosts",
                 "walk_hosts", "read_lca_hosts"):
        assert tk.LAUNCHES[name] > 0, name
    assert (tk.LAUNCHES["greedy_variants_hosts"] > 0) == (mismatches > 0)
    assert not tk.LAUNCHES["greedy_search"] + tk.LAUNCHES["ranges_lca"]
    if vcap == 1:
        assert bool((want[:, 2] & greedy.FLAG_SCRATCH).any())


def _serve_queries(idx, sh, W, seed):
    """A round's queries for N at width W on the index `sh` (every kind
    its width allows, in random order: RANK, LF, SAMPLE, ROW at W >= 20,
    TEXT at W >= 32), with parked lanes' rank pairs (one letter, two ends)
    next to each other, on one row and on two rows, some at an odd place."""
    rng = np.random.default_rng(seed)
    kinds = [tdev.Q_RANK, tdev.Q_LF, tdev.Q_SAMPLE]
    kinds += [tdev.Q_ROW] if W >= 20 else []
    kinds += [tdev.Q_TEXT] if W >= 32 else []
    n = 4000
    kind = rng.choice(kinds, n).astype(np.int32)
    k = rng.integers(0, idx.length + 1, n).astype(np.int32)
    k[:4] = [0, 128, idx.length, idx.length - 1]
    c = rng.integers(1, idx.alen, n).astype(np.int32)
    x = np.where(kind == tdev.Q_SAMPLE, k % sh.sa_seq.shape[0],
                 np.where(kind == tdev.Q_LF, np.minimum(k, idx.length - 1),
                          np.where(kind == tdev.Q_TEXT,
                                   k % (sh.S * sh.ntb_s), k)))
    op = kind << 8 | np.where(kind == tdev.Q_RANK, c, 0)
    rows = [np.stack([op, x], 1)]
    for t in range(600):  # the pairs: one row (a narrow interval), or two
        a0 = int(rng.integers(0, idx.length))
        a1 = (min(idx.length, (a0 | 127) + 1 - int(rng.integers(0, 4)))
              if t % 3 else int(rng.integers(a0, idx.length + 1)))
        a1 = max(a1, a0)
        cc = int(rng.integers(1, idx.alen))
        pair = [[tdev.Q_RANK << 8 | cc, a0], [tdev.Q_RANK << 8 | cc, a1]]
        if t % 5 == 0:  # a lone query first: the pair at an odd place
            pair.insert(0, [tdev.Q_LF << 8, a0])
        rows.append(np.array(pair))
    return torch.from_numpy(np.concatenate(rows).astype(np.int32))


@pytest.mark.parametrize("count", ["even", "odd", "none"])
@pytest.mark.parametrize("W", [1, 2, 20, 32])
def test_fm_serve_round_matches_plain(env, cuda, W, count):
    """N on a round of an even or odd count of queries (its groups take
    two each), or none, every kind of the width in one round, parked
    lanes' pairs on one row and on two: one launch (none for no query),
    its answers its plain version's, `bad` 0; on a view with shard 1
    remote, the queries to it count in bad, their answers 0, the rest
    equal."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    idx = env["idx"]
    sh_c, sh_g = ShardedIndex(idx, 3, "cpu"), ShardedIndex(idx, 3, cuda)
    q = _serve_queries(idx, sh_c, W, W)
    even = q.shape[0] - q.shape[0] % 2
    q = q[:{"even": even, "odd": even - 1, "none": 0}[count]]
    want, _b = tdev.fm_serve_plain(sh_c.rec, sh_c.C, sh_c.sa_seq,
                                   sh_c.sa_off, q, W, text=sh_c.text)
    kernels.reset_counts()
    qg = q.to(cuda)
    got, bad = tdev.fm_serve(sh_g.rec, sh_g.C, sh_g.sa_seq, sh_g.sa_off,
                             qg, W, sh_g.text)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fm_serve"] == int(q.shape[0] > 0)
    assert int(bad) == 0 and torch.equal(got.cpu(), want)
    if not q.shape[0]:
        return
    view = _hosts_view(sh_g, (1,))
    got, bad = tdev.fm_serve(view.rec, view.C, view.sa_seq, view.sa_off,
                             qg, W, view.text)
    shard = tdev.query_shard(sh_c.rec, sh_c.sa_seq, q, sh_c.text)
    far = shard == 1
    torch.cuda.synchronize()
    assert int(bad) == int(far.sum()) > 0
    assert torch.equal(got.cpu()[~far], want[~far])
    assert not got.cpu()[far].any()


@pytest.mark.parametrize("sw", [0, 12], ids=["no_stop", "hybrid_stop"])
@pytest.mark.parametrize("remote", [(1,), (0, 2)], ids=["one", "two"])
def test_mem_extend_hosts_resume_matches_plain(env, cuda, remote, sw):
    """O's resume form, round after round on the same answers as its plain
    version (the lanes matched by position), equals it: out, and the lanes
    parked again with their records (p, i, s0, s1, q) and queries.  Over
    the rounds, resumed lanes end on the answer (the interval empties),
    reach i = 0, stop at the hybrid's stop (sw), and park again."""
    from kaiju_tpu_torch.ops import hybrid
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    assert sw in (0, hybrid.S1_STEPS)
    idx, dv = env["idx"], env["dv"]
    views = {d: _hosts_view(ShardedIndex(idx, 3, d), remote)
             for d in ("cpu", cuda)}
    flat, frag_off, _rf = _batch(env, 16)
    seed = env["seed"]
    K = search.SEED_K

    def ext(d, **kw):
        v = views[d]
        return search.mem_extend_hosts(
            v.rec, v.C, *(a.to(d) for a in seed), flat.to(d),
            frag_off.to(d), K, MIN_LEN - 1, sw_steps=sw, **kw)

    out_c, pk_c, q_c = ext("cpu")
    out_g, pk_g, q_g = ext(cuda)
    base = search._lane_fragments(frag_off, flat.shape[0])[2]
    seen = dict.fromkeys(("answer", "zero", "stop", "again"), 0)
    rounds = 0
    while pk_c.shape[0]:
        rounds += 1
        assert torch.equal(out_g.cpu(), out_c)
        assert torch.equal(_sorted_rows(pk_g), _sorted_rows(pk_c))
        order_g = torch.argsort(pk_g[:, 0].cpu().long())
        order_c = torch.argsort(pk_c[:, 0].long())
        assert torch.equal(q_g.cpu()[order_g], q_c[order_c])
        ans = views["cpu"].exchange.serve(q_c.reshape(-1, 2), 1,
                                          "extend").view(-1, 2)
        ans_g = ans[order_c][torch.argsort(order_g)].to(cuda).contiguous()
        before = pk_c.clone()
        out_c, pk_c, q_c = ext("cpu", out=out_c, parked=pk_c, answers=ans)
        out_g, pk_g, q_g = ext(cuda, out=out_g, parked=pk_g, answers=ans_g)
        torch.cuda.synchronize()
        again = set(pk_c[:, 0].tolist())
        for (p, _i, _a0, _a1, _q), (n0, n1) in zip(before.tolist(),
                                                   ans.tolist()):
            i, s0, s1 = out_c[:, p].tolist()
            if p in again:
                seen["again"] += 1
            elif n0 >= n1:
                seen["answer"] += 1
            elif i == 0:
                seen["zero"] += 1
            elif (p - int(base[p]) - K + 1 - i == sw
                  and s1 - s0 <= search.SW_WCAP):  # the steps it took
                seen["stop"] += 1
    assert torch.equal(out_g.cpu(), out_c) and pk_g.shape[0] == 0
    want = search.mem_extend_plain(dv.rec, dv.C, *seed, flat, frag_off, K,
                                   MIN_LEN - 1, sw_steps=sw)
    for g, w in zip(out_g, want):
        assert torch.equal(g.cpu(), w)
    assert rounds > 1 and seen["answer"] and seen["zero"] and seen["again"]
    assert bool(seen["stop"]) == bool(sw), seen


# ---------------------------------------------------------------------------
# kernel Y and the hybrid's forms of N, O, X, U, V, W across hosts
# ---------------------------------------------------------------------------


def _by_first(t):
    """Rows in the order of their first column (a kernel parks in no fixed
    order), on the CPU."""
    t = t.cpu()
    return t[torch.argsort(t[:, 0].long(), stable=True)]


@pytest.mark.parametrize("remote", [(1,), (0, 2)], ids=["one", "two"])
def test_hybrid_hosts_kernels_match_plain(env, cuda, remote):
    """On the text index in 3 shards with the shards `remote` on another
    host: N's TEXT rows, O with the hybrid's stop (start and resume), Y's
    three forms (start, a resume of each stage, finish) and its rounds, W's
    and V's list forms with the virtual rows' ids, each equal to its plain
    version on the same arguments; Y in rounds gives switch_plain's, and
    the MEM hosts batch with the hybrid gives fused_mem_classify's rows
    with G on the card."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.ops import hybrid
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    idx, dv = env["idx"], env["dv"]
    assert idx.text is not None
    views = {d: _hosts_view(ShardedIndex(idx, 3, d), remote)
             for d in ("cpu", cuda)}
    vc, vg = views["cpu"], views[cuda]
    kernels.reset_counts()
    # N: text rows, every row and past the end
    ntb = vc.ntb_s
    rows = torch.arange(3 * ntb + 2, dtype=torch.int32)
    q = torch.stack([torch.full_like(rows, tdev.Q_TEXT << 8), rows], 1)
    whole = ShardedIndex(idx, 3, cuda)
    got, bad = tdev.fm_serve(whole.rec, whole.C, whole.sa_seq, whole.sa_off,
                             q.to(cuda), 32, whole.text)
    want, _b = tdev.fm_serve_plain(
        *(getattr(ShardedIndex(idx, 3, "cpu"), a) for a in
          ("rec", "C", "sa_seq", "sa_off")), q[:-2], 32,
        text=ShardedIndex(idx, 3, "cpu").text)
    torch.cuda.synchronize()
    assert int(bad) == 2 and torch.equal(got.cpu()[:-2], want)
    got, bad = tdev.fm_serve(vg.rec, vg.C, vg.sa_seq, vg.sa_off,
                             q[:-2].to(cuda), 32, vg.text)
    far = ~vc.text.here[vc.text.owner(rows[:-2].long() * 128)]
    assert int(bad) == int(far.sum()) > 0
    assert torch.equal(got.cpu()[~far], want[~far])
    # O with sw_steps: start, one resume, then the rounds
    flat, frag_off, rf_rows = _batch(env, 16)
    seed = env["seed"]

    def ext(d, **kw):
        v = views[d]
        return search.mem_extend_hosts(
            v.rec, v.C, *(a.to(d) for a in seed), flat.to(d),
            frag_off.to(d), search.SEED_K, MIN_LEN - 1,
            sw_steps=hybrid.S1_STEPS, **kw)

    res = {d: ext(d) for d in views}
    assert torch.equal(res[cuda][0].cpu(), res["cpu"][0])
    assert torch.equal(_by_first(res[cuda][1]), _by_first(res["cpu"][1]))
    for d in views:
        out, pk, qs = res[d]
        views[d].exchange.rounds("extend", pk, qs, 1, lambda p, a, d=d,
                                 out=out: ext(d, out=out, parked=p,
                                              answers=a.reshape(-1, 2))[1:])
    want = search.mem_extend_plain(dv.rec, dv.C, *seed, flat, frag_off,
                                   search.SEED_K, MIN_LEN - 1,
                                   sw_steps=hybrid.S1_STEPS)
    for g, c, w in zip(res[cuda][0], res["cpu"][0], want):
        assert torch.equal(g.cpu(), w) and torch.equal(c, w)
    i, s0, s1 = want
    lanes = hybrid.switched(i, s0, s1, frag_off,
                            search.SEED_K + hybrid.S1_STEPS)
    base = search._lane_fragments(frag_off, flat.shape[0])[2]
    sw = (s0[lanes], s1[lanes], base[lanes] + i[lanes], i[lanes])
    assert sw[0].shape[0] > 10
    # Y: start form, a resume of each stage on the same answers, finish
    st = {d: hybrid.switch_state(sw[2].to(d), sw[3].to(d)) for d in views}

    def y(d, form, **kw):
        v = views[d]
        return hybrid.switch_hosts(form, v.rec, v.C, v.sa_seq, v.sa_off,
                                   v.text, v.rank_start, v.nseq, v.chpt_exp,
                                   flat.to(d), st[d], **kw)

    pk = {d: y(d, 0, s0=sw[0].to(d), s1=sw[1].to(d)) for d in views}
    for a, b in zip(st[cuda], st["cpu"]):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(_by_first(pk[cuda][0]), _by_first(pk["cpu"][0]))
    for kind, width in ((hybrid.WALK, 2), (hybrid.TEXT, 32)):
        sel = {d: pk[d][0][:, 1] == kind for d in views}
        ps = {d: _by_first(pk[d][0][sel[d]]) for d in views}
        order = torch.argsort(pk["cpu"][0][sel["cpu"]][:, 0].long())
        qs = pk["cpu"][1][sel["cpu"]][order]
        if not qs.shape[0]:
            continue
        ans = vc.exchange.serve(qs.reshape(-1, 2), width, "switch")
        again = {d: y(d, 1, parked=ps[d].to(d),
                      answers=ans.to(d).contiguous()) for d in views}
        for a, b in zip(st[cuda], st["cpu"]):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(_by_first(again[cuda][0]),
                           _by_first(again["cpu"][0]))
    fin = {d: y(d, 2) for d in views}
    for a, b in zip(fin[cuda], fin["cpu"]):
        assert torch.equal(a.cpu(), b)
    want = hybrid.switch_plain(*sw, flat, dv.text, dv.rank_start, dv.rec,
                               dv.C, dv.sa_seq, dv.sa_off, dv.nseq,
                               dv.chpt_exp)
    got = hybrid.switch_in_rounds(vg, vg.exchange, *(t.to(cuda) for t in sw),
                                  flat.to(cuda), vg.rank_start)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    # W's and V's list forms with the virtual rows' ids (G's layout)
    tail = (dv.rec, dv.C, *seed, flat, frag_off, search.SEED_K, MIN_LEN - 1)
    lanes_g = hybrid.text_extend_plain(
        *search.mem_extend_plain(*tail, sw_steps=hybrid.S1_STEPS), flat,
        frag_off, search.SEED_K + hybrid.S1_STEPS, dv.text, dv.rank_start,
        dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.nseq, dv.chpt_exp)
    stats = search.mem_stats_plain(*lanes_g[:3], frag_off, MIN_LEN, T)
    d_args = (*stats[:2], *stats[3:], rf_rows)
    sw_ids = lanes_g[3]
    R = 32
    want = classify.read_lca_list(*d_args, R, sw_ids)
    got = classify.read_lca_list(*(a.to(cuda) for a in d_args), R,
                                 sw_ids.to(cuda))
    torch.cuda.synchronize()
    assert len(got) == 3
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool((want[2] >= 0).any())  # virtual rows listed
    g_s0, g_s1 = stats[3], stats[4]  # each fragment's ties as ranges
    want = classify.ranges_lca_list(g_s0, g_s1, R, sw_ids)
    got = classify.ranges_lca_list(g_s0.to(cuda), g_s1.to(cuda), R,
                                   sw_ids.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    # the MEM hosts batch with the hybrid against B -> G -> C -> D
    gpu = _args(env, flat, frag_off, rf_rows, 32, cuda)
    want = classify.fused_mem_classify(*gpu, hyb=(dv.text.to(cuda),
                                                  dv.rank_start.to(cuda)))
    got = classify.fused_mem_classify_hosts(
        vg, vg.exchange, gpu[2], gpu[3], gpu[4], gpu[5], vg.seq_tax,
        gpu[9], gpu[10], search.SEED_K, MIN_LEN - 1, MIN_LEN, T, 32, CAP,
        hyb=(vg.text, vg.rank_start))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    for name in ("fm_serve", "mem_extend_hosts", "switch_hosts",
                 "read_lca_hosts", "walk_hosts"):
        assert kernels.LAUNCHES[name] > 0, name


@pytest.mark.parametrize("e", [1, 3])
def test_greedy_hybrid_hosts_kernels_match_plain(env, cuda, e):
    """X with the last level's stop, Y, U's settle with virtual tie rows
    and V's list form with their ids, on the text index in 3 shards with
    shard 1 on another host: greedy_search_hosts with the hybrid on the
    card equals its plain version and the one-host greedy_search_plain
    with the hybrid (best, flags, g_s0, g_s1, sw_ids), and the batch's
    rows equal B -> E -> F with the hybrid on the card."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    idx, dv = env["idx"], env["dv"]
    views = {d: _hosts_view(ShardedIndex(idx, 3, d), (1,))
             for d in ("cpu", cuda)}
    flat, frag_off, rf_rows = _batch(env, 16, "greedy")
    Lmap, mfl, min_score, _e, T_, vcap = GREEDY_PARAMS
    lanes = search.mem_extend_plain(dv.rec, dv.C, *env["seed"], flat,
                                    frag_off, search.SEED_K, Lmap - 1)
    kernels.reset_counts()
    got = {}
    for d in views:
        v = views[d]
        got[d] = greedy.greedy_search_hosts(
            v, v.exchange, *(t.to(d) for t in lanes), flat.to(d),
            frag_off.to(d), rf_rows.to(d),
            tuple(t.to(d) for t in env["tables"]), Lmap, mfl, min_score, e,
            T_, vcap, hyb=(v.text, v.rank_start))
    want = greedy.greedy_search_plain(
        *lanes, flat, frag_off, rf_rows, dv.rec, dv.C, env["tables"], Lmap,
        mfl, min_score, e, T_,
        hyb=(dv.text, dv.rank_start, dv.sa_seq, dv.sa_off, dv.nseq,
             dv.chpt_exp))
    torch.cuda.synchronize()
    for g, c, w in zip(got[cuda], got["cpu"], want):
        assert torch.equal(g.cpu(), w) and torch.equal(c, w)
    for name in ("greedy_variants_hosts", "switch_hosts", "greedy_levels"):
        assert kernels.LAUNCHES[name] > 0, name
    gpu = _greedy_args(env, env["reads"], e, cuda, vcap)
    (rec, C, seed, gflat, gfrag, grf, sa_seq, sa_off, seq_tax, par, dep,
     tables, K, lmap, mfl_, ms, e_, T2, R, cap, _n, _c, vc) = gpu
    want = greedy.fused_greedy_classify(
        *gpu, hyb=(dv.text.to(cuda), dv.rank_start.to(cuda)))
    v = views[cuda]
    got = greedy.fused_greedy_classify_hosts(
        v, v.exchange, seed, gflat, gfrag, grf, seq_tax, par, dep, tables,
        K, lmap, mfl_, ms, e_, T2, R, cap, vc, hyb=(v.text, v.rank_start))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert kernels.LAUNCHES["ranges_lca_hosts"] > 0
