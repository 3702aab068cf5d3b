"""The port's text-compare hybrid on a text-carrying index, on the CPU:
kernel G's plain version (ops/hybrid.py:text_extend_plain) against
kaiju_tpu's _switch_pool with _walk_pos, and the rows of
fused_mem_classify (B screened -> G -> C -> D) and fused_greedy_classify
(B screened -> E with its last-level hybrid -> F) against kaiju_tpu's with
its Bloom screen and hybrid on, and against the port with both off.
Integer outputs, tolerance 0.  Virtual rows are numbered differently by
the two packages (a layout, not a semantic), so switched lanes are held to
their decoded id lists, and the classify rows whole.

The JAX programs with the hybrid run in one fresh subprocess: this
jaxlib can crash compiling them in a process that has already compiled
many others (tests/test_mem_fast.py:116-120).  The kernels themselves are
held against these plain versions in tests/test_torch_kernels.py."""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from kaiju_tpu.engine.fragments_native import NativeFragmenter2
from kaiju_tpu.engine.greedy_device import greedy_scoring_tables as jax_tables
from kaiju_tpu.index import py_builder as jax_py_builder
from kaiju_tpu.index.alphabet import trans_table
from kaiju_tpu.io.taxonomy import Taxonomy
from kaiju_tpu.ops.bloom import load_words
from kaiju_tpu.ops.kmer import KmerTables as JaxKmerTables
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.ops import classify, greedy, hybrid, search
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.ops.bloom import BloomScreen

from conftest import make_db_records
from readgen import make_reads, reverse_translate

K, MIN_LEN, LMAP, MIN_SCORE = 5, 11, 7, 65
T_MEM, T_GREEDY, R, CAP, S = 8, 20, 32, 20, 16
SW_LEN = K + hybrid.S1_STEPS
NODES = {1: 1, 10: 1, 100: 10, 200: 10, 300: 10, 101: 100, 102: 100,
         103: 100, 201: 200, 202: 200, 301: 300}
P_PAD, F_PAD = 65536, 16384

WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(sys.argv[3]))
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from kaiju_tpu.index import py_builder
from kaiju_tpu.ops import device_index as jdev
from kaiju_tpu.ops.fused_classify import fused_mem_classify
from kaiju_tpu.ops.fused_greedy import fused_greedy_classify
from kaiju_tpu.ops.fused_mem2 import _switch_pool, _walk_pos, build_flatp

d = dict(np.load(sys.argv[1]))
records = json.loads(str(d.pop("records")))
idx = py_builder.build_index(records)
jd = jdev.DeviceIndex(idx)
textp, rank_start = jd.textp, jd.rank_start  # placed before any trace
nseq, cx = idx.nseq, idx.chpt_exp
tax = jnp.asarray(idx.seq_taxids.astype(np.int32))
seed = tuple(jnp.asarray(d[f"seed{t}"]) for t in range(3))
out = {}


def walk(kf):
    return _walk_pos(jd.rec, jd.C, jd.sa_seq, jd.sa_off, nseq, cx, kf)


for tag in ("real", "rand"):  # the switch pool on the given lanes
    flat = jnp.asarray(d[tag + "_flat"])
    cap = int(d[tag + "_cap"])

    @jax.jit
    def pool(start_i, s0, s1, base):
        hyb = dict(textp=textp, rank_start=rank_start,
                   flatp=build_flatp(flat), nseq=nseq, chpt_exp=cx,
                   walk_pos=walk)
        act = jnp.ones(start_i.shape, bool)
        return _switch_pool(hyb, start_i, s0, s1, base, act, cap)[:5]

    res = pool(*(jnp.asarray(d[f"{tag}_{k}"]) for k in
                 ("start_i", "s0", "s1", "base")))
    for k, v in zip(("in_pool", "sw_i", "sw_s0", "sw_s1", "sw_ids"), res):
        out[f"{tag}_{k}"] = np.asarray(v)

bw = jnp.asarray(d["bloom_mem"])
out["mem"] = np.asarray(fused_mem_classify(
    jd.rec, jd.C, seed, d["mem_flat"], d["mem_off"], d["mem_rf"], jd.sa_seq,
    jd.sa_off, tax, jnp.asarray(d["par"]), jnp.asarray(d["dep"]), jd.rec2,
    bw, jd.textp, jd.rank_start, 5, 10, 11, int(d["mem_flat"].shape[0]),
    16384, 8, 32, 20, nseq, cx, 11, int(d["lb"]), 4))
bw = jnp.asarray(d["bloom_greedy"])
caps = (65536, 16384, 16384, 65536, 16384, 65536)
for e in (1, 3):
    arrays = (jd.rec, jd.C, jd.rec2, seed, bw, jd.sa_seq, jd.sa_off, tax,
              jnp.asarray(d["par"]), jnp.asarray(d["dep"]), jd.textp,
              jd.rank_start, d["g_flat"], d["g_off"], d["g_rid"],
              *(jnp.asarray(d[f"tab{t}"]) for t in range(4)))
    statics = (int(d["g_B"]), 5, 6, 7, 11, 65, e, *caps, 20, 32, 20, nseq,
               cx, 7, int(d["lb"]), 4)
    out[f"greedy{e}"] = np.asarray(fused_greedy_classify(*arrays, *statics))
np.savez(sys.argv[2], **out)
"""


def _bucket(n, lo):
    b = lo
    while b < n:
        b *= 2
    return b


def _random_lanes(rng, td, idx, n=300):
    """n narrow intervals (1-8 occurrences) as kernel B's lanes, one
    fragment each, stopped at length SW_LEN with i letters left; the
    letters before each lane copy the text before one of its occurrences,
    with a mismatch, a letter past a sequence's end or nothing changed, so
    that the extensions differ between occurrences."""
    length = int(idx.length)
    frags, lanes = [], []
    for t in range(n):
        width = rng.randint(1, 8)
        s0 = rng.randrange(0, length - width)
        start_i = rng.randint(1, 60)
        k = torch.tensor([s0 + rng.randrange(width)], dtype=torch.int32)
        iseq, pos = tdev.sa_walk(td.rec, td.C, td.sa_seq, td.sa_off,
                                 td.nseq, td.chpt_exp, k)
        p = int(td.rank_start[int(iseq[0])]) + int(pos[0])
        left = idx.text[max(p - start_i, 0):p].astype(np.uint8)
        left = np.concatenate([np.full(start_i - left.shape[0], 1 + t % 20,
                                       np.uint8), left])
        left = np.where(left == 0, 7, left)  # the query has no separators
        if t % 3 == 1:
            left[rng.randrange(start_i)] = rng.randint(1, 20)
        codes = np.concatenate([left, np.full(SW_LEN, 3, np.uint8)])
        frags.append(codes)
        lanes.append((start_i, s0, s0 + width))
    frag_off = np.zeros(n + 1, dtype=np.int32)
    frag_off[1:] = np.cumsum([f.shape[0] for f in frags])
    flat = np.concatenate(frags)
    P = flat.shape[0]
    j = np.arange(P) - np.repeat(frag_off[:-1], [f.shape[0] for f in frags])
    i = (j + 1).astype(np.int32)
    s0 = np.zeros(P, np.int32)
    s1 = np.zeros(P, np.int32)
    at = frag_off[1:] - 1  # each fragment's lane: its last position
    i[at], s0[at], s1[at] = np.array(lanes, dtype=np.int32).T
    return flat, frag_off, i, s0, s1


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = random.Random(121)
    records = make_db_records(rng, nseq=40)
    jidx = jax_py_builder.build_index(records)
    tidx = py_builder.build_index(records)
    td = tdev.DeviceIndex(tidx, "cpu")
    seed = JaxKmerTables.build(jidx, K).planar_seed(K)
    tseed = tuple(torch.from_numpy(a) for a in seed)
    par, dep = Taxonomy(NODES).dense_arrays()
    reads = [(n, s, None) for n, s in make_reads(rng, records, n=150)]
    for t in range(50):  # long exact copies: matches outlive the burn-in
        _, prot = records[rng.randrange(len(records))]
        plen = min(len(prot), rng.randint(hybrid.S1_STEPS + 10, 150))
        st = rng.randrange(0, len(prot) - plen + 1)
        dna = reverse_translate(rng, prot[st:st + plen])
        if t % 2:  # a point mutation: a variant for the Greedy levels
            x = rng.randrange(len(dna))
            dna = dna[:x] + "ACGT"[("ACGT".index(dna[x]) + 1) % 4] + dna[x + 1:]
        reads.append((f"long{t}", dna, None))
    work = tmp_path_factory.mktemp("torch_hybrid")
    inp = {"records": json.dumps(records), "par": par, "dep": dep,
           **{f"seed{t}": a for t, a in enumerate(seed)}}
    lb = None
    for path, m in (("mem", MIN_LEN), ("greedy", LMAP)):
        words, _m, lb = load_words(jidx, None, m)
        inp[f"bloom_{path}"] = words
    inp["lb"] = np.int32(lb)

    # the MEM batch, and its switched lanes from the port's B
    flat, chars, frag_off, n_frags, _k, rf, _o = NativeFragmenter2(
        "mem", MIN_LEN, MIN_SCORE, True, False).run(reads, S, _bucket)
    B = rf.shape[0]
    rf_pad = np.full((_bucket(B, 512), S), -1, dtype=np.int32)
    rf_pad[:B] = rf
    inp.update(mem_flat=flat, mem_off=frag_off, mem_rf=rf_pad)
    mflat = torch.from_numpy(flat[:chars])
    moff = torch.from_numpy(frag_off[: n_frags + 1])
    screen = BloomScreen(inp["bloom_mem"], MIN_LEN, lb, "cpu").args
    lanes = search.mem_extend(td.rec, td.C, *tseed, mflat, moff, K,
                              MIN_LEN - 1, bloom=screen,
                              sw_steps=hybrid.S1_STEPS)
    sw = hybrid.switched(*lanes, moff, SW_LEN)
    _pos, _f, base, _fl = search._lane_fragments(moff, chars)
    real = {"flat": flat[:chars], "start_i": lanes[0][sw], "s0": lanes[1][sw],
            "s1": lanes[2][sw], "base": base[sw]}
    rand = _random_lanes(rng, td, tidx)
    r_at = torch.from_numpy(rand[1][1:] - 1).long()
    rand_pool = {"flat": rand[0], "start_i": torch.from_numpy(rand[2])[r_at],
                 "s0": torch.from_numpy(rand[3])[r_at],
                 "s1": torch.from_numpy(rand[4])[r_at],
                 "base": torch.from_numpy(rand[1][:-1])}
    for tag, lanes_ in (("real", real), ("rand", rand_pool)):
        for k, v in lanes_.items():
            inp[f"{tag}_{k}"] = np.asarray(v)
        inp[f"{tag}_cap"] = np.int32(_bucket(int(
            (lanes_["s1"] - lanes_["s0"]).sum()) + 1, 128))

    # the Greedy batch, padded as the JAX pipeline pads it
    gflat, gchars, goff, gnf, _k, grf, _o = NativeFragmenter2(
        "greedy", MIN_LEN, MIN_SCORE, True, False).run(reads, S, _bucket)
    Bp = _bucket(B, 512)
    flat_p = np.zeros(P_PAD, np.uint8)
    flat_p[:gchars] = gflat[:gchars]
    off_p = np.full(F_PAD + 1, gchars, np.int32)
    off_p[: gnf + 1] = goff[: gnf + 1]
    rid = np.full(F_PAD, Bp, np.int32)
    rows_, slots = np.nonzero(grf >= 0)
    rid[grf[rows_, slots]] = rows_
    tables = jax_tables(jidx.alphabet, trans_table(jidx.alphabet))
    inp.update(g_flat=flat_p, g_off=off_p, g_rid=rid, g_B=np.int32(Bp),
               **{f"tab{t}": a for t, a in enumerate(tables)})

    in_npz, out_npz = str(work / "in.npz"), str(work / "out.npz")
    np.savez(in_npz, **inp)
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", WORKER, in_npz, out_npz,
                           os.path.join(here, "x")],
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(out_npz))
    return {
        "td": td, "tseed": tseed, "par": torch.from_numpy(par),
        "dep": torch.from_numpy(dep), "ref": ref, "B": B, "lb": lb,
        "inp": inp, "rand": rand, "real_lanes": lanes, "sw": sw,
        "mem": (mflat, moff, torch.from_numpy(rf)),
        "greedy": (torch.from_numpy(gflat[:gchars]),
                   torch.from_numpy(goff[: gnf + 1]), torch.from_numpy(grf)),
        "tables": tuple(torch.from_numpy(a) for a in tables),
    }


def _g_args(env, flat, frag_off):
    td = env["td"]
    return (flat, frag_off, SW_LEN, td.text, td.rank_start, td.rec, td.C,
            td.sa_seq, td.sa_off, td.nseq, td.chpt_exp)


def _jax_ids(ref, tag):
    """Per lane: (sw_i, the id list of its virtual row) from _switch_pool."""
    ids = ref[f"{tag}_sw_ids"]
    return [(int(i), ids[a - hybrid.VBASE:b - hybrid.VBASE].tolist())
            for i, a, b in zip(ref[f"{tag}_sw_i"], ref[f"{tag}_sw_s0"],
                               ref[f"{tag}_sw_s1"])]


@pytest.mark.parametrize("tag", ["real", "rand"])
def test_text_extend_matches_jax_switch_pool(env, tag):
    """G's plain version on the switched lanes of the first MEM batch
    ("real") and on random narrow lanes ("rand"): sw_i and the decoded id
    lists, in SA order, equal _switch_pool's."""
    ref = env["ref"]
    assert ref[f"{tag}_in_pool"].all()  # the JAX pool held every lane
    if tag == "real":
        i, s0, s1 = env["real_lanes"]
        flat, frag_off, _rf = env["mem"]
        lanes = torch.nonzero(env["sw"]).squeeze(1)
    else:
        flat, frag_off, i, s0, s1 = (torch.from_numpy(a) for a in env["rand"])
        lanes = (frag_off[1:] - 1).long()
    out_i, out_s0, out_s1, sw_ids = hybrid.text_extend_plain(
        i, s0, s1, flat, frag_off, *_g_args(env, flat, frag_off)[2:])
    got = [(int(out_i[p]), sw_ids[out_s0[p] - hybrid.VBASE:
                                  out_s1[p] - hybrid.VBASE].tolist())
           for p in lanes]
    want = _jax_ids(ref, tag)
    assert got == want
    assert len(got) > 100
    ext = [int(i[p]) - g for p, (g, _ids) in zip(lanes, got)]
    assert max(ext) > 20 and min(ext) == 0  # long and empty extensions
    assert any(len(ids) > 1 for _g, ids in got)  # several achieving ids
    if tag == "rand":  # some lanes keep only part of their interval
        assert any(len(ids) < int(s1[p] - s0[p])
                   for p, (_g, ids) in zip(lanes, got))
    keep = torch.ones_like(i, dtype=torch.bool)
    keep[lanes] = False  # other lanes pass through
    for a, b in ((out_i, i), (out_s0, s0), (out_s1, s1)):
        assert torch.equal(a[keep], b[keep])


def _screen(env, path):
    m = MIN_LEN if path == "mem" else LMAP
    return BloomScreen(env["inp"][f"bloom_{path}"], m, env["lb"], "cpu").args


def test_fused_mem_classify_hybrid_rows_match_jax(env):
    """B screened -> G -> C -> D against kaiju_tpu's fused_mem_classify with
    its Bloom screen and hybrid, and against the port without either."""
    td = env["td"]
    flat, frag_off, rf = env["mem"]
    args = (td.rec, td.C, env["tseed"], flat, frag_off, rf, td.sa_seq,
            td.sa_off, td.seq_tax, env["par"], env["dep"], K, MIN_LEN - 1,
            MIN_LEN, T_MEM, R, CAP, td.nseq, td.chpt_exp)
    got = classify.fused_mem_classify(
        *args, bloom=_screen(env, "mem"), hyb=(td.text, td.rank_start))
    want = env["ref"]["mem"]
    B = env["B"]
    assert want[-1, 0] <= env["inp"]["mem_flat"].shape[0]
    assert want[-1, 1] <= 16384  # no capacity retry
    np.testing.assert_array_equal(got.numpy(), want[:B])
    off = classify.fused_mem_classify(*args)
    assert torch.equal(got, off)
    assert (want[:B, 1] > 0).sum() > 100 and (want[:B, 1] > SW_LEN).sum() > 20


@pytest.mark.parametrize("mismatches", [1, 3])
def test_fused_greedy_classify_hybrid_rows_match_jax(env, mismatches):
    """B screened -> E (last-level hybrid) -> F against kaiju_tpu's
    fused_greedy_classify with its Bloom screen and hybrid (columns 0-3,
    the port's own FLAG_TIE_ORDER aside), and against the port without
    either; at -e 1 some ties are virtual rows (at -e 3 a last-level tie
    of this data never reaches the best)."""
    td = env["td"]
    flat, frag_off, rf = env["greedy"]
    args = (td.rec, td.C, env["tseed"], flat, frag_off, rf, td.sa_seq,
            td.sa_off, td.seq_tax, env["par"], env["dep"], env["tables"], K,
            LMAP, MIN_LEN, MIN_SCORE, mismatches, T_GREEDY, R, CAP, td.nseq,
            td.chpt_exp)
    got = greedy.fused_greedy_classify(
        *args, bloom=_screen(env, "greedy"), hyb=(td.text, td.rank_start))
    want = env["ref"][f"greedy{mismatches}"]
    B = env["B"]
    caps = np.asarray([65536, 16384, 16384, 65536, 16384, 65536])
    assert (want[-1, :6] <= caps).all()  # no capacity retry
    g = got.numpy().copy()
    g[:, 2] &= ~greedy.FLAG_TIE_ORDER
    np.testing.assert_array_equal(g, want[:B, :4])
    assert torch.equal(got, greedy.fused_greedy_classify(*args))
    lanes = search.mem_extend(td.rec, td.C, *env["tseed"], flat, frag_off, K,
                              LMAP - 1, bloom=_screen(env, "greedy"))
    found = greedy.greedy_search(
        *lanes, flat, frag_off, rf, td.rec, td.C, env["tables"], LMAP,
        MIN_LEN, MIN_SCORE, mismatches, T_GREEDY,
        hyb=(td.text, td.rank_start, td.sa_seq, td.sa_off, td.nseq,
             td.chpt_exp))
    assert (found[2] >= hybrid.VBASE).any() == (mismatches == 1)
    assert (want[:B, 1] > 0).sum() > 100
