"""Port MEM search (kernels B + C: mem_extend, mem_stats) against
kaiju_tpu's fused_mem_search2 rows 0..F-1, with T = 8 and W = 4, with the
JAX program unscreened and screened by the Bloom bitmap built from the
index text.  Integer outputs, tolerance 0.  The kernels themselves are
held against these plain versions in tests/test_torch_kernels.py."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaiju_tpu.index import py_builder
from kaiju_tpu.index.alphabet import encode_protein
from kaiju_tpu.ops import device_index as jdev
from kaiju_tpu.ops.bloom import load_words
from kaiju_tpu.ops.fused_mem2 import fused_mem_search2
from kaiju_tpu.ops.kmer import KmerTables as JaxKmerTables
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.ops import search
from kaiju_tpu_torch.ops.kmer import KmerTables

from conftest import make_db_records, random_protein

MIN_LEN = 11
J0 = MIN_LEN - 1
T = 8
W = 4


def _fragments(rng, records, n=160):
    """Exact DB substrings (some long enough to outlive the JAX burn-in),
    mutated copies, random junk, short and empty fragments."""
    frags = []
    for t in range(n):
        kind = t % 8
        _, prot = records[rng.randrange(len(records))]
        if kind == 6:
            frags.append(random_protein(rng, rng.randint(5, 60)))
            continue
        if kind == 7:
            frags.append("" if t % 16 == 7 else random_protein(rng, rng.randint(1, 10)))
            continue
        ln = rng.randint(min(12, len(prot)), min(120, len(prot)))
        st = rng.randrange(0, len(prot) - ln + 1)
        s = prot[st : st + ln]
        if kind in (1, 2):
            s = list(s)
            for _ in range(rng.randint(1, 3)):
                s[rng.randrange(len(s))] = rng.choice("ACDEFGHIKLMNPQRSTVWY")
            s = "".join(s)
        frags.append(s)
    for _ in range(6):  # ten copies of one DB motif: more ties than T
        _, prot = records[rng.randrange(len(records))]
        st = rng.randrange(0, len(prot) - 15 + 1)
        frags.append(("W" + prot[st : st + 15]) * 10)
    return frags


@pytest.fixture(scope="module")
def env():
    rng = random.Random(41)
    records = make_db_records(rng, nseq=40)
    idx = py_builder.build_index(records)
    jd = jdev.DeviceIndex(idx)
    # host build: the same tables as build_device (test_torch_device_ops)
    # without its XLA compiles
    kt = JaxKmerTables.build(idx, search.SEED_K)
    frags = _fragments(rng, records)
    enc = [encode_protein(f, idx.alphabet) for f in frags]
    total = sum(len(e) for e in enc)
    flat = np.zeros(total, dtype=np.uint8)
    frag_off = np.zeros(len(enc) + 1, dtype=np.int32)
    pos = 0
    for fi, e in enumerate(enc):
        frag_off[fi] = pos
        flat[pos : pos + len(e)] = e
        pos += len(e)
    frag_off[-1] = pos
    seed = kt.planar_seed(search.SEED_K)
    td = tdev.DeviceIndex.from_arrays(
        np.asarray(jd.rec), np.asarray(jd.C), np.asarray(jd.sa_seq),
        np.asarray(jd.sa_off), idx.seq_taxids, "cpu", nseq=idx.nseq,
        chpt_exp=idx.chpt_exp,
    )
    tseed = tuple(torch.from_numpy(a) for a in KmerTables(kt.tables).planar_seed(search.SEED_K))
    return {
        "idx": idx, "jd": jd, "seed": seed, "flat": flat,
        "frag_off": frag_off, "enc": enc, "td": td, "tseed": tseed,
    }


def _port(env):
    td = env["td"]
    i, s0, s1 = search.mem_extend(
        td.rec, td.C, *env["tseed"], torch.from_numpy(env["flat"]),
        torch.from_numpy(env["frag_off"]), search.SEED_K, J0,
    )
    return (i, s0, s1), search.mem_stats(
        i, s0, s1, torch.from_numpy(env["frag_off"]), MIN_LEN, T
    )


@pytest.mark.parametrize("screened", [False, True])
def test_mem_stats_rows_match_fused_mem_search2(env, screened):
    idx, jd = env["idx"], env["jd"]
    flat, frag_off = env["flat"], env["frag_off"]
    F = frag_off.shape[0] - 1
    P = 4096
    while P < flat.shape[0]:
        P *= 2
    jflat = np.zeros(P, dtype=np.uint8)
    jflat[: flat.shape[0]] = flat
    if screened:
        words, m, lb = load_words(idx, None, MIN_LEN)
        bloom, rec2 = jnp.asarray(words), jd.rec2
    else:
        bloom, m, lb, rec2 = None, 0, 0, None
    Ms = 4096
    packed = np.asarray(fused_mem_search2(
        jd.rec, jd.C, tuple(jnp.asarray(a) for a in env["seed"]), jflat,
        frag_off, rec2, bloom, search.SEED_K, J0, MIN_LEN, P, T, Ms, m, lb, W,
    ))
    assert packed[F, 0] <= P and packed[F, 1] <= Ms  # no capacity retry
    _lanes, stats = _port(env)
    maxl, tie_cnt, tie_j, tie_s0, tie_s1 = (a.numpy() for a in stats)
    np.testing.assert_array_equal(maxl, packed[:F, 0])
    np.testing.assert_array_equal(tie_cnt, packed[:F, 1])
    np.testing.assert_array_equal(tie_j, packed[:F, 2 : 2 + T])
    np.testing.assert_array_equal(tie_s0, packed[:F, 2 + T : 2 + 2 * T])
    np.testing.assert_array_equal(tie_s1, packed[:F, 2 + 2 * T :])
    assert (maxl > 0).sum() > 40 and tie_cnt.max() > T  # cases exercised


def test_mem_extend_lanes_are_maximal_extensions(env):
    """Every seeded lane's (i, s0, s1) is the maximal backward extension
    of kaiju_tpu's extend_all; unevaluated lanes are (j + 1, 0, 0)."""
    jd, enc, frag_off = env["jd"], env["enc"], env["frag_off"]
    (i, s0, s1), _ = _port(env)
    F = len(enc)
    L = max(len(e) for e in enc)
    codes = np.zeros((F, L), dtype=np.uint8)
    flen = np.array([len(e) for e in enc], dtype=np.int32)
    for fi, e in enumerate(enc):
        codes[fi, : len(e)] = e
    start, a0, a1 = (np.asarray(a) for a in jdev.extend_all(
        jd.blocks, jd.occ, jd.C, codes, flen))
    seed_d = env["seed"][2]
    seeded = 0
    for f in range(F):
        for j in range(flen[f]):
            p = frag_off[f] + j
            got = (int(i[p]), int(s0[p]), int(s1[p]))
            if j < J0:
                assert got == (j + 1, 0, 0)
                continue
            kid = sum((int(codes[f, j - t]) - 1) * 20**t
                      for t in range(search.SEED_K))
            if seed_d[kid] > 0:
                assert got == (start[f, j], a0[f, j], a1[f, j]), (f, j)
                seeded += 1
    assert seeded > 100
