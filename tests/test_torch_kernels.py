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
from kaiju_tpu_torch.engine.mem import _bucket
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.io.taxonomy import Taxonomy
from kaiju_tpu_torch.ops import classify, search
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
    kt = KmerTables.build(idx, search.SEED_K)
    par, dep = Taxonomy(NODES).dense_arrays()
    return {
        "idx": idx, "reads": reads, "dv": tdev.DeviceIndex(idx, "cpu"),
        "seed": tuple(torch.from_numpy(a) for a in kt.planar_seed(search.SEED_K)),
        "par": torch.from_numpy(par), "dep": torch.from_numpy(dep),
    }


def _batch(env, S):
    frag = NativeFragmenter2("mem", MIN_LEN, 65, True, False)
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


def test_wrappers_refuse_bad_cuda_inputs(env, cuda):
    dv = env["dv"]
    rec, C = dv.rec.to(cuda), dv.C.to(cuda)
    k = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        tdev.update_si(rec, C, k, k, k)
    k32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="on cpu"):
        tdev.update_si(rec, C, k32, k32, k32)
