"""Port fused_mem_classify (kernels B -> C -> D) against rows 0..B-1 of
kaiju_tpu's fused_mem_classify, with the production slot and position
budgets (S = 16, R = 32) and tiny ones (S = 2, R = 4) under which both
flags fire.  Integer outputs, tolerance 0.  The kernels themselves are
held against these plain versions in tests/test_torch_kernels.py."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaiju_tpu.engine.fragments_native import NativeFragmenter2
from kaiju_tpu.index import py_builder
from kaiju_tpu.io.taxonomy import Taxonomy
from kaiju_tpu.ops import device_index as jdev
from kaiju_tpu.ops import fused_classify as jfc
from kaiju_tpu.ops.kmer import KmerTables as JaxKmerTables
from kaiju_tpu_torch.ops import classify
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.ops import search

from conftest import make_db_records
from readgen import make_reads, reverse_translate

MIN_LEN = 11
J0 = MIN_LEN - 1
T = 8
CAP = 20
MS = 16384  # JAX strip-survivor capacity: large enough for no retry
NODES = {1: 1, 10: 1, 100: 10, 200: 10, 300: 10, 101: 100, 102: 100,
         103: 100, 201: 200, 202: 200, 301: 300}


def _bucket(n, lo):
    b = lo
    while b < n:
        b *= 2
    return b


@pytest.fixture(scope="module")
def env():
    rng = random.Random(51)
    records = make_db_records(rng, nseq=40)
    idx = py_builder.build_index(records)
    jd = jdev.DeviceIndex(idx)
    # host build: the same tables as build_device (test_torch_device_ops)
    # without its XLA compiles
    kt = JaxKmerTables.build(idx, search.SEED_K)
    reads = [(n, s, None) for n, s in make_reads(rng, records, n=180)]
    for t in range(12):  # periodic motifs: more ties than T
        _, prot = records[rng.randrange(len(records))]
        st = rng.randrange(0, len(prot) - 14)
        reads.append((f"rep{t}", reverse_translate(rng, ("W" + prot[st : st + 14]) * 9), None))
    par, dep = Taxonomy(NODES).dense_arrays()
    td = tdev.DeviceIndex.from_arrays(
        np.asarray(jd.rec), np.asarray(jd.C), np.asarray(jd.sa_seq),
        np.asarray(jd.sa_off), idx.seq_taxids, "cpu", nseq=idx.nseq,
        chpt_exp=idx.chpt_exp,
    )
    return {
        "idx": idx, "jd": jd, "seed": kt.planar_seed(search.SEED_K),
        "reads": reads, "par": par, "dep": dep, "td": td,
    }


def _inputs(env, S):
    frag = NativeFragmenter2("mem", MIN_LEN, 65, True, False)
    flat, chars, frag_off, n_frags, _k, rf_rows, _oflow = frag.run(
        env["reads"], S, _bucket)
    return flat, chars, frag_off, n_frags, rf_rows


def _port_rows(env, flat, frag_off, rf_rows, R):
    td = env["td"]
    return classify.fused_mem_classify(
        td.rec, td.C, tuple(torch.from_numpy(a) for a in env["seed"]),
        torch.from_numpy(flat), torch.from_numpy(frag_off),
        torch.from_numpy(rf_rows), td.sa_seq, td.sa_off, td.seq_tax,
        torch.from_numpy(env["par"]), torch.from_numpy(env["dep"]),
        search.SEED_K, J0, MIN_LEN, T, R, CAP, td.nseq, td.chpt_exp,
    )


@pytest.mark.parametrize("S,R", [(16, 32), (2, 4)])
def test_fused_mem_classify_rows_match_jax(env, S, R):
    idx, jd = env["idx"], env["jd"]
    flat, chars, frag_off, n_frags, rf_rows = _inputs(env, S)
    B = rf_rows.shape[0]
    Bp = _bucket(B, 512)
    rf_pad = np.full((Bp, S), -1, dtype=np.int32)
    rf_pad[:B] = rf_rows
    P = flat.shape[0]
    packed = np.asarray(jfc.fused_mem_classify(
        jd.rec, jd.C, tuple(jnp.asarray(a) for a in env["seed"]), flat,
        frag_off, rf_pad, jd.sa_seq, jd.sa_off,
        jnp.asarray(idx.seq_taxids.astype(np.int32)),
        jnp.asarray(env["par"]), jnp.asarray(env["dep"]), jd.rec2, None,
        None, None, search.SEED_K, J0, MIN_LEN, P, MS, T, R, CAP,
        idx.nseq, idx.chpt_exp, 0, 0, 4,
    ))
    assert packed[-1, 0] <= P and packed[-1, 1] <= MS  # no retry needed
    # the port takes the unpadded batch
    got = _port_rows(env, flat[:chars], frag_off[: n_frags + 1], rf_rows, R)
    np.testing.assert_array_equal(got.numpy(), packed[:B])
    flags = packed[:B, 2]
    assert (packed[:B, 1] > 0).sum() > 60
    if S == 2:  # both host-replay flags fire under the tiny budgets
        assert (flags & classify.FLAG_TIE_OVER).any()
        assert (flags & classify.FLAG_NEED_MORE).any()

