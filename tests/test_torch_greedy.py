"""Port fused_greedy_classify (kernels B -> E -> F) against rows 0..B-1,
columns 0-3, of kaiju_tpu's fused_greedy_classify at -e 0, 1 and 3, and
the port's ranges_lca (kernel F) against kaiju_tpu's ranges_lca, on the
CPU with the plain versions.  The DB holds two peptides, each in 26
sequences of distinct species, so that the order of a read's ties decides
its LCA.  Integer outputs, tolerance 0.  The kernels themselves are held
against these plain versions in tests/test_torch_kernels.py."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.engine.core import ExactClassifier, format_output_line
from kaiju_tpu.engine.fragments_native import NativeFragmenter2
from kaiju_tpu.engine.greedy_device import greedy_scoring_tables as jax_tables
from kaiju_tpu.index import py_builder
from kaiju_tpu.index.alphabet import trans_table
from kaiju_tpu.io.taxonomy import Taxonomy
from kaiju_tpu.ops import device_index as jdev
from kaiju_tpu.ops import fused_classify as jfc
from kaiju_tpu.ops.fused_greedy import fused_greedy_classify as jax_fgc
from kaiju_tpu.ops.kmer import KmerTables as JaxKmerTables
from kaiju_tpu.utils.aot import AotCache
from kaiju_tpu_torch.engine import greedy as tgreedy
from kaiju_tpu_torch.index import py_builder as torch_py_builder
from kaiju_tpu_torch.io.taxonomy import Taxonomy as TorchTaxonomy
from kaiju_tpu_torch.ops import classify, greedy
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.ops.search import mem_extend

from conftest import make_db_records
from readgen import make_reads, reverse_translate
from test_exact_parity import _diff, _lowcomp_reads

AA = "ACDEFGHIKLMNPQRSTVWY"
K, LMAP, MFL, MIN_SCORE, T, R, CAP = 5, 7, 11, 65, 20, 32, 20
S = 16
P_PAD, F_PAD = 65536, 16384  # one padded shape: one JAX compile per -e
FAMILY = 26  # sequences a peptide: more than cap + 1 taxa
NODES = {1: 1, 10: 1, 100: 10, 200: 10, 300: 10, 101: 100, 102: 100,
         103: 100, 201: 200, 202: 200, 301: 300, 400: 10, 500: 10,
         **{401 + t: 400 for t in range(FAMILY)},
         **{501 + t: 500 for t in range(FAMILY)}}


def _bucket(n, lo):
    b = lo
    while b < n:
        b *= 2
    return b


@pytest.fixture(scope="module")
def env():
    rng = random.Random(91)
    records = make_db_records(rng, nseq=40)
    # peptide A and its reverse B (same letters, so the same score), each
    # in FAMILY sequences of distinct species under genera 400 and 500
    pep_a = "".join(rng.choice(AA) for _ in range(22))
    pep_b = pep_a[::-1]
    for t in range(FAMILY):
        for pep, tx in ((pep_a, 401 + t), (pep_b, 501 + t)):
            flank = ["".join(rng.choice(AA) for _ in range(rng.randint(5, 25)))
                     for _ in range(2)]
            records.append((f"F{tx}.1_{tx}", flank[0] + pep + flank[1]))
    idx = py_builder.build_index(records)
    idx.text = None
    jd = jdev.DeviceIndex(idx)
    seed = JaxKmerTables.build(idx, K).planar_seed(K)
    par, dep = Taxonomy(NODES).dense_arrays()
    td = tdev.DeviceIndex.from_arrays(
        np.asarray(jd.rec), np.asarray(jd.C), np.asarray(jd.sa_seq),
        np.asarray(jd.sa_off), idx.seq_taxids, "cpu", nseq=idx.nseq,
        chpt_exp=idx.chpt_exp,
    )
    reads = [(n, s, None) for n, s in make_reads(rng, records, n=150)]
    reads += [(n, s, None) for n, s in _lowcomp_reads(rng, records, n=30)]
    for t in range(8):  # periodic motifs: more positions than R, and
        # (24 copies) more ties than T
        _, prot = records[rng.randrange(40)]
        st = rng.randrange(0, len(prot) - 14)
        reads.append((f"rep{t}", reverse_translate(
            rng, ("W" + prot[st:st + 14]) * (24 if t < 2 else 9)), None))
    # reads whose two best ties lie in different fragments or at different
    # places of one fragment (X: six random letters; TAA: a stop)
    x = "".join(rng.choice(AA) for _ in range(6))
    tie_reads = []
    for name, parts in (("A*B", (pep_a, None, pep_b)),
                        ("B*A", (pep_b, None, pep_a)),
                        ("AxB", (pep_a, x, pep_b)),
                        ("A*Bx", (pep_a, None, pep_b + x)),
                        ("B*Ax", (pep_b, None, pep_a + x)),
                        ("xA*B", (x + pep_a, None, pep_b)),
                        ("Ax*B", (pep_a + x, None, pep_b)),
                        ("AxBxA", (pep_a, x, pep_b + x + pep_a))):
        a, mid, b = parts
        dna = (reverse_translate(rng, a)
               + ("TAA" if mid is None else reverse_translate(rng, mid))
               + reverse_translate(rng, b))
        tie_reads.append((name, dna, None))
    tables = jax_tables(idx.alphabet, trans_table(idx.alphabet))
    return {
        "records": records, "idx": idx, "jd": jd, "seed": seed, "par": par,
        "dep": dep, "td": td, "reads": reads, "tie_reads": tie_reads,
        "tables": tables, "aot": AotCache(None),
    }


def _fragments(reads):
    frag = NativeFragmenter2("greedy", MFL, MIN_SCORE, True, False)
    return frag.run(reads, S, _bucket)


def _jax_rows(env, reads, e):
    """Rows [B, 8] of kaiju_tpu's fused_greedy_classify, capacities large
    enough for no retry."""
    idx, jd = env["idx"], env["jd"]
    flat, chars, frag_off, n_frags, _k, rf, _o = _fragments(reads)
    assert chars <= P_PAD and n_frags <= F_PAD
    B = len(reads)
    Bp = _bucket(B, 512)
    flat_p = np.zeros(P_PAD, np.uint8)
    flat_p[:chars] = flat[:chars]
    off_p = np.full(F_PAD + 1, chars, np.int32)
    off_p[: n_frags + 1] = frag_off[: n_frags + 1]
    frag_rid = np.full(F_PAD, Bp, np.int32)
    rows_, slots = np.nonzero(rf >= 0)
    frag_rid[rf[rows_, slots]] = rows_
    arrays = (jd.rec, jd.C, jd.rec2, tuple(jnp.asarray(a) for a in env["seed"]),
              None, jd.sa_seq, jd.sa_off,
              jnp.asarray(idx.seq_taxids.astype(np.int32)),
              jnp.asarray(env["par"]), jnp.asarray(env["dep"]), None, None,
              flat_p, off_p, frag_rid, *env["tables"])
    caps = (P_PAD, 16384, 16384, 65536, 16384, 65536)
    statics = (Bp, K, LMAP - 1, LMAP, MFL, MIN_SCORE, e, *caps, T, R, CAP,
               idx.nseq, idx.chpt_exp, 0, 0, 4)
    out = np.asarray(env["aot"].call("greedy", jax_fgc, arrays, statics))
    assert (out[Bp, :6] <= np.asarray(caps)).all()  # no retry needed
    return out[:B]


def _port_rows(env, reads, e, vcap=greedy.VCAP):
    td = env["td"]
    flat, chars, frag_off, n_frags, _k, rf, _o = _fragments(reads)
    return greedy.fused_greedy_classify(
        td.rec, td.C, tuple(torch.from_numpy(a) for a in env["seed"]),
        torch.from_numpy(flat[:chars]), torch.from_numpy(frag_off[: n_frags + 1]),
        torch.from_numpy(rf), td.sa_seq, td.sa_off, td.seq_tax,
        torch.from_numpy(env["par"]), torch.from_numpy(env["dep"]),
        tuple(torch.from_numpy(a) for a in env["tables"]), K, LMAP, MFL,
        MIN_SCORE, e, T, R, CAP, td.nseq, td.chpt_exp, vcap,
    ).numpy()


def _same_as_jax(got, want):
    """The port's rows equal the JAX rows, but for the port's own
    FLAG_TIE_ORDER bit (the JAX rows themselves are kept)."""
    g = got.copy()
    g[:, 2] &= ~greedy.FLAG_TIE_ORDER
    np.testing.assert_array_equal(g, want[:, :4])


@pytest.mark.parametrize("mismatches", [0, 1, 3])
def test_fused_greedy_classify_rows_match_jax(env, mismatches):
    want = _jax_rows(env, env["reads"], mismatches)
    got = _port_rows(env, env["reads"], mismatches)
    assert not (got[:, 2] & greedy.FLAG_SCRATCH).any()
    _same_as_jax(got, want)
    assert (want[:, 1] > 0).sum() > 100
    assert (want[:, 2] & greedy.FLAG_TIE_OVER).any()
    assert (want[:, 2] & greedy.FLAG_NEED_MORE).any()


def test_scratch_limit_flags_whole_reads(env):
    """With one source slot a read, the reads that need more get
    FLAG_SCRATCH and a zero row; every other row is unchanged."""
    full = _port_rows(env, env["reads"], 3)
    small = _port_rows(env, env["reads"], 3, vcap=1)
    over = (small[:, 2] & greedy.FLAG_SCRATCH) != 0
    assert 0 < over.sum() < len(over)
    np.testing.assert_array_equal(small[~over], full[~over])
    assert (small[over] == [0, 0, greedy.FLAG_SCRATCH, 0]).all()


def test_ranges_lca_plain_matches_jax(env):
    """Random SA ranges, empty rows, rows past R positions, and the tie
    ranges of the peptide reads (more than cap + 1 taxa)."""
    idx, jd, td = env["idx"], env["jd"], env["td"]
    rng = np.random.default_rng(7)
    B, G = 96, T
    s0 = rng.integers(0, idx.length, (B, G)).astype(np.int32)
    size = rng.choice([0, 0, 0, 1, 2, 5, 40], (B, G)).astype(np.int32)
    s1 = np.minimum(s0 + size, idx.length).astype(np.int32)
    s0[:8] = s1[:8] = 0  # reads without a tie
    # the peptide reads' ties, from the port's kernel E plain version
    flat, chars, frag_off, n_frags, _k, rf, _o = _fragments(env["tie_reads"])
    _t = torch.from_numpy
    i, a0, a1 = mem_extend(td.rec, td.C, *(_t(a) for a in env["seed"]),
                           _t(flat[:chars]), _t(frag_off[: n_frags + 1]), K,
                           LMAP - 1)
    _b, _f, t_s0, t_s1, _sw = greedy.greedy_search(
        i, a0, a1, _t(flat[:chars]), _t(frag_off[: n_frags + 1]), _t(rf),
        td.rec, td.C, tuple(_t(a) for a in env["tables"]), LMAP, MFL,
        MIN_SCORE, 3, T)
    s0 = np.concatenate([s0, t_s0.numpy()])
    s1 = np.concatenate([s1, t_s1.numpy()])
    assert ((s1 - s0).clip(0).sum(1) > R).any()

    walk = jax.jit(lambda kf: jfc._sa_walk_local(
        jd.rec, jd.C, jd.sa_seq, jd.sa_off, idx.nseq, idx.chpt_exp, kf))
    lca, n_ids, need_more, _tot = jfc.ranges_lca(
        jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(s1 > s0), walk,
        jnp.asarray(idx.seq_taxids.astype(np.int32)), jnp.asarray(env["par"]),
        jnp.asarray(env["dep"]), R, CAP, idx.nseq, idx.chpt_exp)
    got = classify.ranges_lca_plain(
        _t(s0), _t(s1), td.rec, td.C, td.sa_seq, td.sa_off, td.seq_tax,
        _t(env["par"]), _t(env["dep"]), R, CAP, td.nseq, td.chpt_exp)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(lca))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(n_ids))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(need_more))
    assert np.asarray(need_more).any() and (got[1].numpy() > CAP).any()


def test_tie_order_follows_the_reference(env):
    """Reads whose ties cover more than R positions over more than cap + 1
    taxa: the kept taxa, so the LCA, follow the order of the ties.  The
    JAX rows disagree with ExactClassifier on some of them (its strip nodes
    come before the other nodes of every fragment; the reference takes
    fragments in queue order).  The port keeps the JAX rows, flags every
    read whose result depends on the order, and its pipeline replays them,
    so its TSV equals the ExactClassifier's."""
    reads = env["tie_reads"]
    want = _jax_rows(env, reads, 3)
    got = _port_rows(env, reads, 3)
    _same_as_jax(got, want)
    cfg = KaijuConfig(mode="greedy", use_Evalue=False)
    exact = ExactClassifier(env["idx"], Taxonomy(NODES), cfg).classify_batch(reads)
    differ = [r for r, (_n, res) in enumerate(exact) if res.lca != want[r, 0]]
    assert differ  # the kaiju_tpu fault of ROADMAP.md queue 3
    order = got[:, 2] & greedy.FLAG_TIE_ORDER
    assert all(order[r] for r in differ)
    assert {want[r, 0] for r in range(len(reads)) if order[r]} == {400, 500}

    tidx = torch_py_builder.build_index(env["records"])
    tidx.text = None
    pipe = tgreedy.GreedyPipeline(tidx, TorchTaxonomy(NODES), cfg, device="cpu")
    port = "".join(format_output_line(n, r, False)
                   for n, r in pipe.classify_batch(reads))
    ref = "".join(format_output_line(n, r, False) for n, r in exact)
    assert port == ref, _diff(port, ref)
