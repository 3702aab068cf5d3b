"""Port (kaiju_tpu_torch) device index, rank, UpdateSI, SA walk and K-mer
seed tables against kaiju_tpu, on one small index.  Every output is an
integer, so the tolerance is 0.  Kernel A itself is held against its
plain version in tests/test_torch_kernels.py."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from kaiju_tpu.index import py_builder as jax_py_builder
from kaiju_tpu.ops import device_index as jdev
from kaiju_tpu.ops.kmer import KmerTables as JaxKmerTables
from kaiju_tpu_torch.index import native_builder, py_builder
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.ops.kmer import KmerTables

from conftest import make_db_records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def env():
    records = make_db_records(random.Random(31), nseq=30)
    jidx = jax_py_builder.build_index(records)
    jd = jdev.DeviceIndex(jidx)
    td = tdev.DeviceIndex.from_arrays(
        np.asarray(jd.rec), np.asarray(jd.C), np.asarray(jd.sa_seq),
        np.asarray(jd.sa_off), jidx.seq_taxids, "cpu", nseq=jidx.nseq,
        chpt_exp=jidx.chpt_exp,
    )
    return {"records": records, "jidx": jidx, "jd": jd, "td": td}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


@pytest.mark.parametrize("builder", ["py", "native"])
def test_port_index_and_records_match_jax(env, builder):
    """The port's own index builders and fused records reproduce the JAX
    package's index and device arrays."""
    mod = py_builder if builder == "py" else native_builder
    idx = mod.build_index(env["records"])
    jidx, jd = env["jidx"], env["jd"]
    np.testing.assert_array_equal(idx.bwt, jidx.bwt)
    np.testing.assert_array_equal(idx.sa_seq, jidx.sa_seq)
    np.testing.assert_array_equal(idx.sa_off, jidx.sa_off)
    assert idx.names == jidx.names
    np.testing.assert_array_equal(tdev.build_fused_records(idx),
                                  np.asarray(jd.rec))
    d = tdev.DeviceIndex(idx, "cpu")
    for name in ("rec", "C", "sa_seq", "sa_off"):
        np.testing.assert_array_equal(getattr(d, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    np.testing.assert_array_equal(d.seq_tax.numpy(), jidx.seq_taxids)


def test_rank_matches_fmindex(env):
    jidx, jd, td = env["jidx"], env["jd"], env["td"]
    rng = np.random.default_rng(5)
    N = 3000
    c = rng.integers(0, jidx.alen, N).astype(np.int32)
    k = rng.integers(0, jidx.length + 1, N).astype(np.int32)
    # every block boundary, including k == length
    k[:10] = np.minimum(np.arange(10) * 128, jidx.length)
    k[10] = jidx.length
    want = np.asarray(jdev.fmindex(jd.blocks, jd.occ, jd.C, c, k))
    got = tdev.rank(td.rec, td.C, _t(c), _t(k)).numpy()
    np.testing.assert_array_equal(got, want)


def _probes(jidx, n, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(1, jidx.alen, n).astype(np.int32)
    s0 = rng.integers(0, jidx.length, n).astype(np.int32)
    s1 = np.minimum(jidx.length, s0 + rng.integers(1, 300, n)).astype(np.int32)
    return c, s0, s1


def test_update_si_matches_probe_updates(env):
    jidx, jd, td = env["jidx"], env["jd"], env["td"]
    c, s0, s1 = _probes(jidx, 2000, 6)
    want = [np.asarray(a) for a in jdev.probe_updates(
        jd.blocks, jd.occ, jd.C, c, s0, s1)]
    got = [a.numpy() for a in tdev.update_si(td.rec, td.C, _t(c), _t(s0), _t(s1))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sa_walk_matches_sa_lookup_fused(env):
    jidx, jd, td = env["jidx"], env["jd"], env["td"]
    k = np.arange(jidx.nseq, jidx.length, dtype=np.int32)  # every position
    wi, wp = (np.asarray(a) for a in jdev.sa_lookup_fused(
        jd.rec, jd.C, jd.sa_seq, jd.sa_off, jidx.nseq, jidx.chpt_exp, k))
    gi, gp = tdev.sa_walk(td.rec, td.C, td.sa_seq, td.sa_off, jidx.nseq,
                          jidx.chpt_exp, _t(k))
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gp.numpy(), wp)


@pytest.mark.parametrize("K", [3, 5])
def test_kmer_tables_match(env, K):
    """Device build (kernel A's plain version) and host build both equal
    the JAX package's device-built tables and seed arrays."""
    jidx, jd, td = env["jidx"], env["jd"], env["td"]
    want = JaxKmerTables.build_device(jidx, K, jd)
    dev_built = KmerTables.build_device(jidx, K, td)
    host_built = KmerTables.build(jidx, K)
    for got in (dev_built, host_built):
        assert got.K == want.K
        for (g0, g1), (w0, w1) in zip(got.tables, want.tables):
            np.testing.assert_array_equal(g0, w0)
            np.testing.assert_array_equal(g1, w1)
        for g, w in zip(got.planar_seed(K), want.planar_seed(K)):
            np.testing.assert_array_equal(g, w)
    # tables made from the JAX package's arrays give the same seeds
    for g, w in zip(KmerTables(want.tables).planar_seed(K),
                    want.planar_seed(K)):
        np.testing.assert_array_equal(g, w)


def test_port_imports_neither_jax_nor_kaiju_tpu():
    """Every module of the port, and chip_smoke as a module, import
    without pulling in jax or any kaiju_tpu module."""
    code = r"""
import importlib, pathlib, sys
sys.path.insert(0, sys.argv[1])
pkg = pathlib.Path(sys.argv[1], "kaiju_tpu_torch")
mods = [".".join(p.relative_to(pkg.parent).with_suffix("").parts)
        .removesuffix(".__init__") for p in sorted(pkg.rglob("*.py"))]
assert len(mods) > 30, mods
for m in mods:
    importlib.import_module(m)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "kaiju_tpu" or m.startswith("kaiju_tpu."))
assert not bad, bad
print(len(mods))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code, REPO], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_entry_points_need_a_card_unless_cpu_is_asked(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdev.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdev.DeviceIndex(env["jidx"])
    assert tdev.resolve_device("cpu") == torch.device("cpu")
