"""The port's index above 2^31 letters on the CPU (K17: parallel.big_index,
ops.big_mem, tools.big_build, tools.big_classify) against
scripts/big_classify_demo.py at toy size.

The demo's build_db, save_sharded_ktx, load_mesh and make_mesh_mem_step
run once for the module in a fresh subprocess with x64 on a 4-device
virtual CPU mesh (never its main(), which writes BIGCLASSIFY.log at the
repository root); they return npz files.  The port builds the same
databases, saves them byte for byte as the demo does, and its
big_mem_step (the plain versions of kernels L and M on the CPU) gives the
four arrays of the JAX step on every lane, dtypes included, at S = 1, 2
and 4, on reads of the demo's four kinds, reads shorter than L and reads
with a code 0 inside.  The one difference is the demo's rank at k = N
when the last shard is full: there the port follows the host BigRank and
KaijuIndex.get_suffix, and the test records the lanes where the demo's
step differs.  Integer outputs: every comparison is exact."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kaiju_tpu_torch.index import native_builder
from kaiju_tpu_torch.ops import big_mem
from kaiju_tpu_torch.parallel.big_index import (BigIndex, build_db,
                                                save_sharded_ktx)
from kaiju_tpu_torch.tools import big_classify
from kaiju_tpu_torch.tools.big_classify import HostOracle, host_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = (1, 2, 4)
LETTERS, SEED, R, L = 200_000, 11, 32, 48
# the full last shard: N = 50,176 = 128 x 2 x 196
FAULT_LETTERS, FAULT_SEED, FAULT_L = 50_000, 25, 8

WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
job = json.load(open(sys.argv[1]))
sys.path.insert(0, os.path.join(job["root"], "scripts"))
import big_classify_demo as demo
import jax
import numpy as np

fh = open(os.devnull, "w")
for case in job["cases"]:
    db = demo.build_db(fh, case["letters"], 2, case["seed"], True)
    reads = np.load(case["reads"])
    for S in case["shards"]:
        path = os.path.join(job["work"], f"jax_{case['name']}_S{S}")
        meta = demo.save_sharded_ktx(fh, db, path, S)
        mesh, arrs = demo.load_mesh(fh, path, meta)
        step = demo.make_mesh_mem_step(mesh, meta, reads.shape[1])
        out = [np.asarray(a)[0] for a in step(
            arrs["blocks"], arrs["occ"], arrs["shard_base"], arrs["C"],
            arrs["sa_seq"], arrs["sa_off"], jax.device_put(reads))]
        np.savez(path + ".npz", i=out[0], s0=out[1], s1=out[2], ids=out[3])
    if case["name"] == "main":
        # the demo's oracle walk at rows whose walk meets a terminator
        oracle = demo.HostOracle(db)
        ks = np.load(case["oracle_k"])
        np.save(os.path.join(job["work"], "demo_sa_id.npy"),
                np.asarray([oracle.sa_id(int(k)) for k in ks], np.int64))
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small tensor ops, for which torch's
    intra-op threads add CPU time and no speed; one thread for this file
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reads(db, n, length):
    """The demo's reads plus reads shorter than length (a 0 tail), one
    with a code 0 inside and one of code 0 only."""
    reads, _truth = big_classify.make_reads(db, n, length)
    rng = np.random.default_rng(5)
    extra = np.zeros((6, length), np.uint8)
    for t in range(4):
        p = int(rng.integers(0, db["N"] - length))
        take = [length // 2, 11, 1, length - 1][t]
        extra[t, :take] = db["text"][p:p + take]
    p = int(db["starts"][3])
    extra[4] = db["text"][p:p + length]
    extra[4, length // 3] = 0
    return np.concatenate([reads, extra])


def _terminator_rows(db, n=8):
    """SA rows that are not sampled and whose BWT byte is 0: their walk
    ends at the terminator."""
    check = (1 << db["e"]) - 1
    k = np.nonzero(db["bwt"] == 0)[0]
    k = k[(k < db["first"]) | (((k - db["first"]) & check) != 0)]
    return k[:n]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_big")
    db = build_db(None, LETTERS, 2, SEED, True)
    fdb = build_db(None, FAULT_LETTERS, 2, FAULT_SEED, True)
    reads = _reads(db, R, L)
    freads = np.concatenate([
        np.asarray([[20] * 8, [5, 20, 20, 20, 3, 20, 7, 20]], np.uint8),
        big_classify.make_reads(fdb, 30, FAULT_L)[0]])
    np.save(work / "reads.npy", reads)
    np.save(work / "freads.npy", freads)
    np.save(work / "oracle_k.npy", _terminator_rows(db))
    job = {"root": ROOT, "work": str(work), "cases": [
        {"name": "main", "letters": LETTERS, "seed": SEED,
         "shards": list(SHARDS), "reads": str(work / "reads.npy"),
         "oracle_k": str(work / "oracle_k.npy")},
        {"name": "fault", "letters": FAULT_LETTERS, "seed": FAULT_SEED,
         "shards": [2], "reads": str(work / "freads.npy")}]}
    with open(work / "job.json", "w") as fh:
        json.dump(job, fh)
    proc = subprocess.Popen([sys.executable, "-c", WORKER,
                             str(work / "job.json")],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)

    def jax_step(name, S):
        if proc.returncode is None:
            _out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
        z = np.load(work / f"jax_{name}_S{S}.npz")
        return [z[k] for k in ("i", "s0", "s1", "ids")]

    for S in SHARDS:
        save_sharded_ktx(None, db, str(work / f"port_main_S{S}"), S)
    save_sharded_ktx(None, fdb, str(work / "port_fault_S2"), 2)
    yield {"work": work, "db": db, "fdb": fdb, "reads": reads,
           "freads": freads, "jax": jax_step}
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _step(path, reads):
    ix = BigIndex.load(str(path), "cpu")
    return ix, [a.numpy() for a in big_mem.big_mem_step(
        ix, torch.from_numpy(reads))]


@pytest.mark.parametrize("S", SHARDS)
def test_big_step_matches_jax(env, S):
    """big_mem_step's (i, s0, s1, ids) and dtypes equal the demo's step on
    every lane, and so do the host statistics (maxl, taxa) of each read;
    the reads reach positions past the first shard."""
    ix, got = _step(env["work"] / f"port_main_S{S}", env["reads"])
    want = env["jax"]("main", S)
    for g, w, dtype in zip(got, want, (np.int32, np.int64, np.int64,
                                       np.int64)):
        assert g.dtype == w.dtype == dtype
        np.testing.assert_array_equal(g, w)
    seq_tax = ix.seq_tax.numpy()
    assert host_stats(env["reads"], *got, seq_tax) == host_stats(
        env["reads"], *want, seq_tax)
    i, s0, s1, ids = got
    zero = env["reads"] == 0
    assert zero.any() and (i[zero] == np.nonzero(zero)[1]).all()
    assert (s0[zero] == ix.C[1].item()).all()
    assert (ids >= 0).sum() > R * L // 2
    if S > 1:
        assert (s0 >= ix.nb_s * 128).any()  # an owner past shard 0


@pytest.mark.parametrize("D, S", [(2, 2), (2, 4), (4, 2), (4, 4)])
def test_big_step_over_cpu_slots_matches_jax(env, D, S):
    """BigIndex over D CPU slots (the cards of one process): shard o on
    slot o mod D, the others read in place from there, the step on slot
    0; its four arrays equal the demo's step on every lane, and each
    slot's bytes are those of its shards (slot 0 adds the replicated
    arrays)."""
    ix = BigIndex.load(str(env["work"] / f"port_main_S{S}"), ["cpu"] * D)
    assert ix.rec.peer == ix.sa_seq.peer == {o for o in range(S) if o % D}
    got = [a.numpy() for a in big_mem.big_mem_step(
        ix, torch.from_numpy(env["reads"]))]
    for g, w in zip(got, env["jax"]("main", S)):
        np.testing.assert_array_equal(g, w)
    assert sorted(ix.card_bytes) == list(range(D))
    assert sum(ix.card_bytes.values()) == sum(ix.nbytes.values())
    replicated = ix.nbytes["sa_off"] + ix.nbytes["C + shard_base + seq_tax"]
    for c in range(D):
        want = sum(ix.rec.parts[o].nbytes + ix.sa_seq.parts[o].nbytes
                   for o in range(S) if o % D == c)
        assert ix.card_bytes[c] == want + (replicated if c == 0 else 0)


@pytest.mark.parametrize("S", SHARDS)
def test_save_is_the_demos_bytes_and_loader_reads_the_demos_dir(env, S):
    """save_sharded_ktx writes the demo's files byte for byte, and
    BigIndex.load reads the demo's directory to the same step."""
    env["jax"]("main", S)
    port = env["work"] / f"port_main_S{S}"
    jax_dir = env["work"] / f"jax_main_S{S}"
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax_dir))
    assert len(names) == 2 * S + 6
    for name in names:
        assert (port / name).read_bytes() == (jax_dir / name).read_bytes(), \
            name
    _ix, got = _step(jax_dir, env["reads"])
    for g, w in zip(got, env["jax"]("main", S)):
        np.testing.assert_array_equal(g, w)


def test_walked_ids_equal_get_suffix(env):
    """Every walked id is KaijuIndex.get_suffix's sequence of the interval's
    first row, on an index of the same sequences built by the port's
    native_builder with builder="big"; the intervals are its ranks'."""
    db = env["db"]
    seqs = [db["text"][s:e - 1] for s, e in zip(db["starts"], db["ends"])]
    names = [f"S{n}_{t}" for n, t in enumerate(db["taxids"])]
    kidx = native_builder.build_index_from_codes(names, seqs, chpt_exp=5,
                                                 builder="big")
    np.testing.assert_array_equal(kidx.bwt[:kidx.length], db["bwt"])
    _ix, (i, s0, s1, ids) = _step(env["work"] / "port_main_S2",
                                  env["reads"])
    walked = np.nonzero(ids.reshape(-1) >= 0)[0]
    for lane in walked:
        k = int(s0.reshape(-1)[lane])
        assert ids.reshape(-1)[lane] == kidx.get_suffix(k)[0], lane
    assert len(walked) > 1000


def test_full_last_shard_follows_bigrank_not_the_demo(env):
    """N = 128 S nb_s fills the last shard: the demo's rank clips the local
    block at k = N and drops the last block's counts (:278), so every
    lane whose interval ends at C[alen] = N (a lane on letter 20)
    extends wrongly there.  The port's end row serves k = N: it equals
    the host BigRank on every lane, walks included; the demo's step
    differs on 4 lanes of the first two reads and 6 of all, each on 20."""
    fdb, reads = env["fdb"], env["freads"]
    assert fdb["N"] == 128 * 2 * 196
    ix, got = _step(env["work"] / "port_fault_S2", reads)
    assert ix.nb_s * 128 * ix.S == fdb["N"]
    oracle = HostOracle(fdb)
    for t in range(len(reads)):
        exts = oracle.extensions(reads[t])
        assert [tuple(x) for x in zip(*(a[t].tolist() for a in got[:3]))] \
            == exts, t
        for j, (_i, s0, s1) in enumerate(exts):
            want = oracle.sa_id(s0) if s1 > s0 else -1
            assert got[3][t, j] == want, (t, j)
    jax = env["jax"]("fault", 2)
    bad = np.zeros(reads.shape, bool)
    for g, w in zip(got, jax):
        bad |= g != w
    assert bad[:2].sum() == 4 and bad.sum() == 6
    assert (reads[bad] == 20).all()
    assert [a[0, 1] for a in got[:3]] == [0, 50059, 50176]
    assert [a[0, 1] for a in jax[:3]] == [0, 50059, 50172]
    assert got[0][1, 3] == 0 and jax[0][1, 3] == 1


def test_big_rank_plain_beyond_int32():
    """The plain int64 rank on hand-built shards whose C and shard_base
    exceed 2^31: C[c] + base[owner, c] + the local count, for every letter
    and every k in [0, N] (k = N on the last shard's end row)."""
    rng = np.random.default_rng(3)
    S, nb_s, alen = 3, 4, 21
    N = S * nb_s * 128
    bwt = rng.integers(0, alen, size=N, dtype=np.uint8)
    blocks = [bwt[o * nb_s * 128:(o + 1) * nb_s * 128].reshape(nb_s, 128)
              for o in range(S)]
    big = np.int64(3) << 31
    occ, base, run = [], np.zeros((S, alen), np.int64), np.zeros(alen,
                                                                  np.int64)
    for o in range(S):
        cnt = np.stack([(blocks[o] == c).sum(1) for c in range(alen)], 1)
        occ.append(np.concatenate([np.zeros((1, alen)),
                                   np.cumsum(cnt, 0)]).astype(np.int32))
        base[o] = run + big * (o + 1)
        run += cnt.sum(0)
    C = np.zeros(alen + 1, np.int64)
    C[1:] = np.cumsum(run) + big
    meta = dict(N=N, nseq=1, alen=alen, e=5, first=32, n_shards=S,
                nb_s=nb_s, ns_s=1)
    ix = BigIndex.from_arrays(meta, blocks, occ, C, base, np.zeros(S),
                              np.zeros(S), np.zeros(1), "cpu")
    k = np.tile(np.arange(N + 1), alen)
    c = np.repeat(np.arange(alen), N + 1)
    got = big_mem.big_rank_plain(ix, torch.from_numpy(c),
                                 torch.from_numpy(k)).numpy()
    owner = np.minimum((k >> 7) // nb_s, S - 1)
    prefix = np.array([np.count_nonzero(bwt[:kk] == cc)
                       for cc, kk in zip(c, k)])
    want = C[c] + big * (owner + 1) + prefix
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got.max() > 1 << 33


def test_loader_refuses_a_shard_of_2_31_positions():
    meta = dict(N=1 << 32, nseq=1, alen=21, e=5, first=32, n_shards=2,
                nb_s=1 << 24, ns_s=1)
    with pytest.raises(ValueError, match="2\\^31"):
        BigIndex.from_arrays(meta, [], [], None, None, None, None, None,
                             "cpu")


def test_loader_refuses_an_index_of_2_38_letters():
    """The kernels number the BWT blocks in int32: BigIndex refuses an
    index of 2^38 letters or more, whatever its shards."""
    meta = dict(N=1 << 38, nseq=1, alen=21, e=5, first=32, n_shards=1 << 9,
                nb_s=1 << 22, ns_s=1)
    with pytest.raises(ValueError, match="2\\^38"):
        BigIndex.from_arrays(meta, [], [], None, None, None, None, None,
                             "cpu")


def test_oracle_walk_returns_the_content_rank(env):
    """The port's HostOracle.sa_id returns the LF result at a terminator,
    the content rank of the sequence (KaijuIndex.get_suffix's), where the
    demo's oracle returns the raw row (:483-484)."""
    env["jax"]("main", 1)
    db = env["db"]
    ks = _terminator_rows(db)
    oracle = HostOracle(db)
    got = [oracle.sa_id(int(k)) for k in ks]
    demo = np.load(env["work"] / "demo_sa_id.npy")
    assert demo.tolist() == ks.tolist()
    br = oracle.br
    assert got == [br.fmindex(0, int(k)) for k in ks]
    assert all(0 <= g < db["nseq"] for g in got) and got != ks.tolist()


def test_cli_writes_its_log_inside_out(tmp_path):
    """tools.big_classify's main on the CPU: the demo's summary as the last
    line, every sampled read verified, the log inside --out and the
    repository's BIGCLASSIFY.log untouched."""
    demo_log = os.path.join(ROOT, "BIGCLASSIFY.log")
    before = os.stat(demo_log).st_mtime_ns if os.path.exists(demo_log) \
        else None
    out = tmp_path / "bigktx"
    proc = subprocess.run(
        [sys.executable, "-m", "kaiju_tpu_torch.tools.big_classify",
         "--device", "cpu", "--allow-small", "--letters", "60000",
         "--shards", "3", "--reads", "24", "--read-len", "40",
         "--verify", "8", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["verified"] == 8 and summary["shards"] == 3
    assert summary["classified"] > 0
    assert "parity OK" in (out / "big_classify.log").read_text()
    after = os.stat(demo_log).st_mtime_ns if os.path.exists(demo_log) \
        else None
    assert after == before
