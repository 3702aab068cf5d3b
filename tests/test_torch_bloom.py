"""The port's Bloom screen (kaiju_tpu_torch.ops.bloom and kernel B's screen
in search.mem_extend) against kaiju_tpu's, on the CPU: the bitmap bit for
bit, the hash and the probe, the shared cache file, and the screen's
contract (the same mem_stats rows as without it; every lane with a match
of length >= m stays).  Integer outputs, tolerance 0.  Kernel B with the
screen is held against this plain version in tests/test_torch_kernels.py."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaiju_tpu.index import py_builder as jax_py_builder
from kaiju_tpu.index.alphabet import encode_protein
from kaiju_tpu.ops import bloom as jbloom
from kaiju_tpu.ops.fused_mem2 import _bloom_hash
from kaiju_tpu.ops.kmer import KmerTables as JaxKmerTables
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.ops import bloom
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.ops import search

from conftest import make_db_records, random_protein

MIN_LEN, LMAP, T = 11, 7, 8


@pytest.fixture(scope="module")
def env():
    rng = random.Random(111)
    records = make_db_records(rng, nseq=40)
    jidx = jax_py_builder.build_index(records)
    tidx = py_builder.build_index(records)
    assert (jidx.text == 0).sum() == jidx.nseq  # a separator a sequence
    frags = []
    for t in range(200):  # DB substrings (some ending at a sequence's
        _, prot = records[rng.randrange(len(records))]  # end), mutated
        if t % 5 == 4:  # copies and junk
            frags.append(random_protein(rng, rng.randint(5, 60)))
            continue
        ln = rng.randint(min(8, len(prot)), min(90, len(prot)))
        st = len(prot) - ln if t % 5 == 3 else rng.randrange(len(prot) - ln + 1)
        s = list(prot[st:st + ln])
        if t % 5 == 1:
            s[rng.randrange(len(s))] = rng.choice("ACDEFGHIKLMNPQRSTVWY")
        frags.append("".join(s))
    enc = [encode_protein(f, tidx.alphabet) for f in frags]
    frag_off = np.zeros(len(enc) + 1, dtype=np.int32)
    frag_off[1:] = np.cumsum([len(e) for e in enc])
    td = tdev.DeviceIndex(tidx, "cpu")
    seed = JaxKmerTables.build(jidx, search.SEED_K).planar_seed(search.SEED_K)
    return {
        "jidx": jidx, "tidx": tidx, "td": td, "frag_off": frag_off,
        "flat": np.concatenate(enc).astype(np.uint8),
        "seed": tuple(torch.from_numpy(a) for a in seed),
    }


@pytest.mark.parametrize("m", [LMAP, MIN_LEN])
def test_fill_from_text_matches_jax(env, m):
    lb = bloom.bloom_lb(env["tidx"].length)
    assert lb == jbloom.bloom_lb(env["jidx"].length)
    got = bloom.fill_from_text(env["tidx"].text, m, lb)
    want = jbloom.fill_from_text(env["jidx"].text, m, lb)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert 0 < np.count_nonzero(got) < got.size


@pytest.mark.parametrize("m", [LMAP, MIN_LEN])
def test_hash_and_probe_match_jax(env, m):
    """hash_plain against fused_mem2._bloom_hash on random codes (uint32
    wrap), and the probe bit of every flat position against
    kaiju_tpu.ops.bloom.BloomScreen.probe."""
    codes = np.random.default_rng(m).integers(0, 256, 5000).astype(np.uint8)
    want = np.asarray(_bloom_hash(jnp.asarray(codes, dtype=jnp.uint32), m))
    got = bloom.hash_plain(torch.from_numpy(codes), m).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    words, m_, lb = jbloom.load_words(env["jidx"], None, m)
    flat = env["flat"]
    jscreen = jbloom.BloomScreen(words, m_, lb)
    jbits = np.asarray(jscreen.probe(jscreen.hash_flat(
        jnp.asarray(flat.astype(np.int32)), m - 1)))
    screen = bloom.BloomScreen(words, m_, lb, "cpu")
    pos = torch.arange(flat.shape[0])
    bits = bloom.probe_plain(torch.from_numpy(flat), pos,
                             torch.ones(flat.shape[0], dtype=torch.bool),
                             *screen.args).numpy()
    np.testing.assert_array_equal(bits, jbits)
    assert 0 < bits.sum() < bits.size


def test_cache_file_is_shared_with_jax(env, tmp_path):
    """A bitmap cached by either package is read by the other (same file
    name, same words), before any text source."""
    jidx, tidx = env["jidx"], env["tidx"]
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    jw, m, lb = jbloom.load_words(jidx, str(jdir), MIN_LEN)
    tw, _m, _lb = bloom.load_words(tidx, str(tdir), MIN_LEN)
    assert sorted(p.name for p in jdir.iterdir()) == [f"bloom_m{m}_lb{lb}.npy"]
    assert (jdir / f"bloom_m{m}_lb{lb}.npy").read_bytes() == (
        tdir / f"bloom_m{m}_lb{lb}.npy").read_bytes()
    text = tidx.text
    tidx.text = None  # only the cache can answer now
    try:
        got = bloom.load_words(tidx, str(jdir), MIN_LEN)
        assert bloom.load_words(tidx, None, MIN_LEN) is None
    finally:
        tidx.text = text
    np.testing.assert_array_equal(got[0], jw)
    jidx_text = jidx.text
    jidx.text = None
    try:
        np.testing.assert_array_equal(
            jbloom.load_words(jidx, str(tdir), MIN_LEN)[0], tw)
    finally:
        jidx.text = jidx_text
    screen = bloom.BloomScreen.load_or_build(tidx, str(tdir), MIN_LEN, "cpu")
    assert screen.words.dtype == torch.int32 and screen.lb == lb
    np.testing.assert_array_equal(screen.words.numpy().view(np.uint32), tw)


@pytest.mark.parametrize("m", [LMAP, MIN_LEN])
def test_screen_keeps_the_statistics(env, m):
    """mem_extend_plain with the screen: the same mem_stats_plain rows as
    without it, and every lane with a match of length >= m evaluated as
    before (the screened-in set is a superset of those lanes)."""
    td = env["td"]
    flat = torch.from_numpy(env["flat"])
    frag_off = torch.from_numpy(env["frag_off"])
    args = (td.rec, td.C, *env["seed"], flat, frag_off, search.SEED_K, m - 1)
    screen = bloom.BloomScreen.load_or_build(env["tidx"], None, m, "cpu")
    plain = search.mem_extend_plain(*args)
    scr = search.mem_extend_plain(*args, bloom=screen.args)
    pos, _f, base, _flen = search._lane_fragments(frag_off, flat.shape[0])
    length = pos - base - plain[0] + 1
    kept = scr[2] > scr[1]
    assert (kept | (length < m)).all()
    long_ = length >= m
    for a, b in zip(scr, plain):
        assert torch.equal(a[long_], b[long_])
    assert (~kept & (plain[2] > plain[1])).sum() > 100  # lanes dropped
    for a, b in zip(search.mem_stats_plain(*scr, frag_off, m, T),
                    search.mem_stats_plain(*plain, frag_off, m, T)):
        assert torch.equal(a, b)
