"""compare_kernels.py on the CPU: a second copy of the port imported from a
checkout beside the first, and kernels A's, B's, G's, C's, J's, I's,
E's, D's, F's, H's, K's, L's and M's calls (A in both forms and on a
BatchRunner round, J on a padded code matrix and on a BatchRunner's
first length group, I on lanes with substitutions and in its code-row
form on a BatchRunner's ExtendFrom round, D and F on a flat and a deep
taxonomy, H on tie rows and on a BatchRunner round, K on B's lanes of
a Greedy batch and on its longest fragment alone, L and M on a toy
index of the big layout loaded as --big-dir loads one) routed through
that copy's wrappers (here their plain versions, as the CPU takes them),
sharded index arrays and big indexes rebuilt as the copy's classes; a
copy without A's letters form runs its stand-in.  The shards = 2 cases
shard the index only for a kernel with a sharded form (a
``<kernel>_sharded`` entry point): I has none, so its cases run
unsharded at both values, and so do C's and K's, which read no index.
The results must equal this copy's, bit for bit (K's rows sorted by
(f, j) on both sides).  Imports neither jax nor kaiju_tpu."""

import importlib
import os
import random
import sys
import types

import numpy as np
import pytest
import torch

from kaiju_tpu_torch import kernels
from kaiju_tpu_torch.engine.fragments_native import NativeFragmenter2
from kaiju_tpu_torch.engine.pipeline import _bucket
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.index.alphabet import trans_table
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.io.taxonomy import Taxonomy
from kaiju_tpu_torch.ops import greedy, hybrid, search
from kaiju_tpu_torch.ops.kmer import KmerTables
from kaiju_tpu_torch.parallel.big_index import (BigIndex, build_db,
                                                save_sharded_ktx)
from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex
from kaiju_tpu_torch.tools import big_classify
from kaiju_tpu_torch.tools.readgen import DeepTaxonomy, make_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import compare_kernels as ck  # noqa: E402

AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small tensor ops (L's and M's int64
    ones above all), for which torch's intra-op threads add CPU time and
    no speed; one thread for this file leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = random.Random(5)
    records = [(f"P{i}_{100 + i % 3}",
                "".join(rng.choice(AA) for _ in range(rng.randint(30, 200))))
               for i in range(40)]
    idx = py_builder.build_index(records)
    dv = tdev.DeviceIndex(idx, "cpu")
    kt = KmerTables.build(idx, search.SEED_K)
    seed = tuple(torch.from_numpy(a) for a in kt.planar_seed(search.SEED_K))
    reads = [(n, s, None) for n, s in make_reads(rng, records, n=40)]
    frag = NativeFragmenter2("greedy", 11, 65, True, False)
    flat, chars, frag_off, n_frags, _k, rf_rows, _o = frag.run(
        reads, 16, _bucket)
    flat = torch.from_numpy(flat[:chars])
    frag_off = torch.from_numpy(frag_off[: n_frags + 1])
    ext = (dv.rec, dv.C, *seed, flat, frag_off, search.SEED_K, 6)
    lanes = search.mem_extend(*ext)
    tables = tuple(torch.from_numpy(a) for a in greedy.greedy_scoring_tables(
        idx.alphabet, trans_table(idx.alphabet)))
    rf_rows = torch.from_numpy(rf_rows)
    ge = (*lanes, flat, frag_off, rf_rows, dv.rec, dv.C, tables, 7, 11, 65,
          3, 20, 64)
    # D's and F's inputs on the flat tree and on a deep one
    stats = search.mem_stats(*lanes, frag_off, 11, 8)
    found = greedy.greedy_search(*ge)
    deep = DeepTaxonomy(3, n_species=3000, max_taxid=20_000, width=40)
    trees = {"": (dv.seq_tax, *(torch.from_numpy(a) for a in Taxonomy(
        {1: 1, 10: 1, 100: 10, 101: 10, 102: 10}).dense_arrays())),
        " (deep tree)": (torch.from_numpy(deep.species[:idx.nseq]),
                         torch.from_numpy(deep.parent),
                         torch.from_numpy(deep.depth))}
    tails = {}
    for suffix, tax in trees.items():
        tail = (dv.rec, dv.C, dv.sa_seq, dv.sa_off, *tax, 32, 20, dv.nseq,
                dv.chpt_exp)
        tails["read_lca" + suffix] = (*stats[:2], *stats[3:], rf_rows,
                                      *tail)
        tails["ranges_lca" + suffix] = (found[2], found[3], *tail)
    # G on the lanes B stops for it; H on the tie rows' positions and on a
    # BatchRunner round
    sw_len = search.SEED_K + hybrid.S1_STEPS
    g = (*search.mem_extend(*ext, sw_steps=hybrid.S1_STEPS), flat,
         frag_off, sw_len, dv.text, dv.rank_start, dv.rec, dv.C, dv.sa_seq,
         dv.sa_off, dv.nseq, dv.chpt_exp)
    assert hybrid.switched(*g[:3], frag_off, sw_len).any()
    s0, s1 = stats[3].reshape(-1), stats[4].reshape(-1)
    k = torch.unique(s0[s1 > s0]).to(torch.int32)
    h = {"sa_lookup": (dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.nseq,
                       dv.chpt_exp, k)}
    h["sa_lookup (tie rows)"] = h["sa_lookup"][:-1] + (k[::2].contiguous(),)
    round_ = ck.runner_round(idx, reads, device="cpu")
    h["sa_lookup (BatchRunner)"] = (dv.rec, dv.C, dv.sa_seq, dv.sa_off,
                                    *round_[4:])
    # A's letters form on the depth-2 intervals, its probe form on their
    # repeated probes and on a BatchRunner's Probes round; C on B's lanes
    p0, p1 = (torch.from_numpy(t.astype("int32")) for t in kt.tables[1])
    c = torch.arange(1, ck.NLET + 1,
                     dtype=torch.int32).repeat_interleave(p0.shape[0])
    probes = ck.runner_round(idx, reads, device="cpu", wrapper="update_si",
                             run="kaijux greedy")
    a = {"update_si_letters": (dv.rec, dv.C, p0, p1),
         "update_si": (dv.rec, dv.C, c, p0.repeat(ck.NLET),
                       p1.repeat(ck.NLET)),
         "update_si (BatchRunner)": (dv.rec, dv.C, *probes[2:]),
         "mem_stats": (*lanes, frag_off, 11, 8),
         "greedy_map": (*lanes, frag_off, 7),
         "greedy_map (one fragment)": chip_smoke.longest_fragment(
             *lanes, frag_off, 7)}
    # J on the fragments as a 0-padded code matrix and on a BatchRunner's
    # first length group; I on lanes resumed inside the fragments, a
    # substitution below i in half of them, and in its code-row form on a
    # BatchRunner's ExtendFrom round
    off = frag_off.numpy()
    flen = np.diff(off).astype(np.int32)
    codes = np.zeros((flen.shape[0], int(flen.max())), dtype=np.uint8)
    for t in range(flen.shape[0]):
        codes[t, :flen[t]] = flat.numpy()[off[t]:off[t + 1]]
    lrng = np.random.default_rng(7)
    f = np.flatnonzero(flen > 1)[lrng.integers(0, int((flen > 1).sum()),
                                                 300)]
    j = 1 + (lrng.random(f.shape[0]) * (flen[f] - 1)).astype(np.int64)
    c = flat.numpy()[off[f] + j].astype(np.int64)
    pos = np.where(lrng.random(f.shape[0]) < 0.5, -1,
                   (lrng.random(f.shape[0]) * j).astype(np.int64))
    cols = (off[f], pos, lrng.integers(1, 21, f.shape[0]), j,
            dv.C.numpy()[c], dv.C.numpy()[c + 1])
    ij = {"extend_all": (dv.rec, dv.C, torch.from_numpy(codes),
                         torch.from_numpy(flen)),
          "extend_all (BatchRunner)": ck.runner_round(
              idx, reads, device="cpu", wrapper="extend_all"),
          "extend_from": (dv.rec, dv.C, flat, *(
              torch.from_numpy(np.asarray(a, np.int32)) for a in cols),
              torch.from_numpy(lrng.random(f.shape[0]) < 0.9)),
          "extend_rows (BatchRunner)": ck.runner_round(
              idx, reads, device="cpu", wrapper="extend_rows",
              run="kaijux greedy")}
    # L and M on a toy index of the big layout (K17), loaded as
    # --big-dir loads one, on fewer reads of each of its shapes
    bdb = build_db(None, 50_000, 2, 25, True)
    bdir = tmp_path_factory.mktemp("big")
    save_sharded_ktx(None, bdb, str(bdir), ck.BIG_SHARDS)
    bix, text = ck.big_index(str(bdir), device="cpu", seed=25)
    big = {}
    for suffix, (_n, seed) in ck.BIG.items():
        rd = big_classify.make_reads(text, 48, 64, seed=seed)[0]
        want = big_classify.make_reads(bdb, 48, 64, seed=seed)[0]
        assert np.array_equal(rd, want)  # the text made again
        big.update({k + suffix: v for k, v in ck.big_calls(bix, rd).items()})
    return {"idx": idx, "dv": dv, "ext": ext, "ge": ge, "tails": tails,
            "g": g, "h": h, "a": a, "ij": ij, "big": big}


def _call(env, name):
    """(args, kwargs) of phase 3's call `name` on env's index."""
    if name == "greedy_search":
        return env["ge"], {"hyb": None}
    if name.startswith("mem_extend"):
        return env["ext"], {"bloom": None, "sw_steps": 0}
    if name == "text_extend":
        return env["g"], {}
    if name.startswith("sa_lookup"):
        return env["h"][name], {}
    if name in env["a"]:
        return env["a"][name], {}
    if name in env["ij"]:
        return env["ij"][name], {}
    if name in env["big"]:
        return env["big"][name]
    return env["tails"][name], {"sw_ids": None}


@pytest.mark.parametrize("name", sorted(ck.COMPARED))
@pytest.mark.parametrize("shards", [0, 2])
def test_other_checkout_runs_its_own_wrappers(env, name, shards):
    this = {n: importlib.import_module(f"kaiju_tpu_torch.{n}")
            for n in ck.MODULES}
    before = {k: m for k, m in sys.modules.items()
              if k.startswith("kaiju_tpu_torch")}
    other = ck.import_checkout(REPO)
    # a second copy, bound to its own loader; sys.modules left as it was
    assert all(other[n] is not this[n] for n in ck.MODULES)
    assert other["ops.search"].kernels is other["kernels"]
    assert other["ops.greedy"].kernels is other["kernels"]
    assert {k: m for k, m in sys.modules.items()
            if k.startswith("kaiju_tpu_torch")} == before
    assert other["ops.classify"].kernels is other["kernels"]
    assert other["ops.hybrid"].kernels is other["kernels"]
    assert other["ops.device_index"].kernels is other["kernels"]
    a, kw = _call(env, name)
    call, _k, shaped = ck.design_call(this, name, a, kw)
    want = shaped(call())
    kernel = ck.LAUNCHED.get(ck.COMPARED[name][1], ck.COMPARED[name][1])
    # C and K read no index; I has no sharded form
    holds = (any(x is env["dv"].rec for x in a)
             and kernel + "_sharded" in kernels.LAUNCHES)
    if shards and holds:
        sh = ShardedIndex(env["idx"], shards, "cpu")
        a, kw = chip_smoke.shard_call(sh, env["dv"], a, kw)
        rec = a[list(map(id, _call(env, name)[0])).index(id(env["dv"].rec))]
        assert isinstance(rec, tdev.Shards)
        moved = ck.to_design((rec,), other)[0]
        assert isinstance(moved, other["ops.device_index"].Shards)
        assert not isinstance(moved, tdev.Shards)
        assert moved.parts == rec.parts and moved.per == rec.per
        assert moved.shape == rec.shape
    call, kname, shaped = ck.design_call(other, name, a, kw)
    assert kname == kernel + ("_sharded" if shards and holds else "")
    got = shaped(call())
    if isinstance(want, torch.Tensor):  # D's rows
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)


@pytest.mark.parametrize("shards", [0, 2])
def test_design_without_letters_form_runs_its_probes(env, shards):
    """A design whose device_index has update_si but not
    update_si_letters (the parent of A's letters form) is timed on its
    update_si over the repeated probes, and its outputs, masked and
    shaped, equal the letters form's."""
    this = {n: importlib.import_module(f"kaiju_tpu_torch.{n}")
            for n in ck.MODULES}
    old = dict(this)
    old["ops.device_index"] = types.SimpleNamespace(
        update_si=tdev.update_si, Shards=tdev.Shards)
    a, kw = _call(env, "update_si_letters")
    if shards:
        a, kw = chip_smoke.shard_call(
            ShardedIndex(env["idx"], shards, "cpu"), env["dv"], a, kw)
    want = ck.design_call(this, "update_si_letters", a, kw)[0]()
    call, kname, shaped = ck.design_call(old, "update_si_letters", a, kw)
    assert kname == "update_si" + ("_sharded" if shards else "")
    got = shaped(call())
    assert len(got) == len(want) == 2
    assert (want[0] < want[1]).any()  # live pairs compared
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_big_index_goes_to_a_design_as_its_class(env):
    """A BigIndex reaches a design's wrappers as that design's BigIndex
    over the same arrays, its shard tables as the design's Shards; the
    design's L and M equal this checkout's on it."""
    other = ck.import_checkout(REPO)
    (ix, codes), _kw = env["big"]["big_extend_all"]
    moved = ck.to_design((ix, codes), other)
    assert isinstance(moved[0], other["parallel.big_index"].BigIndex)
    assert not isinstance(moved[0], BigIndex)
    assert moved[1] is codes
    for arr in ("rec", "sa_seq"):
        got, want = getattr(moved[0], arr), getattr(ix, arr)
        assert isinstance(got, other["ops.device_index"].Shards)
        assert got.parts == want.parts and got.per == want.per
    assert moved[0].C is ix.C and moved[0].N == ix.N
    got = other["ops.big_mem"].big_mem_step(moved[0], codes)
    want = importlib.import_module(
        "kaiju_tpu_torch.ops.big_mem").big_mem_step(ix, codes)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (want[3] >= 0).any()


def test_big_dir_of_another_seed_is_refused(env, tmp_path):
    db = build_db(None, 20_000, 2, 3, True)
    save_sharded_ktx(None, db, str(tmp_path), 2)
    with pytest.raises(ValueError, match="seed 4"):
        ck.big_index(str(tmp_path), device="cpu", seed=4)


def test_no_card_no_comparison(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ck.main([REPO]) == 2
