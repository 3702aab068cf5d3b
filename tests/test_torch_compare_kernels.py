"""compare_kernels.py on the CPU: a second copy of the port imported from a
checkout beside the first, and kernels B's and E's calls routed through
that copy's wrappers (here their plain versions, as the CPU takes them),
sharded index arrays rebuilt as the copy's class.  The results must equal
this copy's, bit for bit.  Imports neither jax nor kaiju_tpu."""

import importlib
import os
import random
import sys

import pytest
import torch

from kaiju_tpu_torch.engine.fragments_native import NativeFragmenter2
from kaiju_tpu_torch.engine.pipeline import _bucket
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.index.alphabet import trans_table
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.ops import greedy, search
from kaiju_tpu_torch.ops.kmer import KmerTables
from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex
from kaiju_tpu_torch.tools.readgen import make_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import compare_kernels as ck  # noqa: E402

AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def env():
    rng = random.Random(5)
    records = [(f"P{i}_{100 + i % 3}",
                "".join(rng.choice(AA) for _ in range(rng.randint(30, 200))))
               for i in range(40)]
    idx = py_builder.build_index(records)
    dv = tdev.DeviceIndex(idx, "cpu")
    seed = tuple(torch.from_numpy(a) for a in KmerTables.build(
        idx, search.SEED_K).planar_seed(search.SEED_K))
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
    ge = (*lanes, flat, frag_off, torch.from_numpy(rf_rows), dv.rec, dv.C,
          tables, 7, 11, 65, 3, 20, 64)
    return {"idx": idx, "dv": dv, "ext": ext, "ge": ge}


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
    a, kw = (env["ge"], {"hyb": None}) if name == "greedy_search" else (
        env["ext"], {"bloom": None, "sw_steps": 0})
    want = ck.design_call(this, name, a, kw)[0]()
    if shards:
        sh = ShardedIndex(env["idx"], shards, "cpu")
        a, kw = chip_smoke.shard_call(sh, env["dv"], a, kw)
        rec = a[0] if name.startswith("mem") else a[6]
        assert isinstance(rec, tdev.Shards)
        moved = ck.to_design((rec,), other)[0]
        assert isinstance(moved, other["ops.device_index"].Shards)
        assert not isinstance(moved, tdev.Shards)
        assert moved.parts == rec.parts and moved.per == rec.per
        assert moved.shape == rec.shape
    call, kname = ck.design_call(other, name, a, kw)
    assert kname == ck.COMPARED[name][1] + ("_sharded" if shards else "")
    got = call()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)


def test_no_card_no_comparison(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ck.main([REPO]) == 2
