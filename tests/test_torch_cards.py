"""The cards of one process on the CPU, with no JAX: ``multihost.local_cards``
for None, a string and a list; ``engine.pipeline.CardShare`` (each card's
share of a batch through its own worker thread, the results in read order,
a card with an empty share idle) on stub pipelines; ``make_runner`` with a
list of CPU slots (a CardShare over ``ShardedIndex.on_cards`` with
``--mesh-index``, the first slot without it); every ``SystemExit`` of
``--mesh-index`` with a list of slots; and the raise without a card.  The
TSVs over slots against kaiju_tpu are in tests/test_torch_sharded.py and
tests/test_torch_sharded_greedy.py."""

import random
import threading
from types import SimpleNamespace

import pytest
import torch

from kaiju_tpu_torch.engine.config import KaijuConfig
from kaiju_tpu_torch.engine.pipeline import CardShare
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.io.taxonomy import Taxonomy
from kaiju_tpu_torch.parallel import multihost, peer_shards
from kaiju_tpu_torch.tools import common
from kaiju_tpu_torch.tools import kaiju as tkaiju

AA = "ACDEFGHIKLMNPQRSTVWY"
NODES = {1: 1, 10: 1, 100: 10, 200: 10, 101: 100, 102: 100, 201: 200}
CPU = torch.device("cpu")
V_ONLY = "--mesh-index / --dist-\\* support mem and greedy modes without -v"


def test_local_cards_of_a_string_and_a_list():
    assert multihost.local_cards("cpu") == [CPU]
    assert multihost.local_cards(torch.device("cpu")) == [CPU]
    assert multihost.local_cards(["cpu"] * 3) == [CPU] * 3
    assert multihost.local_cards(("cpu",)) == [CPU]
    with pytest.raises(ValueError, match="empty list"):
        multihost.local_cards([])
    with pytest.raises(ValueError, match="unsupported device"):
        multihost.local_cards(["cpu", "meta"])


def test_local_cards_of_none_are_every_visible_card(monkeypatch):
    """None names every visible card, each with its number, and a card
    without one is the current card; without a card, None raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.local_cards(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.local_cards(["cpu", "cuda:1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert multihost.local_cards(None) == [torch.device("cuda", i)
                                           for i in range(3)]
    assert multihost.local_cards("cuda") == [torch.device("cuda", 2)]
    assert multihost.local_cards(["cuda:0", "cuda:0"]) == [
        torch.device("cuda", 0)] * 2


class _Stub:
    """A pipeline that records which thread ran each call and answers
    (read name, its card)."""

    def __init__(self, card, calls):
        self.card = card
        self.calls = calls

    def submit_batch(self, reads):
        self.calls.append(("submit", self.card, len(reads),
                           threading.current_thread().name))
        return list(reads)

    def collect_batch(self, reads):
        self.calls.append(("collect", self.card, len(reads),
                           threading.current_thread().name))
        return [(name, self.card) for name, _s1, _s2 in reads]


def test_card_share_keeps_read_order_and_skips_empty_shares():
    """Each card takes local_rows(n, D, c) of every batch, in its own
    worker thread; the results come back in read order, batch after
    batch; a card whose share is empty gets no call; the pipelines are
    built one after another, in order, in the calling thread."""
    calls, built = [], []

    def make(c):
        built.append((c, threading.current_thread().name))
        return _Stub(c, calls)

    share = CardShare(make, ["cpu"] * 4)
    main = threading.current_thread().name
    assert built == [(c, main) for c in range(4)]
    sizes = [10, 3, 1, 8]
    batches, k = [], 0
    for n in sizes:
        batches.append([(f"r{k + i}", "", None) for i in range(n)])
        k += n
    out = list(share.classify_stream(batches))
    share.close()
    assert [[name for name, _c in got] for got in out] == [
        [name for name, _s, _t in b] for b in batches]
    for got, n in zip(out, sizes):
        owners = [c for _name, c in got]
        want = []
        for c in range(4):
            lo, hi = multihost.local_rows(n, 4, c)
            want += [c] * (hi - lo)
        assert owners == want
    # 3 reads over 4 cards: one each for cards 0-2, none for card 3; 1
    # read: card 0 alone
    submits = [c for kind, c, _n, _t in calls if kind == "submit"]
    assert [submits.count(c) for c in range(4)] == [4, 3, 3, 2]
    assert all(t == f"card{c}_0" for _k, c, _n, t in calls)
    assert sum(n for kind, _c, n, _t in calls if kind == "collect") == 22


def _records(rng):
    base = "".join(rng.choice(AA) for _ in range(120))
    recs = []
    for i in range(24):
        seq = ("".join(rng.choice(AA) for _ in range(rng.randint(40, 200)))
               if i % 3 else base[:rng.randint(30, 120)])
        recs.append((f"ACC{i:04d}.1_{[101, 102, 201][i % 3]}", seq))
    return recs


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    rng = random.Random(5)
    return {"index": py_builder.build_index(_records(rng)),
            "tax": Taxonomy(NODES),
            "cache": str(tmp_path_factory.mktemp("cards_cache"))}


@pytest.mark.parametrize("what, args, expect", [
    ({"verbose": True}, {"mesh_index": 2}, V_ONLY),
    ({"taxonomy_free": True}, {"mesh_index": 2}, V_ONLY),
    ({"debug": True}, {"mesh_index": 2}, "-d traces reads"),
    ({"mode": "mem", "use_Evalue": False, "verbose": True},
     {"mesh_index": 4}, V_ONLY),
    ({"mode": "mem", "use_Evalue": False},
     {"mesh_index": 2, "dist_nprocs": 2}, "needs --dist-coordinator"),
])
def test_refusals_stay_with_a_list_of_cards(tiny, what, args, expect):
    """-v, the taxonomy-free tools and -d with --mesh-index, and many
    processes without a coordinator, exit with their message when the
    caller names several cards, before anything is built."""
    cfg = KaijuConfig(**{"mode": "greedy", **what})
    with pytest.raises(SystemExit, match=expect):
        common.make_runner(tiny["index"], tiny["tax"], cfg,
                           args=SimpleNamespace(**args), device=["cpu"] * 3)


def test_make_runner_over_cpu_slots(tiny, monkeypatch):
    """--mesh-index S with a list of D slots: a CardShare of D sharded
    pipelines, slot c on the view of card c (the shards of the rule, the
    others read from their holder's slot); one slot gives the pipeline
    itself, and a run without --mesh-index takes the first slot."""
    monkeypatch.setenv("KAIJU_TPU_CACHE", tiny["cache"])
    cfg = KaijuConfig(mode="mem", use_Evalue=False)
    share = common.make_runner(tiny["index"], tiny["tax"], cfg,
                               args=SimpleNamespace(mesh_index=4),
                               device=["cpu"] * 3)
    try:
        assert isinstance(share, CardShare) and len(share.pipes) == 3
        for c, pipe in enumerate(share.pipes):
            lay = pipe.dev.layout()
            assert type(pipe).__name__ == "ShardedMemPipeline"
            assert pipe.device == CPU and pipe.dev.slot == c
            assert lay["held"] == peer_shards.held(c, 3, 4)
            assert lay["reads"] == {o: o % 3 for o in range(4)
                                    if o % 3 != c}
            for o, h in lay["reads"].items():
                assert pipe.dev.rec.parts[o] is \
                    share.pipes[h].dev.rec.parts[o]
        # one placement: the host seed tables computed once, for all
        assert share.pipes[0].dev.shared is share.pipes[2].dev.shared
        assert len(share.pipes[0].dev.shared) == 1
    finally:
        share.close()
    one = common.make_runner(tiny["index"], tiny["tax"], cfg,
                             args=SimpleNamespace(mesh_index=2),
                             device=["cpu"])
    assert type(one).__name__ == "ShardedMemPipeline" and one.dev.S == 2
    flat = common.make_runner(tiny["index"], tiny["tax"], cfg,
                              args=SimpleNamespace(mesh_index=0),
                              device=["cpu"] * 2)
    assert type(flat).__name__ == "MemPipeline" and flat.device == CPU


def test_main_raises_without_a_card(tmp_path, monkeypatch):
    """--mesh-index in one process runs on every visible card: with none,
    main raises and names device='cpu'; it never falls back to the
    CPU."""
    rng = random.Random(9)
    index = py_builder.build_index(_records(rng))
    ktx = str(tmp_path / "db.ktx")
    index.save(ktx)
    nodes = tmp_path / "nodes.dmp"
    nodes.write_text("".join(f"{t}\t|\t{p}\t|\tno rank\t|\n"
                             for t, p in NODES.items()))
    fq = tmp_path / "r.fastq"
    fq.write_text("@r0\nACGTACGTACGTACGTACGTACGTACGTACGTAC\n+\n"
                  + "I" * 34 + "\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mesh in (["--mesh-index", "2"], []):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tkaiju.main(["-t", str(nodes), "-f", ktx, "-i", str(fq),
                         "-o", str(tmp_path / "o.tsv"), *mesh])


def test_cards_without_peer_access_raise_naming_both(monkeypatch):
    """Where kt_peer_enable fails (two cards without peer access), the
    placement raises and names both cards; it never copies a shard to the
    reader instead.  The library is a stand-in here: the call's error
    path, not the card's."""
    class Lib:
        calls = []

        def kt_peer_enable(self, reader, holder):
            self.calls.append((reader, holder))
            return 217  # cudaErrorPeerAccessUnsupported

        def kt_error_string(self, rc):
            return b"peer access is not supported between these two devices"

    lib = Lib()
    monkeypatch.setattr(peer_shards, "_peer_lib", lambda: lib)
    with pytest.raises(RuntimeError, match="cuda:2 cannot read the index "
                       "shards of cuda:3: peer access failed with CUDA "
                       "error 217"):
        peer_shards.enable_peer(torch.device("cuda", 2),
                                torch.device("cuda", 3))
    peer_shards.enable_peer(torch.device("cuda", 1), torch.device("cuda", 1))
    peer_shards.enable_peer(CPU, CPU)
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    with pytest.raises(RuntimeError, match="cuda:0 cannot read the index "
                       "shards of cuda:1 in place.*expandable_segments"):
        peer_shards.enable_peer(torch.device("cuda", 0),
                                torch.device("cuda", 1))
    assert lib.calls == [(2, 3)]
