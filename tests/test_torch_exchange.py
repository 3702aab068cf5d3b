"""The transport of the rounds across hosts (kaiju_tpu_torch.parallel.
exchange, multihost.card_groups), without processes and without JAX: the
rule that picks NCCL or gloo from the physical card of every slot of a
group (never from the hosts' names), the refusal of a group that the rule
gives NCCL where this PyTorch has none, and the groups a card index made
in card order, each NCCL communicator started at set-up and every group
destroyed after the shards' teardown and before the world group.  The
rounds themselves run over gloo in tests/test_torch_multihost.py and
tests/test_torch_dist_cards.py (CPU slots), and over NCCL on two cards in
tests/test_torch_kernels.py."""

from types import SimpleNamespace

import pytest
import torch

from kaiju_tpu_torch.parallel import exchange, multihost


@pytest.mark.parametrize("slots, want", [
    ([["GPU-0"], ["GPU-1"]], "nccl"),
    ([["GPU-0"], ["GPU-1"], ["GPU-2"]], "nccl"),
    ([["GPU-0", "GPU-1"], ["GPU-2", "GPU-3"]], "nccl"),
    ([["GPU-0"], ["GPU-0"]], "gloo"),
    ([["GPU-0"], ["GPU-1"], ["GPU-0"]], "gloo"),
    ([["GPU-0", "GPU-0"], ["GPU-1", "GPU-2"]], "gloo"),
    ([["GPU-0", "GPU-1"], ["GPU-1", "GPU-2"]], "gloo"),
    ([["cpu"], ["GPU-1"]], "gloo"),
    ([["GPU-0", "cpu"], ["GPU-1", "GPU-2"]], "gloo"),
    ([["cpu", "cpu"], ["cpu", "cpu"]], "gloo"),
], ids=["two-cards", "three-cards", "two-by-two-cards",
        "two-processes-one-card", "three-processes-two-cards",
        "two-card-indices-one-card", "a-card-in-two-processes",
        "a-cpu-slot", "a-cpu-card-index", "cpu-slots"])
def test_the_rule_gives_nccl_only_for_a_card_a_slot(slots, want):
    assert exchange.backend_for(slots) == want


@pytest.mark.parametrize("hosts", ["ab", "aa", "ba"])
def test_the_rule_reads_the_cards_not_the_hosts(hosts):
    """Processes labelled as hosts (phase 4j, the multihost tests) may
    share a card, and processes of one host may each have their own: the
    cards alone decide, whatever the labels."""
    machine = {"a": "GPU-0", "b": "GPU-0"}  # one machine, one card
    shared = [[machine[h]] for h in hosts]
    own = [[f"GPU-{p}"] for p in range(len(hosts))]
    assert exchange.backend_for(shared) == "gloo"
    assert exchange.backend_for(own) == "nccl"


def test_a_group_of_distinct_cards_raises_without_nccl(monkeypatch):
    """Where the rule gives NCCL and this PyTorch has none (the CPU build
    of the tests' lane), the run raises naming NCCL; it never falls back
    to gloo.  gloo needs nothing."""
    import torch.distributed as dist

    if dist.is_nccl_available():  # a CUDA build: make it lack NCCL
        monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        exchange.transport([["GPU-0"], ["GPU-1"]])
    assert exchange.transport([["GPU-0"], ["GPU-0"]]) == "gloo"
    assert exchange.transport([["cpu"], ["cpu"]]) == "gloo"


def test_card_identity_is_the_uuid(monkeypatch):
    uuids = {0: "1f0e-aa", 1: "1f0e-bb"}
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(uuid=uuids[d.index]))
    assert exchange.card_identity(torch.device("cpu")) == "cpu"
    assert [exchange.card_identity(torch.device("cuda", i))
            for i in (1, 0)] == ["1f0e-bb", "1f0e-aa"]


class _Dist:
    """What card_groups and multihost._leave call of torch.distributed,
    recorded in order: a world of `n` processes whose all-reduce sums one
    from each and whose all-to-all gives each process's rank (modulo
    `n`, as if `n` processes answered)."""

    def __init__(self, monkeypatch, n):
        import torch.distributed as dist

        self.events = []
        self.made = 0
        self.n = n

        def new_group(ranks, backend):
            self.made += 1
            g = f"{backend}{self.made}"
            self.events.append(("new", g, tuple(ranks)))
            return g

        def all_reduce(t, group):
            self.events.append(("all_reduce", group, str(t.device)))
            t.mul_(self.n)

        def all_to_all_single(out, inp, group):
            self.events.append(("all_to_all", group, str(inp.device)))
            out.copy_(torch.arange(len(out)) % self.n)

        monkeypatch.setattr(dist, "get_world_size", lambda g: n)
        monkeypatch.setattr(dist, "get_rank", lambda g: 1)
        monkeypatch.setattr(dist, "all_to_all_single", all_to_all_single)
        monkeypatch.setattr(dist, "new_group", new_group)
        monkeypatch.setattr(dist, "all_reduce", all_reduce)
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "destroy_process_group", lambda g=None:
                            self.events.append(("destroy", g)))
        monkeypatch.setattr(multihost, "_GROUPS", [])
        monkeypatch.setattr(multihost, "_BEFORE_LEAVE", [])


@pytest.mark.parametrize("backend, cards, want", [
    ("gloo", 1, []),
    ("gloo", 2, [("new", "gloo1", (0, 1, 2)), ("new", "gloo2", (0, 1, 2))]),
    ("nccl", 1, [("new", "nccl1", (0, 1, 2)), ("all_reduce", "nccl1", "cpu"),
                 ("all_to_all", "nccl1", "cpu")]),
    ("nccl", 2, [("new", "nccl1", (0, 1, 2)), ("all_reduce", "nccl1", "cpu"),
                 ("all_to_all", "nccl1", "cpu"),
                 ("new", "nccl2", (0, 1, 2)), ("all_reduce", "nccl2", "cpu"),
                 ("all_to_all", "nccl2", "cpu")]),
], ids=["gloo-one-card", "gloo-two-cards", "nccl-one-card",
        "nccl-two-cards"])
def test_card_groups_in_card_order(monkeypatch, backend, cards, want):
    """A group a card index, made in card order on every process; with
    gloo and one card the world group itself; under NCCL, one card too,
    each communicator started by an all-reduce and an all-to-all on its
    card as it is made (the CPU stands in for the cards here)."""
    d = _Dist(monkeypatch, 3)
    groups = multihost.card_groups("world", [torch.device("cpu")] * cards,
                                   backend)
    assert d.events == want
    assert groups == (["world"] if not want
                      else [e[1] for e in want if e[0] == "new"])
    assert multihost._GROUPS == [g for g in groups if g != "world"]


@pytest.mark.parametrize("reached, want", [
    (2, r"summed 2 of 3 ones and exchanged \[0, 1, 0\]"),
    (4, r"summed 4 of 3 ones and exchanged \[0, 1, 2\]"),
])
def test_an_nccl_group_that_misses_a_process_raises(monkeypatch, reached,
                                                    want):
    """Set-up fails where the all-reduce or the all-to-all of a new NCCL
    group does not reach every process once."""
    d = _Dist(monkeypatch, 3)
    d.n = reached
    with pytest.raises(RuntimeError, match=want):
        multihost.card_groups("world", [torch.device("cpu")], "nccl")


def test_the_groups_leave_after_the_shards_and_before_the_world(
        monkeypatch):
    d = _Dist(monkeypatch, 2)
    groups = multihost.card_groups("world", [torch.device("cpu")] * 2,
                                   "nccl")
    multihost.before_leave(lambda: d.events.append(("shards closed",)))
    del d.events[:]
    multihost._leave()
    assert d.events == [("shards closed",), ("destroy", groups[1]),
                        ("destroy", groups[0]), ("destroy", None)]
    assert not multihost._GROUPS
