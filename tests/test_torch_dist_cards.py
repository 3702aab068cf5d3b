"""A process of a `--dist-*` group on several cards, on the CPU
(kaiju_tpu_torch.parallel.multihost.process_cards, peer_shards.slot_routes,
ShardedIndex.in_group, engine.pipeline.ProcessShare over a CardShare, an
exchange a card index), as kaiju_tpu's own multi-process test runs 2
processes of 4 devices each.  In the process: the deal of a machine's
cards over its processes (process p on cuda:{p % cards} wherever a
machine runs as many processes as it has cards or more, every card for a
machine's only process), the exit for unequal numbers of cards, the slot
rules (the process rules at one card a process, ShardedIndex.on_cards's
card rules at one process) and a CardShare in lockstep that submits every
batch to every card, an empty share included.  Then 2 processes x 2 CPU
slots (tests/torch_multihost_worker.py --slots 2): MEM and Greedy without
--mesh-index, MEM at --mesh-index 2 and Greedy at 4 on one host, and
Greedy and MEM at --mesh-index 4 over hosts a, b, all six started at once,
with a batch size whose last batch gives process 1 and card 1 of process 0
an empty share.  Every read must be written by exactly one process, the
one local_rows names, the lines merged by read must be the one-process
TSV byte for byte (which is kaiju_tpu's ExactClassifier's,
tests/test_torch_multihost.py:_single), each slot must hold, read, map
and have served in rounds exactly what the slot rules say, and no file
of the mapped shards may outlive the processes.  No JAX program runs
here."""

import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kaiju_tpu_torch.engine.pipeline import CardShare, ProcessShare
from kaiju_tpu_torch.parallel import multihost, peer_shards
from kaiju_tpu_torch.parallel.multihost import local_rows

from test_exact_parity import _diff
from test_torch_multihost import (FLAGS, N_READS, ROOT, WORKER, _free_port,
                                  _single, env)  # noqa: F401 (fixture)

SLOTS = 2  # cards a process
NPROCS = 2
BATCH = 33  # the last batch 1 read: process 1 and card 1 of process 0 idle


@pytest.mark.parametrize("machines, cards, want", [
    ("m", 8, [[0, 1, 2, 3, 4, 5, 6, 7]]),  # a machine's only process
    ("mm", 4, [[0, 1], [2, 3]]),
    ("mmm", 8, [[0, 1], [2, 3], [4, 5]]),
    ("mmmm", 4, [[0], [1], [2], [3]]),  # cuda:{p % cards}
    ("mm", 1, [[0], [0]]),  # cuda:{p % cards}, on one card
    ("mmm", 2, [[0], [1], [0]]),
    ("aabb", 4, [[0, 1], [2, 3], [0, 1], [2, 3]]),  # two machines
    ("abab", 2, [[0], [0], [1], [1]]),
])
def test_the_deal_of_a_machines_cards(machines, cards, want):
    got = [multihost.deal_cards(list(machines), p, cards)
           for p in range(len(machines))]
    assert got == want
    for p, m in enumerate(machines):  # cuda:{r % cards} where R >= cards
        R = machines.count(m)
        if R >= cards:
            r = [q for q in range(len(machines)) if machines[q] == m].index(p)
            assert got[p] == [r % cards]


def test_unequal_cards_exit_naming_each_process():
    multihost.equal_cards([2, 2, 2])
    with pytest.raises(SystemExit, match="process 0: 2, process 1: 1"):
        multihost.equal_cards([2, 1])


class _Group:
    """process_cards' view of a group: this process's rank, and what the
    processes gather (one machine name and one card count each)."""

    def __init__(self, monkeypatch, rank, machines, counts):
        import torch.distributed as dist

        self.calls = []

        def gather(out, obj, group=None):
            theirs = machines if isinstance(obj, str) else counts
            out[:] = [obj if q == rank else theirs[q]
                      for q in range(len(out))]
            self.calls.append(obj)

        monkeypatch.setattr(dist, "get_world_size", lambda g: len(machines))
        monkeypatch.setattr(dist, "get_rank", lambda g: rank)
        monkeypatch.setattr(dist, "all_gather_object", gather)


def test_process_cards_deals_the_machines_cards(monkeypatch):
    """With no device, process 1 of two on one machine of 4 cards takes
    cuda:2 and cuda:3 and makes cuda:2 current; a caller's list is taken
    as it is; unequal counts exit; without a card it raises."""
    host = multihost.socket.gethostname()
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    g = _Group(monkeypatch, 1, [host, host], [2, 2])
    assert multihost.process_cards(None) == [torch.device("cuda", 2),
                                             torch.device("cuda", 3)]
    assert current == [torch.device("cuda", 2)] and g.calls == [host, 2]
    g = _Group(monkeypatch, 0, ["x", "y"], [2, 2])
    assert multihost.process_cards(None, ["cpu"] * 2) == [
        torch.device("cpu")] * 2
    assert g.calls == [2]  # no machine name gathered
    _Group(monkeypatch, 0, ["x", "y"], [1, 3])
    with pytest.raises(SystemExit, match="process 0: 1, process 1: 3"):
        multihost.process_cards(None, "cpu")
    _Group(monkeypatch, 0, [host, host, "y"], [4, 4, 4])
    with pytest.raises(SystemExit, match="process 0: 2, process 1: 4"):
        multihost.process_cards(None)  # two processes share 4 cards
    with pytest.raises(RuntimeError, match="cuda:4 is not present"):
        multihost.process_cards(None, ["cuda:0", "cuda:4"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.process_cards(None)


def _slot_rule(g, hosts, D, S):
    """The slot rules, restated: (held, {shard: card of this process},
    {shard: slot of another process of this host}, {shard: process that
    serves it}) for slot g = p D + c."""
    G = len(hosts) * D
    p = g // D

    def holds(h):
        return [h % S] if G >= S else [o for o in range(S) if o % G == h]

    reads, opened, remote = {}, {}, {}
    for o in range(S):
        if o in holds(g):
            continue
        own = [h for h in range(p * D, p * D + D) if o in holds(h)]
        near = [h for h in range(G) if hosts[h // D] == hosts[p]
                and o in holds(h)]
        if own:
            reads[o] = (o % G if o % G in own else min(own)) - p * D
        elif near:
            opened[o] = o % G if o % G in near else min(near)
        else:
            remote[o] = (o % G) // D
    return holds(g), reads, opened, remote


@pytest.mark.parametrize("hosts", ["a", "aa", "ab", "aab", "abab", "aaa"])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("S", [1, 2, 4, 6])
def test_slot_rules(hosts, D, S):
    """Every slot reads each shard it does not hold from a holder: a card
    of its process, else a slot of its host, else the serving process
    holds it; at one card a process these are the process rules
    (held, source, routes), in one process the card rules of
    ShardedIndex.on_cards (source over the cards)."""
    N = len(hosts)
    G = N * D
    for g in range(G):
        got = peer_shards.slot_routes(g, list(hosts), D, S)
        assert got == _slot_rule(g, hosts, D, S)
        mine, reads, opened, remote = got
        assert sorted([*mine, *reads, *opened, *remote]) == list(range(S))
        p = g // D
        for o, c in reads.items():
            assert o in peer_shards.held(p * D + c, G, S)
        for o, h in opened.items():
            assert h // D != p and hosts[h // D] == hosts[p]
            assert o in peer_shards.held(h, G, S)
        for o, q in remote.items():
            assert o in peer_shards.held(peer_shards.source(o, G), G, S)
            assert peer_shards.source(o, G) // D == q
            assert hosts[q] != hosts[p]
        if D == 1:  # the process rules
            assert mine == peer_shards.held(p, N, S) and not reads
            assert (opened, remote) == peer_shards.routes(p, list(hosts), S)
        if N == 1:  # the card rules of on_cards
            assert not opened and not remote
            assert reads == {o: peer_shards.source(o, D) for o in range(S)
                             if o not in mine}


class _Stub:
    """A pipeline of a group on several hosts (its view has an exchange)
    that records each call's thread and answers (read name, its card)."""

    def __init__(self, card, calls):
        self.card = card
        self.calls = calls
        self.dev = SimpleNamespace(exchange=object())

    def submit_batch(self, reads):
        self.calls.append(("submit", self.card, len(reads),
                           threading.current_thread().name))
        return list(reads)

    def collect_batch(self, reads):
        return [(name, self.card) for name, _s1, _s2 in reads]


def test_card_share_in_lockstep_submits_every_batch_to_every_card():
    """Under a ProcessShare of process 0 of 2, a CardShare of two cards
    whose pipelines run rounds submits every batch to every card in its
    thread, in stream order, an empty share included (a 1-read batch: card
    1 gets 0 reads); the results come back in read order with None for
    process 1's reads.  As process 1 (whose share of that batch is empty)
    both cards still submit it."""
    for pid in range(2):
        calls = []
        share = CardShare(lambda c: _Stub(c, calls), ["cpu"] * 2)
        assert share.lockstep
        proc = ProcessShare(share, 2, pid)
        assert proc.lockstep
        sizes = [9, 1]
        batches, k = [], 0
        for n in sizes:
            batches.append([(f"r{k + i}", "", None) for i in range(n)])
            k += n
        out = list(proc.classify_stream(batches))
        proc.close()
        for got, batch in zip(out, batches):
            lo, hi = local_rows(len(batch), 2, pid)
            assert [x is None for x in got] == [
                not lo <= i < hi for i in range(len(batch))]
            mine = [x for x in got if x is not None]
            assert [name for name, _c in mine] == [
                name for name, _s, _t in batch[lo:hi]]
            want = []
            for c in range(2):
                a, b = local_rows(hi - lo, 2, c)
                want += [c] * (b - a)
            assert [c for _n, c in mine] == want
        subs = [(c, n, t) for kind, c, n, t in calls if kind == "submit"]
        for c in range(2):  # each card's batches, in its thread, in order
            want = []
            for n in sizes:
                lo, hi = local_rows(n, 2, pid)
                a, b = local_rows(hi - lo, 2, c)
                want.append((c, b - a, f"card{c}_0"))
            assert [x for x in subs if x[0] == c] == want
        assert len(subs) == 2 * len(sizes)
        assert any(n == 0 for _c, n, _t in subs)  # an empty share


def test_a_card_threads_failure_fails_the_run():
    """A pipeline that raises in its card's thread fails the stream where
    its batch is collected; nothing carries on without it."""
    class Broken(_Stub):
        def submit_batch(self, reads):
            if self.card == 1:
                raise RuntimeError("card 1 failed")
            return super().submit_batch(reads)

    share = CardShare(lambda c: Broken(c, []), ["cpu"] * 2)
    with pytest.raises(RuntimeError, match="card 1 failed"):
        list(ProcessShare(share, 1, 0).classify_stream(
            [[(f"r{i}", "", None) for i in range(4)]]))
    share.close()


def test_a_failed_map_names_both_cards():
    """Where a shard of another process cannot be opened on the reading
    card, the error names the reading card and the holder's card; no copy
    is made instead.  The library is a stand-in: the call's error path,
    not the card's."""
    class Lib:
        def kt_peer_open(self, device, handle, ptr):
            return 217  # cudaErrorPeerAccessUnsupported

        def kt_error_string(self, rc):
            return b"peer access is not supported between these two devices"

    share = peer_shards.PeerShards.__new__(peer_shards.PeerShards)
    share.cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    share._lib = Lib()
    share._maps = []
    with pytest.raises(RuntimeError, match=r"rec shard 2 of process 1 \(its "
                       r"cuda:3\) on cuda:1 .*CUDA error 217"):
        share._open(1, bytes(peer_shards.HANDLE_BYTES), (4, 64),
                    np.dtype("int32"), "rec shard 2 of process 1 (its "
                    "cuda:3)")
    assert not share._maps


def test_a_coordinator_port_is_held_until_its_store_listens():
    """_free_port's ports: distinct, refused to any other bind while held
    (so that two concurrent groups never share a coordinator), and open
    to the group's store, whose listener binds with SO_REUSEADDR."""
    import datetime
    import socket

    import torch.distributed as dist

    ports = [_free_port() for _ in range(8)]
    assert len(set(ports)) == len(ports)
    other = socket.socket()
    with pytest.raises(OSError):
        other.bind(("127.0.0.1", ports[0]))
    other.close()
    store = dist.TCPStore("127.0.0.1", ports[0], 1, True,
                          timeout=datetime.timedelta(seconds=30))
    store.set("k", "v")
    assert store.get("k") == b"v"
    del store


# the runs of 2 processes x 2 slots: (mode, --mesh-index, hosts, index)
RUNS = {"mem-flat": ("mem", 0, "aa", "ktx"),
        "greedy-flat": ("greedy", 0, "aa", "ktx"),
        "mem-mesh2": ("mem", 2, "aa", "ktx"),
        "greedy-mesh4-text": ("greedy", 4, "aa", "ktx_text"),
        "greedy-mesh4-hosts-ab": ("greedy", 4, "ab", "ktx"),
        "mem-mesh4-hosts-ab-text": ("mem", 4, "ab", "ktx_text")}


# the seconds a run's workers may take, from their start (alone a run
# takes ~15-30 s on 8 cores), and after them the seconds each worker's
# faulthandler has to print its stacks once it is told to stop
WAIT_S = 300
STACKS_S = 20


def _start(env, tag):
    """Start the 2 workers of RUNS[tag] on SLOTS CPU slots each, process p
    on host hosts[p], each with an empty seed-table cache of its own (so
    that no process waits on another's, and a group across hosts builds
    its tables by rounds), their stacks printed WAIT_S seconds after the
    start if they are still running; returns (processes, outputs)."""
    mode, mesh, hosts, ktx = RUNS[tag]
    argv = ["-t", env["nodes_dmp"], "-f", env[ktx], "-i", env["fq"],
            *FLAGS[mode], "-b", str(BATCH)]
    if mesh:
        argv += ["--mesh-index", str(mesh)]
    coord = f"127.0.0.1:{_free_port()}"
    procs, outs = [], []
    for p in range(NPROCS):
        out = str(env["work"] / f"cards_{tag}_p{p}.tsv")
        outs.append(out)
        penv = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT
                    + os.pathsep + os.environ.get("PYTHONPATH", ""),
                    KAIJU_TPU_CACHE=str(env["work"] / f"cache_{tag}_p{p}"),
                    KAIJU_TEST_STACKS_AFTER=str(WAIT_S))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, "--host", hosts[p], "--slots",
             str(SLOTS), *argv, "--dist-nprocs", str(NPROCS),
             "--dist-coordinator", coord, "--dist-pid", str(p), "-o", out],
            cwd=ROOT, env=penv, stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs, outs, time.monotonic()


def _finish(procs, outs, t0):
    """(errors, each process's output lines) of one run's workers, which
    may run until WAIT_S seconds after t0.  A worker still running then is
    stopped with SIGTERM, on which it prints every thread's stack, and
    killed STACKS_S seconds later if it has not ended; each error carries
    its worker's exit code and the tail of its stderr, the stacks
    included."""
    errors = []
    for p, proc in enumerate(procs):
        try:
            _o, err = proc.communicate(
                timeout=max(1.0, WAIT_S + STACKS_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:  # the whole run: its peers wait on it
                if q.poll() is None:
                    q.terminate()
            try:
                _o, err = proc.communicate(timeout=STACKS_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                _o, err = proc.communicate()
            errors.append(f"process {p}: still running {WAIT_S} s after "
                          f"the start, stopped; stderr:\n{err[-12000:]}")
            continue
        if proc.returncode != 0:
            errors.append(f"process {p}: rc {proc.returncode}\n"
                          f"{err[-12000:]}")
    lines = []
    if not errors:
        for out in outs:
            with open(out) as fh:
                lines.append(fh.readlines())
    return errors, lines


@pytest.fixture(scope="module")
def runs(env):
    """Every run of RUNS started at once (one torch thread a process), the
    one-process TSVs made in this process meanwhile; {tag: (errors,
    lines)}.  A run that fails, or whose workers overrun, gives its own
    errors, which fail only its own case (so does a failure of the
    one-process TSVs, which each case makes again)."""
    started = {}
    try:
        for tag in RUNS:
            started[tag] = _start(env, tag)
        for mode in ("mem", "greedy"):
            try:
                _single(env, mode)
            except Exception:  # each case calls _single again and fails
                pass
        yield {tag: _finish(*run) for tag, run in started.items()}
    finally:
        for procs, _outs, _t0 in started.values():
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def _check_slots(env, tag, S, text, hosts, mode):
    """Each slot held, read, mapped and had served in rounds exactly what
    the slot rules say (rounds in every stage of the mode's path on every
    card, the seed tables' on card 0; on the text index the hybrid's
    stages "switch" and "text" ran on every card, "switch" with rounds on
    a card of each process), and no file of the mapped shards is left."""
    stages = ("extend", "variants", "walk") if mode == "greedy" else (
        "extend", "walk")
    hybrid = ("switch", "text") if text else ()
    arrays = {"rec", "sa_seq", "sa_off"} | ({"text"} if text else set())
    across = len(set(hosts)) > 1
    holders = set()
    for p in range(NPROCS):
        with open(env["work"] / f"cards_{tag}_p{p}.tsv.shards.json") as fh:
            got = json.load(fh)
        assert len(got) == SLOTS
        for c, lay in enumerate(got):
            g = p * SLOTS + c
            mine, reads, opened, remote = _slot_rule(g, hosts, SLOTS, S)
            assert lay["slot"] == g and lay["card"] == "cpu"
            assert lay["held"] == mine, (g, lay)
            assert lay["reads"] == {str(o): h for o, h in reads.items()}
            assert lay["opened_slot"] == {str(o): h
                                          for o, h in opened.items()}
            assert lay["opened"] == {str(o): h // SLOTS
                                     for o, h in opened.items()}
            assert lay["remote"] == {str(o): q for o, q in remote.items()}
            assert set(lay["bytes_held"]) == arrays
            assert all(lay["bytes_held"][a] > 0 for a in arrays)
            assert all((lay["bytes_opened"][a] > 0) == bool(opened)
                       for a in arrays)
            assert all((lay["bytes_read"][a] > 0) == bool(reads)
                       for a in arrays)
            if across:
                assert lay["host"] == hosts[p] and remote
                assert lay["backend"] == "gloo"  # CPU slots: no NCCL
                rounds = lay["card_rounds"]
                assert set(rounds) == set(stages) | set(hybrid) | (
                    {"seed"} if c == 0 else set()), rounds
                assert all(rounds[k]["rounds"] > 0 for k in stages), rounds
                if c == 0:
                    assert rounds["seed"]["queries"] > 0
            else:
                assert not remote and not lay["rounds"]
                assert "card_rounds" not in lay and lay["backend"] is None
            holders.update(mine)
            assert not os.path.exists(lay["run_dir"]), lay["run_dir"]
        if across and hybrid:
            assert sum(lay["card_rounds"]["switch"]["rounds"]
                       for lay in got) > 0
    assert holders == set(range(S))


@pytest.mark.parametrize("tag", list(RUNS))
def test_processes_on_two_cards_merge_to_the_single_process_tsv(env, runs,
                                                               tag):
    """The run's merged TSV is the one-process TSV of its mode on db.ktx
    (the text copy changes no line: tests/test_torch_multihost.py), which
    is the ExactClassifier's."""
    mode, mesh, hosts, ktx = RUNS[tag]
    single, exact = _single(env, mode)
    assert single == exact, _diff(single, exact)
    errors, lines = runs[tag]
    assert not errors, "\n".join(errors)
    names = [n for n, _s in env["reads"]]
    owner = {}
    for b0 in range(0, N_READS, BATCH):
        n = min(BATCH, N_READS - b0)
        for p in range(NPROCS):
            lo, hi = local_rows(n, NPROCS, p)
            owner.update((names[r], p) for r in range(b0 + lo, b0 + hi))
    assert N_READS % BATCH == 1 and local_rows(1, NPROCS, 1) == (1, 1)
    assert local_rows(1, SLOTS, 1) == (1, 1)
    by_name = {}
    for p, ls in enumerate(lines):
        for ln in ls:
            name = ln.split("\t")[1]
            assert name not in by_name, f"{name} written twice"
            assert owner[name] == p, name
            by_name[name] = ln
    assert sorted(by_name) == sorted(names)
    merged = "".join(by_name[n] for n in names)
    assert merged == single, _diff(merged, single)
    if mesh:
        _check_slots(env, tag, mesh, ktx == "ktx_text", hosts, mode)
