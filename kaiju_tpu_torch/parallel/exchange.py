"""The rounds of a group of processes on several hosts (``kaiju
--mesh-index S --dist-*`` where the processes' hosts differ, in MEM and in
Greedy): the port's
counterpart of kaiju_tpu's owner-computes steps, whose psum over the index
axis assembles every rank and SA-walk step from its owner shard
(kaiju_tpu/parallel/sharded_fused.py:35-36, ``_make_rank1`` :52-75,
``_make_walk`` :78-150), with the while-loops in lockstep through
``_any_psum``.

Over one host every shard is held or mapped (``parallel.peer_shards``)
and the kernels read it in place.  A shard that no process of a host
holds is remote there: its owner serves it.  A lane whose next step needs
a row (or an SA sample, or a 128-byte text row) of a remote shard parks
with its query (kernels O, X, Q and Y: ``ops.search.mem_extend_hosts``,
``ops.greedy.greedy_variants_hosts``, ``ops.device_index.walk_hosts``,
``ops.hybrid.switch_hosts``).  Then one round:

- each process sorts its parked queries by the process that answers them
  (``route``: this process for a shard it reads, else the shard's server);
- the counts, then the queries, go out with ``all_to_all_single``;
- each process answers what it received with kernel N
  (``ops.device_index.fm_serve``), and its own queries the same way
  without the transport (a launch only where it has any), its count of
  queries it cannot answer read once;
- the answers come back the same way, in the order the queries left;
- the caller relaunches its round kernel on the parked lanes with their
  answers, which may park again.

Lockstep: a stage's rounds end only when no process of the group has a
parked lane (an all-reduce of the parked count before each round, the
counterpart of ``_any_psum``), so a process with nothing left still
serves its peers.  Every process runs the same stages in the same order
(``ops.classify.fused_mem_classify_hosts`` or
``ops.greedy.fused_greedy_classify_hosts`` for each batch, whose stage
"variants" runs once a level, -e times, parked lanes or not; with the
text-compare hybrid the stages "switch" and "text" of kernel Y,
``ops.hybrid.switch_in_rounds``, once a batch in MEM, after "extend", and
once at the last level in Greedy, after its "variants"; the seed
tables' ROW rounds at set-up), so the collectives match.

Transport: card to card over NCCL wherever every slot of the group, a
(process, card) pair, has a card of its own (``backend_for``, decided
from every slot's physical card, ``card_identity``, gathered over the
world group in ``ShardedIndex.in_group``), else the group's gloo.  NCCL
refuses two ranks of one communicator on one card, which is how a
one-card machine runs several processes, and two communicators of one
process on one card can hang when two card threads use them at once.
Where the rule gives NCCL and this PyTorch has none, the run raises
(``transport``); it never falls back to gloo.  A process on D cards has
an exchange a card, card c over a group of its own, of card c of every
process (``ShardedIndex.in_group``, ``multihost.card_groups``): the D
cards' threads run their rounds at once, and one group takes no
collectives from two threads.  Card c's queries go to card c of the
serving process, whose view reads the shard wherever that process holds
it.  Every tensor goes to the collective where it lies (the direct
form): under NCCL the counts, queries and answers stay on the card, the
counts read to the host once a round for the split sizes; under gloo on
the CPU, the tests' rehearsal, they are host tensors.  Only gloo with
card tensors stages each round through pinned host buffers that are kept
and reused (the staged form): one copy to the host, the gloo exchange,
one copy back.  A failed exchange, or a query that reaches a process not
reading its shard, raises.

``COUNTS[stage]`` sums, over the rounds of this process (a ``serve``
call each; ``Exchange.counts`` over those of one card), for each stage of ``STAGES`` that ran one (the seed tables'
"seed", O's "extend", X's "variants", Y's walks "switch" (LF steps and
samples with their offsets, answers of 2 words) and its text rows "text"
(answers of 32 words), Q's "walk"): rounds, queries
(all, own included), ``sent`` (the queries that crossed to a peer),
``bytes`` (queries and answers sent and received), and the seconds in
the copies (the staged form's; 0 in the direct form), the transport
(all-to-alls and the lockstep all-reduce, under NCCL with the card
synchronised before and after each, so that they count what gloo's do:
the transport and the lockstep's waits) and kernel N.
"""

from __future__ import annotations

import threading
import time

import torch

from ..ops.device_index import fm_serve, query_shard

STAGES = ("seed", "extend", "variants", "switch", "text", "walk")
COUNTS: dict = {}
_FIELDS = ("rounds", "queries", "sent", "bytes", "copy_s", "transport_s",
           "serve_s")


_TALLY = threading.Lock()  # COUNTS, from the threads of many cards


def reset_counts() -> None:
    with _TALLY:
        COUNTS.clear()


def _tally(mine: dict, stage: str, **add) -> None:
    """Add `add` to COUNTS[stage] and to mine[stage] (an exchange's)."""
    if stage not in STAGES:
        raise ValueError(f"unknown exchange stage {stage!r}")
    with _TALLY:
        for counts in (COUNTS, mine):
            row = counts.setdefault(stage, dict.fromkeys(_FIELDS, 0))
            for k, v in add.items():
                row[k] += v


def card_identity(device: torch.device) -> str:
    """The physical card of a slot on `device`: its CUDA UUID, which no
    other card of any host shares, or "cpu" for a CPU slot."""
    if device.type != "cuda":
        return "cpu"
    return str(torch.cuda.get_device_properties(device).uuid)


def backend_for(slots: list) -> str:
    """The transport of the rounds of a group whose slots lie on `slots`
    (for each process, the card_identity of each of its cards, in order):
    "nccl" where every slot is a CUDA card and no two slots share one,
    else "gloo".  It reads the physical cards only, never the hosts'
    names, and every process decides it from the same gathered slots."""
    ids = [card for cards in slots for card in cards]
    if "cpu" in ids or len(set(ids)) < len(ids):
        return "gloo"
    return "nccl"


def transport(slots: list) -> str:
    """backend_for(slots); raises where it gives NCCL and this PyTorch
    has no NCCL (a group of distinct cards never falls back to gloo)."""
    import torch.distributed as dist

    backend = backend_for(slots)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError(
            "every slot of this group has a card of its own, so its rounds "
            "run over NCCL, but this PyTorch build has no NCCL")
    return backend


class Exchange:
    """The rounds of one process of `group` over the index `sh` (a hosts
    view of ``ShardedIndex``): route[o] is the process that answers a query
    to shard o, this process where it reads o.  ``backend`` is the group's
    ("nccl" or "gloo", ``transport``); ``staged`` says whether its rounds
    stage through pinned host buffers (gloo with card tensors).
    ``counts`` holds this exchange's rounds by stage, as ``COUNTS``."""

    def __init__(self, sh, group, route: list, backend: str = "gloo"):
        import torch.distributed as dist

        self.sh = sh
        self.group = group
        self.backend = backend
        self.pid = dist.get_rank(group)
        self.nprocs = dist.get_world_size(group)
        self.device = sh.device
        self.staged = backend == "gloo" and self.device.type == "cuda"
        # where the collectives' tensors lie: the card under NCCL, else
        # the host
        self.lie = (self.device if backend == "nccl"
                    else torch.device("cpu"))
        self.route = torch.tensor(route, dtype=torch.int64,
                                  device=self.device)
        self._pinned: dict = {}
        self.counts: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _collective(self, fn, *args) -> float:
        """fn(*args) over the group; its seconds.  Under NCCL the card is
        synchronised before it (the card's earlier work is not the
        transport's) and after it, so that the seconds mean what gloo's
        do: the transport and the lockstep's waits for the peers."""
        nccl = self.backend == "nccl"
        if nccl:
            self._sync()
        t0 = time.perf_counter()
        fn(*args, group=self.group)
        if nccl:
            self._sync()
        return time.perf_counter() - t0

    def _buffer(self, key: str, shape, dtype) -> torch.Tensor:
        """A tensor of `shape` for the transport to write: in the staged
        form a view of a pinned host buffer kept under `key` (grown when
        too small), else a new tensor where the collectives' tensors lie."""
        if not self.staged:
            return torch.empty(shape, dtype=dtype, device=self.lie)
        n = 1
        for d in shape:
            n *= d
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < n or buf.dtype != dtype:
            buf = self._pinned[key] = torch.empty(max(n, 1), dtype=dtype,
                                                  pin_memory=True)
        return buf[:n].view(shape)

    def _out(self, t: torch.Tensor, key: str) -> torch.Tensor:
        """t as the transport sends it: a pinned host copy in the staged
        form, else t itself."""
        if not self.staged:
            return t.contiguous()
        h = self._buffer(key, t.shape, t.dtype)
        h.copy_(t)
        return h

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        """What the transport wrote, on this card (the staged form copies
        it back)."""
        if not self.staged:
            return t
        t = t.to(self.device)
        self._sync()
        return t

    def all_agree(self, flag: bool) -> bool:
        """True when `flag` holds on every process of the group."""
        import torch.distributed as dist

        t = torch.tensor([int(bool(flag))], dtype=torch.int64,
                         device=self.lie)
        self._collective(dist.all_reduce, t, dist.ReduceOp.MIN)
        return bool(t.item())

    def serve(self, queries: torch.Tensor, width: int,
              stage: str) -> torch.Tensor:
        """One round: this process's queries int32 [Q, 2] (op, x) answered
        by their owners, int32 [Q, width] in the queries' order; every
        process of the group calls it together."""
        import torch.distributed as dist

        sh, dev, N, me = self.sh, self.device, self.nprocs, self.pid
        dest = self.route[query_shard(sh.rec, sh.sa_seq, queries, sh.text)]
        order = torch.argsort(dest, stable=True)
        qs = queries[order]
        counts = torch.bincount(dest, minlength=N).to(self.lie)
        send_n = counts.clone()
        send_n[me] = 0
        recv_n = torch.empty_like(send_n)
        transport = self._collective(dist.all_to_all_single, recv_n, send_n)
        t1 = time.perf_counter()
        both = torch.cat([counts, recv_n]).tolist()  # the round's one read
        counts, recv_l = both[:N], both[N:]
        lo = sum(counts[:me])
        hi = lo + counts[me]
        send_l = counts[:me] + [0] + counts[me + 1:]
        sent, got = sum(send_l), sum(recv_l)
        send = self._out(torch.cat([qs[:lo], qs[hi:]]), "send")
        recv = self._buffer("recv", (got, 2), torch.int32)
        t2 = time.perf_counter()
        transport += self._collective(dist.all_to_all_single, recv, send,
                                      recv_l, send_l)
        t3 = time.perf_counter()
        recv = self._in(recv)
        t4 = time.perf_counter()
        theirs, bad = fm_serve(sh.rec, sh.C, sh.sa_seq, sh.sa_off, recv,
                               width, sh.text)
        # this process's own (a launch only where it asked its own shards)
        own, bad_o = fm_serve(sh.rec, sh.C, sh.sa_seq, sh.sa_off, qs[lo:hi],
                              width, sh.text)
        bad = int(bad + bad_o)  # synchronises: the round's one read
        t5 = time.perf_counter()
        if bad:
            raise RuntimeError(
                f"process {me}: {bad} exchange queries reached it for shards "
                "it does not read")
        theirs = self._out(theirs, "theirs")
        back = self._buffer("back", (sent, width), torch.int32)
        t6 = time.perf_counter()
        transport += self._collective(dist.all_to_all_single, back, theirs,
                                      send_l, recv_l)
        t7 = time.perf_counter()
        back = self._in(back)
        ans = torch.empty((queries.shape[0], width), dtype=torch.int32,
                          device=dev)
        ans[order] = torch.cat([back[:lo], own, back[lo:]])
        self._sync()
        t8 = time.perf_counter()
        copy_s = ((t2 - t1) + (t4 - t3) + (t6 - t5) + (t8 - t7)
                  if self.staged else 0.0)
        _tally(self.counts, stage, rounds=1, queries=queries.shape[0],
               sent=sent, bytes=(sent + got) * 4 * (2 + width),
               copy_s=copy_s, transport_s=transport, serve_s=t5 - t4)
        return ans

    def parked_anywhere(self, n: int, stage: str) -> bool:
        """Whether a process of the group has a parked lane, this one n
        (the lockstep's all-reduce)."""
        import torch.distributed as dist

        t = torch.tensor([n], dtype=torch.int64, device=self.lie)
        _tally(self.counts, stage,
               transport_s=self._collective(dist.all_reduce, t))
        return int(t.item()) > 0

    def rounds(self, stage: str, parked, queries, width: int, resume):
        """Run a stage's rounds: while any process of the group has a
        parked lane, serve() this process's queries (int32 [L, q, 2], q a
        lane) and relaunch: resume(parked, answers int32 [L, q, width])
        returns the lanes parked again with their queries.  Every process
        calls it for every stage, in the same order."""
        while self.parked_anywhere(parked.shape[0], stage):
            L, q = queries.shape[0], queries.shape[1]
            ans = self.serve(queries.reshape(-1, 2), width, stage)
            parked, queries = resume(parked, ans.view(L, q, width))
