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
  without the transport;
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

Transport: the group's gloo backend (``parallel.multihost``; NCCL refuses
two ranks on one card, which is how a one-card machine runs several
processes).  A process on D cards has an exchange a card, card c over a
gloo group of its own, of card c of every process
(``ShardedIndex.in_group``): the D cards' threads run their rounds at
once, and one group takes no collectives from two threads.  Card c's
queries go to card c of the serving process, whose view reads the shard
wherever that process holds it.  On the card each round stages through pinned host buffers
that are kept and reused: one copy to the host, the gloo exchange, one
copy back.  A failed exchange, or a query that reaches a process not
reading its shard, raises.

``COUNTS[stage]`` sums, over the rounds of this process (a ``serve``
call each; ``Exchange.counts`` over those of one card), for each stage of ``STAGES`` that ran one (the seed tables'
"seed", O's "extend", X's "variants", Y's walks "switch" (LF steps and
samples with their offsets, answers of 2 words) and its text rows "text"
(answers of 32 words), Q's "walk"): rounds, queries
(all, own included), ``sent`` (the queries that crossed to a peer),
``bytes`` (queries and answers sent and received), and the seconds in
the copies, the transport (all-to-alls and the lockstep all-reduce) and
kernel N.
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


class Exchange:
    """The rounds of one process of `group` over the index `sh` (a hosts
    view of ``ShardedIndex``): route[o] is the process that answers a query
    to shard o, this process where it reads o.  ``counts`` holds this
    exchange's rounds by stage, as ``COUNTS``."""

    def __init__(self, sh, group, route: list):
        import torch.distributed as dist

        self.sh = sh
        self.group = group
        self.pid = dist.get_rank(group)
        self.nprocs = dist.get_world_size(group)
        self.device = sh.device
        self.route = torch.tensor(route, dtype=torch.int64,
                                  device=self.device)
        self._pinned: dict = {}
        self.counts: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _staged(self, key: str, shape, dtype) -> torch.Tensor:
        """A host tensor of `shape` for the transport: on the card a view of
        a pinned buffer kept under `key` (grown when too small)."""
        n = 1
        for d in shape:
            n *= d
        if self.device.type != "cuda":
            return torch.empty(shape, dtype=dtype)
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < n or buf.dtype != dtype:
            buf = self._pinned[key] = torch.empty(max(n, 1), dtype=dtype,
                                                  pin_memory=True)
        return buf[:n].view(shape)

    def _to_host(self, t: torch.Tensor, key: str) -> torch.Tensor:
        if self.device.type != "cuda":
            return t.contiguous()
        h = self._staged(key, t.shape, t.dtype)
        h.copy_(t)
        return h

    def all_agree(self, flag: bool) -> bool:
        """True when `flag` holds on every process of the group."""
        import torch.distributed as dist

        t = torch.tensor([int(bool(flag))], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
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
        counts = torch.bincount(dest, minlength=N).cpu()
        lo = int(counts[:me].sum())
        hi = lo + int(counts[me])
        send_n = counts.clone()
        send_n[me] = 0
        recv_n = torch.empty_like(send_n)
        t0 = time.perf_counter()
        dist.all_to_all_single(recv_n, send_n, group=self.group)
        t1 = time.perf_counter()
        send = torch.cat([qs[:lo], qs[hi:]])
        send_h = self._to_host(send, "send")
        recv_h = self._staged("recv", (int(recv_n.sum()), 2), torch.int32)
        t2 = time.perf_counter()
        dist.all_to_all_single(recv_h, send_h, recv_n.tolist(),
                               send_n.tolist(), group=self.group)
        t3 = time.perf_counter()
        recv = recv_h.to(dev)
        self._sync()
        t4 = time.perf_counter()
        theirs, bad_t = fm_serve(sh.rec, sh.C, sh.sa_seq, sh.sa_off, recv,
                                 width, sh.text)
        own, bad_o = fm_serve(sh.rec, sh.C, sh.sa_seq, sh.sa_off, qs[lo:hi],
                              width, sh.text)
        bad = int(bad_t) + int(bad_o)  # synchronises
        t5 = time.perf_counter()
        if bad:
            raise RuntimeError(
                f"process {me}: {bad} exchange queries reached it for shards "
                "it does not read")
        theirs_h = self._to_host(theirs, "theirs")
        back_h = self._staged("back", (int(send_n.sum()), width), torch.int32)
        t6 = time.perf_counter()
        dist.all_to_all_single(back_h, theirs_h, send_n.tolist(),
                               recv_n.tolist(), group=self.group)
        t7 = time.perf_counter()
        back = back_h.to(dev)
        ans = torch.empty((queries.shape[0], width), dtype=torch.int32,
                          device=dev)
        ans[order] = torch.cat([back[:lo], own, back[lo:]])
        self._sync()
        t8 = time.perf_counter()
        sent, got = int(send_n.sum()), int(recv_n.sum())
        _tally(self.counts, stage, rounds=1, queries=queries.shape[0],
               sent=sent, bytes=(sent + got) * 4 * (2 + width),
               copy_s=(t2 - t1) + (t4 - t3) + (t6 - t5) + (t8 - t7),
               transport_s=(t1 - t0) + (t3 - t2) + (t7 - t6),
               serve_s=t5 - t4)
        return ans

    def parked_anywhere(self, n: int, stage: str) -> bool:
        """Whether a process of the group has a parked lane, this one n
        (the lockstep's all-reduce)."""
        import torch.distributed as dist

        t = torch.tensor([n], dtype=torch.int64)
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self.group)
        _tally(self.counts, stage, transport_s=time.perf_counter() - t0)
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
