"""Many processes on one classification run (``--dist-nprocs N
--dist-coordinator host:port --dist-pid p``, or ``KAIJU_TPU_NPROCS``,
``KAIJU_TPU_COORDINATOR``, ``KAIJU_TPU_PID``).

The counterpart of kaiju_tpu/parallel/multihost.py (:28-112).  Each
process reads the whole input, classifies and writes only the reads it
owns: of every batch of n reads, process p of N owns reads [p per, min((p
+ 1) per, n)), per = ceil(n / N) (``local_rows``), and the pipeline
(``engine.pipeline.ProcessShare``) yields None for every other read.  The
per-process outputs, merged by read, are the single-process output byte
for byte.  This is kaiju_tpu's ``local_data_rows`` (:66-78) on a mesh of
one card a process, with the data axis over the processes.

The cards of one process split each batch the same way: with
``--mesh-index S`` and no ``--dist-*``, every visible card
(``local_cards``) runs a pipeline on its share, card c of D taking the
rows ``local_rows(n, D, c)`` (``engine.pipeline.CardShare``), and the
index shards lie over the cards (``ShardedIndex.on_cards``): D data rows
where kaiju_tpu's mesh of the process's devices has D / S (:40-53), for
the same output, as for processes below.

A process of a group runs on the cards the caller names, else on its
share of its machine's cards (``process_cards``, ``deal_cards``), and on
each of its D cards a pipeline classifies that card's share of the
process's share of every batch (``ProcessShare`` over a ``CardShare``):
kaiju_tpu's mesh over every device of every process, each process
classifying the data rows of its own devices (:41-53, ``local_data_rows``
:66-78).  Every process of a group runs on the same number of cards.
Without ``--mesh-index`` every card keeps the whole index (a mesh of N D
data rows and one index column).  With ``--mesh-index S`` each slot, a
(process, card) pair, holds only its shards of the index and reads every
other shard from another card of its process, or maps it from a process
of its host that holds it (``parallel.peer_shards``): the index axis
crosses the slots, as in kaiju_tpu's (data x index) mesh with the index
axis innermost (:41-53).  Its data axis then has N D / S rows; here the
data axis always has N D rows, every card classifying its share of each
batch on all S shards.  The merged output is the same; which process
writes which read differs in that case only.

The processes join a ``torch.distributed`` group over gloo, not NCCL:
NCCL refuses two ranks on one card, which is how a one-card machine runs
two processes, and no collective runs inside the loop.  kaiju_tpu needs a
per-batch pmax of its overflow counters only so that every process takes
the same capacity retry (sharded_fused.py:366-373), and the port has no
capacity retry.  The group serves the rendezvous, the deal of the
cards, the exchange of the shards' handles, one barrier at the end of
each stream, so that no process tears the group down while a peer still
writes, and the shards' teardown (``before_leave``).  Over several
hosts each card index has a group of its own for its rounds
(``card_groups``, ``parallel.exchange``): NCCL where every slot of the
group has a card of its own, else gloo (``exchange.backend_for``).
"""

from __future__ import annotations

import atexit
import socket

import torch

from ..ops.device_index import resolve_device


def init_distributed(coordinator: str, nprocs: int, pid: int) -> None:
    """Join this process into the group of nprocs processes whose process
    0 listens at coordinator (host:port); does nothing once joined."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if nprocs < 1 or not 0 <= pid < nprocs:
        raise ValueError(f"process id {pid} outside 0..{nprocs - 1}")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=nprocs, rank=pid)
    atexit.register(_leave)


_BEFORE_LEAVE: list = []
_GROUPS: list = []  # the groups a card index (card_groups)


def before_leave(fn) -> None:
    """Call fn() when this process leaves its group (at exit, before the
    group is destroyed), the latest registered first."""
    _BEFORE_LEAVE.append(fn)


def _leave() -> None:
    import torch.distributed as dist

    while _BEFORE_LEAVE:
        _BEFORE_LEAVE.pop()()
    while _GROUPS:  # after the shards' teardown, before the world group
        dist.destroy_process_group(_GROUPS.pop())
    if dist.is_initialized():
        dist.destroy_process_group()


def card_groups(group, cards: list, backend: str) -> list:
    """One group of the processes of `group` (the world group; every
    process calls it together) for each card index of this process's
    `cards`, on `backend`, made in card order: card c's rounds run over
    the c-th, of card c of every process.  With gloo and one card, `group`
    itself.  Each NCCL communicator starts here, on this thread and in
    card order, before any card thread runs: one all-reduce, and one
    all-to-all of an element a process, which connects every pair of
    processes as a round's all-to-alls do (NCCL connects them at their
    first send), so that a fault, or the connections' seconds, show at
    set-up and not in a round.  The groups are destroyed when the process
    leaves, after the ``before_leave`` functions and before the world
    group."""
    import torch.distributed as dist

    if backend == "gloo" and len(cards) == 1:
        return [group]
    n = dist.get_world_size(group)
    ranks = list(range(n))
    groups = []
    for card in cards:
        g = dist.new_group(ranks, backend=backend)
        _GROUPS.append(g)
        if backend == "nccl":
            t = torch.ones(1, device=card)
            dist.all_reduce(t, group=g)
            got = torch.empty(n, dtype=torch.int64, device=card)
            dist.all_to_all_single(got, torch.full(
                (n,), dist.get_rank(group), dtype=torch.int64, device=card),
                group=g)
            if int(t.item()) != n or got.tolist() != ranks:
                raise RuntimeError(
                    f"the NCCL group of {card} summed {int(t.item())} of "
                    f"{n} ones and exchanged {got.tolist()}")
        groups.append(g)
    return groups


def deal_cards(machines: list, pid: int, cards: int) -> list[int]:
    """The card numbers of process pid of a group whose processes run on
    `machines` (a name a process), on a machine with `cards` cards: the
    group's R processes on pid's machine share them, the one of rank r
    among them taking cards [r k, (r + 1) k), k = cards // R, where R <=
    cards, else card r mod cards."""
    mine = [q for q, m in enumerate(machines) if m == machines[pid]]
    R, r = len(mine), mine.index(pid)
    if R > cards:
        return [r % cards]
    k = cards // R
    return list(range(r * k, (r + 1) * k))


def equal_cards(counts: list) -> None:
    """Exit unless every process of a group runs on the same number of
    cards (counts: one a process)."""
    if len(set(counts)) > 1:
        raise SystemExit(
            "the processes of a --dist-* group must run on the same number "
            "of cards; they run on " + ", ".join(
                f"process {p}: {n}" for p, n in enumerate(counts)))


def process_cards(group, device=None) -> list[torch.device]:
    """The cards of this process of `group` (every process calls it
    together): the caller's device or list of devices if given
    (``local_cards``; ``device="cpu"`` or ``["cpu"] * k`` for the plain
    versions), else its share of the cards of its machine
    (``socket.gethostname()``, gathered over the group; ``deal_cards``),
    the first made the process's current card.  Raises when no card is
    present and the caller asked for none; exits when the processes run
    on unequal numbers of cards (``equal_cards``)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if device is not None:
        cards = local_cards(device)
    else:
        resolve_device("cuda")  # raises without a card
        machines = [None] * n
        dist.all_gather_object(machines, socket.gethostname(), group=group)
        cards = [torch.device("cuda", i) for i in deal_cards(
            machines, dist.get_rank(group), torch.cuda.device_count())]
    counts = [None] * n
    dist.all_gather_object(counts, len(cards), group=group)
    equal_cards(counts)
    if cards[0].type == "cuda":
        torch.cuda.set_device(cards[0])
    return cards


def local_cards(device=None) -> list[torch.device]:
    """The cards of a process (``--mesh-index`` in one process, or the
    caller's cards in a group): None, every visible card (raises when
    there is none); a device or a string, that one device; a list, those
    devices in order, where a device may come more than once (``["cpu"] *
    4``: four slots on the CPU, the tests' rehearsal; ``["cuda:0",
    "cuda:0"]``: two data rows on one card).  A card is named with its
    number; a card that is not present raises."""
    if device is None:
        resolve_device("cuda")  # raises without a card
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty list of cards")
        return [numbered(d) for d in device]
    return [numbered(device)]


def numbered(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} is not present: this machine has "
                           f"{torch.cuda.device_count()} cards")
    return dev


def local_rows(n: int, nprocs: int, pid: int) -> tuple[int, int]:
    """The reads [lo, hi) of an n-read batch that process pid of nprocs
    owns (empty, lo == hi, when the batch ends before its share); the same
    split gives each card of one process its rows of the process's share
    (``engine.pipeline.CardShare``)."""
    per = -(-n // nprocs)
    lo = min(pid * per, n)
    return lo, min(lo + per, n)


def barrier() -> None:
    """Wait for every process of the group (none: return at once)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
