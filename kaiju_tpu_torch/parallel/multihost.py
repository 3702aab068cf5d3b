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
the same output, as for processes below.  Each process
of a group runs on its own card, ``cuda:{p % device_count}``
(``process_device``).  Without ``--mesh-index`` it keeps the whole index
there.  With ``--mesh-index S`` it holds only its shards of the index and
maps every other shard from the process that holds it
(``parallel.peer_shards``): the index axis crosses the processes, as in
kaiju_tpu's (data x index) mesh with the index axis innermost (:41-53).
Its data axis then has N / S rows; here the data axis always has N rows,
every process classifying its share of each batch on all S shards.  The
merged output is the same; which process writes which read differs in
that case only.

The processes join a ``torch.distributed`` group over gloo, not NCCL:
NCCL refuses two ranks on one card, which is how a one-card machine runs
two processes, and no collective runs inside the loop.  kaiju_tpu needs a
per-batch pmax of its overflow counters only so that every process takes
the same capacity retry (sharded_fused.py:366-373), and the port has no
capacity retry.  The group serves the rendezvous, the exchange of the
shards' handles, one barrier at the end of each stream, so that no
process tears the group down while a peer still writes, and the
shards' teardown (``before_leave``).
"""

from __future__ import annotations

import atexit

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


def before_leave(fn) -> None:
    """Call fn() when this process leaves its group (at exit, before the
    group is destroyed), the latest registered first."""
    _BEFORE_LEAVE.append(fn)


def _leave() -> None:
    import torch.distributed as dist

    while _BEFORE_LEAVE:
        _BEFORE_LEAVE.pop()()
    if dist.is_initialized():
        dist.destroy_process_group()


def process_device(pid: int, device=None) -> torch.device:
    """The device of process pid: the caller's device if it names one
    (``device="cpu"`` for the plain versions), else the card
    cuda:{pid % device_count}, made the process's current card.  Raises
    when no card is present and the caller asked for none."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")  # raises without a card
    dev = torch.device("cuda", pid % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def local_cards(device=None) -> list[torch.device]:
    """The cards of a run in one process (``--mesh-index`` without
    ``--dist-*``): None, every visible card (raises when there is none);
    a device or a string, that one device; a list, those devices in order,
    where a device may come more than once (``["cpu"] * 4``: four slots
    on the CPU, the tests' rehearsal; ``["cuda:0", "cuda:0"]``: two data
    rows on one card).  A card is named with its number."""
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
    return dev


def local_rows(n: int, nprocs: int, pid: int) -> tuple[int, int]:
    """The reads [lo, hi) of an n-read batch that process pid of nprocs
    owns (empty, lo == hi, when the batch ends before its share); the same
    split gives each card of one process its rows (``local_cards``,
    ``engine.pipeline.CardShare``)."""
    per = -(-n // nprocs)
    lo = min(pid * per, n)
    return lo, min(lo + per, n)


def barrier() -> None:
    """Wait for every process of the group (none: return at once)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
