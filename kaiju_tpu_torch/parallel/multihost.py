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

Each process runs on its own card, ``cuda:{p % device_count}``
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


def local_rows(n: int, nprocs: int, pid: int) -> tuple[int, int]:
    """The reads [lo, hi) of an n-read batch that process pid of nprocs
    owns (empty, lo == hi, when the batch ends before its share)."""
    per = -(-n // nprocs)
    lo = min(pid * per, n)
    return lo, min(lo + per, n)


def barrier() -> None:
    """Wait for every process of the group (none: return at once)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
