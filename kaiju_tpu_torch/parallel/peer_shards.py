"""Index shards held apart by the processes of a group (K16's
cross-process form: ``kaiju --mesh-index S --dist-nprocs N``).

The counterpart of kaiju_tpu's ``put_global``
(kaiju_tpu/parallel/multihost.py:55-65), which puts on a process's devices
only the shards they hold, together with the psum over the index axis
that takes each rank or walk step from its owner
(kaiju_tpu/parallel/sharded_fused.py:35-36).  Here a process uploads only
the shards it holds and maps every other shard from a process that holds
it; the sharded kernels then read rows, SA samples and text bytes through
their pointer tables (``kt::ShardIx``, csrc/fm_common.cuh) wherever the
shard lives, with no collective in the loop.

Who holds what, over the slots of a group: slot g = p D + c is card c
of process p, of G = N D slots (D, each process's cards, equal in every
process; ``multihost.process_cards``).  Slot g holds shard o when o = g mod
S, for G >= S (kaiju_tpu's (data x index) mesh over every device of every
process, index axis innermost, multihost.py:41-53; slots g >= S hold
replicas), and when o mod G = g, for G < S (ceil or floor S / G shards
each, as a JAX device with S / G shards) (``held``).  Slot source(o, G) =
o mod G holds o either way (``source``).

Where a slot reads a shard it does not hold (``slot_routes``): from a card
of its own process that holds it (slot ``source(o, G)`` if it is one,
else the lowest), in place, over NVLink where the cards differ (``reads``,
peer access, ``enable_peer``); else from a slot of another process of its
host (``host_name``, gathered from every process) that holds it (the
source slot if it is on the host, else the lowest), mapped over CUDA IPC
on the reading card (``opened``); else o is remote (``remote``): the
process of the source slot, which always holds it, serves its rows,
samples and text rows to the slot's card in rounds (``parallel.exchange``,
kernel N).  A remote shard is never copied whole to the reader.  With D =
1 a slot is a process and these are the process rules (``routes``); with
N = 1 they are the card rules of ``ShardedIndex.on_cards``.  A group
across hosts runs MEM and Greedy, both with the text-compare hybrid on an
index with a text copy (kernel Y, ``ops.hybrid.switch_hosts``).

On the card each held shard is an allocation of its own (csrc/peer.cu),
published by its CUDA IPC handle once its upload has finished, when a
slot of another process maps it; the reader opens it on its own card,
over NVLink when the holder's card is another.  An open that fails
raises, naming both cards and the CUDA error: no shard is copied in place
of mapping it.  On the CPU (``device="cpu"`` or ``["cpu"] * k``, the
tests) the holder writes each shard it serves to a file in a run
directory that the lowest process of its host makes in the temporary
directory and names to that host's processes, and the readers map the
file read-only (np.memmap): the ownership and the teardown, rehearsed
without a card.

Teardown (``PeerShards.close``): the readers unmap, a barrier, then the
holders free (on the CPU: unlink their files, a second barrier, the
lowest process of each host removes its run directory), so that no
holder frees a shard that a peer still reads.  It runs when the caller
closes the shards, and at the latest before the process leaves its group
(``multihost.before_leave``).
"""

from __future__ import annotations

import ctypes
import os
import socket
import tempfile
import warnings

import numpy as np
import torch

from .. import kernels
from . import multihost

HANDLE_BYTES = 64  # sizeof(cudaIpcMemHandle_t)


def held(slot: int, slots: int, n_shards: int) -> list[int]:
    """The shards that slot (or process) `slot` of `slots` holds."""
    if slots >= n_shards:
        return [slot % n_shards]
    return list(range(slot, n_shards, slots))


def source(shard: int, slots: int) -> int:
    """The slot (or process) that holds `shard` for every reader that
    takes it from its source."""
    return shard % slots


def host_name() -> str:
    """The name of this process's host, which decides what a process maps
    and what is served to it in rounds (a test or a rehearsal may replace
    this function to give each process a host of its own)."""
    return socket.gethostname()


def slot_routes(slot: int, hosts: list, cards: int,
                n_shards: int) -> tuple[list, dict, dict, dict]:
    """The shards of slot `slot` (card slot mod cards of process slot //
    cards) of a group whose processes run on hosts (a name a process),
    each on `cards` cards: (held, {shard: card of this process it is read
    from}, {shard: slot of another process of this host it is mapped
    from}, {shard: process that serves it in rounds}) (module
    docstring)."""
    G = len(hosts) * cards
    p = slot // cards
    mine = held(slot, G, n_shards)
    reads, opened, remote = {}, {}, {}
    for o in range(n_shards):
        if o in mine:
            continue
        src = source(o, G)
        holders = [h for h in range(G) if o in held(h, G, n_shards)]
        own = [h for h in holders if h // cards == p]
        near = [h for h in holders if hosts[h // cards] == hosts[p]]
        if own:
            reads[o] = (src if src in own else min(own)) - p * cards
        elif near:
            opened[o] = src if src in near else min(near)
        else:
            remote[o] = src // cards
    return mine, reads, opened, remote


def routes(pid: int, hosts: list, n_shards: int) -> tuple[dict, dict]:
    """For process pid of a group of one card a process on hosts:
    ({shard: process it is mapped from}, {shard: process that serves it in
    rounds}), ``slot_routes`` with one card."""
    _mine, _reads, opened, remote = slot_routes(pid, hosts, 1, n_shards)
    return opened, remote


def group_hosts(group) -> list:
    """Every process's host_name(), in rank order (every process of the
    group calls it)."""
    import torch.distributed as dist

    hosts = [None] * dist.get_world_size(group)
    dist.all_gather_object(hosts, host_name(), group=group)
    return hosts


def map_file(path: str, shape, dtype: np.dtype) -> torch.Tensor:
    """A CPU tensor over the file a holder wrote, mapped read-only."""
    a = np.memmap(path, dtype=dtype, mode="r", shape=tuple(shape))
    with warnings.catch_warnings():  # read-only, and nothing writes it
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


def _peer_lib() -> ctypes.CDLL:
    lib = kernels.load("peer")
    if not getattr(lib, "_kt_peer_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, args in (("kt_peer_alloc", (i, ctypes.c_size_t,
                                            ctypes.POINTER(p))),
                         ("kt_peer_handle", (p, p)),
                         ("kt_peer_open", (i, p, ctypes.POINTER(p))),
                         ("kt_peer_close", (p,)),
                         ("kt_peer_free", (p,)),
                         ("kt_peer_enable", (i, i))):
            getattr(lib, fn).restype = i
            getattr(lib, fn).argtypes = args
        lib._kt_peer_set = True
    return lib


_ENABLED: set = set()  # (reader, holder) card pairs with peer access on


def enable_peer(reader: torch.device, holder: torch.device) -> None:
    """Let kernels on card `reader` read tensors of card `holder` in place,
    over NVLink (csrc/peer.cu kt_peer_enable); nothing to do for one card
    or the CPU.  Raises, naming both cards, where they have no peer
    access: a shard is never copied to the reader instead."""
    if reader.type != "cuda" or holder.type != "cuda" or \
            reader.index == holder.index or (reader.index,
                                             holder.index) in _ENABLED:
        return
    if "expandable_segments:true" in os.environ.get(
            "PYTORCH_CUDA_ALLOC_CONF", "").replace(" ", "").lower():
        # such segments are mapped for their own card only; peer access
        # enabled here does not reach them
        raise RuntimeError(
            f"cuda:{reader.index} cannot read the index shards of "
            f"cuda:{holder.index} in place: PYTORCH_CUDA_ALLOC_CONF sets "
            "expandable_segments")
    lib = _peer_lib()
    rc = lib.kt_peer_enable(reader.index, holder.index)
    if rc != 0:
        raise RuntimeError(
            f"cuda:{reader.index} cannot read the index shards of "
            f"cuda:{holder.index}: peer access failed with CUDA error {rc} "
            f"({lib.kt_error_string(rc).decode()})")
    _ENABLED.add((reader.index, holder.index))


class _CudaArray:
    """A device pointer as ``__cuda_array_interface__``, which
    torch.as_tensor wraps without a copy, on the card that holds it."""

    def __init__(self, ptr: int, shape, dtype: np.dtype):
        self.__cuda_array_interface__ = {
            "shape": tuple(shape), "typestr": dtype.str,
            "data": (ptr, False), "strides": None, "version": 2}


class PeerShards:
    """The shards of one index as the cards of process `rank` of `group`
    (a torch.distributed group of more than one process) read them, card
    c of D = len(cards) being slot rank D + c (module docstring): for
    each card, ``held[c]`` the shards it holds, uploaded to it,
    ``reads[c]`` {shard: card of this process it is read from in place},
    ``opened[c]`` {shard: slot of another process of this host it is
    mapped from} and ``remote[c]`` {shard: process that serves it};
    ``hosts`` is every process's host, and ``spans_hosts`` says whether
    they differ."""

    def __init__(self, cards: list, n_shards: int, group):
        import torch.distributed as dist

        self.cards = [torch.device(c) for c in cards]
        if len({c.type for c in self.cards}) != 1:
            raise ValueError(f"cards of one kind expected, got {self.cards}")
        self.D = len(self.cards)
        self.S = n_shards
        self.group = group
        self.pid = dist.get_rank(group)
        self.nprocs = dist.get_world_size(group)
        self.hosts = group_hosts(group)
        self.spans_hosts = len(set(self.hosts)) > 1
        routes_ = [slot_routes(self.pid * self.D + c, self.hosts, self.D,
                               n_shards) for c in range(self.D)]
        self.held, self.reads, self.opened, self.remote = (
            [r[k] for r in routes_] for k in range(4))
        self.run_dir = None
        self._lib = _peer_lib() if self.cards[0].type == "cuda" else None
        self._owned: list = []  # our allocations (card) or files (CPU)
        self._maps: list = []  # peers' allocations mapped here (card)
        self._closed = False
        multihost.before_leave(self.close)
        if self._lib is None:  # the lowest process of each host makes
            first = self.hosts.index(self.hosts[self.pid])  # the run dir
            made = (tempfile.mkdtemp(prefix="kaiju_tpu_shards_")
                    if self.pid == first else None)
            names = [None] * self.nprocs
            dist.all_gather_object(names, made, group=group)
            self.run_dir = names[first]

    def _serves(self) -> set:
        """The (card, shard) pairs of this process that a slot of another
        process maps."""
        D, base = self.D, self.pid * self.D
        return {(h - base, o) for g in range(self.nprocs * D)
                for o, h in slot_routes(g, self.hosts, D, self.S)[2].items()
                if base <= h < base + D}

    def parts(self, arrays: dict) -> list[dict]:
        """{name: S host parts (numpy)} -> for each card, {name: S
        tensors, None for a remote shard}: the held parts uploaded to
        their cards, every part another card of this process holds read
        from there, every other part of this host mapped from its holder,
        once a card, all handles exchanged in one all-gather."""
        import torch.distributed as dist

        D, base = self.D, self.pid * self.D
        out = [{name: [None] * self.S for name in arrays} for _ in range(D)]
        mine = {}
        serves = self._serves()
        for name, host in arrays.items():
            for c in range(D):
                for o in self.held[c]:
                    serve = (c, o) in serves
                    out[c][name][o], key = self._hold(
                        c, np.ascontiguousarray(host[o]), serve,
                        f"{name}_{o}")
                    if serve:
                        mine[name, base + c, o] = (
                            key, host[o].shape, host[o].dtype.str,
                            str(self.cards[c]))
        if self._lib is not None:  # uploads done before the handles go out
            for card in dict.fromkeys(self.cards):
                torch.cuda.synchronize(card)
        everyone = [None] * self.nprocs
        dist.all_gather_object(everyone, mine, group=self.group)
        maps = {}  # (card, handle or file): the tensor mapped there
        for c in range(D):
            for o, h in self.opened[c].items():
                for name in arrays:
                    key, shape, dtype, at = everyone[h // D][name, h, o]
                    got = (str(self.cards[c]), key)
                    if got not in maps:
                        maps[got] = self._open(
                            c, key, shape, np.dtype(dtype), f"{name} shard "
                            f"{o} of process {h // D} (its {at})")
                    out[c][name][o] = maps[got]
            for o, h in self.reads[c].items():
                for name in arrays:
                    out[c][name][o] = out[h][name][o]
        if self._lib is not None:  # kt_peer_* made other cards current
            torch.cuda.set_device(self.cards[0])
        return out

    def _hold(self, c: int, a: np.ndarray, serve: bool, tag: str):
        """a on card c, and what a peer opens it by (the IPC handle, or
        the file) if a slot of another process maps it."""
        if self._lib is None:
            t = torch.from_numpy(a.copy())
            if not serve:
                return t, None
            path = os.path.join(self.run_dir,
                                f"{tag}.s{self.pid * self.D + c}")
            a.tofile(path)
            self._owned.append(path)
            return t, path
        card = self.cards[c]
        ptr = ctypes.c_void_p()
        self._call("kt_peer_alloc", f"cudaMalloc of {tag} on {card}",
                   card.index, a.nbytes, ctypes.byref(ptr))
        self._owned.append(ptr.value)
        t = torch.as_tensor(_CudaArray(ptr.value, a.shape, a.dtype))
        t.copy_(torch.from_numpy(a))
        if not serve:
            return t, None
        handle = ctypes.create_string_buffer(HANDLE_BYTES)
        self._call("kt_peer_handle", f"cudaIpcGetMemHandle of {tag}", ptr,
                   handle)
        return t, handle.raw

    def _open(self, c: int, key, shape, dtype: np.dtype,
              what: str) -> torch.Tensor:
        if self._lib is None:
            return map_file(key, shape, dtype)
        card = self.cards[c]
        ptr = ctypes.c_void_p()
        self._call("kt_peer_open", f"cudaIpcOpenMemHandle of {what} on "
                   f"{card} (across cards it needs peer access)",
                   card.index, ctypes.create_string_buffer(key),
                   ctypes.byref(ptr))
        self._maps.append(ptr.value)
        return torch.as_tensor(_CudaArray(ptr.value, shape, dtype))

    def _call(self, fn: str, what: str, *args) -> None:
        rc = getattr(self._lib, fn)(*args)
        if rc != 0:
            msg = self._lib.kt_error_string(rc).decode()
            raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")

    def close(self) -> None:
        """Unmap the peers' shards, wait for every process to do so, then
        free the held ones (on the CPU, unlink, and the lowest process of
        each host removes its run directory).  Every process of the group
        calls it; the tensors of ``parts`` are invalid after it."""
        import torch.distributed as dist

        if self._closed:
            return
        self._closed = True
        if self._lib is not None:
            for card in dict.fromkeys(self.cards):
                torch.cuda.synchronize(card)
            for ptr in self._maps:
                self._call("kt_peer_close", "cudaIpcCloseMemHandle",
                           ctypes.c_void_p(ptr))
        self._maps.clear()
        dist.barrier(group=self.group)
        for item in self._owned:
            if self._lib is None:
                os.unlink(item)
            else:
                self._call("kt_peer_free", "cudaFree", ctypes.c_void_p(item))
        self._owned.clear()
        if self._lib is None:
            dist.barrier(group=self.group)
            if self.pid == self.hosts.index(self.hosts[self.pid]):
                os.rmdir(self.run_dir)
