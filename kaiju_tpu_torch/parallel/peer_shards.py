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

Who holds what: process p of N holds shard o of S when o = p mod S, for N
>= S (kaiju_tpu's (data x index) mesh of one card a process, index axis
innermost, multihost.py:41-53; processes p >= S hold replicas), and when
o mod N = p, for N < S (ceil or floor S / N shards each, as a JAX process
with S / N devices).  A shard that a process does not hold is read from
process o mod N, which holds it either way (``held``, ``source``).

On the card (process p on ``cuda:{p % cards}``) each held shard is an
allocation of its own (csrc/peer.cu), published by its CUDA IPC handle
once its upload has finished; a reader maps it on its own card, or over
NVLink from another card of the host.  An open that fails raises with the
CUDA error: no shard is copied in place of mapping it.  On the CPU
(``device="cpu"``, the tests) the holder writes each shard it serves to a
file in a run directory that the lowest process of its host makes in the
temporary directory and names to that host's processes, and the readers
map the file read-only (np.memmap): the ownership and the teardown,
rehearsed without a card.

Several hosts (``host_name``, gathered from every process): CUDA IPC
reaches the processes of one host only.  For each shard o that process p
does not hold: if its source o mod N is on p's host, p maps it from
there; else, if another process of p's host holds o, p maps it from the
lowest such process; else o is remote for p (``remote``), and its source,
which always holds it, serves its rows and samples to p in rounds
(``parallel.exchange``, kernel N).  A remote shard is never copied whole
to the reader.  Such a group runs MEM and Greedy, both without the
text-compare hybrid.

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


def held(pid: int, nprocs: int, n_shards: int) -> list[int]:
    """The shards that process pid of nprocs holds."""
    if nprocs >= n_shards:
        return [pid % n_shards]
    return list(range(pid, n_shards, nprocs))


def source(shard: int, nprocs: int) -> int:
    """The process that a process not holding `shard` reads it from."""
    return shard % nprocs


def host_name() -> str:
    """The name of this process's host, which decides what a process maps
    and what is served to it in rounds (a test or a rehearsal may replace
    this function to give each process a host of its own)."""
    return socket.gethostname()


def routes(pid: int, hosts: list, n_shards: int) -> tuple[dict, dict]:
    """For process pid of a group whose processes run on hosts (a name a
    process): ({shard: process it is mapped from}, {shard: process that
    serves it in rounds}) over the shards pid does not hold (module
    docstring)."""
    N = len(hosts)
    mine = set(held(pid, N, n_shards))
    opened, remote = {}, {}
    for o in range(n_shards):
        if o in mine:
            continue
        src = source(o, N)
        near = [q for q in range(N) if hosts[q] == hosts[pid]
                and o in held(q, N, n_shards)]
        if hosts[src] == hosts[pid]:
            opened[o] = src
        elif near:
            opened[o] = min(near)
        else:
            remote[o] = src
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
    """The shards of one index as process `rank` of `group` (a
    torch.distributed group of more than one process) reads them: those it
    holds, uploaded to `device`, and the others mapped from a process of
    its host (module docstring).  ``held`` lists the held shards,
    ``opened`` maps every shard mapped to the process it was mapped from,
    ``remote`` every shard no process of this host holds to the process
    that serves it; ``hosts`` is every process's host, and
    ``spans_hosts`` says whether they differ."""

    def __init__(self, device: torch.device, n_shards: int, group):
        import torch.distributed as dist

        self.device = device
        self.S = n_shards
        self.group = group
        self.pid = dist.get_rank(group)
        self.nprocs = dist.get_world_size(group)
        self.held = held(self.pid, self.nprocs, n_shards)
        self.hosts = group_hosts(group)
        self.spans_hosts = len(set(self.hosts)) > 1
        self.opened, self.remote = routes(self.pid, self.hosts, n_shards)
        self.run_dir = None
        self._lib = _peer_lib() if device.type == "cuda" else None
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
        """The held shards that a process maps from this one."""
        return {o for p in range(self.nprocs)
                for o, q in routes(p, self.hosts, self.S)[0].items()
                if q == self.pid}

    def parts(self, arrays: dict) -> dict:
        """{name: S host parts (numpy)} -> {name: S tensors, None for a
        remote shard}: the held parts uploaded, every other part of this
        host mapped from its holder, all handles exchanged in one
        all-gather."""
        import torch.distributed as dist

        out = {name: [None] * self.S for name in arrays}
        mine = {}
        serves = self._serves()
        for name, host in arrays.items():
            for o in self.held:
                serve = o in serves
                out[name][o], key = self._hold(
                    np.ascontiguousarray(host[o]), serve, f"{name}_{o}")
                if serve:
                    mine[name, o] = (key, host[o].shape, host[o].dtype.str)
        if self._lib is not None:  # uploads done before the handles go out
            torch.cuda.synchronize(self.device)
        everyone = [None] * self.nprocs
        dist.all_gather_object(everyone, mine, group=self.group)
        for o, p in self.opened.items():
            for name in arrays:
                key, shape, dtype = everyone[p][name, o]
                out[name][o] = self._open(key, shape, np.dtype(dtype),
                                          f"{name} shard {o} of process {p}")
        return out

    def _hold(self, a: np.ndarray, serve: bool, tag: str):
        """a on this process's device, and what a peer opens it by (the
        IPC handle, or the file) if this process serves it."""
        if self._lib is None:
            t = torch.from_numpy(a.copy())
            if not serve:
                return t, None
            path = os.path.join(self.run_dir, f"{tag}.p{self.pid}")
            a.tofile(path)
            self._owned.append(path)
            return t, path
        ptr = ctypes.c_void_p()
        self._call("kt_peer_alloc", f"cudaMalloc of {tag}", self.device.index,
                   a.nbytes, ctypes.byref(ptr))
        self._owned.append(ptr.value)
        t = torch.as_tensor(_CudaArray(ptr.value, a.shape, a.dtype))
        t.copy_(torch.from_numpy(a))
        if not serve:
            return t, None
        handle = ctypes.create_string_buffer(HANDLE_BYTES)
        self._call("kt_peer_handle", f"cudaIpcGetMemHandle of {tag}", ptr,
                   handle)
        return t, handle.raw

    def _open(self, key, shape, dtype: np.dtype, what: str) -> torch.Tensor:
        if self._lib is None:
            return map_file(key, shape, dtype)
        ptr = ctypes.c_void_p()
        self._call("kt_peer_open", f"cudaIpcOpenMemHandle of {what} on "
                   f"{self.device} (across cards it needs peer access)",
                   self.device.index, ctypes.create_string_buffer(key),
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
        each host removes its run directory).  Every process of the group calls it; the tensors of
        ``parts`` are invalid after it."""
        import torch.distributed as dist

        if self._closed:
            return
        self._closed = True
        if self._lib is not None:
            torch.cuda.synchronize(self.device)
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
