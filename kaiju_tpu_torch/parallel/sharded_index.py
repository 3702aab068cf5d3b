"""The FM index split into S contiguous shards (K16, ``--mesh-index S``).

The counterpart of kaiju_tpu/parallel/sharded_index.py, with its layout:
shard o owns the BWT blocks [o nb_s, (o + 1) nb_s), nb_s = ceil(nb / S),
the SA sample slots [o ns_s, (o + 1) ns_s) and, on an index with a text
copy, the text bytes of the 128-byte rows [o ntb_s, (o + 1) ntb_s), the
row ranges that match the BWT shards.  The last shard is padded as
kaiju_tpu pads it: blocks of byte 31 with the last occ row repeated, zero
samples, zero text.

A shard of rank records is its nb_s rows of the port's ``rec`` plus one
end row.  Those rows carry the global occ counts, so the owner's row
answers FMindex(c, k) by itself: C[c] + its occ word + the count in the
block, which is ``_sharded_fmindex``'s C[c] + shard_base[owner, c] +
occ_local[owner][k >> 7 - owner nb_s, c] + the same count
(tests/test_torch_sharded.py holds the two equal).  The JAX program
assembles each step's value with a psum over the index axis of its mesh;
the kernels read the owner's row directly (``kt::ShardIx``,
csrc/fm_common.cuh), through a device table of shard pointers.

Every shard is a tensor of its own.  In one process all S shards live on
the device the pipeline runs on.  Given a group of N > 1 processes, each
process uploads only the shards it holds and maps the others from the
processes that hold them (``parallel.peer_shards``, CUDA IPC on the
card), with the same layout: only the pointers in the tables change.
Shards of one process on several cards are ROADMAP item 10e.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.core import BLOCK, KaijuIndex
from ..ops.device_index import (Shards, build_fused_records, extend_all,
                                extend_all_plain, resolve_device, sa_lookup,
                                sa_lookup_plain)
from .peer_shards import PeerShards


def _split(a: np.ndarray, S: int, per: int, extra: int, fill) -> list:
    """S arrays of a's rows [o per, o per + per + extra), a padded with
    rows of `fill` to S per + extra rows."""
    need = S * per + extra - a.shape[0]
    if need > 0:
        pad = np.broadcast_to(fill, (need, *a.shape[1:])).astype(a.dtype)
        a = np.concatenate([a, pad])
    return [a[o * per:o * per + per + extra] for o in range(S)]


class ShardedIndex:
    """The arrays of DeviceIndex (ops/device_index.py) with ``rec``,
    ``sa_seq``, ``sa_off`` and ``text`` as ``Shards`` of S parts; ``C``,
    ``seq_tax`` and ``rank_start`` are replicated.  nb_s, ns_s and ntb_s
    are the blocks, sample slots and text rows of a shard.

    group: None, or a torch.distributed group; with more than one process
    in it, this process holds only its shards and maps the others from
    their holders (``parallel.peer_shards``; every process of the group
    makes its ShardedIndex together, and ``share.close`` releases them,
    at the latest when the process leaves its group).
    ``held`` lists the shards this process holds, ``opened`` maps each
    other shard to the process it was mapped from."""

    def __init__(self, index: KaijuIndex, n_shards: int, device=None,
                 group=None):
        if n_shards < 1:
            raise ValueError(f"--mesh-index must be >= 1, got {n_shards}")
        S = self.S = int(n_shards)

        where = resolve_device(device)

        def put(a):  # a copy: every shard is an allocation of its own
            return torch.from_numpy(np.array(a)).to(where)

        self.C = put(np.asarray(index.C, dtype=np.int32))
        self.device = dev = self.C.device  # with its card's number
        self.seq_tax = put(np.asarray(index.seq_taxids, dtype=np.int32))
        self.nseq = int(index.nseq)
        self.chpt_exp = int(index.chpt_exp)
        rec = build_fused_records(index)
        nb = rec.shape[0] - 1
        self.nb_s = -(-nb // S)
        sa_seq = np.asarray(index.sa_seq, dtype=np.int32)
        ns = sa_seq.shape[0]
        self.ns_s = max(1, -(-ns // S))
        host = {"rec": _split(rec, S, self.nb_s, 1, rec[-1]),
                "sa_seq": _split(sa_seq, S, self.ns_s, 0, 0),
                "sa_off": _split(np.asarray(index.sa_off, dtype=np.int32), S,
                                 self.ns_s, 0, 0)}
        size = {"rec": (self.nb_s, nb + 1), "sa_seq": (self.ns_s, ns),
                "sa_off": (self.ns_s, ns)}
        self.rank_start = None
        self.ntb_s = 0
        if index.text is not None:
            text = np.asarray(index.text, dtype=np.uint8)
            ntb = -(-text.shape[0] // BLOCK)
            self.ntb_s = max(1, -(-ntb // S))
            host["text"] = _split(text, S, self.ntb_s * BLOCK, 0, 0)
            size["text"] = (self.ntb_s * BLOCK, text.shape[0])
            self.rank_start = put(index.rank_text_starts().astype(np.int32))

        self.share = None
        if group is not None:
            import torch.distributed as dist

            if dist.get_world_size(group) > 1:
                self.share = PeerShards(dev, S, group)
        if self.share is None:
            parts = {k: [put(p) for p in v] for k, v in host.items()}
            self.held, self.opened = list(range(S)), {}
        else:
            parts = self.share.parts(host)
            self.held, self.opened = self.share.held, self.share.opened
        sh = {k: Shards(parts[k], *size[k], dev, self.opened) for k in parts}
        self.rec, self.sa_seq, self.sa_off = (sh["rec"], sh["sa_seq"],
                                              sh["sa_off"])
        self.text = sh.get("text")

    @property
    def has_text(self) -> bool:
        return self.text is not None

    def layout(self) -> dict:
        """The shards this process holds and maps: {"held": [o, ...],
        "opened": {o: process}, "bytes_held", "bytes_opened": {array:
        bytes}}."""
        arrays = {"rec": self.rec, "sa_seq": self.sa_seq,
                  "sa_off": self.sa_off, "text": self.text}

        def nbytes(shards):
            return {k: sum(a.parts[o].nbytes for o in shards)
                    for k, a in arrays.items() if a is not None}

        return {"held": list(self.held), "opened": dict(self.opened),
                "bytes_held": nbytes(self.held),
                "bytes_opened": nbytes(self.opened)}


# ---------------------------------------------------------------------------
# the sharded primitives (K16b, K16c)
# ---------------------------------------------------------------------------


def sharded_extend_all(sh: ShardedIndex, codes, flen):
    """make_sharded_extend_all (kaiju_tpu/parallel/sharded_index.py:123-182):
    (start, si0, si1) int32 [F, L] for codes uint8 [F, L] and flen int32
    [F], ranks from the owner shards.  Kernel J's sharded instantiation for
    CUDA tensors, the plain version for CPU tensors."""
    return extend_all(sh.rec, sh.C, codes, flen)


def sharded_extend_all_plain(sh: ShardedIndex, codes, flen, touched=None):
    return extend_all_plain(sh.rec, sh.C, codes, flen, touched)


def sharded_sa_lookup(sh: ShardedIndex, k):
    """make_sharded_sa_lookup (:185-270): (iseq, pos) int32 [N] of the SA
    positions k int32 [N], each LF step's BWT byte and rank and the SA
    sample from their owner.  Kernel H's sharded instantiation for CUDA
    tensors, the plain version for CPU tensors."""
    return sa_lookup(sh.rec, sh.C, sh.sa_seq, sh.sa_off, sh.nseq,
                     sh.chpt_exp, k)


def sharded_sa_lookup_plain(sh: ShardedIndex, k, touched=None):
    return sa_lookup_plain(sh.rec, sh.C, sh.sa_seq, sh.sa_off, sh.nseq,
                           sh.chpt_exp, k, touched)
