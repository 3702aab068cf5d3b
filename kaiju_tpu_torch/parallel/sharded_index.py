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

Every shard is a tensor of its own.  In this port all S shards live on the
one device the pipeline runs on: spreading them over cards (peer access or
NCCL, one process a card) is ROADMAP item 10e, and it needs no new layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.core import BLOCK, KaijuIndex
from ..ops.device_index import (Shards, build_fused_records, extend_all,
                                extend_all_plain, resolve_device, sa_lookup,
                                sa_lookup_plain)


def _split(a: np.ndarray, S: int, per: int, extra: int, fill, put):
    """S tensors of a's rows [o per, o per + per + extra), a padded with
    rows of `fill` to S per + extra rows."""
    need = S * per + extra - a.shape[0]
    if need > 0:
        pad = np.broadcast_to(fill, (need, *a.shape[1:])).astype(a.dtype)
        a = np.concatenate([a, pad])
    return [put(a[o * per:o * per + per + extra]) for o in range(S)]


class ShardedIndex:
    """The arrays of DeviceIndex (ops/device_index.py) with ``rec``,
    ``sa_seq``, ``sa_off`` and ``text`` as ``Shards`` of S parts; ``C``,
    ``seq_tax`` and ``rank_start`` are replicated.  nb_s, ns_s and ntb_s
    are the blocks, sample slots and text rows of a shard."""

    def __init__(self, index: KaijuIndex, n_shards: int, device=None):
        if n_shards < 1:
            raise ValueError(f"--mesh-index must be >= 1, got {n_shards}")
        S = self.S = int(n_shards)
        self.device = dev = resolve_device(device)

        def put(a):  # a copy: every shard is an allocation of its own
            return torch.from_numpy(np.array(a)).to(dev)

        rec = build_fused_records(index)
        nb = rec.shape[0] - 1
        self.nb_s = -(-nb // S)
        self.rec = Shards(_split(rec, S, self.nb_s, 1, rec[-1], put),
                          self.nb_s, nb + 1)
        sa_seq = np.asarray(index.sa_seq, dtype=np.int32)
        ns = sa_seq.shape[0]
        self.ns_s = max(1, -(-ns // S))
        self.sa_seq = Shards(_split(sa_seq, S, self.ns_s, 0, 0, put),
                             self.ns_s, ns)
        self.sa_off = Shards(_split(np.asarray(index.sa_off, dtype=np.int32),
                                    S, self.ns_s, 0, 0, put), self.ns_s, ns)
        self.C = put(np.asarray(index.C, dtype=np.int32))
        self.seq_tax = put(np.asarray(index.seq_taxids, dtype=np.int32))
        self.nseq = int(index.nseq)
        self.chpt_exp = int(index.chpt_exp)
        self.text = self.rank_start = None
        self.ntb_s = 0
        if index.text is not None:
            text = np.asarray(index.text, dtype=np.uint8)
            ntb = -(-text.shape[0] // BLOCK)
            self.ntb_s = max(1, -(-ntb // S))
            per = self.ntb_s * BLOCK
            self.text = Shards(_split(text, S, per, 0, 0, put), per,
                               text.shape[0])
            self.rank_start = put(index.rank_text_starts().astype(np.int32))

    @property
    def has_text(self) -> bool:
        return self.text is not None


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
