"""The independent host int64 rank over a big BWT: ``BigRank``, the
counterpart of scripts/big_build_demo.py:BigRank (:55-87).

It counts its own int64 occ checkpoints from the raw BWT bytes, with no
shard layout, so it checks the sharded big index (``parallel.big_index``)
and kernels L and M from outside: ``tools.big_classify``'s oracle walks it.
"""

from __future__ import annotations

import numpy as np

from ..parallel.big_index import block_counts

BLOCK = 128


class BigRank:
    """int64 occ checkpoints over the big BWT, host-side (the ktx occ
    array is int32 and deliberately capped at 2^31 per shard)."""

    def __init__(self, bwt: np.ndarray, alen: int):
        n = len(bwt)
        nb = (n + BLOCK - 1) // BLOCK
        pad = np.full(nb * BLOCK - n, 255, dtype=np.uint8)
        self.bwt = np.concatenate([bwt, pad]) if len(pad) else bwt
        self.blocks = self.bwt.reshape(nb, BLOCK)
        self.occ = np.zeros((nb + 1, alen), dtype=np.int64)
        self.occ[1:] = block_counts(self.blocks, alen)
        np.cumsum(self.occ, axis=0, out=self.occ)
        counts = self.occ[-1]
        self.C = np.zeros(alen + 1, dtype=np.int64)
        np.cumsum(counts, out=self.C[1:])

    def rank(self, c: int, k: int) -> int:
        b = k >> 7
        base = int(self.occ[b, c])
        off = k & (BLOCK - 1)
        if off:
            row = self.blocks[b]
            base += int((row[:off] == c).sum())
        return base

    def fmindex(self, c: int, k: int) -> int:
        return int(self.C[c]) + self.rank(c, k)
