"""K-mer seed tables: precomputed backward-search intervals.

For every k-mer (over the 20 letter codes 1..20) up to depth K, the SA
interval after k backward-extension steps is precomputed.  Seeding a lane
with its trailing k-mer replaces the first K extension steps with one
table lookup; most non-matching end positions die inside the table.

This is new relative to the reference (which starts every extension from
scratch, bwt.c:267-269) but exact: the table IS the first K steps.  The
tables are built on the device with kernel A (``update_si``) or on the
host with numpy; both give the same arrays.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..index.core import KaijuIndex
from .device_index import update_si

NLET = 20  # letter codes 1..20 (makedb alphabet)
DEVICE_CHUNK = 1 << 22  # UpdateSI probes a launch while building


class KmerTables:
    """tables[d] = (si0, si1) int64 arrays of size NLET^d, d = 1..K.

    Index of k-mer c_1..c_d (c_1 = leftmost, letter codes 1..20):
    sum (c_i - 1) * NLET^(d-i).  Empty intervals are (0, 0).
    """

    def __init__(self, tables: list[tuple[np.ndarray, np.ndarray]]):
        self.tables = [(np.asarray(a), np.asarray(b)) for a, b in tables]
        self.K = len(self.tables)

    @classmethod
    def build(cls, index: KaijuIndex, K: int) -> "KmerTables":
        """Host build: numpy UpdateSI per (letter, k-mer) pair."""
        # materialize (the index may be mmap-backed; fancy indexing on a
        # memmap is pathologically slow)
        blocks = np.ascontiguousarray(index.blocks)
        occ = np.ascontiguousarray(index.occ)
        C = np.ascontiguousarray(index.C)
        lanes = np.arange(128, dtype=np.int64)

        def fmindex(c, k):
            b = k >> 7
            base = occ[b, c].astype(np.int64)
            rows = blocks[np.minimum(b, len(blocks) - 1)]
            off = (k & 127)[:, None]
            cnt = ((rows == c[:, None]) & (lanes < off)).sum(axis=1)
            return C[c] + base + cnt

        tables = []
        # depth 1: InitialSI per letter (reference: bwt.c:146-152)
        codes = np.arange(1, NLET + 1, dtype=np.int64)
        tables.append((index.C[codes], index.C[codes + 1]))
        chunk = 1 << 21
        for _d in range(2, K + 1):
            p0, p1 = tables[-1]
            n = len(p0)
            # prepend each letter c: new interval = UpdateSI(c, prev)
            n0 = np.zeros(n * NLET, dtype=np.int64)
            n1 = np.zeros(n * NLET, dtype=np.int64)
            for ci, c in enumerate(codes):
                for lo in range(0, n, chunk):
                    hi = min(n, lo + chunk)
                    s0 = p0[lo:hi]
                    s1 = p1[lo:hi]
                    alive = s0 < s1
                    if not alive.any():
                        continue
                    carr = np.full(int(alive.sum()), c, dtype=np.int64)
                    n0a = fmindex(carr, s0[alive])
                    n1a = fmindex(carr, s1[alive])
                    ok = n0a < n1a
                    idx = ci * n + lo + np.flatnonzero(alive)[ok]
                    n0[idx] = n0a[ok]
                    n1[idx] = n1a[ok]
            tables.append((n0, n1))
        return cls(tables)

    @classmethod
    def build_device(cls, index: KaijuIndex, K: int, device_index) -> "KmerTables":
        """Build the per-depth interval tables with batched UpdateSI probes
        on the device index's device: every (letter, previous k-mer) pair,
        20 * 20^(d-1) probes at depth d, through kernel A on the card."""
        dv = device_index
        codes = np.arange(1, NLET + 1, dtype=np.int64)
        tables = [(index.C[codes], index.C[codes + 1])]
        letters = torch.arange(1, NLET + 1, dtype=torch.int32, device=dv.device)
        p0, p1 = (torch.from_numpy(t.astype(np.int32)).to(dv.device)
                  for t in tables[0])
        for _d in range(2, K + 1):
            n = p0.shape[0]
            c = letters.repeat_interleave(n)
            s0 = p0.repeat(NLET)
            s1 = p1.repeat(NLET)
            n0 = torch.zeros_like(s0)
            n1 = torch.zeros_like(s1)
            for lo in range(0, n * NLET, DEVICE_CHUNK):
                hi = min(n * NLET, lo + DEVICE_CHUNK)
                r0, r1, ok = update_si(dv.rec, dv.C, c[lo:hi], s0[lo:hi],
                                       s1[lo:hi])
                n0[lo:hi] = torch.where(ok, r0, 0)
                n1[lo:hi] = torch.where(ok, r1, 0)
            # empty previous intervals must stay empty
            alive = (p0 < p1).repeat(NLET)
            p0 = torch.where(alive, n0, 0)
            p1 = torch.where(alive, n1, 0)
            tables.append(
                (p0.cpu().numpy().astype(np.int64),
                 p1.cpu().numpy().astype(np.int64))
            )
        return cls(tables)

    # ---- persistence --------------------------------------------------

    def save(self, dirpath: str) -> None:
        os.makedirs(dirpath, exist_ok=True)
        for d, (s0, s1) in enumerate(self.tables, start=1):
            np.save(os.path.join(dirpath, f"si0_{d}.npy"), s0)
            np.save(os.path.join(dirpath, f"si1_{d}.npy"), s1)

    @classmethod
    def load_or_build(cls, index: KaijuIndex, cache_dir: str | None, K: int,
                      device_index=None):
        """Tables of depth K from `cache_dir`/kmerK, else built (on the
        device index's device when one is given) and saved there."""
        path = os.path.join(cache_dir, f"kmer{K}") if cache_dir else None
        if path and os.path.exists(os.path.join(path, f"si0_{K}.npy")):
            tables = [
                (
                    np.load(os.path.join(path, f"si0_{d}.npy")),
                    np.load(os.path.join(path, f"si1_{d}.npy")),
                )
                for d in range(1, K + 1)
            ]
            return cls(tables)
        if device_index is not None:
            t = cls.build_device(index, K, device_index)
        else:
            t = cls.build(index, K)
        if path:
            try:
                t.save(path)
            except OSError:
                pass
        return t

    # ---- packed single-lookup seed records ----------------------------

    def packed_seed_rec(self, K: int | None = None) -> np.ndarray:
        """[NLET^K, 4] int32 rows (si0, si1, d*, 0): for each K-mer id, the
        DEEPEST d <= K whose d-suffix (= the first d backward-extension
        steps) has a non-empty interval, with that interval.  d* == 0 means
        even the last letter is absent from the DB."""
        K = K or self.K
        K = min(K, self.K)
        n = NLET**K
        rec = np.zeros((n, 4), dtype=np.int32)
        ids = np.arange(n, dtype=np.int64)
        for d in range(1, K + 1):
            sub = ids % (NLET**d) if d < K else ids
            t0, t1 = self.tables[d - 1]
            s0 = t0[sub]
            s1 = t1[sub]
            pres = s0 < s1
            rec[pres, 0] = s0[pres].astype(np.int32)
            rec[pres, 1] = s1[pres].astype(np.int32)
            rec[pres, 2] = d
        return rec

    def planar_seed(self, K: int | None = None):
        """packed_seed_rec as three planar 1-D arrays (s0 int32, s1 int32,
        d int8), the seed inputs of kernel B."""
        rec = self.packed_seed_rec(K)
        return (
            np.ascontiguousarray(rec[:, 0]),
            np.ascontiguousarray(rec[:, 1]),
            np.ascontiguousarray(rec[:, 2]).astype(np.int8),
        )
