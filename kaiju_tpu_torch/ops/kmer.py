"""K-mer seed tables: precomputed backward-search intervals.

For every k-mer (over the 20 letter codes 1..20) up to depth K, the SA
interval after k backward-extension steps is precomputed.  Seeding a lane
with its trailing k-mer replaces the first K extension steps with one
table lookup; most non-matching end positions die inside the table.

This is new relative to the reference (which starts every extension from
scratch, bwt.c:267-269) but exact: the table IS the first K steps.  The
tables are built on the device with kernel A's letters form
(``update_si_letters``, one launch a depth) or on the host with numpy;
both give the same arrays.  Over a group of processes on several hosts
they are built through the exchange's rounds, kernel N answering the 20
letters' ranks of each row (``build_hosts``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..index.core import KaijuIndex
from .device_index import NLET, Q_ROW, update_si_letters


def default_depth(index: KaijuIndex) -> int:
    """Deep enough that a random k-mer is likely absent (kills junk lanes
    at seed time), capped by table memory (20^K * 16 B): the depth
    ``tools.mkdb --kmer`` builds."""
    import math

    k = math.ceil(math.log(max(index.length, 2), NLET)) + 1
    return max(4, min(6, k))
DEVICE_CHUNK = 1 << 22  # previous intervals a launch while building


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
        """Build the per-depth interval tables on the device index's device:
        UpdateSI of every letter on every previous interval, through kernel
        A's letters form on the card (one launch a depth up to DEVICE_CHUNK
        intervals), which reads each interval's rows once for all NLET
        letters and leaves dead intervals and empty pairs at (0, 0)."""
        dv = device_index
        codes = np.arange(1, NLET + 1, dtype=np.int64)
        tables = [(index.C[codes], index.C[codes + 1])]
        p0, p1 = (torch.from_numpy(t.astype(np.int32)).to(dv.device)
                  for t in tables[0])
        for _d in range(2, K + 1):
            n = p0.shape[0]
            parts = [update_si_letters(dv.rec, dv.C, p0[lo:lo + DEVICE_CHUNK],
                                       p1[lo:lo + DEVICE_CHUNK])
                     for lo in range(0, n, DEVICE_CHUNK)]
            # [NLET, n], letter-major: the k-mer index (c - 1) * n + prev
            p0, p1 = (parts[0][t] if len(parts) == 1 else
                      torch.cat([q[t] for q in parts], 1)
                      for t in range(2))
            p0, p1 = p0.reshape(-1), p1.reshape(-1)
            tables.append(
                (p0.cpu().numpy().astype(np.int64),
                 p1.cpu().numpy().astype(np.int64))
            )
        return cls(tables)

    @classmethod
    def build_hosts(cls, index: KaijuIndex, K: int, sh) -> "KmerTables":
        """build_device over the shards of a group of processes on several
        hosts (``sh``, a ShardedIndex with an ``exchange``): each depth's
        live intervals ask kernel N for the 20 letters' ranks at both ends
        (Q_ROW, one round of ``parallel.exchange`` a chunk), each answered
        by the process that reads the row's shard; every process of the
        group builds the same tables in the same rounds."""
        codes = np.arange(1, NLET + 1, dtype=np.int64)
        tables = [(index.C[codes], index.C[codes + 1])]
        p0, p1 = (torch.from_numpy(t.astype(np.int32)).to(sh.device)
                  for t in tables[0])
        for _d in range(2, K + 1):
            n = p0.shape[0]
            n0 = torch.zeros((NLET, n), dtype=torch.int32, device=sh.device)
            n1 = torch.zeros_like(n0)
            live = torch.nonzero(p0 < p1).squeeze(1)
            for lo in range(0, live.shape[0], DEVICE_CHUNK):
                x = live[lo:lo + DEVICE_CHUNK]
                m = x.shape[0]
                ends = torch.cat([p0[x], p1[x]])
                q = torch.stack([torch.full_like(ends, Q_ROW << 8), ends], 1)
                ans = sh.exchange.serve(q, NLET, "seed")
                r0, r1 = ans[:m].T, ans[m:].T
                ok = r0 < r1
                n0[:, x] = torch.where(ok, r0, 0)
                n1[:, x] = torch.where(ok, r1, 0)
            p0, p1 = n0.reshape(-1), n1.reshape(-1)
            tables.append((p0.cpu().numpy().astype(np.int64),
                           p1.cpu().numpy().astype(np.int64)))
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
        found = bool(path) and os.path.exists(os.path.join(path,
                                                           f"si0_{K}.npy"))
        exchange = getattr(device_index, "exchange", None)
        if exchange is not None and not exchange.all_agree(found):
            # a group on several hosts builds by rounds, in which a process
            # that found the tables still serves its peers
            t = cls.build_hosts(index, K, device_index)
            if not found:
                t._save_quietly(path)
            return t
        if found:
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
        t._save_quietly(path)
        return t

    def _save_quietly(self, path) -> None:
        if path:
            try:
                self.save(path)
            except OSError:
                pass

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
