"""MEM search: kernel B (``mem_extend``) and kernel C (``mem_stats``).

Together they compute what ``kaiju_tpu.ops.fused_mem2`` computes for MEM
(``_search_phases`` + ``_staged_extend`` + ``_mem_stats``): for a batch of
fragments laid out flat (codes ``flat`` uint8 [P], offsets ``frag_off``
int32 [F+1], monotone), the per-fragment greedyExact statistics (maxl,
tie_cnt, tie_j[T], tie_s0[T], tie_s1[T]).

B evaluates every lane (fragment, end j >= j0) to its maximal backward
extension: seed from the K-mer tables, then FM steps.  The JAX program
evaluates a subset (a Bloom-screened strip, then the unresolved
remainder) and proves the statistics equal on any superset
(fused_mem2.py:23-31); C reads every lane, so the statistics are the same
with or without screening.  B's results are in flat layout: lane p is
position j = p - frag_off[f] of the fragment f that owns p.
"""

from __future__ import annotations

import torch

from .. import kernels
from .device_index import rank

SEED_K = 5  # seed-table depth of the MEM search
TIE_CAP = 8  # ties kept per fragment
NLET = 20


def _lane_fragments(frag_off, P):
    """Owner f, start and length of the fragment of every flat position
    (the last fragment at a start owns it: empty fragments share starts)."""
    F = frag_off.shape[0] - 1
    pos = torch.arange(P, dtype=torch.int32, device=frag_off.device)
    f = torch.searchsorted(frag_off[:F].contiguous(), pos, right=True) - 1
    f = torch.clamp(f, 0, max(F - 1, 0))
    base = frag_off[f]
    return pos, f, base, frag_off[f + 1] - base


# ---------------------------------------------------------------------------
# kernel B
# ---------------------------------------------------------------------------


def mem_extend_plain(rec, C, seed_s0, seed_s1, seed_d, flat, frag_off, K, j0,
                     touched=None):
    """touched: None, or a list that receives the record rows read."""
    P = flat.shape[0]
    if P == 0:
        z = torch.zeros(0, dtype=torch.int32, device=flat.device)
        return z, z, z
    pos, f, base, flen = _lane_fragments(frag_off, P)
    j = pos - base
    c32 = flat.to(torch.int32)
    valid = (j >= j0) & (j < flen)
    kid = torch.zeros(P, dtype=torch.int32, device=flat.device)
    for t in range(K):
        kid += (c32[torch.clamp(pos - t, min=0).long()] - 1) * NLET**t
    kid = torch.clamp(torch.where(valid, kid, 0), 0, seed_d.shape[0] - 1).long()
    d = torch.where(valid, seed_d[kid].to(torch.int32), 0)
    i = torch.where(valid, torch.where(d > 0, j - d + 1, j), j + 1)
    s0 = torch.where(valid, seed_s0[kid], 0)
    s1 = torch.where(valid, seed_s1[kid], 0)
    live = torch.nonzero(valid & (d == K) & (i > 0)).squeeze(1)
    while live.numel():
        li, a0, a1 = i[live], s0[live], s1[live]
        c = c32[(base[live] + li - 1).long()]
        n0 = rank(rec, C, c, a0, touched)
        n1 = rank(rec, C, c, a1, touched)
        ok = n0 < n1
        live = live[ok]
        s0[live] = n0[ok]
        s1[live] = n1[ok]
        i[live] = li[ok] - 1
        live = live[i[live] > 0]
    return i, s0, s1


def mem_extend(rec, C, seed_s0, seed_s1, seed_d, flat, frag_off, K, j0):
    """Maximal backward extension (i, s0, s1), int32 [P] each, of every
    flat position (see csrc/mem_extend.cu for the contract).  Kernel B for
    CUDA tensors, the plain version for CPU tensors."""
    if K < 1 or j0 < K - 1:
        raise ValueError(f"need K >= 1 and j0 >= K - 1 (K={K}, j0={j0})")
    if flat.device.type == "cpu":
        return mem_extend_plain(rec, C, seed_s0, seed_s1, seed_d, flat,
                                frag_off, K, j0)
    dev = flat.device
    kernels.check(rec, "rec", torch.int32, dev, 2)
    kernels.check(C, "C", torch.int32, dev, 1)
    kernels.check(seed_s0, "seed_s0", torch.int32, dev, 1)
    kernels.check(seed_s1, "seed_s1", torch.int32, dev, 1)
    kernels.check(seed_d, "seed_d", torch.int8, dev, 1)
    kernels.check(flat, "flat", torch.uint8, dev, 1)
    kernels.check(frag_off, "frag_off", torch.int32, dev, 1)
    if not seed_s0.shape == seed_s1.shape == seed_d.shape == (NLET**K,):
        raise ValueError(f"seed tables must hold {NLET}^{K} rows")
    P, F = flat.shape[0], frag_off.shape[0] - 1
    if P and F < 1:
        raise ValueError("flat codes without a fragment to own them")
    out = torch.empty((3, P), dtype=torch.int32, device=dev)
    if P:
        kernels.launch("mem_extend", rec, rec.shape[0], C, seed_s0, seed_s1,
                       seed_d, seed_d.shape[0], flat, P, frag_off, F, K, j0,
                       out[0], out[1], out[2])
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# kernel C
# ---------------------------------------------------------------------------


def mem_stats_plain(i, s0, s1, frag_off, min_len, T):
    F = frag_off.shape[0] - 1
    dev = i.device
    if F == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z, z.view(0, T), z.view(0, T), z.view(0, T)
    P = i.shape[0]
    pos, f, base, flen = _lane_fragments(frag_off, P)
    j = pos - base
    valid = (j >= 0) & (j < flen)
    fl = f.long()
    length = j - i + 1
    stop = valid & (i <= 1)
    jstop = torch.full((F,), -1, dtype=torch.int32, device=dev)
    jstop.scatter_reduce_(0, fl[stop], j[stop], "amax")
    elig = valid & (j >= jstop[fl]) & (length >= min_len)
    maxl = torch.zeros(F, dtype=torch.int32, device=dev)
    maxl.scatter_reduce_(0, fl[elig], length[elig], "amax")
    tie = elig & (length == maxl[fl]) & (maxl[fl] > 0)
    tie_cnt = torch.bincount(fl[tie], minlength=F).to(torch.int32)
    # lanes ascend in (f, j): a tie's rank is its place among its
    # fragment's ties
    tl = torch.nonzero(tie).squeeze(1)
    tf = fl[tl]
    first = torch.cumsum(tie_cnt, 0, dtype=torch.int64) - tie_cnt
    r = torch.arange(tl.shape[0], device=dev) - first[tf]
    keep = r < T
    tl, tf, r = tl[keep], tf[keep], r[keep]
    tie_j = torch.full((F, T), -1, dtype=torch.int32, device=dev)
    tie_s0 = torch.zeros((F, T), dtype=torch.int32, device=dev)
    tie_s1 = torch.zeros((F, T), dtype=torch.int32, device=dev)
    tie_j[tf, r] = j[tl]
    tie_s0[tf, r] = s0[tl]
    tie_s1[tf, r] = s1[tl]
    return maxl, tie_cnt, tie_j, tie_s0, tie_s1


def mem_stats(i, s0, s1, frag_off, min_len, T):
    """Per-fragment greedyExact statistics (maxl, tie_cnt [F]; tie_j,
    tie_s0, tie_s1 [F, T]) from B's lanes.  Kernel C for CUDA tensors, the
    plain version for CPU tensors."""
    if i.device.type == "cpu":
        return mem_stats_plain(i, s0, s1, frag_off, min_len, T)
    dev = i.device
    P = i.shape[0]
    for t, what in ((i, "i"), (s0, "s0"), (s1, "s1")):
        kernels.check(t, what, torch.int32, dev, 1)
        if t.shape[0] != P:
            raise ValueError(f"{what}: {t.shape[0]} lanes, expected {P}")
    kernels.check(frag_off, "frag_off", torch.int32, dev, 1)
    F = frag_off.shape[0] - 1
    maxl = torch.empty(F, dtype=torch.int32, device=dev)
    tie_cnt = torch.empty(F, dtype=torch.int32, device=dev)
    ties = torch.empty((3, F, T), dtype=torch.int32, device=dev)
    if F > 0:
        kernels.launch("mem_stats", i, s0, s1, frag_off, F, min_len, T,
                       maxl, tie_cnt, ties[0], ties[1], ties[2])
    return maxl, tie_cnt, ties[0], ties[1], ties[2]
