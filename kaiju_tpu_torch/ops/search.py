"""MEM search: kernel B (``mem_extend``) and kernel C (``mem_stats``),
and the Greedy engine's level-0 map from B's lanes, kernel K
(``greedy_map``).

Together they compute what ``kaiju_tpu.ops.fused_mem2`` computes for MEM
(``_search_phases`` + ``_staged_extend`` + ``_mem_stats``): for a batch of
fragments laid out flat (codes ``flat`` uint8 [P], offsets ``frag_off``
int32 [F+1], monotone), the per-fragment greedyExact statistics (maxl,
tie_cnt, tie_j[T], tie_s0[T], tie_s1[T]).

B evaluates every usable lane (fragment, end j >= j0) to its maximal
backward extension: seed from the K-mer tables, then FM steps.  With a
Bloom bitmap (``ops/bloom.py``, on an index with a text copy) it first
drops the lanes whose trailing m-mer is absent from the database; they
return the length-0 result of a lane not evaluated.  The JAX program
evaluates a subset too (a Bloom-screened strip, then the unresolved
remainder) and proves the statistics equal on any superset of the lanes
with a match of length >= m (fused_mem2.py:23-31); C reads every lane, so
the statistics are the same with or without the screen.  With the
text-compare hybrid B stops its narrow lanes after the seed and
S1_STEPS steps, and kernel G (``ops/hybrid.py``) finishes them.  B's
results are in flat layout: lane p is position j = p - frag_off[f] of the
fragment f that owns p.
"""

from __future__ import annotations

import threading

import torch

from .. import kernels
from .bloom import probe_plain
from .device_index import Q_RANK, Shards, rank, shard_args

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


SW_WCAP = 8  # the hybrid switches intervals of at most this many occurrences


def _seed_lanes(seed_s0, seed_s1, seed_d, flat, frag_off, K, j0, bloom):
    """B's pass 1 on every flat position: (i, s0, s1) after the screen and
    the seed, the lanes that go on stepping (int64, ascending) and each
    position's fragment start."""
    P = flat.shape[0]
    pos, f, base, flen = _lane_fragments(frag_off, P)
    j = pos - base
    c32 = flat.to(torch.int32)
    valid = (j >= j0) & (j < flen)
    if bloom is not None:
        valid &= probe_plain(flat, pos, valid, *bloom)
    kid = torch.zeros(P, dtype=torch.int32, device=flat.device)
    for t in range(K):
        kid += (c32[torch.clamp(pos - t, min=0).long()] - 1) * NLET**t
    kid = torch.clamp(torch.where(valid, kid, 0), 0, seed_d.shape[0] - 1).long()
    d = torch.where(valid, seed_d[kid].to(torch.int32), 0)
    i = torch.where(valid, torch.where(d > 0, j - d + 1, j), j + 1)
    s0 = torch.where(valid, seed_s0[kid], 0)
    s1 = torch.where(valid, seed_s1[kid], 0)
    live = torch.nonzero(valid & (d == K) & (i > 0)).squeeze(1)
    return i, s0, s1, live, base


def mem_extend_plain(rec, C, seed_s0, seed_s1, seed_d, flat, frag_off, K, j0,
                     touched=None, bloom=None, sw_steps=0):
    """touched: None, or a list that receives the record rows read."""
    P = flat.shape[0]
    if P == 0:
        z = torch.zeros(0, dtype=torch.int32, device=flat.device)
        return z, z, z
    i, s0, s1, live, base = _seed_lanes(seed_s0, seed_s1, seed_d, flat,
                                        frag_off, K, j0, bloom)
    c32 = flat.to(torch.int32)
    steps = 0
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
        steps += 1
        if steps == sw_steps:  # the hybrid's narrow lanes stop here
            live = live[s1[live] - s0[live] > SW_WCAP]
    return i, s0, s1


def mem_extend(rec, C, seed_s0, seed_s1, seed_d, flat, frag_off, K, j0,
               bloom=None, sw_steps=0):
    """Maximal backward extension (i, s0, s1), int32 [P] each, of every
    flat position (see csrc/mem_extend.cu for the contract).  bloom: None,
    or the screen (words int32 [2^(lb-5)], m, lb) with m <= j0 + 1;
    sw_steps: 0, or the steps after which the hybrid's narrow lanes stop.
    Kernel B for CUDA tensors (its sharded instantiation for a ``Shards``
    rec), the plain version for CPU tensors."""
    if K < 1 or j0 < K - 1:
        raise ValueError(f"need K >= 1 and j0 >= K - 1 (K={K}, j0={j0})")
    if bloom is not None and not 1 <= bloom[1] <= j0 + 1:
        raise ValueError(f"need 1 <= m <= j0 + 1 (m={bloom[1]}, j0={j0})")
    if sw_steps < 0:
        raise ValueError(f"sw_steps must be >= 0, got {sw_steps}")
    if flat.device.type == "cpu":
        return mem_extend_plain(rec, C, seed_s0, seed_s1, seed_d, flat,
                                frag_off, K, j0, bloom=bloom,
                                sw_steps=sw_steps)
    dev = flat.device
    sharded = isinstance(rec, Shards)
    idx_args = (shard_args(dev, rec) if sharded else (rec, rec.shape[0]))
    if not sharded:
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
    words, m, lb = bloom if bloom is not None else (None, 0, 0)
    if words is not None:
        kernels.check(words, "bloom words", torch.int32, dev, 1)
        if words.shape[0] != 1 << (lb - 5):
            raise ValueError(f"bloom words: {words.shape[0]}, expected "
                             f"2^{lb - 5}")
    out = torch.empty((3, P), dtype=torch.int32, device=dev)
    if P:
        kernels.launch("mem_extend_sharded" if sharded else "mem_extend",
                       *idx_args, C, seed_s0, seed_s1, seed_d,
                       seed_d.shape[0], flat, P, frag_off, F, K, j0, words,
                       m, lb, sw_steps, out[0], out[1], out[2])
        if words is not None:
            kernels.SCREENED["mem_extend"] += 1
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# kernel O: B over the shards of a group on several hosts
# ---------------------------------------------------------------------------


def _park_rows(rec, C, flat, lanes, out, i, s0, s1, q, touched, K=0,
               sw_steps=0):
    """Step the lanes (int64 flat positions) from (i, s0, s1), q (int64)
    the flat index of the code before i, while both rows of a step lie on
    this host (``Shards.here``); a lane whose rows do not parks.  With
    sw_steps, a lane stops where B stops it for the hybrid: after
    sw_steps steps (p - K - q of them taken) with at most SW_WCAP
    occurrences.  Writes out (int32 [3, P]) for every lane that ends or
    parks and returns the parked (p, i, s0, s1, q) int32 [L, 5] and their
    rank-pair queries int32 [L, 2, 2]."""
    c32 = flat.to(torch.int32)
    parked, queries = [], []
    while lanes.numel():
        if sw_steps:
            sw = (lanes - K - q == sw_steps) & (s1 - s0 <= SW_WCAP)
            out[:, lanes[sw]] = torch.stack([i, s0, s1])[:, sw]
            keep = ~sw
            lanes, i, s0, s1, q = (lanes[keep], i[keep], s0[keep], s1[keep],
                                   q[keep])
            if not lanes.numel():
                break
        c = c32[q]
        here = rec.here[rec.owner(s0 >> 7)] & rec.here[rec.owner(s1 >> 7)]
        stop = ~here
        parked.append(torch.stack([lanes[stop].to(torch.int32), i[stop],
                                   s0[stop], s1[stop],
                                   q[stop].to(torch.int32)], 1))
        op = (Q_RANK << 8) | c[stop]
        queries.append(torch.stack([op, s0[stop], op, s1[stop]], 1))
        go = torch.nonzero(here).squeeze(1)
        n0 = rank(rec, C, c[go], s0[go], touched)
        n1 = rank(rec, C, c[go], s1[go], touched)
        ok = n0 < n1
        step = go[ok]
        s0[step], s1[step] = n0[ok], n1[ok]
        i[step] -= 1
        q[step] -= 1
        ended = stop | (i == 0)
        ended[go[~ok]] = True
        out[:, lanes[ended]] = torch.stack([i, s0, s1])[:, ended]
        keep = ~ended
        lanes, i, s0, s1, q = lanes[keep], i[keep], s0[keep], s1[keep], q[keep]
    z = torch.zeros((0, 5), dtype=torch.int32, device=flat.device)
    return (torch.cat(parked) if parked else z,
            (torch.cat(queries) if queries else z[:, :4]).view(-1, 2, 2))


def mem_extend_hosts_plain(rec, C, seed_s0, seed_s1, seed_d, flat, frag_off,
                           K, j0, bloom=None, out=None, parked=None,
                           answers=None, touched=None, sw_steps=0):
    """touched: as for mem_extend_plain."""
    P = flat.shape[0]
    dev = flat.device
    if parked is None:
        if P == 0:
            out = torch.zeros((3, 0), dtype=torch.int32, device=dev)
            lanes = torch.zeros(0, dtype=torch.int64, device=dev)
            i = s0 = s1 = base = lanes.to(torch.int32)
        else:
            i, s0, s1, lanes, base = _seed_lanes(seed_s0, seed_s1, seed_d,
                                                 flat, frag_off, K, j0, bloom)
            out = torch.stack([i, s0, s1])
        i, s0, s1 = i[lanes], s0[lanes], s1[lanes]
        q = (base[lanes] + i - 1).long()
    else:  # a parked lane carries its q: the code of its pending step
        lanes = parked[:, 0].long()
        i, s0, s1 = (parked[:, t].clone() for t in (1, 2, 3))
        n0, n1 = answers[:, 0], answers[:, 1]
        ok = n0 < n1  # the step B would take, else the lane ends
        s0[ok], s1[ok] = n0[ok], n1[ok]
        i[ok] -= 1
        ended = ~ok | (i == 0)
        out[:, lanes[ended]] = torch.stack([i, s0, s1])[:, ended]
        keep = ~ended
        lanes, i, s0, s1 = lanes[keep], i[keep], s0[keep], s1[keep]
        q = parked[keep, 4].long() - 1
    parked, queries = _park_rows(rec, C, flat, lanes, out, i, s0, s1, q,
                                 touched, K, sw_steps)
    return out, parked, queries


def mem_extend_hosts(rec, C, seed_s0, seed_s1, seed_d, flat, frag_off, K,
                     j0, bloom=None, out=None, parked=None, answers=None,
                     sw_steps=0):
    """B over a group of processes on several hosts (see
    csrc/mem_extend.cu, kernel O); sw_steps: 0, or B's hybrid stop after
    that many steps (kernel Y finishes the lanes it stops, as G does on
    one host).  The start form (parked None) evaluates
    every flat position as B does and returns (out int32 [3, P] = (i, s0,
    s1), parked int32 [L, 5] = (p, i, s0, s1, q), q the flat index of the
    code of the lane's next step, queries int32 [L, 2, 2], that step's
    rank pair, (Q_RANK c, s0) and (Q_RANK c, s1)); the resume form takes
    out, the parked lanes and their answers int32 [L, 2] and returns the
    same three, out updated in place.  The parked records stay in the
    process; only the queries go to the owners.  A parked lane's out row
    holds its state when it parked.  Once no lane is parked, out equals
    B's (i, s0, s1) with the same sw_steps.  Kernel O for CUDA tensors
    (the resume form reads no frag_off), the plain version for CPU
    tensors."""
    if K < 1 or j0 < K - 1:
        raise ValueError(f"need K >= 1 and j0 >= K - 1 (K={K}, j0={j0})")
    if sw_steps < 0:
        raise ValueError(f"sw_steps must be >= 0, got {sw_steps}")
    if bloom is not None and not 1 <= bloom[1] <= j0 + 1:
        raise ValueError(f"need 1 <= m <= j0 + 1 (m={bloom[1]}, j0={j0})")
    if (parked is None) != (answers is None) or (parked is None) != (
            out is None):
        raise ValueError("out, parked and answers come together (resume)")
    if flat.device.type == "cpu":
        return mem_extend_hosts_plain(rec, C, seed_s0, seed_s1, seed_d, flat,
                                      frag_off, K, j0, bloom, out, parked,
                                      answers, sw_steps=sw_steps)
    dev = flat.device
    args = shard_args(dev, rec, hosts=True)
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
    words, m, lb = bloom if bloom is not None else (None, 0, 0)
    if words is not None:
        kernels.check(words, "bloom words", torch.int32, dev, 1)
        if words.shape[0] != 1 << (lb - 5):
            raise ValueError(f"bloom words: {words.shape[0]}, expected "
                             f"2^{lb - 5}")
    if parked is None:
        out = torch.empty((3, P), dtype=torch.int32, device=dev)
        n = P
    else:
        kernels.check(out, "out", torch.int32, dev, 2)
        kernels.check(parked, "parked", torch.int32, dev, 2)
        kernels.check(answers, "answers", torch.int32, dev, 2)
        if out.shape != (3, P) or parked.shape[1] != 5 or \
                answers.shape != (parked.shape[0], 2):
            raise ValueError("out [3, P], parked [L, 5], answers [L, 2] "
                             "expected")
        n = parked.shape[0]
    park = torch.empty((n, 5), dtype=torch.int32, device=dev)
    q = torch.empty((n, 2, 2), dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    if n:
        kernels.launch("mem_extend_hosts", *args, C, seed_s0, seed_s1, seed_d,
                       seed_d.shape[0], flat, P, frag_off, F, K, j0, words, m,
                       lb, sw_steps, parked, answers,
                       0 if parked is None else n,
                       out[0], out[1], out[2], park, q, count)
    k = int(count)
    return out, park[:k], q[:k]


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


def mem_search(rec, C, seed, flat, frag_off, K, j0, min_len, T, bloom=None):
    """kaiju_tpu's fused_mem_search2 without the hybrid, B -> C: the
    per-fragment (maxl, tie_cnt, tie_j, tie_s0, tie_s1) of the fragments in
    flat/frag_off, seed = (seed_s0, seed_s1, seed_d).  B evaluates every
    lane, so there is no capacity to retry."""
    lanes = mem_extend(rec, C, *seed, flat, frag_off, K, j0, bloom=bloom)
    return mem_stats(*lanes, frag_off, min_len, T)


# ---------------------------------------------------------------------------
# kernel K
# ---------------------------------------------------------------------------


def greedy_map_plain(i, s0, s1, frag_off, lmap):
    F = frag_off.shape[0] - 1
    dev = i.device
    P = i.shape[0]
    if F == 0 or P == 0:
        return (torch.zeros((0, 5), dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))
    pos, f, base, flen = _lane_fragments(frag_off, P)
    j = pos - base
    valid = (j >= 0) & (j < flen)
    fl = f.long()
    stop = valid & (i <= 1)
    jstop = torch.full((F,), -1, dtype=torch.int32, device=dev)
    jstop.scatter_reduce_(0, fl[stop], j[stop], "amax")
    emit = torch.nonzero(valid & (j >= jstop[fl]) & (j - i + 1 >= lmap))
    emit = emit.squeeze(1)
    rows = torch.stack([f[emit], j[emit], i[emit], s0[emit], s1[emit]], 1)
    n = torch.tensor([rows.shape[0]], dtype=torch.int32, device=dev)
    return rows.to(torch.int32), n


# kernel K's look-back status words, one buffer a (device, stream), kept
# with the epoch of its last launch; zeroed when allocated, never before a
# launch (csrc/greedy_map.cu)
_K_STATE: dict = {}
_K_LOCK = threading.Lock()
_K_EPOCHS = (1 << 31) - 1  # the status word's epoch field, 0 unused
_K_BLOCK_FRAGS = 32  # fragments a block of K (256 threads, 8 a fragment)


def _k_state(dev, F):
    """(the status buffer, this launch's epoch) of kernel K on dev's
    current stream, for F fragments."""
    blocks = -(-F // _K_BLOCK_FRAGS)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    with _K_LOCK:
        buf, epoch = _K_STATE.get(key, (None, 0))
        if buf is None or buf.shape[0] < blocks or epoch == _K_EPOCHS:
            buf = torch.zeros(max(2 * blocks, 4096), dtype=torch.int64,
                              device=dev)
            epoch = 0
        _K_STATE[key] = (buf, epoch + 1)
    return buf, epoch + 1


def greedy_map(i, s0, s1, frag_off, lmap):
    """The level-0 candidate map of the Greedy engine from B's lanes: a
    row (f, j, i, s0, s1) for every lane of fragment f with j >= jstop(f)
    and j - i + 1 >= lmap (see csrc/greedy_map.cu).  Returns (rows, n):
    rows int32 [>= n, 5], of which the first n (n: int32 [1], on the
    device, so the call does not wait for the card) are the rows, in
    ascending (f, j), the plain version's order too.  Kernel K for CUDA
    tensors, one launch that also writes n; the plain version for CPU
    tensors."""
    if lmap < 1:
        raise ValueError(f"lmap must be >= 1, got {lmap}")
    if i.device.type == "cpu":
        return greedy_map_plain(i, s0, s1, frag_off, lmap)
    dev = i.device
    P = i.shape[0]
    for t, what in ((i, "i"), (s0, "s0"), (s1, "s1")):
        kernels.check(t, what, torch.int32, dev, 1)
        if t.shape[0] != P:
            raise ValueError(f"{what}: {t.shape[0]} lanes, expected {P}")
    kernels.check(frag_off, "frag_off", torch.int32, dev, 1)
    F = frag_off.shape[0] - 1
    rows = torch.empty((P, 5), dtype=torch.int32, device=dev)
    if F == 0 or P == 0:
        return rows, torch.zeros(1, dtype=torch.int32, device=dev)
    n = torch.empty(1, dtype=torch.int32, device=dev)
    state, epoch = _k_state(dev, F)
    kernels.launch("greedy_map", i, s0, s1, frag_off, F, lmap, rows, n,
                   state, state.shape[0], epoch)
    return rows, n
