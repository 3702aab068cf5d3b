"""Kernels L (``big_extend_all``) and M (``big_sa_walk``): the int64 MEM
step over an index of more than 2^31 letters (K17,
scripts/big_classify_demo.py:make_mesh_mem_step, :253-420), and their
plain PyTorch versions.

The index is a ``parallel.big_index.BigIndex``: S shards of int32 rank
records with local occ, int64 ``C`` and ``base`` (the counts of the
shards before each), SA samples by shard.  Positions, intervals and ids
are int64:

    FMindex(c, k) = C[c] + base[o, c] + occ_local[o][b - o nb_s, c]
                    + #c in block b before k & 127,
    b = k >> 7, o = min(b // nb_s, S - 1)

where the JAX program assembles the owner's count with a psum over its
mesh and steps every lane in lockstep, each lane here reads its owner's
row and runs on its own; the arrays are the same, lane for lane.  The
plain versions follow the JAX program's semantics (with the shard's end
row at k = 128 S nb_s, where the JAX rank clips); a wrapper takes them
only for CPU tensors, and chip_smoke.py holds the kernels against them.
"""

from __future__ import annotations

import torch

from .. import kernels


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _rows(ix, b, touched=None):
    """(owner int64, record rows int32 [n, 64]) of the blocks b int64 [n];
    touched: None, or a list that receives the blocks read."""
    if touched is not None:
        touched.append(b)
    owner = torch.clamp(b // ix.nb_s, max=ix.S - 1)
    return owner, ix.rec[b]


def _count_below(rows, c, off):
    """#c among the first off bytes of each row's 128 BWT bytes."""
    bytes_ = rows[:, 32:].contiguous().view(torch.uint8)
    lanes = torch.arange(128, device=rows.device)
    hit = (bytes_ == c.to(torch.uint8)[:, None]) & (lanes < off[:, None])
    return hit.sum(1)


def _rank_on(ix, owner, rows, c, k):
    cl = c.long()
    local = rows.gather(1, cl[:, None])[:, 0].long()
    return ix.C[cl] + ix.base[owner, cl] + local + _count_below(rows, c,
                                                                k & 127)


def big_rank_plain(ix, c, k, touched=None):
    """FMindex(c, k) int64 [n] for letters c and positions k int64 [n]."""
    owner, rows = _rows(ix, k >> 7, touched)
    return _rank_on(ix, owner, rows, c, k)


def big_extend_all_plain(ix, codes, touched=None):
    """touched: as for _rows."""
    R, L = codes.shape
    dev = codes.device
    flat = codes.reshape(-1).long()
    lane = torch.arange(R * L, device=dev)
    j = lane % L
    valid = flat > 0
    c0 = torch.where(valid, flat, 1)
    s0, s1, i = ix.C[c0].clone(), ix.C[c0 + 1].clone(), j.clone()
    live = torch.nonzero(valid & (j > 0)).squeeze(1)
    while live.numel():
        x = i[live] - 1
        c = flat[live - j[live] + x]
        go = c > 0
        live, x, c = live[go], x[go], c[go]
        n0 = big_rank_plain(ix, c, s0[live], touched)
        n1 = big_rank_plain(ix, c, s1[live], touched)
        ok = n0 < n1
        live = live[ok]
        s0[live], s1[live], i[live] = n0[ok], n1[ok], x[ok]
        live = live[i[live] > 0]
    return (i.to(torch.int32).view(R, L), s0.view(R, L), s1.view(R, L))


def big_sa_walk_plain(ix, kf, touched=None, slots=None):
    """touched: as for _rows; each LF step reads one row.  slots: None,
    or a list that receives the sample slots read."""
    check = (1 << ix.e) - 1
    last = ix.S * ix.ns_s - 1
    ids = torch.full_like(kf, -1)
    k = kf.clone()
    todo = torch.nonzero(kf >= 0).squeeze(1)
    while todo.numel():
        kk = k[todo]
        at = (kk >= ix.first) & (((kk - ix.first) & check) == 0)
        slot = torch.clamp((kk[at] - ix.first) >> ix.e, 0, last)
        if slots is not None:
            slots.append(slot)
        ids[todo[at]] = ix.sa_seq[slot].long()
        todo, kk = todo[~at], kk[~at]
        owner, rows = _rows(ix, kk >> 7, touched)
        off = kk & 127
        bytes_ = rows[:, 32:].contiguous().view(torch.uint8)
        c = bytes_.gather(1, off[:, None])[:, 0].long()
        kn = _rank_on(ix, owner, rows, c, kk)
        term = c == 0
        ids[todo[term]] = kn[term]
        todo = todo[~term]
        k[todo] = kn[~term]
    return ids


# ---------------------------------------------------------------------------
# kernels L and M
# ---------------------------------------------------------------------------


def _index_args(ix, dev):
    ix.check(dev)
    return ix.rec.table, ix.nb_s, ix.S, ix.C, ix.base, ix.alen


def big_extend_all(ix, codes):
    """The maximal backward extension of every lane (r, j) of read codes
    uint8 [R, L] (letters 1..alen-1, 0 where a read has none): (i int32,
    s0 int64, s1 int64) [R, L], the match [i, j] and its SA interval
    [s0, s1).  A lane on code 0 gives (j, C[1], C[2]); extension stops at
    a code 0.  Kernel L (csrc/big_mem.cu) for CUDA tensors, the plain
    version for CPU tensors."""
    if codes.device.type == "cpu":
        return big_extend_all_plain(ix, codes)
    dev = codes.device
    kernels.check(codes, "codes", torch.uint8, dev, 2)
    R, L = codes.shape
    i = torch.empty((R, L), dtype=torch.int32, device=dev)
    s = torch.empty((2, R, L), dtype=torch.int64, device=dev)
    args = _index_args(ix, dev)
    if R * L:
        kernels.launch("big_extend_all", *args, codes, R, L, i, s[0], s[1])
    return i, s[0], s[1]


def big_sa_walk(ix, kf):
    """The content-rank sequence id int64 [n] of each SA row kf int64 [n]
    (-1 where kf < 0): an LF walk to a sampled row or a terminator.
    Kernel M (csrc/big_mem.cu: one walk for each run of equal kf) for
    CUDA tensors, the plain version for CPU tensors."""
    if kf.device.type == "cpu":
        return big_sa_walk_plain(ix, kf)
    dev = kf.device
    kernels.check(kf, "kf", torch.int64, dev, 1)
    n = kf.shape[0]
    ids = torch.empty(n, dtype=torch.int64, device=dev)
    args = _index_args(ix, dev)
    if n:
        # the kernel's list of the runs of equal kf: two counters, then
        # (kf, lane << 6 | run length) a run
        scratch = torch.empty(2 + 2 * n, dtype=torch.int64, device=dev)
        kernels.launch("big_sa_walk", *args, ix.sa_seq.table, ix.ns_s,
                       ix.first, ix.e, kf, n, ids, scratch)
    return ids


def big_mem_step(ix, codes):
    """make_mesh_mem_step on one device: L on the whole [R, L] batch, then
    M on the first row of every non-empty interval.  Returns (i int32,
    s0, s1, ids int64) [R, L].  Raises for a code of alen or more."""
    if codes.numel() and int(codes.max()) >= ix.alen:
        raise ValueError(f"codes: letters 0..{ix.alen - 1} expected")
    i, s0, s1 = big_extend_all(ix, codes)
    kf = torch.where(s1 > s0, s0, -1).reshape(-1)
    return i, s0, s1, big_sa_walk(ix, kf).view(codes.shape)
