"""MEM classification of a batch of reads: kernel D (``read_lca``) and
``fused_mem_classify``, which runs B -> C -> D.

``fused_mem_classify`` returns what rows 0..B-1 of
``kaiju_tpu.ops.fused_classify.fused_mem_classify`` hold: (lca, score,
flags, n_ids) per read, with the reference's semantics for the SA walks
(bwt.c:105-121), the capped id set (ConsumerThread.cpp:799-845) and the
LCA (util.cpp:194-263).  Reads flagged FLAG_TIE_OVER or FLAG_NEED_MORE
exceeded a device budget and are replayed on the host.  The JAX program's
last row (lane-capacity counters for its retry) has no counterpart: the
kernels have no lane capacities.
"""

from __future__ import annotations

import torch

from .. import kernels
from .device_index import sa_walk
from .search import mem_extend, mem_stats

FLAG_TIE_OVER = 1  # a contributing fragment had more ties than T
FLAG_NEED_MORE = 2  # position budget R exhausted before the id cap
MAX_R = 1024  # positions a read: kernel D keeps them in shared memory


def read_lca_plain(maxl, tie_cnt, tie_s0, tie_s1, rf_rows, rec, C, sa_seq,
                   sa_off, seq_tax, parent, depth, R, cap, nseq, chpt_exp,
                   touched=None):
    """touched: None, or a list that receives the record rows read."""
    dev = maxl.device
    F, T = tie_s0.shape
    B, S = rf_rows.shape
    i32 = torch.int32
    if B == 0:
        return torch.zeros((0, 4), dtype=i32, device=dev)
    # ---- the read's longest over its slots, and the contributing ties --
    rf = torch.where(rf_rows >= 0, rf_rows, F).long()
    zero = torch.zeros(1, dtype=i32, device=dev)
    slot_maxl = torch.cat([maxl, zero])[rf]
    longest = slot_maxl.max(1).values
    contrib = (rf_rows >= 0) & (slot_maxl == longest[:, None]) & (
        longest[:, None] > 0)
    tie_over = (contrib & (torch.cat([tie_cnt, zero])[rf] > T)).any(1)
    zrow = torch.zeros((1, T), dtype=i32, device=dev)
    t_s0 = torch.cat([tie_s0, zrow])[rf].reshape(B, S * T)
    t_s1 = torch.cat([tie_s1, zrow])[rf].reshape(B, S * T)
    sizes = torch.where(contrib.repeat_interleave(T, dim=1), t_s1 - t_s0, 0)
    csum = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev),
                      torch.cumsum(sizes, 1, dtype=i32)], 1)
    total = csum[:, -1]

    # ---- the first R positions: position r lies in the last range whose
    # start is <= r -------------------------------------------------------
    rr = torch.arange(R, dtype=i32, device=dev)
    seg = (csum[:, None, :] <= rr[None, :, None]).sum(2) - 1
    seg = torch.clamp(seg, 0, S * T - 1)
    valid = rr[None, :] < torch.clamp(total, max=R)[:, None]
    k = t_s0.gather(1, seg) + rr[None, :] - csum.gather(1, seg)
    iseq, _pos = sa_walk(rec, C, sa_seq, sa_off, nseq, chpt_exp, k[valid],
                         touched)
    tax = torch.full((B, R), -1, dtype=i32, device=dev)
    tax[valid] = seq_tax[torch.clamp(iseq, 0, seq_tax.shape[0] - 1).long()]

    # ---- capped unique-id set ------------------------------------------
    eq = (tax[:, :, None] == tax[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    earlier = rr[None, :] < rr[:, None]  # [r, q]: q before r
    uniq = valid & ~(eq & earlier[None]).any(2)
    prior = torch.cumsum(uniq, 1, dtype=i32) - uniq.to(i32)
    included = uniq & (prior <= cap)
    n_ids = included.sum(1, dtype=i32)
    need_more = (total > R) & (uniq.sum(1, dtype=i32) <= cap)

    # ---- LCA: drop taxa outside the tree, lift to the shallowest, then
    # climb in lock step ----------------------------------------------
    maxtax = parent.shape[0]
    taxc = torch.clamp(tax, 0, maxtax - 1).long()
    dep = depth[taxc]
    present = included & (tax >= 0) & (tax < maxtax) & (dep > 0)
    dmin = torch.where(present, dep, 1 << 30).min(1).values
    ids = torch.where(present, taxc, 0)
    lift = torch.where(present, dep - dmin[:, None], 0)
    while bool((lift > 0).any()):
        up = lift > 0
        ids = torch.where(up, parent[ids].long(), ids)
        lift = lift - up.to(i32)
    # absent slots take the first present taxon so they never block the
    # climb
    first = ids.gather(1, present.to(i32).argmax(1, keepdim=True))
    ids = torch.where(present, ids, first)
    for _ in range(int(torch.where(present.any(1), dmin, 0).max())):
        same = (ids == ids[:, :1]).all(1)
        if bool(same.all()):
            break
        ids = torch.where(same[:, None], ids, parent[ids].long())
    lca = torch.where(present.any(1), ids[:, 0].to(i32), 0)
    first_uid = tax.gather(1, included.to(i32).argmax(1, keepdim=True))[:, 0]
    lca = torch.where(n_ids == 1, first_uid, lca)
    lca = torch.where((n_ids > 0) & (longest > 0), lca, 0)
    flags = tie_over.to(i32) * FLAG_TIE_OVER + need_more.to(i32) * FLAG_NEED_MORE
    return torch.stack([lca, longest, flags, n_ids], 1).to(i32)


def read_lca(maxl, tie_cnt, tie_s0, tie_s1, rf_rows, rec, C, sa_seq, sa_off,
             seq_tax, parent, depth, R, cap, nseq, chpt_exp):
    """(lca, score, flags, n_ids) int32 [B, 4] per read from the
    per-fragment statistics (maxl, tie_cnt [F]; tie_s0, tie_s1 [F, T]) and
    the pop-order slot table rf_rows int32 [B, S] (-1 = pad).  Kernel D
    for CUDA tensors, the plain version for CPU tensors."""
    if maxl.device.type == "cpu":
        return read_lca_plain(maxl, tie_cnt, tie_s0, tie_s1, rf_rows, rec, C,
                              sa_seq, sa_off, seq_tax, parent, depth, R, cap,
                              nseq, chpt_exp)
    dev = maxl.device
    F, T = tie_s0.shape
    for t, what, nd in ((maxl, "maxl", 1), (tie_cnt, "tie_cnt", 1),
                        (tie_s0, "tie_s0", 2), (tie_s1, "tie_s1", 2),
                        (rf_rows, "rf_rows", 2), (rec, "rec", 2), (C, "C", 1),
                        (sa_seq, "sa_seq", 1), (seq_tax, "seq_tax", 1),
                        (parent, "parent", 1), (depth, "depth", 1)):
        kernels.check(t, what, torch.int32, dev, nd)
    if maxl.shape[0] != F or tie_cnt.shape[0] != F or tie_s1.shape != (F, T):
        raise ValueError("maxl, tie_cnt, tie_s0 and tie_s1 disagree on F or T")
    if parent.shape != depth.shape:
        raise ValueError("parent and depth differ in size")
    if not 0 < R <= MAX_R:
        raise ValueError(f"R must lie in 1..{MAX_R}, got {R}")
    B, S = rf_rows.shape
    out = torch.empty((B, 4), dtype=torch.int32, device=dev)
    if B:
        kernels.launch("read_lca", maxl, tie_cnt, tie_s0, tie_s1, T,
                       rf_rows, B, S, rec, rec.shape[0], C, sa_seq,
                       sa_seq.shape[0], seq_tax, seq_tax.shape[0], parent,
                       depth, parent.shape[0], R, cap, nseq, chpt_exp, out)
    return out


def fused_mem_classify(rec, C, seed, flat, frag_off, rf_rows, sa_seq, sa_off,
                       seq_tax, parent, depth, K, j0, min_len, T, R, cap,
                       nseq, chpt_exp):
    """The whole MEM batch, B -> C -> D: flat uint8 [P] fragment codes,
    frag_off int32 [F+1], rf_rows int32 [B, S] fragment row per (read,
    pop-order slot), seed = (s0, s1, d) K-mer tables.  Returns int32
    [B, 4] rows (lca, score, flags, n_ids)."""
    i, s0, s1 = mem_extend(rec, C, *seed, flat, frag_off, K, j0)
    stats = mem_stats(i, s0, s1, frag_off, min_len, T)
    return read_lca(*stats[:2], *stats[3:], rf_rows, rec, C, sa_seq, sa_off,
                    seq_tax, parent, depth, R, cap, nseq, chpt_exp)
