"""The classification tail: kernel F (``ranges_lca``, per-read SA ranges
to the LCA), kernel D (``read_lca``, the MEM form over per-fragment tie
statistics) and ``fused_mem_classify``, which runs B -> C -> D, or
B -> G -> C -> D with the text-compare hybrid; and, for a group of
processes on several hosts, kernels W and V (D and F split around kernel
Q's SA walks, both finished by W's ``lca_resolved``) and
``fused_mem_classify_hosts``, with kernel Y (``hybrid.switch_hosts``) in
G's place on a text index.  D and F share their tail:
one device function (``csrc/lca_common.cuh``) and one plain version
(``ranges_lca_plain``).  Given ``sw_ids``, a position >= VBASE is a
virtual row of the hybrid (``ops/hybrid.py``) and takes its sequence from
sw_ids[k - VBASE] instead of an SA walk; without, every position is
walked, whatever its value.

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
from .device_index import Shards, sa_walk, shard_args, walk_hosts
from .hybrid import (S1_STEPS, VBASE, switch_in_rounds, switched,
                     text_extend)
from .search import (SW_WCAP, _lane_fragments, mem_extend, mem_extend_hosts,
                     mem_stats)

FLAG_TIE_OVER = 1  # a contributing fragment had more ties than T
FLAG_NEED_MORE = 2  # position budget R exhausted before the id cap
MAX_R = 1024  # positions a read: kernels D and F keep them in shared memory


def _first_positions(g_s0, g_s1, R):
    """The first R SA positions of each read's ranges g_s0, g_s1 int32
    [B, G], in range order: (k int32 [B, R], -1 past them; valid [B, R];
    total [B]; sizes [B, G]).  Each range counts up to R + 1, as kernels D
    and F count it (csrc/lca_common.cuh list_positions): only min(total,
    R) and total > R matter, and an int32 sum of S x T ranges near 2^31
    would wrap."""
    dev = g_s0.device
    B, G = g_s0.shape
    i32 = torch.int32
    sizes = torch.clamp(g_s1 - g_s0, 0, R + 1)
    csum = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev),
                      torch.cumsum(sizes, 1, dtype=i32)], 1)
    total = csum[:, -1]
    # position r lies in the last range whose start is <= r
    rr = torch.arange(R, dtype=i32, device=dev)
    seg = (csum[:, None, :] <= rr[None, :, None]).sum(2) - 1
    seg = torch.clamp(seg, 0, max(G - 1, 0))
    valid = rr[None, :] < torch.clamp(total, max=R)[:, None]
    k = torch.full((B, R), -1, dtype=i32, device=dev)
    if G:
        k[valid] = (g_s0.gather(1, seg) + rr[None, :]
                    - csum.gather(1, seg))[valid]
    return k, valid, total, sizes


def _lca_of_taxa(tax, valid, total, parent, depth, R, cap):
    """The tail after the walks: the capped unique-id set of the taxa
    tax int32 [B, R] (valid where listed), then the LCA.  Returns (lca,
    n_ids, need_more, cut)."""
    dev = tax.device
    i32 = torch.int32
    rr = torch.arange(R, dtype=i32, device=dev)
    # ---- capped unique-id set ------------------------------------------
    eq = (tax[:, :, None] == tax[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    earlier = rr[None, :] < rr[:, None]  # [r, q]: q before r
    uniq = valid & ~(eq & earlier[None]).any(2)
    prior = torch.cumsum(uniq, 1, dtype=i32) - uniq.to(i32)
    included = uniq & (prior <= cap)
    n_ids = included.sum(1, dtype=i32)
    n_uniq = uniq.sum(1, dtype=i32)
    need_more = (total > R) & (n_uniq <= cap)
    cut = (n_uniq > cap + 1) | ((total > R) & (n_uniq > cap))

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
        ids = torch.where(up, _up(parent, ids), ids)
        lift = lift - up.to(i32)
    # absent slots take the first present taxon so they never block the
    # climb
    first = ids.gather(1, present.to(i32).argmax(1, keepdim=True))
    ids = torch.where(present, ids, first)
    for _ in range(int(torch.where(present.any(1), dmin, 0).max())):
        same = (ids == ids[:, :1]).all(1)
        if bool(same.all()):
            break
        ids = torch.where(same[:, None], ids, _up(parent, ids))
    lca = torch.where(present.any(1), ids[:, 0].to(i32), 0)
    first_uid = tax.gather(1, included.to(i32).argmax(1, keepdim=True))[:, 0]
    lca = torch.where(n_ids == 1, first_uid, lca)
    lca = torch.where(n_ids > 0, lca, 0)
    return lca, n_ids, need_more.to(i32), cut


def ranges_lca_plain(g_s0, g_s1, rec, C, sa_seq, sa_off, seq_tax, parent,
                     depth, R, cap, nseq, chpt_exp, touched=None,
                     sw_ids=None):
    """touched: None, or a list that receives the record rows read."""
    dev = g_s0.device
    B, G = g_s0.shape
    i32 = torch.int32
    if B == 0:
        z = torch.zeros(0, dtype=i32, device=dev)
        return z, z, z, z
    pos, valid, total, sizes = _first_positions(g_s0, g_s1, R)
    tax = torch.full((B, R), -1, dtype=i32, device=dev)
    if G:
        k = pos[valid]
        virt = (k >= VBASE if sw_ids is not None
                else torch.zeros_like(k, dtype=torch.bool))
        iseq = torch.empty_like(k)
        walked, _pos = sa_walk(rec, C, sa_seq, sa_off, nseq, chpt_exp,
                               k[~virt], touched)
        iseq[~virt] = walked
        if sw_ids is not None:
            iseq[virt] = sw_ids[torch.clamp(k[virt] - VBASE, max=max(
                sw_ids.shape[0] - 1, 0)).long()]
        tax[valid] = seq_tax[torch.clamp(iseq, 0, seq_tax.shape[0] - 1).long()]
    lca, n_ids, need_more, cut = _lca_of_taxa(tax, valid, total, parent,
                                              depth, R, cap)
    tie_order = ((sizes > 0).sum(1) > 1) & cut
    return lca, n_ids, need_more, tie_order.to(i32)


def _up(parent, ids):
    """One round of parent loads of the lift or the climb (a link of the
    longest chain of dependent loads, which chip_smoke.py counts)."""
    return parent[ids].long()


def ranges_lca(g_s0, g_s1, rec, C, sa_seq, sa_off, seq_tax, parent, depth,
               R, cap, nseq, chpt_exp, sw_ids=None):
    """(lca, n_ids, need_more, tie_order) int32 [B] per read from its SA
    ranges g_s0, g_s1 int32 [B, G] (range g contributes when g_s1 > g_s0).
    tie_order is 1 where more than one range contributes and the id cap
    may have cut the read's taxa, so that the result depends on the order
    of the ranges.  sw_ids: None, or the ids of the virtual rows (int32).
    Kernel F for CUDA tensors (its sharded instantiation for a ``Shards``
    rec and sa_seq), the plain version for CPU tensors."""
    if g_s0.device.type == "cpu":
        return ranges_lca_plain(g_s0, g_s1, rec, C, sa_seq, sa_off, seq_tax,
                                parent, depth, R, cap, nseq, chpt_exp,
                                sw_ids=sw_ids)
    dev = g_s0.device
    sharded = isinstance(rec, Shards)
    if sharded:
        idx_args = (*shard_args(dev, rec, sa_seq), C)
    else:
        idx_args = (rec, rec.shape[0], C, sa_seq, sa_seq.shape[0])
        kernels.check(rec, "rec", torch.int32, dev, 2)
        kernels.check(sa_seq, "sa_seq", torch.int32, dev, 1)
    for t, what, nd in ((g_s0, "g_s0", 2), (g_s1, "g_s1", 2), (C, "C", 1),
                        (seq_tax, "seq_tax", 1), (parent, "parent", 1),
                        (depth, "depth", 1)):
        kernels.check(t, what, torch.int32, dev, nd)
    if g_s1.shape != g_s0.shape:
        raise ValueError("g_s0 and g_s1 differ in shape")
    _check_tail(parent, depth, R, sw_ids, dev)
    B, G = g_s0.shape
    out = torch.empty((4, B), dtype=torch.int32, device=dev)
    if B:
        kernels.launch("ranges_lca_sharded" if sharded else "ranges_lca",
                       g_s0, g_s1, B, G, *idx_args, seq_tax, seq_tax.shape[0],
                       parent, depth, parent.shape[0], R, cap, nseq, chpt_exp,
                       sw_ids, _nsw(sw_ids), out[0], out[1], out[2], out[3])
    return out[0], out[1], out[2], out[3]


def _check_tail(parent, depth, R, sw_ids, dev):
    if parent.shape != depth.shape:
        raise ValueError("parent and depth differ in size")
    if not 0 < R <= MAX_R:
        raise ValueError(f"R must lie in 1..{MAX_R}, got {R}")
    if sw_ids is not None:
        kernels.check(sw_ids, "sw_ids", torch.int32, dev, 1)


def _nsw(sw_ids):
    return 0 if sw_ids is None else sw_ids.shape[0]


def _contributing(maxl, tie_cnt, tie_s0, tie_s1, rf_rows):
    """The read's longest over its slots, whether a contributing fragment
    had more than T ties, and the contributing ties' ranges in slot order
    then tie order (int32 [B, S T], 0 where not contributing)."""
    dev = maxl.device
    F, T = tie_s0.shape
    B, S = rf_rows.shape
    i32 = torch.int32
    rf = torch.where(rf_rows >= 0, rf_rows, F).long()
    zero = torch.zeros(1, dtype=i32, device=dev)
    slot_maxl = torch.cat([maxl, zero])[rf]
    longest = slot_maxl.max(1).values
    contrib = (rf_rows >= 0) & (slot_maxl == longest[:, None]) & (
        longest[:, None] > 0)
    tie_over = (contrib & (torch.cat([tie_cnt, zero])[rf] > T)).any(1)
    zrow = torch.zeros((1, T), dtype=i32, device=dev)
    keep = contrib.repeat_interleave(T, dim=1)
    t_s0 = torch.where(keep, torch.cat([tie_s0, zrow])[rf].reshape(B, S * T), 0)
    t_s1 = torch.where(keep, torch.cat([tie_s1, zrow])[rf].reshape(B, S * T), 0)
    return longest, tie_over.to(i32), t_s0, t_s1


def read_lca_plain(maxl, tie_cnt, tie_s0, tie_s1, rf_rows, rec, C, sa_seq,
                   sa_off, seq_tax, parent, depth, R, cap, nseq, chpt_exp,
                   touched=None, sw_ids=None):
    """touched: None, or a list that receives the record rows read."""
    B = rf_rows.shape[0]
    i32 = torch.int32
    if B == 0:
        return torch.zeros((0, 4), dtype=i32, device=maxl.device)
    longest, tie_over, t_s0, t_s1 = _contributing(maxl, tie_cnt, tie_s0,
                                                  tie_s1, rf_rows)
    lca, n_ids, need_more, _order = ranges_lca_plain(
        t_s0, t_s1, rec, C, sa_seq, sa_off, seq_tax, parent, depth, R, cap,
        nseq, chpt_exp, touched, sw_ids)
    lca = torch.where(longest > 0, lca, 0)
    flags = tie_over * FLAG_TIE_OVER + need_more * FLAG_NEED_MORE
    return torch.stack([lca, longest, flags, n_ids], 1).to(i32)


def read_lca(maxl, tie_cnt, tie_s0, tie_s1, rf_rows, rec, C, sa_seq, sa_off,
             seq_tax, parent, depth, R, cap, nseq, chpt_exp, sw_ids=None):
    """(lca, score, flags, n_ids) int32 [B, 4] per read from the
    per-fragment statistics (maxl, tie_cnt [F]; tie_s0, tie_s1 [F, T]) and
    the pop-order slot table rf_rows int32 [B, S] (-1 = pad); sw_ids:
    None, or the ids of the virtual tie rows.  Kernel D for CUDA tensors
    (its sharded instantiation for a ``Shards`` rec and sa_seq), the plain
    version for CPU tensors."""
    if maxl.device.type == "cpu":
        return read_lca_plain(maxl, tie_cnt, tie_s0, tie_s1, rf_rows, rec, C,
                              sa_seq, sa_off, seq_tax, parent, depth, R, cap,
                              nseq, chpt_exp, sw_ids=sw_ids)
    dev = maxl.device
    F, T = tie_s0.shape
    sharded = isinstance(rec, Shards)
    if sharded:
        idx_args = (*shard_args(dev, rec, sa_seq), C)
    else:
        idx_args = (rec, rec.shape[0], C, sa_seq, sa_seq.shape[0])
        kernels.check(rec, "rec", torch.int32, dev, 2)
        kernels.check(sa_seq, "sa_seq", torch.int32, dev, 1)
    for t, what, nd in ((maxl, "maxl", 1), (tie_cnt, "tie_cnt", 1),
                        (tie_s0, "tie_s0", 2), (tie_s1, "tie_s1", 2),
                        (rf_rows, "rf_rows", 2), (C, "C", 1),
                        (seq_tax, "seq_tax", 1), (parent, "parent", 1),
                        (depth, "depth", 1)):
        kernels.check(t, what, torch.int32, dev, nd)
    if maxl.shape[0] != F or tie_cnt.shape[0] != F or tie_s1.shape != (F, T):
        raise ValueError("maxl, tie_cnt, tie_s0 and tie_s1 disagree on F or T")
    _check_tail(parent, depth, R, sw_ids, dev)
    B, S = rf_rows.shape
    out = torch.empty((B, 4), dtype=torch.int32, device=dev)
    if B:
        kernels.launch("read_lca_sharded" if sharded else "read_lca", maxl,
                       tie_cnt, tie_s0, tie_s1, T, rf_rows, B, S, *idx_args,
                       seq_tax, seq_tax.shape[0], parent, depth,
                       parent.shape[0], R, cap, nseq, chpt_exp, sw_ids,
                       _nsw(sw_ids), out)
    return out


# ---------------------------------------------------------------------------
# kernel W: D split around its walks, for a group on several hosts
# ---------------------------------------------------------------------------


def _listed_ids(pos, sw_ids):
    """The list forms' seq with sw_ids: each listed position's sequence
    where it is a virtual row (sw_ids[k - VBASE], the rule of
    ranges_lca_plain), -1 elsewhere (kernel Q walks it)."""
    virt = pos >= VBASE
    seq = torch.full_like(pos, -1)
    seq[virt] = sw_ids[torch.clamp(pos[virt] - VBASE, max=max(
        sw_ids.shape[0] - 1, 0)).long()]
    return seq


def read_lca_list_plain(maxl, tie_cnt, tie_s0, tie_s1, rf_rows, R,
                        sw_ids=None):
    B = rf_rows.shape[0]
    dev = maxl.device
    if B == 0:
        pos = torch.zeros((0, R), dtype=torch.int32, device=dev)
        info = torch.zeros((0, 4), dtype=torch.int32, device=dev)
    else:
        longest, tie_over, t_s0, t_s1 = _contributing(maxl, tie_cnt, tie_s0,
                                                      tie_s1, rf_rows)
        pos, _valid, total, _sizes = _first_positions(t_s0, t_s1, R)
        info = torch.stack([torch.clamp(total, max=R), total, longest,
                            tie_over], 1).to(torch.int32)
    if sw_ids is None:
        return pos, info
    return pos, info, _listed_ids(pos, sw_ids)


def lca_resolved_plain(info, seq, seq_tax, parent, depth, R, cap,
                       ranges=False):
    B = info.shape[0]
    dev = info.device
    i32 = torch.int32
    if B == 0:
        z = torch.zeros(0, dtype=i32, device=dev)
        return z, z, z, z
    n, total = info[:, 0], info[:, 1]
    valid = torch.arange(R, dtype=i32, device=dev)[None, :] < n[:, None]
    tax = torch.full((B, R), -1, dtype=i32, device=dev)
    tax[valid] = seq_tax[torch.clamp(seq[valid], 0,
                                     seq_tax.shape[0] - 1).long()]
    lca, n_ids, need_more, cut = _lca_of_taxa(tax, valid, total, parent,
                                              depth, R, cap)
    tie_order = (info[:, 2] > 1) & cut if ranges else torch.zeros_like(cut)
    return lca, n_ids, need_more, tie_order.to(i32)


def read_lca_rows(info, lca, n_ids, need_more):
    """D's rows (lca, score, flags, n_ids) int32 [B, 4] from W's list
    form's info (longest, tie_over) and the resolved form's outputs."""
    longest, tie_over = info[:, 2], info[:, 3]
    flags = tie_over * FLAG_TIE_OVER + need_more * FLAG_NEED_MORE
    return torch.stack([torch.where(longest > 0, lca, 0), longest, flags,
                        n_ids], 1).to(torch.int32)


def read_lca_list(maxl, tie_cnt, tie_s0, tie_s1, rf_rows, R, sw_ids=None):
    """W's list form (csrc/read_lca.cu, kt_read_lca_hosts form 0): D's
    slots and range expansion without the walks, (pos int32 [B, R], the
    first R SA positions of each read's contributing ties, -1 past them;
    info int32 [B, 4] = (positions, total, longest, tie_over)), total
    counting each range up to R + 1.  With sw_ids (the hybrid's virtual
    rows, in G's layout) a third output, seq int32 [B, R]: each listed
    virtual row's sequence from sw_ids, as D takes it, -1 elsewhere (the
    positions kernel Q walks).  Kernel W for CUDA tensors, the plain
    version for CPU tensors."""
    if not 0 < R <= MAX_R:
        raise ValueError(f"R must lie in 1..{MAX_R}, got {R}")
    if maxl.device.type == "cpu":
        return read_lca_list_plain(maxl, tie_cnt, tie_s0, tie_s1, rf_rows, R,
                                   sw_ids)
    dev = maxl.device
    F, T = tie_s0.shape
    for t, what, nd in ((maxl, "maxl", 1), (tie_cnt, "tie_cnt", 1),
                        (tie_s0, "tie_s0", 2), (tie_s1, "tie_s1", 2),
                        (rf_rows, "rf_rows", 2)):
        kernels.check(t, what, torch.int32, dev, nd)
    if maxl.shape[0] != F or tie_cnt.shape[0] != F or tie_s1.shape != (F, T):
        raise ValueError("maxl, tie_cnt, tie_s0 and tie_s1 disagree on F or T")
    if sw_ids is not None:
        kernels.check(sw_ids, "sw_ids", torch.int32, dev, 1)
    B, S = rf_rows.shape
    pos = torch.empty((B, R), dtype=torch.int32, device=dev)
    info = torch.empty((B, 4), dtype=torch.int32, device=dev)
    seq = (None if sw_ids is None else
           torch.empty((B, R), dtype=torch.int32, device=dev))
    if B:
        kernels.launch("read_lca_hosts", 0, maxl, tie_cnt, tie_s0, tie_s1, T,
                       rf_rows, B, S, seq, None, 0, None, None, 0, R, 0,
                       0, sw_ids, _nsw(sw_ids), pos, info, None)
    return (pos, info) if sw_ids is None else (pos, info, seq)


def lca_resolved(info, seq, seq_tax, parent, depth, R, cap, ranges=False):
    """The resolved form that W and V share (csrc/read_lca.cu,
    kt_read_lca_hosts form 1): the capped id set and LCA of each read from
    info int32 [B, 4] (read_lca_list's, or ranges_lca_list's where
    `ranges`) and the sequence of each listed position, seq int32 [B, R]
    (kernel Q's walks): (lca, n_ids, need_more, tie_order) int32 [B], F's
    four outputs where `ranges`, else tie_order 0 (read_lca_rows makes D's
    rows).  Kernel W for CUDA tensors, the plain version for CPU
    tensors."""
    if not 0 < R <= MAX_R:
        raise ValueError(f"R must lie in 1..{MAX_R}, got {R}")
    if info.device.type == "cpu":
        return lca_resolved_plain(info, seq, seq_tax, parent, depth, R, cap,
                                  ranges)
    dev = info.device
    B = info.shape[0]
    for t, what, nd in ((info, "info", 2), (seq, "seq", 2),
                        (seq_tax, "seq_tax", 1), (parent, "parent", 1),
                        (depth, "depth", 1)):
        kernels.check(t, what, torch.int32, dev, nd)
    if info.shape[1] != 4 or seq.shape != (B, R):
        raise ValueError("info [B, 4] and seq [B, R] expected")
    _check_tail(parent, depth, R, None, dev)
    out = torch.empty((4, B), dtype=torch.int32, device=dev)
    if B:
        kernels.launch("read_lca_hosts", 1, None, None, None, None, 0, None,
                       B, 0, seq, seq_tax, seq_tax.shape[0], parent, depth,
                       parent.shape[0], R, cap, int(ranges), None, 0, None,
                       info, out)
    return out[0], out[1], out[2], out[3]


# ---------------------------------------------------------------------------
# kernel V: F split around its walks, for a group on several hosts
# ---------------------------------------------------------------------------


def ranges_lca_list_plain(g_s0, g_s1, R, sw_ids=None):
    pos, _valid, total, sizes = _first_positions(g_s0, g_s1, R)
    info = torch.stack([torch.clamp(total, max=R), total,
                        (sizes > 0).sum(1, dtype=torch.int32),
                        torch.zeros_like(total)], 1).to(torch.int32)
    if sw_ids is None:
        return pos, info
    return pos, info, _listed_ids(pos, sw_ids)


def ranges_lca_list(g_s0, g_s1, R, sw_ids=None):
    """Kernel V (csrc/ranges_lca.cu, kt_ranges_lca_hosts): F's
    range expansion without the walks, (pos int32 [B, R], the first R SA
    positions of each read's ranges g_s0, g_s1 int32 [B, G] in range
    order, -1 past them; info int32 [B, 4] = (positions, total, non-empty
    ranges, 0)), each range counted up to R + 1; lca_resolved (ranges)
    finishes the reads.  With sw_ids (the virtual tie rows' ids) a third
    output, seq int32 [B, R], as read_lca_list's.  Kernel V for CUDA
    tensors, the plain version for CPU tensors."""
    if not 0 < R <= MAX_R:
        raise ValueError(f"R must lie in 1..{MAX_R}, got {R}")
    if g_s0.device.type == "cpu":
        return ranges_lca_list_plain(g_s0, g_s1, R, sw_ids)
    dev = g_s0.device
    kernels.check(g_s0, "g_s0", torch.int32, dev, 2)
    kernels.check(g_s1, "g_s1", torch.int32, dev, 2)
    if g_s1.shape != g_s0.shape:
        raise ValueError("g_s0 and g_s1 differ in shape")
    if sw_ids is not None:
        kernels.check(sw_ids, "sw_ids", torch.int32, dev, 1)
    B, G = g_s0.shape
    pos = torch.empty((B, R), dtype=torch.int32, device=dev)
    info = torch.empty((B, 4), dtype=torch.int32, device=dev)
    seq = (None if sw_ids is None else
           torch.empty((B, R), dtype=torch.int32, device=dev))
    if B:
        kernels.launch("ranges_lca_hosts", g_s0, g_s1, B, G, R, sw_ids,
                       _nsw(sw_ids), pos, info, seq)
    return (pos, info) if sw_ids is None else (pos, info, seq)


def walk_listed(sh, exchange, pos, seq=None):
    """The sequence of each position that W's or V's list form listed (pos
    int32 [B, R], -1 past them): seq, where given, holds the list form's
    ids of the virtual rows and -1 elsewhere; kernel Q walks the listed
    positions whose seq is -1 (every one without seq) in the rounds of
    stage "walk".  Returns seq int32 [B, R], -1 past the listed
    positions."""
    listed = pos >= 0 if seq is None else (pos >= 0) & (seq < 0)
    rows = pos[listed]
    ids = torch.empty_like(rows)
    parked, queries = walk_hosts(sh.rec, sh.C, sh.sa_seq, sh.nseq,
                                 sh.chpt_exp, ids, rows=rows)
    exchange.rounds("walk", parked, queries, 1, lambda pk, ans:
                    walk_hosts(sh.rec, sh.C, sh.sa_seq, sh.nseq, sh.chpt_exp,
                               ids, parked=pk, answers=ans.reshape(-1)))
    seq = torch.full_like(pos, -1) if seq is None else seq
    seq[listed] = ids
    return seq


def fused_mem_classify_hosts(sh, exchange, seed, flat, frag_off, rf_rows,
                             seq_tax, parent, depth, K, j0, min_len, T, R,
                             cap, bloom=None, hyb=None):
    """fused_mem_classify over a ``ShardedIndex`` of a group of processes
    on several hosts (K16e across hosts): A's tables come in seed; O
    extends (its parked steps answered by their owners in rounds of
    ``exchange``, parallel/exchange.py); with hyb (the hybrid's (text,
    rank_start)), O stops the narrow lanes after S1_STEPS steps and kernel
    Y finishes them in the rounds of stages "switch" and "text"
    (hybrid.switch_in_rounds), its results written as G writes them; C
    takes the statistics, W lists each read's positions (with the virtual
    rows' ids), Q walks the others (rounds again) and W resolves the
    reads.  Every process of the group calls it for every batch, with its
    share (none: empty tensors), since each round is a collective.
    Returns fused_mem_classify's rows."""
    sw_steps = S1_STEPS if hyb is not None else 0
    out, parked, queries = mem_extend_hosts(sh.rec, sh.C, *seed, flat,
                                            frag_off, K, j0, bloom=bloom,
                                            sw_steps=sw_steps)
    exchange.rounds("extend", parked, queries, 1, lambda pk, ans:
                    mem_extend_hosts(sh.rec, sh.C, *seed, flat, frag_off, K,
                                     j0, bloom=bloom, out=out, parked=pk,
                                     answers=ans.reshape(-1, 2),
                                     sw_steps=sw_steps)[1:])
    sw_ids = None
    if hyb is not None:
        sw_ids = _switch_lanes(sh, exchange, out, flat, frag_off,
                               K + S1_STEPS, hyb[1])
    stats = mem_stats(out[0], out[1], out[2], frag_off, min_len, T)
    pos, info, *virt = read_lca_list(*stats[:2], *stats[3:], rf_rows, R,
                                     sw_ids)
    seq = walk_listed(sh, exchange, pos, *virt)
    return read_lca_rows(info, *lca_resolved(info, seq, seq_tax, parent,
                                             depth, R, cap)[:3])


def _switch_lanes(sh, exchange, out, flat, frag_off, sw_len, rank_start):
    """O's lanes that the hybrid switches (hybrid.switched) finished by
    kernel Y in rounds, written into out (int32 [3, P]) in G's layout: (i
    - maxext, VBASE + 8 p, VBASE + 8 p + n_ach); returns sw_ids int32
    [8 P], lane p's ids at [8 p, 8 p + n_ach)."""
    P = flat.shape[0]
    if SW_WCAP * P >= VBASE:
        raise ValueError(f"{P} lanes: virtual rows would pass 2^31")
    i, s0, s1 = out
    lanes = torch.nonzero(switched(i, s0, s1, frag_off, sw_len)).squeeze(1)
    base = _lane_fragments(frag_off, P)[2]
    li = i[lanes]
    maxext, n_ach, ids = switch_in_rounds(sh, exchange, s0[lanes], s1[lanes],
                                          base[lanes] + li, li, flat,
                                          rank_start)
    slot = (SW_WCAP * lanes).to(torch.int32)
    out[:, lanes] = torch.stack([li - maxext, VBASE + slot,
                                 VBASE + slot + n_ach])
    sw_ids = torch.zeros((P, SW_WCAP), dtype=torch.int32, device=flat.device)
    sw_ids[lanes] = ids
    return sw_ids.view(-1)


def fused_mem_classify(rec, C, seed, flat, frag_off, rf_rows, sa_seq, sa_off,
                       seq_tax, parent, depth, K, j0, min_len, T, R, cap,
                       nseq, chpt_exp, bloom=None, hyb=None):
    """The whole MEM batch, B -> C -> D (B -> G -> C -> D with the
    hybrid): flat uint8 [P] fragment codes, frag_off int32 [F+1], rf_rows
    int32 [B, S] fragment row per (read, pop-order slot), seed = (s0, s1,
    d) K-mer tables; bloom = None or the screen (words, m, lb); hyb = None
    or the hybrid's (text, rank_start).  Returns int32 [B, 4] rows (lca,
    score, flags, n_ids)."""
    i, s0, s1 = mem_extend(rec, C, *seed, flat, frag_off, K, j0, bloom=bloom,
                           sw_steps=S1_STEPS if hyb is not None else 0)
    sw_ids = None
    if hyb is not None:
        i, s0, s1, sw_ids = text_extend(i, s0, s1, flat, frag_off,
                                        K + S1_STEPS, *hyb, rec, C, sa_seq,
                                        sa_off, nseq, chpt_exp)
    stats = mem_stats(i, s0, s1, frag_off, min_len, T)
    return read_lca(*stats[:2], *stats[3:], rf_rows, rec, C, sa_seq, sa_off,
                    seq_tax, parent, depth, R, cap, nseq, chpt_exp,
                    sw_ids=sw_ids)
