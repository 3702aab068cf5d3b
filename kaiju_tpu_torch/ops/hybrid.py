"""The text-compare hybrid: kernel G (``text_extend``) and the plain
switch that it and kernel E's last level share.

On an index with a text copy (``DeviceIndex.text``, ``rank_start``) and
fewer than VBASE positions, a backward search whose SA interval holds at
most SW_WCAP occurrences stops stepping the FM index: each occurrence is
walked to its text position (K4's ``_walk_pos``), and the extension goes
on by comparing the database text with the query directly (K8's
``_switch_pool`` and ``_text_extend``, kaiju_tpu/ops/fused_mem2.py).  The
occurrences that reach the longest extension are the interval the FM steps
would end on, in SA order (LF steps keep the order), so their sequence ids
stand in for it: a virtual row (VBASE + slot, VBASE + slot + n) with the
ids at sw_ids[slot, slot + n).  Kernels D and F read such rows from
sw_ids instead of walking them (``ops/classify.py``).  The row is as wide
as the interval it replaces, so every count downstream is unchanged.

In the MEM funnel kernel B stops a lane after the K-letter seed and
S1_STEPS steps (``search.mem_extend(..., sw_steps=S1_STEPS)``) and G
finishes it; a lane p's slot is 8 p.  In Greedy only the last variant
level switches, inside kernel E.
"""

from __future__ import annotations

import torch

from .. import kernels
from .device_index import Shards, sa_walk, shard_args
from .search import SW_WCAP, _lane_fragments

S1_STEPS = 12  # FM steps after the K-letter seed before the MEM switch
VBASE = 1 << 30  # virtual rows start here; real SA positions lie below


def text_match_plain(text, flat, p, qg, avail):
    """The longest u with text[p-1-t] == flat[qg-1-t] for every t < u,
    stopping at t = avail, at t = p and at a text code of 0; int32 [N]."""
    u = torch.zeros_like(p)
    lim = torch.minimum(avail, p)
    live = torch.nonzero(lim > 0).squeeze(1)
    while live.numel():
        t = u[live]
        c = text[(p[live] - 1 - t).long()]
        ok = (c > 0) & (c == flat[(qg[live] - 1 - t).long()])
        live = live[ok]
        u[live] += 1
        live = live[u[live] < lim[live]]
    return u


def switch_plain(s0, s1, qg, avail, flat, text, rank_start, rec, C, sa_seq,
                 sa_off, nseq, chpt_exp, touched=None):
    """The switch of n intervals [s0, s1) (1 to SW_WCAP occurrences each)
    whose query letters end before flat position qg, avail of them left:
    (maxext int32 [n], n_ach int32 [n], ids int32 [n, SW_WCAP]) with the
    ids of the n_ach occurrences reaching maxext first, in SA order, zeros
    after them.  touched: as for ``device_index.rank``."""
    dev = s0.device
    n = s0.shape[0]
    q = torch.arange(SW_WCAP, dtype=torch.int32, device=dev)
    occ = (q[None, :] < (s1 - s0)[:, None])
    k = (s0[:, None] + q[None, :])[occ]
    iseq, pos = sa_walk(rec, C, sa_seq, sa_off, nseq, chpt_exp, k, touched)
    row = torch.nonzero(occ)[:, 0]
    pt = rank_start[torch.clamp(iseq, 0, nseq - 1).long()] + pos
    ext = torch.full((n, SW_WCAP), -1, dtype=torch.int32, device=dev)
    ext[occ] = text_match_plain(text, flat, pt, qg[row], avail[row])
    maxext = ext.max(1).values if n else ext.new_zeros(0)
    ach = ext == maxext[:, None]
    ids = torch.zeros((n, SW_WCAP), dtype=torch.int32, device=dev)
    idv = torch.zeros((n, SW_WCAP), dtype=torch.int32, device=dev)
    idv[occ] = iseq
    rank = torch.cumsum(ach, 1, dtype=torch.int32) - ach.to(torch.int32)
    r, c = torch.nonzero(ach, as_tuple=True)
    ids[r, rank[r, c].long()] = idv[r, c]
    return maxext, ach.sum(1, dtype=torch.int32), ids


# ---------------------------------------------------------------------------
# kernel G
# ---------------------------------------------------------------------------


def switched(i, s0, s1, frag_off, sw_len):
    """The lanes of B's output (flat layout) that G finishes: i > 0,
    length j - i + 1 == sw_len and 1..SW_WCAP occurrences; bool [P]."""
    pos, _f, base, _flen = _lane_fragments(frag_off, i.shape[0])
    width = s1 - s0
    return ((i > 0) & (pos - base - i + 1 == sw_len) & (width >= 1)
            & (width <= SW_WCAP))


def text_extend_plain(i, s0, s1, flat, frag_off, sw_len, text, rank_start,
                      rec, C, sa_seq, sa_off, nseq, chpt_exp, touched=None):
    """touched: None, or a list that receives the record rows read."""
    P = i.shape[0]
    out_i, out_s0, out_s1 = i.clone(), s0.clone(), s1.clone()
    sw_ids = torch.zeros(SW_WCAP * P, dtype=torch.int32, device=i.device)
    if P == 0:
        return out_i, out_s0, out_s1, sw_ids
    lanes = torch.nonzero(switched(i, s0, s1, frag_off, sw_len)).squeeze(1)
    _pos, _f, base, _flen = _lane_fragments(frag_off, P)
    li = i[lanes]
    maxext, n_ach, ids = switch_plain(
        s0[lanes], s1[lanes], base[lanes] + li, li, flat, text, rank_start,
        rec, C, sa_seq, sa_off, nseq, chpt_exp, touched)
    slot = (SW_WCAP * lanes).to(torch.int32)
    out_i[lanes] = li - maxext
    out_s0[lanes] = VBASE + slot
    out_s1[lanes] = VBASE + slot + n_ach
    sw_ids.view(P, SW_WCAP)[lanes] = ids
    return out_i, out_s0, out_s1, sw_ids


def text_extend(i, s0, s1, flat, frag_off, sw_len, text, rank_start, rec, C,
                sa_seq, sa_off, nseq, chpt_exp):
    """Finish B's switched lanes (see ``switched``) by text comparison:
    (i, s0, s1) int32 [P] with each switched lane's result as a virtual
    row (VBASE + 8 p, VBASE + 8 p + n), other lanes unchanged, and sw_ids
    int32 [8 P] with lane p's n ids in SA order at [8 p, 8 p + n), zeros
    elsewhere.  Kernel G (csrc/text_extend.cu) for CUDA tensors (its
    sharded instantiation for a ``Shards`` rec, with the SA samples and the
    text in shards too), the plain version for CPU tensors."""
    P = i.shape[0]
    if SW_WCAP * P >= VBASE:
        raise ValueError(f"{P} lanes: virtual rows would pass 2^31")
    if i.device.type == "cpu":
        return text_extend_plain(i, s0, s1, flat, frag_off, sw_len, text,
                                 rank_start, rec, C, sa_seq, sa_off, nseq,
                                 chpt_exp)
    dev = i.device
    sharded = isinstance(rec, Shards)
    if sharded:
        idx_args = shard_args(dev, rec, sa_seq, sa_off, text)
    else:
        idx_args = (rec, rec.shape[0], C, sa_seq, sa_off, sa_seq.shape[0],
                    nseq, chpt_exp, text)
        for t, what, nd in ((rec, "rec", 2), (sa_seq, "sa_seq", 1),
                            (sa_off, "sa_off", 1)):
            kernels.check(t, what, torch.int32, dev, nd)
        kernels.check(text, "text", torch.uint8, dev, 1)
    for t, what, nd in ((i, "i", 1), (s0, "s0", 1), (s1, "s1", 1),
                        (frag_off, "frag_off", 1), (rank_start, "rank_start", 1),
                        (C, "C", 1)):
        kernels.check(t, what, torch.int32, dev, nd)
    kernels.check(flat, "flat", torch.uint8, dev, 1)
    if not s0.shape == s1.shape == flat.shape == (P,):
        raise ValueError("i, s0, s1 and flat must hold one entry a lane")
    if rank_start.shape[0] != nseq:
        raise ValueError(f"rank_start: {rank_start.shape[0]}, expected {nseq}")
    F = frag_off.shape[0] - 1
    out = torch.empty((3, P), dtype=torch.int32, device=dev)
    sw_ids = torch.zeros(SW_WCAP * P, dtype=torch.int32, device=dev)
    if P:
        if F < 1:
            raise ValueError("lanes without a fragment to own them")
        # the kernel's lists: counters, a lane's 6 words, 8 occurrences
        scratch = torch.empty(4 + (6 + SW_WCAP) * P, dtype=torch.int32,
                              device=dev)
        if sharded:
            kernels.launch("text_extend_sharded", *idx_args, C, nseq,
                           chpt_exp, rank_start, flat, P, frag_off, F, sw_len,
                           i, s0, s1, out[0], out[1], out[2], sw_ids, scratch)
        else:
            kernels.launch("text_extend", *idx_args, rank_start, flat, P,
                           frag_off, F, sw_len, i, s0, s1, out[0], out[1],
                           out[2], sw_ids, scratch)
    return out[0], out[1], out[2], sw_ids
