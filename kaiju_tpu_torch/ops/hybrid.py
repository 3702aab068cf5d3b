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

Over a group of processes on several hosts the switch is kernel Y
(``switch_hosts``, csrc/switch_hosts.cu), which MEM's O and Greedy's X
hand their narrow intervals to (``switch_in_rounds``): an occurrence whose
walk step, SA sample or text row lies on another host parks with its query
for the owner (kernel N), stage "switch" for the walks, then stage "text"
for the text rows (``parallel.exchange``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..index.core import BLOCK
from .device_index import (Q_LF, Q_SAMPLE, Q_TEXT, Shards, _letter_at, rank,
                           sa_walk, shard_args)
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


# ---------------------------------------------------------------------------
# kernel Y: the switch over the shards of a group on several hosts
# ---------------------------------------------------------------------------

WALK, TEXT = 0, 1  # the kinds of a parked occurrence (csrc/switch_hosts.cu)
TEXT_WORDS = BLOCK // 4  # a text row's answer: 128 bytes as int32 words


class SwitchState(NamedTuple):
    """Y's state of n intervals between its launches: each interval's
    query end qg and letters left avail (int32 [n]), and each occurrence's
    reach ext and sequence ids (int32 [n, SW_WCAP]; ext -1 past the
    interval's occurrences)."""
    qg: torch.Tensor
    avail: torch.Tensor
    ext: torch.Tensor
    ids: torch.Tensor


def switch_state(qg, avail) -> SwitchState:
    n = qg.shape[0]
    z = torch.zeros((n, SW_WCAP), dtype=torch.int32, device=qg.device)
    return SwitchState(qg, avail, z, z.clone())


def _switch_finish(st):
    ext, ids = st.ext, st.ids
    n = ext.shape[0]
    maxext = ext.max(1).values if n else ext.new_zeros(0)
    ach = ext == maxext[:, None]
    out = torch.zeros_like(ids)
    rank_ = torch.cumsum(ach, 1, dtype=torch.int32) - ach.to(torch.int32)
    r, c = torch.nonzero(ach, as_tuple=True)
    out[r, rank_[r, c].long()] = ids[r, c]
    return maxext, ach.sum(1, dtype=torch.int32), out


def switch_hosts_plain(form, rec, C, sa_seq, sa_off, text, rank_start, nseq,
                       chpt_exp, flat, st, s0=None, s1=None, parked=None,
                       answers=None, touched=None):
    """touched: as for ``device_index.rank``."""
    if form == 2:
        return _switch_finish(st)
    dev = flat.device
    i32 = torch.int32
    check = (1 << chpt_exp) - 1
    nsamp = sa_seq.shape[0]
    out_p, out_q = [], []

    def park(o, kind, a, b, qkind, x):
        out_p.append(torch.stack([o, torch.full_like(o, kind), a, b], 1))
        out_q.append(torch.stack([torch.full_like(x, qkind << 8), x], 1))

    ext, ids = st.ext.view(-1), st.ids.view(-1)
    z = torch.zeros(0, dtype=i32, device=dev)
    w_o = w_k = w_st = c_o = c_p = c_u = z
    if form == 0:
        ext.fill_(-1)
        ids.zero_()
        q = torch.arange(SW_WCAP, dtype=i32, device=dev)
        occ = q[None, :] < (s1 - s0)[:, None]
        w_o = torch.nonzero(occ.reshape(-1)).squeeze(1).to(i32)
        w_k = (s0[:, None] + q[None, :])[occ]
        w_st = torch.zeros_like(w_k)
    else:
        o, kind, a, b = parked.unbind(1)
        w = kind == WALK
        wo, wk, wst, v = o[w], a[w], b[w], answers[w, 0]
        lf = (wk & check) != 0
        go = lf & (v >= 0)  # an LF step to the next row
        end = ~go  # a terminator's ~rank, or a sample
        iseq = torch.where(lf, ~v, v)[end]
        pos = torch.where(lf, wst, answers[w, 1] + wst)[end]
        ids[wo[end].long()] = iseq
        c_o, c_u = wo[end], torch.zeros_like(iseq)
        c_p = rank_start[torch.clamp(iseq, 0, nseq - 1).long()] + pos
        w_o, w_k, w_st = wo[go], v[go], wst[go] + 1
        t = ~w  # text rows: compare within the answered row
        to, tp, tu, rows = o[t], a[t], b[t], answers[t]
        r = (to >> 3).long()
        lim = torch.minimum(st.avail[r], tp)
        lo = ((tp - 1 - tu) >> 7) << 7
        end_ = torch.minimum(lim, tp - lo)
        shifts = torch.tensor([0, 8, 16, 24], dtype=i32, device=dev)
        row_bytes = ((rows[:, :, None] >> shifts) & 255).reshape(-1, BLOCK)
        qg = st.qg[r]
        live = torch.arange(to.shape[0], device=dev)
        done = torch.zeros(to.shape[0], dtype=torch.bool, device=dev)
        while True:
            live = live[tu[live] < end_[live]]
            if not live.numel():
                break
            u = tu[live]
            c = row_bytes[live, (tp[live] - 1 - u - lo[live]).long()]
            ok = (c > 0) & (c == flat[(qg[live] - 1 - u).long()].to(i32))
            done[live[~ok]] = True
            live = live[ok]
            tu[live] += 1
        ext[to[done].long()] = tu[done]
        c_o = torch.cat([c_o, to[~done]])
        c_p = torch.cat([c_p, tp[~done]])
        c_u = torch.cat([c_u, tu[~done]])
    # the walks on this host's rows
    while w_o.numel():
        at = (w_k & check) == 0
        so, sk, sst = w_o[at], w_k[at], w_st[at]
        slot = torch.clamp((sk >> chpt_exp) - ((nseq - 1) >> chpt_exp) - 1,
                           0, nsamp - 1)
        here = sa_seq.here[sa_seq.owner(slot)]
        park(so[~here], WALK, sk[~here], sst[~here], Q_SAMPLE, slot[~here])
        hs = slot[here]
        iseq, pos = sa_seq[hs], sa_off[hs] + sst[here]
        ids[so[here].long()] = iseq
        c_o = torch.cat([c_o, so[here]])
        c_u = torch.cat([c_u, torch.zeros_like(iseq)])
        c_p = torch.cat([c_p, rank_start[torch.clamp(
            iseq, 0, nseq - 1).long()] + pos])
        lo_, lk, lst = w_o[~at], w_k[~at], w_st[~at]
        here = rec.here[rec.owner(lk >> 7)]
        park(lo_[~here], WALK, lk[~here], lst[~here], Q_LF, lk[~here])
        lo_, lk, lst = lo_[here], lk[here], lst[here]
        letter = _letter_at(rec, lk)
        kn = rank(rec, C, letter, lk, touched)
        term = letter == 0
        ids[lo_[term].long()] = kn[term]
        c_o = torch.cat([c_o, lo_[term]])
        c_u = torch.cat([c_u, torch.zeros_like(kn[term])])
        c_p = torch.cat([c_p, rank_start[torch.clamp(
            kn[term], 0, nseq - 1).long()] + lst[term]])
        w_o, w_k, w_st = lo_[~term], kn[~term], lst[~term] + 1
    # the compares on this host's text rows
    r = (c_o >> 3).long()
    lim = torch.minimum(st.avail[r], c_p)
    qg = st.qg[r]
    while c_o.numel():
        fin = c_u >= lim
        ext[c_o[fin].long()] = c_u[fin]
        keep = ~fin
        c_o, c_p, c_u, lim, qg = (c_o[keep], c_p[keep], c_u[keep],
                                  lim[keep], qg[keep])
        x = c_p - 1 - c_u
        here = text.here[text.owner(x)]
        park(c_o[~here], TEXT, c_p[~here], c_u[~here], Q_TEXT,
             x[~here] >> 7)
        c_o, c_p, c_u, lim, qg, x = (c_o[here], c_p[here], c_u[here],
                                     lim[here], qg[here], x[here])
        c = text[x].to(i32)
        ok = (c > 0) & (c == flat[(qg - 1 - c_u).long()].to(i32))
        ext[c_o[~ok].long()] = c_u[~ok]
        c_o, c_p, c_u, lim, qg = (c_o[ok], c_p[ok], c_u[ok] + 1, lim[ok],
                                  qg[ok])
    pk = torch.cat(out_p) if out_p else z.view(0, 4)
    qs = torch.cat(out_q) if out_q else z.view(0, 2)
    return pk, qs.view(-1, 1, 2)


def switch_hosts(form, rec, C, sa_seq, sa_off, text, rank_start, nseq,
                 chpt_exp, flat, st, s0=None, s1=None, parked=None,
                 answers=None):
    """Kernel Y (csrc/switch_hosts.cu for the contract): the hybrid's
    switch of n intervals over the shards of a group on several hosts, on
    the state st (``switch_state(qg, avail)``, updated in place).  Form 0
    (start) takes the intervals s0, s1 int32 [n] (1 to SW_WCAP
    occurrences each), form 1 (resume) the parked occurrences int32 [L, 4]
    with their answers int32 [L, W] (W = 2 for walks, TEXT_WORDS for text
    rows); both return the occurrences parked now (int32 [L', 4] = (o,
    kind, a, b), kind WALK or TEXT) with their queries int32 [L', 1, 2]
    (Q_LF, Q_SAMPLE or Q_TEXT).  Form 2 (finish) returns switch_plain's
    (maxext int32 [n], n_ach int32 [n], ids int32 [n, SW_WCAP]).  Kernel
    Y for CUDA tensors, the plain version for CPU tensors."""
    if form not in (0, 1, 2) or (form == 0) != (s0 is not None) or (
            form == 1) != (parked is not None):
        raise ValueError("form 0 takes s0 and s1, form 1 parked and answers")
    n = st.qg.shape[0]
    if form == 0 and not s0.shape == s1.shape == (n,):
        raise ValueError("s0, s1: one entry an interval expected")
    if flat.device.type == "cpu":
        return switch_hosts_plain(form, rec, C, sa_seq, sa_off, text,
                                  rank_start, nseq, chpt_exp, flat, st, s0,
                                  s1, parked, answers)
    dev = flat.device
    args = shard_args(dev, rec, sa_seq, sa_off, text, hosts=True)
    for t, what in ((C, "C"), (rank_start, "rank_start"), (st.qg, "qg"),
                    (st.avail, "avail")):
        kernels.check(t, what, torch.int32, dev, 1)
    kernels.check(flat, "flat", torch.uint8, dev, 1)
    kernels.check(st.ext, "ext", torch.int32, dev, 2)
    kernels.check(st.ids, "ids", torch.int32, dev, 2)
    if st.avail.shape != (n,) or st.ext.shape != (n, SW_WCAP) or (
            st.ids.shape != (n, SW_WCAP)):
        raise ValueError("the switch state does not fit its intervals")
    if rank_start.shape[0] != nseq:
        raise ValueError(f"rank_start: {rank_start.shape[0]}, expected {nseq}")
    L = W = 0
    if form == 0:
        kernels.check(s0, "s0", torch.int32, dev, 1)
        kernels.check(s1, "s1", torch.int32, dev, 1)
        m = SW_WCAP * n
    elif form == 1:
        kernels.check(parked, "parked", torch.int32, dev, 2)
        kernels.check(answers, "answers", torch.int32, dev, 2)
        L, W = answers.shape
        if parked.shape != (L, 4) or W < 2:
            raise ValueError("parked [L, 4] and answers [L, W >= 2] expected")
        m = L
    if form == 2:
        maxext = torch.empty(n, dtype=torch.int32, device=dev)
        n_ach = torch.empty(n, dtype=torch.int32, device=dev)
        ids = torch.empty((n, SW_WCAP), dtype=torch.int32, device=dev)
        if n:
            kernels.launch("switch_hosts", 2, *args, C, nseq, chpt_exp,
                           rank_start, flat, st.qg, st.avail, n, None, None,
                           None, None, 0, 0, st.ext, st.ids, None, None, None,
                           maxext, n_ach, ids)
        return maxext, n_ach, ids
    park = torch.empty((m, 4), dtype=torch.int32, device=dev)
    q = torch.empty((m, 1, 2), dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    if m:
        kernels.launch("switch_hosts", form, *args, C, nseq, chpt_exp,
                       rank_start, flat, st.qg, st.avail, n, s0, s1, parked,
                       answers, L, W, st.ext, st.ids, park, q, count, None,
                       None, None)
    k = int(count)
    return park[:k], q[:k]


def switch_in_rounds(sh, exchange, s0, s1, qg, avail, flat, rank_start):
    """The hybrid's switch of n intervals over a ``ShardedIndex`` of a
    group of processes on several hosts: Y's start form, the walks' parked
    steps and samples answered in the rounds of stage "switch" (width 2),
    then the text rows in those of stage "text" (width TEXT_WORDS), then
    Y's finish form: switch_plain's (maxext, n_ach, ids).  Every process
    of the group calls it at the same point, with intervals or without,
    since each round is a collective."""
    st = switch_state(qg, avail)
    idx = (sh.rec, sh.C, sh.sa_seq, sh.sa_off, sh.text, rank_start, sh.nseq,
           sh.chpt_exp, flat, st)
    parked, queries = switch_hosts(0, *idx, s0=s0, s1=s1)
    held = []  # the compares parked at a text row, for stage "text"

    def split(pk, qs):
        t = pk[:, 1] == TEXT
        held.append((pk[t], qs[t]))
        return pk[~t], qs[~t]

    parked, queries = split(parked, queries)
    exchange.rounds("switch", parked, queries, 2, lambda pk, ans: split(
        *switch_hosts(1, *idx, parked=pk, answers=ans.reshape(-1, 2))))
    parked = torch.cat([p for p, _q in held])
    queries = torch.cat([q for _p, q in held])
    exchange.rounds("text", parked, queries, TEXT_WORDS, lambda pk, ans:
                    switch_hosts(1, *idx, parked=pk,
                                 answers=ans.reshape(-1, TEXT_WORDS)))
    return switch_hosts(2, *idx)
