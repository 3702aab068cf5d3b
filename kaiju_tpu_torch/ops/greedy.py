"""Greedy search: kernel E (``greedy_search``) and ``fused_greedy_classify``,
which runs B -> E -> F; and, for a group of processes on several hosts,
E split at its level boundaries, kernels U (``greedy_levels``) and X
(``greedy_variants_hosts``), with ``fused_greedy_classify_hosts``, which
runs O -> U -> (X in rounds -> U) a level -> V -> Q -> V, and with the
text-compare hybrid kernel Y (``hybrid.switch_hosts``) in rounds between
the last level's X and U.

``fused_greedy_classify`` returns what rows 0..B-1, columns 0-3, of
``kaiju_tpu.ops.fused_greedy.fused_greedy_classify`` hold: (lca, best,
flags, n_ids) per read, with the reference's Greedy semantics
(ConsumerThread.cpp:346-541, bwt.c:225-336).  E takes B's lanes (the
maximal backward extension of every end position j >= Lmap - 1) and, per
read:

  level 0   jstop (the highest j whose match reaches i <= 1), the eligible
            candidates (j >= jstop, length >= Lmap), the inserted-node rule
            (scanning j downward, a candidate is a node iff its i is below
            that of every higher-j candidate), node scores from the
            BLOSUM62 diagonal prefix sums, the read's best, and the planned
            nodes (length groups, longest first, up to and including the
            first group with more than one member);
  level k   the 19 substitutions at each source's qi - 1 in the
            reference's descending order, pruned at max(the read's best
            after level k - 1, min_score); each variant's UpdateSI probe
            and resumed extension; its score; the next level's sources;
  ties      every eval event that scores the read's final best (> 0), in
            the JAX order: level, then within level 0 the strip nodes
            (j >= flen - 4) before the others, each in fragment order then
            ascending j, and within a variant level the source order then
            the substitution's column.  The first T are kept;
            FLAG_TIE_OVER when there are more.

With the text-compare hybrid (an index with a text copy,
``ops/hybrid.py``), a variant of the last level whose probe interval holds
at most SW_WCAP occurrences, with letters left, finishes by text
comparison instead of FM steps (fused_greedy.py:488-505); a tie it makes
is a virtual row (VBASE + slot, VBASE + slot + n), slot = (b T + r) 8 for
tie r of read b, whose n ids sit in SA order in sw_ids [B, T, 8] (zeros
elsewhere).

F (``classify.ranges_lca``) resolves the kept ties to the LCA.  The JAX
program's capacities, compaction buffers, burn-in, windows and retry have
no counterpart.  A read keeps its sources of one level in VCAP slots of
scratch; a read whose sources outgrow them gets FLAG_SCRATCH (a flag of
the port's own) and a zero row, and is replayed on the host.  The
plain version applies the same limit, so kernel and plain agree bit for
bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..constants import AA_TO_INT, BLOSUM62, BLOSUM62_DIAG, BLOSUM_SUBST
from .classify import (FLAG_NEED_MORE, FLAG_TIE_OVER, lca_resolved,
                       ranges_lca, ranges_lca_list, walk_listed)
from .device_index import Q_RANK, Shards, rank, shard_args
from .hybrid import VBASE, switch_in_rounds, switch_plain
from .search import SW_WCAP, _lane_fragments, mem_extend, mem_extend_hosts

FLAG_SCRATCH = 4  # the read's sources outgrew VCAP (port only): replay
# more than one tie and the id cap may have cut the read's taxa: the result
# depends on the tie order, and the JAX order is not the reference's
# (ROADMAP.md queue 3), so the host replays the read (port only)
FLAG_TIE_ORDER = 8
STRIP = 4  # the JAX funnel's rightmost-W strip (W = 4): its nodes come first
QLCAP = 512  # the planned-node rule clamps lengths below this; the host
# replays reads with a fragment this long
NSUB = 19  # substitutions a position
MAX_S = 32  # slots a read: kernel E sorts a read's fragments in one warp
VCAP = 1024  # sources a read and level in kernel E's scratch
SRC_INTS = 8  # a source in E's scratch: fid qi effL s0 s1 delta diffc ml

def greedy_scoring_tables(alphabet: str, trans) -> tuple[np.ndarray, ...]:
    """Letter-code-indexed scoring tables: diag int32 [32], and per original
    code the 19 substitutions in the reference's descending-score order
    (ConsumerThread.cpp:346-395), int32 [32, 19] each: B62[orig, sub], the
    substituted letter code, diag[sub]."""
    diag = np.zeros(32, dtype=np.int32)
    submat = np.zeros((32, NSUB), dtype=np.int32)
    subcode = np.zeros((32, NSUB), dtype=np.int32)
    subdiag = np.zeros((32, NSUB), dtype=np.int32)
    for code, ch in enumerate(alphabet):
        if ch not in AA_TO_INT:
            continue
        oi = AA_TO_INT[ch]
        diag[code] = int(BLOSUM62_DIAG[oi])
        for s, sub in enumerate(BLOSUM_SUBST[ch]):
            bi = AA_TO_INT[sub]
            submat[code, s] = int(BLOSUM62[oi, bi])
            subcode[code, s] = int(trans[ord(sub)])
            subdiag[code, s] = int(BLOSUM62_DIAG[bi])
    return diag, submat, subcode, subdiag


# ---------------------------------------------------------------------------
# kernel E
# ---------------------------------------------------------------------------


def _resume(rec, C, flat, base, pos, code, start, n0, n1, act, touched):
    """Resumed backward extension (maxMatches_withStart, bwt.c:298-336)
    from (start, n0, n1), reading code `code` at position `pos`."""
    i, a0, a1 = start.clone(), n0.clone(), n1.clone()
    live = torch.nonzero(act & (start > 0)).squeeze(1)
    while live.numel():
        li = i[live]
        x = li - 1
        c = torch.where(x == pos[live], code[live],
                        flat[(base[live] + x).long()].to(torch.int32))
        m0 = rank(rec, C, c, a0[live], touched)
        m1 = rank(rec, C, c, a1[live], touched)
        ok = m0 < m1
        live = live[ok]
        a0[live] = m0[ok]
        a1[live] = m1[ok]
        i[live] = li[ok] - 1
        live = live[i[live] > 0]
    return i, a0, a1


def _level0(i, flat, frag_off, rf_rows, diag, Lmap, mfl, min_score):
    """Level 0 of E from B's lanes: the read of each fragment row (B: no
    read), the diagonal prefix sums (cum, flat layout, a leading 0), the
    fragments' starts, and the nodes in event order (the strip nodes
    first, each in fragment order then ascending j): their flat positions,
    fragments, reads, qi, effL, lengths, scores, eval events and planned
    flags."""
    dev = flat.device
    i32, i64 = torch.int32, torch.int64
    B, S = rf_rows.shape
    F = frag_off.shape[0] - 1
    P = flat.shape[0]
    frag_rid = torch.full((F,), B, dtype=i64, device=dev)
    sel = rf_rows >= 0
    frag_rid[rf_rows[sel].long()] = torch.arange(
        B, device=dev)[:, None].expand(B, S)[sel]
    cum = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                     torch.cumsum(diag[flat.long()], 0, dtype=i32)])
    start = frag_off.long()

    def pref(f, x):
        return cum[start[f] + x.long()] - cum[start[f]]

    pos, f, base, flen = _lane_fragments(frag_off, P)
    f = f.long()
    j = pos - base
    rid = frag_rid[f]
    valid = (j >= Lmap - 1) & (j < flen) & (rid < B)
    stop = valid & (i <= 1)
    jstop = torch.full((F,), -1, dtype=i32, device=dev)
    jstop.scatter_reduce_(0, f[stop], j[stop], "amax")
    elig = valid & (j >= jstop[f]) & (j - i + 1 >= Lmap)
    # min i over the eligible lanes of the same fragment at higher j: a
    # suffix minimum over keys that put each fragment above the previous
    # one, so that no fragment's minimum leaks into another
    W = P + 2
    key = f * W + torch.where(elig, i, P + 1).long()
    suf = torch.cummin(key.flip(0), 0).values.flip(0)
    above = torch.cat([suf[1:], suf.new_full((1,), (F + 1) * W)]) - f * W
    ins = elig & (i.long() < above)
    strip = j >= flen - STRIP
    nodes = torch.cat([torch.nonzero(ins & strip).squeeze(1),
                       torch.nonzero(ins & ~strip).squeeze(1)])
    n_f, n_rid, n_qi = f[nodes], rid[nodes], i[nodes]
    n_effL = j[nodes] + 1
    n_ql = n_effL - n_qi
    n_score = torch.clamp(pref(n_f, n_effL) - pref(n_f, n_qi), min=0)
    n_ev = (n_ql >= mfl) & (n_score >= min_score)
    gkey = n_f * QLCAP + torch.clamp(n_ql, max=QLCAP - 1)
    _u, inv, cnt = torch.unique(gkey, return_inverse=True, return_counts=True)
    multi = cnt[inv] >= 2
    ql_t = torch.full((F,), -1, dtype=i32, device=dev)
    ql_t.scatter_reduce_(0, n_f[multi], n_ql[multi], "amax")
    planned = n_ql >= ql_t[n_f]
    return (frag_rid, cum, start, pref, nodes, n_f, n_rid, n_qi, n_effL,
            n_ql, n_score, n_ev, planned)


def greedy_search_plain(i, s0, s1, flat, frag_off, rf_rows, rec, C, tables,
                        Lmap, mfl, min_score, mismatches, T, vcap=VCAP,
                        touched=None, hyb=None):
    """touched: None, or a list that receives the record rows read."""
    dev = flat.device
    i32 = torch.int32
    diag, submat, subcode, subdiag = tables
    B, S = rf_rows.shape
    P = flat.shape[0]
    best = torch.zeros(B + 1, dtype=i32, device=dev)  # row B: no read
    g_s0 = torch.zeros((B, T), dtype=i32, device=dev)
    g_s1 = torch.zeros((B, T), dtype=i32, device=dev)
    flags = torch.zeros(B, dtype=i32, device=dev)
    sw_ids = (torch.zeros((B, T, SW_WCAP), dtype=i32, device=dev)
              if hyb is not None else None)
    if B == 0 or P == 0:
        return best[:B], flags, g_s0, g_s1, _flat(sw_ids)

    # ---- level 0: candidates, inserted nodes, scores, planned nodes -----
    (_rid, _cum, start, pref, nodes, n_f, n_rid, n_qi, n_effL, n_ql, n_score,
     n_ev, planned) = _level0(i, flat, frag_off, rf_rows, diag, Lmap, mfl,
                              min_score)
    best.scatter_reduce_(0, n_rid, torch.where(n_ev, n_score, 0), "amax")
    # events: (read, s0, s1, eval, score, ids of a switched interval, how
    # many: 0 for an FM interval)
    no_ids = torch.zeros((nodes.shape[0], SW_WCAP), dtype=i32, device=dev)
    events = [(n_rid, s0[nodes], s1[nodes], n_ev, n_score, no_ids,
               torch.zeros_like(n_rid))]

    # ---- variant levels --------------------------------------------------
    over = torch.zeros(B + 1, dtype=torch.bool, device=dev)
    src = planned & (n_qi > 0) & (n_effL >= mfl)
    zero = torch.zeros_like(n_qi)
    fr = [t[src] for t in (n_f, n_rid, n_qi, n_effL, s0[nodes], s1[nodes],
                           zero, zero, n_ql)]
    if mismatches > 0:
        over |= torch.bincount(fr[1], minlength=B + 1) > vcap
    for level in range(1, mismatches + 1):
        last = level == mismatches
        sf, srid, sqi, seff, ss0, ss1, sdel, sdif, sml = fr
        el = (sqi > 0) & (seff >= mfl)
        origc = torch.where(
            el, flat[(start[sf] + sqi - 1).clamp(min=0)].long(), 0)
        whole = torch.clamp(pref(sf, seff) + sdel + sdif, min=0)
        basev = whole - diag[origc]
        thr = torch.clamp(best[srid], min=min_score)
        keep = el[:, None] & (basev[:, None] + submat[origc] >= thr[:, None])
        r, col = torch.nonzero(keep, as_tuple=True)  # source, then column
        vf, vrid, vqi, veff = sf[r], srid[r], sqi[r], seff[r]
        oc = origc[r]
        code = subcode[oc, col]
        vdif = sdif[r] + submat[oc, col] - subdiag[oc, col]
        vdel = sdel[r] + subdiag[oc, col] - diag[oc]
        ml1 = sml[r] + 1
        n0 = rank(rec, C, code, ss0[r], touched)
        n1 = rank(rec, C, code, ss1[r], touched)
        p_ok = n0 < n1
        v_start = veff - ml1
        sw = torch.zeros_like(p_ok)
        if last and hyb is not None:
            sw = p_ok & (n1 - n0 <= SW_WCAP) & (v_start > 0)
        i_end, r0, r1 = _resume(rec, C, flat, start[vf], vqi - 1, code,
                                v_start, n0, n1, p_ok & ~sw, touched)
        ids = torch.zeros((r.shape[0], SW_WCAP), dtype=i32, device=dev)
        nid = torch.zeros_like(vrid)
        if bool(sw.any()):
            text, rank_start, sa_seq, sa_off, nseq, chpt_exp = hyb
            st = v_start[sw]
            maxext, n_ach, sw_i = switch_plain(
                n0[sw], n1[sw], (start[vf[sw]] + st).to(i32), st, flat, text,
                rank_start, rec, C, sa_seq, sa_off, nseq, chpt_exp, touched)
            i_end[sw] = st - maxext
            ids[sw] = sw_i
            nid[sw] = n_ach.long()
        i_res = torch.where(p_ok, i_end, 1)
        vml = veff - i_res
        has_si = p_ok & (vml >= (mfl if last else ml1))
        score = torch.clamp(pref(vf, veff) - pref(vf, i_res) + vdel + vdif,
                            min=0)
        ev = has_si & (vml >= mfl) & (score >= min_score)
        best.scatter_reduce_(0, vrid, torch.where(ev, score, 0), "amax")
        events.append((vrid, r0, r1, ev, score, ids, nid))
        if last:
            break
        fr = [t[has_si] for t in (vf, vrid, i_res, veff, r0, r1, vdel, vdif,
                                  vml)]
        over |= torch.bincount(fr[1], minlength=B + 1) > vcap

    # ---- ties: the eval events at the read's final best, in order --------
    e_rid, e_s0, e_s1, e_ev, e_score, e_ids, e_nid = (
        torch.cat(c) for c in zip(*events))
    tie = e_ev & (e_score == best[e_rid]) & (e_score > 0)
    t_rid = e_rid[tie]
    order = torch.sort(t_rid, stable=True).indices
    t_rid, t_s0, t_s1 = t_rid[order], e_s0[tie][order], e_s1[tie][order]
    t_ids, t_nid = e_ids[tie][order], e_nid[tie][order]
    cnt = torch.bincount(t_rid, minlength=B + 1)
    rank_in_read = torch.arange(t_rid.shape[0], device=dev) - (
        torch.cumsum(cnt, 0) - cnt)[t_rid]
    k = rank_in_read < T
    t_rid, r_k = t_rid[k], rank_in_read[k]
    t_s0, t_s1, t_ids, t_nid = t_s0[k], t_s1[k], t_ids[k], t_nid[k]
    virt = t_nid > 0
    vrow = (VBASE + (t_rid * T + r_k) * SW_WCAP).to(i32)
    g_s0[t_rid, r_k] = torch.where(virt, vrow, t_s0)
    g_s1[t_rid, r_k] = torch.where(virt, vrow + t_nid.to(i32), t_s1)
    if sw_ids is not None:
        sw_ids[t_rid[virt], r_k[virt]] = t_ids[virt]
    flags = (cnt[:B] > T).to(i32) * FLAG_TIE_OVER
    over = over[:B]
    best = torch.where(over, 0, best[:B])
    flags = torch.where(over, FLAG_SCRATCH, flags)
    g_s0[over] = 0
    g_s1[over] = 0
    if sw_ids is not None:
        sw_ids[over] = 0
    return best, flags, g_s0, g_s1, _flat(sw_ids)


def _flat(sw_ids):
    return None if sw_ids is None else sw_ids.reshape(-1)


def greedy_search(i, s0, s1, flat, frag_off, rf_rows, rec, C, tables, Lmap,
                  mfl, min_score, mismatches, T, vcap=VCAP, hyb=None):
    """Per read: the best score (int32 [B]), flags (int32 [B]:
    FLAG_TIE_OVER, FLAG_SCRATCH) and the first T ties' SA ranges g_s0, g_s1
    (int32 [B, T], zeros past the last), from B's lanes (i, s0, s1 int32
    [P]), the flat codes (uint8 [P]), frag_off (int32 [F+1]), the slot
    table rf_rows (int32 [B, S], -1 = pad) and the scoring tables of
    greedy_scoring_tables; then sw_ids, int32 [B T 8], the ids of the
    virtual tie rows (None without hyb).  hyb: None, or the last level's
    text-compare hybrid (text, rank_start, sa_seq, sa_off, nseq,
    chpt_exp).  Kernel E (csrc/greedy_search.cu) for CUDA tensors (its
    sharded instantiation for a ``Shards`` rec, with the hybrid's SA
    samples and text in shards too), the plain version for CPU tensors."""
    if Lmap < 1 or mismatches < 0 or T < 1 or vcap < 1:
        raise ValueError("need Lmap >= 1, mismatches >= 0, T >= 1, vcap >= 1")
    B = rf_rows.shape[0]
    if hyb is not None and VBASE + B * T * SW_WCAP >= 1 << 31:
        raise ValueError(f"{B} reads of {T} ties: virtual rows pass 2^31")
    if flat.device.type == "cpu":
        return greedy_search_plain(i, s0, s1, flat, frag_off, rf_rows, rec, C,
                                   tables, Lmap, mfl, min_score, mismatches,
                                   T, vcap, hyb=hyb)
    dev = flat.device
    P = flat.shape[0]
    for t, what in ((i, "i"), (s0, "s0"), (s1, "s1")):
        kernels.check(t, what, torch.int32, dev, 1)
        if t.shape[0] != P:
            raise ValueError(f"{what}: {t.shape[0]} lanes, expected {P}")
    kernels.check(flat, "flat", torch.uint8, dev, 1)
    kernels.check(frag_off, "frag_off", torch.int32, dev, 1)
    kernels.check(rf_rows, "rf_rows", torch.int32, dev, 2)
    kernels.check(C, "C", torch.int32, dev, 1)
    _check_tables(tables, dev)
    B, S = rf_rows.shape
    if S > MAX_S:
        raise ValueError(f"rf_rows: {S} slots a read, at most {MAX_S}")
    F = frag_off.shape[0] - 1
    text, rank_start, sa_seq, sa_off, nseq, chpt_exp = (
        hyb if hyb is not None else (None, None, None, None, 0, 0))
    if hyb is not None:
        kernels.check(rank_start, "rank_start", torch.int32, dev, 1)
    sharded = isinstance(rec, Shards)
    if sharded:
        idx_args = shard_args(dev, rec, sa_seq, sa_off, text)
    else:
        kernels.check(rec, "rec", torch.int32, dev, 2)
        if hyb is not None:
            kernels.check(text, "text", torch.uint8, dev, 1)
            kernels.check(sa_seq, "sa_seq", torch.int32, dev, 1)
            kernels.check(sa_off, "sa_off", torch.int32, dev, 1)
        idx_args = (rec, rec.shape[0])
    sw_ids = (torch.zeros(B * T * SW_WCAP, dtype=torch.int32, device=dev)
              if hyb is not None else None)
    best = torch.empty(B, dtype=torch.int32, device=dev)
    flags = torch.empty(B, dtype=torch.int32, device=dev)
    g = torch.empty((2, B, T), dtype=torch.int32, device=dev)
    if B:
        node = torch.empty(P, dtype=torch.uint8, device=dev)
        pincl = torch.empty(P, dtype=torch.int32, device=dev)
        src = torch.empty((B, 2, vcap, SRC_INTS) if mismatches else (1,),
                          dtype=torch.int32, device=dev)
        common = (i, s0, s1, flat, frag_off, F, rf_rows, B, S, *idx_args, C,
                  *tables, Lmap, mfl, min_score, mismatches, T, vcap, node,
                  pincl, src, best, flags, g[0], g[1])
        if sharded:
            kernels.launch("greedy_search_sharded", *common, rank_start,
                           nseq, chpt_exp, sw_ids)
        else:
            kernels.launch("greedy_search", *common, text, rank_start, sa_seq,
                           sa_off, 0 if sa_seq is None else sa_seq.shape[0],
                           nseq, chpt_exp, sw_ids)
    return best, flags, g[0], g[1], sw_ids


def _check_tables(tables, dev):
    diag, submat, subcode, subdiag = tables
    kernels.check(diag, "diag", torch.int32, dev, 1)
    for t, what in ((submat, "submat"), (subcode, "subcode"),
                    (subdiag, "subdiag")):
        kernels.check(t, what, torch.int32, dev, 2)
        if t.shape != (32, NSUB):
            raise ValueError(f"{what}: shape {tuple(t.shape)}, expected (32, 19)")
    if diag.shape != (32,):
        raise ValueError(f"diag: shape {tuple(diag.shape)}, expected (32,)")


# ---------------------------------------------------------------------------
# kernels U and X: E split at its level boundaries, for a group of
# processes on several hosts
# ---------------------------------------------------------------------------

STATE_INTS = 4  # U's state a read: best, ties so far, sources, over
# a variant of U's list (X's input): code | pos << 8, s0, s1, base, need,
# delta, diffc, fid | effL << 8 (the source's interval, its fragment's
# start in flat, the substituted letter's position pos = qi - 1, and the
# fields of E's window slot: greedy_common.cuh, Variant)
VAR_INTS = 8


class LevelState(NamedTuple):
    """What kernel U keeps of a batch between its launches, every tensor
    updated in place: pincl int32 [P], each fragment's inclusive diagonal
    prefix sums (in flat layout); src int32 [B, 2, vcap, 8], the sources of
    a level and of the next (level k reads half (k - 1) & 1: fid qi effL
    s0 s1 delta diffc ml, fid the fragment's place among the read's
    fragment rows, ascending); state int32 [B, 4] = (best, ties so far,
    sources of the next level, over vcap); and the outputs best, flags
    int32 [B] and g_s0, g_s1 int32 [B, T] (the ties so far, the first T;
    zeros past the kept ones once the last level is settled)."""
    pincl: torch.Tensor
    src: torch.Tensor
    state: torch.Tensor
    best: torch.Tensor
    flags: torch.Tensor
    g_s0: torch.Tensor
    g_s1: torch.Tensor


def level_state(B, P, T, vcap, mismatches, dev) -> LevelState:
    """U's state of a batch of B reads and P flat positions, zeros."""
    z = torch.zeros
    i32 = torch.int32
    return LevelState(
        z(P, dtype=i32, device=dev),
        z((B, 2, vcap, SRC_INTS) if mismatches else (1,), dtype=i32,
          device=dev),
        z((B, STATE_INTS), dtype=i32, device=dev), z(B, dtype=i32, device=dev),
        z(B, dtype=i32, device=dev), z((B, T), dtype=i32, device=dev),
        z((B, T), dtype=i32, device=dev))


def _read_starts(frag_off, rf_rows):
    """Each read's fragment rows in ascending order, as their starts in flat
    (int64 [B, S], P past the read's rows), and each fragment row's place
    among its read's rows (int64 [F])."""
    F = frag_off.shape[0] - 1
    B, S = rf_rows.shape
    rows = torch.where(rf_rows >= 0, rf_rows.long(), F).sort(1).values
    place = torch.zeros(F + 1, dtype=torch.int64, device=rf_rows.device)
    place[rows] = torch.arange(S, device=rf_rows.device).expand(B, S)
    return frag_off.long()[rows], place[:F]


def _pref(pincl, base, x):
    """The diagonal sum over the first x codes of the fragment at base."""
    return torch.where(x > 0, pincl[(base + x - 1).clamp(min=0)], 0)


def _in_order(rid, B):
    """The order that groups events by read, keeping each read's events in
    order, and each event's rank among its read's (by that order)."""
    order = torch.sort(rid, stable=True).indices
    r = rid[order]
    cnt = torch.bincount(r, minlength=B)
    rank = torch.arange(r.shape[0], device=rid.device) - (
        torch.cumsum(cnt, 0) - cnt)[r]
    return order, r, rank, cnt


def _add_ties(st, rid, a0, a1, ev, score, T, nid=None, ids=None,
              sw_ids=None):
    """E's Ties.add over events in order (rid int64, reads < B): the read's
    running best, its ties so far, the first T rows; an event with nid > 0
    ids (ids int32 [n, SW_WCAP]) is a switched interval, whose tie r of
    read b becomes the virtual row (VBASE + (b T + r) 8, + nid) with its
    ids at sw_ids [B, T, SW_WCAP][b, r]."""
    B = st.state.shape[0]
    best = st.state[:, 0]
    m = torch.zeros(B, dtype=torch.int32, device=rid.device)
    m.scatter_reduce_(0, rid, torch.where(ev, score, 0), "amax")
    nb = torch.maximum(best, m)
    cnt = torch.where(nb > best, 0, st.state[:, 1])
    tie = ev & (score == nb[rid]) & (score > 0)
    order, t_rid, rank, n_t = _in_order(rid[tie], B)
    at = cnt[t_rid] + rank
    k = at < T
    r0, r1 = a0[tie][order], a1[tie][order]
    if nid is not None:
        tn = nid[tie][order]
        virt = tn > 0
        vrow = (VBASE + (t_rid * T + at) * SW_WCAP).to(torch.int32)
        r0 = torch.where(virt, vrow, r0)
        r1 = torch.where(virt, vrow + tn, r1)
        m = k & virt
        sw_ids[t_rid[m], at[m]] = ids[tie][order][m]
    st.g_s0[t_rid[k], at[k]] = r0[k]
    st.g_s1[t_rid[k], at[k]] = r1[k]
    st.state[:, 0] = nb
    st.state[:, 1] = cnt + n_t.to(torch.int32)


def _push_sources(st, half, rid, fields, vcap):
    """E's push_src over sources in order (rid int64, fields int32 [n, 8]):
    the first vcap of each read into src[:, half]; returns each read's
    count (int32 [B], which may pass vcap)."""
    B = st.state.shape[0]
    order, r, rank, cnt = _in_order(rid, B)
    k = rank < vcap
    st.src[r[k], half, rank[k]] = fields[order][k]
    return cnt.to(torch.int32)


def _finish(st, T, sw_ids=None):
    """E's last section: the read's row from its ties, zero past the kept
    ones; best 0, FLAG_SCRATCH and a zero row (no ids) for a read over
    vcap."""
    over = st.state[:, 3] != 0
    if sw_ids is not None:
        sw_ids[over] = 0
    cnt = st.state[:, 1]
    kept = torch.where(over, 0, torch.clamp(cnt, max=T))
    past = torch.arange(T, device=cnt.device)[None, :] >= kept[:, None]
    st.g_s0[past] = 0
    st.g_s1[past] = 0
    st.best.copy_(torch.where(over, 0, st.state[:, 0]))
    st.flags.copy_(torch.where(over, FLAG_SCRATCH,
                               torch.where(cnt > T, FLAG_TIE_OVER, 0)))


def greedy_levels_plain(form, level, flat, frag_off, rf_rows, tables, params,
                        st, lanes=None, voff=None, var=None, vout=None,
                        vnid=None, vids=None, sw_ids=None):
    """U's contract (greedy_levels) on CPU tensors."""
    Lmap, mfl, min_score, mismatches, T, vcap = params
    diag, submat, subcode, subdiag = tables
    dev = flat.device
    i32 = torch.int32
    B = rf_rows.shape[0]
    last = level == mismatches
    if form == 0:
        if B and flat.shape[0]:
            i, s0, s1 = lanes
            (frag_rid, cum, _start, _p, nodes, n_f, n_rid, n_qi, n_effL, n_ql,
             n_score, n_ev, planned) = _level0(i, flat, frag_off, rf_rows,
                                               diag, Lmap, mfl, min_score)
            _pos, f, base, _flen = _lane_fragments(frag_off, flat.shape[0])
            mine = frag_rid[f.long()] < B
            st.pincl[mine] = (cum[1:] - cum[base.long()])[mine]
            _add_ties(st, n_rid, s0[nodes], s1[nodes], n_ev, n_score, T)
            if mismatches > 0:
                src = planned & (n_qi > 0) & (n_effL >= mfl)
                place = _read_starts(frag_off, rf_rows)[1]
                zero = torch.zeros_like(n_qi)
                fields = torch.stack([place[n_f].to(i32), n_qi, n_effL,
                                      s0[nodes], s1[nodes], zero, zero, n_ql],
                                     1)[src]
                n = _push_sources(st, 0, n_rid[src], fields, vcap)
                st.state[:, 2] = n
                st.state[:, 3] = (n > vcap).to(i32)
        if mismatches == 0:
            _finish(st, T)
        return None
    starts = _read_starts(frag_off, rf_rows)[0]
    if form == 1:  # fan-out: each live source's kept substitutions
        half = (level - 1) & 1
        live = st.state[:, 3] == 0
        n = torch.where(live, st.state[:, 2], 0).clamp(max=vcap)
        rid, r = torch.nonzero(torch.arange(st.src.shape[2], device=dev)[None]
                               < n[:, None], as_tuple=True)
        e = st.src[rid, half, r]
        base = starts[rid, e[:, 0].long()]
        qi, effL = e[:, 1], e[:, 2]
        el = (qi > 0) & (effL >= mfl)
        oc = torch.where(el, flat[(base + qi - 1).clamp(min=0)].long() & 31, 0)
        basev = torch.clamp(_pref(st.pincl, base, effL) + e[:, 5] + e[:, 6],
                            min=0) - diag[oc]
        thr = torch.clamp(st.state[rid, 0], min=min_score)
        keep = el[:, None] & (basev[:, None] + submat[oc] >= thr[:, None])
        if voff is None:
            counts = torch.zeros(B, dtype=i32, device=dev)
            return counts.index_add_(0, rid, keep.sum(1, dtype=i32))
        s, col = torch.nonzero(keep, as_tuple=True)  # source, then column
        o = oc[s]
        need = (torch.full_like(qi[s], mfl) if last else e[s, 7] + 1)
        return torch.stack([
            subcode[o, col] | (qi[s] - 1) << 8, e[s, 3], e[s, 4],
            base[s].to(i32), need, e[s, 5] + subdiag[o, col] - diag[o],
            e[s, 6] + submat[o, col] - subdiag[o, col],
            e[s, 0] | effL[s] << 8], 1)
    # form 2, settle: the variants' results in list order (E's settle)
    rid = torch.repeat_interleave(torch.arange(B, device=dev),
                                  (voff[1:] - voff[:-1]).long())
    n0, n1, i = vout[:, 0], vout[:, 1], vout[:, 2]
    fid, veff = var[:, 7] & 255, var[:, 7] >> 8
    base = starts[rid, fid.long()]
    mlen = veff - i
    has_si = (n0 < n1) & (mlen >= var[:, 4])
    score = torch.where(has_si, torch.clamp(
        _pref(st.pincl, base, veff) - _pref(st.pincl, base, i) + var[:, 5]
        + var[:, 6], min=0), 0)
    ev = has_si & (mlen >= mfl) & (score >= min_score)
    sw = None if sw_ids is None else sw_ids.view(B, T, SW_WCAP)
    _add_ties(st, rid, n0, n1, ev, score, T, vnid, vids, sw)
    if last:
        _finish(st, T, sw)
        return None
    fields = torch.stack([fid, i, veff, n0, n1, var[:, 5], var[:, 6], mlen],
                         1)[has_si]
    n = _push_sources(st, level & 1, rid[has_si], fields, vcap)
    live = st.state[:, 3] == 0
    st.state[:, 2] = torch.where(live, n, st.state[:, 2])
    st.state[:, 3] = torch.where(live, (n > vcap).to(i32), st.state[:, 3])
    return None


def greedy_levels(form, level, flat, frag_off, rf_rows, tables, params, st,
                  lanes=None, voff=None, var=None, vout=None, vnid=None,
                  vids=None, sw_ids=None):
    """Kernel U (csrc/greedy_levels.cu): E's per-read work between its
    FM steps, a warp a read, on the batch's LevelState st (level_state),
    params = (Lmap, mfl, min_score, mismatches, T, vcap).

    form 0: E's level 0 from B's lanes = (i, s0, s1) int32 [P] (the node
    scan, the planned-node rule, node scores, level-0 events and ties, the
    level-1 sources with FLAG_SCRATCH past vcap); with mismatches 0 it
    writes the outputs.  Returns None.
    form 1, the fan-out of level `level`: each live source's kept
    substitutions, the 19 columns in the reference's descending order
    kept while the bound is >= max(best, min_score).  Without voff it
    returns each read's count (int32 [B]); with voff (int32 [B + 1], their
    scan) the variant list int32 [V, 8] (VAR_INTS), by read, then source,
    then column.
    form 2, the settle of level `level`: the variants' results, vout int32
    [V, 3] = (n0, n1, i) from X, read in list order: E's settle, ties,
    best and the next level's sources (FLAG_SCRATCH past vcap); at the
    last level the outputs.  With the hybrid (the last level only), vnid
    int32 [V] > 0 marks a variant that kernel Y finished, its ids in SA
    order at vids int32 [V, SW_WCAP]: its tie becomes a virtual row with
    the ids in sw_ids int32 [B T SW_WCAP] (zeros elsewhere), as in E.
    Returns None.
    Kernel U for CUDA tensors, the plain version for CPU tensors."""
    Lmap, mfl, min_score, mismatches, T, vcap = params
    if not 0 <= form <= 2 or (form and not 1 <= level <= mismatches):
        raise ValueError(f"form {form} at level {level} of {mismatches}")
    if Lmap < 1 or mismatches < 0 or T < 1 or vcap < 1:
        raise ValueError("need Lmap >= 1, mismatches >= 0, T >= 1, vcap >= 1")
    if (form == 0) != (lanes is not None) or (form == 2) != (
            var is not None) or (form == 2 and voff is None):
        raise ValueError("form 0 takes lanes, form 2 voff, var and vout")
    if (sw_ids is not None) != (vnid is not None) or (vnid is not None) != (
            vids is not None) or (sw_ids is not None and (
                form != 2 or level != mismatches)):
        raise ValueError("vnid, vids and sw_ids come together, at the last "
                         "level's settle")
    if flat.device.type == "cpu":
        return greedy_levels_plain(form, level, flat, frag_off, rf_rows,
                                   tables, params, st, lanes, voff, var, vout,
                                   vnid, vids, sw_ids)
    dev = flat.device
    B, S = rf_rows.shape
    P = flat.shape[0]
    kernels.check(flat, "flat", torch.uint8, dev, 1)
    kernels.check(frag_off, "frag_off", torch.int32, dev, 1)
    kernels.check(rf_rows, "rf_rows", torch.int32, dev, 2)
    if S > MAX_S:
        raise ValueError(f"rf_rows: {S} slots a read, at most {MAX_S}")
    _check_tables(tables, dev)
    for t, what in ((st.pincl, "pincl"), (st.src, "src"),
                    (st.state, "state"), (st.best, "best"),
                    (st.flags, "flags"), (st.g_s0, "g_s0"),
                    (st.g_s1, "g_s1")):
        kernels.check(t, what, torch.int32, dev)
    if (st.pincl.shape != (P,) or st.state.shape != (B, STATE_INTS)
            or st.g_s0.shape != (B, T) or (mismatches and st.src.shape != (
                B, 2, vcap, SRC_INTS))):
        raise ValueError("the level state does not fit the batch")
    if voff is not None:
        kernels.check(voff, "voff", torch.int32, dev, 1)
        if voff.shape != (B + 1,):
            raise ValueError(f"voff: {tuple(voff.shape)}, expected "
                             f"({B + 1},)")
    li = ls0 = ls1 = node = counts = out = None
    if form == 0:
        li, ls0, ls1 = lanes
        for t, what in ((li, "i"), (ls0, "s0"), (ls1, "s1")):
            kernels.check(t, what, torch.int32, dev, 1)
            if t.shape[0] != P:
                raise ValueError(f"{what}: {t.shape[0]} lanes, expected {P}")
        node = torch.empty(P, dtype=torch.uint8, device=dev)
    elif form == 1:
        if voff is None:
            out = counts = torch.empty(B, dtype=torch.int32, device=dev)
        else:
            out = var = torch.empty((int(voff[-1]), VAR_INTS),
                                    dtype=torch.int32, device=dev)
    else:
        kernels.check(var, "var", torch.int32, dev, 2)
        kernels.check(vout, "vout", torch.int32, dev, 2)
        if vout.shape != (var.shape[0], 3) or var.shape[1] != VAR_INTS:
            raise ValueError("var [V, 8] and vout [V, 3] expected")
        if sw_ids is not None:
            kernels.check(vnid, "vnid", torch.int32, dev, 1)
            kernels.check(vids, "vids", torch.int32, dev, 2)
            kernels.check(sw_ids, "sw_ids", torch.int32, dev, 1)
            if (vnid.shape != (var.shape[0],) or vids.shape != (
                    var.shape[0], SW_WCAP) or sw_ids.shape != (
                        B * T * SW_WCAP,)):
                raise ValueError("vnid [V], vids [V, 8], sw_ids [B T 8] "
                                 "expected")
    if B and (form != 1 or voff is None or var.shape[0]):
        kernels.launch("greedy_levels", form, level, li, ls0, ls1, flat,
                       frag_off, rf_rows, B, S, *tables, *params, node,
                       st.pincl, st.src, st.state, voff, counts, var, vout,
                       vnid, vids, sw_ids, st.best, st.flags, st.g_s0,
                       st.g_s1)
    return out


def greedy_variants_hosts_plain(rec, C, flat, var, out, parked=None,
                                answers=None, touched=None, sw=False):
    """touched: as for rank."""
    dev = flat.device
    i32 = torch.int32
    if parked is None:
        v = torch.arange(var.shape[0], dtype=torch.int64, device=dev)
        i = (var[:, 0] >> 8) + 1  # the probe: the step that reads pos
        a0, a1 = var[:, 1].clone(), var[:, 2].clone()
        n0 = n1 = None
    else:
        v = parked[:, 0].long()
        i, a0, a1 = (parked[:, t].clone() for t in (1, 2, 3))
        n0, n1 = answers[:, 0], answers[:, 1]
    code, pos, base = var[v, 0] & 255, var[v, 0] >> 8, var[v, 3].long()
    c32 = flat.to(i32)
    park, qry = [], []
    while v.numel():
        y = i - 1
        c = torch.where(y == pos, code, c32[(base + y).clamp(min=0)])
        if n0 is None:  # take the step on this host's rows, or park
            here = (rec.here[rec.owner(a0 >> 7)]
                    & rec.here[rec.owner(a1 >> 7)])
            stop = ~here
            park.append(torch.stack([v[stop].to(i32), i[stop], a0[stop],
                                     a1[stop]], 1))
            op = (Q_RANK << 8) | c[stop]
            qry.append(torch.stack([op, a0[stop], op, a1[stop]], 1))
            keep = here
            v, i, a0, a1, c = v[keep], i[keep], a0[keep], a1[keep], c[keep]
            y, code, pos, base = y[keep], code[keep], pos[keep], base[keep]
            n0 = rank(rec, C, c, a0, touched)
            n1 = rank(rec, C, c, a1, touched)
        # the probe takes its interval, empty or not; a resumed step only
        # a non-empty one (bwt.c:298-336)
        ok = n0 < n1
        take = ok | (y == pos)
        a0 = torch.where(take, n0, a0)
        a1 = torch.where(take, n1, a1)
        i = i - take.to(i32)
        done = ~ok | (i <= 0)
        if sw:  # the hybrid's narrow probes stop: kernel Y finishes them
            done |= (y == pos) & (a1 - a0 <= SW_WCAP)
        out[v[done]] = torch.stack([a0, a1, i], 1)[done]
        keep = ~done
        v, i, a0, a1 = v[keep], i[keep], a0[keep], a1[keep]
        code, pos, base = code[keep], pos[keep], base[keep]
        n0 = n1 = None
    z = torch.zeros((0, 4), dtype=i32, device=dev)
    return (torch.cat(park) if park else z,
            (torch.cat(qry) if qry else z).view(-1, 2, 2))


def greedy_variants_hosts(rec, C, flat, var, out, parked=None, answers=None,
                          sw=False):
    """Kernel X (csrc/greedy_variants.cu): the FM steps of a level's
    variants over the shards of a group on several hosts.  Each variant
    of the list var int32 [V, 8] (greedy_levels form 1) takes E's probe
    (the rank pair of its substituted letter at pos) and then E's resumed
    extension on the flat codes, on this host's rows; a step whose rank
    pair needs a remote row parks the variant.  The start form (parked
    None) runs every variant; the resume form takes the parked (v, i, s0,
    s1) int32 [L, 4] with their answers int32 [L, 2], applies each as the
    step, and goes on.  Both write out int32 [V, 3] = (n0, n1, i) of each
    variant that finishes (E's window slot before its settle) and return
    the variants parked now (int32 [L', 4]) with their queries int32
    [L', 2, 2], (Q_RANK c, s0) and (Q_RANK c, s1).  sw (the last level
    with the hybrid): a variant whose probe leaves 1 to SW_WCAP
    occurrences with pos > 0 letters before it stops after the probe, as
    E's last level switches it; its out row (n0, n1, pos) goes to kernel
    Y (``switched_variants``).  Kernel X for CUDA tensors, the plain
    version for CPU tensors."""
    if (parked is None) != (answers is None):
        raise ValueError("parked and answers come together (resume)")
    if flat.device.type == "cpu":
        return greedy_variants_hosts_plain(rec, C, flat, var, out, parked,
                                           answers, sw=sw)
    dev = flat.device
    args = shard_args(dev, rec, hosts=True)
    kernels.check(C, "C", torch.int32, dev, 1)
    kernels.check(flat, "flat", torch.uint8, dev, 1)
    kernels.check(var, "var", torch.int32, dev, 2)
    kernels.check(out, "out", torch.int32, dev, 2)
    V = var.shape[0]
    if var.shape[1] != VAR_INTS or out.shape != (V, 3):
        raise ValueError("var [V, 8] and out [V, 3] expected")
    if parked is None:
        n = V
    else:
        kernels.check(parked, "parked", torch.int32, dev, 2)
        kernels.check(answers, "answers", torch.int32, dev, 2)
        n = parked.shape[0]
        if parked.shape[1] != 4 or answers.shape != (n, 2):
            raise ValueError("parked [L, 4] and answers [L, 2] expected")
    park = torch.empty((n, 4), dtype=torch.int32, device=dev)
    q = torch.empty((n, 2, 2), dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    if n:
        kernels.launch("greedy_variants_hosts", *args, C, flat, var, V,
                       parked, answers, 0 if parked is None else n, int(sw),
                       out, park, q, count)
    k = int(count)
    return park[:k], q[:k]


def switched_variants(var, out):
    """The variants that X stopped with sw (int64 indices into var): the
    probe's interval holds 1 to SW_WCAP occurrences and the variant ended
    on it at i = pos > 0.  No variant ends there otherwise: with sw, a
    probe that leaves such an interval always stops, and one that leaves
    a wider interval ends below pos or on that wider interval."""
    pos = var[:, 0] >> 8
    n0, n1, i = out.unbind(1)
    return torch.nonzero((n0 < n1) & (n1 - n0 <= SW_WCAP) & (i == pos)
                         & (pos > 0)).squeeze(1)


def _switch_variants(sh, exchange, flat, var, out, rank_start):
    """The last level's switched variants finished by kernel Y in rounds
    (stages "switch" and "text"), as E's last level finishes them: each
    one's i = pos - maxext written into out, and (vnid int32 [V], vids
    int32 [V, SW_WCAP]) for U's settle."""
    v = switched_variants(var, out)
    pos = var[v, 0] >> 8
    maxext, n_ach, ids = switch_in_rounds(sh, exchange, out[v, 0], out[v, 1],
                                          var[v, 3] + pos, pos, flat,
                                          rank_start)
    out[v, 2] = pos - maxext
    V = var.shape[0]
    vnid = torch.zeros(V, dtype=torch.int32, device=flat.device)
    vids = torch.zeros((V, SW_WCAP), dtype=torch.int32, device=flat.device)
    vnid[v] = n_ach
    vids[v] = ids
    return vnid, vids


def greedy_search_hosts(sh, exchange, i, s0, s1, flat, frag_off, rf_rows,
                        tables, Lmap, mfl, min_score, mismatches, T,
                        vcap=VCAP, hyb=None):
    """greedy_search over a ``ShardedIndex`` of a group of processes on
    several hosts: U's level 0, then for each level U's fan-out, X in
    rounds of `exchange` (stage "variants", called once a level by every
    process, whether or not it has a variant parked) and U's settle.  With
    hyb (the hybrid's (text, rank_start)), X stops the last level's narrow
    probes and kernel Y finishes them in the rounds of stages "switch" and
    "text" before the settle, as E's last level does; the level-0 funnel
    never switches (kaiju_tpu/parallel/sharded_fused.py:347-349).  Returns
    greedy_search's (best, flags, g_s0, g_s1, sw_ids)."""
    params = (Lmap, mfl, min_score, mismatches, T, vcap)
    dev = flat.device
    B = rf_rows.shape[0]
    if hyb is not None and VBASE + B * T * SW_WCAP >= 1 << 31:
        raise ValueError(f"{B} reads of {T} ties: virtual rows pass 2^31")
    st = level_state(B, flat.shape[0], T, vcap, mismatches, dev)
    sw_ids = (torch.zeros(B * T * SW_WCAP, dtype=torch.int32, device=dev)
              if hyb is not None else None)
    common = (flat, frag_off, rf_rows, tables, params, st)
    greedy_levels(0, 0, *common, lanes=(i, s0, s1))
    for level in range(1, mismatches + 1):
        sw = hyb is not None and level == mismatches
        counts = greedy_levels(1, level, *common)
        voff = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                          torch.cumsum(counts, 0, dtype=torch.int32)])
        var = greedy_levels(1, level, *common, voff=voff)
        out = torch.empty((var.shape[0], 3), dtype=torch.int32, device=dev)
        parked, queries = greedy_variants_hosts(sh.rec, sh.C, flat, var, out,
                                                sw=sw)
        exchange.rounds("variants", parked, queries, 1, lambda pk, ans:
                        greedy_variants_hosts(sh.rec, sh.C, flat, var, out,
                                              parked=pk,
                                              answers=ans.reshape(-1, 2),
                                              sw=sw))
        vnid = vids = None
        if sw:
            vnid, vids = _switch_variants(sh, exchange, flat, var, out,
                                          hyb[1])
        greedy_levels(2, level, *common, voff=voff, var=var, vout=out,
                      vnid=vnid, vids=vids, sw_ids=sw_ids if sw else None)
    return st.best, st.flags, st.g_s0, st.g_s1, sw_ids


def fused_greedy_classify_hosts(sh, exchange, seed, flat, frag_off, rf_rows,
                                seq_tax, parent, depth, tables, K, Lmap, mfl,
                                min_score, mismatches, T, R, cap, vcap=VCAP,
                                bloom=None, hyb=None):
    """fused_greedy_classify over a ``ShardedIndex`` of a group of
    processes on several hosts (K16f across hosts): O extends at j0 =
    Lmap - 1 with the Lmap-mer screen (stage "extend"), U and X run the
    levels (greedy_search_hosts; with hyb, the hybrid's (text,
    rank_start), Y finishes the last level's narrow variants), V lists
    each read's positions (with the virtual rows' ids), Q walks the others
    (stage "walk") and W's resolved form (lca_resolved) finishes the
    reads.  Every process of the group calls it for every batch, with its
    share (none: empty tensors), since each round is a collective.
    Returns fused_greedy_classify's rows."""
    out, parked, queries = mem_extend_hosts(sh.rec, sh.C, *seed, flat,
                                            frag_off, K, Lmap - 1,
                                            bloom=bloom)
    exchange.rounds("extend", parked, queries, 1, lambda pk, ans:
                    mem_extend_hosts(sh.rec, sh.C, *seed, flat, frag_off, K,
                                     Lmap - 1, bloom=bloom, out=out,
                                     parked=pk,
                                     answers=ans.reshape(-1, 2))[1:])
    best, flags, g_s0, g_s1, sw_ids = greedy_search_hosts(
        sh, exchange, out[0], out[1], out[2], flat, frag_off, rf_rows,
        tables, Lmap, mfl, min_score, mismatches, T, vcap, hyb)
    pos, info, *virt = ranges_lca_list(g_s0, g_s1, R, sw_ids)
    seq = walk_listed(sh, exchange, pos, *virt)
    lca, n_ids, need_more, tie_order = lca_resolved(
        info, seq, seq_tax, parent, depth, R, cap, ranges=True)
    lca = torch.where(best > 0, lca, 0)
    flags = flags | need_more * FLAG_NEED_MORE | tie_order * FLAG_TIE_ORDER
    return torch.stack([lca, best, flags, n_ids], 1)


def fused_greedy_classify(rec, C, seed, flat, frag_off, rf_rows, sa_seq,
                          sa_off, seq_tax, parent, depth, tables, K, Lmap,
                          mfl, min_score, mismatches, T, R, cap, nseq,
                          chpt_exp, vcap=VCAP, bloom=None, hyb=None):
    """The whole Greedy batch, B -> E -> F: flat uint8 [P] fragment codes,
    frag_off int32 [F+1], rf_rows int32 [B, S] fragment row per (read,
    pop-order slot), seed = (s0, s1, d) K-mer tables, tables = the scoring
    tables (greedy_scoring_tables); bloom = None or B's screen (words, m,
    lb), m = Lmap; hyb = None or the last level's hybrid (text,
    rank_start).  Returns int32 [B, 4] rows (lca, best, flags, n_ids)."""
    i, s0, s1 = mem_extend(rec, C, *seed, flat, frag_off, K, Lmap - 1,
                           bloom=bloom)
    best, flags, g_s0, g_s1, sw_ids = greedy_search(
        i, s0, s1, flat, frag_off, rf_rows, rec, C, tables, Lmap, mfl,
        min_score, mismatches, T, vcap,
        hyb=None if hyb is None else (*hyb, sa_seq, sa_off, nseq, chpt_exp))
    lca, n_ids, need_more, tie_order = ranges_lca(
        g_s0, g_s1, rec, C, sa_seq, sa_off, seq_tax, parent, depth, R, cap,
        nseq, chpt_exp, sw_ids=sw_ids)
    lca = torch.where(best > 0, lca, 0)
    flags = flags | need_more * FLAG_NEED_MORE | tie_order * FLAG_TIE_ORDER
    return torch.stack([lca, best, flags, n_ids], 1)
