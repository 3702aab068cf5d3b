"""Greedy search: kernel E (``greedy_search``) and ``fused_greedy_classify``,
which runs B -> E -> F.

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

import numpy as np
import torch

from .. import kernels
from ..constants import AA_TO_INT, BLOSUM62, BLOSUM62_DIAG, BLOSUM_SUBST
from .classify import FLAG_NEED_MORE, FLAG_TIE_OVER, ranges_lca
from .device_index import Shards, rank, shard_args
from .hybrid import VBASE, switch_plain
from .search import SW_WCAP, _lane_fragments, mem_extend

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


def greedy_search_plain(i, s0, s1, flat, frag_off, rf_rows, rec, C, tables,
                        Lmap, mfl, min_score, mismatches, T, vcap=VCAP,
                        touched=None, hyb=None):
    """touched: None, or a list that receives the record rows read."""
    dev = flat.device
    i32, i64 = torch.int32, torch.int64
    diag, submat, subcode, subdiag = tables
    B, S = rf_rows.shape
    F = frag_off.shape[0] - 1
    P = flat.shape[0]
    best = torch.zeros(B + 1, dtype=i32, device=dev)  # row B: no read
    g_s0 = torch.zeros((B, T), dtype=i32, device=dev)
    g_s1 = torch.zeros((B, T), dtype=i32, device=dev)
    flags = torch.zeros(B, dtype=i32, device=dev)
    sw_ids = (torch.zeros((B, T, SW_WCAP), dtype=i32, device=dev)
              if hyb is not None else None)
    if B == 0 or P == 0:
        return best[:B], flags, g_s0, g_s1, _flat(sw_ids)

    # read of each fragment row (B: no read), diag prefix sums
    frag_rid = torch.full((F,), B, dtype=i64, device=dev)
    sel = rf_rows >= 0
    frag_rid[rf_rows[sel].long()] = torch.arange(
        B, device=dev)[:, None].expand(B, S)[sel]
    cum = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                     torch.cumsum(diag[flat.long()], 0, dtype=i32)])
    start = frag_off.long()

    def pref(f, x):
        return cum[start[f] + x.long()] - cum[start[f]]

    # ---- level 0: candidates, inserted nodes, scores, planned nodes -----
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
    best.scatter_reduce_(0, n_rid, torch.where(n_ev, n_score, 0), "amax")
    # events: (read, s0, s1, eval, score, ids of a switched interval, how
    # many: 0 for an FM interval)
    no_ids = torch.zeros((nodes.shape[0], SW_WCAP), dtype=i32, device=dev)
    events = [(n_rid, s0[nodes], s1[nodes], n_ev, n_score, no_ids,
               torch.zeros_like(n_rid))]

    gkey = n_f * QLCAP + torch.clamp(n_ql, max=QLCAP - 1)
    _u, inv, cnt = torch.unique(gkey, return_inverse=True, return_counts=True)
    multi = cnt[inv] >= 2
    ql_t = torch.full((F,), -1, dtype=i32, device=dev)
    ql_t.scatter_reduce_(0, n_f[multi], n_ql[multi], "amax")
    planned = n_ql >= ql_t[n_f]

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
    diag, submat, subcode, subdiag = tables
    kernels.check(diag, "diag", torch.int32, dev, 1)
    for t, what in ((submat, "submat"), (subcode, "subcode"),
                    (subdiag, "subdiag")):
        kernels.check(t, what, torch.int32, dev, 2)
        if t.shape != (32, NSUB):
            raise ValueError(f"{what}: shape {tuple(t.shape)}, expected (32, 19)")
    if diag.shape != (32,):
        raise ValueError(f"diag: shape {tuple(diag.shape)}, expected (32,)")
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
                  diag, submat, subcode, subdiag, Lmap, mfl, min_score,
                  mismatches, T, vcap, node, pincl, src, best, flags, g[0],
                  g[1])
        if sharded:
            kernels.launch("greedy_search_sharded", *common, rank_start,
                           nseq, chpt_exp, sw_ids)
        else:
            kernels.launch("greedy_search", *common, text, rank_start, sa_seq,
                           sa_off, 0 if sa_seq is None else sa_seq.shape[0],
                           nseq, chpt_exp, sw_ids)
    return best, flags, g[0], g[1], sw_ids


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
