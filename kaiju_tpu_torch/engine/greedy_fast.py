"""Greedy classification with verbose output (``kaiju -v``) on the
device: ``kaiju_tpu.engine.greedy_fast.GreedyFastPipeline``, whose host
logic is copied as it stands (it carries the reference's pop-order
fragment column); the device services run on the port's kernels.

The reference Greedy classifier is a per-read best-first branch-and-bound
search (reference: ConsumerThread.cpp:424-541): fragments are popped from
a score-ordered queue, exact-matched (maxMatches, bwt.c:261-296), their
matches spawn bounded substitution variants (addAllMismatchVariantsAtPosSI,
ConsumerThread.cpp:346-395) that resume extension (maxMatches_withStart,
bwt.c:298-336), and the running best score prunes both the queue and the
variant enumeration.

Batch strategy (exact by construction):

1. LEVEL-0 MAPS.  Kernel B extends every lane of every unique fragment
   of the batch (with its Bloom screen on an index with a text copy, no
   hybrid) and kernel K compacts the sparse maxMatches candidate map (all
   end positions with match length >= Lmap above the `i <= 1` stop); the
   host sorts the rows per fragment.

2. CO-SIMULATION ROUNDS.  A level-synchronized simulation runs every
   read's search with a LAGGING bound (the read's best score as of the
   previous round; the true best only rises, so every fragment/variant
   the reference touches is touched here too — a superset).  Each round
   issues ONE batched UpdateSI probe call (kernel A) and ONE batched
   resumed-extension call (kernel I) for all reads together, and records
   results in caches.
   Rounds terminate when no queue entry reaches its read's bound; the
   final best score equals the reference's (any extra evaluations score
   strictly below their upper bound < best_final and cannot raise it).

3. RESTRICTED EXACT REPLAY.  Per read, the reference algorithm is
   replayed exactly — priority queue, SEG splitting, best dynamics, tie
   caps — but entries whose score upper bound is below the known final
   best are discarded unprocessed: they cannot contribute a best-scoring
   match (their variants bound even lower), and pruning them cannot
   change the relative pop order of the surviving entries (multimap tie
   order is insertion order, which for survivors depends only on other
   survivors' pop events).  Every search/probe the replay performs hits
   the caches from step 2, so the replay is pure host logic (a miss
   goes to kernel A or I, one lane at a time).

4. Batched SA resolution through kernel H + LCA as in the MEM pipeline.

The JAX path's static-shape machinery (shape buckets, the map's lane and
row capacities and their retry) has no counterpart: B evaluates every lane,
K writes every row, and the kernels take any shape.
"""

from __future__ import annotations

import heapq
import math
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..constants import (
    AA_TO_INT,
    BLOSUM62,
    BLOSUM62_DIAG,
    BLOSUM_SUBST,
    LAMBDA,
    LN_2,
    LN_K,
)
from ..index.alphabet import trans_table
from ..index.core import KaijuIndex
from ..io.taxonomy import Taxonomy
from ..ops.device_index import extend_from, extend_rows, update_si
from ..ops.search import SEED_K, greedy_map, mem_extend
from .config import KaijuConfig
from .core import ClassifyResult
from .fragments_native import NativeFragmenter
from .mem_fast import SaResolveMixin, _flat_layout
from .pipeline import DeviceSetup
from .si import SI, insert_si_sorted, walk_group_heads

# host seconds of each stage of a batch, over all pipelines: fragmenting
# (with and without SEG), the level-0 maps (B -> K, their upload, launches
# and wait, and the node caches), the co-simulation and its backfill (A, I),
# the exact replay of each read with the E-value gate, resolving the ties
# to ids (H) and building the results
HOST_SECONDS = dict.fromkeys(
    ("fragment", "maps", "simulate", "replay", "resolve", "results"), 0.0)


def reset_counts() -> None:
    for k in HOST_SECONDS:
        HOST_SECONDS[k] = 0.0

@dataclass
class Entry:
    key: int
    seq: int
    frag: str
    num_mm: int = 0
    diff: int = 0
    si0: int = 0
    si1: int = 0
    matchlen: int = 0
    checked: bool = True

    def __lt__(self, other):  # heapq tiebreak never reaches here
        return self.seq < other.seq


class GreedyFastPipeline(SaResolveMixin, DeviceSetup):
    def __init__(
        self,
        index: KaijuIndex,
        taxonomy: Optional[Taxonomy],
        config: KaijuConfig,
        device=None,
        kmer_cache_dir: Optional[str] = None,
    ):
        if config.mode != "greedy" or config.taxonomy_free:
            raise ValueError("GreedyFastPipeline runs -a greedy")
        # the lowest end position evaluated is Lmap - 1, and the K-mer seed
        # may not reach below it; B's screen is built for m = Lmap
        self.lmap = min(config.seed_length, config.min_fragment_length)
        super().__init__(index, taxonomy, config, device, kmer_cache_dir,
                         min(SEED_K, config.seed_length, self.lmap),
                         self.lmap)
        self._trans = trans_table(index.alphabet)
        self._frag_seg = NativeFragmenter(
            "greedy", config.min_fragment_length, config.min_score,
            config.seg, config.input_is_protein,
        )
        self._frag_raw = NativeFragmenter(
            "greedy", config.min_fragment_length, config.min_score,
            False, config.input_is_protein,
        )
        if config.seg:
            from .seg_native import make_seg_filter

            self._seg = make_seg_filter()
            self._seg_cache: dict[str, list] = {}
        else:
            self._seg = None
        # diag-score prefix sums per fragment: score of frag[a:b] is
        # pref[b] - pref[a] (then clamped at 0 with diff added)
        self._pref: dict[str, np.ndarray] = {}
        self._diag_by_byte = np.zeros(256, dtype=np.int64)
        for aa, i in AA_TO_INT.items():
            self._diag_by_byte[ord(aa)] = int(BLOSUM62_DIAG[i])
        self._diag_by_byte[
            np.setdiff1d(np.arange(256), [ord(a) for a in AA_TO_INT])
        ] = int(BLOSUM62_DIAG[AA_TO_INT["A"]])
        # vectorized-planning tables, indexed [aa_idx, sub_slot 0..18] in
        # the reference's descending-score substitution order
        self._submat = np.zeros((20, 19), dtype=np.int64)   # B62[orig, sub]
        self._subdiag = np.zeros((20, 19), dtype=np.int64)  # diag[sub]
        self._subcode = np.zeros((20, 19), dtype=np.int32)  # index-alphabet code
        self._subchar = np.zeros((20, 19), dtype=np.uint8)  # ASCII
        for aa, oi in AA_TO_INT.items():
            for s, sub in enumerate(BLOSUM_SUBST[aa]):
                bi = AA_TO_INT[sub]
                self._submat[oi, s] = int(BLOSUM62[oi, bi])
                self._subdiag[oi, s] = int(BLOSUM62_DIAG[bi])
                self._subcode[oi, s] = int(self._trans[ord(sub)])
                self._subchar[oi, s] = ord(sub)
        self._diag20 = np.asarray(BLOSUM62_DIAG, dtype=np.int64)
        # index-alphabet code -> AA scoring index / diag value
        alpha = index.alphabet
        self._aaidx_by_code = np.zeros(max(32, len(alpha)), dtype=np.int32)
        self._diag_by_code = np.zeros(max(32, len(alpha)), dtype=np.int64)
        for code, ch in enumerate(alpha):
            i = AA_TO_INT.get(ch, 0)
            self._aaidx_by_code[code] = i
            self._diag_by_code[code] = int(BLOSUM62_DIAG[i])
        # cross-batch caches
        self._frag_ids: dict[str, int] = {}
        self._frags: list[str] = []
        self._gmaps: list = []  # uid -> (j desc, i, s0, s1) arrays
        self._mm_cache: list = []  # uid -> maxMatches SI list (or False)
        self._enc_np: list = []  # uid -> encoded codes (np.uint8)
        self._pref_np: list = []  # uid -> diag prefix sums (int64, len+1)
        self._nodes: list = []  # uid -> dict of inserted-node arrays
        self._uid_best: list = []  # uid -> max eval score of num_mm=0 nodes
        self._uvars: list = []  # uid -> dict of round-1 variant arrays
        self._ext_cache: dict[tuple, tuple] = {}
        self._probe_cache: dict[tuple, Optional[tuple]] = {}
        # generation flush (see mem_fast): drop all fragment-keyed memo
        # tables once the unique-fragment count passes the cap, only
        # between batches so outstanding uids stay valid
        self._cache_cap = int(os.environ.get("KAIJU_FRAG_CACHE_CAP", 1 << 18))
        self._inflight = 0

    # ------------------------------------------------------------------
    def _uid(self, frag: str) -> int:
        uid = self._frag_ids.get(frag)
        if uid is None:
            uid = len(self._frags)
            self._frag_ids[frag] = uid
            self._frags.append(frag)
            self._gmaps.append(None)
            self._mm_cache.append(None)
            self._enc_np.append(None)
            self._pref_np.append(None)
            self._nodes.append(None)
            self._uid_best.append(0)
            self._uvars.append(None)
        return uid

    # ---- level-0 sparse maps -----------------------------------------

    def _compute_maps(self, uids) -> None:
        """B -> K for every fragment of uids without a map, then the rows
        grouped per fragment in descending j."""
        todo = [u for u in dict.fromkeys(uids) if self._gmaps[u] is None]
        if not todo:
            return
        encoded = []
        for u in todo:
            raw = np.frombuffer(self._frags[u].encode("ascii"), dtype=np.uint8)
            encoded.append(self._trans[raw].astype(np.uint8))
        flat, frag_off = _flat_layout(encoded)
        frag_off_dev = self._put(frag_off)
        lanes = mem_extend(self.dev.rec, self.dev.C, *self._seed,
                           self._put(flat), frag_off_dev, self.seed_K,
                           self.lmap - 1, bloom=self._bloom)
        rows, n_rows = greedy_map(*lanes, frag_off_dev, self.lmap)
        rows = rows[: int(n_rows.item())].cpu().numpy()

        # group rows per fragment in descending j (reference scan order)
        order = np.lexsort((-rows[:, 1], rows[:, 0]))
        rows = rows[order]
        bounds = np.searchsorted(rows[:, 0], np.arange(len(todo) + 1))
        for fi, u in enumerate(todo):
            r = rows[bounds[fi] : bounds[fi + 1]]
            self._gmaps[u] = (r[:, 1], r[:, 2], r[:, 3], r[:, 4])
        self._build_node_caches(todo, encoded, rows, bounds)

    def _build_node_caches(self, todo, encoded, rows, bounds):
        """Vectorized per-fragment node set (the inserted maxMatches
        candidates: i < the exclusive running minimum of earlier i while
        scanning j descending — exactly bwt.c:261-296's `cur` containment
        rule) plus the fragment's num_mm=0 eval maximum and the full
        round-1 substitution-variant arrays at the min_score bound.

        Everything is computed in ONE pass over the concatenated row
        arrays (segmented Hillis-Steele scan for the running minimum);
        per-uid caches are views into the global arrays."""
        cfg = self.cfg
        BIG = np.int64(1 << 60)
        flen = np.zeros(len(todo), np.int64)
        for fi, u in enumerate(todo):
            enc = encoded[fi]
            self._enc_np[u] = enc
            pref = np.zeros(len(enc) + 1, dtype=np.int64)
            np.cumsum(self._diag_by_code[enc], out=pref[1:])
            self._pref_np[u] = pref
            flen[fi] = len(enc)

        nrows = len(rows)
        if nrows == 0:
            for u in todo:
                self._nodes[u] = None
                self._uid_best[u] = 0
                self._uvars[u] = None
            return
        fidc = rows[:, 0].astype(np.int64)
        j = rows[:, 1].astype(np.int64)
        i_arr = rows[:, 2].astype(np.int64)

        # segmented inclusive prefix-min of i, then shift by one row
        incl = i_arr.copy()
        off = 1
        while off < nrows:
            shifted = np.empty(nrows, np.int64)
            shifted[off:] = incl[:-off]
            shifted[:off] = BIG
            same = np.empty(nrows, bool)
            same[off:] = fidc[off:] == fidc[:-off]
            same[:off] = False
            np.minimum(incl, np.where(same, shifted, BIG), out=incl)
            off <<= 1
        excl = np.empty(nrows, np.int64)
        excl[1:] = incl[:-1]
        excl[0] = BIG
        first = np.empty(nrows, bool)
        first[0] = True
        first[1:] = fidc[1:] != fidc[:-1]
        excl[first] = BIG
        ins = i_arr < excl

        qi = i_arr[ins]
        ql = j[ins] - qi + 1
        s0 = rows[:, 3][ins].astype(np.int64)
        s1 = rows[:, 4][ins].astype(np.int64)
        nf = fidc[ins]
        # per-row gathers from the per-uid prefix sums via a flat table
        poff = np.zeros(len(todo) + 1, np.int64)
        np.cumsum(flen + 1, out=poff[1:])
        pref_flat = np.concatenate([self._pref_np[u] for u in todo])
        enc_flat = np.concatenate([encoded[fi] for fi in range(len(todo))]) \
            if len(todo) else np.zeros(0, np.uint8)
        eoff = np.zeros(len(todo) + 1, np.int64)
        np.cumsum(flen, out=eoff[1:])

        evald = pref_flat[poff[nf] + qi + ql] - pref_flat[poff[nf] + qi]
        effL = np.minimum(qi + ql, flen[nf])
        origi = np.where(
            qi > 0,
            self._aaidx_by_code[enc_flat[eoff[nf] + np.maximum(qi - 1, 0)]],
            -1,
        )

        nbounds = np.searchsorted(nf, np.arange(len(todo) + 1))
        # num_mm=0 eval maximum per fragment
        scv = np.where(
            (ql >= cfg.min_fragment_length), np.clip(evald, 0, None), -1
        )
        scv = np.where(scv >= cfg.min_score, scv, 0)
        ubest = np.zeros(len(todo), np.int64)
        np.maximum.at(ubest, nf, scv)

        # the reference enumerates substitutions only over
        # walk_group_heads' node set: length groups in descending order up
        # to AND INCLUDING the first group with more than one member
        # (reference: ConsumerThread.cpp:477's samelen-else-next walk over
        # the insert_si_sorted structure) — planning a superset would
        # create candidates outside the reference's search space whose
        # scores can exceed the true final best
        gorder = np.lexsort((-ql, nf))
        gf, gq = nf[gorder], ql[gorder]
        new_grp = np.empty(len(gorder), bool)
        new_grp[0] = True
        new_grp[1:] = (gf[1:] != gf[:-1]) | (gq[1:] != gq[:-1])
        grp_id = np.cumsum(new_grp) - 1
        grp_sz = np.bincount(grp_id)
        # group index within its fragment
        frag_first = np.empty(len(gorder), bool)
        frag_first[0] = True
        frag_first[1:] = gf[1:] != gf[:-1]
        gi_abs = np.arange(len(gorder))
        frag_base = np.maximum.accumulate(np.where(frag_first, gi_abs, 0))
        grp_base = np.maximum.accumulate(np.where(new_grp, gi_abs, 0))
        grp_in_frag = grp_id - grp_id[frag_base]
        multi = grp_sz[grp_id] > 1
        # first multi group index per fragment (inf when none)
        first_multi = np.full(len(todo), 1 << 30, np.int64)
        np.minimum.at(
            first_multi, gf[multi], grp_in_frag[multi]
        )
        planned_sorted = grp_in_frag <= first_multi[gf]
        planned = np.empty(len(gorder), bool)
        planned[gorder] = planned_sorted

        # round-1 variants at the global min_score bound
        el = planned & (origi >= 0) & (qi + ql >= cfg.min_fragment_length)
        ei = np.flatnonzero(el)
        if len(ei) and cfg.mismatches > 0:
            nori = origi[ei]
            base = (
                np.clip(pref_flat[poff[nf[ei]] + effL[ei]], 0, None)
                - self._diag20[nori]
            )
            sa = base[:, None] + self._submat[nori]
            keep = sa >= cfg.min_score
            mi, si = np.nonzero(keep)
            vf = nf[ei[mi]]
            vars_all = dict(
                key=sa[mi, si],
                code=self._subcode[nori[mi], si].astype(np.int64),
                ps0=s0[ei[mi]], ps1=s1[ei[mi]],
                pos=qi[ei[mi]] - 1,
                diffc=self._submat[nori[mi], si]
                - self._subdiag[nori[mi], si],
                delta=self._subdiag[nori[mi], si] - self._diag20[nori[mi]],
                matchlen=ql[ei[mi]] + 1,
                effL=effL[ei[mi]],
                subch=self._subchar[nori[mi], si],
            )
            vorder = np.argsort(vf, kind="stable")
            vf = vf[vorder]
            vars_all = {c: v[vorder] for c, v in vars_all.items()}
            vbounds = np.searchsorted(vf, np.arange(len(todo) + 1))
        else:
            vars_all = None
            vbounds = None

        for fi, u in enumerate(todo):
            lo, hi = nbounds[fi], nbounds[fi + 1]
            if lo == hi:
                self._nodes[u] = None
                self._uid_best[u] = 0
                self._uvars[u] = None
                continue
            self._nodes[u] = dict(
                qi=qi[lo:hi], ql=ql[lo:hi], s0=s0[lo:hi], s1=s1[lo:hi],
                evald=evald[lo:hi], effL=effL[lo:hi], origi=origi[lo:hi],
            )
            self._uid_best[u] = int(ubest[fi])
            if vars_all is None or vbounds[fi] == vbounds[fi + 1]:
                self._uvars[u] = None
            else:
                a, b = vbounds[fi], vbounds[fi + 1]
                self._uvars[u] = {c: v[a:b] for c, v in vars_all.items()}

    def _max_matches(self, uid: int) -> Optional[SI]:
        """maxMatches(frag, seed_length, 0) from the sparse map, cached
        (reference: bwt.c:261-296; SI nodes are immutable after build)."""
        res = self._mm_cache[uid]
        if res is None:
            js, i_arr, s0, s1 = self._gmaps[uid]
            first: Optional[SI] = None
            cur: Optional[SI] = None
            for t in range(len(js)):
                i = int(i_arr[t])
                if cur is None or i < cur.qi:
                    cur = SI(int(s0[t]), int(s1[t]) - int(s0[t]), i,
                             int(js[t]) - i + 1)
                    first = insert_si_sorted(first, cur)
            res = first if first is not None else False
            self._mm_cache[uid] = res
        return res if res is not False else None

    # ---- variant planning (reference: ConsumerThread.cpp:346-395) ----

    def _frag_pref(self, frag: str) -> np.ndarray:
        pref = self._pref.get(frag)
        if pref is None:
            raw = np.frombuffer(frag.encode("ascii"), dtype=np.uint8)
            pref = np.concatenate(
                [[0], np.cumsum(self._diag_by_byte[raw])]
            )
            self._pref[frag] = pref
        return pref

    def _score(self, frag: str, start: int, length: int, diff: int) -> int:
        """calcScore via prefix sums (reference: ConsumerThread.cpp:397-404)."""
        pref = self._frag_pref(frag)
        s = diff + int(pref[start + length]) - int(pref[start])
        return s if s > 0 else 0

    def _plan_variants(self, e: Entry, pos, erase_pos, si: SI, bound,
                       plan, probes):
        cfg = self.cfg
        fragment = e.frag
        if erase_pos is not None and erase_pos < len(fragment):
            fragment = fragment[:erase_pos]
        orig = fragment[pos]
        oi = AA_TO_INT[orig]
        pref = self._frag_pref(e.frag)
        whole = e.diff + int(pref[len(fragment)])
        base = (whole if whole > 0 else 0) - int(BLOSUM62_DIAG[oi])
        for sub in BLOSUM_SUBST[orig]:
            bi = AA_TO_INT[sub]
            score_after = base + int(BLOSUM62[oi, bi])
            if score_after >= bound and score_after >= cfg.min_score:
                code = int(self._trans[ord(sub)])
                new_seq = fragment[:pos] + sub + fragment[pos + 1 :]
                diff = int(BLOSUM62[oi, bi]) - int(BLOSUM62_DIAG[bi])
                plan.append(
                    (new_seq, score_after, e.num_mm + 1, e.diff + diff,
                     si.ql + 1)
                )
                probes.append((code, si.start, si.start + si.len))
            else:
                break

    def _plan_for_entry(self, e: Entry, si: SI, bound, plan, probes):
        cfg = self.cfg
        length = len(e.frag)
        for node in walk_group_heads(si):
            right_end = node.qi + node.ql - 1
            if node.qi > 0 and right_end + 1 >= cfg.min_fragment_length:
                erase = right_end + 1 if right_end < length - 1 else None
                self._plan_variants(e, node.qi - 1, erase, node, bound,
                                    plan, probes)

    # ---- eval --------------------------------------------------------

    def _sim_best(self, si: Optional[SI], e: Entry, best: int) -> int:
        """Max achievable eval score of the SI tree (same node set as
        eval_match_scores, ConsumerThread.cpp:751-797, scores only)."""
        if si is None:
            return best
        cfg = self.cfg
        if si.samelen is not None:
            best = self._sim_best(si.samelen, e, best)
        if si.next is not None and si.next.ql >= cfg.min_fragment_length:
            best = self._sim_best(si.next, e, best)
        score = self._score(e.frag, si.qi, si.ql, e.diff)
        if score >= cfg.min_score and score > best:
            best = score
        return best

    def _eval_exact(self, si, e: Entry, best, best_sis, best_frags):
        """eval_match_scores (reference: ConsumerThread.cpp:751-797)."""
        if si is None:
            return best
        cfg = self.cfg
        if si.samelen is not None:
            best = self._eval_exact(si.samelen, e, best, best_sis, best_frags)
        if si.next is not None and si.next.ql >= cfg.min_fragment_length:
            best = self._eval_exact(si.next, e, best, best_sis, best_frags)
        score = self._score(e.frag, si.qi, si.ql, e.diff)
        if score < cfg.min_score:
            return best
        if score > best:
            best_sis.clear()
            best_frags.clear()
            best_sis.append(si)
            if cfg.verbose:
                best_frags.append(e.frag[si.qi : si.qi + si.ql])
            return score
        if score == best and len(best_sis) < cfg.max_matches_SI:
            best_sis.append(si)
            if cfg.verbose:
                best_frags.append(e.frag[si.qi : si.qi + si.ql])
        return best

    # ---- batched device services -------------------------------------

    def _serve_extends(self, lanes) -> None:
        """lanes: list of (frag, si0, si1, matchlen) cache keys; one launch
        of kernel I over the fragments' code rows."""
        todo = [k for k in dict.fromkeys(lanes) if k not in self._ext_cache]
        if not todo:
            return
        N = len(todo)
        L = max(len(k[0]) for k in todo)
        codes = np.zeros((N, L), dtype=np.uint8)
        start_i = np.zeros(N, dtype=np.int32)
        s0 = np.zeros(N, dtype=np.int32)
        s1 = np.zeros(N, dtype=np.int32)
        for t, (frag, a, b, ml) in enumerate(todo):
            raw = np.frombuffer(frag.encode("ascii"), dtype=np.uint8)
            e = self._trans[raw].astype(np.uint8)
            codes[t, : len(e)] = e
            start_i[t] = len(e) - ml
            s0[t] = a
            s1[t] = b
        fi, f0, f1 = (
            x.tolist()
            for x in extend_rows(
                self.dev.rec, self.dev.C, self._put(codes), self._put(start_i),
                self._put(s0), self._put(s1), self._put(np.ones(N, bool)),
            )
        )
        for t, k in enumerate(todo):
            self._ext_cache[k] = (fi[t], f0[t], f1[t])

    def _serve_probes(self, probes) -> None:
        """One launch of kernel A for the probes not in the cache."""
        todo = [p for p in dict.fromkeys(probes) if p not in self._probe_cache]
        if not todo:
            return
        c, s0, s1 = (self._put(np.asarray(col, dtype=np.int32))
                     for col in zip(*todo))
        n0, n1, ok = (x.tolist() for x in update_si(self.dev.rec, self.dev.C,
                                                    c, s0, s1))
        for t, p in enumerate(todo):
            self._probe_cache[p] = (n0[t], n1[t]) if ok[t] else None

    def _resume_si(self, e: Entry) -> Optional[SI]:
        cfg = self.cfg
        L = (
            cfg.min_fragment_length
            if e.num_mm == cfg.mismatches
            else e.matchlen
        )
        i, s0, s1 = self._ext_cache[(e.frag, e.si0, e.si1, e.matchlen)]
        ml = len(e.frag) - i
        if ml >= L:
            return SI(s0, s1 - s0, i, ml)
        return None

    # ---- co-simulation ------------------------------------------------

    def _probe_batch(self, code, ps0, ps1):
        """Unique-probe device round (kernel A): (n0, n1, ok) per row."""
        keys = np.stack([code.astype(np.int64), ps0, ps1], axis=1)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        c, a, b = (self._put(uniq[:, t].astype(np.int32)) for t in range(3))
        n0, n1, ok = (x.cpu().numpy()
                      for x in update_si(self.dev.rec, self.dev.C, c, a, b))
        return n0[inv], n1[inv], ok[inv] & (uniq[inv, 1] < uniq[inv, 2])

    def _extend_batch(self, flat_dev, base, pos, subcode, start_i, s0, s1):
        """Batched variant extension via the flat parent-code array
        (kernel I)."""
        args = (self._put(np.asarray(v, dtype=np.int32))
                for v in (base, pos, subcode, start_i, s0, s1))
        act = self._put(np.ones(len(base), bool))
        i, r0, r1 = (x.cpu().numpy() for x in extend_from(
            self.dev.rec, self.dev.C, flat_dev, *args, act))
        return i, r0, r1

    def _simulate(self, orders, keys_of):
        """Vectorized level-synchronized co-simulation.

        Computes per-read best_final (== the reference's final best
        score: every entry the reference evaluates is evaluated here, and
        extra evaluations score below their upper bound so they cannot
        raise the maximum).  Probes and resumed extensions are pure
        functions of (fragment, node, substitution chain), so all rows
        are deduplicated at the VARIANT level across reads; per-read
        state is only the running best.  Returns (best, records) where
        records back-fill the replay caches."""
        cfg = self.cfg
        n = len(orders)
        best = np.zeros(n, dtype=np.int64)
        for r, order in enumerate(orders):
            m = 0
            for uid in order:
                ub = self._uid_best[uid]
                if ub > m:
                    m = ub
            best[r] = m
        if cfg.mismatches <= 0:
            return best, []

        # uid universe of this batch + flat device codes + flat pref sums
        uid_set = sorted({u for o in orders for u in o})
        uid_pos = {u: t for t, u in enumerate(uid_set)}
        base_of = np.zeros(len(uid_set), np.int64)
        poff = np.zeros(len(uid_set), np.int64)
        total = 0
        ptotal = 0
        for t, u in enumerate(uid_set):
            base_of[t] = total
            poff[t] = ptotal
            total += len(self._enc_np[u])
            ptotal += len(self._enc_np[u]) + 1
        flat = np.zeros(max(total, 1), np.uint8)
        pref_flat = np.zeros(ptotal, np.int64)
        for t, u in enumerate(uid_set):
            e = self._enc_np[u]
            flat[base_of[t] : base_of[t] + len(e)] = e
            pref_flat[poff[t] : poff[t] + len(e) + 1] = self._pref_np[u]
        flat_dev = self._put(flat)

        # reads containing each uid (for thresholds + best updates)
        uid_reads: list[list[int]] = [[] for _ in uid_set]
        for r, order in enumerate(orders):
            for uid in set(order):
                uid_reads[uid_pos[uid]].append(r)

        def thresholds():
            thr = np.full(len(uid_set), 1 << 60, dtype=np.int64)
            for t, rs in enumerate(uid_reads):
                m = min(best[r] for r in rs)
                thr[t] = max(m, cfg.min_score)
            return thr

        # round-1 variant rows (uid-level)
        cols = ["key", "code", "ps0", "ps1", "pos", "diffc", "delta",
                "matchlen", "effL", "subch"]
        rows = {c: [] for c in cols}
        rows["uidt"] = []
        for u in uid_set:
            v = self._uvars[u]
            if v is None:
                continue
            m = len(v["key"])
            for c in cols:
                rows[c].append(v[c])
            rows["uidt"].append(np.full(m, uid_pos[u], np.int64))
        if not rows["key"]:
            return best, ([], uid_set, base_of)
        cur = {c: np.concatenate(rows[c]) for c in rows}
        m1 = len(cur["key"])
        cur["num_mm"] = np.ones(m1, np.int64)
        cur["parent_rec"] = np.full(m1, -1, np.int64)
        cur["parent_row"] = np.full(m1, -1, np.int64)

        records = []
        while True:
            thr = thresholds()
            act = cur["key"] >= thr[cur["uidt"]]
            if not act.any():
                break
            sub = {c: cur[c][act] for c in cur}
            n0, n1, ok = self._probe_batch(
                sub["code"], sub["ps0"], sub["ps1"]
            )
            okp = np.flatnonzero(ok)
            rec = {c: sub[c] for c in sub}
            rec["n0"], rec["n1"], rec["ok"] = n0, n1, ok
            if len(okp) == 0:
                records.append(rec)
                break
            g = {c: sub[c][okp] for c in sub}
            gi = n0[okp]
            gs1 = n1[okp]
            start_i = g["effL"] - g["matchlen"]
            i_res, r0, r1 = self._extend_batch(
                flat_dev, base_of[g["uidt"]], g["pos"], g["code"],
                start_i.astype(np.int64), gi, gs1,
            )
            rec["ext_rows"] = okp
            rec["i_res"], rec["r0"], rec["r1"] = i_res, r0, r1
            records.append(rec)

            ml = g["effL"] - i_res
            L_req = np.where(
                g["num_mm"] == cfg.mismatches, cfg.min_fragment_length,
                g["matchlen"],
            )
            has_si = ml >= L_req
            # eval: clamp(pref[effL]-pref[i_res]+delta+diffc)
            prefs_hi = pref_flat[poff[g["uidt"]] + g["effL"]]
            prefs_lo = pref_flat[poff[g["uidt"]] + i_res]
            score = np.clip(
                prefs_hi - prefs_lo + g["delta"] + g["diffc"], 0, None
            )
            evalok = has_si & (ml >= cfg.min_fragment_length) & (
                score >= cfg.min_score
            )
            if evalok.any():
                uval = np.zeros(len(uid_set), np.int64)
                np.maximum.at(uval, g["uidt"][evalok], score[evalok])
                for t in np.flatnonzero(uval):
                    for r in uid_reads[t]:
                        if uval[t] > best[r]:
                            best[r] = uval[t]
            # next-round variants
            nxt_mask = has_si & (g["num_mm"] < cfg.mismatches)
            if not nxt_mask.any():
                break
            w = np.flatnonzero(nxt_mask)
            qi = i_res[w].astype(np.int64)
            eff = g["effL"][w]
            el = (qi > 0) & (eff >= cfg.min_fragment_length)
            w = w[el]
            if len(w) == 0:
                break
            qi = qi[el]
            eff = g["effL"][w]
            uidt = g["uidt"][w]
            origc = flat[base_of[uidt] + qi - 1].astype(np.int64)
            ori = self._aaidx_by_code[origc]
            pref_eff = pref_flat[poff[uidt] + eff]
            basev = (
                np.clip(pref_eff + g["delta"][w] + g["diffc"][w], 0, None)
                - self._diag20[ori]
            )
            sa = basev[:, None] + self._submat[ori]
            keep = sa >= np.maximum(thr[uidt], cfg.min_score)[:, None]
            mi, si_ = np.nonzero(keep)
            if len(mi) == 0:
                break
            cur = dict(
                key=sa[mi, si_],
                code=self._subcode[ori[mi], si_].astype(np.int64),
                ps0=r0[w[mi]].astype(np.int64),
                ps1=r1[w[mi]].astype(np.int64),
                pos=qi[mi] - 1,
                diffc=g["diffc"][w[mi]]
                + self._submat[ori[mi], si_]
                - self._subdiag[ori[mi], si_],
                delta=g["delta"][w[mi]]
                + self._subdiag[ori[mi], si_]
                - self._diag20[ori[mi]],
                matchlen=(eff[mi] - qi[mi]) + 1,
                effL=eff[mi],
                uidt=uidt[mi],
                subch=self._subchar[ori[mi], si_],
                parent_rec=np.full(len(mi), len(records) - 1, np.int64),
                parent_row=okp[w[mi]].astype(np.int64),
                num_mm=g["num_mm"][w[mi]] + 1,
            )
        return best, (records, uid_set, base_of)

    def _backfill(self, simrec, orders, best_final):
        """Populate the probe/extension caches with exactly the rows the
        restricted replay can touch: variants whose score upper bound
        reaches the final best of SOME classified read containing their
        root fragment."""
        records, uid_set, base_of = simrec if simrec else ([], [], None)
        if not records:
            return
        need = {}
        for r, order in enumerate(orders):
            if best_final[r] <= 0:
                continue
            for uid in set(order):
                cur = need.get(uid)
                if cur is None or best_final[r] < cur:
                    need[uid] = int(best_final[r])
        if not need:
            return
        needv = np.full(len(uid_set), 1 << 60, dtype=np.int64)
        for t, u in enumerate(uid_set):
            if u in need:
                needv[t] = need[u]

        def chain_seq(rec_i, row):
            """(root uid index, [(pos, subch)...]) up the parent chain."""
            subs = []
            while True:
                rec = records[rec_i] if rec_i >= 0 else None
                if rec is None:
                    break
                subs.append((int(rec["pos"][row]), int(rec["subch"][row])))
                uidt = int(rec["uidt"][row])
                pr, pw = int(rec["parent_rec"][row]), int(
                    rec["parent_row"][row]
                )
                if pr < 0:
                    return uidt, subs
                rec_i, row = pr, pw
            return None, subs

        for rec_i, rec in enumerate(records):
            sel = np.flatnonzero(rec["key"] >= needv[rec["uidt"]])
            if len(sel) == 0:
                continue
            ext_pos = {int(x): t for t, x in
                       enumerate(rec.get("ext_rows", []))}
            for x in sel:
                x = int(x)
                pk = (int(rec["code"][x]), int(rec["ps0"][x]),
                      int(rec["ps1"][x]))
                if rec["ok"][x]:
                    n0, n1 = int(rec["n0"][x]), int(rec["n1"][x])
                    self._probe_cache[pk] = (n0, n1)
                    t = ext_pos.get(x)
                    if t is not None:
                        uidt, subs = chain_seq(rec_i, x)
                        frag = self._frags[uid_set[uidt]]
                        effL = int(rec["effL"][x])
                        sq = list(frag[:effL])
                        for pos, ch in subs:
                            sq[pos] = chr(ch)
                        new_seq = "".join(sq)
                        self._ext_cache[
                            (new_seq, n0, n1, int(rec["matchlen"][x]))
                        ] = (
                            int(rec["i_res"][t]),
                            int(rec["r0"][t]),
                            int(rec["r1"][t]),
                        )
                else:
                    self._probe_cache[pk] = None

    # ---- restricted exact replay --------------------------------------

    def _seg_intervals(self, frag: str):
        ivs = self._seg_cache.get(frag)
        if ivs is None:
            ivs = self._seg.mask_intervals(frag)
            self._seg_cache[frag] = ivs
        return ivs

    def _replay(self, raw_uids, keys_of, best_final):
        """Exact reference replay restricted to entries whose upper bound
        reaches best_final (reference: ConsumerThread.cpp:424-541)."""
        cfg = self.cfg
        heap: list[tuple[int, int, Entry]] = []
        seq = 0
        for uid in raw_uids:
            e = Entry(key=keys_of[uid], seq=seq, frag=self._frags[uid],
                      checked=not cfg.seg)
            heap.append((-e.key, seq, e))
            seq += 1
        heapq.heapify(heap)
        best = 0
        best_sis: list[SI] = []
        best_frags: list[str] = []
        while heap:
            key = -heap[0][0]
            if key < best:
                break
            _, _, e = heapq.heappop(heap)
            if key < best_final:
                continue  # cannot contribute; removal is order-invisible
            if not e.checked:
                locs = self._seg_intervals(e.frag)
                if locs:
                    start = 0
                    for left, right in locs:
                        seq = self._requeue(heap, e.frag, start,
                                            left - start, seq)
                        start = right + 1
                    seq = self._requeue(heap, e.frag, start,
                                        len(e.frag) - start, seq)
                    continue
            if e.num_mm == 0:
                si = self._max_matches(self._frag_ids[e.frag])
            else:
                si = self._resume_si(e)
            if si is None:
                continue
            if cfg.mismatches > 0 and e.num_mm < cfg.mismatches:
                plan: list = []
                probes: list = []
                self._plan_for_entry(
                    e, si, max(best, cfg.min_score), plan, probes
                )
                for (new_seq, score_after, num_mm, diff, ql), probe in zip(
                    plan, probes
                ):
                    if score_after < best_final:
                        continue  # non-contributor subtree; cache may miss
                    res = self._probe_cache.get(probe, "MISS")
                    if res == "MISS":
                        self._serve_probes([probe])
                        res = self._probe_cache[probe]
                    if res is None:
                        continue
                    child = Entry(
                        key=score_after, seq=seq, frag=new_seq,
                        num_mm=num_mm, diff=diff, si0=res[0], si1=res[1],
                        matchlen=ql,
                    )
                    heapq.heappush(heap, (-child.key, seq, child))
                    seq += 1
            if si.ql < cfg.min_fragment_length:
                continue
            best = self._eval_exact(si, e, best, best_sis, best_frags)
        return best, best_sis, best_frags

    def _requeue(self, heap, fragment, start, length, seq):
        """(reference: ConsumerThread.cpp:298-322)."""
        cfg = self.cfg
        if length > cfg.min_fragment_length:
            piece = fragment[start : start + length]
            score = self._score(fragment, start, length, 0)
            if score >= cfg.min_score:
                uid = self._uid(piece)
                if self._gmaps[uid] is None:
                    # piece never searched in the simulation's superset:
                    # only possible when its parent was itself pruned —
                    # compute lazily (rare)
                    self._compute_maps([uid])
                e = Entry(key=score, seq=seq, frag=piece)
                heapq.heappush(heap, (-score, seq, e))
                seq += 1
        return seq

    # ---- entry --------------------------------------------------------

    def classify_batch(self, reads):
        return self.collect_batch(self.submit_batch(reads))

    def classify_stream(self, batches):
        state = None
        for batch in batches:
            if state is not None and len(self._frags) > self._cache_cap:
                # drain so the generation flush can fire at next submit
                yield self.collect_batch(state)
                state = None
            nxt = self.submit_batch(batch)
            if state is not None:
                yield self.collect_batch(state)
            state = nxt
        if state is not None:
            yield self.collect_batch(state)

    def _maybe_flush_caches(self):
        if self._inflight > 0 or len(self._frags) <= self._cache_cap:
            return
        self._frag_ids.clear()
        self._frags.clear()
        self._gmaps.clear()
        self._mm_cache.clear()
        self._enc_np.clear()
        self._pref_np.clear()
        self._nodes.clear()
        self._uid_best.clear()
        self._uvars.clear()
        self._ext_cache.clear()
        self._probe_cache.clear()
        self._pref.clear()
        if self._seg is not None:
            self._seg_cache.clear()

    def submit_batch(self, reads):
        self._maybe_flush_caches()
        self._inflight += 1
        try:
            t0 = time.perf_counter()
            frags_all, orders_all, keys_all = self._frag_seg.run(
                reads, with_keys=True
            )
            guid = [self._uid(f) for f in frags_all]
            orders = [[guid[u] for u in o] for o in orders_all]
            keys_of = {}
            for lu, gu in enumerate(guid):
                keys_of[gu] = int(keys_all[lu])
            t1 = time.perf_counter()
            self._compute_maps([u for o in orders for u in o])
            HOST_SECONDS["fragment"] += t1 - t0
            HOST_SECONDS["maps"] += time.perf_counter() - t1
            return (reads, orders, keys_of)
        except BaseException:
            self._inflight = max(0, self._inflight - 1)
            raise

    def collect_batch(self, state):
        self._inflight = max(0, self._inflight - 1)
        cfg = self.cfg
        reads, orders, keys_of = state
        t0 = time.perf_counter()
        if cfg.seg:
            frags_raw, orders_raw, keys_raw = self._frag_raw.run(
                reads, with_keys=True
            )
            guid_raw = [self._uid(f) for f in frags_raw]
            raw_orders = [[guid_raw[u] for u in o] for o in orders_raw]
            for lu, gu in enumerate(guid_raw):
                keys_of.setdefault(gu, int(keys_raw[lu]))
        else:
            raw_orders = orders
        t1 = time.perf_counter()

        best_final, simrec = self._simulate(orders, keys_of)
        self._backfill(simrec, orders, best_final)
        t2 = time.perf_counter()

        per_read = []
        si_orders = []
        for r, (name, s1, s2) in enumerate(reads):
            if (not raw_orders[r] and not orders[r]) or best_final[r] == 0:
                # best_final == 0 proves no match anywhere reaches
                # min_score: the reference outputs U without further work
                per_read.append((name, None, 0, []))
                si_orders.append([])
                continue
            best, best_sis, best_frags = self._replay(
                raw_orders[r], keys_of, best_final[r]
            )
            if not best_sis:
                per_read.append((name, None, 0, []))
                si_orders.append([])
                continue
            if cfg.use_Evalue:
                if cfg.input_is_protein:
                    qlen = float(len(s1))
                else:
                    qlen = len(s1) / 3.0 + (len(s2) / 3.0 if s2 else 0.0)
                bitscore = (LAMBDA * best - LN_K) / LN_2
                evalue = (
                    float(self.index.db_length) * qlen
                    * math.pow(2.0, -bitscore)
                )
                if evalue > cfg.min_Evalue:
                    per_read.append((name, None, 0, []))
                    si_orders.append([])
                    continue
            per_read.append((name, best_sis, best, best_frags))
            si_orders.append([(si.start, si.start + si.len)
                              for si in best_sis])

        t3 = time.perf_counter()
        resolved = self._resolve_ids(si_orders)
        t4 = time.perf_counter()

        out = []
        for (name, best_sis, score, vfrags), (ids, dbnames) in zip(
            per_read, resolved
        ):
            if best_sis is None or not ids:
                out.append((name, ClassifyResult(False, 0, u_zero=False)))
            else:
                out.append((name, self._result(score, ids, dbnames, vfrags)))
        HOST_SECONDS["fragment"] += t1 - t0
        HOST_SECONDS["simulate"] += t2 - t1
        HOST_SECONDS["replay"] += t3 - t2
        HOST_SECONDS["resolve"] += t4 - t3
        HOST_SECONDS["results"] += time.perf_counter() - t4
        return out
