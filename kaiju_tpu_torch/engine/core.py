"""Classification core as per-read coroutines over an abstract rank backend.

The reference classifier interleaves sequential host logic (fragment queue,
branch-and-bound bounds, tie caps) with index rank queries
(reference: src/ConsumerThread.cpp).  Here the per-read logic is a Python
generator that YIELDS index-query requests and receives responses, so the
same semantics code runs under two drivers:

  * SyncExecutor (this module): serves each request immediately from the
    host KaijuIndex — the parity oracle.
  * BatchRunner (kaiju_tpu.engine.batch): collects requests from thousands
    of read coroutines per round and serves them with one batched device
    kernel call each (kaiju_tpu.ops.device_index).

Because both drivers execute the identical generator, batched TPU
classification is bit-identical to the sequential reference semantics by
construction.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Iterator, Optional

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
from ..index.core import KaijuIndex, parse_taxid
from ..io.taxonomy import Taxonomy
from .config import GREEDY, MEM, KaijuConfig
from .fragments import FragmentSource
from .si import SI, free_until_max_si, insert_si_sorted, walk_group_heads, walk_samelen

# ---------------------------------------------------------------------------
# Requests yielded by read coroutines
# ---------------------------------------------------------------------------


@dataclass
class ExtendAll:
    """Maximal backward extension for every end position of `frag`.
    Response: (start, si0, si1) int arrays of len(frag)."""

    frag: str


@dataclass
class ExtendFrom:
    """Right-anchored resumed extension (maxMatches_withStart loop).
    Response: (i, si0, si1) ints."""

    frag: str
    si0: int
    si1: int
    matchlen: int


@dataclass
class Probes:
    """Batched UpdateSI probes: items = [(code, si0, si1)].
    Response: list of None | (n0, n1)."""

    items: list


@dataclass
class SaLookup:
    """SA position -> sequence index.  Response: list of int iseq."""

    positions: list


# ---------------------------------------------------------------------------
# Map-based replays of the bwt.c search strategies
# ---------------------------------------------------------------------------


def max_matches_from_map(ext, L: int, cap: int) -> Optional[SI]:
    """maxMatches (reference: bwt.c:261-296) replayed from an extension map
    ext = (start, si0, si1) arrays."""
    start, si0, si1 = ext
    n = len(start)
    first: Optional[SI] = None
    cur: Optional[SI] = None
    j = n - 1
    while j >= L - 1:
        i = int(start[j])
        length = j - i + 1
        if length >= L:
            if cur is None or i < cur.qi:
                cur = SI(int(si0[j]), int(si1[j]) - int(si0[j]), i, length)
                first = insert_si_sorted(first, cur)
                if cap > 0:
                    k = free_until_max_si(first, cap)
                    if k > L:
                        L = k
                    if length < k:
                        cur = None
        if i <= 1:
            break
        j -= 1
    return first


def greedy_exact_from_map(ext, L: int, jump: int = -1) -> Optional[SI]:
    """greedyExact (reference: bwt.c:347-380) replayed from an extension map."""
    start, si0, si1 = ext
    n = len(start)
    first: Optional[SI] = None
    delta = (L - jump) if jump >= 0 else 1
    j = n - 1
    while j >= L - 1:
        i = int(start[j])
        length = j - i + 1
        if length >= L:
            if length > L:
                first = None
                L = length
                if jump >= 0:
                    delta = L - jump
            prev = first
            first = SI(int(si0[j]), int(si1[j]) - int(si0[j]), i, length)
            first.samelen = prev
        if i <= 1:
            break
        j -= delta
    return first


# ---------------------------------------------------------------------------
# Per-read coroutine
# ---------------------------------------------------------------------------


@dataclass
class Fragment:
    """Queue entry (reference: ConsumerThread.hpp:46-62)."""

    seq: str
    num_mm: int = 0
    diff: int = 0
    pos_lastmm: int = 0
    si0: int = 0
    si1: int = 0
    matchlen: int = 0
    seg_checked: bool = False


@dataclass
class ClassifyResult:
    classified: bool
    lca: int
    score: int = 0
    match_ids: list = field(default_factory=list)
    match_dbnames: list = field(default_factory=list)
    match_fragments: list = field(default_factory=list)
    # taxonomy-free U-line variant: early-outs print "U\tname\t0", a failed
    # search prints "U\tname" (reference: ConsumerThreadx.cpp:204/248,
    # ConsumerThreadp.cpp:17/64/85)
    u_zero: bool = True


def _calc_score(seq: str, start: int, length: int, diff: int) -> int:
    """calcScore with clamp at 0 (reference: ConsumerThread.cpp:397-404)."""
    s = diff
    for ch in seq[start : start + length]:
        s += int(BLOSUM62_DIAG[AA_TO_INT.get(ch, 0)])
    return s if s > 0 else 0


class ReadClassifier:
    """Factory for per-read classification coroutines."""

    def __init__(
        self,
        cfg: KaijuConfig,
        index: KaijuIndex,
        taxonomy: Optional[Taxonomy],
    ):
        self.cfg = cfg
        self.index = index
        self.tax = taxonomy
        self._trans = trans_table(index.alphabet)
        self._debug = getattr(cfg, "debug", False)
        if cfg.seg:
            from .seg_native import make_seg_filter

            self._seg_filter = make_seg_filter()
            self._seg_cache: dict[str, list] = {}
        else:
            self._seg_filter = None

    def seg_intervals(self, seq: str):
        ivs = self._seg_cache.get(seq)
        if ivs is None:
            ivs = self._seg_filter.mask_intervals(seq)
            self._seg_cache[seq] = ivs
        return ivs

    # ---- queue helpers (per-run state passed explicitly) ---------------

    def _requeue_piece(self, state, seq, start, length):
        """(reference: ConsumerThread.cpp:298-322; strict > on length)."""
        cfg = self.cfg
        if length > cfg.min_fragment_length:
            piece = seq[start : start + length]
            if cfg.mode == GREEDY:
                score = _calc_score(seq, start, length, 0)
                if score >= cfg.min_score:
                    self._push(state, score, Fragment(piece, seg_checked=True))
            else:
                self._push(state, length, Fragment(piece, seg_checked=True))

    def _dbg(self, msg: str) -> None:
        """-d per-read tracing, byte-compatible with the reference's
        stderr lines (reference: ConsumerThread.cpp:437-470,555-573)."""
        import sys

        print(msg, file=sys.stderr)

    def _push(self, state, key, frag):
        heapq.heappush(state["q"], (-key, state["n"], frag))
        state["n"] += 1

    def _get_next_fragment(self, state, min_score) -> Optional[Fragment]:
        """(reference: ConsumerThread.cpp:272-342)."""
        q = state["q"]
        if not q or -q[0][0] < min_score:
            return None
        f = heapq.heappop(q)[2]
        while self._seg_filter is not None and f is not None and not f.seg_checked:
            locs = self.seg_intervals(f.seq)
            if not locs:
                return f
            start = 0
            for left, right in locs:
                self._requeue_piece(state, f.seq, start, left - start)
                start = right + 1
            self._requeue_piece(state, f.seq, start, len(f.seq) - start)
            f = None
            if q and -q[0][0] >= min_score:
                f = heapq.heappop(q)[2]
        return f

    # ---- the coroutine --------------------------------------------------

    def run(self, name: str, seq1: str, seq2: Optional[str] = None) -> Iterator:
        """Generator: yields requests, returns ClassifyResult via
        StopIteration.value (reference: ConsumerThread.cpp:630-745)."""
        cfg = self.cfg
        if cfg.input_is_protein:
            if len(seq1) < cfg.min_fragment_length:
                return ClassifyResult(False, 0)
        else:
            mfl3 = cfg.min_fragment_length * 3
            if seq2 is None:
                if len(seq1) < mfl3:
                    return ClassifyResult(False, 0)
            elif len(seq1) < mfl3 and len(seq2) < mfl3:
                return ClassifyResult(False, 0)

        src = FragmentSource(cfg.mode, cfg.min_fragment_length, cfg.min_score)
        if cfg.input_is_protein:
            query_len = float(len(seq1))
            src.add_protein(seq1)
        else:
            query_len = len(seq1) / 3.0
            if len(seq1) >= cfg.min_fragment_length * 3:
                src.add_dna(seq1)
            if seq2 is not None:
                query_len += len(seq2) / 3.0
                if len(seq2) >= cfg.min_fragment_length * 3:
                    src.add_dna(seq2)

        state = {"q": [], "n": 0}
        for key, frag in src.items:
            self._push(state, key, Fragment(frag))

        if cfg.taxonomy_free and cfg.input_is_protein and not state["q"]:
            # kaijup: no fragments -> U with trailing 0
            # (reference: ConsumerThreadp.cpp:62-66)
            return ClassifyResult(False, 0)

        if cfg.mode == MEM:
            result = yield from self._run_length(state)
        else:
            result = yield from self._run_greedy(state, query_len)
        return result

    # ---- MEM (reference: ConsumerThread.cpp:543-628) --------------------

    def _run_length(self, state):
        cfg = self.cfg
        longest = 0
        matches: list[SI] = []
        match_fragments: list[str] = []
        while True:
            f = self._get_next_fragment(state, longest)
            if f is None:
                break
            if self._debug:
                self._dbg(f"Searching fragment {f.seq} ({len(f.seq)})")
            ext = yield ExtendAll(f.seq)
            if cfg.taxonomy_free:
                # kaijux MEM uses maxMatches with cap 1 instead of
                # greedyExact (reference: ConsumerThreadx.cpp:135)
                si = max_matches_from_map(
                    ext, max(cfg.min_fragment_length, longest), 1
                )
            else:
                si = greedy_exact_from_map(
                    ext, max(cfg.min_fragment_length, longest), -1
                )
            if si is None:
                if self._debug:
                    self._dbg("No match for this fragment.")
                continue
            if self._debug:
                self._dbg(f"Longest match is length {si.ql}")
            if si.ql > longest:
                matches = [si]
                longest = si.ql
                if cfg.verbose:
                    match_fragments = [f.seq[si.qi : si.qi + si.ql]]
            elif si.ql == longest:
                matches.append(si)
                if cfg.verbose:
                    match_fragments.append(f.seq[si.qi : si.qi + si.ql])
        if not matches:
            return ClassifyResult(False, 0, u_zero=False)
        si_order = [node for m in matches for node in walk_samelen(m)]
        result = yield from self._resolve_and_finish(
            si_order, longest, match_fragments
        )
        return result

    # ---- Greedy (reference: ConsumerThread.cpp:424-541) -----------------

    def _run_greedy(self, state, query_len):
        cfg = self.cfg
        best_score = 0
        best_sis: list[tuple[SI, Fragment]] = []
        best_fragments: list[str] = []

        while True:
            t = self._get_next_fragment(state, best_score)
            if t is None:
                break
            length = len(t.seq)
            if self._debug:
                self._dbg(
                    f"Searching fragment {t.seq} "
                    f"({length},{t.num_mm},{t.diff})"
                )
            if t.num_mm > 0:
                L = (
                    cfg.min_fragment_length
                    if t.num_mm == cfg.mismatches
                    else t.matchlen
                )
                i, s0, s1 = yield ExtendFrom(t.seq, t.si0, t.si1, t.matchlen)
                ml = length - 1 - i + 1
                si = SI(s0, s1 - s0, i, ml) if ml >= L else None
            else:
                ext = yield ExtendAll(t.seq)
                si = max_matches_from_map(ext, cfg.seed_length, 0)
            if si is None:
                if self._debug:
                    self._dbg("No match for this fragment.")
                continue
            if self._debug:
                self._dbg(f"Longest match is length {si.ql}")

            if cfg.mismatches > 0 and t.num_mm < cfg.mismatches:
                # Plan all substitution probes for this pop: the attempted
                # set is determined by scores alone (the UpdateSI result
                # only gates the push), so one batched request suffices.
                plan = []
                probes = []
                for node in walk_group_heads(si):
                    match_right_end = node.qi + node.ql - 1
                    if self._debug:
                        self._dbg(
                            f"Match from {node.qi} to {match_right_end}: "
                            f"{t.seq[node.qi : match_right_end + 1]} "
                            f"({node.ql})"
                        )
                    if (
                        node.qi > 0
                        and match_right_end + 1 >= cfg.min_fragment_length
                    ):
                        erase_pos = (
                            match_right_end + 1
                            if match_right_end < length - 1
                            else None
                        )
                        self._plan_variants(
                            t, node.qi - 1, erase_pos, node, best_score,
                            plan, probes,
                        )
                if probes:
                    responses = yield Probes(probes)
                    for entry, resp in zip(plan, responses):
                        if resp is None:
                            continue
                        (new_seq, score_after, num_mm, pos, diff, ql) = entry
                        self._push(
                            state,
                            score_after,
                            Fragment(
                                new_seq,
                                num_mm=num_mm,
                                pos_lastmm=pos,
                                diff=diff,
                                si0=resp[0],
                                si1=resp[1],
                                matchlen=ql,
                                seg_checked=True,
                            ),
                        )

            if si.ql < cfg.min_fragment_length:
                if self._debug:
                    self._dbg(f"Match of length {si.ql} is too short")
                continue
            best_score = self._eval_match_scores(
                si, t, best_score, best_sis, best_fragments
            )

        if not best_sis:
            return ClassifyResult(False, 0, u_zero=False)

        if cfg.use_Evalue:
            bitscore = (LAMBDA * best_score - LN_K) / LN_2
            evalue = (
                float(self.index.db_length)
                * query_len
                * math.pow(2.0, -bitscore)
            )
            if self._debug:
                self._dbg(f"E-value = {evalue:g}")
            if evalue > cfg.min_Evalue:
                return ClassifyResult(False, 0, u_zero=False)

        si_order = [si for si, _ in best_sis]
        result = yield from self._resolve_and_finish(
            si_order, best_score, best_fragments
        )
        return result

    def _plan_variants(
        self, f: Fragment, pos: int, erase_pos, si: SI, best_score, plan, probes
    ):
        """addAllMismatchVariantsAtPosSI planning
        (reference: ConsumerThread.cpp:346-395)."""
        cfg = self.cfg
        fragment = f.seq
        if erase_pos is not None and erase_pos < len(fragment):
            fragment = fragment[:erase_pos]
        orig = fragment[pos]
        oi = AA_TO_INT[orig]
        base = _calc_score(fragment, 0, len(fragment), f.diff) - int(
            BLOSUM62_DIAG[oi]
        )
        for sub in BLOSUM_SUBST[orig]:
            bi = AA_TO_INT[sub]
            score_after = base + int(BLOSUM62[oi, bi])
            if score_after >= best_score and score_after >= cfg.min_score:
                code = int(self._trans[ord(sub)])
                new_seq = fragment[:pos] + sub + fragment[pos + 1 :]
                diff = int(BLOSUM62[oi, bi]) - int(BLOSUM62_DIAG[bi])
                plan.append(
                    (new_seq, score_after, f.num_mm + 1, pos, f.diff + diff,
                     si.ql + 1)
                )
                probes.append((code, si.start, si.start + si.len))
            else:
                break

    def _eval_match_scores(self, si, frag, best_score, best_sis, best_fragments):
        """Post-order eval (reference: ConsumerThread.cpp:751-797)."""
        if si is None:
            return best_score
        cfg = self.cfg
        if si.samelen is not None:
            best_score = self._eval_match_scores(
                si.samelen, frag, best_score, best_sis, best_fragments
            )
        if si.next is not None and si.next.ql >= cfg.min_fragment_length:
            best_score = self._eval_match_scores(
                si.next, frag, best_score, best_sis, best_fragments
            )
        score = _calc_score(frag.seq, si.qi, si.ql, frag.diff)
        if score < cfg.min_score:
            return best_score
        if score > best_score:
            best_sis.clear()
            best_fragments.clear()
            best_sis.append((si, frag))
            if cfg.verbose:
                best_fragments.append(frag.seq[si.qi : si.qi + si.ql])
            return score
        if score == best_score and len(best_sis) < cfg.max_matches_SI:
            best_sis.append((si, frag))
            if cfg.verbose:
                best_fragments.append(frag.seq[si.qi : si.qi + si.ql])
        return best_score

    # ---- id resolution + finish ----------------------------------------

    def _resolve_and_finish(self, si_order, score, match_fragments):
        """ids_from_SI over the ordered SI list with caps
        (reference: ConsumerThread.cpp:799-845), SA lookups batched in
        chunks; then the LCA + result assembly."""
        cfg = self.cfg
        idx = self.index
        if cfg.taxonomy_free:
            result = yield from self._resolve_names(si_order, score, match_fragments)
            return result
        ids: set[int] = set()
        dbnames: set[str] = set()
        chunk_size = cfg.max_match_ids + 6
        for si in si_order:
            k = si.start
            end = si.start + si.len
            capped = False
            while k < end and not capped:
                n = min(chunk_size, end - k)
                iseqs = yield SaLookup(list(range(k, k + n)))
                for iseq in iseqs:
                    if len(ids) > cfg.max_match_ids:
                        capped = True
                        break
                    name = idx.names[iseq]
                    taxid = parse_taxid(name)
                    if "_" in name and cfg.verbose and len(dbnames) < cfg.max_match_acc:
                        dbnames.add(name.rsplit("_", 1)[0])
                    ids.add(taxid)
                k += n

        if len(ids) == 1:
            lca = next(iter(ids))
        elif self.tax is not None:
            lca = self.tax.lca(sorted(ids), verbose=cfg.verbose)
        else:
            lca = 0
        return ClassifyResult(
            classified=lca > 0,
            lca=lca,
            score=score,
            match_ids=sorted(ids),
            match_dbnames=sorted(dbnames),
            match_fragments=match_fragments,
        )


    def _resolve_names(self, si_order, score, match_fragments):
        """kaijux/kaijup id resolution: DB sequence NAMES, deduped by
        sequence and ordered by sequence index (the reference inserts
        char* pointers into a std::set, whose order is the ids[] allocation
        order = content rank; reference: ConsumerThreadx.cpp:258-290)."""
        cfg = self.cfg
        idx = self.index
        iseqs: set[int] = set()
        chunk_size = cfg.max_match_ids + 6
        for si in si_order:
            k = si.start
            end = si.start + si.len
            capped = False
            while k < end and not capped:
                n = min(chunk_size, end - k)
                res = yield SaLookup(list(range(k, k + n)))
                for iseq in res:
                    if len(iseqs) > cfg.max_match_ids:
                        capped = True
                        break
                    iseqs.add(iseq)
                k += n
        names = [idx.names[i] for i in sorted(iseqs)]
        return ClassifyResult(
            classified=True,
            lca=0,
            score=score,
            match_ids=[],
            match_dbnames=names,
            match_fragments=match_fragments,
        )


# ---------------------------------------------------------------------------
# Synchronous driver (parity oracle)
# ---------------------------------------------------------------------------


class SyncExecutor:
    """Serves coroutine requests directly from the host KaijuIndex."""

    def __init__(self, index: KaijuIndex):
        self.index = index
        self._trans = trans_table(index.alphabet)
        self._ext_cache: dict[str, tuple] = {}

    def _encode(self, seq: str) -> np.ndarray:
        raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        return self._trans[raw].astype(np.uint8)

    def extend_all(self, frag: str):
        cached = self._ext_cache.get(frag)
        if cached is not None:
            return cached
        from .search import _extend_backward

        codes = self._encode(frag)
        n = len(codes)
        start = np.zeros(n, dtype=np.int64)
        s0 = np.zeros(n, dtype=np.int64)
        s1 = np.zeros(n, dtype=np.int64)
        for j in range(n):
            start[j], s0[j], s1[j] = _extend_backward(self.index, codes, j)
        res = (start, s0, s1)
        self._ext_cache[frag] = res
        return res

    def serve(self, req):
        idx = self.index
        if isinstance(req, ExtendAll):
            return self.extend_all(req.frag)
        if isinstance(req, ExtendFrom):
            codes = self._encode(req.frag)
            si0, si1 = req.si0, req.si1
            i = len(codes) - req.matchlen
            while i > 0:
                upd = idx.update_si(int(codes[i - 1]), si0, si1)
                if upd is None:
                    break
                si0, si1 = upd
                i -= 1
            return (i, si0, si1)
        if isinstance(req, Probes):
            return [
                idx.update_si(c, a, b) for (c, a, b) in req.items
            ]
        if isinstance(req, SaLookup):
            return [idx.get_suffix(k)[0] for k in req.positions]
        raise TypeError(req)


def drive_sync(gen, executor: SyncExecutor) -> ClassifyResult:
    try:
        req = next(gen)
        while True:
            req = gen.send(executor.serve(req))
    except StopIteration as stop:
        return stop.value


def format_output_line_x(name: str, res: ClassifyResult) -> str:
    """Taxonomy-free TSV line (reference: ConsumerThreadx.cpp:108-119,
    183-195, 235-248)."""
    if not res.classified:
        return f"U\t{name}\t0\n" if res.u_zero else f"U\t{name}\n"
    ids = "".join(f"{n}," for n in res.match_dbnames)
    frags = "".join(f"{m}," for m in res.match_fragments)
    return f"C\t{name}\t{res.score}\t{ids}\t{frags}\n"


def format_output_line(name: str, res: ClassifyResult, verbose: bool) -> str:
    """TSV line (reference: ConsumerThread.cpp:724-739, 527-536, 614-622)."""
    if not res.classified:
        return f"U\t{name}\t0\n"
    line = f"C\t{name}\t{res.lca}"
    if verbose:
        ids = "".join(f"{i}," for i in res.match_ids)
        accs = "".join(f"{a}," for a in res.match_dbnames)
        frags = "".join(f"{m}," for m in res.match_fragments)
        line += f"\t{res.score}\t{ids}\t{accs}\t{frags}"
    return line + "\n"


class ExactClassifier:
    """Sequential per-read classifier over the host index (parity oracle)."""

    def __init__(self, index: KaijuIndex, taxonomy, config: KaijuConfig):
        self.core = ReadClassifier(config, index, taxonomy)
        self.executor = SyncExecutor(index)
        self.cfg = config

    def classify_read(self, name, seq1, seq2=None):
        res = drive_sync(self.core.run(name, seq1, seq2), self.executor)
        return name, res

    def classify_batch(self, reads):
        """Sequential driver (used by -d: reads processed one at a time
        so the stderr trace interleaves exactly like the reference's
        single-threaded run)."""
        return [self.classify_read(*r) for r in reads]
