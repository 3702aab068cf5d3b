"""SEG low-complexity filter (Wootton & Federhen 1993).

A from-scratch implementation of the SEG algorithm with the exact numeric
behavior of the vendored NCBI implementation the reference links against
(reference: src/include/ncbi-blast+/algo/blast/core/blast_seg.c), using the
parameters kaiju configures: window=12, locut=2.2, hicut=2.5, maxtrim=50,
maxbogus=2, overlaps=TRUE (reference: blast_seg.c:48-50, Config.cpp:24-27).

Numeric fidelity notes (observable through trim tie-breaks):
  * ln(n!) uses the reference's precomputed table, which stores lgamma(n+1)
    ROUNDED TO 6 DECIMALS for n <= 10000 (blast_seg.c:53), falling back to
    Stirling above.
  * Entropy is |sum sv*log(sv/total)| / (total*ln2) with the 80-bit-free
    double math of libm (blast_seg.c:1595-1626).
  * Trim scans lengths descending then offsets ascending with a strict '<'
    (blast_seg.c:1989-2006), so ties keep the first (longest/leftmost) hit.
"""

from __future__ import annotations

import math
from functools import lru_cache

_LN2 = 0.69314718055994530941723212145818  # NCBIMATH_LN2 (ncbi_math.h:161)
_LN20 = 2.9957322735539909  # s_AA20alphaStd (blast_seg.c:2193)
_AA20 = "ACDEFGHIKLMNPQRSTVWY"
_AA_IDX = {c: i for i, c in enumerate(_AA20)}

_WINDOW = 12
_LOCUT = 2.2
_HICUT = 2.5
_MAXTRIM = 50
_MAXBOGUS = 2

# log(i/10) table used when a window holds exactly 10 counted residues
# (blast_seg.c:1310 log_win10; note the historical typo at i=3)
_LOG_WIN10 = [
    0.0, -2.30258509, -1.60943791, -1.203982804, -0.916290731,
    -0.693147181, -0.510825624, -0.356674944, -0.223143551,
    -0.105360516, 0.0,
]

_LNFACT_SIZE = 10001


@lru_cache(maxsize=None)
def _lnfact(n: int) -> float:
    """s_lnfact (blast_seg.c:1851-1856): 6-decimal table, else Stirling."""
    if n < _LNFACT_SIZE:
        return float(f"{math.lgamma(n + 1):.6f}")
    return (n + 0.5) * math.log(n) - n + 0.9189385332


def _entropy(sv: list[int]) -> float:
    """s_Entropy (blast_seg.c:1595-1626) on a descending state vector."""
    total = 0
    for v in sv:
        if v == 0:
            break
        total += v
    if total == 0:
        return 0.0
    ent = 0.0
    if total == 10:
        for v in sv:
            if v == 0:
                break
            ent += v * _LOG_WIN10[v] / _LN2
    else:
        for v in sv:
            if v == 0:
                break
            ent += v * math.log(v / total) / _LN2
    return abs(ent / total)


def _state_vector(counts: list[int]) -> list[int]:
    """Nonzero composition counts sorted descending, zero-padded to 21
    (blast_seg.c:1518-1543)."""
    sv = sorted((c for c in counts if c), reverse=True)
    return sv + [0] * (21 - len(sv))


def _ln_ass(sv: list[int]) -> float:
    """s_LnAss (blast_seg.c:1889-1930): ln of the number of compositions in
    the complexity state — 20! over the factorials of the multiplicities of
    each distinct count value (including the zero group)."""
    ans = _lnfact(20)
    if sv[0] == 0:
        return ans
    total = 20
    cls = 1
    idx = 0
    svim1 = sv[0]
    i = 0
    while True:
        i += 1
        if i == 20:
            ans -= _lnfact(cls)
            break
        idx += 1
        svi = sv[idx]
        if svi == svim1:
            cls += 1
            svim1 = svi
            continue
        total -= cls
        ans -= _lnfact(cls)
        if svi == 0:
            ans -= _lnfact(total)
            break
        cls = 1
        svim1 = svi
    return ans


def _ln_perm(sv: list[int], window_length: int) -> float:
    """s_LnPerm (blast_seg.c:1864-1879)."""
    ans = _lnfact(window_length)
    for v in sv:
        if v == 0:
            break
        ans -= _lnfact(v)
    return ans


def _get_prob(sv: list[int], total: int) -> float:
    """s_GetProb (blast_seg.c:1940-1962): ln P0."""
    return _ln_ass(sv) + _ln_perm(sv, total) - total * _LN20


class SegFilter:
    """SEG over plain AA strings; fragments contain only the 20 AAs, so the
    bogus-character machinery reduces to counting unknowns."""

    def mask_intervals(self, seq: str) -> list[tuple[int, int]]:
        """Ascending, overlap-merged [left, right] masked intervals,
        equivalent to SeqBufferSeg + s_MergeSegs (overlaps=TRUE, hilenmin=0)
        + s_SegsToBlastSeqLoc ordering."""
        codes = [_AA_IDX.get(c, -1) for c in seq]
        segs: list[list[int]] = []  # head at index 0 (prepend order)
        self._seg_seq(codes, 0, len(codes), 0, segs)
        if not segs:
            return []
        # s_MergeSegs (blast_seg.c:2121-2152) with hilenmin=0: merge
        # overlapping neighbors walking from the head (rightmost first).
        merged = [segs[0]]
        for nxt in segs[1:]:
            seg = merged[-1]
            if seg[0] - nxt[1] - 1 < 0:
                seg[1] = max(seg[1], nxt[1])
                seg[0] = min(seg[0], nxt[0])
            else:
                merged.append(nxt)
        merged.reverse()  # restore ascending (s_SegsToBlastSeqLoc prepend)
        return [(a, b) for a, b in merged]

    # ------------------------------------------------------------------

    def _seq_entropy(self, codes, start, length):
        """s_SeqEntropy (blast_seg.c:1750-1798): H[i] per window center."""
        window = _WINDOW
        downset = (window + 1) // 2 - 1
        upset = window - downset
        if window > length:
            return None
        H = [-1.0] * length
        counts = [0] * 20
        bogus = 0
        for p in range(start, start + window):
            if codes[p] >= 0:
                counts[codes[p]] += 1
            else:
                bogus += 1
        first = downset
        last = length - upset
        for i in range(first, last + 1):
            if bogus > _MAXBOGUS:
                H[i] = -1.0
            else:
                H[i] = _entropy(_state_vector(counts))
            # shift window right by one
            p = start + (i - downset)
            if p + window < start + length:
                if codes[p] >= 0:
                    counts[codes[p]] -= 1
                else:
                    bogus -= 1
                q = p + window
                if codes[q] >= 0:
                    counts[codes[q]] += 1
                else:
                    bogus += 1
        return H

    def _trim(self, codes, start, length):
        """s_Trim (blast_seg.c:1970-2015): (lend, rend) within the window."""
        lend = 0
        rend = length - 1
        minlen = 1
        if length - _MAXTRIM > minlen:
            minlen = length - _MAXTRIM
        minprob = 1.0
        for ln in range(length, minlen, -1):
            counts = [0] * 20
            for p in range(start, start + ln):
                if codes[p] >= 0:
                    counts[codes[p]] += 1
            for i in range(0, length - ln + 1):
                sv = _state_vector(counts)
                prob = _get_prob(sv, ln)
                if prob < minprob:
                    minprob = prob
                    lend = i
                    rend = ln + i - 1
                p = start + i
                if p + ln < start + length:
                    if codes[p] >= 0:
                        counts[codes[p]] -= 1
                    if codes[p + ln] >= 0:
                        counts[codes[p + ln]] += 1
        return lend, rend

    def _seg_seq(self, codes, start, length, offset, segs):
        """s_SegSeq (blast_seg.c:2026-2113); segs built in prepend order."""
        window = _WINDOW
        downset = (window + 1) // 2 - 1
        upset = window - downset
        H = self._seq_entropy(codes, start, length)
        if H is None:
            return
        first = downset
        last = length - upset
        lowlim = first
        i = first
        while i <= last:
            if H[i] <= _LOCUT and H[i] != -1.0:
                # extend while H <= hicut (s_FindLow/s_FindHigh)
                j = i
                while j >= lowlim and H[j] != -1.0 and H[j] <= _HICUT:
                    j -= 1
                loi = j + 1
                j = i
                while j <= last and H[j] != -1.0 and H[j] <= _HICUT:
                    j += 1
                hii = j - 1

                leftend = loi - downset
                rightend = hii + upset - 1
                tlen = rightend - leftend + 1
                lend, rend = self._trim(codes, start + leftend, tlen)
                new_left = leftend + lend
                new_right = rightend - (tlen - rend - 1)

                if i + upset - 1 < new_left:
                    # trigger window fell in the left trim: recurse left
                    lrec_start = loi - downset
                    lrec_len = (new_left - 1) - lrec_start + 1
                    sub: list[list[int]] = []
                    self._seg_seq(
                        codes, start + lrec_start, lrec_len,
                        offset + lrec_start, sub,
                    )
                    if sub:
                        # NB: the reference links only the HEAD of the
                        # nested list (`leftsegs->next = *segs`,
                        # blast_seg.c:2093-2097), dropping any further
                        # nested segs — replicated for bit-parity.
                        segs.insert(0, sub[0])
                segs.insert(0, [new_left + offset, new_right + offset])
                i = min(hii, new_right + downset)
                lowlim = i + 1
            i += 1
