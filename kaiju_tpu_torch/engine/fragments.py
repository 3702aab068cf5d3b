"""Read -> candidate protein fragments.

Six-frame translation and fragment extraction in the exact insertion order
of the reference (reference: src/ConsumerThread.cpp:190-270
getAllFragmentsBits; 659-696 protein-input splitting), because the fragment
queue breaks score ties FIFO and tie order is observable in the output.
"""

from __future__ import annotations

import numpy as np

from ..constants import AA_TO_INT, BLOSUM62_DIAG, CODON2AA, COMPNUC2INT, NUC2INT

_AA20 = "ACDEFGHIKLMNPQRSTVWY"
_AA20_SET = set(_AA20)

# chars outside AA_ORDER hit aa2int's zero default = 'A'
# (reference: ConsumerThread.cpp:45 memset); only the 20 AAs ever occur in
# fragments, so the default is unobservable — kept for fidelity.
_DIAG_BY_CHAR = np.full(256, BLOSUM62_DIAG[AA_TO_INT["A"]], dtype=np.int64)
for _c, _i in AA_TO_INT.items():
    _DIAG_BY_CHAR[ord(_c)] = BLOSUM62_DIAG[_i]


def frag_score(seq: str) -> int:
    """Sum of BLOSUM62 diagonal scores (reference: ConsumerThread.cpp:415-421
    calcScore without diff)."""
    if not seq:
        return 0
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return int(_DIAG_BY_CHAR[raw].sum())


def translate_six_frames(read: str) -> list[str]:
    """Translated AA chars per scan position, forward then reverse.

    Returns [fwd, rev] where fwd[count] is the AA (or '*') for the codon at
    position count, count = 0..len-3, and rev[k] corresponds to the
    reference's backward scan at count = len-2-k (the first backward
    position count=len-2 reads one char past the read and is always '*';
    reference: ConsumerThread.cpp:234-236 with c_str() NUL).
    """
    raw = np.frombuffer(read.encode("ascii"), dtype=np.uint8)
    n = len(raw)
    if n < 3:
        return ["", ""]
    nuc = NUC2INT[raw].astype(np.int64)
    comp = COMPNUC2INT[raw].astype(np.int64)

    c0, c1, c2 = nuc[:-2], nuc[1:-1], nuc[2:]
    valid = (c0 < 4) & (c1 < 4) & (c2 < 4)
    packed = ((c0 << 4) | (c1 << 2) | c2) & 63
    fwd = np.where(valid, CODON2AA[packed], ord("*")).astype(np.uint8)

    # reverse scan at count uses complement of read[count+2],[count+1],[count]
    r0, r1, r2 = comp[2:], comp[1:-1], comp[:-2]
    rvalid = (r0 < 4) & (r1 < 4) & (r2 < 4)
    rpacked = ((r0 << 4) | (r1 << 2) | r2) & 63
    rev_by_count = np.where(rvalid, CODON2AA[rpacked], ord("*")).astype(np.uint8)
    # backward scan order: count = len-2 (always '*'), then len-3 .. 0
    rev = b"*" + rev_by_count[::-1].tobytes()
    return [fwd.tobytes().decode("ascii"), rev.decode("ascii")]


class FragmentSource:
    """Accumulates fragments with the reference's queue-key semantics."""

    def __init__(self, mode: str, min_fragment_length: int, min_score: int):
        self.mode = mode
        self.min_fragment_length = min_fragment_length
        self.min_score = min_score
        self.items: list[tuple[int, str]] = []  # (key, fragment)

    def _emit(self, frag: str) -> None:
        """Queue-insert check (reference: ConsumerThread.cpp:203-214)."""
        if len(frag) >= self.min_fragment_length:
            if self.mode == "greedy":
                score = frag_score(frag)
                if score >= self.min_score:
                    self.items.append((score, frag))
            else:
                self.items.append((len(frag), frag))

    def add_dna(self, read: str) -> None:
        """Six-frame translation split at stops
        (reference: ConsumerThread.cpp:190-270)."""
        fwd, rev = translate_six_frames(read)
        n = len(read)
        acc = ["", "", ""]
        for count in range(n - 2):
            aa = fwd[count]
            f = count % 3
            if aa == "*":
                self._emit(acc[f])
                acc[f] = ""
            else:
                acc[f] += aa
        for f in range(3):
            self._emit(acc[f])
            acc[f] = ""
        # backward: count = n-2 down to 0; rev[k] is count = n-2-k
        for k, aa in enumerate(rev):
            count = n - 2 - k
            f = count % 3
            if aa == "*":
                self._emit(acc[f])
                acc[f] = ""
            else:
                acc[f] += aa
        for f in range(3):
            self._emit(acc[f])
            acc[f] = ""

    def add_protein(self, read: str) -> None:
        """Split uppercased protein input at any non-AA char
        (reference: ConsumerThread.cpp:659-695)."""
        seq = read.upper()
        start = 0
        for pos, ch in enumerate(seq):
            if ch not in _AA20_SET:
                if pos - start >= self.min_fragment_length:
                    self._emit_protein(seq[start:pos])
                start = pos + 1
        if len(seq) - start >= self.min_fragment_length:
            self._emit_protein(seq[start:])

    def _emit_protein(self, frag: str) -> None:
        # length precondition checked by caller (>= min_fragment_length)
        if self.mode == "greedy":
            score = frag_score(frag)
            if score >= self.min_score:
                self.items.append((score, frag))
        else:
            self.items.append((len(frag), frag))
