"""Backward-search strategies over a KaijuIndex (host-exact reference).

These are the executable specifications of the reference's three search
entry points (reference: src/bwt/bwt.c:261-380).  The TPU wavefront kernels
(kaiju_tpu.ops.search) compute the same (end-position -> maximal backward
extension) map in bulk; the sequential insertion/trim/termination semantics
here are then replayed as cheap postprocessing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..index.core import KaijuIndex
from .si import SI, free_until_max_si, insert_si_sorted


def _extend_backward(index: KaijuIndex, seq: np.ndarray, j: int):
    """Maximal backward extension ending at j: InitialSI + UpdateSI loop
    (reference: bwt.c:267-274).  Returns (i, si0, si1): match spans [i, j]."""
    si0, si1 = index.initial_si(int(seq[j]))
    i = j
    while i > 0:
        upd = index.update_si(int(seq[i - 1]), si0, si1)
        if upd is None:
            break
        si0, si1 = upd
        i -= 1
    return i, si0, si1


def max_matches(
    index: KaijuIndex, seq: np.ndarray, L: int, max_matches_cap: int
) -> Optional[SI]:
    """Length-sorted list of maximal matches >= L (reference: bwt.c:261-296).

    max_matches_cap == 0 means unlimited.
    """
    n = len(seq)
    first: Optional[SI] = None
    cur: Optional[SI] = None
    j = n - 1
    while j >= L - 1:
        i, si0, si1 = _extend_backward(index, seq, j)
        length = j - i + 1
        if length >= L:
            # containment check: same start as previous match => inside it
            if cur is None or i < cur.qi:
                cur = SI(start=si0, len=si1 - si0, qi=i, ql=length)
                first = insert_si_sorted(first, cur)
                if max_matches_cap > 0:
                    k = free_until_max_si(first, max_matches_cap)
                    if k > L:
                        L = k
                    if length < k:
                        cur = None
        if i <= 1:
            break
        j -= 1
    return first


def max_matches_with_start(
    index: KaijuIndex,
    seq: np.ndarray,
    L: int,
    si0: int,
    si1: int,
    offset: int,
) -> Optional[SI]:
    """Resume a right-anchored extension from a saved interval
    (reference: bwt.c:298-336).  The match always ends at the last position."""
    n = len(seq)
    j = n - 1
    i = j - offset + 1
    while i > 0:
        upd = index.update_si(int(seq[i - 1]), si0, si1)
        if upd is None:
            break
        si0, si1 = upd
        i -= 1
    length = j - i + 1
    if length >= L:
        return SI(start=si0, len=si1 - si0, qi=i, ql=length)
    return None


def greedy_exact(
    index: KaijuIndex, seq: np.ndarray, L: int, jump: int = -1
) -> Optional[SI]:
    """All maximal matches of the maximum length >= L, chained via samelen
    (reference: bwt.c:347-380).  jump >= 0 skips by L-jump after a match."""
    n = len(seq)
    first: Optional[SI] = None
    delta = (L - jump) if jump >= 0 else 1
    j = n - 1
    while j >= L - 1:
        i, si0, si1 = _extend_backward(index, seq, j)
        length = j - i + 1
        if length >= L:
            if length > L:
                first = None  # drop shorter ones
                L = length
                if jump >= 0:
                    delta = L - jump
            prev = first
            first = SI(start=si0, len=si1 - si0, qi=i, ql=length)
            first.samelen = prev
        if i <= 1:
            break
        j -= delta
    return first
