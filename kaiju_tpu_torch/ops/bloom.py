"""Bloom presence screen over database m-mers.

The fused MEM/Greedy searches only ever RECORD matches of length >= L
(L = min_fragment_length in MEM, seed_length in Greedy; reference:
ConsumerThread.cpp:562 greedyExact(..., max(min_len, best), -1) and
:454 maxMatches(..., seed_length, 0)), and the i <= 1 scan break can only
fire at an end position that also hosts a length >= L match (or at the
very last scanned position, where it has no effect).  So an end position
whose trailing L-mer is absent from the database contributes NOTHING to
the search result, and one bitmap probe per position screens it out
before any extension rank query runs (kernel B, ``ops/search.py``).

False positives only cost extension work (the lane dies during exact
extension); false negatives are impossible by construction, so screening
preserves bit-exact parity with the reference scan.

The bitmap is built once per (index, m) from the database text and cached
next to the index as ``bloom_m{m}_lb{lb}.npy``, the file and layout of
``kaiju_tpu.ops.bloom``: either package reads the other's cache.
"""

from __future__ import annotations

import os

import numpy as np
import torch

A32 = np.uint32(0x01000193)
GOLD = np.uint32(0x9E3779B1)


def bloom_lb(db_length: int) -> int:
    """Bitmap size exponent: ~64 bits per database position (false
    positive rate ~1.5% with one probe), clamped to [20, 32]."""
    lb = int(np.ceil(np.log2(max(db_length, 2)))) + 6
    return max(20, min(32, lb))


def fill_from_text(codes: np.ndarray, m: int, lb: int) -> np.ndarray:
    """words uint32 [2^(lb-5)] with one bit set per valid m-window of the
    text (codes: uint8, letters 1..20; 0/21+ break windows)."""
    from ..native import get_lib
    import ctypes

    lib = get_lib()
    words = np.zeros(1 << (lb - 5), dtype=np.uint32)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lib.kt_bloom_fill(
        codes.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(codes.size),
        ctypes.c_int32(m),
        ctypes.c_int32(lb),
        words.ctypes.data_as(ctypes.c_void_p),
    )
    return words


_M32 = 0xFFFFFFFF


def hash_plain(codes: torch.Tensor, m: int) -> torch.Tensor:
    """Rolling polynomial hash of the m codes ending at each position,
    h[p] = sum_t codes[p - t] * A^t mod 2^32 (codes before 0 count as 0),
    int64 [N] from codes [N]; kernel B computes it in uint32."""
    c = codes.to(torch.int64)
    h = torch.zeros_like(c)
    a_t = 1
    for t in range(m):
        shifted = torch.cat([c.new_zeros(t), c[: c.shape[0] - t]]) if t else c
        h = (h + shifted * a_t) & _M32
        a_t = a_t * int(A32) & _M32
    return h


def probe_plain(flat, pos, valid, words, m: int, lb: int) -> torch.Tensor:
    """The bitmap bit of the m-mer ending at each flat position pos, bool;
    False where not valid (callers guarantee pos - m + 1 lies in the
    position's fragment where valid)."""
    h = hash_plain(flat, m)[pos.long()]
    gold = int(GOLD)
    # (h * GOLD) mod 2^32 in int64 without overflow: GOLD in 16-bit halves
    prod = (h * (gold & 0xFFFF) + (((h * (gold >> 16)) & 0xFFFF) << 16)) & _M32
    bit = prod >> (32 - lb)
    w = words[torch.where(valid, bit >> 5, 0)]
    return valid & (((w >> (bit & 31).to(torch.int32)) & 1) > 0)


class BloomScreen:
    """The m-mer presence bitmap on one device: ``words`` int32
    [2^(lb-5)], the uint32 words reinterpreted (kernel B reads them as
    uint32; torch's uint32 support is thin), with the window length m and
    the size exponent lb."""

    def __init__(self, words: np.ndarray, m: int, lb: int, device):
        self.m = m
        self.lb = lb
        w = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
        self.words = torch.from_numpy(w).to(device)

    @property
    def args(self) -> tuple:
        """(words, m, lb), the screen argument of ``search.mem_extend``."""
        return self.words, self.m, self.lb

    @classmethod
    def load_or_build(cls, index, cache_dir: str | None, m: int, device,
                      fasta: str | None = None):
        """Build (or load) the screen for min-match-length m on `device`.

        Text source priority: cached bitmap -> ktx text.npy -> the index's
        text -> the original FASTA.  Returns None when no text source
        exists (the caller then runs unscreened: slower, same results)."""
        got = load_words(index, cache_dir, m, fasta=fasta)
        if got is None:
            return None
        words, m, lb = got
        return cls(words, m, lb, device)


def load_words(index, cache_dir: str | None, m: int,
               fasta: str | None = None):
    """(words, m, lb) as host numpy, or None when no text source exists."""
    lb = bloom_lb(index.length)
    path = (
        os.path.join(cache_dir, f"bloom_m{m}_lb{lb}.npy")
        if cache_dir
        else None
    )
    if path and os.path.exists(path):
        return np.load(path, mmap_mode=None), m, lb

    codes = None
    text_path = (
        os.path.join(index.source_dir, "text.npy")
        if index.source_dir
        else None
    )
    if text_path and os.path.exists(text_path):
        codes = np.load(text_path)
    elif getattr(index, "text", None) is not None:
        codes = index.text
    elif fasta and os.path.exists(fasta):
        codes = _codes_from_fasta(fasta, index.alphabet)
    if codes is None:
        return None
    words = fill_from_text(codes, m, lb)
    if path:
        try:
            np.save(path, words)
        except OSError:
            pass
    return words, m, lb


def _codes_from_fasta(fasta: str, alphabet: str) -> np.ndarray:
    """Concatenated letter codes with 0 separators between records."""
    from ..index.alphabet import trans_table

    trans = trans_table(alphabet)
    chunks: list[np.ndarray] = []
    with open(fasta, "rb") as fh:
        seq_parts: list[bytes] = []
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if seq_parts:
                    raw = np.frombuffer(b"".join(seq_parts), dtype=np.uint8)
                    chunks.append(trans[raw].astype(np.uint8))
                    chunks.append(np.zeros(1, np.uint8))
                    seq_parts = []
            else:
                seq_parts.append(line)
        if seq_parts:
            raw = np.frombuffer(b"".join(seq_parts), dtype=np.uint8)
            chunks.append(trans[raw].astype(np.uint8))
            chunks.append(np.zeros(1, np.uint8))
    if not chunks:
        return np.zeros(0, np.uint8)
    return np.concatenate(chunks)
