"""Reader for the reference kaiju `.fmi` index format.

Parses the binary layout written by kaiju-mkfmi — BWT header || SA header ||
SA checkpoint bytes || compact FMI (reference: src/bwt/bwt.c:40-45,
suffixArray.c:261-321, fmicommon.h:175-184, compactfmi.c:165-179) — and
converts it into the plain-array KaijuIndex used by the TPU path, decoding
the byte-packed (letter, count) BWT re-coding back into plain letter codes
(reference: compactfmi.c:68-89 lcode table).

This lets parity tests load the SAME database through both engines and lets
users reuse existing kaiju databases directly.
"""

from __future__ import annotations

import struct

import numpy as np

from .core import KaijuIndex, finalize_index


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated .fmi file")
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.take(8))[0]

    def array(self, dtype, count) -> np.ndarray:
        dt = np.dtype(dtype)
        return np.frombuffer(self.take(dt.itemsize * count), dtype=dt)


def read_fmi(path: str) -> KaijuIndex:
    with open(path, "rb") as fh:
        cur = _Cursor(fh.read())

    # ---- BWT header (bwt.c:51-58) ----
    length = cur.i64()
    nseq = cur.i32()
    alen = cur.i32()
    alphabet = cur.take(alen).decode("ascii")

    # ---- SA header (suffixArray.c:282-301) ----
    sa_len = cur.i64()
    ncheck = cur.i64()
    chpt_exp = cur.i32()
    nbytes = cur.i32()
    sbits = cur.i32()  # noqa: F841  (recomputable; kept for clarity)
    pbits = cur.i32()
    mask = cur.i64()
    _check = cur.i64()
    sa_nseq = cur.i32()
    assert sa_len == length and sa_nseq == nseq
    names = []
    for _ in range(nseq):
        slen = cur.u8()
        names.append(cur.take(slen).decode("latin-1"))
    seq_term_order = cur.array("<i4", nseq).copy()
    seq_lengths = cur.array("<i8", nseq).copy()

    # ---- SA body: ncheck samples of nbytes big-endian ints
    # (suffixArray.c:40-53 long2uchar writes most-significant byte first) ----
    raw = np.frombuffer(cur.take(ncheck * nbytes), dtype=np.uint8)
    raw = raw.reshape(ncheck, nbytes).astype(np.int64)
    vals = np.zeros(ncheck, dtype=np.int64)
    for b in range(nbytes):
        vals = (vals << 8) | raw[:, b]
    sa_seq = vals >> pbits
    sa_off = vals & mask

    # ---- FMI (read_fmi_common, fmicommon.h:190-217 + startLcode) ----
    fmi_alen = cur.i32()
    bwtlen = cur.i64()
    n1 = cur.i32()
    n2 = cur.i32()
    assert fmi_alen == alen and bwtlen == length
    coded_bwt = cur.array("u1", bwtlen)
    _index1 = cur.array("<i8", n1 * alen)
    _index2 = cur.array("<u2", n2 * alen)
    start_lcode = cur.array("<i4", alen + 1)

    # Decode the (letter, count) byte-packing back to plain letters:
    # lcode[code] = the letter whose range [startLcode[a], startLcode[a+1])
    # contains code (reference: compactfmi.c:75-89 fmi_fill_codes).
    lcode = np.zeros(256, dtype=np.uint8)
    for a in range(alen):
        lcode[start_lcode[a] : start_lcode[a + 1]] = a
    bwt = lcode[coded_bwt]

    return finalize_index(
        bwt=bwt,
        alphabet=alphabet,
        nseq=nseq,
        chpt_exp=chpt_exp,
        sa_seq=sa_seq,
        sa_off=sa_off,
        names=names,
        seq_lengths=seq_lengths,
        seq_term_order=seq_term_order,
    )
