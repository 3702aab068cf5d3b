"""Native (C++) SEG filter wrapper with the same API as engine.seg.SegFilter.

Falls back to the Python implementation if the native library cannot be
built.  Both implementations are validated against the NCBI C code in
tests/test_seg.py.
"""

from __future__ import annotations

import ctypes

import numpy as np

_AA20 = "ACDEFGHIKLMNPQRSTVWY"
_CODE = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate(_AA20):
    _CODE[ord(_c)] = _i


class NativeSegFilter:
    def __init__(self):
        from ..native import get_lib

        self._lib = get_lib()
        self._buf = np.empty(4096, dtype=np.int32)

    def mask_intervals(self, seq: str) -> list[tuple[int, int]]:
        raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        codes = _CODE[raw]
        n = self._lib.kt_seg_intervals(
            codes.ctypes.data_as(ctypes.c_void_p),
            len(codes),
            self._buf.ctypes.data_as(ctypes.c_void_p),
            len(self._buf) // 2,
        )
        if n < 0:
            raise RuntimeError("SEG interval buffer overflow")
        return [(int(self._buf[2 * t]), int(self._buf[2 * t + 1])) for t in range(n)]


def make_seg_filter():
    """Best available SEG filter (native preferred)."""
    try:
        return NativeSegFilter()
    except Exception:
        from .seg import SegFilter

        return SegFilter()
