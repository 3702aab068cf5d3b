"""Native (C++) components, loaded via ctypes.

The shared library is compiled on first use into this package directory;
no pip/system installs are required (g++ only).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_LIB_NAME = "libkaiju_native.so"
_LOCK = threading.Lock()
_lib = None


def _src_dir() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def build_library(force: bool = False) -> str:
    """Compile the native library if needed; returns the .so path."""
    d = _src_dir()
    so = os.path.join(d, _LIB_NAME)
    srcs = [
        os.path.join(d, "sais.cpp"),
        os.path.join(d, "bigsais.cpp"),
        os.path.join(d, "seg.cpp"),
        os.path.join(d, "fragments2.cpp"),
    ]
    if not force and os.path.exists(so):
        newest_src = max(os.path.getmtime(s) for s in srcs)
        if os.path.getmtime(so) >= newest_src:
            return so
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        *srcs, "-o", so,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return so


def get_lib():
    global _lib
    with _LOCK:
        if _lib is None:
            so = build_library()
            lib = ctypes.CDLL(so)
            lib.kt_build_bwt.restype = ctypes.c_int
            lib.kt_seg_intervals.restype = ctypes.c_int
            lib.kt_seg_intervals.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ]
            lib.kt_fragment_batch2.restype = ctypes.c_int
            lib.kt_fragment_batch2.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # seqs
                ctypes.c_void_p, ctypes.c_void_p,                  # seqs2
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,    # flags
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,    # seg/thr
                ctypes.c_int32,                                    # S
                ctypes.c_void_p, ctypes.c_int64,                   # flat
                ctypes.c_void_p, ctypes.c_int64,                   # frag off
                ctypes.c_void_p,                                   # keys
                ctypes.c_void_p, ctypes.c_void_p,                  # rf/oflow
                ctypes.c_void_p,                                   # counts
            ]
            lib.kt_build_bwt_big.restype = ctypes.c_int
            lib.kt_build_bwt_big.argtypes = [
                ctypes.c_void_p,  # text (0-separated)
                ctypes.c_void_p,  # tstart int64[nseq+1]
                ctypes.c_int64,   # nseq
                ctypes.c_int64,   # N
                ctypes.c_int32,   # alen
                ctypes.c_int32,   # chpt_exp
                ctypes.c_int32,   # n_threads
                ctypes.c_void_p,  # bwt out
                ctypes.c_void_p,  # content_rank out
                ctypes.c_void_p,  # sa_seq out (int32)
                ctypes.c_void_p,  # sa_off out (int64)
                ctypes.c_int64,   # n_samples
            ]
            lib.kt_build_bwt.argtypes = [
                ctypes.c_void_p,  # codes
                ctypes.c_void_p,  # seq_len
                ctypes.c_int64,   # nseq
                ctypes.c_int64,   # total_letters
                ctypes.c_int32,   # alen
                ctypes.c_int32,   # chpt_exp
                ctypes.c_void_p,  # bwt out
                ctypes.c_void_p,  # content_rank out
                ctypes.c_void_p,  # sa_seq out
                ctypes.c_void_p,  # sa_off out
                ctypes.c_int64,   # n_samples
            ]
            _lib = lib
    return _lib
