"""Python wrappers for the native batched fragment pipelines: six-frame
translation + stop splitting + queue-key computation + lazy SEG splitting +
pop-order simulation, one C call per read batch.  ``NativeFragmenter``
(native/fragments.cpp) returns the unique fragments as strings and each
read's pop order, for the host-tail pipelines of -v
(``engine.mem_fast``, ``engine.greedy_fast``); ``NativeFragmenter2``
(native/fragments2.cpp) writes straight into the device upload buffers.

Mirrors the reference's fragment queue for every read at once
(ConsumerThread.cpp:190-342).
"""

from __future__ import annotations

import ctypes

import numpy as np


class NativeFragmenter:
    def __init__(self, mode: str, min_fragment_length: int, min_score: int,
                 seg: bool, input_is_protein: bool):
        from ..native import get_lib

        self._lib = get_lib()
        self.greedy = 1 if mode == "greedy" else 0
        self.min_len = min_fragment_length
        self.min_score = min_score
        self.seg = 1 if seg else 0
        self.protein = 1 if input_is_protein else 0

    def run(self, reads, with_keys: bool = False):
        """reads: [(name, seq1, seq2-or-None)].

        Returns (frags: list[str] unique fragments, orders: per read the
        list of indices into frags in exact pop order); with_keys adds a
        third element: the queue key per unique fragment (length in MEM,
        BLOSUM diagonal score in Greedy)."""
        n = len(reads)
        seq1 = b"".join(r[1].encode("ascii") for r in reads)
        off1 = np.zeros(n + 1, dtype=np.int64)
        off1[1:] = np.cumsum([len(r[1]) for r in reads])
        paired = any(r[2] is not None for r in reads)
        if paired:
            seq2 = b"".join((r[2] or "").encode("ascii") for r in reads)
            off2 = np.zeros(n + 1, dtype=np.int64)
            off2[1:] = np.cumsum([len(r[2] or "") for r in reads])
            p2 = seq2
            po2 = off2.ctypes.data_as(ctypes.c_void_p)
        else:
            p2 = None
            po2 = None

        frag_cap = max(4096, 16 * n)
        buf_cap = max(65536, 4 * len(seq1) + (4 * len(seq2) if paired else 0))
        uid_cap = max(4096, 24 * n)
        while True:
            frag_buf = ctypes.create_string_buffer(buf_cap)
            frag_off = np.zeros(frag_cap + 1, dtype=np.int64)
            uids = np.zeros(uid_cap, dtype=np.int32)
            read_off = np.zeros(n + 1, dtype=np.int64)
            keys = np.zeros(frag_cap, dtype=np.int64)
            counts = np.zeros(3, dtype=np.int64)
            rc = self._lib.kt_fragment_batch(
                seq1, off1.ctypes.data_as(ctypes.c_void_p), n,
                p2, po2,
                self.protein, self.greedy, self.min_len, self.min_score,
                self.seg,
                frag_buf, buf_cap,
                frag_off.ctypes.data_as(ctypes.c_void_p), frag_cap,
                uids.ctypes.data_as(ctypes.c_void_p), uid_cap,
                read_off.ctypes.data_as(ctypes.c_void_p),
                keys.ctypes.data_as(ctypes.c_void_p),
                counts.ctypes.data_as(ctypes.c_void_p),
            )
            if rc == 0:
                break
            frag_cap *= 2
            buf_cap *= 2
            uid_cap *= 2

        n_frags, chars, n_uids = (int(c) for c in counts)
        raw = frag_buf.raw
        frags = [
            raw[frag_off[i] : frag_off[i + 1]].decode("ascii")
            for i in range(n_frags)
        ]
        orders = [
            uids[read_off[r] : read_off[r + 1]].tolist() for r in range(n)
        ]
        if with_keys:
            return frags, orders, keys[:n_frags].tolist()
        return frags, orders


class NativeFragmenter2:
    """Translated codes + pop-order slot table straight into the fused
    classifier's upload buffers.  No Python strings, no interning,
    multi-threaded."""

    def __init__(self, mode: str, min_fragment_length: int, min_score: int,
                 seg: bool, input_is_protein: bool, n_threads: int = 2):
        from ..native import get_lib

        self._lib = get_lib()
        self.greedy = 1 if mode == "greedy" else 0
        self.min_len = min_fragment_length
        self.min_score = min_score
        self.seg = 1 if seg else 0
        self.protein = 1 if input_is_protein else 0
        self.n_threads = n_threads
        self._flat_cap = 1 << 20
        self._frag_cap = 1 << 16

    def run(self, reads, S: int, bucket):
        """reads: [(name, seq1, seq2-or-None)]; S: slot-table width;
        bucket: fn(n, lo) -> padded capacity.

        Returns (flat uint8 [flat_cap], n_chars, frag_off int32 [>=F+1],
        n_frags, keys int64 [F], rf_rows int32 [n, S], oflow uint8 [n]) —
        flat/frag_off are bucket-padded and ready for device upload
        (pad fragment offsets already repeat n_chars)."""
        n = len(reads)
        seq1 = b"".join(r[1].encode("ascii") for r in reads)
        off1 = np.zeros(n + 1, dtype=np.int64)
        off1[1:] = np.cumsum([len(r[1]) for r in reads])
        paired = any(r[2] is not None for r in reads)
        if paired:
            seq2 = b"".join((r[2] or "").encode("ascii") for r in reads)
            off2 = np.zeros(n + 1, dtype=np.int64)
            off2[1:] = np.cumsum([len(r[2] or "") for r in reads])
            p2, po2 = seq2, off2.ctypes.data_as(ctypes.c_void_p)
        else:
            p2, po2 = None, None

        need = 2 * (len(seq1) + (len(seq2) if paired else 0)) + 4096
        self._flat_cap = bucket(max(self._flat_cap, need), 4096)
        while True:
            flat = np.zeros(self._flat_cap, dtype=np.uint8)
            frag_off = np.zeros(self._frag_cap + 1, dtype=np.int32)
            keys = np.zeros(self._frag_cap, dtype=np.int64)
            rf_rows = np.full((n, S), -1, dtype=np.int32)
            oflow = np.zeros(n, dtype=np.uint8)
            counts = np.zeros(2, dtype=np.int64)
            rc = self._lib.kt_fragment_batch2(
                seq1, off1.ctypes.data_as(ctypes.c_void_p), n,
                p2, po2,
                self.protein, self.greedy, self.min_len, self.min_score,
                self.seg, self.n_threads, S,
                flat.ctypes.data_as(ctypes.c_void_p), self._flat_cap,
                frag_off.ctypes.data_as(ctypes.c_void_p), self._frag_cap,
                keys.ctypes.data_as(ctypes.c_void_p),
                rf_rows.ctypes.data_as(ctypes.c_void_p),
                oflow.ctypes.data_as(ctypes.c_void_p),
                counts.ctypes.data_as(ctypes.c_void_p),
            )
            if rc == 0:
                break
            self._flat_cap *= 2
            self._frag_cap *= 2

        n_frags, chars = int(counts[0]), int(counts[1])
        frag_off[n_frags:] = chars
        # re-bucket to the tight upload shapes (the scratch is oversized)
        P = bucket(max(chars, 1), 4096)
        Fb = bucket(max(n_frags, 1), 256)
        if P <= self._flat_cap:
            flat_out = np.ascontiguousarray(flat[:P])
        else:
            flat_out = np.zeros(P, dtype=np.uint8)
            flat_out[:chars] = flat[:chars]
        off_out = np.full(Fb + 1, chars, dtype=np.int32)
        off_out[: min(Fb, n_frags) + 1] = frag_off[: min(Fb, n_frags) + 1]
        return flat_out, chars, off_out, n_frags, keys, rf_rows, oflow
