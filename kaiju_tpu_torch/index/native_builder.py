"""Index builder backed by the native SA-IS library (kaiju_tpu.native).

Produces output identical to py_builder (the executable spec) and to the
reference kaiju-mkbwt/mkfmi toolchain, at scale: linear-time suffix sorting
in C++ instead of Python comparison sorting.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import get_lib
from .alphabet import MAKEDB_ALPHABET
from .core import KaijuIndex, finalize_index
from .py_builder import DEFAULT_CHPT_EXP, translate_db_sequence


def build_index(
    records: list[tuple[str, str]],
    chpt_exp: int = DEFAULT_CHPT_EXP,
    alphabet: str = MAKEDB_ALPHABET,
) -> KaijuIndex:
    names_in = [name for name, _ in records]
    seqs = [translate_db_sequence(seq, alphabet) for _, seq in records]
    return build_index_from_codes(names_in, seqs, chpt_exp, alphabet)


def build_index_from_codes(
    names_in: list[str],
    seqs: list[np.ndarray],
    chpt_exp: int = DEFAULT_CHPT_EXP,
    alphabet: str = MAKEDB_ALPHABET,
    builder: str = "auto",
    n_threads: int | None = None,
) -> KaijuIndex:
    nseq = len(seqs)
    for i, s in enumerate(seqs):
        if len(s) == 0:
            raise ValueError(f"empty sequence: {names_in[i]}")
    seq_len = np.array([len(s) for s in seqs], dtype=np.int64)
    if builder == "auto":
        import os as _os

        builder = _os.environ.get("KAIJU_BUILDER", "auto")
    if builder == "big" or (
        builder == "auto" and int(seq_len.sum()) + nseq + 1 >= (1 << 31)
    ):
        return _build_big(names_in, seqs, seq_len, chpt_exp, alphabet,
                          n_threads)
    codes = np.concatenate(seqs).astype(np.uint8)
    total = int(seq_len.sum())
    bwt_len = total + nseq
    e = chpt_exp
    # multiples of 2^e in [nseq, bwt_len)
    first = ((nseq + (1 << e) - 1) >> e) << e
    n_samples = max(0, ((bwt_len - 1) >> e) - (first >> e) + 1) if first < bwt_len else 0

    bwt = np.empty(bwt_len, dtype=np.uint8)
    content_rank = np.empty(nseq, dtype=np.int32)
    sa_seq = np.empty(max(1, n_samples), dtype=np.int32)
    sa_off = np.empty(max(1, n_samples), dtype=np.int32)

    lib = get_lib()
    rc = lib.kt_build_bwt(
        codes.ctypes.data_as(ctypes.c_void_p),
        seq_len.ctypes.data_as(ctypes.c_void_p),
        nseq,
        total,
        len(alphabet),
        e,
        bwt.ctypes.data_as(ctypes.c_void_p),
        content_rank.ctypes.data_as(ctypes.c_void_p),
        sa_seq.ctypes.data_as(ctypes.c_void_p),
        sa_off.ctypes.data_as(ctypes.c_void_p),
        n_samples,
    )
    if rc != 0:
        raise RuntimeError(f"kt_build_bwt failed with code {rc}")

    order = np.argsort(content_rank, kind="stable")  # content-rank r -> input
    names_sorted = [names_in[i] for i in order]
    # 0-separated text copy (m-mer screen construction, kaiju_tpu.ops.bloom)
    text = np.zeros(total + nseq, dtype=np.uint8)
    ends = np.cumsum(seq_len + 1)
    starts = ends - seq_len - 1
    for i, s in enumerate(seqs):
        text[starts[i] : ends[i] - 1] = s
    return finalize_index(
        bwt=bwt,
        alphabet=alphabet,
        nseq=nseq,
        chpt_exp=e,
        sa_seq=sa_seq[:n_samples],
        sa_off=sa_off[:n_samples],
        names=names_sorted,
        seq_lengths=seq_len[order],
        seq_term_order=order.astype(np.int32),
        text=text,
    )


def _build_big(
    names_in: list[str],
    seqs: list[np.ndarray],
    seq_len: np.ndarray,
    chpt_exp: int,
    alphabet: str,
    n_threads: int | None,
) -> KaijuIndex:
    """Threaded bucketed builder (kt_build_bwt_big): no 2^31 length cap.

    Role-equivalent of the reference's threaded bucket pipeline
    (reference: src/bwt/mkbwt.c:82-138,569-671); output is bit-identical
    to the SA-IS path (tests/test_index.py asserts this)."""
    import os as _os

    nseq = len(seqs)
    total = int(seq_len.sum())
    N = total + nseq
    # 0-separated text (doubles as the bloom-screen source)
    text = np.zeros(N, dtype=np.uint8)
    ends = np.cumsum(seq_len + 1)
    starts = ends - seq_len - 1
    for i, s in enumerate(seqs):
        text[starts[i] : ends[i] - 1] = s
    tstart = np.zeros(nseq + 1, dtype=np.int64)
    tstart[1:] = ends

    e = chpt_exp
    first = ((nseq + (1 << e) - 1) >> e) << e
    n_samples = max(0, ((N - 1) >> e) - (first >> e) + 1) if first < N else 0

    bwt = np.empty(N, dtype=np.uint8)
    content_rank = np.empty(nseq, dtype=np.int32)
    sa_seq = np.empty(max(1, n_samples), dtype=np.int32)
    sa_off64 = np.empty(max(1, n_samples), dtype=np.int64)
    nt = n_threads or max(1, _os.cpu_count() or 1)

    lib = get_lib()
    rc = lib.kt_build_bwt_big(
        text.ctypes.data_as(ctypes.c_void_p),
        tstart.ctypes.data_as(ctypes.c_void_p),
        nseq,
        N,
        len(alphabet),
        e,
        nt,
        bwt.ctypes.data_as(ctypes.c_void_p),
        content_rank.ctypes.data_as(ctypes.c_void_p),
        sa_seq.ctypes.data_as(ctypes.c_void_p),
        sa_off64.ctypes.data_as(ctypes.c_void_p),
        n_samples,
    )
    if rc != 0:
        raise RuntimeError(f"kt_build_bwt_big failed with code {rc}")

    order = np.argsort(content_rank, kind="stable")
    names_sorted = [names_in[i] for i in order]
    return finalize_index(
        bwt=bwt,
        alphabet=alphabet,
        nseq=nseq,
        chpt_exp=e,
        sa_seq=sa_seq[:n_samples],
        sa_off=sa_off64[:n_samples].astype(np.int32),
        names=names_sorted,
        seq_lengths=seq_len[order],
        seq_term_order=order.astype(np.int32),
        text=text,
    )
