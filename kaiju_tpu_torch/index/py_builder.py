"""Pure-Python index builder (small databases / tests).

Replicates the reference BWT construction semantics exactly
(reference: src/bwt/mkbwt.c, readFasta.c) without replicating its
mechanism (bucketed multikey quicksort over order-encoded padding):

  * Suffixes over letter positions only (codes 1..alen-1).
  * Comparison: letter string to the end of the owning sequence; a sequence
    end sorts below any letter; ties between identical letter strings break
    by INPUT order of the owning sequence.  This is what the reference's
    negative base-100 "encodeOrder" padding achieves for the default
    (non-revsort) terminator order (reference: mkbwt.c:834-856, 1012-1024).
  * BWT = [terminator block: last letter of input-seq j at slot j
    (reference: mkbwt.c:860-873 write_term with readOrder)] ++
    [preceding char of each sorted suffix; 0 at sequence starts].
  * Sequence metadata (ids/lengths/termOrder) is stored in CONTENT-sorted
    order; SA samples store (content_rank, offset)
    (reference: mkbwt.c:700-728 SortSeqs, suffixArray.c:195-226).

The native C++ builder (kaiju_tpu/native) produces identical output at
scale; this module is the executable specification.
"""

from __future__ import annotations

import functools

import numpy as np

from .alphabet import MAKEDB_ALPHABET, trans_table
from .core import KaijuIndex, finalize_index

DEFAULT_CHPT_EXP = 3  # kaiju-makedb uses -e 3 for genome DBs (kaiju-makedb:16)


def translate_db_sequence(seq: str, alphabet: str = MAKEDB_ALPHABET) -> np.ndarray:
    """FASTA sequence chars -> index codes; non-letters dropped
    (reference: readFasta.c:145-148 keeps only translate[c] >= 0)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    codes = trans_table(alphabet)[raw]
    return codes[codes > 0].astype(np.uint8)


def build_index(
    records: list[tuple[str, str]],
    chpt_exp: int = DEFAULT_CHPT_EXP,
    alphabet: str = MAKEDB_ALPHABET,
) -> KaijuIndex:
    """Build a KaijuIndex from (name, sequence) records in input order."""
    nseq = len(records)
    names_in = [name for name, _ in records]
    seqs = [translate_db_sequence(seq) for _, seq in records]
    for i, s in enumerate(seqs):
        if len(s) == 0:
            raise ValueError(f"empty sequence: {names_in[i]}")
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    total = int(lengths.sum()) + nseq  # one terminator per sequence

    # Suffix keys: bytes(codes[p:]) + 0x00 + big-endian input index.
    # All code values are < 128, so byte comparison == signed-char
    # comparison in the reference; 0x00 < any letter implements
    # "sequence end sorts first"; the index suffix implements the
    # input-order tie-break.
    idx_w = max(1, (nseq.bit_length() + 7) // 8)
    seq_bytes = [s.tobytes() for s in seqs]
    tails = [b"\x00" + i.to_bytes(idx_w, "big") for i in range(nseq)]

    suffixes = []  # (key, iseq, pos)
    for i, sb in enumerate(seq_bytes):
        t = tails[i]
        for p in range(len(sb)):
            suffixes.append((sb[p:] + t, i, p))
    suffixes.sort(key=lambda x: x[0])

    # Content rank: order of the full-sequence suffixes (p == 0)
    # (reference: SortSeqs, mkbwt.c:700-728).
    order = sorted(range(nseq), key=lambda i: seq_bytes[i] + tails[i])
    content_rank = np.empty(nseq, dtype=np.int64)
    for r, i in enumerate(order):
        content_rank[i] = r

    bwt = np.empty(total, dtype=np.uint8)
    # Terminator block in INPUT order: bwt[j] = last letter of input seq j
    # (write_term with seqTermOrder == readOrder identity).
    for j, s in enumerate(seqs):
        bwt[j] = s[-1]

    e = chpt_exp
    sa_seq, sa_off = [], []
    for r, (_, iseq, pos) in enumerate(suffixes):
        k = nseq + r
        bwt[k] = seqs[iseq][pos - 1] if pos > 0 else 0
        if (k & ((1 << e) - 1)) == 0:
            sa_seq.append(content_rank[iseq])
            sa_off.append(pos)

    names_sorted = [names_in[i] for i in order]
    lengths_sorted = lengths[order]
    term_order = np.array(order, dtype=np.int32)  # content-rank r -> input idx
    text = np.concatenate(
        [np.concatenate([s, np.zeros(1, np.uint8)]) for s in seqs]
    ).astype(np.uint8)

    return finalize_index(
        bwt=bwt,
        alphabet=alphabet,
        nseq=nseq,
        chpt_exp=chpt_exp,
        sa_seq=np.array(sa_seq, dtype=np.int64),
        sa_off=np.array(sa_off, dtype=np.int64),
        names=names_sorted,
        seq_lengths=lengths_sorted,
        seq_term_order=term_order,
        text=text,
    )


def read_fasta_records(path: str) -> list[tuple[str, str]]:
    """Minimal FASTA reader for DB building: (id, seq) records.

    The id is the header up to the first blank (reference: readFasta.c:74-78).
    """
    records: list[tuple[str, str]] = []
    name = None
    chunks: list[str] = []
    if path == "-":
        import contextlib
        import sys

        opener = functools.partial(contextlib.nullcontext, sys.stdin)
    elif path.endswith(".gz"):
        import gzip

        opener = functools.partial(gzip.open, path, "rt")
    else:
        opener = functools.partial(open, path, "rt")
    with opener() as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    records.append((name, "".join(chunks)))
                header = line[1:]
                name = header.split()[0] if header.split() else ""
                chunks = []
            elif name is not None:
                chunks.append(line)
    if name is not None:
        records.append((name, "".join(chunks)))
    return records
