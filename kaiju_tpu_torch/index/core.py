"""In-memory FM-index model ("ktx") and host-side (numpy) query primitives.

Layout is designed for TPU rank kernels, replacing the reference's
byte-packed two-level structure (reference: src/bwt/compactfmi.c,
fmicommon.h) with plain arrays:

  bwt       uint8[len_padded]  plain letter codes (no letter+count packing)
  occ       int32[nblocks+1, OCC_WIDTH]  occ[b, c] = #c in bwt[0 : b*BLOCK]
  C         int64[alen+1]      letter start positions in SA space
  sa_seq/sa_off                unpacked SA samples every 2^chpt_exp SA slots

BLOCK = 128 so one occ row is one 128-lane int32 tile and one BWT block is
one 128-lane uint8 row: rank(c, k) = occ[k>>7, c] + popcount-in-block, a
single row gather + masked compare-reduce on the VPU.

FM semantics match the reference exactly: FMindex(c, k) = C[c] + occ_c(k)
with the count EXCLUDING position k, returning absolute SA positions
(reference: compactfmi.c:4-19).
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

import numpy as np

from .alphabet import PROTEIN_ALPHABET

BLOCK = 128  # occ checkpoint spacing == TPU lane width
OCC_WIDTH = 32  # padded alphabet width (alen=22 -> 32) for aligned rows
PAD_CODE = 31  # padding byte beyond bwt end; never equals a letter code

_TAXID_RE = re.compile(r"^\d+")


def parse_taxid(name: str) -> int:
    """Taxon id from a DB sequence name.

    Names are "Acc.Ver_taxid" or plain "taxid"; the number after the LAST
    underscore wins (reference: ConsumerThread.cpp:812-832, strtoul
    semantics: leading digits, 0 if none).
    """
    part = name.rsplit("_", 1)[-1]
    m = _TAXID_RE.match(part)
    return int(m.group(0)) if m else 0


@dataclass
class KaijuIndex:
    alphabet: str  # e.g. "*ACDEFGHIKLMNPQRSTVWYX"
    bwt: np.ndarray  # uint8 [padded to BLOCK multiple]; logical length = length
    length: int  # true BWT length (== total chars incl. one terminator/seq)
    nseq: int
    C: np.ndarray  # int64 [alen+1], C[c] = # chars < c in BWT
    occ: np.ndarray  # int32 [nblocks+1, OCC_WIDTH]
    chpt_exp: int  # SA sample spacing exponent
    sa_seq: np.ndarray  # int32 [nsamples]  content-rank of sequence
    sa_off: np.ndarray  # int32 [nsamples]  offset of suffix within sequence
    names: list[str]  # DB sequence names in content-sorted order
    seq_taxids: np.ndarray  # int64 [nseq], parsed from names
    seq_lengths: np.ndarray  # int64 [nseq]
    seq_term_order: np.ndarray  # int32 [nseq]: input index of content-rank r
    source_dir: str | None = None  # ktx directory this index was loaded from
    text: np.ndarray | None = None  # uint8 codes with 0 separators (optional)
    _blocks: np.ndarray | None = field(default=None, repr=False)

    # ------------------------------------------------------------------
    @property
    def alen(self) -> int:
        return len(self.alphabet)

    @property
    def db_length(self) -> int:
        """Effective database length for E-values:
        bwt len - nseq (reference: Config.cpp:19-28)."""
        return self.length - self.nseq

    @property
    def blocks(self) -> np.ndarray:
        if self._blocks is None:
            self._blocks = self.bwt.reshape(-1, BLOCK)
        return self._blocks

    # ---- rank / FM queries (host reference implementation) -----------

    def rank(self, c: np.ndarray, k: np.ndarray) -> np.ndarray:
        """#occurrences of letter c in bwt[0:k] (exclusive), vectorized."""
        c = np.asarray(c, dtype=np.int64)
        k = np.asarray(k, dtype=np.int64)
        b = k >> 7
        base = self.occ[b, c].astype(np.int64)
        # k == length at a block boundary gathers a row it won't count from
        rows = self.blocks[np.minimum(b, len(self.blocks) - 1)]  # [n, BLOCK]
        off = (k & (BLOCK - 1))[..., None]
        lanes = np.arange(BLOCK, dtype=np.int64)
        cnt = ((rows == c[..., None]) & (lanes < off)).sum(axis=-1)
        return base + cnt

    def fmindex(self, c, k):
        """FMindex(c, k) = C[c] + rank_c(k) (reference: compactfmi.c:267)."""
        c = np.asarray(c, dtype=np.int64)
        return self.C[c] + self.rank(c, k)

    def initial_si(self, c: int) -> tuple[int, int]:
        """Whole SA interval for letter c (reference: bwt.c:146-152)."""
        return int(self.C[c]), int(self.C[c + 1])

    def update_si(self, c: int, si0: int, si1: int) -> tuple[int, int] | None:
        """Backward-extend interval by letter c; None if empty
        (reference: bwt.c:160-173)."""
        n0 = int(self.fmindex(c, si0))
        n1 = int(self.fmindex(c, si1))
        if n0 >= n1:
            return None
        return n0, n1

    # ---- suffix recovery ---------------------------------------------

    def _sample_index(self, k: int) -> int:
        """Sample slot for SA position k (k % 2^e == 0, k >= nseq)
        (reference: bwt.c:115-116)."""
        e = self.chpt_exp
        return (k >> e) - ((self.nseq - 1) >> e) - 1

    def get_suffix(self, k: int) -> tuple[int, int]:
        """(content-rank sequence index, offset) for SA position k.

        LF-walk until a sampled SA slot or a terminator char
        (reference: bwt.c:105-121).
        """
        check = (1 << self.chpt_exp) - 1
        steps = 0
        c = 1
        while c and (k & check):
            c = int(self.bwt[k])
            k = int(self.C[c] + self.rank(np.int64(c), np.int64(k)))
            steps += 1
        if c:
            idx = self._sample_index(k)
            return int(self.sa_seq[idx]), int(self.sa_off[idx]) + steps
        return k, steps - 1

    def taxid_for_sa_range(self, si0: int, si1: int, cap: int | None = None):
        """Sequence indices for SA positions [si0, si1) in enumeration order."""
        out = []
        for k in range(si0, si1 if cap is None else min(si1, si0 + cap)):
            iseq, _ = self.get_suffix(k)
            out.append(iseq)
        return out

    # ---- persistence --------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        meta = {
            "format": "ktx-1",
            "alphabet": self.alphabet,
            "length": int(self.length),
            "nseq": int(self.nseq),
            "chpt_exp": int(self.chpt_exp),
        }
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        np.save(os.path.join(path, "bwt.npy"), self.bwt)
        np.save(os.path.join(path, "C.npy"), self.C)
        np.save(os.path.join(path, "occ.npy"), self.occ)
        np.save(os.path.join(path, "sa_seq.npy"), self.sa_seq)
        np.save(os.path.join(path, "sa_off.npy"), self.sa_off)
        np.save(os.path.join(path, "seq_taxids.npy"), self.seq_taxids)
        np.save(os.path.join(path, "seq_lengths.npy"), self.seq_lengths)
        np.save(os.path.join(path, "seq_term_order.npy"), self.seq_term_order)
        blob = b"\n".join(n.encode("utf-8") for n in self.names)
        with open(os.path.join(path, "names.txt"), "wb") as fh:
            fh.write(blob)
        if self.text is not None:
            np.save(os.path.join(path, "text.npy"), self.text)
        self.source_dir = path

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "KaijuIndex":
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        mm = "r" if mmap else None

        def _ld(name):
            return np.load(os.path.join(path, name), mmap_mode=mm)

        with open(os.path.join(path, "names.txt"), "rb") as fh:
            names = fh.read().decode("utf-8").split("\n")
        if names == [""]:
            names = []
        text_path = os.path.join(path, "text.npy")
        text = (
            np.load(text_path, mmap_mode=mm) if os.path.exists(text_path)
            else None
        )
        return cls(
            alphabet=meta["alphabet"],
            bwt=_ld("bwt.npy"),
            length=meta["length"],
            nseq=meta["nseq"],
            C=np.load(os.path.join(path, "C.npy")),
            occ=_ld("occ.npy"),
            chpt_exp=meta["chpt_exp"],
            sa_seq=_ld("sa_seq.npy"),
            sa_off=_ld("sa_off.npy"),
            names=names,
            seq_taxids=np.load(os.path.join(path, "seq_taxids.npy")),
            seq_lengths=np.load(os.path.join(path, "seq_lengths.npy")),
            seq_term_order=np.load(os.path.join(path, "seq_term_order.npy")),
            source_dir=path,
            text=text,
        )

    def rank_text_starts(self) -> np.ndarray:
        """int64 [nseq]: global start offset in `text` of the sequence
        with content rank r.  `text` lays sequences out in INPUT order,
        each followed by one 0 separator; an SA sample (iseq, off) maps
        to global text position rank_text_starts()[iseq] + off."""
        order = np.asarray(self.seq_term_order, dtype=np.int64)
        lengths_in = np.empty(self.nseq, dtype=np.int64)
        lengths_in[order] = np.asarray(self.seq_lengths, dtype=np.int64)
        starts_in = np.zeros(self.nseq, dtype=np.int64)
        np.cumsum(lengths_in[:-1] + 1, out=starts_in[1:])
        return starts_in[order]


def build_occ(bwt: np.ndarray, alen: int) -> tuple[np.ndarray, np.ndarray]:
    """(C, occ) from a plain uint8 BWT.

    occ[b, c] counts letter c in bwt[0 : b*BLOCK]; one extra row covers the
    end.  Equivalent of makeIndex_common's two-level checkpoints
    (reference: src/bwt/fmicommon.h:104-171) in a single dense level.
    """
    n = len(bwt)
    nblocks = (n + BLOCK - 1) // BLOCK
    padded = np.full(nblocks * BLOCK, PAD_CODE, dtype=np.uint8)
    padded[:n] = bwt
    onehot_counts = np.zeros((nblocks, OCC_WIDTH), dtype=np.int64)
    blocks = padded.reshape(nblocks, BLOCK)
    for c in range(alen):
        onehot_counts[:, c] = (blocks == c).sum(axis=1)
    occ = np.zeros((nblocks + 1, OCC_WIDTH), dtype=np.int64)
    np.cumsum(onehot_counts, axis=0, out=occ[1:])
    counts = occ[-1, :alen]
    C = np.zeros(alen + 1, dtype=np.int64)
    np.cumsum(counts, out=C[1:])
    assert C[alen] == n
    return C, occ.astype(np.int32)


def finalize_index(
    bwt: np.ndarray,
    alphabet: str,
    nseq: int,
    chpt_exp: int,
    sa_seq: np.ndarray,
    sa_off: np.ndarray,
    names: list[str],
    seq_lengths: np.ndarray,
    seq_term_order: np.ndarray,
    text: np.ndarray | None = None,
) -> KaijuIndex:
    C, occ = build_occ(bwt, len(alphabet))
    n = len(bwt)
    nblocks = (n + BLOCK - 1) // BLOCK
    padded = np.full(nblocks * BLOCK, PAD_CODE, dtype=np.uint8)
    padded[:n] = bwt
    taxids = np.array([parse_taxid(nm) for nm in names], dtype=np.int64)
    return KaijuIndex(
        alphabet=alphabet,
        bwt=padded,
        length=n,
        nseq=nseq,
        C=C,
        occ=occ,
        chpt_exp=chpt_exp,
        sa_seq=np.asarray(sa_seq, dtype=np.int32),
        sa_off=np.asarray(sa_off, dtype=np.int32),
        names=names,
        seq_taxids=taxids,
        seq_lengths=np.asarray(seq_lengths, dtype=np.int64),
        seq_term_order=np.asarray(seq_term_order, dtype=np.int32),
        text=text,
    )
