"""Scoring and translation constants.

These are the public BLOSUM62 / genetic-code tables used by the reference
classifier (reference: src/ConsumerThread.cpp:6-187), expressed as numpy
arrays so they can be shipped to the device once.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Amino-acid integer encoding used for SCORING (aa2int order in the
# reference, ConsumerThread.cpp:45-65).  This is distinct from the INDEX
# alphabet encoding (see kaiju_tpu.index.alphabet).
# ---------------------------------------------------------------------------
AA_ORDER = "ARNDCQEGHILKMFPSTWYV"  # index 0..19
AA_TO_INT = {c: i for i, c in enumerate(AA_ORDER)}

# BLOSUM62 diagonal (match) scores, indexed by AA_ORDER
# (reference: ConsumerThread.cpp:66-85)
BLOSUM62_DIAG = np.array(
    [4, 5, 6, 6, 9, 5, 5, 6, 8, 4, 4, 5, 5, 6, 7, 4, 5, 11, 7, 4],
    dtype=np.int32,
)

# Full 20x20 BLOSUM62 (off-diagonal values as in ConsumerThread.cpp:88-107,
# diagonal from BLOSUM62_DIAG).  Standard public matrix.
_B62_ROWS = {
    "A": "A4 R-1 N-2 D-2 C0 Q-1 E-1 G0 H-2 I-1 L-1 K-1 M-1 F-2 P-1 S1 T0 W-3 Y-2 V0",
    "R": "A-1 R5 N0 D-2 C-3 Q1 E0 G-2 H0 I-3 L-2 K2 M-1 F-3 P-2 S-1 T-1 W-3 Y-2 V-3",
    "N": "A-2 R0 N6 D1 C-3 Q0 E0 G0 H1 I-3 L-3 K0 M-2 F-3 P-2 S1 T0 W-4 Y-2 V-3",
    "D": "A-2 R-2 N1 D6 C-3 Q0 E2 G-1 H-1 I-3 L-4 K-1 M-3 F-3 P-1 S0 T-1 W-4 Y-3 V-3",
    "C": "A0 R-3 N-3 D-3 C9 Q-3 E-4 G-3 H-3 I-1 L-1 K-3 M-1 F-2 P-3 S-1 T-1 W-2 Y-2 V-1",
    "Q": "A-1 R1 N0 D0 C-3 Q5 E2 G-2 H0 I-3 L-2 K1 M0 F-3 P-1 S0 T-1 W-2 Y-1 V-2",
    "E": "A-1 R0 N0 D2 C-4 Q2 E5 G-2 H0 I-3 L-3 K1 M-2 F-3 P-1 S0 T-1 W-3 Y-2 V-2",
    "G": "A0 R-2 N0 D-1 C-3 Q-2 E-2 G6 H-2 I-4 L-4 K-2 M-3 F-3 P-2 S0 T-2 W-2 Y-3 V-3",
    "H": "A-2 R0 N1 D-1 C-3 Q0 E0 G-2 H8 I-3 L-3 K-1 M-2 F-1 P-2 S-1 T-2 W-2 Y2 V-3",
    "I": "A-1 R-3 N-3 D-3 C-1 Q-3 E-3 G-4 H-3 I4 L2 K-3 M1 F0 P-3 S-2 T-1 W-3 Y-1 V3",
    "L": "A-1 R-2 N-3 D-4 C-1 Q-2 E-3 G-4 H-3 I2 L4 K-2 M2 F0 P-3 S-2 T-1 W-2 Y-1 V1",
    "K": "A-1 R2 N0 D-1 C-3 Q1 E1 G-2 H-1 I-3 L-2 K5 M-1 F-3 P-1 S0 T-1 W-3 Y-2 V-2",
    "M": "A-1 R-1 N-2 D-3 C-1 Q0 E-2 G-3 H-2 I1 L2 K-1 M5 F0 P-2 S-1 T-1 W-1 Y-1 V1",
    "F": "A-2 R-3 N-3 D-3 C-2 Q-3 E-3 G-3 H-1 I0 L0 K-3 M0 F6 P-4 S-2 T-2 W1 Y3 V-1",
    "P": "A-1 R-2 N-2 D-1 C-3 Q-1 E-1 G-2 H-2 I-3 L-3 K-1 M-2 F-4 P7 S-1 T-1 W-4 Y-3 V-2",
    "S": "A1 R-1 N1 D0 C-1 Q0 E0 G0 H-1 I-2 L-2 K0 M-1 F-2 P-1 S4 T1 W-3 Y-2 V-2",
    "T": "A0 R-1 N0 D-1 C-1 Q-1 E-1 G-2 H-2 I-1 L-1 K-1 M-1 F-2 P-1 S1 T5 W-2 Y-2 V0",
    "W": "A-3 R-3 N-4 D-4 C-2 Q-2 E-3 G-2 H-2 I-3 L-2 K-3 M-1 F1 P-4 S-3 T-2 W11 Y2 V-3",
    "Y": "A-2 R-2 N-2 D-3 C-2 Q-1 E-2 G-3 H2 I-1 L-1 K-2 M-1 F3 P-3 S-2 T-2 W2 Y7 V-1",
    "V": "A0 R-3 N-3 D-3 C-1 Q-2 E-2 G-3 H-3 I3 L1 K-2 M1 F-1 P-2 S-2 T0 W-3 Y-1 V4",
}


def _parse_b62() -> np.ndarray:
    m = np.zeros((20, 20), dtype=np.int32)
    for row_aa, spec in _B62_ROWS.items():
        for entry in spec.split():
            col_aa = entry[0]
            m[AA_TO_INT[row_aa], AA_TO_INT[col_aa]] = int(entry[1:])
    assert (m == m.T).all()
    return m


BLOSUM62 = _parse_b62()

# Per-amino-acid substitution candidate order used by the Greedy search:
# the 19 other AAs sorted by descending BLOSUM62 score, with the exact
# tie-break order of the reference's hard-coded lists
# (reference: ConsumerThread.cpp:10-30).  The tie order is load-bearing: the
# Greedy loop breaks at the first substitution whose score bound fails, and
# queue insertion order for equal scores is FIFO.
BLOSUM_SUBST = {
    "A": "SVTGCPMKLIEQRYFHDNW",
    "R": "KQHENTSMAYPLGDVWFIC",
    "N": "SHDTKGEQRYPMAVFLICW",
    "D": "ENSQTPKHGRAVYFMICWL",
    "C": "AVTSMLIYWFPKHGQDNRE",
    "Q": "EKRSMHDNYTPAVWLGFIC",
    "E": "QDKSHNRTPAVYMGWFLIC",
    "G": "SNADWTPKHEQRVYFMCLI",
    "H": "YNEQRSFKDWTPMGAVLIC",
    "I": "VLMFYTCASWPKHEQDNRG",
    "L": "MIVFYTCAWSKQRPHENGD",
    "K": "REQSNTPMHDAVYLGWFIC",
    "M": "LVIFQYWTSKCRAPHENGD",
    "F": "YWMLIVHTSCAKGEQDNRP",
    "P": "TSKEQDAVMHGNRYLICWF",
    "S": "TNAKGEQDPMHCRVYFLIW",
    "T": "SVNAPMKLIEQCDRYWFHG",
    "W": "YFMTLHGQCVSKIERAPDN",
    "Y": "FWHVMLIQTSKECNRAPGD",
    "V": "IMLTAYFCSPKEQWHGDNR",
}


def _check_subst_order() -> None:
    # Sanity: each list must be the 19 non-identical AAs in non-increasing
    # BLOSUM62 score order (ties broken by the reference's fixed order).
    for aa, subs in BLOSUM_SUBST.items():
        assert len(subs) == 19 and aa not in subs
        scores = [BLOSUM62[AA_TO_INT[aa], AA_TO_INT[s]] for s in subs]
        assert all(scores[i] >= scores[i + 1] for i in range(18)), aa


_check_subst_order()

# ---------------------------------------------------------------------------
# Genetic code.  Codon integer code packs 2-bit nucleotides as
# (n0 << 4) | (n1 << 2) | n2 with A=0 C=1 G=2 T/U=3
# (reference: ConsumerThread.cpp:32-43, 869-875).
# ---------------------------------------------------------------------------
NUC_ORDER = "ACGT"
_CODON_TABLE = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}


def _codon_tables():
    """codon2aa char table (64 entries) indexed by 6-bit packed codon."""
    codon2aa = np.full(64, ord("*"), dtype=np.uint8)
    n2i = {c: i for i, c in enumerate(NUC_ORDER)}
    for codon, aa in _CODON_TABLE.items():
        idx = (n2i[codon[0]] << 4) | (n2i[codon[1]] << 2) | n2i[codon[2]]
        codon2aa[idx] = ord(aa)
    return codon2aa


CODON2AA = _codon_tables()

# nuc2int / complement nuc2int over raw bytes (255 = invalid)
# (reference: ConsumerThread.cpp:32-43)
NUC2INT = np.full(256, 255, dtype=np.uint8)
COMPNUC2INT = np.full(256, 255, dtype=np.uint8)
for _c, _v in [("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)]:
    NUC2INT[ord(_c)] = NUC2INT[ord(_c.lower())] = _v
    COMPNUC2INT[ord(_c)] = COMPNUC2INT[ord(_c.lower())] = 3 - _v

# Karlin-Altschul parameters for ungapped BLOSUM62
# (reference: ConsumerThread.hpp:41-44, provenance blast_stat.c:263)
LAMBDA = 0.3176
LN_K = -2.009915479  # K = 0.134
LN_2 = 0.6931471805
