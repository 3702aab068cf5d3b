"""Index alphabet and query translation.

The alphabet is a property of the index: terminator first, then letters.
kaiju-makedb builds databases with `-a ACDEFGHIKLMNPQRSTVWY`
(reference: util/kaiju-makedb:176 etc.), giving "*ACDEFGHIKLMNPQRSTVWY"
(alen=21) where code 0 = terminator, 1..20 = amino acids, and any other
letter maps to the LAST alphabet letter (the "wildcard", here 'Y') — that is
the translation_table semantics of sequence.c:68-97 with dummy = last char.
`kaiju-mkbwt -a protein` instead gives "*ACDEFGHIKLMNPQRSTVWYX" (alen=22,
wildcard X; reference: mkbwt.c:892).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..constants import AA_ORDER

# Default: what kaiju-makedb produces (alen = 21, wildcard = Y)
MAKEDB_ALPHABET = "*ACDEFGHIKLMNPQRSTVWY"
# `-a protein` variant (alen = 22, wildcard = X)
PROTEIN_ALPHABET = "*ACDEFGHIKLMNPQRSTVWYX"

# mkbwt's named alphabets (reference: mkbwt.c:882-903 read_alphabet)
NAMED_ALPHABETS = {
    "DNA": "*ACGTN",
    "RNA": "*ACGUN",
    "protein": PROTEIN_ALPHABET,
}

# base complements for -r reverse-complement duplication
# (reference: readFasta.c "complement is TGCAN for ACGTN")
DNA_COMPLEMENT = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def revcomp_dna(seq: str) -> str:
    return seq.translate(DNA_COMPLEMENT)[::-1]


@lru_cache(maxsize=None)
def trans_table(alphabet: str = MAKEDB_ALPHABET,
                case_sens: bool = False) -> np.ndarray:
    """256-entry byte -> code table (int16; -1 = invalid non-letter).

    Mirrors translation_table (reference: sequence.c:68-97): alpha chars not
    in the alphabet get the wildcard code (last letter), case-insensitive
    unless case_sens (mkbwt -c), non-letters -> -1, NUL -> 0.
    """
    table = np.full(256, -1, dtype=np.int16)
    table[0] = 0
    wildcard = len(alphabet) - 1
    for i in range(1, 128):
        if chr(i).isalpha():
            table[i] = wildcard
    for code, ch in enumerate(alphabet):
        table[ord(ch)] = code
        if not case_sens:
            table[ord(ch.upper())] = code
            table[ord(ch.lower())] = code
    return table


@lru_cache(maxsize=None)
def score_to_code(alphabet: str = MAKEDB_ALPHABET) -> np.ndarray:
    """Index code (1..20) for each scoring index (AA_ORDER position)."""
    return np.array([alphabet.index(c) for c in AA_ORDER], dtype=np.int32)


@lru_cache(maxsize=None)
def code_to_score(alphabet: str = MAKEDB_ALPHABET) -> np.ndarray:
    """Scoring index for each alphabet code (terminator/wildcard -> -1).

    Note: for the makedb alphabet the wildcard IS 'Y', a real amino acid, so
    only code 0 maps to -1 there."""
    out = np.full(len(alphabet), -1, dtype=np.int32)
    for s, c in enumerate(score_to_code(alphabet)):
        out[c] = s
    return out


def encode_protein(seq: str, alphabet: str = MAKEDB_ALPHABET) -> np.ndarray:
    """Translate a protein string to index codes (uint8), as
    translate2numbers does for query fragments (reference: sequence.c:151)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return trans_table(alphabet)[raw].astype(np.uint8)


def decode_protein(codes, alphabet: str = MAKEDB_ALPHABET) -> str:
    return "".join(alphabet[c] for c in codes)
