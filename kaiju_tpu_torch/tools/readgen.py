"""Synthetic read generation: reads derived from DB proteins by reverse
translation (with mutations / reverse-complement / junk), so MEM and
Greedy paths all get exercised.  The generator of the repository's tests
and benchmark, copied so that the port needs nothing outside itself."""

import random

_CODONS = {}
_CODON_TABLE = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}
for _c, _a in _CODON_TABLE.items():
    _CODONS.setdefault(_a, []).append(_c)

_COMP = str.maketrans("ACGT", "TGCA")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def reverse_translate(rng: random.Random, protein: str) -> str:
    return "".join(rng.choice(_CODONS[a]) for a in protein)


def make_reads(rng: random.Random, records, n: int = 120):
    """List of (name, dna) reads."""
    reads = []
    for i in range(n):
        kind = i % 6
        name = f"read{i:04d}"
        if kind == 5:  # random junk
            dna = "".join(rng.choice("ACGT") for _ in range(rng.randint(40, 200)))
        else:
            _, prot = records[rng.randrange(len(records))]
            plen = rng.randint(12, min(60, len(prot)))
            start = rng.randrange(0, len(prot) - plen + 1)
            sub = prot[start : start + plen]
            dna = reverse_translate(rng, sub)
            if kind == 1:  # point mutations in DNA
                dna = list(dna)
                for _ in range(rng.randint(1, 4)):
                    p = rng.randrange(len(dna))
                    dna[p] = rng.choice("ACGT")
                dna = "".join(dna)
            elif kind == 2:  # reverse complement
                dna = revcomp(dna)
            elif kind == 3:  # flanked by junk
                dna = (
                    "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 25)))
                    + dna
                    + "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 25)))
                )
            elif kind == 4:  # short read
                dna = dna[: rng.randint(20, 40)]
        reads.append((name, dna))
    return reads


def make_protein_reads(rng: random.Random, records, n: int = 60):
    reads = []
    aas = "ACDEFGHIKLMNPQRSTVWY"
    for i in range(n):
        kind = i % 4
        name = f"prot{i:04d}"
        if kind == 3:
            prot = "".join(rng.choice(aas) for _ in range(rng.randint(8, 80)))
        else:
            _, p = records[rng.randrange(len(records))]
            plen = rng.randint(8, min(70, len(p)))
            start = rng.randrange(0, len(p) - plen + 1)
            prot = p[start : start + plen]
            if kind == 1:  # mutate
                prot = list(prot)
                for _ in range(rng.randint(1, 3)):
                    q = rng.randrange(len(prot))
                    prot[q] = rng.choice(aas)
                prot = "".join(prot)
            elif kind == 2:  # embed junk chars (split points)
                prot = prot[: len(prot) // 2] + "x*" + prot[len(prot) // 2 :]
        reads.append((name, prot))
    return reads


def gen_realistic(rng: random.Random, letters: int):
    """A protein DB of at least `letters` letters with repeats, as
    (name, sequence) records: gene families whose base gene is copied
    exactly (under other taxa) and at ~90 % identity, salted with
    low-complexity runs (homopolymers and dipeptide repeats).  The
    benchmark's generator (bench.py), copied so that the port needs
    nothing outside itself; the same rng state gives the same records."""
    aas = "ACDEFGHIKLMNPQRSTVWY"
    records = []
    total = 0
    i = 0
    while total < letters:
        base = "".join(rng.choices(aas, k=rng.randint(150, 450)))
        fam = rng.randint(1, 6)  # copies of this family
        for c in range(fam):
            seq = base
            if c > 0 and rng.random() < 0.7:
                # ~90%-identity mutant
                s = list(seq)
                for _ in range(max(1, len(s) // 10)):
                    s[rng.randrange(len(s))] = rng.choice(aas)
                seq = "".join(s)
            if rng.random() < 0.10:
                # low-complexity insertion (homopolymer / dipeptide run)
                run = (rng.choice(aas) * rng.randint(8, 30)
                       if rng.random() < 0.5
                       else (rng.choice(aas) + rng.choice(aas))
                       * rng.randint(6, 15))
                p = rng.randrange(len(seq))
                seq = seq[:p] + run + seq[p:]
            records.append((f"ACC{i:07d}.1_{100 + i % 97}", seq))
            total += len(seq)
            i += 1
    return records


def write_fastq(reads, path):
    with open(path, "w") as fh:
        for name, seq in reads:
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


def write_reads_fasta(reads, path):
    with open(path, "w") as fh:
        for name, seq in reads:
            fh.write(f">{name}\n{seq}\n")
