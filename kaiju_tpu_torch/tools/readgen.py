"""Synthetic read generation: reads derived from DB proteins by reverse
translation (with mutations / reverse-complement / junk), so MEM and
Greedy paths all get exercised.  The generator of the repository's tests
and benchmark, copied so that the port needs nothing outside itself.
Also a taxonomy of NCBI's size and depth (``deep_taxonomy``) for timing
the LCA kernels on lineages as long as the ones Kaiju's users classify
against."""

import math
import random

import numpy as np

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


def gen_realistic(rng: random.Random, letters: int, families=None):
    """A protein DB of at least `letters` letters with repeats, as
    (name, sequence) records: gene families whose base gene is copied
    exactly (under other taxa) and at ~90 % identity, salted with
    low-complexity runs (homopolymers and dipeptide repeats).  The
    benchmark's generator (bench.py), copied so that the port needs
    nothing outside itself; the same rng state gives the same records.
    families: None, or a list that receives each record's family
    number."""
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
            if families is not None:
                families.append(len(records) - 1 - c)
            total += len(seq)
            i += 1
    return records


# deep_taxonomy's shape: internal ("no rank") levels below the root, the
# levels whose nodes take species, and the widest internal level
DEEP_LEVELS = 38
DEEP_SPECIES_FROM = 18
DEEP_WIDTH = 32_000


class DeepTaxonomy:
    """A random tree shaped like NCBI's nodes.dmp: ``n_species`` species
    (about 2 M) under about 440 k "no rank" clades, each species 20-40
    levels below the root (depth 21-40 as Taxonomy.depth counts it, the
    root 1), taxids drawn sparse from [2, max_taxid).  parent and depth
    are the dense int32 arrays of Taxonomy.dense_arrays (about 12 MB each
    at NCBI's size); species holds the species' taxids and internal the
    clades' (the root first), children a CSR list (child_off, child_ids)
    of every node's children by taxid."""

    def __init__(self, seed: int, n_species: int = 2_060_000,
                 max_taxid: int = 3_000_000, width: int = DEEP_WIDTH):
        rng = np.random.default_rng(seed)
        sizes = [1]
        for d in range(1, DEEP_LEVELS + 1):
            sizes.append(min(max(sizes[-1], math.ceil(2 * 1.42 ** d)),
                             width))
        n_int = sum(sizes)
        if n_int + n_species >= max_taxid - 1:
            raise ValueError("max_taxid too small for the tree")
        ids = np.empty(n_int + n_species, dtype=np.int64)
        ids[0] = 1
        ids[1:] = rng.choice(max_taxid - 2, n_int + n_species - 1,
                             replace=False) + 2
        # node i's parent as a node number: every clade of a level has a
        # child on the next level (the first ones one each), the rest
        # random; species under the clades of levels DEEP_SPECIES_FROM and
        # below, every clade of the last level with at least one
        par_node = np.zeros(n_int + n_species, dtype=np.int64)
        level_of = np.zeros(n_int + n_species, dtype=np.int32)
        start = np.cumsum([0] + sizes)
        for d in range(1, DEEP_LEVELS + 1):
            lo, n_up, n = start[d - 1], sizes[d - 1], sizes[d]
            pick = np.concatenate([np.arange(n_up),
                                   rng.integers(0, n_up, n - n_up)])
            par_node[start[d]:start[d + 1]] = lo + pick
            level_of[start[d]:start[d + 1]] = d
        lo = start[DEEP_SPECIES_FROM]
        last = start[DEEP_LEVELS]
        pick = np.concatenate([
            np.arange(last, n_int),
            rng.integers(lo, n_int, n_species - (n_int - last))])
        par_node[n_int:] = pick
        level_of[n_int:] = level_of[pick] + 1
        self.parent = np.zeros(max_taxid, dtype=np.int32)
        self.depth = np.zeros(max_taxid, dtype=np.int32)
        self.parent[ids] = ids[par_node]
        self.depth[ids] = level_of + 1
        self.internal = ids[:n_int].astype(np.int32)
        self.species = ids[n_int:].astype(np.int32)
        order = np.argsort(self.parent[ids[1:]], kind="stable")
        kids = ids[1:][order]
        self.child_off = np.zeros(max_taxid + 1, dtype=np.int64)
        np.add.at(self.child_off, self.parent[kids].astype(np.int64) + 1, 1)
        self.child_off = np.cumsum(self.child_off)
        self.child_ids = kids.astype(np.int32)

    def leaves_under(self, rng: np.random.Generator, nodes) -> np.ndarray:
        """A leaf for each of `nodes` (taxids), each found by a random
        descent from its node (a uniform child a level)."""
        cur = np.asarray(nodes, dtype=np.int64).copy()
        for _ in range(DEEP_LEVELS + 1):
            lo = self.child_off[cur]
            n = self.child_off[cur + 1] - lo
            down = n > 0
            if not down.any():
                break
            k = lo[down] + (rng.random(int(down.sum())) * n[down]).astype(
                np.int64)
            cur[down] = self.child_ids[k]
        return cur.astype(np.int32)

    def ancestor(self, taxa, up) -> np.ndarray:
        """Each of `taxa` lifted `up` levels (not past the root)."""
        cur = np.asarray(taxa, dtype=np.int64).copy()
        up = np.asarray(up)
        for u in range(int(up.max(initial=0))):
            cur = np.where(up > u, self.parent[cur], cur)
        return cur.astype(np.int32)

    def write_nodes_dmp(self, path: str) -> None:
        """nodes.dmp of the tree: taxid, parent and rank ("no rank" for the
        clades, "species") as NCBI's fields."""
        lines = []
        for taxa, rank in ((self.internal, "no rank"),
                           (self.species, "species")):
            lines += [f"{t}\t|\t{p}\t|\t{rank}\t|"
                      for t, p in zip(taxa.tolist(),
                                      self.parent[taxa].tolist())]
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")


def write_fastq(reads, path):
    with open(path, "w") as fh:
        for name, seq in reads:
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


def write_reads_fasta(reads, path):
    with open(path, "w") as fh:
        for name, seq in reads:
            fh.write(f">{name}\n{seq}\n")
