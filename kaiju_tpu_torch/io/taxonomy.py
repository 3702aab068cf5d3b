"""NCBI taxonomy parsing and LCA computation.

Host-side equivalents of the reference taxonomy utilities
(reference: src/util.cpp:79-263), plus a dense-array representation that the
device LCA kernel (kaiju_tpu.ops.lca) consumes.
"""

from __future__ import annotations

import sys
from typing import Iterable

import numpy as np


def _parse_two_ints(line: str) -> tuple[int, int] | None:
    """First two integer fields of a dmp line (reference: util.cpp:84-90)."""
    i = 0
    n = len(line)
    while i < n and line[i].isdigit():
        i += 1
    if i == 0:
        return None
    a = int(line[:i])
    j = i
    while j < n and not line[j].isdigit():
        j += 1
    k = j
    while k < n and line[k].isdigit():
        k += 1
    if k == j:
        return None
    return a, int(line[j:k])


def parse_nodes_dmp(path: str) -> dict[int, int]:
    """taxid -> parent taxid (reference: util.cpp:79-99)."""
    nodes: dict[int, int] = {}
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            pair = _parse_two_ints(line)
            if pair is None:
                print(f"Found bad number in line: {line}", file=sys.stderr)
                continue
            nodes.setdefault(pair[0], pair[1])
    return nodes


def parse_nodes_dmp_with_rank(path: str) -> tuple[dict[int, int], dict[int, str]]:
    """taxid -> parent and taxid -> rank (reference: util.cpp:123-154)."""
    nodes: dict[int, int] = {}
    ranks: dict[int, str] = {}
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            pair = _parse_two_ints(line)
            if pair is None:
                print(f"Found bad number in line: {line}", file=sys.stderr)
                continue
            node, parent = pair
            # rank = first run of [a-z ] after the parent field, lstripped of
            # non-lowercase prefix (reference: util.cpp:137-141)
            rest = line
            # re-locate end of parent field
            i = 0
            while i < len(rest) and rest[i].isdigit():
                i += 1
            while i < len(rest) and not rest[i].isdigit():
                i += 1
            while i < len(rest) and rest[i].isdigit():
                i += 1
            j = i
            while j < len(rest) and not ("a" <= rest[j] <= "z"):
                j += 1
            k = j
            while k < len(rest) and ("a" <= rest[k] <= "z" or rest[k] == " "):
                k += 1
            nodes.setdefault(node, parent)
            ranks.setdefault(node, rest[j:k])
    return nodes, ranks


def parse_names_dmp(path: str) -> dict[int, str]:
    """taxid -> scientific name (reference: util.cpp:156-179)."""
    names: dict[int, str] = {}
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or "scientific name" not in line:
                continue
            fields = [f.strip() for f in line.split("|")]
            try:
                taxid = int(fields[0])
            except (ValueError, IndexError):
                print(f"Found bad number in line: {line}", file=sys.stderr)
                continue
            names.setdefault(taxid, fields[1])
    return names


def parse_merged_dmp(path: str) -> dict[int, int]:
    """old taxid -> new taxid (reference: util.cpp:101-121)."""
    merged: dict[int, int] = {}
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            pair = _parse_two_ints(line)
            if pair is None:
                continue
            merged.setdefault(pair[0], pair[1])
    return merged


class Taxonomy:
    """Parent-map taxonomy with memoized depths and reference-exact LCA."""

    def __init__(self, nodes: dict[int, int]):
        self.nodes = nodes
        self._depth: dict[int, int] = {}

    @classmethod
    def from_nodes_dmp(cls, path: str) -> "Taxonomy":
        return cls(parse_nodes_dmp(path))

    def depth(self, taxid: int) -> int:
        """Distance-to-root + 1 (reference: util.cpp:217-223)."""
        d = self._depth.get(taxid)
        if d is not None:
            return d
        depth = 1
        node = taxid
        nodes = self.nodes
        while node in nodes and node != nodes[node]:
            depth += 1
            node = nodes[node]
        self._depth[taxid] = depth
        return depth

    def is_ancestor(self, node1: int, node2: int) -> bool:
        """True if node1 is an ancestor of node2 or equal
        (reference: util.cpp:63-77)."""
        nodes = self.nodes
        if node1 not in nodes or node2 not in nodes:
            return False
        if node1 == node2:
            return True
        while node2 in nodes and node2 != nodes[node2]:
            node2 = nodes[node2]
            if node2 == node1:
                return True
        return False

    def lca(self, ids: Iterable[int], verbose: bool = False) -> int:
        """LCA of a set of taxids, replicating util.cpp:194-263 exactly:
        ids missing from the tree are dropped (0 if none remain); all ids
        are lifted to the shallowest depth, then climbed in lock-step."""
        ids = list(ids)
        if len(ids) == 1:
            return ids[0]
        nodes = self.nodes
        leafs = []
        shallowest = None
        for taxid in ids:
            if taxid not in nodes:
                if verbose:
                    print(
                        f"Warning: Taxon ID {taxid} in database is not "
                        "contained in taxonomic tree.",
                        file=sys.stderr,
                    )
                continue
            leafs.append(taxid)
            d = self.depth(taxid)
            if shallowest is None or d < shallowest:
                shallowest = d
        if not leafs:
            return 0
        leafs = [self._lift(t, self.depth(t) - shallowest) for t in leafs]
        while True:
            first = leafs[0]
            if all(x == first for x in leafs):
                return first
            leafs = [nodes[x] for x in leafs]

    def _lift(self, taxid: int, steps: int) -> int:
        nodes = self.nodes
        for _ in range(steps):
            taxid = nodes[taxid]
        return taxid

    def name_path(self, taxid: int, names: dict[int, str]) -> list[str]:
        """Root-to-leaf list of scientific names (for krona / -p output)."""
        path = []
        nodes = self.nodes
        node = taxid
        while node in nodes:
            path.append(names.get(node, f"taxonid:{node}"))
            if node == nodes[node]:
                break
            node = nodes[node]
        return list(reversed(path))

    # ---- dense arrays for the device LCA kernel -------------------------

    def dense_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(parent, depth) dense int32 arrays indexed by taxid.

        parent[t] = parent taxid (or 0 if t not in the tree; parent[0] = 0).
        depth[t] = reference depth (root = ...), 0 for absent taxids.
        Used by kaiju_tpu.ops.lca for on-device batched LCA.
        """
        max_id = max(self.nodes) if self.nodes else 0
        parent = np.zeros(max_id + 1, dtype=np.int32)
        depth = np.zeros(max_id + 1, dtype=np.int32)
        for t, p in self.nodes.items():
            parent[t] = p
        for t in self.nodes:
            depth[t] = self.depth(t)
        return parent, depth
