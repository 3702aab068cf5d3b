"""Suffix-interval result lists for the search strategies.

Replicates the reference's SI linked-list semantics (reference:
src/bwt/bwt.c:25-34 struct, 178-252 alloc/insert/trim) — a list sorted by
match length (descending) whose equal-length groups hang off a `samelen`
chain.  The traversal orders of these chains are observable in the output
(tie caps, id enumeration order), so the structure is kept 1:1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class SI:
    start: int  # SA interval [start, start+len)
    len: int
    qi: int  # query start position of the match
    ql: int  # match length
    count: int = 0
    next: Optional["SI"] = field(default=None, repr=False)
    samelen: Optional["SI"] = field(default=None, repr=False)


def insert_si_sorted(base: Optional[SI], new: SI) -> SI:
    """Insert into the length-sorted list (reference: bwt.c:225-252)."""
    new.count = new.len
    if base is None:
        return new
    if base.ql < new.ql:
        new.next = base
        new.count += base.count
        return new
    tmp = base
    while tmp.next is not None and tmp.next.ql >= new.ql:
        tmp.count += new.len
        tmp = tmp.next
    tmp.count += new.len
    if tmp.ql == new.ql:
        new.samelen = tmp.samelen
        if tmp.samelen is not None:
            new.count += tmp.samelen.count
        tmp.samelen = new
    else:
        new.next = tmp.next
        if tmp.next is not None:
            new.count += tmp.next.count
        tmp.next = new
    return base


def free_until_max_si(si: Optional[SI], maximum: int) -> int:
    """Drop shortest-length groups while keeping >= maximum matches; returns
    the min retained length, or 0 if nothing dropped
    (reference: bwt.c:205-220)."""
    if si is None or si.count <= maximum:
        return 0
    cur = si
    while cur.next is not None and si.count - cur.next.count < maximum:
        cur = cur.next
    if cur.next is not None:
        n = cur.next.count
        cur.next = None
        node = si
        while node is not None:
            node.count -= n
            node = node.next
    return cur.ql


def walk_group_heads(si: Optional[SI]):
    """Iterate in the reference's `samelen ? samelen : next` order
    (reference: ConsumerThread.cpp:477): the head's samelen chain, then —
    only when a group is a singleton — on to the next length group."""
    node = si
    while node is not None:
        yield node
        node = node.samelen if node.samelen is not None else node.next


def walk_samelen(si: Optional[SI]):
    """Iterate a samelen chain only (reference: ConsumerThread.cpp:837-845)."""
    node = si
    while node is not None:
        yield node
        node = node.samelen
