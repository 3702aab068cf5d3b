"""The FM index split into S contiguous shards (K16, ``--mesh-index S``).

The counterpart of kaiju_tpu/parallel/sharded_index.py, with its layout:
shard o owns the BWT blocks [o nb_s, (o + 1) nb_s), nb_s = ceil(nb / S),
the SA sample slots [o ns_s, (o + 1) ns_s) and, on an index with a text
copy, the text bytes of the 128-byte rows [o ntb_s, (o + 1) ntb_s), the
row ranges that match the BWT shards.  The last shard is padded as
kaiju_tpu pads it: blocks of byte 31 with the last occ row repeated, zero
samples, zero text.

A shard of rank records is its nb_s rows of the port's ``rec`` plus one
end row.  Those rows carry the global occ counts, so the owner's row
answers FMindex(c, k) by itself: C[c] + its occ word + the count in the
block, which is ``_sharded_fmindex``'s C[c] + shard_base[owner, c] +
occ_local[owner][k >> 7 - owner nb_s, c] + the same count
(tests/test_torch_sharded.py holds the two equal).  The JAX program
assembles each step's value with a psum over the index axis of its mesh;
the kernels read the owner's row directly (``kt::ShardIx``,
csrc/fm_common.cuh), through a device table of shard pointers.

Every shard is a tensor of its own.  In one process on one card all S
shards live there.  Over the D cards of one process (``on_cards``:
``kaiju --mesh-index S`` without ``--dist-*``, every visible card) card c
holds shard c mod S for D >= S and the shards o with o mod D = c for D < S
(``peer_shards.held``, kaiju_tpu's mesh of the process's devices with the
index axis innermost), each allocated once on each card that holds it,
and reads every other shard in place from card ``peer_shards.source(o,
D)`` over NVLink (peer access, ``peer_shards.enable_peer``); each card has
a view of its own (pointer tables, ``C``, ``seq_tax``, ``rank_start``),
and with D = 1 that view is the one-card layout.  Over a group of N > 1
processes of D cards each (``in_group``), slot p D + c, card c of process
p, holds ``peer_shards.held`` over the N D slots, uploads only those, and
reads every other shard from a card of its process that holds it, or maps
it from a process of its host that holds it (``parallel.peer_shards``,
CUDA IPC on the card): the same layout, only the pointers in the tables
change.  Over a group whose processes lie on several hosts, a shard that
no slot of this host holds is remote (``remote``: its part is None, its
pointers 0): each card's ``exchange`` (``parallel.exchange.Exchange``,
card to card over NCCL where every slot of the group has a card of its
own, else over gloo) runs the rounds in which its owner serves its rows,
samples and text rows, and only the hosts kernels (N, O, Q, W, U, X, V,
Y) read such a view.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.core import BLOCK, KaijuIndex
from ..ops.device_index import (Shards, build_fused_records, extend_all,
                                extend_all_plain, sa_lookup, sa_lookup_plain)
from . import exchange, multihost, peer_shards
from .peer_shards import PeerShards


def _split(a: np.ndarray, S: int, per: int, extra: int, fill) -> list:
    """S arrays of a's rows [o per, o per + per + extra), a padded with
    rows of `fill` to S per + extra rows."""
    need = S * per + extra - a.shape[0]
    if need > 0:
        pad = np.broadcast_to(fill, (need, *a.shape[1:])).astype(a.dtype)
        a = np.concatenate([a, pad])
    return [a[o * per:o * per + per + extra] for o in range(S)]


def _put(a, where: torch.device) -> torch.Tensor:
    """A copy of a on `where`: every shard is an allocation of its own."""
    return torch.from_numpy(np.array(a)).to(where)


class _Host:
    """The host side of an index in S shards, built once: the split parts
    ({array: S numpy parts}), each array's rows a shard and whole length,
    and the replicated arrays and scalars."""

    def __init__(self, index: KaijuIndex, S: int):
        if S < 1:
            raise ValueError(f"--mesh-index must be >= 1, got {S}")
        self.S = S
        self.C = np.asarray(index.C, dtype=np.int32)
        self.seq_tax = np.asarray(index.seq_taxids, dtype=np.int32)
        self.nseq = int(index.nseq)
        self.chpt_exp = int(index.chpt_exp)
        rec = build_fused_records(index)
        nb = rec.shape[0] - 1
        self.nb_s = -(-nb // S)
        sa_seq = np.asarray(index.sa_seq, dtype=np.int32)
        ns = sa_seq.shape[0]
        self.ns_s = max(1, -(-ns // S))
        self.parts = {
            "rec": _split(rec, S, self.nb_s, 1, rec[-1]),
            "sa_seq": _split(sa_seq, S, self.ns_s, 0, 0),
            "sa_off": _split(np.asarray(index.sa_off, dtype=np.int32), S,
                             self.ns_s, 0, 0)}
        self.size = {"rec": (self.nb_s, nb + 1), "sa_seq": (self.ns_s, ns),
                     "sa_off": (self.ns_s, ns)}
        self.rank_start = None
        self.ntb_s = 0
        if index.text is not None:
            text = np.asarray(index.text, dtype=np.uint8)
            ntb = -(-text.shape[0] // BLOCK)
            self.ntb_s = max(1, -(-ntb // S))
            self.parts["text"] = _split(text, S, self.ntb_s * BLOCK, 0, 0)
            self.size["text"] = (self.ntb_s * BLOCK, text.shape[0])
            self.rank_start = index.rank_text_starts().astype(np.int32)


class ShardedIndex:
    """The arrays of DeviceIndex (ops/device_index.py) with ``rec``,
    ``sa_seq``, ``sa_off`` and ``text`` as ``Shards`` of S parts; ``C``,
    ``seq_tax`` and ``rank_start`` are replicated.  nb_s, ns_s and ntb_s
    are the blocks, sample slots and text rows of a shard.  One object is
    the view of one card (``device``), which the kernels read there.

    ``held`` lists the shards this card holds, ``reads`` maps each shard
    held by another card of this process (``on_cards``, ``in_group``) to
    that card's place among ``cards``, ``opened`` each shard mapped from
    another process to that process (``opened_slot``: to its slot), and
    ``remote`` each shard served in rounds to the process that serves it;
    ``cards`` lists the process's cards and ``slot`` is this one's place
    among them, and ``shared`` is a dict that the views of one placement
    share (the host seed tables, sharded_fused)."""

    def __init__(self, index: KaijuIndex, n_shards: int, device=None):
        host = _Host(index, int(n_shards))
        dev = multihost.numbered(device)
        self._set(host, [dev], 0, {k: [_put(p, dev) for p in v]
                                   for k, v in host.parts.items()},
                  list(range(host.S)))

    @classmethod
    def in_group(cls, index: KaijuIndex, n_shards: int, cards: list,
                 group) -> list["ShardedIndex"]:
        """The index in n_shards shards over the slots of a group of
        processes (`group`, of more than one process; every process calls
        it together, each with its D cards, ``multihost.process_cards``):
        one view a card, in order, card c being slot rank D + c.  Each card
        holds its shards (``peer_shards.slot_routes``), reads the shards
        of another card of this process in place, with peer access enabled
        where the two cards differ (raises where they have none), and maps
        the shards of another process of its host; ``share`` (the group's
        ``PeerShards``, shared by the views) releases them.  Over several
        hosts each card has an ``exchange`` of its own, over a group of
        its card index (``multihost.card_groups``: D groups made in the
        same order in every process, since the D cards run their rounds
        at once) on the transport that every slot's physical card gives
        (``exchange.transport``, from the slots gathered here, so that
        every process decides alike): NCCL where no two slots share a
        card, else gloo.  The host records are built once."""
        import torch.distributed as dist

        host = _Host(index, int(n_shards))
        cards = [multihost.numbered(c) for c in cards]
        share = PeerShards(cards, host.S, group)
        parts = share.parts(host.parts)
        D = len(cards)
        if share.spans_hosts:  # rounds: the transport and its groups
            slots = [None] * dist.get_world_size(group)
            dist.all_gather_object(slots, [exchange.card_identity(c)
                                           for c in cards], group=group)
            backend = exchange.transport(slots)
            groups = multihost.card_groups(group, cards, backend)
        shared: dict = {}
        views = []
        for c in range(D):
            for h in share.reads[c].values():
                peer_shards.enable_peer(cards[c], cards[h])
            view = cls.__new__(cls)
            view._set(host, cards, c, parts[c], share.held[c],
                      opened={o: g // D for o, g in share.opened[c].items()},
                      reads=share.reads[c], remote=share.remote[c])
            view.opened_slot = dict(share.opened[c])
            view.share = share
            view.host = share.hosts[share.pid]
            view.shared = shared
            if share.spans_hosts:  # the group's hosts differ: rounds
                view.exchange = exchange.Exchange(view, groups[c], [
                    view.remote.get(o, share.pid) for o in range(view.S)],
                    backend)
            views.append(view)
        return views

    @classmethod
    def on_cards(cls, index: KaijuIndex, n_shards: int,
                 cards: list) -> list["ShardedIndex"]:
        """The index in n_shards shards over the cards of one process
        (``multihost.local_cards``; a card may repeat, as CPU slots do):
        one view a card, in order.  Card c of D holds ``peer_shards.held(c,
        D, S)``, each of its shards allocated once on it, and reads every
        other shard o from card ``peer_shards.source(o, D)``, with peer
        access enabled for it where the two are distinct cards (raises
        where they have none).  The host records are built once."""
        host = _Host(index, int(n_shards))
        S, D = host.S, len(cards)
        cards = [torch.device(c) for c in cards]
        held = [peer_shards.held(c, D, S) for c in range(D)]
        shared: dict = {}  # what the cards' pipelines compute once
        mine = [{k: {o: _put(v[o], cards[c]) for o in held[c]}
                 for k, v in host.parts.items()} for c in range(D)]
        views = []
        for c in range(D):
            reads = {o: peer_shards.source(o, D) for o in range(S)
                     if o not in held[c]}
            for o, h in reads.items():
                peer_shards.enable_peer(cards[c], cards[h])
            parts = {k: [mine[c][k][o] if o in held[c]
                         else mine[reads[o]][k][o] for o in range(S)]
                     for k in host.parts}
            view = cls.__new__(cls)
            view._set(host, cards, c, parts, held[c], reads=reads)
            view.shared = shared
            views.append(view)
        return views

    def _set(self, host: _Host, cards: list, slot: int, parts: dict,
             held: list, opened=None, reads=None, remote=None):
        dev = self.device = cards[slot]
        self.cards, self.slot = list(cards), slot
        self.S = host.S
        self.nb_s, self.ns_s, self.ntb_s = host.nb_s, host.ns_s, host.ntb_s
        self.nseq, self.chpt_exp = host.nseq, host.chpt_exp
        self.C = _put(host.C, dev)
        self.seq_tax = _put(host.seq_tax, dev)
        self.rank_start = (None if host.rank_start is None
                           else _put(host.rank_start, dev))
        self.held = list(held)
        self.opened = dict(opened or {})
        self.reads = dict(reads or {})
        self.remote = dict(remote or {})
        self.opened_slot = dict(self.opened)
        self.share = None
        self.exchange = None
        self.host = None
        self.shared: dict = {}
        peer = set(self.opened) | set(self.reads)
        sh = {k: Shards(parts[k], *host.size[k], dev, peer) for k in parts}
        self.rec, self.sa_seq, self.sa_off = (sh["rec"], sh["sa_seq"],
                                              sh["sa_off"])
        self.text = sh.get("text")

    @property
    def has_text(self) -> bool:
        return self.text is not None

    def layout(self) -> dict:
        """The shards this card holds and reads: {"card": its device,
        "host": its host in a group (else None), "slot": its slot in the
        group (else its place among the cards), "held": [o, ...],
        "opened": {o: process}, "opened_slot": {o: slot},
        "reads": {o: place of the holding card among the cards},
        "remote": {o: process that serves it in rounds}, "bytes_held",
        "bytes_opened", "bytes_read", "bytes_remote": {array: bytes}}."""
        arrays = {"rec": self.rec, "sa_seq": self.sa_seq,
                  "sa_off": self.sa_off, "text": self.text}

        def nbytes(shards):
            out = {}
            for k, a in arrays.items():
                if a is None:
                    continue
                one = next(p for p in a.parts if p is not None).nbytes
                out[k] = one * len(shards)  # every shard has one size
            return out

        slot = self.slot
        if self.share is not None:
            slot += self.share.pid * self.share.D
        return {"card": str(self.device), "host": self.host, "slot": slot,
                "held": list(self.held), "opened": dict(self.opened),
                "opened_slot": dict(self.opened_slot),
                "reads": dict(self.reads), "remote": dict(self.remote),
                "bytes_held": nbytes(self.held),
                "bytes_opened": nbytes(self.opened),
                "bytes_read": nbytes(self.reads),
                "bytes_remote": nbytes(self.remote)}


# ---------------------------------------------------------------------------
# the sharded primitives (K16b, K16c)
# ---------------------------------------------------------------------------


def sharded_extend_all(sh: ShardedIndex, codes, flen):
    """make_sharded_extend_all (kaiju_tpu/parallel/sharded_index.py:123-182):
    (start, si0, si1) int32 [F, L] for codes uint8 [F, L] and flen int32
    [F], ranks from the owner shards.  Kernel J's sharded instantiation for
    CUDA tensors, the plain version for CPU tensors."""
    return extend_all(sh.rec, sh.C, codes, flen)


def sharded_extend_all_plain(sh: ShardedIndex, codes, flen, touched=None):
    return extend_all_plain(sh.rec, sh.C, codes, flen, touched)


def sharded_sa_lookup(sh: ShardedIndex, k):
    """make_sharded_sa_lookup (:185-270): (iseq, pos) int32 [N] of the SA
    positions k int32 [N], each LF step's BWT byte and rank and the SA
    sample from their owner.  Kernel H's sharded instantiation for CUDA
    tensors, the plain version for CPU tensors."""
    return sa_lookup(sh.rec, sh.C, sh.sa_seq, sh.sa_off, sh.nseq,
                     sh.chpt_exp, k)


def sharded_sa_lookup_plain(sh: ShardedIndex, k, touched=None):
    return sa_lookup_plain(sh.rec, sh.C, sh.sa_seq, sh.sa_off, sh.nseq,
                           sh.chpt_exp, k, touched)
