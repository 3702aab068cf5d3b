"""The index above 2^31 letters (K17): build, the sharded layout on disk,
and its loader onto the card.

The counterpart of scripts/big_classify_demo.py's ``build_db`` (:87-143),
``save_sharded_ktx`` (:146-199) and ``load_mesh`` (:206-250).  The layout
on disk is the demo's, byte for byte: per shard o its BWT blocks
``blocks_{o}.npy`` uint8 [nb_s, 128] (the last shard padded with byte
255) and its LOCAL occ checkpoints ``occ_{o}.npy`` int32 [nb_s + 1, alen]
(a shard holds fewer than 2^31 positions), beside the int64 global tables
``C.npy`` [alen + 1] and ``shard_base.npy`` [S, alen] (the counts of the
shards before o), the SA samples ``sa_seq.npy`` int32 and ``sa_off.npy``
int64 [S, ns_s], ``seq_tax.npy`` (the taxon of each content-ranked
sequence) and ``meta.json``.

``BigIndex`` puts each shard on a card as an allocation of its own:
int32 rank records [nb_s + 1, 64], words 0..31 the shard's local occ row
and words 32..63 the block's 128 bytes, and an end row (the shard's end
counts, bytes 255) that serves k at the shard's end, read by the kernels
through a table of shard pointers (``kt::BigShardIx``,
csrc/big_common.cuh).  Where the JAX program takes each owner's count with
a psum over its mesh, the kernels read the owner's row directly.  Over the
D cards of a process (``multihost.local_cards``: every visible card by
default) shard o lies on card o mod D, as the demo's ``Mesh(devs[:S]
.reshape(1, S))`` places it (:206-250): one data row, computing on the
first card, which reads the other cards' shards in place over NVLink
(peer access, ``peer_shards.enable_peer``); the replicated arrays lie on
the first card.
"""

from __future__ import annotations

import ctypes
import json
import os
import resource
import time

import numpy as np
import torch

from .. import kernels
from ..index.alphabet import MAKEDB_ALPHABET
from ..native import get_lib
from ..ops.device_index import Shards
from . import multihost, peer_shards

BLOCK = 128
INT32_CAP = 1 << 31


def log(fh, msg):
    """Print msg with the time, and write it to fh unless fh is None."""
    line = f"[{time.strftime('%H:%M:%S')}] {msg}"
    print(line, flush=True)
    if fh is not None:
        fh.write(line + "\n")
        fh.flush()


def peak_rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


# ---------------------------------------------------------------------------
# build + save
# ---------------------------------------------------------------------------


def _draw_lengths(rng, letters):
    """The demo's sequence lengths, one rng.integers(150, 451) each until
    they sum to `letters` or more, drawn as one vector: the Generator
    gives a vector the same numbers, and leaves the same state, as the
    scalar calls."""
    state = rng.bit_generator.state
    n = letters // 300 + 64
    while True:
        tot = np.cumsum(rng.integers(150, 451, size=n))
        if tot[-1] >= letters:
            break
        rng.bit_generator.state = state
        n *= 2
    n = int(np.searchsorted(tot, letters)) + 1
    rng.bit_generator.state = state
    return rng.integers(150, 451, size=n)


def make_text(fh, letters, seed, allow_small):
    """The text of build_db's DB, without its index: the dict of alen, N,
    nseq, text, starts, ends, seq_len and taxids (what
    tools.big_classify.make_reads reads)."""
    alen = len(MAKEDB_ALPHABET)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    seq_len = _draw_lengths(rng, letters).astype(np.int64)
    nseq = len(seq_len)
    tot = int(seq_len.sum())
    N = tot + nseq
    if not allow_small:
        assert N > (1 << 31) + 1_000_000, "demo must exceed the int32 cap"
    text = np.empty(N, dtype=np.uint8)
    ends = np.cumsum(seq_len + 1)
    starts = ends - seq_len - 1
    chunk = 1 << 28
    for i in range(0, N, chunk):
        j = min(N, i + chunk)
        text[i:j] = rng.integers(1, alen, size=j - i, dtype=np.uint8)
    text[ends - 1] = 0
    # taxid per INPUT sequence (bench-style star tree under root)
    taxids = (100 + np.arange(nseq, dtype=np.int64) % 97).astype(np.int32)
    log(fh, f"text ready: N={N} ({N/2**31:.2f} x 2^31) nseq={nseq} "
            f"{time.time()-t0:.0f}s RSS {peak_rss_gb():.1f}G")
    return dict(alen=alen, N=N, nseq=nseq, text=text, starts=starts,
                ends=ends, seq_len=seq_len, taxids=taxids)


def build_db(fh, letters, threads, seed, allow_small):
    """A synthetic protein DB of `letters` letters from `seed` (uniform
    codes 1..alen-1, sequences of 150..450, taxa 100 + i mod 97) indexed
    by the int64 threaded builder kt_build_bwt_big with e = 5; the demo's
    dict of arrays."""
    db = make_text(fh, letters, seed, allow_small)
    alen, N, nseq, text = db["alen"], db["N"], db["nseq"], db["text"]
    tstart = np.zeros(nseq + 1, dtype=np.int64)
    tstart[1:] = db["ends"]

    e = 5
    first = ((nseq + (1 << e) - 1) >> e) << e
    n_samples = ((N - 1) >> e) - (first >> e) + 1
    bwt = np.empty(N, dtype=np.uint8)
    content_rank = np.empty(nseq, dtype=np.int32)
    sa_seq = np.empty(n_samples, dtype=np.int32)
    sa_off64 = np.empty(n_samples, dtype=np.int64)
    t0 = time.time()
    lib = get_lib()
    rc = lib.kt_build_bwt_big(
        text.ctypes.data_as(ctypes.c_void_p),
        tstart.ctypes.data_as(ctypes.c_void_p),
        nseq, N, alen, e, threads,
        bwt.ctypes.data_as(ctypes.c_void_p),
        content_rank.ctypes.data_as(ctypes.c_void_p),
        sa_seq.ctypes.data_as(ctypes.c_void_p),
        sa_off64.ctypes.data_as(ctypes.c_void_p),
        n_samples,
    )
    assert rc == 0, f"kt_build_bwt_big rc={rc}"
    log(fh, f"BWT built in {time.time()-t0:.0f}s RSS {peak_rss_gb():.1f}G")
    db.update(e=e, first=first, bwt=bwt, content_rank=content_rank,
              sa_seq=sa_seq, sa_off=sa_off64)
    return db


def block_counts(blocks: np.ndarray, alen: int) -> np.ndarray:
    """int64 [nb, alen]: #c in each 128-byte row of blocks uint8 [nb, 128]
    (what (blocks == c).sum(axis=1) gives for each c), by one bincount
    over chunks of rows."""
    nb = blocks.shape[0]
    out = np.empty((nb, alen), dtype=np.int64)
    step = 1 << 10  # 256 K bins a pass stay in cache
    row_key = (np.arange(step, dtype=np.int32) << 8)[:, None]
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        key = blocks[b0:b1] + row_key[:b1 - b0]
        cnt = np.bincount(key.ravel(), minlength=(b1 - b0) << 8)
        out[b0:b1] = cnt.reshape(b1 - b0, 256)[:, :alen]
    return out


def save_sharded_ktx(fh, db, path, n_shards):
    """Sharded big-index layout: per-shard blocks + LOCAL int32 occ +
    int64 shard bases (each shard holds < 2^31 positions; only the
    global prefix needs 64 bits), sharded SA samples, int64 C.  The files
    are the demo's, byte for byte; returns meta."""
    os.makedirs(path, exist_ok=True)
    t0 = time.time()
    alen, N = db["alen"], db["N"]
    bwt = db["bwt"]
    nb = (N + BLOCK - 1) // BLOCK
    nb_s = -(-nb // n_shards)
    C = np.zeros(alen + 1, dtype=np.int64)
    shard_base = np.zeros((n_shards, alen), dtype=np.int64)
    run = np.zeros(alen, dtype=np.int64)
    for s in range(n_shards):
        lo, hi = s * nb_s * BLOCK, min((s + 1) * nb_s * BLOCK, N)
        blk = np.full(nb_s * BLOCK, 255, dtype=np.uint8)
        if hi > lo:
            blk[: hi - lo] = bwt[lo:hi]
        blk2 = blk.reshape(nb_s, BLOCK)
        # local occ: int32 by construction (shard < 2^31 positions)
        occ_l = np.zeros((nb_s + 1, alen), dtype=np.int32)
        occ_l[1:] = block_counts(blk2, alen)
        np.cumsum(occ_l, axis=0, out=occ_l)
        shard_base[s] = run
        run = run + occ_l[-1].astype(np.int64)
        np.save(os.path.join(path, f"blocks_{s}.npy"), blk2)
        np.save(os.path.join(path, f"occ_{s}.npy"), occ_l)
    np.cumsum(run, out=C[1:])
    ns = len(db["sa_seq"])
    ns_s = max(1, -(-ns // n_shards))
    sa_seq = np.zeros(ns_s * n_shards, np.int32)
    sa_off = np.zeros(ns_s * n_shards, np.int64)
    sa_seq[:ns] = db["sa_seq"]
    sa_off[:ns] = db["sa_off"]
    np.save(os.path.join(path, "sa_seq.npy"),
            sa_seq.reshape(n_shards, ns_s))
    np.save(os.path.join(path, "sa_off.npy"),
            sa_off.reshape(n_shards, ns_s))
    np.save(os.path.join(path, "shard_base.npy"), shard_base)
    np.save(os.path.join(path, "C.npy"), C)
    np.save(os.path.join(path, "seq_tax.npy"),
            db["taxids"][np.argsort(db["content_rank"], kind="stable")])
    meta = dict(N=int(N), nseq=int(db["nseq"]), alen=alen, e=db["e"],
                first=int(db["first"]), n_shards=n_shards, nb_s=int(nb_s),
                ns_s=int(ns_s))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    sz = sum(os.path.getsize(os.path.join(path, f))
             for f in os.listdir(path))
    log(fh, f"sharded ktx saved: {sz/1e9:.2f} GB in {time.time()-t0:.0f}s "
            f"({n_shards} shards x {nb_s} blocks)")
    return meta


# ---------------------------------------------------------------------------
# the index on the device
# ---------------------------------------------------------------------------


class BigIndex:
    """A sharded big index over the cards of a process, computed on the
    first (``device``): ``rec`` (``Shards`` of S int32 [nb_s + 1, 64]
    record tensors with local occ, shard o on card o mod D), ``C`` int64
    [alen + 1], ``base`` int64 [S, alen], ``sa_seq`` (``Shards`` of S
    int32 [ns_s], placed as ``rec``) and ``sa_off`` (int64 [S, ns_s], what
    the demo loads; the step reads no offset), ``seq_tax`` int32 [nseq].
    N, nseq, alen, e, first, S, nb_s and ns_s are the meta's; ``cards``
    lists the cards; ``nbytes`` maps each array to the device bytes it
    takes and ``card_bytes`` each card (its place in ``cards``) to the
    bytes it holds."""

    @classmethod
    def load(cls, path: str, device=None, fh=None) -> "BigIndex":
        """The directory of save_sharded_ktx on the cards of `device`
        (``multihost.local_cards``: None for every visible card, a device,
        or a list of devices; "cpu" for the CPU)."""
        t0 = time.time()
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        S = meta["n_shards"]

        def ld(name):
            return np.load(os.path.join(path, f"{name}.npy"))

        self = cls.from_arrays(
            meta, [ld(f"blocks_{s}") for s in range(S)],
            [ld(f"occ_{s}") for s in range(S)], ld("C"), ld("shard_base"),
            ld("sa_seq"), ld("sa_off"), ld("seq_tax"), device)
        for card in self.cards:
            if card.type == "cuda":
                torch.cuda.synchronize(card)
        self.load_seconds = time.time() - t0
        log(fh, f"big index load: {self.load_seconds:.1f}s, "
                f"{sum(self.nbytes.values()):,} bytes on " + ", ".join(
                    f"{self.cards[c]} {b:,}"
                    for c, b in sorted(self.card_bytes.items()))
                + f" ({S} shards of {meta['nb_s']} blocks)")
        return self

    @classmethod
    def from_arrays(cls, meta, blocks, occ, C, shard_base, sa_seq, sa_off,
                    seq_tax, device=None) -> "BigIndex":
        """A BigIndex over the arrays of the layout: blocks and occ are
        lists of S arrays (each shard's, uint8 [nb_s, 128] and int32
        [nb_s + 1, alen]); sa_seq and sa_off [S, ns_s]; device as load's."""
        self = cls.__new__(cls)
        cards = self.cards = multihost.local_cards(device)
        where = cards[0]
        for k in ("N", "nseq", "alen", "e", "first", "nb_s", "ns_s"):
            setattr(self, k, int(meta[k]))
        S = self.S = int(meta["n_shards"])
        nb_s, ns_s, alen = self.nb_s, self.ns_s, self.alen
        if alen > 32:
            raise ValueError(f"alen {alen}: a record row holds 32 counts")
        if self.N >= BLOCK * INT32_CAP:
            raise ValueError(
                f"N = {self.N:,} letters, 2^38 or more: the kernels number "
                "the BWT blocks in int32")
        if nb_s * BLOCK >= INT32_CAP:
            raise ValueError(
                f"a shard of {nb_s} blocks holds {nb_s * BLOCK:,} positions, "
                "2^31 or more: its local occ counts are int32; save the "
                "index in more shards")
        if len(blocks) != S or len(occ) != S:
            raise ValueError(f"expected {S} shards of blocks and occ")

        def put(a, dtype, to=where):
            a = np.ascontiguousarray(a, dtype=dtype)
            return torch.from_numpy(a).to(to)

        self.C = put(C, np.int64)
        dev = self.device = where
        D = len(cards)
        home = [cards[o % D] for o in range(S)]  # the demo's devs[:S]
        peer = {o for o in range(S) if o % D}
        for o in sorted(peer):
            peer_shards.enable_peer(dev, home[o])
        parts = []
        for s in range(S):
            if blocks[s].shape != (nb_s, BLOCK) or \
                    occ[s].shape != (nb_s + 1, alen):
                raise ValueError(f"shard {s}: blocks {blocks[s].shape}, occ "
                                 f"{occ[s].shape}, nb_s {nb_s}")
            rec = torch.zeros((nb_s + 1, 64), dtype=torch.int32,
                              device=home[s])
            rec[:, :alen] = put(occ[s], np.int32, home[s])
            rec[:nb_s, 32:] = put(blocks[s], np.uint8, home[s]).view(
                torch.int32)
            rec[nb_s, 32:] = -1  # bytes 255: no letter
            parts.append(rec)
        nb = -(-self.N // BLOCK)
        self.rec = Shards(parts, nb_s, nb + 1, dev, peer)
        self.base = put(shard_base, np.int64)
        sa_seq = np.asarray(sa_seq).reshape(S, ns_s)
        self.sa_seq = Shards([put(sa_seq[s], np.int32, home[s])
                              for s in range(S)], ns_s, S * ns_s, dev, peer)
        self.sa_off = put(np.asarray(sa_off).reshape(S, ns_s), np.int64)
        self.seq_tax = put(seq_tax, np.int32)
        if self.C.shape != (alen + 1,) or self.base.shape != (S, alen):
            raise ValueError("C, shard_base: shapes do not match the meta")
        self.nbytes = {
            "rec": sum(p.nbytes for p in parts),
            "sa_seq": sum(p.nbytes for p in self.sa_seq.parts),
            "sa_off": self.sa_off.nbytes,
            "C + shard_base + seq_tax": (self.C.nbytes + self.base.nbytes
                                         + self.seq_tax.nbytes),
        }
        self.card_bytes = dict.fromkeys(range(D), 0)
        self.card_bytes[0] = (self.nbytes["sa_off"]
                              + self.nbytes["C + shard_base + seq_tax"])
        for o in range(S):
            self.card_bytes[o % D] += (parts[o].nbytes
                                       + self.sa_seq.parts[o].nbytes)
        return self

    def check(self, device) -> None:
        """Raise unless every array lies on `device` with the layout the
        kernels read, the shards of other cards there for a peer read."""
        self.rec.check("rec", torch.int32, device, self.nb_s + 1)
        self.sa_seq.check("sa_seq", torch.int32, device, self.ns_s)
        kernels.check(self.C, "C", torch.int64, device, 1)
        kernels.check(self.base, "shard_base", torch.int64, device, 2)
        if self.rec.shape[1] != 64:
            raise ValueError("rec: rows of 64 words expected")
