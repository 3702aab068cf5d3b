"""Device-resident FM index, its rank, the SA walk, and the kernels that
work on the index alone: A (``update_si`` for probes, ``update_si_letters``
for the seed tables), H (``sa_lookup``), I (``extend_from``) and J
(``extend_all``).

The index sits on the card as fused rank records, one int32 row of 64
words per 128-character BWT block (``build_fused_records``), so a rank
query reads one 256-byte row:

    FMindex(c, k) = C[c] + occ[k >> 7, c] + #c in block[k >> 7][0, k & 127)

Everything is int32: one index shard keeps its SA positions below 2^31.
The plain versions below are masked loops over tensors with the kernels'
contracts; a wrapper takes them only for tensors that lie on the CPU.

An index may also be split into shards (``Shards``, built by
``parallel.sharded_index.ShardedIndex``): then ``rec``, the SA samples and
the text are each S tensors, the plain versions read them through the
owner arithmetic of ``Shards.__getitem__``, and a wrapper launches the
kernel's sharded instantiation (``<name>_sharded``, csrc/fm_common.cuh
``kt::ShardIx``).  Over a group of processes on several hosts some
shards are remote (``Shards.remote``): kernel N (``fm_serve``) answers the
queries of a round for the shards a process reads (rank rows, SA samples
and, for the text-compare hybrid, text rows), and kernel Q
(``walk_hosts``) walks the SA, parking the steps whose rows lie on another
host (``parallel.exchange`` runs the rounds).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..index.core import BLOCK, KaijuIndex


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def build_fused_records(index: KaijuIndex) -> np.ndarray:
    """Fused rank records, int32 [nb+1, 64]: words 0..31 are the occ
    checkpoint row, words 32..63 the 128 BWT bytes packed 4 a word,
    little endian.  The last row covers k == length at a block boundary:
    the end counts, and pad bytes of code 31, which match no letter."""
    blocks = np.asarray(index.bwt).reshape(-1, BLOCK)
    nb = blocks.shape[0]
    rec = np.zeros((nb + 1, 64), dtype=np.int32)
    rec[:, :32] = np.asarray(index.occ, dtype=np.int32)[: nb + 1]
    rec[:nb, 32:] = np.ascontiguousarray(blocks).view("<u4").view(np.int32)
    rec[nb, 32:] = np.full(32, 0x1F1F1F1F, dtype=np.int32)
    return rec


class DeviceIndex:
    """The tensors of one index shard on one device: ``rec`` int32
    [nb+1, 64], ``C`` int32 [alen+1], the SA samples ``sa_seq``/``sa_off``
    int32 [nsamples] and ``seq_tax`` int32 [nseq] (taxon of each
    content-ranked sequence).  An index with a text copy also has ``text``
    uint8 [N] (letter codes, a 0 after each sequence, input order) and
    ``rank_start`` int32 [nseq] (the text start of the content-rank-r
    sequence), which the text-compare hybrid reads; both are None
    otherwise."""

    def __init__(self, index: KaijuIndex, device=None):
        has_text = index.text is not None
        self._set(
            resolve_device(device),
            build_fused_records(index),
            np.asarray(index.C, dtype=np.int32),
            np.asarray(index.sa_seq, dtype=np.int32),
            np.asarray(index.sa_off, dtype=np.int32),
            np.asarray(index.seq_taxids, dtype=np.int32),
            int(index.nseq),
            int(index.chpt_exp),
            np.asarray(index.text, dtype=np.uint8) if has_text else None,
            index.rank_text_starts() if has_text else None,
        )

    @classmethod
    def from_arrays(cls, rec, C, sa_seq, sa_off, seq_tax, device, *, nseq,
                    chpt_exp, text=None, rank_start=None) -> "DeviceIndex":
        """A DeviceIndex over given arrays (anything np.asarray takes),
        e.g. those of another implementation, so that both compute on the
        same index; text and rank_start come together or not at all."""
        if (text is None) != (rank_start is None):
            raise ValueError("text and rank_start come together")
        self = cls.__new__(cls)
        arrs = [np.asarray(a, dtype=np.int32)
                for a in (rec, C, sa_seq, sa_off, seq_tax)]
        self._set(resolve_device(device), *arrs, int(nseq), int(chpt_exp),
                  None if text is None else np.asarray(text, dtype=np.uint8),
                  rank_start)
        return self

    def _set(self, device, rec, C, sa_seq, sa_off, seq_tax, nseq, chpt_exp,
             text, rank_start):
        def put(a):
            a = np.ascontiguousarray(a)
            if not a.flags.writeable:  # e.g. a read-only memory map
                a = a.copy()
            return torch.from_numpy(a).to(device)

        self.device = device
        self.rec = put(rec)
        self.C = put(C)
        self.sa_seq = put(sa_seq)
        self.sa_off = put(sa_off)
        self.seq_tax = put(seq_tax)
        self.nseq = nseq
        self.chpt_exp = chpt_exp
        self.text = None if text is None else put(text)
        self.rank_start = (None if rank_start is None else
                           put(np.asarray(rank_start, dtype=np.int32)))

    @property
    def has_text(self) -> bool:
        return self.text is not None


class Shards:
    """One array of an index split into S contiguous shards, each its own
    tensor (K16, kaiju_tpu/parallel/sharded_index.py), read on `device`
    (by default the first shard's).  Element (row) x lives in shard o =
    min(x // per, S - 1) at x - o * per; a shard holds `per` of them (rank
    records one end row more).  Indexing with an integer tensor reads every
    element from its owner, so the plain versions read the shards as they
    read one tensor; ``shape`` is the whole array's.  ``table`` (int64
    [S], on `device`) holds the shards' addresses, which the sharded
    kernels read.  `peer` names the shards placed for a peer read: mapped
    from another process's memory (``parallel.peer_shards``) or held by
    another card of this process (``ShardedIndex.on_cards``), with peer
    access enabled for `device`.  Those alone may lie on another card,
    which the kernels read over NVLink and the plain versions refuse.

    A part None is a remote shard: no process of this host holds it, in a
    group of processes on several hosts (``parallel.peer_shards``); its
    address in ``table`` is 0, ``remote`` names it, and its elements are
    served by its owner in rounds (``parallel.exchange``).  Only the hosts
    forms (kernels N, O, Q and their plain versions, which test a row's
    shard first) accept such Shards; ``check`` refuses them elsewhere, and
    indexing an element of a remote shard raises."""

    def __init__(self, parts: list, per: int, length: int, device=None,
                 peer=(), like=None):
        """like: a part of the array (its dtype and row shape), needed
        where every part is remote."""
        if not parts or per < 1:
            raise ValueError("shards need one or more parts and per >= 1")
        self.parts = list(parts)
        self.per = int(per)
        self.S = len(self.parts)
        p0 = next((p for p in self.parts if p is not None), like)
        if p0 is None:
            raise ValueError("every shard remote: pass like")
        self.shape = torch.Size((int(length), *p0.shape[1:]))
        self.dtype = p0.dtype
        self.device = p0.device if device is None else torch.device(device)
        self.peer = frozenset(peer)
        self.remote = frozenset(o for o, p in enumerate(self.parts)
                                if p is None)
        self.table = torch.tensor(
            [0 if p is None else p.data_ptr() for p in self.parts],
            dtype=torch.int64).to(self.device)
        self.here = torch.tensor([p is not None for p in self.parts],
                                 device=self.device)

    def owner(self, idx: torch.Tensor) -> torch.Tensor:
        """The shard (int64) that holds each element of idx."""
        return torch.clamp(idx.long() // self.per, 0, self.S - 1)

    def __getitem__(self, idx) -> torch.Tensor:
        for o, part in enumerate(self.parts):
            if part is not None and part.device != self.device:
                raise ValueError(
                    f"shard {o} lies on {part.device}: the plain versions "
                    f"read shards on {self.device} only")
        idx = torch.as_tensor(idx, device=self.device).long()
        owner = self.owner(idx)
        local = idx - owner * self.per
        out = torch.empty((*idx.shape, *self.shape[1:]), dtype=self.dtype,
                          device=self.device)
        for o, part in enumerate(self.parts):
            m = owner == o
            if part is None:
                if bool(m.any()):
                    raise ValueError(
                        f"shard {o} lies on another host: its owner serves "
                        "it in rounds (parallel.exchange); only the hosts "
                        "forms read such shards")
                continue
            out[m] = part[local[m]]
        return out

    def check(self, what: str, dtype: torch.dtype, device, rows: int,
              hosts: bool = False) -> None:
        """Raise unless the shards are read on `device` and every shard is
        a contiguous tensor of `dtype` with `rows` rows on `device`, or on
        another card when it was placed there for a peer read; a remote
        shard only where `hosts` (a hosts kernel reads the Shards)."""
        if self.device != device:
            raise ValueError(f"{what}: shards read on {self.device}, "
                             f"expected {device}")
        for o, part in enumerate(self.parts):
            if part is None:
                if not hosts:
                    raise ValueError(
                        f"{what} shard {o} lies on another host: only the "
                        "hosts kernels (parallel.exchange) read it")
                continue
            on = device
            if o in self.peer and part.device.type == device.type:
                on = part.device
            kernels.check(part, f"{what} shard {o}", dtype, on)
            if part.shape[0] != rows:
                raise ValueError(f"{what} shard {o}: {part.shape[0]} rows, "
                                 f"expected {rows}")


def shard_args(dev, rec, sa_seq=None, sa_off=None, text=None,
               hosts: bool = False) -> tuple:
    """The shard arguments of a sharded kernel (kernels.SHARD_SIG: rec_tab
    nb_s seq_tab off_tab ns_s nsamp text_tab nt_s S) after checking the
    shards; the arrays a kernel does not read are None.  hosts: the
    kernel reads kt::HostIx, and a remote shard's pointers are 0."""
    rec.check("rec", torch.int32, dev, rec.per + 1, hosts)
    if rec.shape[1] != 64:
        raise ValueError("rec: rows of 64 words expected")
    for a, what in ((sa_seq, "sa_seq"), (sa_off, "sa_off"), (text, "text")):
        if a is None:
            continue
        if not isinstance(a, Shards) or a.S != rec.S:
            raise TypeError(f"{what}: expected {rec.S} shards like rec")
        a.check(what, torch.uint8 if what == "text" else torch.int32, dev,
                a.per, hosts)
    if sa_seq is not None and sa_off is not None and (
            sa_seq.per != sa_off.per or sa_seq.shape != sa_off.shape):
        raise ValueError("sa_seq, sa_off: shards of different sizes")
    samp = sa_seq if sa_seq is not None else sa_off
    return (rec.table, rec.per,
            None if sa_seq is None else sa_seq.table,
            None if sa_off is None else sa_off.table,
            0 if samp is None else samp.per,
            0 if samp is None else samp.shape[0],
            None if text is None else text.table,
            0 if text is None else text.per, rec.S)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

_SHIFTS = torch.tensor([0, 8, 16, 24], dtype=torch.int32)


def _block_bytes(rows: torch.Tensor) -> torch.Tensor:
    """[N, 64] records -> their 128 BWT bytes, int32 [N, 128]."""
    w = rows[:, 32:, None] >> _SHIFTS.to(rows.device)
    return (w & 255).reshape(rows.shape[0], BLOCK)


def rank(rec, C, c, k, touched=None):
    """Plain FMindex(c, k) over fused records (int32 [N] in and out).
    touched: None, or a list that receives the record rows read."""
    b = torch.clamp(k >> 7, max=rec.shape[0] - 1).long()
    if touched is not None:
        touched.append(b)
    rows = rec[b]
    off = k & (BLOCK - 1)
    lanes = torch.arange(BLOCK, device=rec.device)
    cnt = ((_block_bytes(rows) == c[:, None]) & (lanes < off[:, None])).sum(
        1, dtype=torch.int32
    )
    cl = c.long()
    return C[cl] + rows.gather(1, cl[:, None])[:, 0] + cnt


def update_si_plain(rec, C, c, s0, s1, touched=None):
    n0 = rank(rec, C, c, s0, touched)
    n1 = rank(rec, C, c, s1, touched)
    return n0, n1, n0 < n1


NLET = 20  # letter codes 1..20 of the seed tables
_LETTERS_CHUNK = 1 << 14  # intervals of a plain round: 20x the probes


def update_si_letters_plain(rec, C, s0, s1, touched=None):
    """update_si_plain on every (letter, interval) pair of the live
    intervals (s0 < s1), each pair kept where its new interval is not
    empty: (n0, n1) int32 [NLET, n], letter c in row c - 1, zeros for a
    dead interval or an empty pair.  touched: as for rank (no row of a
    dead interval is read)."""
    n = s0.shape[0]
    n0 = torch.zeros((NLET, n), dtype=torch.int32, device=s0.device)
    n1 = torch.zeros_like(n0)
    live = torch.nonzero(s0 < s1).squeeze(1)
    letters = torch.arange(1, NLET + 1, dtype=torch.int32, device=s0.device)
    for lo in range(0, live.shape[0], _LETTERS_CHUNK):
        x = live[lo:lo + _LETTERS_CHUNK]
        m = x.shape[0]
        r0, r1, ok = update_si_plain(rec, C, letters.repeat_interleave(m),
                                     s0[x].repeat(NLET), s1[x].repeat(NLET),
                                     touched)
        n0[:, x] = torch.where(ok, r0, 0).view(NLET, m)
        n1[:, x] = torch.where(ok, r1, 0).view(NLET, m)
    return n0, n1


def sa_walk(rec, C, sa_seq, sa_off, nseq, chpt_exp, k, touched=None):
    """Plain batched get_suffix (bwt.c:105-121): (iseq, pos) per SA
    position k, int32 [N].  Walks LF until a sampled slot or a terminator,
    where the LF result is the content rank and pos the steps taken.
    touched: as for rank."""
    check = (1 << chpt_exp) - 1
    nsamp = sa_seq.shape[0]

    def sample(kk):
        idx = (kk >> chpt_exp) - ((nseq - 1) >> chpt_exp) - 1
        return torch.clamp(idx, 0, nsamp - 1).long()

    k = k.clone()
    steps = torch.zeros_like(k)
    idx0 = sample(k)
    iseq = sa_seq[idx0].clone()
    pos = sa_off[idx0].clone()
    todo = torch.nonzero(k & check).squeeze(1)
    while todo.numel():
        kk = k[todo]
        rows = rec[torch.clamp(kk >> 7, max=rec.shape[0] - 1).long()]
        off = (kk & (BLOCK - 1)).long()
        c = _block_bytes(rows).gather(1, off[:, None])[:, 0]
        kn = rank(rec, C, c, kk, touched)
        st = steps[todo]
        term = c == 0
        t_idx = todo[term]
        iseq[t_idx] = kn[term]
        pos[t_idx] = st[term]
        moving = ~term
        todo, kn, st = todo[moving], kn[moving], st[moving] + 1
        k[todo] = kn
        steps[todo] = st
        at = (kn & check) == 0
        s_idx = sample(kn[at])
        iseq[todo[at]] = sa_seq[s_idx]
        pos[todo[at]] = sa_off[s_idx] + st[at]
        todo = todo[~at]
    return iseq, pos


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------


def update_si(rec, C, c, s0, s1):
    """Batched UpdateSI: (n0, n1, ok) with n0/n1 = FMindex(c, s0/s1) int32
    [N] and ok = n0 < n1 bool [N].  Kernel A (csrc/update_si.cu) for CUDA
    tensors, the plain version for CPU tensors."""
    if rec.device.type == "cpu":
        return update_si_plain(rec, C, c, s0, s1)
    dev = rec.device
    kernels.check(C, "C", torch.int32, dev, 1)
    n = c.shape[0]
    for t, what in ((c, "c"), (s0, "s0"), (s1, "s1")):
        kernels.check(t, what, torch.int32, dev, 1)
        if t.shape[0] != n:
            raise ValueError(f"{what}: {t.shape[0]} probes, expected {n}")
    n0 = torch.empty(n, dtype=torch.int32, device=dev)
    n1 = torch.empty(n, dtype=torch.int32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    if isinstance(rec, Shards):
        args = shard_args(dev, rec)
        if n:
            kernels.launch("update_si_sharded", *args, C, c, s0, s1, n, n0,
                           n1, ok)
        return n0, n1, ok
    kernels.check(rec, "rec", torch.int32, dev, 2)
    if rec.shape[1] != 64:
        raise ValueError("rec: rows of 64 words expected")
    if n:
        kernels.launch("update_si", rec, rec.shape[0], C, c, s0, s1, n,
                       n0, n1, ok)
    return n0, n1, ok


def update_si_letters(rec, C, s0, s1):
    """UpdateSI of every letter c = 1..NLET on each interval (s0, s1)
    (int32 [n]), the step of the seed-table build: (n0, n1) int32
    [NLET, n], row c - 1 = FMindex(c, s0), FMindex(c, s1) where the
    interval is alive and the new one non-empty, else zeros; equal to
    update_si on the NLET * n repeated probes, masked.  Kernel A's letters
    form (csrc/update_si.cu) for CUDA tensors, the plain version for CPU
    tensors."""
    if rec.device.type == "cpu":
        return update_si_letters_plain(rec, C, s0, s1)
    dev = rec.device
    kernels.check(C, "C", torch.int32, dev, 1)
    n = s0.shape[0]
    _check_lanes(dev, n, (s0, "s0", torch.int32), (s1, "s1", torch.int32))
    n0 = torch.empty((NLET, n), dtype=torch.int32, device=dev)
    n1 = torch.empty((NLET, n), dtype=torch.int32, device=dev)
    if isinstance(rec, Shards):
        args = shard_args(dev, rec)
        if n:
            kernels.launch("update_si_letters_sharded", *args, C, s0, s1, n,
                           n0, n1)
        return n0, n1
    kernels.check(rec, "rec", torch.int32, dev, 2)
    if rec.shape[1] != 64:
        raise ValueError("rec: rows of 64 words expected")
    if n:
        kernels.launch("update_si_letters", rec, rec.shape[0], C, s0, s1, n,
                       n0, n1)
    return n0, n1


def _check_lanes(dev, n, *named):
    """Raise unless each (tensor, name, dtype) is a contiguous [n] tensor
    of that dtype on dev."""
    for t, what, dtype in named:
        kernels.check(t, what, dtype, dev, 1)
        if t.shape[0] != n:
            raise ValueError(f"{what}: {t.shape[0]} lanes, expected {n}")


def _check_index(dev, rec, C):
    kernels.check(rec, "rec", torch.int32, dev, 2)
    kernels.check(C, "C", torch.int32, dev, 1)
    if rec.shape[1] != 64:
        raise ValueError("rec: rows of 64 words expected")


# ---------------------------------------------------------------------------
# kernel H
# ---------------------------------------------------------------------------


sa_lookup_plain = sa_walk


def sa_lookup(rec, C, sa_seq, sa_off, nseq, chpt_exp, k):
    """Batched get_suffix: (iseq, pos) int32 [N] for the SA positions k
    int32 [N] (see sa_walk).  Kernel H (csrc/sa_lookup.cu) for CUDA
    tensors, the plain version for CPU tensors."""
    if k.device.type == "cpu":
        return sa_lookup_plain(rec, C, sa_seq, sa_off, nseq, chpt_exp, k)
    dev = k.device
    n = k.shape[0]
    _check_lanes(dev, n, (k, "k", torch.int32))
    if isinstance(rec, Shards):
        kernels.check(C, "C", torch.int32, dev, 1)
        args = shard_args(dev, rec, sa_seq, sa_off)
        if sa_seq.shape[0] < 1:
            raise ValueError("sa_seq, sa_off: one or more samples")
        iseq = torch.empty(n, dtype=torch.int32, device=dev)
        pos = torch.empty(n, dtype=torch.int32, device=dev)
        if n:
            kernels.launch("sa_lookup_sharded", *args, C, nseq, chpt_exp, k,
                           n, iseq, pos)
        return iseq, pos
    _check_index(dev, rec, C)
    kernels.check(sa_seq, "sa_seq", torch.int32, dev, 1)
    kernels.check(sa_off, "sa_off", torch.int32, dev, 1)
    if sa_seq.shape != sa_off.shape or sa_seq.shape[0] < 1:
        raise ValueError("sa_seq, sa_off: one or more samples, equal lengths")
    iseq = torch.empty(n, dtype=torch.int32, device=dev)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        kernels.launch("sa_lookup", rec, rec.shape[0], C, sa_seq, sa_off,
                       sa_seq.shape[0], nseq, chpt_exp, k, n, iseq, pos)
    return iseq, pos


# ---------------------------------------------------------------------------
# kernels N and Q: a group of processes on several hosts
# ---------------------------------------------------------------------------

# the kinds of an exchange query (op, x), op = kind << 8 | letter
# (csrc/fm_common.cuh kQRank ...; kernel N's contract in csrc/fm_serve.cu)
Q_RANK, Q_ROW, Q_LF, Q_SAMPLE, Q_TEXT = 0, 1, 2, 3, 4


def query_shard(rec, sa_seq, queries, text=None) -> torch.Tensor:
    """The shard (int64 [Q]) that answers each query (op, x) of int32
    [Q, 2]: a sample's slot owner, a text row's owner (the 128-byte rows
    of ``text``, by its rows a shard, not by the BWT blocks), else the
    owner of row x >> 7."""
    x = queries[:, 1]
    kind = queries[:, 0] >> 8
    out = torch.where(kind == Q_SAMPLE, sa_seq.owner(x), rec.owner(x >> 7))
    if text is not None:
        out = torch.where(kind == Q_TEXT, text.owner(x.long() * BLOCK), out)
    return out


def _letter_at(rec, k):
    """The BWT letter at each SA row k (int32 [N])."""
    rows = rec[torch.clamp(k >> 7, max=rec.shape[0] - 1).long()]
    return _block_bytes(rows).gather(1, (k & (BLOCK - 1)).long()[:, None])[:, 0]


def fm_serve_plain(rec, C, sa_seq, sa_off, queries, width, text=None,
                   touched=None):
    """touched: as for rank."""
    dev = queries.device
    ans = torch.zeros((queries.shape[0], width), dtype=torch.int32,
                      device=dev)
    op, x = queries[:, 0], queries[:, 1]
    kind, c = op >> 8, op & 255
    if not bool(((kind >= Q_RANK) & (kind <= Q_TEXT)).all()):
        raise ValueError("a query of an unknown kind")
    m = kind == Q_TEXT
    if bool(m.any()):
        if text is None or width < BLOCK // 4:
            raise ValueError(f"Q_TEXT answers take the text and width >= "
                             f"{BLOCK // 4}")
        at = x[m].long()[:, None] * BLOCK + torch.arange(BLOCK, device=dev)
        b = text[at.reshape(-1)].to(torch.int32).view(-1, BLOCK // 4, 4)
        ans[m, :BLOCK // 4] = (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16
                               | b[..., 3] << 24)
    m = kind == Q_RANK
    if bool(m.any()):
        ans[m, 0] = rank(rec, C, c[m], x[m], touched)
    m = kind == Q_LF
    if bool(m.any()):
        letter = _letter_at(rec, x[m])
        kn = rank(rec, C, letter, x[m], touched)
        ans[m, 0] = torch.where(letter == 0, ~kn, kn)
    m = kind == Q_SAMPLE
    if bool(m.any()):
        ans[m, 0] = sa_seq[x[m]]
        if width > 1:
            ans[m, 1] = sa_off[x[m]]
    m = kind == Q_ROW
    if bool(m.any()):
        if width < NLET:
            raise ValueError(f"Q_ROW answers take width >= {NLET}")
        k = x[m]
        n = k.shape[0]
        letters = torch.arange(1, NLET + 1, dtype=torch.int32,
                               device=dev).repeat_interleave(n)
        ans[m, :NLET] = rank(rec, C, letters, k.repeat(NLET),
                             touched).view(NLET, n).T
    return ans, torch.zeros(1, dtype=torch.int32, device=dev)


def fm_serve(rec, C, sa_seq, sa_off, queries, width, text=None):
    """A round's queries to the shards this process reads (int32 [Q, 2],
    (op, x); Q_RANK (c, k), Q_ROW k, Q_LF k, Q_SAMPLE slot, Q_TEXT row of
    ``text``, csrc/fm_serve.cu) answered: (ans int32 [Q, width], bad int32
    [1], the queries whose shard is not read here or whose kind or width
    is wrong; the plain version raises on one instead).  The words of an
    answer that its kind does not write are 0.  The kernel's launch waits
    for nothing on the host.
    Kernel N (csrc/fm_serve.cu: a thread a query where width < 20, the
    rounds of RANK, LF and SAMPLE; else a group of 8 lanes on two
    neighbouring queries, one coalesced line a row) for CUDA tensors, the
    plain version for CPU tensors."""
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    if queries.device.type == "cpu":
        return fm_serve_plain(rec, C, sa_seq, sa_off, queries, width,
                              text=text)
    dev = queries.device
    kernels.check(queries, "queries", torch.int32, dev, 2)
    kernels.check(C, "C", torch.int32, dev, 1)
    if queries.shape[1] != 2:
        raise ValueError("queries: rows (op, x) expected")
    args = shard_args(dev, rec, sa_seq, sa_off, text, hosts=True)
    n = queries.shape[0]
    ans = torch.empty((n, width), dtype=torch.int32, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    if n:
        kernels.launch("fm_serve", *args, C, queries, n, width, ans, bad)
    return ans, bad


def walk_hosts_plain(rec, C, sa_seq, nseq, chpt_exp, seq, rows=None,
                     parked=None, answers=None, touched=None):
    """touched: as for rank."""
    dev = seq.device
    check = (1 << chpt_exp) - 1
    nsamp = sa_seq.shape[0]
    if parked is None:
        w = torch.arange(rows.shape[0], dtype=torch.int32, device=dev)
        k = rows.clone()
    else:
        w, k = parked[:, 0], parked[:, 1]
        a = answers
        lf = (k & check) != 0
        end = ~lf | (a < 0)  # a sample's id, or a terminator's ~rank
        seq[w[end].long()] = torch.where(lf, ~a, a)[end]
        w, k = w[~end], a[~end]
    out_w, out_k, out_q = [], [], []

    def park(pw, pk, kind, x):
        out_w.append(pw)
        out_k.append(pk)
        out_q.append(torch.stack([torch.full_like(x, kind << 8), x], 1))
        seq[pw.long()] = -1

    while w.numel():
        at = (k & check) == 0
        sw, sk = w[at], k[at]
        idx = (sk >> chpt_exp) - ((nseq - 1) >> chpt_exp) - 1
        idx = torch.clamp(idx, 0, nsamp - 1)
        here = sa_seq.here[sa_seq.owner(idx)]
        seq[sw[here].long()] = sa_seq[idx[here]]
        park(sw[~here], sk[~here], Q_SAMPLE, idx[~here])
        lw, lk = w[~at], k[~at]
        here = rec.here[rec.owner(lk >> 7)]
        park(lw[~here], lk[~here], Q_LF, lk[~here])
        lw, lk = lw[here], lk[here]
        letter = _letter_at(rec, lk)
        kn = rank(rec, C, letter, lk, touched)
        term = letter == 0
        seq[lw[term].long()] = kn[term]
        w, k = lw[~term], kn[~term]
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    pw = torch.cat(out_w) if out_w else z
    pk = torch.cat(out_k) if out_k else z
    q = torch.cat(out_q) if out_q else z.view(0, 2)
    return torch.stack([pw, pk], 1), q.view(-1, 1, 2)


def walk_hosts(rec, C, sa_seq, nseq, chpt_exp, seq, rows=None, parked=None,
               answers=None):
    """SA walks to sequence ids over the shards of a group on several
    hosts (csrc/walk_hosts.cu for the contract): the start form walks
    rows int32 [W] into seq int32 [W]; the resume form takes the parked
    walks (w, k) int32 [L, 2] with their answers int32 [L].  Both write
    seq in place (-1 for a walk that parks) and return the walks parked
    now (int32 [L', 2]) with their queries (int32 [L', 1, 2]).  Kernel Q
    (csrc/walk_hosts.cu) for CUDA tensors, the plain version for CPU
    tensors."""
    if (rows is None) == (parked is None):
        raise ValueError("rows (start) or parked and answers (resume)")
    if seq.device.type == "cpu":
        return walk_hosts_plain(rec, C, sa_seq, nseq, chpt_exp, seq, rows,
                                parked, answers)
    dev = seq.device
    kernels.check(C, "C", torch.int32, dev, 1)
    kernels.check(seq, "seq", torch.int32, dev, 1)
    args = shard_args(dev, rec, sa_seq, hosts=True)
    if parked is None:
        _check_lanes(dev, seq.shape[0], (rows, "rows", torch.int32))
        n = rows.shape[0]
    else:
        n = parked.shape[0]
        kernels.check(parked, "parked", torch.int32, dev, 2)
        _check_lanes(dev, n, (answers, "answers", torch.int32))
    park = torch.empty((n, 2), dtype=torch.int32, device=dev)
    q = torch.empty((n, 1, 2), dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    if n:
        kernels.launch("walk_hosts", *args, C, nseq, chpt_exp, rows,
                       0 if rows is None else n, parked, answers,
                       0 if parked is None else n, seq, park, q, count)
    m = int(count)
    return park[:m], q[:m]


# ---------------------------------------------------------------------------
# kernels I and J: backward extension
# ---------------------------------------------------------------------------


def extend_from_plain(rec, C, flat, base, pos, subcode, start_i, s0, s1, act,
                      touched=None):
    """touched: as for rank."""
    i, s0, s1 = start_i.clone(), s0.clone(), s1.clone()
    live = torch.nonzero(act & (i > 0)).squeeze(1)
    while live.numel():
        x = i[live] - 1
        c = torch.where(x == pos[live], subcode[live],
                        flat[(base[live] + x).long()].to(torch.int32))
        n0 = rank(rec, C, c, s0[live], touched)
        n1 = rank(rec, C, c, s1[live], touched)
        ok = n0 < n1
        live = live[ok]
        s0[live] = n0[ok]
        s1[live] = n1[ok]
        i[live] = x[ok]
        live = live[i[live] > 0]
    return i, s0, s1


def extend_from(rec, C, flat, base, pos, subcode, start_i, s0, s1, act):
    """Resumed backward extension (maxMatches_withStart, bwt.c:298-336):
    lane t reads the letter at x from flat[base[t] + x] (uint8), or
    subcode[t] where x == pos[t] (-1: none), and an active lane extends
    [s0, s1) from start_i while the interval stays non-empty and i > 0.
    Returns the final (i, s0, s1) int32 [N]; inactive lanes (act False)
    come back unchanged.  Kernel I (csrc/extend_from.cu) for CUDA tensors,
    the plain version for CPU tensors."""
    if flat.device.type == "cpu":
        return extend_from_plain(rec, C, flat, base, pos, subcode, start_i,
                                 s0, s1, act)
    dev = flat.device
    _check_index(dev, rec, C)
    kernels.check(flat, "flat", torch.uint8, dev, 1)
    n = start_i.shape[0]
    _check_lanes(dev, n, (base, "base", torch.int32),
                 (pos, "pos", torch.int32), (subcode, "subcode", torch.int32),
                 (start_i, "start_i", torch.int32), (s0, "s0", torch.int32),
                 (s1, "s1", torch.int32), (act, "act", torch.bool))
    out = torch.empty((3, n), dtype=torch.int32, device=dev)
    if n:
        kernels.launch("extend_from", rec, rec.shape[0], C, flat, base, pos,
                       subcode, start_i, s0, s1, act, n, out[0], out[1],
                       out[2])
    return out[0], out[1], out[2]


def extend_rows(rec, C, codes, start_i, s0, s1, act):
    """extend_from over per-lane code rows, codes uint8 [N, L] (the form of
    kaiju_tpu's extend_from_rec): lane t reads row t, no substitution."""
    N, L = codes.shape
    dev = codes.device
    base = torch.arange(N, dtype=torch.int32, device=dev) * L
    none = torch.full((N,), -1, dtype=torch.int32, device=dev)
    return extend_from(rec, C, codes.reshape(-1), base, none, none, start_i,
                       s0, s1, act)


def extend_all_plain(rec, C, codes, flen, touched=None):
    """touched: as for rank."""
    F, L = codes.shape
    dev = codes.device
    lane = torch.arange(F * L, dtype=torch.int32, device=dev)
    f, j = lane // L, lane % L
    valid = j < flen[f.long()]
    c0 = torch.where(valid, codes.reshape(-1).to(torch.int32), 0).long()
    s0 = torch.where(valid, C[c0], 0)
    s1 = torch.where(valid, C[c0 + 1], 0)
    none = torch.full_like(lane, -1)
    i, s0, s1 = extend_from_plain(rec, C, codes.reshape(-1), f * L, none,
                                  none, j, s0, s1, valid, touched)
    return i.view(F, L), s0.view(F, L), s1.view(F, L)


def extend_all(rec, C, codes, flen):
    """The maximal backward extension of every (fragment f, end j) of
    codes uint8 [F, L] (0-padded) with lengths flen int32 [F]:
    (start, si0, si1) int32 [F, L], the match [start, j] and its SA
    interval; lanes with j >= flen[f] give (j, 0, 0).  Kernel J
    (csrc/extend_all.cu) for CUDA tensors, the plain version for CPU
    tensors."""
    if codes.device.type == "cpu":
        return extend_all_plain(rec, C, codes, flen)
    dev = codes.device
    kernels.check(codes, "codes", torch.uint8, dev, 2)
    F, L = codes.shape
    _check_lanes(dev, F, (flen, "flen", torch.int32))
    out = torch.empty((3, F, L), dtype=torch.int32, device=dev)
    if isinstance(rec, Shards):
        kernels.check(C, "C", torch.int32, dev, 1)
        args = shard_args(dev, rec)
        if F * L:
            kernels.launch("extend_all_sharded", *args, C, codes, flen, F, L,
                           out[0], out[1], out[2])
        return out[0], out[1], out[2]
    _check_index(dev, rec, C)
    if F * L:
        kernels.launch("extend_all", rec, rec.shape[0], C, codes, flen, F, L,
                       out[0], out[1], out[2])
    return out[0], out[1], out[2]
