"""Device-resident FM index, its rank, the SA walk and kernel A
(``update_si``).

The index sits on the card as fused rank records, one int32 row of 64
words per 128-character BWT block (``build_fused_records``), so a rank
query reads one 256-byte row:

    FMindex(c, k) = C[c] + occ[k >> 7, c] + #c in block[k >> 7][0, k & 127)

Everything is int32: one index shard keeps its SA positions below 2^31.
The plain versions below are masked loops over tensors with the kernels'
contracts; a wrapper takes them only for tensors that lie on the CPU.
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
    content-ranked sequence)."""

    def __init__(self, index: KaijuIndex, device=None):
        self._set(
            resolve_device(device),
            build_fused_records(index),
            np.asarray(index.C, dtype=np.int32),
            np.asarray(index.sa_seq, dtype=np.int32),
            np.asarray(index.sa_off, dtype=np.int32),
            np.asarray(index.seq_taxids, dtype=np.int32),
            int(index.nseq),
            int(index.chpt_exp),
        )

    @classmethod
    def from_arrays(cls, rec, C, sa_seq, sa_off, seq_tax, device, *, nseq,
                    chpt_exp) -> "DeviceIndex":
        """A DeviceIndex over given arrays (anything np.asarray takes),
        e.g. those of another implementation, so that both compute on the
        same index."""
        self = cls.__new__(cls)
        arrs = [np.asarray(a, dtype=np.int32)
                for a in (rec, C, sa_seq, sa_off, seq_tax)]
        self._set(resolve_device(device), *arrs, int(nseq), int(chpt_exp))
        return self

    def _set(self, device, rec, C, sa_seq, sa_off, seq_tax, nseq, chpt_exp):
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
    kernels.check(rec, "rec", torch.int32, dev, 2)
    kernels.check(C, "C", torch.int32, dev, 1)
    n = c.shape[0]
    for t, what in ((c, "c"), (s0, "s0"), (s1, "s1")):
        kernels.check(t, what, torch.int32, dev, 1)
        if t.shape[0] != n:
            raise ValueError(f"{what}: {t.shape[0]} probes, expected {n}")
    if rec.shape[1] != 64:
        raise ValueError("rec: rows of 64 words expected")
    n0 = torch.empty(n, dtype=torch.int32, device=dev)
    n1 = torch.empty(n, dtype=torch.int32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        kernels.launch("update_si", rec, rec.shape[0], C, c, s0, s1, n,
                       n0, n1, ok)
    return n0, n1, ok
