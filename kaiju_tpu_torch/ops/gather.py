"""Kernels P1 (``gather_rows``) and P2 (``gather_sum``): random 512-byte
row reads, the port of the repository's two Pallas kernels.

``bench_pallas_gather.py:dma_gather`` (P1) and ``dma_rank`` (P2) were the
DMA rank experiment of ROOFLINE.md §1: can hand-issued row DMAs beat XLA's
row gather?  Nothing in the package calls them; their benchmark is
``tools/bench_gather.py``, whose measured rows/s is the card's rate for
random 512-byte row reads, the reads under every FM rank.

P1: out[i] = tab[idx[i]], int32 [N, 128].  P2: out[i] = the int32 sum of
the row tab[idx[i]], wrapping as jnp.sum does.  tab is int32 [NB, 128],
idx int32 [N].  The kernels (csrc/gather.cu) take any N >= 0; the
wrappers raise on an index outside [0, NB), which would read out of
bounds on the card.
"""

from __future__ import annotations

import torch

from .. import kernels

W = 128  # int32 words a row (512 bytes)


def gather_rows_plain(tab, idx):
    return tab[idx.long()]


def gather_sum_plain(tab, idx):
    return tab[idx.long()].sum(1, dtype=torch.int32)


def _check(tab, idx) -> None:
    """Raise unless tab is int32 [NB, 128] and idx int32 [N] with every
    entry in [0, NB) (on the card this waits for one reduction)."""
    dev = idx.device
    kernels.check(tab, "tab", torch.int32, dev, 2)
    kernels.check(idx, "idx", torch.int32, dev, 1)
    if tab.shape[1] != W:
        raise ValueError(f"tab: rows of {tab.shape[1]} words, expected {W}")
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= tab.shape[0]:
            raise IndexError(f"idx: entries in [{lo}, {hi}], outside "
                             f"[0, {tab.shape[0]})")


def launch_rows(tab, idx, out) -> None:
    """Launch P1 into out int32 [N, 128] on checked arguments."""
    if idx.numel():
        kernels.launch("gather_rows", tab, idx, idx.shape[0], out)


def launch_sum(tab, idx, out) -> None:
    """Launch P2 into out int32 [N] on checked arguments."""
    if idx.numel():
        kernels.launch("gather_sum", tab, idx, idx.shape[0], out)


def gather_rows(tab, idx):
    """tab[idx]: int32 [N, 128].  Kernel P1 (csrc/gather.cu) for CUDA
    tensors, the plain version for CPU tensors; raises on an index outside
    [0, NB)."""
    _check(tab, idx)
    if idx.device.type == "cpu":
        return gather_rows_plain(tab, idx)
    out = torch.empty((idx.shape[0], W), dtype=torch.int32, device=idx.device)
    launch_rows(tab, idx, out)
    return out


def gather_sum(tab, idx):
    """The int32 sum of each row tab[idx[i]] (wrapping): int32 [N].  Kernel
    P2 (csrc/gather.cu) for CUDA tensors, the plain version for CPU
    tensors; raises on an index outside [0, NB)."""
    _check(tab, idx)
    if idx.device.type == "cpu":
        return gather_sum_plain(tab, idx)
    out = torch.empty(idx.shape[0], dtype=torch.int32, device=idx.device)
    launch_sum(tab, idx, out)
    return out
