"""Kernels P1 and P2 of the port (kaiju_tpu_torch.ops.gather) on the CPU:
their plain versions against the repository's Pallas kernels themselves,
bench_pallas_gather.dma_gather and dma_rank, run in TPU interpret mode;
any N, and the wrappers' refusal of an index outside the table.  The
kernels against the plain versions on the card: tests/test_torch_kernels.py
and chip_smoke.py phase 3."""

import os
import sys

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kaiju_tpu_torch.ops import gather
from kaiju_tpu_torch.tools import bench_gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB, N, CH = 1000, 512, 256


@pytest.fixture(scope="module")
def pallas():
    """bench_pallas_gather, imported from the repository root (it prints
    its devices to stderr at import)."""
    sys.path.insert(0, REPO)
    try:
        import bench_pallas_gather
    finally:
        sys.path.remove(REPO)
    return bench_pallas_gather


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(91)
    tab = rng.integers(-2**31, 2**31 - 1, size=(NB, gather.W), dtype=np.int32)
    idx = rng.integers(0, NB, size=N, dtype=np.int32)
    return tab, idx


@pytest.mark.parametrize("kernel", ["dma_gather", "dma_rank"])
def test_plain_versions_match_the_pallas_kernels(pallas, data, kernel):
    """P1 = dma_gather (tab[idx]) and P2 = dma_rank (int32 row sums, which
    wrap here), equal bit for bit."""
    import jax.numpy as jnp

    tab, idx = data
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(getattr(pallas, kernel)(jnp.asarray(tab),
                                                  jnp.asarray(idx), CH))
    port = gather.gather_rows if kernel == "dma_gather" else gather.gather_sum
    got = port(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if kernel == "dma_rank":
        wide = tab[idx].astype(np.int64).sum(1)
        assert (wide != want).any()  # the int32 wrap was exercised


@pytest.mark.parametrize("n", [0, 1, 777])
def test_any_n(data, n):
    """N need not be a multiple of CH (the Pallas grid's step) or of 32."""
    tab, idx = data
    idx = np.resize(idx, n).astype(np.int32)
    t, i = torch.from_numpy(tab), torch.from_numpy(idx)
    np.testing.assert_array_equal(gather.gather_rows(t, i).numpy(), tab[idx])
    np.testing.assert_array_equal(
        gather.gather_sum(t, i).numpy(),
        tab[idx].sum(1, dtype=np.int32) if n else np.zeros(0, np.int32))


@pytest.mark.parametrize("bad", [-1, NB])
def test_index_outside_the_table_raises(data, bad):
    tab, idx = data
    idx = idx.copy()
    idx[5] = bad
    for fn in (gather.gather_rows, gather.gather_sum):
        with pytest.raises(IndexError):
            fn(torch.from_numpy(tab), torch.from_numpy(idx))
    with pytest.raises(ValueError):
        gather.gather_rows(torch.from_numpy(tab[:, :64].copy()),
                           torch.from_numpy(idx[:4]))


def test_bench_needs_a_card():
    """The benchmark measures the card and refuses to run without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the benchmark would measure it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_gather.main(["--nb", "100", "--n", "10"])
