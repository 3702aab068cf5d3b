"""Random 512-byte row reads on the card: kernels P1 (gather_rows) and P2
(gather_sum) against their plain versions and PyTorch's own calls.

    python -m kaiju_tpu_torch.tools.bench_gather [--seed 0] [--nb 250000]
        [--n 262144]

The counterpart of bench_pallas_gather.py:main (:132-159), at its sizes: a
table of NB rows of 128 int32 (512 bytes; 128 MB, larger than the H100's
50 MB L2) and N random row indices, both from np.random.default_rng(seed).
Each kernel is checked against its plain version, bit for bit, then timed
with CUDA events (median of repeated launches), beside
torch.index_select(tab, 0, idx) (one call computing P1) and
tab[idx].sum(1) (P2 in two calls).  Prints M rows/s, GB/s of the N rows
moved (read, and for P1 written) and each time's bound: the bytes this
run's data needs, each moved once, at the H100 SXM's 3.35 TB/s: the
distinct rows of idx read (N random draws from NB rows hit about 65 %
distinct rows; a repeated row can come from L2), idx read and the output
written.  The M rows/s of P1 is the card's rate for random
512-byte row reads, the reads under every FM rank of the port.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from .. import kernels
from ..ops import gather

NB = 250_000
N = 262_144
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median milliseconds of fn() on the card, by CUDA events; a sleep
    kernel queued ahead keeps the host's enqueue out of the time."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(seed: int = 0, nb: int = NB, n: int = N) -> dict:
    """{kernel: its measurements} for P1 and P2 on the card: max_abs_err
    against the plain version, ms, plain_ms, library_ms (None for P2),
    bound_ms and the rates.  Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_gather measures the card: no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.integers(1, 100, size=(nb, gather.W),
                                        dtype=np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, nb, size=n,
                                        dtype=np.int32)).to(dev)
    row = gather.W * 4
    distinct = int(torch.unique(idx).numel())
    rows_out = torch.empty((n, gather.W), dtype=torch.int32, device=dev)
    sums_out = torch.empty(n, dtype=torch.int32, device=dev)
    cases = {
        # name: (checked wrapper, plain, launch alone, library call,
        #        bytes moved once)
        "gather_rows": (gather.gather_rows, gather.gather_rows_plain,
                        lambda: gather.launch_rows(tab, idx, rows_out),
                        lambda: torch.index_select(tab, 0, idx),
                        (distinct + n) * row + 4 * n),
        "gather_sum": (gather.gather_sum, gather.gather_sum_plain,
                       lambda: gather.launch_sum(tab, idx, sums_out),
                       None, distinct * row + 2 * 4 * n),
    }
    out = {}
    for name, (fn, plain, launch, library, nbytes) in cases.items():
        got, want = fn(tab, idx), plain(tab, idx)
        err = int((got.long() - want.long()).abs().max()) if n else 0
        ms = cuda_ms(launch)
        out[name] = {
            "max_abs_err": err, "ms": ms, "bytes": nbytes,
            "plain_ms": cuda_ms(lambda: plain(tab, idx)),
            "library_ms": None if library is None else cuda_ms(library),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "m_rows_per_s": n / ms / 1e3,
            "gb_per_s": (2 * n * row if name == "gather_rows" else n * row)
            / ms / 1e6,
            "rows": n, "distinct_rows": distinct, "table_rows": nb,
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nb", type=int, default=NB)
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args(argv)
    kernels.reset_counts()
    res = run(args.seed, args.nb, args.n)
    print(f"device: {torch.cuda.get_device_name(0)}; tab [{args.nb:,}, "
          f"{gather.W}] int32, {args.n:,} random rows "
          f"({res['gather_rows']['distinct_rows']:,} distinct)")
    for name, r in res.items():
        print(f"{name}: max_abs_err {r['max_abs_err']}, {r['ms']:.4f} ms = "
              f"{r['m_rows_per_s']:.1f} M rows/s, {r['gb_per_s']:.1f} GB/s "
              f"(bound {r['bound_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms"
              + (f", torch.index_select {r['library_ms']:.4f} ms"
                 if r["library_ms"] is not None else
                 ", tab[idx].sum(1) is the plain version, two calls") + ")")
        if name == "gather_rows" and r["library_ms"] is not None:
            lib = r["library_ms"]
            print(f"torch.index_select: {args.n / lib / 1e3:.1f} M rows/s, "
                  f"{2 * args.n * 512 / lib / 1e6:.1f} GB/s")
    print(json.dumps({"bench_gather": res, "launches": {
        k: kernels.LAUNCHES[k] for k in ("gather_rows", "gather_sum")}}))
    bad = [k for k, r in res.items() if r["max_abs_err"]]
    if bad:
        print(f"kernels differ from their plain versions: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
