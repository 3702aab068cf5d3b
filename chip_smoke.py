#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kaiju_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 20240817] [--db-letters 64000000]

Phases, any failure exits non-zero:
  1. build the CUDA kernels from kaiju_tpu_torch/csrc with nvcc; print the
     build seconds and the card's name and power limit (nvidia-smi);
  2. generate a uniform synthetic protein database from --seed (the
     generator and size of bench.py) with a matching nodes.dmp, index it
     with the port's native builder without a text copy (the .fmi
     configuration) and cache it under build/chip_smoke/; generate 65,536
     reads (bench.py's count) and check that the threaded host fragmenter
     gives the same bytes as one thread;
  3. hold every kernel of the MEM path against its plain PyTorch version on
     the card, on the inputs the main path gives it (a 4096-read batch,
     the depth-5 seed-table probes), integer outputs equal; time both;
  4. classify the reads in batches of 4,096 (bench.py's batch) through
     kaiju_tpu_torch.tools.kaiju.main with -a mem, counting each kernel's
     launches (all must be > 0), and check 256 sampled TSV lines against
     the port's host ExactClassifier; then classify them again with the
     seed tables cached, untraced for the steady rate and the host seconds
     of each stage, and traced by torch.profiler for the device's idle
     share;
  5. print the kernels' JSON line, then the result line.

Needs a CUDA device; imports nothing of JAX or of kaiju_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import random
import shutil
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
READS = 65_536  # bench.py's read count and batch
BATCH = 4096
AA = "ACDEFGHIKLMNPQRSTVWY"
REPLACES = {
    "update_si": "kaiju_tpu/ops/device_index.py:333",
    "mem_extend": "kaiju_tpu/ops/fused_mem2.py:528",
    "mem_stats": "kaiju_tpu/ops/fused_mem2.py:921",
    "read_lca": "kaiju_tpu/ops/fused_classify.py:153",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 15, warm: int = 2) -> float:
    """Median milliseconds of fn() on the card, by CUDA events.  A sleep
    kernel queued ahead keeps the stream busy while the host enqueues the
    events and fn's launches, so the time excludes the host's enqueue
    (a plain version that waits on the card still pays its own waits)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)  # about 2 ms at 1.98 GHz
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


# ---------------------------------------------------------------------------
# phase 2: database and reads
# ---------------------------------------------------------------------------


def make_records(seed: int, letters: int):
    """(names, codes, starts, ends, protein records) of the uniform DB."""
    import numpy as np

    rng = np.random.default_rng(seed)
    codes = rng.integers(1, 21, size=letters, dtype=np.uint8)
    lens = rng.integers(150, 451, size=letters // 150 + 1)
    ends = np.cumsum(lens)
    ends = ends[ends <= letters - 500]
    starts = np.concatenate([[0], ends[:-1]])
    blob = np.frombuffer(("*" + AA).encode(), dtype=np.uint8)[codes]
    text = blob.tobytes().decode()
    names = [f"ACC{i:07d}.1_{100 + i % 97}" for i in range(len(ends))]
    records = [(n, text[s:e]) for n, s, e in zip(names, starts, ends)]
    return names, codes, starts, ends, records


def make_reads(seed: int, records, n: int = READS):
    """n reads as (name, dna, None), from the port's readgen."""
    from kaiju_tpu_torch.tools import readgen

    return [(name, s, None) for name, s in readgen.make_reads(
        random.Random(seed + 1), records, n=n)]


def make_db(seed: int, letters: int):
    """(index, protein records, ktx dir, nodes.dmp) of the uniform DB."""
    from kaiju_tpu_torch.index import native_builder
    from kaiju_tpu_torch.index.core import KaijuIndex

    cache = os.path.join(ROOT, "build", "chip_smoke",
                         f"db{letters}_seed{seed}")
    ktx = os.path.join(cache, "db.ktx")
    nodes = os.path.join(cache, "nodes.dmp")
    names, codes, starts, ends, records = make_records(seed, letters)
    if os.path.exists(os.path.join(ktx, "meta.json")):
        return KaijuIndex.load(ktx), records, ktx, nodes
    os.makedirs(cache, exist_ok=True)
    with open(nodes, "w") as fh:
        fh.write("1\t|\t1\t|\tno rank\t|\n")
        fh.write("10\t|\t1\t|\tsuperkingdom\t|\n")
        for t in range(100, 197):
            fh.write(f"{t}\t|\t10\t|\tspecies\t|\n")
    t0 = time.perf_counter()
    index = native_builder.build_index_from_codes(
        names, [codes[s:e] for s, e in zip(starts, ends)]
    )
    index.text = None  # the reference .fmi carries no text copy
    index.save(ktx)
    log(f"db: indexed {int(ends[-1]):,} letters, {len(ends):,} sequences "
        f"in {time.perf_counter() - t0:.1f} s")
    return KaijuIndex.load(ktx), records, ktx, nodes


def check_fragmenter(reads) -> None:
    """Fragment every batch with the pipeline's fragmenter (two threads;
    its first call in the process is the first SEG call) and with one
    thread: the bytes must be equal.  Prints the lanes and a digest of the
    fragments, slot tables and overflow flags, to compare across machines."""
    import numpy as np

    from kaiju_tpu_torch.engine.fragments_native import NativeFragmenter2
    from kaiju_tpu_torch.engine.mem import MemPipeline, _bucket

    seen = []
    for threads in (2, 1):
        frag = NativeFragmenter2("mem", 11, 65, True, False, n_threads=threads)
        h = hashlib.sha256()
        lanes = []
        for i in range(0, len(reads), BATCH):
            flat, chars, off, nf, _k, rf_rows, oflow = frag.run(
                reads[i:i + BATCH], MemPipeline.S_SLOTS, _bucket)
            lanes.append(chars)
            for a in (flat[:chars], off[: nf + 1], rf_rows, oflow):
                h.update(np.ascontiguousarray(a).tobytes())
        seen.append((sum(lanes), lanes[0], h.hexdigest()[:16]))
        log(f"frag: {threads} thread(s): {seen[-1][0]:,} lanes "
            f"({seen[-1][1]:,} in the first batch), digest {seen[-1][2]}")
    if seen[0] != seen[1]:
        raise AssertionError("the threaded fragmenter differs from one thread")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def row_bytes(touched) -> tuple[int, int]:
    """(bytes of the distinct 256-byte record rows in `touched`, rows read
    counting repeats) from a plain version's list of row indices."""
    import torch

    if not touched:
        return 0, 0
    allrows = torch.cat(touched)
    return 256 * int(torch.unique(allrows).numel()), int(allrows.numel())


def check_kernels(index, reads):
    """Per kernel: (max_abs_err, ms, plain_ms, bound_ms, note).  The bound
    counts each input byte once: the distinct record rows that the plain
    version reads, plus the other inputs and the outputs."""
    import numpy as np
    import torch

    from kaiju_tpu_torch.engine.fragments_native import NativeFragmenter2
    from kaiju_tpu_torch.engine.mem import MemPipeline, _bucket
    from kaiju_tpu_torch.io.taxonomy import Taxonomy
    from kaiju_tpu_torch.ops import classify, device_index, search
    from kaiju_tpu_torch.ops.kmer import NLET, KmerTables

    cuda = torch.device("cuda")
    dv = device_index.DeviceIndex(index, cuda)
    out = {}

    def report(name, got, want, fn, plain_fn, touched, other_bytes, note):
        rb, nrows = row_bytes(touched)
        out[name] = (max_abs_err(got, want), cuda_ms(fn),
                     cuda_ms(plain_fn, reps=3, warm=1),
                     (rb + other_bytes) / HBM_BYTES_PER_S * 1e3,
                     f"{note}, {nrows:,} row reads of {rb // 256:,} rows")

    # A at the seed-table build's last depth: 20 * 20^4 probes
    kt = KmerTables.build_device(index, search.SEED_K, dv)
    p0, p1 = (torch.from_numpy(a.astype(np.int32)).to(cuda)
              for a in kt.tables[search.SEED_K - 2])
    c = torch.arange(1, NLET + 1, dtype=torch.int32,
                     device=cuda).repeat_interleave(p0.shape[0])
    s0, s1 = p0.repeat(NLET), p1.repeat(NLET)
    n = c.shape[0]
    chunk = 1 << 18

    def update_si_plain(touched=None):
        parts = [device_index.update_si_plain(
            dv.rec, dv.C, c[i:i + chunk], s0[i:i + chunk], s1[i:i + chunk],
            touched) for i in range(0, n, chunk)]
        return tuple(torch.cat([p[t] for p in parts]) for t in range(3))

    touched = []
    want = update_si_plain(touched)
    report("update_si", device_index.update_si(dv.rec, dv.C, c, s0, s1),
           want, lambda: device_index.update_si(dv.rec, dv.C, c, s0, s1),
           update_si_plain, touched, n * (12 + 9), f"{n:,} probes")

    # B, C, D on the first batch of the main path
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    frag = NativeFragmenter2("mem", 11, 65, True, False)
    flat, chars, frag_off, n_frags, _k, rf_rows, _o = frag.run(
        reads[:BATCH], MemPipeline.S_SLOTS, _bucket)
    flat = put(flat[:chars])
    frag_off = put(frag_off[: n_frags + 1])
    rf_rows = put(rf_rows)
    seed = tuple(put(a) for a in kt.planar_seed(search.SEED_K))
    K, j0, min_len, T = search.SEED_K, 10, 11, search.TIE_CAP
    P, F = chars, n_frags

    ext = (dv.rec, dv.C, *seed, flat, frag_off, K, j0)
    lanes = search.mem_extend(*ext)
    touched = []
    want = search.mem_extend_plain(*ext, touched)
    report("mem_extend", lanes, want, lambda: search.mem_extend(*ext),
           lambda: search.mem_extend_plain(*ext), touched,
           P * (1 + 9 + 12) + 4 * (F + 1), f"{P:,} lanes, {F:,} fragments")

    st = (*lanes, frag_off, min_len, T)
    stats = search.mem_stats(*st)
    report("mem_stats", stats, search.mem_stats_plain(*st),
           lambda: search.mem_stats(*st),
           lambda: search.mem_stats_plain(*st), [],
           12 * P + 4 * (F + 1) + F * (8 + 12 * T), f"{F:,} fragments")

    par, dep = (put(a) for a in Taxonomy(
        {1: 1, 10: 1, **{t: 10 for t in range(100, 197)}}).dense_arrays())
    B, S = rf_rows.shape
    tail = (*stats[:2], *stats[3:], rf_rows, dv.rec, dv.C, dv.sa_seq,
            dv.sa_off, dv.seq_tax, par, dep, MemPipeline.R_BUDGET, 20,
            dv.nseq, dv.chpt_exp)
    rows = classify.read_lca(*tail)
    touched = []
    want = classify.read_lca_plain(*tail, touched)
    report("read_lca", rows, want, lambda: classify.read_lca(*tail),
           lambda: classify.read_lca_plain(*tail), touched,
           4 * B * S + 16 * B + F * (8 + 8 * T), f"{B:,} reads")
    torch.cuda.synchronize()
    del dv
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4b: where the time goes
# ---------------------------------------------------------------------------


def steady_stream(index, nodes, reads, warm) -> None:
    """Classify the reads again, twice, each time with a new MemPipeline
    (seed tables cached) warmed by one batch of other reads, so that the
    host replay meets the reads afresh as in a real stream.  The untraced
    pass gives the steady rate and the host seconds of each stage; the
    pass under torch.profiler, tracing the card only, gives the device's
    busy share and each kernel's total."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kaiju_tpu_torch.engine import mem
    from kaiju_tpu_torch.engine.config import KaijuConfig
    from kaiju_tpu_torch.io.taxonomy import Taxonomy, parse_nodes_dmp

    cfg = KaijuConfig(mode="mem", seg=True, use_Evalue=False)
    tax = Taxonomy(parse_nodes_dmp(nodes))
    batches = [reads[i:i + BATCH] for i in range(0, len(reads), BATCH)]

    def one_pass(traced: bool):
        t0 = time.perf_counter()
        pipe = mem.MemPipeline(index, tax, cfg, kmer_cache_dir=index.source_dir)
        pipe.classify_batch(warm)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        mem.reset_counts()
        trace = (profile(activities=[ProfilerActivity.CUDA]) if traced
                 else contextlib.nullcontext())
        with trace as prof:
            t0 = time.perf_counter()
            n = sum(len(r) for r in pipe.classify_stream(batches))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return n, wall, setup, prof

    n, wall, setup, _p = one_pass(False)
    host = dict(mem.HOST_SECONDS)
    log(f"steady: {n:,} reads in {wall:.3f} s = {n / wall:.1f} reads/s "
        f"untraced (set-up and warm batch {setup:.2f} s not included)")
    host["other"] = wall - sum(host.values())
    log("steady: host seconds " + ", ".join(
        f"{k} {v:.3f} ({v / wall:.1%})" for k, v in host.items())
        + f"; replayed {mem.HOST_REPLAY['flagged']} reads")
    _n, wall_t, _s, prof = one_pass(True)
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA]
    dev_us = sum(r.self_device_time_total for r in rows)
    if dev_us <= 0:
        log("steady: device time not measured (the profiler saw none)")
        return
    busy = dev_us / 1e6 / wall_t
    log(f"steady: traced pass {wall_t:.3f} s; device busy "
        f"{dev_us / 1e3:.3f} ms ({busy:.2%}); idle share {1 - busy:.2%}")
    for r in sorted(rows, key=lambda r: -r.self_device_time_total)[:8]:
        log(f"steady: device {r.self_device_time_total / 1e3:9.3f} ms "
            f"x{r.count:<4d} {r.key[:70]}")


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.engine import mem
    from kaiju_tpu_torch.engine.config import KaijuConfig
    from kaiju_tpu_torch.engine.core import ExactClassifier, format_output_line
    from kaiju_tpu_torch.io.taxonomy import Taxonomy, parse_nodes_dmp
    from kaiju_tpu_torch.tools import kaiju, readgen

    # ---- 1. build ------------------------------------------------------
    secs = kernels.build(force=True, verbose=True)
    log(f"build: nvcc built {len(kernels.LAUNCHES)} kernel libraries in "
        f"{secs:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # ---- 2. database and reads ----------------------------------------
    t0 = time.perf_counter()
    index, records, ktx, nodes = make_db(args.seed, args.db_letters)
    log(f"db: {index.length:,} BWT positions, {index.nseq:,} sequences, "
        f"ready in {time.perf_counter() - t0:.1f} s")
    reads = make_reads(args.seed, records)
    fq = os.path.join(os.path.dirname(ktx), f"reads_{READS}.fastq")
    readgen.write_fastq([(n, s) for n, s, _ in reads], fq)
    check_fragmenter(reads)

    # ---- 3. kernels against their plain versions -----------------------
    checks = check_kernels(index, reads)
    for name, (err, ms, plain_ms, bound_ms, note) in checks.items():
        log(f"kernel {name}: max_abs_err {err}, {ms:.4f} ms "
            f"(plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms) [{note}]")
    bad = [n for n, v in checks.items() if v[0] != 0]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    # ---- 4. end to end through the CLI --------------------------------
    shutil.rmtree(os.path.join(ktx, "kmer5"), ignore_errors=True)
    out_tsv = os.path.join(os.path.dirname(ktx), "out.tsv")
    kernels.reset_counts()
    mem.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = kaiju.main(["-t", nodes, "-f", ktx, "-i", fq, "-a", "mem",
                     "-o", out_tsv, "-b", str(BATCH)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    replay = dict(mem.HOST_REPLAY)
    if rc != 0:
        raise AssertionError(f"kaiju main returned {rc}")
    log(f"e2e: {READS:,} reads in {dt:.2f} s = {READS / dt:.1f} "
        f"reads/s (index load, upload, seed tables and classification)")
    log(f"e2e: host replay {replay['flagged']} of {replay['reads']} reads "
        f"({replay['flagged'] / max(replay['reads'], 1):.4%})")
    log(f"e2e: launches {json.dumps(launches)}")
    if replay["reads"] != READS:
        raise AssertionError(f"classified {replay['reads']} of {READS} reads")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path did not launch: {launches}")

    with open(out_tsv, "rb") as fh:
        log(f"e2e: TSV sha256 {hashlib.sha256(fh.read()).hexdigest()[:16]}")
    with open(out_tsv) as fh:
        lines = fh.readlines()
    if len(lines) != READS:
        raise AssertionError(f"{len(lines)} TSV lines for {READS} reads")
    pick = list(range(0, READS, READS // 256))[:256]
    cfg = KaijuConfig(mode="mem", seg=True, use_Evalue=False)
    exact = ExactClassifier(index, Taxonomy(parse_nodes_dmp(nodes)), cfg)
    t0 = time.perf_counter()
    want = [format_output_line(*exact.classify_read(*reads[r]), False)
            for r in pick]
    diff = [r for r, w in zip(pick, want) if lines[r] != w]
    log(f"check: {len(pick)} sampled TSV lines against ExactClassifier: "
        f"{len(pick) - len(diff)} equal "
        f"({sum(w.startswith('C') for w in want)} classified; "
        f"{time.perf_counter() - t0:.1f} s)")
    if diff:
        r = diff[0]
        raise AssertionError(f"read {r}: {lines[r]!r} != {want[pick.index(r)]!r}")
    steady_stream(index, nodes, reads, make_reads(args.seed + 1, records, BATCH))

    # ---- 5. result lines ----------------------------------------------
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"kaiju_tpu_torch/csrc/{name}.cu",
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
        for name, (err, ms, plain_ms, bound_ms, _n) in checks.items()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20240817)
    ap.add_argument("--db-letters", type=int, default=64_000_000)
    args = ap.parse_args(argv)
    try:
        return run(args)
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
