#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kaiju_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 20240817] [--db-letters 64000000]

Phases, any failure exits non-zero:
  1. build the CUDA kernels from kaiju_tpu_torch/csrc with nvcc; print the
     build seconds and the card's name and power limit (nvidia-smi);
  2. generate a uniform synthetic protein database from --seed (the
     generator and size of bench.py) with a matching nodes.dmp, index it
     once with the port's native builder and save it twice under
     build/chip_smoke/: without a text copy (db.ktx, the .fmi
     configuration) and with it (db_text.ktx, what tools.mkdb writes);
     fill the two Bloom bitmaps of the text index (m = 11 for MEM, 7 for
     Greedy) into its cache; generate 65,536 reads (bench.py's count) and
     check that the threaded host fragmenter gives the same bytes as one
     thread;
  3. hold every kernel of both paths against its plain PyTorch version on
     the card, on the inputs the main path gives it, on each index: the
     depth-5 seed-table probes for A; the first 4,096-read batch of the
     MEM path for B, C, D (and G) and of the Greedy path at -e 3 for B, E,
     F.  On the text index B screens its lanes, G finishes the narrow
     ones, E runs its last-level hybrid and D, F read virtual rows.
     Integer outputs equal; time both;
  4. classify the reads in batches of 4,096 (bench.py's batch) through
     kaiju_tpu_torch.tools.kaiju.main, with -a mem and with the default
     flags (Greedy), on each index, counting each kernel's launches in
     each run (every kernel of the run's path must launch; on the text
     index B's screen and, for MEM, G too; on db.ktx G never), check 256
     sampled TSV lines of each run against the port's host
     ExactClassifier, and each path's whole TSV from db_text.ktx against
     its TSV from db.ktx, byte for byte;
  4b. for each path, on the text index and then on db.ktx, classify the
     reads again with the seed tables and bitmaps cached, untraced for the
     steady rate and the host seconds of each stage, and traced by
     torch.profiler for the device's idle share;
  5. print the kernels' JSON line (the text index's measurements; the
     launches of all four runs of phase 4), then the result line.

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
    "read_lca": "kaiju_tpu/ops/fused_classify.py:298",
    "greedy_search": "kaiju_tpu/ops/fused_greedy.py:298",
    "ranges_lca": "kaiju_tpu/ops/fused_classify.py:153",
    "text_extend": "kaiju_tpu/ops/fused_mem2.py:426",
}
# the kernels each path launches on an index without text (the text index
# adds G to MEM), and the CLI flags that select the path
PATHS = {
    "mem": (("update_si", "mem_extend", "mem_stats", "read_lca"),
            ["-a", "mem"]),
    "greedy": (("update_si", "mem_extend", "greedy_search", "ranges_lca"),
               []),
}
BLOOM_M = {"mem": 11, "greedy": 7}  # -m 11; Lmap = min(-l 7, -m 11)


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
        if (g is None) != (w is None):
            raise AssertionError("an output is missing on one side")
        if g is None:
            continue
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
    """(protein records, nodes.dmp, {"fmi": ktx dir without text, "text":
    ktx dir with text}) of the uniform DB; the text index's cache holds
    its two Bloom bitmaps."""
    from kaiju_tpu_torch.index import native_builder
    from kaiju_tpu_torch.index.core import KaijuIndex
    from kaiju_tpu_torch.ops import bloom

    cache = os.path.join(ROOT, "build", "chip_smoke",
                         f"db{letters}_seed{seed}")
    ktx = {"fmi": os.path.join(cache, "db.ktx"),
           "text": os.path.join(cache, "db_text.ktx")}
    nodes = os.path.join(cache, "nodes.dmp")
    names, codes, starts, ends, records = make_records(seed, letters)
    if all(os.path.exists(os.path.join(k, "meta.json"))
           for k in ktx.values()):
        return records, nodes, ktx
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
    log(f"db: indexed {int(ends[-1]):,} letters, {len(ends):,} sequences "
        f"in {time.perf_counter() - t0:.1f} s")
    index.save(ktx["text"])  # what tools.mkdb writes: with the text copy
    text = index.text
    index.text = None  # the reference .fmi carries no text copy
    index.save(ktx["fmi"])
    tidx = KaijuIndex.load(ktx["text"])
    for mode, m in BLOOM_M.items():
        t0 = time.perf_counter()
        words, _m, lb = bloom.load_words(tidx, ktx["text"], m)
        log(f"bloom {mode}: m {m}, lb {lb}: {words.nbytes:,} bytes filled "
            f"from {text.nbytes:,} text bytes and cached in "
            f"{time.perf_counter() - t0:.2f} s")
    return records, nodes, ktx


def check_fragmenter(reads) -> None:
    """Fragment every batch with the pipeline's fragmenter (two threads;
    its first call in the process is the first SEG call) and with one
    thread: the bytes must be equal.  Prints the lanes and a digest of the
    fragments, slot tables and overflow flags, to compare across machines."""
    import numpy as np

    from kaiju_tpu_torch.engine.fragments_native import NativeFragmenter2
    from kaiju_tpu_torch.engine.mem import MemPipeline
    from kaiju_tpu_torch.engine.pipeline import _bucket

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


def check_kernels(index, reads, ktx_dir):
    """Per kernel: (max_abs_err, ms, plain_ms, bound_ms, note), on the
    index at ktx_dir; with a text copy, B screens (its bitmaps cached in
    ktx_dir), G finishes the narrow MEM lanes, E runs its last-level hybrid
    and D, F read the virtual rows.  The bound counts each input byte once:
    the distinct record rows that the plain version reads, plus the other
    inputs and the outputs (E's per-position and per-source scratch is its
    own, not counted)."""
    import numpy as np
    import torch

    from kaiju_tpu_torch.engine.fragments_native import NativeFragmenter2
    from kaiju_tpu_torch.engine.greedy import GreedyPipeline
    from kaiju_tpu_torch.engine.mem import MemPipeline
    from kaiju_tpu_torch.engine.pipeline import _bucket
    from kaiju_tpu_torch.index.alphabet import trans_table
    from kaiju_tpu_torch.io.taxonomy import Taxonomy
    from kaiju_tpu_torch.ops import (classify, device_index, greedy, hybrid,
                                     search)
    from kaiju_tpu_torch.ops.bloom import BloomScreen
    from kaiju_tpu_torch.ops.kmer import NLET, KmerTables

    cuda = torch.device("cuda")
    dv = device_index.DeviceIndex(index, cuda)
    text = dv.has_text
    screens = {mode: BloomScreen.load_or_build(index, ktx_dir, m, cuda).args
               if text else None for mode, m in BLOOM_M.items()}
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

    # B (screened, stopping the narrow lanes), G, C, D on the first batch
    # of the MEM path
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
    sw_len = K + hybrid.S1_STEPS

    def extend_report(name, mode, ext, kw, note):
        """B on ext with kw; (its lanes, the lanes it evaluated)."""
        lanes = search.mem_extend(*ext, **kw)
        touched = []
        want = search.mem_extend_plain(*ext, touched, **kw)
        pos, _f, base, flen = search._lane_fragments(ext[6], P_[mode])
        usable = int(((pos - base >= ext[8]) & (pos - base < flen)).sum())
        evaluated = int((lanes[0] <= pos - base).sum())
        report(name, lanes, want, lambda: search.mem_extend(*ext, **kw),
               lambda: search.mem_extend_plain(*ext, **kw), touched,
               P_[mode] * (1 + 12) + 4 * (F_[mode] + 1)
               + (4 * usable if kw["bloom"] is not None else 0)
               + 9 * evaluated,
               f"{note}, {P_[mode]:,} lanes, {usable:,} usable, "
               f"{evaluated:,} evaluated")
        return lanes

    P_, F_ = {"mem": P}, {"mem": F}
    ext = (dv.rec, dv.C, *seed, flat, frag_off, K, j0)
    kw = dict(bloom=screens["mem"],
              sw_steps=hybrid.S1_STEPS if text else 0)
    lanes = extend_report("mem_extend", "mem", ext, kw,
                          "MEM batch" + (", screened (m 11)" if text else ""))
    sw_ids = None
    if text:
        g = (*lanes, flat, frag_off, sw_len, dv.text, dv.rank_start, dv.rec,
             dv.C, dv.sa_seq, dv.sa_off, dv.nseq, dv.chpt_exp)
        sw = hybrid.switched(*lanes, frag_off, sw_len)
        nsw, nocc = int(sw.sum()), int((lanes[2] - lanes[1])[sw].sum())
        res = hybrid.text_extend(*g)
        touched = []
        want = hybrid.text_extend_plain(*g, touched)
        ext_len = int((lanes[0] - res[0])[sw].sum())
        n_ids = int((res[2] - res[1])[sw].sum())
        report("text_extend", res, want, lambda: hybrid.text_extend(*g),
               lambda: hybrid.text_extend_plain(*g), touched,
               P * 24 + 4 * (F + 1) + nocc * 12
               + 2 * (ext_len + nsw) + 4 * n_ids,
               f"{nsw:,} switched lanes of {P:,}, {nocc:,} occurrences, "
               f"{ext_len:,} letters extended, {n_ids:,} ids")
        lanes, sw_ids = res[:3], res[3]

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
    virt = 0 if sw_ids is None else int((stats[3] >= hybrid.VBASE).sum())
    rows = classify.read_lca(*tail, sw_ids=sw_ids)
    touched = []
    want = classify.read_lca_plain(*tail, touched, sw_ids=sw_ids)
    report("read_lca", rows, want,
           lambda: classify.read_lca(*tail, sw_ids=sw_ids),
           lambda: classify.read_lca_plain(*tail, sw_ids=sw_ids), touched,
           4 * B * S + 16 * B + F * (8 + 8 * T),
           f"{B:,} reads, {virt:,} virtual tie rows")

    # B (screened), E, F on the first batch of the Greedy path at the
    # default flags (-e 3, -s 65, -m 11, -l 7: K = 5, Lmap = 7, T = 20)
    frag = NativeFragmenter2("greedy", 11, 65, True, False)
    flat, chars, frag_off, n_frags, _k, rf_rows, _o = frag.run(
        reads[:BATCH], GreedyPipeline.S_SLOTS, _bucket)
    flat = put(flat[:chars])
    frag_off = put(frag_off[: n_frags + 1])
    rf_rows = put(rf_rows)
    tables = tuple(put(a) for a in greedy.greedy_scoring_tables(
        index.alphabet, trans_table(index.alphabet)))
    lmap, T = 7, 20
    (B, S), P, F = rf_rows.shape, chars, n_frags
    P_["greedy"], F_["greedy"] = P, F
    ext = (dv.rec, dv.C, *seed, flat, frag_off, K, lmap - 1)
    kw = dict(bloom=screens["greedy"], sw_steps=0)
    if text:  # logged, not in the kernels line: MEM's B stands there
        lanes = extend_report("mem_extend (Greedy batch)", "greedy", ext, kw,
                              "Greedy batch, screened (m 7)")
    else:
        lanes = search.mem_extend(*ext, **kw)
    hyb = ((dv.text, dv.rank_start, dv.sa_seq, dv.sa_off, dv.nseq,
            dv.chpt_exp) if text else None)
    ge = (*lanes, flat, frag_off, rf_rows, dv.rec, dv.C, tables, lmap, 11, 65,
          3, T, GreedyPipeline.VCAP)
    found = greedy.greedy_search(*ge, hyb=hyb)
    touched = []
    want = greedy.greedy_search_plain(*ge, touched, hyb=hyb)
    virt = int((found[2] >= hybrid.VBASE).sum())
    report("greedy_search", found, want,
           lambda: greedy.greedy_search(*ge, hyb=hyb),
           lambda: greedy.greedy_search_plain(*ge, hyb=hyb), touched,
           P * (12 + 1) + 4 * (F + 1) + 4 * B * S + B * (8 + 8 * T),
           f"{B:,} reads, {P:,} lanes, -e 3, {virt:,} virtual tie rows")

    gf = (found[2], found[3], dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.seq_tax,
          par, dep, GreedyPipeline.R_BUDGET, 20, dv.nseq, dv.chpt_exp)
    res = classify.ranges_lca(*gf, sw_ids=found[4])
    touched = []
    want = classify.ranges_lca_plain(*gf, touched, sw_ids=found[4])
    report("ranges_lca", res, want,
           lambda: classify.ranges_lca(*gf, sw_ids=found[4]),
           lambda: classify.ranges_lca_plain(*gf, sw_ids=found[4]), touched,
           8 * B * T + 16 * B, f"{B:,} reads, {int((found[0] > 0).sum()):,} "
           "with a best")
    torch.cuda.synchronize()
    del dv, screens
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4b: where the time goes
# ---------------------------------------------------------------------------


def steady_stream(index, nodes, reads, warm, mode: str, tag: str) -> None:
    """Classify the reads again, twice, each time with a new pipeline of
    `mode` (seed tables and bitmaps cached) warmed by one batch of other
    reads, so that the host replay meets the reads afresh as in a real
    stream.  The untraced pass gives the steady rate and the host seconds
    of each stage; the pass under torch.profiler, tracing the card only,
    gives the device's busy share and each kernel's total."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kaiju_tpu_torch.engine import greedy, mem
    from kaiju_tpu_torch.io.taxonomy import Taxonomy, parse_nodes_dmp

    engine = greedy if mode == "greedy" else mem
    Pipeline = greedy.GreedyPipeline if mode == "greedy" else mem.MemPipeline
    cfg = cli_config(mode)
    tax = Taxonomy(parse_nodes_dmp(nodes))
    batches = [reads[i:i + BATCH] for i in range(0, len(reads), BATCH)]
    name = f"{mode} {tag}"

    def one_pass(traced: bool):
        t0 = time.perf_counter()
        pipe = Pipeline(index, tax, cfg, kmer_cache_dir=index.source_dir)
        pipe.classify_batch(warm)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        engine.reset_counts()
        trace = (profile(activities=[ProfilerActivity.CUDA]) if traced
                 else contextlib.nullcontext())
        with trace as prof:
            t0 = time.perf_counter()
            n = sum(len(r) for r in pipe.classify_stream(batches))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return n, wall, setup, prof

    n, wall, setup, _p = one_pass(False)
    host = dict(engine.HOST_SECONDS)
    log(f"steady {name}: {n:,} reads in {wall:.3f} s = {n / wall:.1f} "
        f"reads/s untraced (set-up and warm batch {setup:.2f} s not "
        "included)")
    host["other"] = wall - sum(host.values())
    log(f"steady {name}: host seconds " + ", ".join(
        f"{k} {v:.3f} ({v / wall:.1%})" for k, v in host.items())
        + f"; replayed {engine.HOST_REPLAY['flagged']} reads")
    _n, wall_t, _s, prof = one_pass(True)
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA]
    dev_us = sum(r.self_device_time_total for r in rows)
    if dev_us <= 0:
        log(f"steady {name}: device time not measured (the profiler saw "
            "none)")
        return
    busy = dev_us / 1e6 / wall_t
    log(f"steady {name}: traced pass {wall_t:.3f} s; device busy "
        f"{dev_us / 1e3:.3f} ms ({busy:.2%}); idle share {1 - busy:.2%}")
    for r in sorted(rows, key=lambda r: -r.self_device_time_total)[:8]:
        log(f"steady {name}: device {r.self_device_time_total / 1e3:9.3f} ms "
            f"x{r.count:<4d} {r.key[:70]}")


def cli_config(mode: str):
    """The KaijuConfig that tools.kaiju.main makes from the path's flags."""
    from kaiju_tpu_torch.engine.config import KaijuConfig

    if mode == "mem":
        return KaijuConfig(mode="mem", seg=True, use_Evalue=False)
    return KaijuConfig()  # the defaults: Greedy, -e 3, SEG, -E 0.01


def run_cli(index, reads, ktx, nodes, fq, mode: str, tag: str):
    """Classify the reads through tools.kaiju.main on the path `mode`,
    the seed tables built afresh (bitmaps as cached); fail unless every
    kernel of the path launched (on a text index B's screen and, for MEM,
    G too; without text G never), and unless 256 sampled TSV lines equal
    the ExactClassifier's.  Returns (the launch counts, the TSV path)."""
    import torch

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.engine import greedy, mem
    from kaiju_tpu_torch.engine.core import ExactClassifier, format_output_line
    from kaiju_tpu_torch.io.taxonomy import Taxonomy, parse_nodes_dmp
    from kaiju_tpu_torch.tools import kaiju

    engine = greedy if mode == "greedy" else mem
    path_kernels, flags = PATHS[mode]
    text = index.text is not None
    if text and mode == "mem":
        path_kernels = path_kernels + ("text_extend",)
    name = f"{mode} {tag}"
    shutil.rmtree(os.path.join(ktx, "kmer5"), ignore_errors=True)
    out_tsv = os.path.join(os.path.dirname(ktx), f"out_{mode}_{tag}.tsv")
    kernels.reset_counts()
    engine.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = kaiju.main(["-t", nodes, "-f", ktx, "-i", fq, *flags,
                     "-o", out_tsv, "-b", str(BATCH)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    screened = kernels.SCREENED["mem_extend"]
    replay = dict(engine.HOST_REPLAY)
    if rc != 0:
        raise AssertionError(f"kaiju main {flags} returned {rc}")
    log(f"e2e {name}: flags {flags}: {READS:,} reads in {dt:.2f} s = "
        f"{READS / dt:.1f} reads/s (index load, upload, seed tables, "
        "bitmaps and classification)")
    log(f"e2e {name}: host replay {replay['flagged']} of {replay['reads']} "
        f"reads ({replay['flagged'] / max(replay['reads'], 1):.4%}); "
        f"counts {json.dumps(replay)}")
    log(f"e2e {name}: launches {json.dumps(launches)}; B screened "
        f"{screened}")
    if replay["reads"] != READS:
        raise AssertionError(f"classified {replay['reads']} of {READS} reads")
    idle = [k for k in path_kernels if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels of the {name} path did not launch: "
                             f"{idle} ({launches})")
    if text and screened != launches["mem_extend"]:
        raise AssertionError(f"{name}: B launched {launches['mem_extend']} "
                             f"times, {screened} with its screen")
    if not text and (screened or launches["text_extend"]):
        raise AssertionError(f"{name}: a screen or G ran without text")
    if mode == "greedy" and launches["text_extend"]:
        raise AssertionError(f"{name}: G ran on the Greedy path")

    with open(out_tsv, "rb") as fh:
        log(f"e2e {name}: TSV sha256 "
            f"{hashlib.sha256(fh.read()).hexdigest()[:16]}")
    with open(out_tsv) as fh:
        lines = fh.readlines()
    if len(lines) != READS:
        raise AssertionError(f"{len(lines)} TSV lines for {READS} reads")
    pick = list(range(0, READS, READS // 256))[:256]
    exact = ExactClassifier(index, Taxonomy(parse_nodes_dmp(nodes)),
                            cli_config(mode))
    t0 = time.perf_counter()
    want = [format_output_line(*exact.classify_read(*reads[r]), False)
            for r in pick]
    diff = [r for r, w in zip(pick, want) if lines[r] != w]
    log(f"check {name}: {len(pick)} sampled TSV lines against "
        f"ExactClassifier: {len(pick) - len(diff)} equal "
        f"({sum(w.startswith('C') for w in want)} classified; "
        f"{time.perf_counter() - t0:.1f} s)")
    if diff:
        r = diff[0]
        raise AssertionError(f"read {r}: {lines[r]!r} != {want[pick.index(r)]!r}")
    return {k: launches[k] for k in REPLACES}, out_tsv


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.index.core import KaijuIndex
    from kaiju_tpu_torch.tools import readgen

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
    records, nodes, ktx = make_db(args.seed, args.db_letters)
    indexes = {tag: KaijuIndex.load(path) for tag, path in ktx.items()}
    index = indexes["fmi"]
    log(f"db: {index.length:,} BWT positions, {index.nseq:,} sequences, "
        f"ready in {time.perf_counter() - t0:.1f} s (both indexes and "
        "bitmaps)")
    reads = make_reads(args.seed, records)
    fq = os.path.join(os.path.dirname(ktx["fmi"]), f"reads_{READS}.fastq")
    readgen.write_fastq([(n, s) for n, s, _ in reads], fq)
    check_fragmenter(reads)

    # ---- 3. kernels against their plain versions -----------------------
    checks = {}
    for tag in ("fmi", "text"):
        checks[tag] = check_kernels(indexes[tag], reads, ktx[tag])
        for name, (err, ms, plain_ms, bound_ms, note) in checks[tag].items():
            log(f"kernel {name} [{tag}]: max_abs_err {err}, {ms:.4f} ms "
                f"(plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms) "
                f"[{note}]")
    bad = [(t, n) for t, c in checks.items() for n, v in c.items() if v[0]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    # ---- 4. end to end through the CLI, each run counted from 0 --------
    launches = {name: 0 for name in REPLACES}
    for mode in PATHS:
        tsv = {}
        for tag in ("text", "fmi"):
            counts, tsv[tag] = run_cli(indexes[tag], reads, ktx[tag], nodes,
                                       fq, mode, tag)
            for name, n in counts.items():
                launches[name] += n
        with open(tsv["text"], "rb") as a, open(tsv["fmi"], "rb") as b:
            same = a.read() == b.read()
        log(f"e2e {mode}: the whole TSV from db_text.ktx "
            f"{'equals' if same else 'DIFFERS FROM'} the one from db.ktx")
        if not same:
            raise AssertionError(f"{mode}: the text index changed the TSV")

    # ---- 4b. where the time goes ----------------------------------------
    warm = make_reads(args.seed + 1, records, BATCH)
    for tag in ("text", "fmi"):
        for mode in PATHS:
            steady_stream(indexes[tag], nodes, reads, warm, mode, tag)

    # ---- 5. result lines ----------------------------------------------
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"kaiju_tpu_torch/csrc/{name}.cu",
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
        for name, (err, ms, plain_ms, bound_ms, _n) in checks["text"].items()
        if name in REPLACES
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
