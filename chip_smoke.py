#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kaiju_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 20240817] [--db-letters 64000000]
    python3 chip_smoke.py --only-processes    # phases 1, 2, 4 (text), 4f

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
     Then the verbose paths' kernels: one batch of each -v pipeline on
     the card records the inputs of its first launch of H (the SA
     positions of the MEM batch's ties), K (B's lanes of the Greedy batch,
     Lmap 7, screened on the text index) and I (the first co-simulation
     round's variant lanes, also run in the code-row form), and J gets
     the MEM batch's fragments as a padded matrix.  Integer outputs
     equal; time both.  Then each kernel that reads the index (A, J, H,
     B, G, D, E, F) launched on the index in 2 and 4 shards (K16's sharded
     instantiations) on the same inputs must equal the unsharded kernel,
     and on the text index its plain version on the shards (timed).  B and
     E also print a second floor: the plain versions' longest chain of
     dependent row reads times the card's L2 latency, which csrc/chase.cu
     measures first.  Then B (the MEM batch screened with the hybrid's stop
     on the text index, unscreened without it on db.ktx; the Greedy batch)
     and E (-e 3, with and without the hybrid) on a DB with repeats
     (readgen.gen_realistic, bench.py's generator, 8 M letters, one batch
     of 4,096 of its reads), equal to their plain versions, timed.  Then
     P1 and P2 through their benchmark, tools.bench_gather (250,000 rows of
     512 bytes, 262,144 random rows): each equal to its plain version, bit
     for bit, timed beside torch.index_select and tab[idx].sum(1);
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
  4c. the verbose paths: tools.kaiju.main with -a mem -v and with -v on
     the first 16,384 reads (four batches) of db_text.ktx and on one batch
     of db.ktx, counting launches (MEM -v must launch A, B, C, H, Greedy
     -v A, B, K, I, H; on the text index every B screened, G never), each
     line's first three columns equal to phase 4's line of the same read,
     path and index, 256 sampled lines equal to ExactClassifier's with
     verbose=True, and on the text index the steady -v rate beside phase
     4b's with the host seconds of each stage, and the device's idle share
     of a traced pass; then a small
     constructed index whose read has a fragment with nine ties (more
     than TIE_CAP) through MEM -v: J must launch, equal its plain version
     on the inputs of each of its calls there, and every line equal
     ExactClassifier's;
  4d. the taxonomy-free tools on db.ktx, through their main and
     engine.batch.BatchRunner: kaijux -a mem on 16,384 reads, kaijux
     (Greedy) on 4,096, kaijup (Greedy) on 4,096 protein reads of
     readgen's make_protein_reads, kaijux -v on 4,096; every kernel of the
     path must launch (J and H for MEM, J, I, A and H for Greedy) and no
     other, 256 sampled lines must equal ExactClassifier's with
     taxonomy_free=True, and each kernel must equal its plain version on
     the arguments of its first call there (timed, with its bound); the
     two kaijux modes are timed again on a warm runner, untraced for the
     steady rate and host seconds and traced for the idle share.  Then
     kaiju-multi with the default flags on two samples (the first two
     batches of phase 4's reads): each output must equal phase 4's Greedy
     lines on db.ktx, and the stdout form their concatenation;
  4e. the index-sharded paths: tools.kaiju.main with -a mem and with the
     default flags (Greedy), each with --mesh-index 2 and 4, on the first
     16,384 reads of each index (seed tables built afresh, on the
     shards): every sharded kernel of the path must launch (A, B, D, and
     G on the text index, for MEM; A, B, E, F for Greedy) and no
     unsharded kernel that reads the index, and the TSV must equal phase
     4's lines of the same reads and path byte for byte; a steady pass on
     a warm sharded pipeline beside phase 4b's unsharded rate; then the
     sharded primitives (J over the first MEM batch's fragments, H on
     their SA positions) against the unsharded kernels;
  4f. many processes: tools.kaiju.main as 2 processes, process p on
     cuda:{p % cards} (on one card both on cuda:0, and the script says
     that the cross-card form was not run) (--dist-nprocs 2, a coordinator
     on 127.0.0.1, --dist-pid p; this script started again with
     --kaiju-worker, each process with its own -o and seed-table cache),
     on the first 16,384 reads of db_text.ktx, with -a mem and with the
     default flags, each with and without --mesh-index 2, and Greedy with
     --mesh-index 4: each process must launch every kernel of its path,
     each read must be in exactly one output, the one its batch share
     names, and the lines merged by read must equal phase 4's; with
     --mesh-index each process must hold exactly its shards (p mod S for
     N >= S, o mod N = p for N < S) and map the others from their holders
     over CUDA IPC, and process 0 holds each kernel of its path (A; B, G,
     C, D; B, E, F) on the arguments of its first call, on the mapped
     shards, against its plain version and against its launch on copies
     in its own memory (both launches timed); the card memory used after
     set-up, the index bytes held apart beside two whole copies, and the
     processes' wall beside the one-process main() of the same reads;
  4g. the index above 2^31 letters (K17): a synthetic DB of 2.2 G
     letters (N about 1.03 x 2^31) from the demo's
     seed, built with the int64 builder on every host thread in a thread
     of its own that starts after phase 4b and runs beside phases 4c-4f
     (it slows their host stages; 4b's steady rates run alone);
     then tools.big_classify.run on the demo's 1,024 reads of 64 at S = 2
     (saved, loaded onto the card, L then M twice, the host statistics,
     every lane of 24 sampled reads against its host oracle) and at S = 8
     (each run counted from 0; L and M must launch in each), the four
     arrays of S = 8 equal to S = 2's; L and M against their plain
     versions on the card on the S = 2 run's reads (timed, bound from the
     distinct rows), an interval starting at 2^31 or later; a steady
     big_mem_step over 65,536 reads (reads/s, L's and M's ms, the host
     statistics' seconds), with build, save and load seconds, the card's
     bytes for the index and the host's peak RSS;
  5. print the kernels' JSON line (the text index's measurements, the
     sharded kernels' on 4 shards, L's and M's on the big index; the
     launches of every run of phases 4, 4c, 4d, 4e, 4f and 4g, each
     counted from 0, and of P1 and P2's benchmark; each error the largest
     of all the kernel's comparisons), then the result line.

Needs a CUDA device; imports nothing of JAX or of kaiju_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
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
    "sa_lookup": "kaiju_tpu/ops/device_index.py:411",
    "extend_from": "kaiju_tpu/ops/device_index.py:348",
    "extend_all": "kaiju_tpu/ops/device_index.py:216",
    "greedy_map": "kaiju_tpu/ops/fused_mem2.py:1011",
    "gather_rows": "bench_pallas_gather.py:75",
    "gather_sum": "bench_pallas_gather.py:125",
    "update_si_sharded": "kaiju_tpu/parallel/sharded_index.py:102",
    "extend_all_sharded": "kaiju_tpu/parallel/sharded_index.py:123",
    "sa_lookup_sharded": "kaiju_tpu/parallel/sharded_index.py:185",
    "mem_extend_sharded": "kaiju_tpu/parallel/sharded_fused.py:52",
    "text_extend_sharded": "kaiju_tpu/parallel/sharded_fused.py:153",
    "read_lca_sharded": "kaiju_tpu/parallel/sharded_fused.py:78",
    "greedy_search_sharded": "kaiju_tpu/parallel/sharded_fused.py:278",
    "ranges_lca_sharded": "kaiju_tpu/parallel/sharded_fused.py:278",
    "big_extend_all": "scripts/big_classify_demo.py:296",
    "big_sa_walk": "scripts/big_classify_demo.py:332",
}
# P1, P2: the one PyTorch call computing the same function, if any
LIBRARY = {"gather_rows": "torch.index_select(tab, 0, idx)"}
# the kernels that read the index, whose sharded instantiations (K16) the
# index-sharded paths run (A for the seed tables; B, G, D for MEM; B, E, F
# for Greedy; H and J beside them)
SHARDED = ("update_si", "extend_all", "sa_lookup", "mem_extend",
           "text_extend", "read_lca", "greedy_search", "ranges_lca")
MESH = (2, 4)  # index shards of phase 3's sharded checks and phase 4e
MESH_READS = 4 * BATCH  # reads of each phase 4e and 4f run
NPROCS = 2  # processes of each phase 4f run, process p on cuda:{p % cards}
# phase 4f's runs (--mesh-index, path): one index a process; the shards
# held apart with N = S; N < S (two shards held and two mapped a process)
PROC_RUNS = ((0, "mem"), (0, "greedy"), (2, "mem"), (2, "greedy"),
             (4, "greedy"))
# the kernels each path launches on an index without text (the text index
# adds G to MEM), and the CLI flags that select the path
PATHS = {
    "mem": (("update_si", "mem_extend", "mem_stats", "read_lca"),
            ["-a", "mem"]),
    "greedy": (("update_si", "mem_extend", "greedy_search", "ranges_lca"),
               []),
}
BLOOM_M = {"mem": 11, "greedy": 7}  # -m 11; Lmap = min(-l 7, -m 11)
# the kernels each verbose path launches (J only on a fragment with more
# than TIE_CAP ties), and its flags
VERBOSE_PATHS = {
    "mem": (("update_si", "mem_extend", "mem_stats", "sa_lookup"),
            ["-a", "mem", "-v"]),
    "greedy": (("update_si", "mem_extend", "greedy_map", "extend_from",
                "sa_lookup"), ["-v"]),
}
V_READS = 4 * BATCH  # reads of the verbose runs on the text index
# phase 4d, on db.ktx: each run of a taxonomy-free tool (tool, flags, kind
# of reads, read count) and the kernels it must launch; the kernel wrappers
# BatchRunner calls (engine.batch; extend_rows launches extend_from)
X_SERVE = ("extend_all", "extend_from", "update_si", "sa_lookup")
X_RUNS = {
    "kaijux mem": ("kaijux", ["-a", "mem"], "dna", 4 * BATCH,
                   ("extend_all", "sa_lookup")),
    "kaijux greedy": ("kaijux", [], "dna", BATCH, X_SERVE),
    "kaijup greedy": ("kaijup", [], "protein", BATCH, X_SERVE),
    "kaijux -v": ("kaijux", ["-v"], "dna", BATCH, X_SERVE),
}
X_WRAPPERS = ("extend_all", "extend_rows", "update_si", "sa_lookup")
X_STEADY = ("kaijux mem", "kaijux greedy")  # the runs timed again
# phase 4g, the index above 2^31 letters (K17): the DB's letters (N about
# 1.03 x 2^31) and seed (the demo's default), the shards of the two runs,
# the demo's reads, read length and sampled reads, and the kernels
BIG_LETTERS = 2_200_000_000
BIG_SEED = 20260821
BIG_SHARDS = (2, 8)
BIG_READS, BIG_LEN, BIG_VERIFY = 1024, 64, 24
BIG_KERNELS = ("big_extend_all", "big_sa_walk")
# phase 3's DB with repeats (readgen.gen_realistic, bench.py's generator):
# its letters, and the kernels held to their plain versions there
REPEATS_LETTERS = 8_000_000
# a read's positions that kernel E holds in shared memory (kLcap of
# csrc/greedy_search.cu); phase 3 counts the reads past it
E_SHARED_POSITIONS = 512


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


def make_repeats_db(seed: int, letters: int = REPEATS_LETTERS):
    """(protein records, {"fmi": ktx dir without text, "text": ktx dir
    with text}) of a DB with repeats: readgen.gen_realistic (bench.py's
    generator: gene families copied exactly and at ~90 % identity, with
    low-complexity runs) from seed + 2, indexed with the native builder;
    the text index's cache holds its two Bloom bitmaps."""
    import numpy as np

    from kaiju_tpu_torch.index import native_builder
    from kaiju_tpu_torch.index.core import KaijuIndex
    from kaiju_tpu_torch.ops import bloom
    from kaiju_tpu_torch.tools import readgen

    t0 = time.perf_counter()
    records = readgen.gen_realistic(random.Random(seed + 2), letters)
    cache = os.path.join(ROOT, "build", "chip_smoke",
                         f"repeats{letters}_seed{seed}")
    ktx = {"fmi": os.path.join(cache, "db.ktx"),
           "text": os.path.join(cache, "db_text.ktx")}
    if not all(os.path.exists(os.path.join(k, "meta.json"))
               for k in ktx.values()):
        lut = np.zeros(256, dtype=np.uint8)
        lut[np.frombuffer(AA.encode(), dtype=np.uint8)] = np.arange(
            1, 21, dtype=np.uint8)
        index = native_builder.build_index_from_codes(
            [n for n, _ in records],
            [lut[np.frombuffer(q.encode(), dtype=np.uint8)]
             for _, q in records])
        index.save(ktx["text"])
        index.text = None
        index.save(ktx["fmi"])
        tidx = KaijuIndex.load(ktx["text"])
        for m in BLOOM_M.values():
            bloom.load_words(tidx, ktx["text"], m)
    log(f"repeats db: {sum(len(q) for _, q in records):,} letters, "
        f"{len(records):,} sequences, both indexes and bitmaps ready in "
        f"{time.perf_counter() - t0:.1f} s")
    return records, ktx


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


@contextlib.contextmanager
def dependent_reads():
    """Counts the rounds of dependent record-row reads of the plain
    versions of B and E run inside the block.  Their lanes step in
    lockstep, so a round is one link of the batch's longest chain of
    dependent reads.  Yields a dict filled on exit: "steps", B's FM-step
    rounds (a step's two ranks read in parallel: one round); "levels",
    E's rounds of each variant level: the probe, then the longer of the
    resumed extension and the last level's SA walks."""
    from kaiju_tpu_torch.ops import device_index, greedy, search

    trace = []
    orig = (search.rank, greedy.rank, device_index.rank, greedy._resume)

    def pair_rank(*a, **k):
        trace.append("p")
        return orig[0](*a, **k)

    def walk_rank(*a, **k):
        trace.append("w")
        return orig[2](*a, **k)

    def resume(*a, **k):
        trace.append("[")
        r = orig[3](*a, **k)
        trace.append("]")
        return r

    search.rank = greedy.rank = pair_rank
    device_index.rank = walk_rank
    greedy._resume = resume
    out = {}
    try:
        yield out
    finally:
        search.rank, greedy.rank, device_index.rank, greedy._resume = orig
    out["steps"] = trace.count("p") // 2
    # E's levels: a probe pair, "[" its resumed extension's pairs "]",
    # then the switch's walk rounds, until the next level's probe pair
    levels, state, res, walks = [], None, 0, 0
    for t in trace:
        if t == "[":
            state, res, walks = "resume", 0, 0
        elif t == "]":
            state = "after"
        elif t == "p" and state == "resume":
            res += 1
        elif t == "p" and state == "after":
            levels.append(1 + max(res // 2, walks))
            state = "probe"
        elif t == "w" and state == "after":
            walks += 1
    if state == "after":
        levels.append(1 + max(res // 2, walks))
    out["levels"] = levels


def floor_note(chain: int, lat_ns: float) -> str:
    """The latency floor of a chain of `chain` dependent row reads, each
    at least one L2 hit (lat_ns)."""
    return (f"longest chain {chain} dependent row reads: latency floor "
            f"{chain * lat_ns / 1e6:.4f} ms at {lat_ns:.1f} ns")


def measure(got, want, fn, plain_fn, touched, other_bytes, note):
    """(max_abs_err, ms, plain_ms, bound_ms, note) of a kernel whose
    outputs `got` its plain version gave as `want`: fn and plain_fn timed
    on the card, the bound from the distinct record rows in `touched` and
    `other_bytes`."""
    rb, nrows = row_bytes(touched)
    return (max_abs_err(got, want), cuda_ms(fn),
            cuda_ms(plain_fn, reps=3, warm=1),
            (rb + other_bytes) / HBM_BYTES_PER_S * 1e3,
            f"{note}, {nrows:,} row reads of {rb // 256:,} rows")


def check_kernels(index, reads, ktx_dir, lat_ns: float, full: bool = True):
    """Per kernel: (max_abs_err, ms, plain_ms, bound_ms, note), on the
    index at ktx_dir; with a text copy, B screens (its bitmaps cached in
    ktx_dir), G finishes the narrow MEM lanes, E runs its last-level hybrid
    and D, F read the virtual rows.  The bound counts each input byte once:
    the distinct record rows that the plain version reads, plus the other
    inputs and the outputs (E's per-position and per-source scratch is its
    own, not counted).  B's and E's notes carry their second floor, the
    longest chain of dependent row reads times the L2 latency lat_ns.
    full=False: B on the MEM and the Greedy batch and E alone."""
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
    inputs = {}  # name: (dv, args, kwargs, other bytes, note) of its check

    def report(name, *args, call=None):
        out[name] = measure(*args)
        if call is not None:
            inputs[name] = (dv, *call, args[-2], args[-1])

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
    if full:
        want = update_si_plain(touched)
        report("update_si", device_index.update_si(dv.rec, dv.C, c, s0, s1),
               want, lambda: device_index.update_si(dv.rec, dv.C, c, s0, s1),
               update_si_plain, touched, n * (12 + 9), f"{n:,} probes",
               call=((dv.rec, dv.C, c, s0, s1), {}))

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
        with dependent_reads() as dep:
            want = search.mem_extend_plain(*ext, touched, **kw)
        pos, _f, base, flen = search._lane_fragments(ext[6], P_[mode])
        usable = int(((pos - base >= ext[8]) & (pos - base < flen)).sum())
        evaluated = int((lanes[0] <= pos - base).sum())
        # the seed row, the bitmap word, then one row pair a step
        chain = dep["steps"] + 1 + (kw["bloom"] is not None)
        report(name, lanes, want, lambda: search.mem_extend(*ext, **kw),
               lambda: search.mem_extend_plain(*ext, **kw), touched,
               P_[mode] * (1 + 12) + 4 * (F_[mode] + 1)
               + (4 * usable if kw["bloom"] is not None else 0)
               + 9 * evaluated,
               f"{note}, {P_[mode]:,} lanes, {usable:,} usable, "
               f"{evaluated:,} evaluated; {floor_note(chain, lat_ns)}",
               call=(ext, kw))
        return lanes

    P_, F_ = {"mem": P}, {"mem": F}
    ext = (dv.rec, dv.C, *seed, flat, frag_off, K, j0)
    kw = dict(bloom=screens["mem"],
              sw_steps=hybrid.S1_STEPS if text else 0)
    lanes = extend_report("mem_extend", "mem", ext, kw,
                          "MEM batch" + (", screened (m 11)" if text else ""))
    sw_ids = None
    if text and full:
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
               f"{ext_len:,} letters extended, {n_ids:,} ids",
               call=(g, {}))
        lanes, sw_ids = res[:3], res[3]

    par, dep = (put(a) for a in Taxonomy(
        {1: 1, 10: 1, **{t: 10 for t in range(100, 197)}}).dense_arrays())
    if full:
        st = (*lanes, frag_off, min_len, T)
        stats = search.mem_stats(*st)
        report("mem_stats", stats, search.mem_stats_plain(*st),
               lambda: search.mem_stats(*st),
               lambda: search.mem_stats_plain(*st), [],
               12 * P + 4 * (F + 1) + F * (8 + 12 * T), f"{F:,} fragments")

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
               lambda: classify.read_lca_plain(*tail, sw_ids=sw_ids),
               touched, 4 * B * S + 16 * B + F * (8 + 8 * T),
               f"{B:,} reads, {virt:,} virtual tie rows",
               call=(tail, {"sw_ids": sw_ids}))

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
    # logged, not in the kernels line: MEM's B stands there
    lanes = extend_report("mem_extend (Greedy batch)", "greedy", ext, kw,
                          "Greedy batch" + (", screened (m 7)" if text
                                            else ""))
    hyb = ((dv.text, dv.rank_start, dv.sa_seq, dv.sa_off, dv.nseq,
            dv.chpt_exp) if text else None)
    ge = (*lanes, flat, frag_off, rf_rows, dv.rec, dv.C, tables, lmap, 11, 65,
          3, T, GreedyPipeline.VCAP)
    found = greedy.greedy_search(*ge, hyb=hyb)
    touched = []
    with dependent_reads() as dep_r:
        want = greedy.greedy_search_plain(*ge, touched, hyb=hyb)
    virt = int((found[2] >= hybrid.VBASE).sum())
    flen = frag_off[1:] - frag_off[:-1]
    read_len = torch.where(rf_rows >= 0, flen[rf_rows.clamp(min=0).long()],
                           0).sum(1)
    n_long = int((read_len > E_SHARED_POSITIONS).sum())
    # the longest level bounds any one read's chain from below; the batch
    # runs the levels in turn, a read no more than all of them
    levels = dep_r["levels"]
    report("greedy_search", found, want,
           lambda: greedy.greedy_search(*ge, hyb=hyb),
           lambda: greedy.greedy_search_plain(*ge, hyb=hyb), touched,
           P * (12 + 1) + 4 * (F + 1) + 4 * B * S + B * (8 + 8 * T),
           f"{B:,} reads, {P:,} lanes, -e 3, {virt:,} virtual tie rows, "
           f"{n_long:,} reads over {E_SHARED_POSITIONS} positions (longest "
           f"{int(read_len.max())}); levels {levels} rounds: "
           f"{floor_note(max(levels, default=0), lat_ns)}",
           call=(ge, {"hyb": hyb}))

    if full:
        gf = (found[2], found[3], dv.rec, dv.C, dv.sa_seq, dv.sa_off,
              dv.seq_tax, par, dep, GreedyPipeline.R_BUDGET, 20, dv.nseq,
              dv.chpt_exp)
        res = classify.ranges_lca(*gf, sw_ids=found[4])
        touched = []
        want = classify.ranges_lca_plain(*gf, touched, sw_ids=found[4])
        report("ranges_lca", res, want,
               lambda: classify.ranges_lca(*gf, sw_ids=found[4]),
               lambda: classify.ranges_lca_plain(*gf, sw_ids=found[4]),
               touched, 8 * B * T + 16 * B,
               f"{B:,} reads, {int((found[0] > 0).sum()):,} with a best",
               call=(gf, {"sw_ids": found[4]}))
    torch.cuda.synchronize()
    del dv, screens
    torch.cuda.empty_cache()
    return out, inputs


def check_verbose_kernels(index, nodes, reads, ktx_dir):
    """H, I, J and K against their plain versions on the inputs the -v
    paths give them, on the index at ktx_dir: one batch through each -v
    pipeline on the card records the first launch of H (MEM: the SA
    positions of the batch's ties), K (Greedy: B's lanes, Lmap 7) and I
    (Greedy: the first co-simulation round's variant lanes); J takes the
    MEM batch's fragments as a 0-padded code matrix.  I runs its code-row
    form on the same lanes too (each lane's parent codes with its
    substitution), which must agree.  Same tuple as check_kernels."""
    import numpy as np
    import torch

    from kaiju_tpu_torch.engine import greedy_fast, mem_fast
    from kaiju_tpu_torch.io.taxonomy import Taxonomy, parse_nodes_dmp
    from kaiju_tpu_torch.ops import device_index, search

    seen = {}
    patched = [(mem_fast, "sa_lookup"), (greedy_fast, "greedy_map"),
               (greedy_fast, "extend_from")]
    real = {name: getattr(mod, name) for mod, name in patched}

    def spy(name):
        def call(*args):
            seen.setdefault(name, args)
            return real[name](*args)
        return call

    tax = Taxonomy(parse_nodes_dmp(nodes))
    try:
        for mod, name in patched:
            setattr(mod, name, spy(name))
        mem_pipe = mem_fast.MemFastPipeline(index, tax, cli_config("mem", True),
                                            kmer_cache_dir=ktx_dir)
        mem_pipe.classify_batch(reads[:BATCH])
        greedy_fast.GreedyFastPipeline(
            index, tax, cli_config("greedy", True),
            kmer_cache_dir=ktx_dir).classify_batch(reads[:BATCH])
    finally:
        for mod, name in patched:
            setattr(mod, name, real[name])
    missing = {"sa_lookup", "greedy_map", "extend_from"} - set(seen)
    if missing:
        raise AssertionError(f"the -v batches launched no {sorted(missing)}")
    out = {}
    inputs = {}  # as check_kernels'

    def report(name, *args, call=None):
        out[name] = measure(*args)
        if call is not None:
            inputs[name] = (mem_pipe.dev, *call, args[-2], args[-1])

    # H on the SA positions of the MEM batch's first resolution round
    h = seen["sa_lookup"]
    n = h[-1].shape[0]
    touched = []
    want = device_index.sa_lookup_plain(*h, touched)
    report("sa_lookup", device_index.sa_lookup(*h), want,
           lambda: device_index.sa_lookup(*h),
           lambda: device_index.sa_lookup_plain(*h), touched, n * (4 + 8 + 8),
           f"{n:,} SA positions of the MEM -v batch's ties", call=(h, {}))

    # I on the first co-simulation round's variant lanes; its code-row
    # form on the same lanes
    i_args = seen["extend_from"]
    rec, C, flat, base, pos, sub, start, s0, s1, act = i_args
    n = base.shape[0]
    got = device_index.extend_from(*i_args)
    touched = []
    want = device_index.extend_from_plain(*i_args, touched)
    L = max(int(start.max()), 1)
    x = torch.arange(L, device=flat.device, dtype=torch.int32)
    codes = flat[torch.clamp(base[:, None] + x, max=flat.shape[0] - 1).long()]
    codes = torch.where(x == pos[:, None], sub[:, None].to(torch.uint8), codes)
    rows = device_index.extend_rows(rec, C, codes.contiguous(), start, s0, s1,
                                    act)
    if max_abs_err(rows, got):
        raise AssertionError("I: the code-row form differs from the flat form")
    steps = int((start - got[0])[act].sum())
    report("extend_from", got, want, lambda: device_index.extend_from(*i_args),
           lambda: device_index.extend_from_plain(*i_args), touched,
           n * (25 + 12) + steps + n,
           f"{n:,} variant lanes of the first Greedy -v round, {steps:,} "
           "steps; the code-row form agrees")

    # J on the MEM batch's fragments
    enc = [mem_pipe._encode(f) for f in mem_pipe._frags]
    F, L = len(enc), max(len(e) for e in enc)
    codes = np.zeros((F, L), dtype=np.uint8)
    for t, e in enumerate(enc):
        codes[t, : len(e)] = e
    flen = np.asarray([len(e) for e in enc], dtype=np.int32)
    j_args = (mem_pipe.dev.rec, mem_pipe.dev.C,
              torch.from_numpy(codes).to(rec.device),
              torch.from_numpy(flen).to(rec.device))
    touched = []
    want = device_index.extend_all_plain(*j_args, touched)
    report("extend_all", device_index.extend_all(*j_args), want,
           lambda: device_index.extend_all(*j_args),
           lambda: device_index.extend_all_plain(*j_args), touched,
           F * L * (1 + 12) + 4 * F,
           f"{F:,} fragments of the MEM -v batch as [{F:,}, {L}] codes",
           call=(j_args, {}))

    # K on B's lanes of the Greedy batch: i of every lane, s0 and s1 of
    # each lane that makes a row, and the rows
    k_args = seen["greedy_map"]
    rows, n_rows = search.greedy_map(*k_args)
    want, n_want = search.greedy_map_plain(*k_args)
    nr = int(n_rows)
    if nr != int(n_want):
        raise AssertionError(f"K: {nr} rows, the plain version {int(n_want)}")

    def order(r):
        r = r.cpu().numpy()
        return torch.from_numpy(r[np.lexsort((-r[:, 1], r[:, 0]))])

    P, F = k_args[0].shape[0], k_args[3].shape[0] - 1
    report("greedy_map", order(rows[:nr]), order(want),
           lambda: search.greedy_map(*k_args),
           lambda: search.greedy_map_plain(*k_args), [],
           4 * P + 4 * (F + 1) + (8 + 20) * nr + 4,
           f"{P:,} lanes of {F:,} fragments of the Greedy -v batch, "
           f"Lmap {k_args[4]}, {nr:,} rows (compared as sorted sets)")
    del mem_pipe
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out, inputs


def check_gather(seed: int):
    """P1 and P2 through their benchmark, tools.bench_gather (NB = 250,000
    rows of 512 bytes, N = 262,144 random rows): each against its plain
    version, bit for bit, then timed beside torch.index_select and
    tab[idx].sum(1).  Returns (the measure() tuple by kernel, the launch
    counts of the run)."""
    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.tools import bench_gather

    kernels.reset_counts()
    res = bench_gather.run(seed)
    launches = {k: kernels.LAUNCHES[k] for k in res}
    out = {}
    for name, r in res.items():
        lib = (f"{LIBRARY[name]} {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None
               else "no single call; the plain tab[idx].sum(1) is two")
        n = r["rows"]  # the bound if every one of the N rows moved
        all_rows = (n * 512 * (2 if name == "gather_rows" else 1)
                    + 4 * n * (1 if name == "gather_rows" else 2))
        log(f"gather {name}: {r['ms']:.4f} ms = {r['m_rows_per_s']:.1f} M "
            f"rows/s, {r['gb_per_s']:.1f} GB/s; bound {r['bound_ms']:.4f} ms "
            f"over the {r['distinct_rows']:,} distinct rows "
            f"({r['bound_ms'] / r['ms']:.1%} of the time; "
            f"{all_rows / HBM_BYTES_PER_S * 1e3:.4f} ms counting all "
            f"{n:,}); plain {r['plain_ms']:.4f} ms; {lib}; "
            f"{launches[name]} launches")
        out[name] = (r["max_abs_err"], r["ms"], r["plain_ms"], r["bound_ms"],
                     f"{r['rows']:,} random rows ({r['distinct_rows']:,} "
                     f"distinct) of a [{r['table_rows']:,}, 128] int32 table",
                     r["library_ms"])
    return out, launches


def shard_call(sh, dv, args, kw):
    """(args, kw) of a kernel call on the DeviceIndex dv with its index
    arrays swapped for the shards of sh (a ShardedIndex)."""
    swap = {id(dv.rec): sh.rec, id(dv.sa_seq): sh.sa_seq,
            id(dv.sa_off): sh.sa_off}
    if dv.has_text:
        swap[id(dv.text)] = sh.text
    sargs = tuple(swap.get(id(a), a) for a in args)
    # E's hybrid is a keyword tuple of index arrays
    skw = {k: tuple(swap.get(id(x), x) for x in v)
           if isinstance(v, tuple) else v for k, v in kw.items()}
    return sargs, skw


def check_sharded(index, inputs, n_shards: int, timed: bool):
    """Each kernel that reads the index (SHARDED) launched on the index in
    n_shards shards, on the arguments of its phase 3 check with the index
    arrays swapped for their shards: its outputs must equal the unsharded
    kernel's; timed: also held against its plain version on the shards and
    timed, with the unsharded check's bound.  Returns {kernel_sharded:
    measure() tuple or (max_abs_err,)}."""
    import torch

    from kaiju_tpu_torch.ops import (classify, device_index, greedy, hybrid,
                                     search)
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    fns = {"update_si": (device_index.update_si, device_index.update_si_plain),
           "extend_all": (device_index.extend_all,
                          device_index.extend_all_plain),
           "sa_lookup": (device_index.sa_lookup, device_index.sa_lookup_plain),
           "mem_extend": (search.mem_extend, search.mem_extend_plain),
           "text_extend": (hybrid.text_extend, hybrid.text_extend_plain),
           "read_lca": (classify.read_lca, classify.read_lca_plain),
           "greedy_search": (greedy.greedy_search, greedy.greedy_search_plain),
           "ranges_lca": (classify.ranges_lca, classify.ranges_lca_plain)}
    sh = ShardedIndex(index, n_shards, torch.device("cuda"))
    out = {}
    for name in SHARDED:
        if name not in inputs:  # G on an index without text
            continue
        dv, args, kw, other_bytes, note = inputs[name]
        sargs, skw = shard_call(sh, dv, args, kw)
        fn, plain = fns[name]
        got = fn(*sargs, **skw)
        err = max_abs_err(got, fn(*args, **kw))
        if timed:
            touched = []
            want = plain(*sargs, touched, **skw)
            err_p, *rest = measure(
                got, want, lambda: fn(*sargs, **skw),
                lambda: plain(*sargs, **skw), touched, other_bytes,
                f"{note}; {n_shards} shards of {sh.nb_s:,} blocks")
            out[name + "_sharded"] = (max(err, err_p), *rest)
        else:
            out[name + "_sharded"] = (err,)
    torch.cuda.synchronize()
    del sh
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
    gives the device's busy share and each kernel's total.  Returns the
    untraced pass's reads/s."""
    import torch
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
    log_device_time(name, prof, wall_t)
    return n / wall


def log_device_time(name: str, prof, wall: float, top: int = 8) -> None:
    """Print the device's busy and idle share of a pass of `wall` seconds
    traced by `prof` (torch.profiler, card only) and its `top` kernels."""
    from torch.autograd import DeviceType

    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA]
    dev_us = sum(r.self_device_time_total for r in rows)
    if dev_us <= 0:
        log(f"steady {name}: device time not measured (the profiler saw "
            "none)")
        return
    busy = dev_us / 1e6 / wall
    log(f"steady {name}: traced pass {wall:.3f} s; device busy "
        f"{dev_us / 1e3:.3f} ms ({busy:.2%}); idle share {1 - busy:.2%}")
    for r in sorted(rows, key=lambda r: -r.self_device_time_total)[:top]:
        log(f"steady {name}: device {r.self_device_time_total / 1e3:9.3f} ms "
            f"x{r.count:<4d} {r.key[:70]}")


def cli_config(mode: str, verbose: bool = False):
    """The KaijuConfig that tools.kaiju.main makes from the path's flags
    (with -v: verbose)."""
    from kaiju_tpu_torch.engine.config import KaijuConfig

    if mode == "mem":
        return KaijuConfig(mode="mem", seg=True, use_Evalue=False,
                           verbose=verbose)
    # the defaults: Greedy, -e 3, SEG, -E 0.01
    return KaijuConfig(verbose=verbose)


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
    flags = PATHS[mode][1]
    text = index.text is not None
    path = kernels_of(mode, text, False)
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
    idle = [k for k in path if launches[k] <= 0]
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
# phase 4c: the verbose paths
# ---------------------------------------------------------------------------


def run_verbose_cli(index, reads, ktx, nodes, mode, tag, n_reads, base_tsv,
                    base_rate):
    """Classify the first n_reads reads through tools.kaiju.main on the
    verbose path `mode` (seed tables built afresh, bitmaps as cached);
    fail unless every kernel of the path launched (on a text index every
    B with its screen; G never), unless each line's first three columns
    equal phase 4's line of the same read (base_tsv), and unless 256
    sampled lines equal ExactClassifier's with verbose=True.  Then, on the
    text index, classify the reads again on a new pipeline warmed by one
    batch of other reads, untraced for the steady -v rate beside the
    path's steady rate of phase 4b (base_rate) and the host seconds of
    each stage, and once more under
    torch.profiler for the device's idle share.  Returns the launch
    counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.engine import greedy_fast, mem_fast
    from kaiju_tpu_torch.engine.core import ExactClassifier, format_output_line
    from kaiju_tpu_torch.io.taxonomy import Taxonomy, parse_nodes_dmp
    from kaiju_tpu_torch.tools import kaiju, readgen

    path_kernels, flags = VERBOSE_PATHS[mode]
    text = index.text is not None
    name = f"{mode} -v {tag}"
    fq = os.path.join(os.path.dirname(ktx), f"reads_{n_reads}.fastq")
    if not os.path.exists(fq):
        readgen.write_fastq([(n, s) for n, s, _ in reads[:n_reads]], fq)
    shutil.rmtree(os.path.join(ktx, "kmer5"), ignore_errors=True)
    out_tsv = os.path.join(os.path.dirname(ktx), f"out_{mode}_v_{tag}.tsv")
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = kaiju.main(["-t", nodes, "-f", ktx, "-i", fq, *flags,
                     "-o", out_tsv, "-b", str(BATCH)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    screened = kernels.SCREENED["mem_extend"]
    if rc != 0:
        raise AssertionError(f"kaiju main {flags} returned {rc}")
    log(f"e2e {name}: flags {flags}: {n_reads:,} reads in {dt:.2f} s = "
        f"{n_reads / dt:.1f} reads/s with set-up")
    log(f"e2e {name}: launches {json.dumps(launches)}; B screened "
        f"{screened}")
    idle = [k for k in path_kernels if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels of the {name} path did not launch: "
                             f"{idle} ({launches})")
    if text and screened != launches["mem_extend"]:
        raise AssertionError(f"{name}: B launched {launches['mem_extend']} "
                             f"times, {screened} with its screen")
    if not text and screened:
        raise AssertionError(f"{name}: a screen ran without text")
    tail = ("text_extend", "read_lca", "greedy_search", "ranges_lca")
    if any(launches[k] for k in tail):
        raise AssertionError(f"{name}: a device-tail kernel ran ({launches})")

    with open(out_tsv) as fh:
        lines = fh.readlines()
    with open(base_tsv) as fh:
        base = [next(fh) for _ in range(n_reads)]
    if len(lines) != n_reads:
        raise AssertionError(f"{len(lines)} TSV lines for {n_reads} reads")
    cut = [r for r in range(n_reads)
           if "\t".join(lines[r].rstrip("\n").split("\t")[:3])
           != base[r].rstrip("\n")]
    log(f"check {name}: first three columns of {n_reads:,} lines against "
        f"phase 4's TSV: {n_reads - len(cut):,} equal")
    if cut:
        r = cut[0]
        raise AssertionError(f"read {r}: {lines[r]!r} against {base[r]!r}")
    pick = list(range(0, n_reads, n_reads // 256))[:256]
    tax = Taxonomy(parse_nodes_dmp(nodes))
    exact = ExactClassifier(index, tax, cli_config(mode, True))
    t0 = time.perf_counter()
    want = [format_output_line(*exact.classify_read(*reads[r]), True)
            for r in pick]
    diff = [r for r, w in zip(pick, want) if lines[r] != w]
    log(f"check {name}: {len(pick)} sampled lines against ExactClassifier "
        f"(verbose): {len(pick) - len(diff)} equal "
        f"({sum(w.startswith('C') for w in want)} classified; "
        f"{time.perf_counter() - t0:.1f} s)")
    if diff:
        r = diff[0]
        raise AssertionError(f"read {r}: {lines[r]!r} != {want[pick.index(r)]!r}")

    if text:
        engine = greedy_fast if mode == "greedy" else mem_fast
        Pipeline = (greedy_fast.GreedyFastPipeline if mode == "greedy"
                    else mem_fast.MemFastPipeline)
        batches = [reads[i:i + BATCH] for i in range(0, n_reads, BATCH)]

        def one_pass(traced: bool):
            pipe = Pipeline(index, tax, cli_config(mode, True),
                            kmer_cache_dir=index.source_dir)
            pipe.classify_batch(reads[-BATCH:])
            torch.cuda.synchronize()
            engine.reset_counts()
            trace = (profile(activities=[ProfilerActivity.CUDA]) if traced
                     else contextlib.nullcontext())
            with trace as prof:
                t0 = time.perf_counter()
                n = sum(len(r) for r in pipe.classify_stream(batches))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            return n, wall, prof

        n, wall, _p = one_pass(False)
        host = dict(engine.HOST_SECONDS)
        log(f"steady {name}: {n:,} reads in {wall:.3f} s = {n / wall:.1f} "
            f"reads/s untraced; without -v {base_rate:.1f} reads/s "
            f"(phase 4b): -v costs {base_rate * wall / n:.2f}x the time")
        host["other"] = wall - sum(host.values())
        log(f"steady {name}: host seconds " + ", ".join(
            f"{k} {v:.3f} ({v / wall:.1%})" for k, v in host.items()))
        _n, wall_t, prof = one_pass(True)
        log_device_time(name, prof, wall_t, top=6)
    return {k: launches[k] for k in REPLACES}


def check_tie_overflow(nodes, seed: int):
    """A small index of nine 12-letter peptides P1..P9 (and random
    proteins), and reads whose fragment is P1 W P2 W .. P9: nine ties of
    the longest length, more than TIE_CAP, so MEM -v recomputes the
    fragment's map through J.  J must launch, equal its plain version on
    the inputs of every call the run made, and every TSV line equal
    ExactClassifier's.  Returns (the launch counts of the run, J's
    max_abs_err)."""
    import numpy as np

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.engine import mem_fast
    from kaiju_tpu_torch.engine.core import ExactClassifier, format_output_line
    from kaiju_tpu_torch.index import native_builder
    from kaiju_tpu_torch.index.core import KaijuIndex
    from kaiju_tpu_torch.io.taxonomy import Taxonomy, parse_nodes_dmp
    from kaiju_tpu_torch.ops import device_index
    from kaiju_tpu_torch.tools import kaiju, readgen

    rng = np.random.default_rng(seed + 2)
    aa = np.frombuffer(AA.replace("W", "").encode(), dtype=np.uint8)
    peps = [rng.choice(aa, 12).tobytes().decode() for _ in range(9)]
    records = [(f"PEP{i}.1_{100 + i}", p) for i, p in enumerate(peps)]
    records += [(f"RND{i}.1_150", rng.choice(aa, 300).tobytes().decode())
                for i in range(40)]
    work = os.path.join(ROOT, "build", "chip_smoke", "tie")
    ktx = os.path.join(work, "tie.ktx")
    os.makedirs(work, exist_ok=True)
    native_builder.build_index(records).save(ktx)
    index = KaijuIndex.load(ktx)
    prng = random.Random(seed + 3)
    reads = [(f"tie{t}", readgen.reverse_translate(prng, "W".join(peps)),
              None) for t in range(4)]
    reads += [(n, s, None) for n, s in readgen.make_reads(
        prng, records[9:], n=60)]
    fq = os.path.join(work, "reads.fastq")
    readgen.write_fastq([(n, s) for n, s, _ in reads], fq)
    out_tsv = os.path.join(work, "out_mem_v.tsv")
    calls = []
    real = mem_fast.extend_all

    def spy(*args):
        calls.append(args)
        return real(*args)

    mem_fast.extend_all = spy
    try:
        kernels.reset_counts()
        rc = kaiju.main(["-t", nodes, "-f", ktx, "-i", fq, "-a", "mem", "-v",
                         "-o", out_tsv])
        launches = dict(kernels.LAUNCHES)
    finally:
        mem_fast.extend_all = real
    if rc != 0:
        raise AssertionError(f"kaiju main -a mem -v returned {rc}")
    with open(out_tsv) as fh:
        got = fh.readlines()
    exact = ExactClassifier(index, Taxonomy(parse_nodes_dmp(nodes)),
                            cli_config("mem", True))
    want = [format_output_line(*exact.classify_batch([r])[0], True)
            for r in reads]
    same = sum(g == w for g, w in zip(got, want))
    ties = got[0].split("\t")[5].rstrip(",").split(",") if got else []
    log(f"e2e mem -v tie: {len(reads)} reads, {len(ties)} accessions on the "
        f"first line; launches {json.dumps(launches)}; {same} of "
        f"{len(want)} lines equal ExactClassifier's")
    if launches["extend_all"] <= 0 or not calls:
        raise AssertionError("J did not launch on the nine-tie read")
    err = max(max_abs_err(device_index.extend_all(*a),
                          device_index.extend_all_plain(*a)) for a in calls)
    log(f"kernel extend_all [tie]: max_abs_err {err} on the inputs of the "
        f"run's {len(calls)} call(s), codes "
        f"{[tuple(a[2].shape) for a in calls]}")
    if err:
        raise AssertionError("J differs from its plain version on the "
                             "nine-tie run's inputs")
    if len(got) != len(want) or same != len(want):
        raise AssertionError("the nine-tie TSV differs from ExactClassifier's")
    if len(ties) != 9:
        raise AssertionError(f"the nine-tie read matched {ties}")
    return {k: launches[k] for k in REPLACES}, err


# ---------------------------------------------------------------------------
# phase 4d: the taxonomy-free tools (BatchRunner) and kaiju-multi
# ---------------------------------------------------------------------------


def x_config(name: str):
    """The KaijuConfig that the tool of X_RUNS[name] makes from its flags."""
    from kaiju_tpu_torch.engine.config import KaijuConfig

    _tool, flags, kind, _n, _k = X_RUNS[name]
    mode = "mem" if "mem" in flags else "greedy"
    return KaijuConfig(mode=mode, use_Evalue=mode == "greedy",
                       verbose="-v" in flags, taxonomy_free=True,
                       input_is_protein=kind == "protein")


def x_kernel_checks(first, name):
    """Each kernel of BatchRunner against its plain version on the
    arguments of the wrapper's first call in the run `name` (the warm-up's
    first length group for J, the first round of the others): the
    measure() tuple by kernel name."""
    import torch

    from kaiju_tpu_torch.ops import device_index as dvi

    def rows_plain(rec, C, codes, start, s0, s1, act, touched=None):
        N, L = codes.shape
        base = torch.arange(N, dtype=torch.int32, device=codes.device) * L
        none = torch.full_like(base, -1)
        return dvi.extend_from_plain(rec, C, codes.reshape(-1), base, none,
                                     none, start, s0, s1, act, touched)

    out = {}
    if "extend_all" in first:
        a = first["extend_all"]
        F, L = a[2].shape
        touched = []
        want = dvi.extend_all_plain(*a, touched)
        out["extend_all"] = measure(
            dvi.extend_all(*a), want, lambda: dvi.extend_all(*a),
            lambda: dvi.extend_all_plain(*a), touched,
            F * L * (1 + 12) + 4 * F,
            f"{name}: the warm-up's first length group, [{F:,}, {L}] codes")
    if "extend_rows" in first:
        a = first["extend_rows"]
        N, L = a[2].shape
        got = dvi.extend_rows(*a)
        touched = []
        want = rows_plain(*a, touched)
        steps = int((a[3] - got[0]).sum())
        out["extend_from"] = measure(
            got, want, lambda: dvi.extend_rows(*a), lambda: rows_plain(*a),
            touched, N * (13 + 12) + steps + N,
            f"{name}: the first round's {N:,} ExtendFrom lanes as [{N:,}, "
            f"{L}] code rows, {steps:,} steps")
    if "update_si" in first:
        a = first["update_si"]
        n = a[2].shape[0]
        touched = []
        want = dvi.update_si_plain(*a, touched)
        out["update_si"] = measure(
            dvi.update_si(*a), want, lambda: dvi.update_si(*a),
            lambda: dvi.update_si_plain(*a), touched, n * (12 + 9),
            f"{name}: the first round's {n:,} probes, "
            f"{int((a[4] == a[3]).sum()):,} on empty intervals")
    if "sa_lookup" in first:
        a = first["sa_lookup"]
        n = a[-1].shape[0]
        touched = []
        want = dvi.sa_lookup_plain(*a, touched)
        out["sa_lookup"] = measure(
            dvi.sa_lookup(*a), want, lambda: dvi.sa_lookup(*a),
            lambda: dvi.sa_lookup_plain(*a), touched, n * (4 + 8 + 8),
            f"{name}: the first round's {n:,} SA positions")
    return out


def x_items(records, reads, seed: int, kind: str, n: int, work: str):
    """(the reads of a run as (name, seq, None), the file the tool reads):
    the first n DNA reads of phase 4, or n protein reads of readgen's
    make_protein_reads, parsed back from the FASTA as the tool parses
    them."""
    from kaiju_tpu_torch.io.fastx import read_reads
    from kaiju_tpu_torch.tools import readgen

    if kind == "dna":
        path = os.path.join(work, f"reads_{n}.fastq")
        if not os.path.exists(path):
            readgen.write_fastq([(nm, s) for nm, s, _ in reads[:n]], path)
        return reads[:n], path
    path = os.path.join(work, f"proteins_{n}.faa")
    readgen.write_reads_fasta(readgen.make_protein_reads(
        random.Random(seed + 4), records, n=n), path)
    return [(nm, s, None) for nm, s, _ in read_reads(path)], path


def run_taxfree(index, ktx, items, fq, name):
    """Run the tool of X_RUNS[name] through its main on db.ktx; fail
    unless every kernel of the path launched and no other did, unless
    every read went through BatchRunner, unless 256 sampled lines equal
    ExactClassifier's (taxonomy_free=True), and unless each kernel equals
    its plain version on the arguments of its first call.  Returns (the
    launch counts, the kernel measurements, the TSV path)."""
    import torch

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.engine import batch
    from kaiju_tpu_torch.engine.core import (ExactClassifier,
                                             format_output_line_x)
    from kaiju_tpu_torch.tools import kaijup, kaijux

    tool, flags, _kind, n, path_kernels = X_RUNS[name]
    main = (kaijux if tool == "kaijux" else kaijup).main
    out_tsv = os.path.join(os.path.dirname(ktx),
                           f"out_{name.replace(' ', '_')}.tsv")
    first = {}
    real = {w: getattr(batch, w) for w in X_WRAPPERS}

    def spy(w):
        def call(*args):
            first.setdefault(w, args)
            return real[w](*args)
        return call

    kernels.reset_counts()
    batch.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for w in real:
            setattr(batch, w, spy(w))
        rc = main(["-f", ktx, "-i", fq, *flags, "-o", out_tsv,
                   "-b", str(BATCH)])
        torch.cuda.synchronize()
    finally:
        for w in real:
            setattr(batch, w, real[w])
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    host, counts = dict(batch.HOST_SECONDS), dict(batch.COUNTS)
    if rc != 0:
        raise AssertionError(f"{tool} main {flags} returned {rc}")
    log(f"e2e {name}: flags {flags}: {n:,} reads in {dt:.2f} s = "
        f"{n / dt:.1f} reads/s with set-up; {counts['rounds']:,} rounds")
    log(f"e2e {name}: launches {json.dumps(launches)}")
    log(f"e2e {name}: host seconds " + ", ".join(
        f"{k} {v:.3f} ({v / dt:.1%})" for k, v in host.items()))
    if counts["reads"] != n:
        raise AssertionError(f"{name}: BatchRunner classified "
                             f"{counts['reads']} of {n} reads")
    idle = [k for k in path_kernels if launches[k] <= 0]
    stray = [k for k in REPLACES if k not in path_kernels and launches[k]]
    if idle or stray:
        raise AssertionError(f"{name}: kernels of the path that did not "
                             f"launch {idle}, others that did {stray}")

    with open(out_tsv) as fh:
        lines = fh.readlines()
    if len(lines) != n:
        raise AssertionError(f"{len(lines)} TSV lines for {n} reads")
    pick = list(range(0, n, n // 256))[:256]
    exact = ExactClassifier(index, None, x_config(name))
    t0 = time.perf_counter()
    want = [format_output_line_x(*exact.classify_read(*items[r]))
            for r in pick]
    diff = [r for r, w in zip(pick, want) if lines[r] != w]
    log(f"check {name}: {len(pick)} sampled lines against ExactClassifier "
        f"(taxonomy-free): {len(pick) - len(diff)} equal "
        f"({sum(w.startswith('C') for w in want)} classified; "
        f"{time.perf_counter() - t0:.1f} s)")
    if diff:
        r = diff[0]
        raise AssertionError(f"read {r}: {lines[r]!r} != {want[pick.index(r)]!r}")
    checks = x_kernel_checks(first, name)
    for k, (err, ms, plain_ms, bound_ms, note) in checks.items():
        log(f"kernel {k} [{name}]: max_abs_err {err}, {ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms) [{note}]")
    if any(v[0] for v in checks.values()):
        raise AssertionError(f"{name}: a kernel differs from its plain "
                             f"version on the run's inputs")
    return {k: launches[k] for k in REPLACES}, checks, out_tsv


def steady_taxfree(index, items, warm, name):
    """Classify the run's reads again on a new BatchRunner warmed by one
    batch of other reads, untraced for the steady rate, the host seconds
    of each stage and the extension-map cache's size, then under
    torch.profiler (card only) for the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kaiju_tpu_torch.engine import batch

    batches = [items[i:i + BATCH] for i in range(0, len(items), BATCH)]

    def one_pass(traced: bool):
        runner = batch.BatchRunner(index, None, x_config(name))
        runner.classify_batch(warm)
        torch.cuda.synchronize()
        batch.reset_counts()
        trace = (profile(activities=[ProfilerActivity.CUDA]) if traced
                 else contextlib.nullcontext())
        with trace as prof:
            t0 = time.perf_counter()
            n = sum(len(runner.classify_batch(b)) for b in batches)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return n, wall, prof, len(runner._ext_cache)

    n, wall, _p, cached = one_pass(False)
    host = dict(batch.HOST_SECONDS)
    host["other"] = wall - sum(host.values())
    log(f"steady {name}: {n:,} reads in {wall:.3f} s = {n / wall:.1f} "
        f"reads/s untraced, {batch.COUNTS['rounds']:,} rounds; extension-map "
        f"cache {cached:,} fragments after the warm batch and the run")
    log(f"steady {name}: host seconds " + ", ".join(
        f"{k} {v:.3f} ({v / wall:.1%})" for k, v in host.items()))
    _n, wall_t, prof, _c = one_pass(True)
    log_device_time(name, prof, wall_t, top=6)


def run_multi(ktx, nodes, reads, base_tsv):
    """kaiju_multi.main with the default flags on two samples, the first
    two batches of the reads, the seed tables built afresh: every kernel
    of the Greedy path must launch, each -o file must equal phase 4's
    lines of its reads (base_tsv, Greedy on the same index), and the
    stdout form their concatenation.  Returns the launch counts of the -o
    run."""
    import io

    import torch

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.tools import kaiju_multi, readgen

    work = os.path.dirname(ktx)
    ins = [os.path.join(work, f"sample{s}.fastq") for s in range(2)]
    outs = [os.path.join(work, f"out_multi{s}.tsv") for s in range(2)]
    for s, path in enumerate(ins):
        readgen.write_fastq([(n, q) for n, q, _ in
                             reads[s * BATCH:(s + 1) * BATCH]], path)
    with open(base_tsv) as fh:
        base = [next(fh) for _ in range(2 * BATCH)]
    argv = ["-t", nodes, "-f", ktx, "-i", ",".join(ins), "-b", str(BATCH)]
    shutil.rmtree(os.path.join(ktx, "kmer5"), ignore_errors=True)  # A runs
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = kaiju_multi.main(argv + ["-o", ",".join(outs)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"kaiju_multi main returned {rc}")
    idle = [k for k in PATHS["greedy"][0] if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kaiju-multi: {idle} did not launch")
    same = []
    for s, path in enumerate(outs):
        with open(path) as fh:
            same.append(fh.readlines() == base[s * BATCH:(s + 1) * BATCH])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc2 = kaiju_multi.main(argv)
    stdout_same = rc2 == 0 and buf.getvalue() == "".join(base)
    log(f"e2e kaiju-multi: 2 samples of {BATCH:,} reads in {dt:.2f} s with "
        f"set-up; launches {json.dumps(launches)}; -o files equal to phase "
        f"4's lines: {same}; stdout form equal to their concatenation: "
        f"{stdout_same}")
    if not all(same) or not stdout_same:
        raise AssertionError("kaiju-multi differs from phase 4's lines")
    return {k: launches[k] for k in REPLACES}


# ---------------------------------------------------------------------------
# phase 4e: the index-sharded paths
# ---------------------------------------------------------------------------


def kernels_of(mode: str, text: bool, sharded: bool) -> list:
    """The kernels a run of `mode` must launch: on a text index MEM adds
    G; sharded, each kernel that reads the index (SHARDED) in its sharded
    instantiation."""
    names = list(PATHS[mode][0])
    if text and mode == "mem":
        names.append("text_extend")
    return [n + "_sharded" if sharded and n in SHARDED else n for n in names]


def mesh_fastq(reads, ktx) -> str:
    """The first MESH_READS reads as a FASTQ beside the index at ktx."""
    from kaiju_tpu_torch.tools import readgen

    fq = os.path.join(os.path.dirname(ktx), f"reads_{MESH_READS}.fastq")
    if not os.path.exists(fq):
        readgen.write_fastq([(n, q) for n, q, _ in reads[:MESH_READS]], fq)
    return fq


def run_mesh(index, reads, ktx, nodes, tag, mode, n_shards, base_tsv,
             base_rate, warm):
    """kaiju --mesh-index n_shards on the path `mode` through
    tools.kaiju.main on the first MESH_READS reads (seed tables built
    afresh, on the shards): every sharded kernel of the path must launch,
    no unsharded kernel that reads the index, and the TSV must equal phase
    4's lines of the same reads and path (base_tsv) byte for byte.  Then a
    steady pass on a new sharded pipeline warmed by one batch of other
    reads, beside phase 4b's unsharded rate (base_rate).  Returns the
    launch counts."""
    import torch

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.engine import greedy, mem
    from kaiju_tpu_torch.io.taxonomy import Taxonomy, parse_nodes_dmp
    from kaiju_tpu_torch.parallel import sharded_fused
    from kaiju_tpu_torch.tools import kaiju

    engine = greedy if mode == "greedy" else mem
    Pipeline = (sharded_fused.ShardedGreedyPipeline if mode == "greedy"
                else sharded_fused.ShardedMemPipeline)
    name = f"{mode} --mesh-index {n_shards} {tag}"
    path = kernels_of(mode, index.text is not None, True)
    fq = mesh_fastq(reads, ktx)
    shutil.rmtree(os.path.join(ktx, "kmer5"), ignore_errors=True)
    out_tsv = os.path.join(os.path.dirname(ktx),
                           f"out_{mode}_mesh{n_shards}_{tag}.tsv")
    kernels.reset_counts()
    engine.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = kaiju.main(["-t", nodes, "-f", ktx, "-i", fq, *PATHS[mode][1],
                     "--mesh-index", str(n_shards), "-o", out_tsv,
                     "-b", str(BATCH)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"kaiju main {name} returned {rc}")
    log(f"e2e {name}: {MESH_READS:,} reads in {dt:.2f} s = "
        f"{MESH_READS / dt:.1f} reads/s with set-up; host replay "
        f"{engine.HOST_REPLAY['flagged']} reads; launches "
        f"{json.dumps(launches)}")
    idle = [k for k in path if launches[k] <= 0]
    unsharded = [k for k in SHARDED if launches[k]]
    stray = [k + "_sharded" for k in SHARDED
             if launches[k + "_sharded"] and k + "_sharded" not in path]
    if idle or unsharded or stray:
        raise AssertionError(f"{name}: kernels of the path that did not "
                             f"launch {idle}, unsharded kernels that did "
                             f"{unsharded}, others {stray}")
    with open(out_tsv) as fh:
        got = fh.readlines()
    with open(base_tsv) as fh:
        want = [next(fh) for _ in range(MESH_READS)]
    same = sum(g == w for g, w in zip(got, want))
    log(f"check {name}: {same:,} of {MESH_READS:,} lines equal phase 4's "
        f"unsharded {mode} lines ({sum(w.startswith('C') for w in want):,} "
        "classified)")
    if len(got) != MESH_READS or same != MESH_READS:
        raise AssertionError(f"{name}: the TSV differs from phase 4's")

    tax = Taxonomy(parse_nodes_dmp(nodes))
    pipe = Pipeline(index, tax, cli_config(mode), n_shards,
                    kmer_cache_dir=index.source_dir)
    pipe.classify_batch(warm)
    torch.cuda.synchronize()
    engine.reset_counts()
    batches = [reads[i:i + BATCH] for i in range(0, MESH_READS, BATCH)]
    t0 = time.perf_counter()
    n = sum(len(r) for r in pipe.classify_stream(batches))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = dict(engine.HOST_SECONDS)
    host["other"] = wall - sum(host.values())
    log(f"steady {name}: {n:,} reads in {wall:.3f} s = {n / wall:.1f} "
        f"reads/s untraced; unsharded {base_rate:.1f} reads/s (phase 4b, "
        "65,536 reads); host seconds " + ", ".join(
            f"{k} {v:.3f} ({v / wall:.1%})" for k, v in host.items())
        + f"; replayed {engine.HOST_REPLAY['flagged']} reads")
    del pipe
    torch.cuda.empty_cache()
    return {k: launches[k] for k in REPLACES}


def run_sharded_primitives(index, reads, n_shards):
    """The sharded primitives of item 10a, which no CLI path reaches yet
    (--mesh-index with -v or a taxonomy-free tool raises): on the index in
    n_shards shards, sharded_extend_all (J) over the fragments of the first
    MEM batch as a padded code matrix, then sharded_sa_lookup (H) on the
    first SA position of every lane's match.  Counts from 0; then each
    output must equal the unsharded kernel's.  Returns the launch counts."""
    import numpy as np
    import torch

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.engine.fragments_native import NativeFragmenter2
    from kaiju_tpu_torch.engine.mem import MemPipeline
    from kaiju_tpu_torch.engine.pipeline import _bucket
    from kaiju_tpu_torch.ops import device_index
    from kaiju_tpu_torch.parallel.sharded_index import (ShardedIndex,
                                                        sharded_extend_all,
                                                        sharded_sa_lookup)

    cuda = torch.device("cuda")
    frag = NativeFragmenter2("mem", 11, 65, True, False)
    flat, chars, off, nf, _k, _rf, _o = frag.run(reads[:BATCH],
                                                 MemPipeline.S_SLOTS, _bucket)
    flen = np.diff(off[:nf + 1]).astype(np.int32)
    codes = np.zeros((nf, int(flen.max())), dtype=np.uint8)
    for t in range(nf):
        codes[t, :flen[t]] = flat[off[t]:off[t + 1]]
    codes = torch.from_numpy(codes).to(cuda)
    flen = torch.from_numpy(flen).to(cuda)
    sh = ShardedIndex(index, n_shards, cuda)
    kernels.reset_counts()
    maps = sharded_extend_all(sh, codes, flen)
    k = maps[1][maps[2] > maps[1]]
    walks = sharded_sa_lookup(sh, k)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    dv = device_index.DeviceIndex(index, cuda)
    err = max(max_abs_err(maps, device_index.extend_all(dv.rec, dv.C, codes,
                                                        flen)),
              max_abs_err(walks, device_index.sa_lookup(
                  dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.nseq, dv.chpt_exp,
                  k)))
    counts = {n: launches[n] for n in ("extend_all_sharded",
                                       "sa_lookup_sharded")}
    log(f"e2e sharded primitives, {n_shards} shards: J over [{nf:,}, "
        f"{codes.shape[1]}] codes, H on {k.shape[0]:,} SA positions; "
        f"max_abs_err {err} against the unsharded kernels; launches "
        f"{json.dumps(counts)}")
    if err:
        raise AssertionError("a sharded primitive differs from the unsharded "
                             "kernel")
    if not (launches["extend_all_sharded"] and launches["sa_lookup_sharded"]):
        raise AssertionError("the sharded primitives did not launch J and H")
    del sh, dv
    torch.cuda.empty_cache()
    return {n: launches[n] for n in REPLACES}


# ---------------------------------------------------------------------------
# phase 4f: many processes on one card
# ---------------------------------------------------------------------------


def spy_first_calls(mode: str) -> dict:
    """Wrap the kernel wrappers of the path `mode` where its pipeline
    looks them up (A where the seed tables are built), so that each keeps
    the arguments of its first call: {kernel: (wrapper, plain version,
    args, kwargs)}, filled as the run goes."""
    from kaiju_tpu_torch.ops import (classify, device_index, greedy, hybrid,
                                     kmer, search)

    where = {"update_si": (kmer, device_index.update_si_plain)}
    if mode == "mem":
        where.update(mem_extend=(classify, search.mem_extend_plain),
                     text_extend=(classify, hybrid.text_extend_plain),
                     mem_stats=(classify, search.mem_stats_plain),
                     read_lca=(classify, classify.read_lca_plain))
    else:
        where.update(mem_extend=(greedy, search.mem_extend_plain),
                     greedy_search=(greedy, greedy.greedy_search_plain),
                     ranges_lca=(greedy, classify.ranges_lca_plain))
    first = {}
    for name, (mod, plain) in where.items():
        def wrap(*args, _fn=getattr(mod, name), _name=name, _plain=plain,
                 **kw):
            first.setdefault(_name, (_fn, _plain, args, kw))
            return _fn(*args, **kw)

        setattr(mod, name, wrap)
    return first


def check_first_calls(first: dict, dev) -> dict:
    """Each kernel of `first` (spy_first_calls) on the arguments of its
    first call, whose Shards hold the shards mapped from the peer process:
    launched again, it must equal its plain version on the same Shards (on
    copies made here of the shards that lie on another card, which the
    plain versions refuse) and its launch on a Shards of copies of every
    shard in this process's own memory; both launches timed.  Returns
    {kernel: {"err", "ms" (mapped shards), "ms_local" (own copies),
    "opened" (shards mapped)}}."""
    import torch

    from kaiju_tpu_torch.ops.device_index import Shards

    out = {}
    for name, (fn, plain, args, kw) in first.items():
        found = {}

        def swap(x):
            if isinstance(x, Shards):
                if id(x) not in found:
                    found[id(x)] = (x, Shards(
                        [p.to(dev, copy=True) for p in x.parts], x.per,
                        x.shape[0], dev))
                return found[id(x)][1]
            if isinstance(x, tuple):
                return tuple(swap(v) for v in x)
            return x

        largs = swap(args)
        lkw = {k: swap(v) for k, v in kw.items()}
        got = fn(*args, **kw)
        here = all(p.device == dev for sh, _c in found.values()
                   for p in sh.parts)
        want = plain(*args, **kw) if here else plain(*largs, **lkw)
        err = max(max_abs_err(got, want),
                  max_abs_err(got, fn(*largs, **lkw)))
        out[name + "_sharded" if name in SHARDED else name] = {
            "err": err, "ms": cuda_ms(lambda: fn(*args, **kw)),
            "ms_local": cuda_ms(lambda: fn(*largs, **lkw)),
            "opened": max((len(sh.opened) for sh, _c in found.values()),
                          default=0)}
        del found, largs, lkw
        torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def kaiju_worker(counts_path: str, argv: list) -> int:
    """One process of a phase 4f run: tools.kaiju.main(argv) on this
    process's card (the --dist-* flags in argv).  Right after set-up (the
    runner made) every process waits for the others and reads the card's
    used memory; with --mesh-index it reports the shards it holds and maps
    (ShardedIndex.layout), and process 0 keeps the arguments of each
    kernel's first call, which it checks after main() (check_first_calls),
    while the mapped shards are still open: they are released when the
    process leaves its group, at exit.  Writes its exit code, card, launch
    counts (main()'s only), seconds, memory, layout and checks to
    counts_path as JSON."""
    import torch
    import torch.distributed as dist

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.tools import kaiju

    mesh = "--mesh-index" in argv
    pid = int(argv[argv.index("--dist-pid") + 1])
    first = (spy_first_calls("mem" if "mem" in argv else "greedy")
             if mesh and pid == 0 else {})
    info = {}
    make_runner = kaiju.make_runner

    def keep(*args, **kw):
        info["runner"] = runner = make_runner(*args, **kw)
        torch.cuda.synchronize()
        dist.barrier()  # every process set up
        free, total = torch.cuda.mem_get_info()
        info["card_used"] = total - free
        info["allocated"] = torch.cuda.memory_allocated()
        return runner

    kaiju.make_runner = keep
    kernels.reset_counts()
    t0 = time.perf_counter()
    rc = kaiju.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)  # before the checks' launches
    runner = info.pop("runner")
    if mesh:
        info["layout"] = runner.pipe.dev.layout()
    info["checks"] = check_first_calls(first, runner.pipe.device)
    with open(counts_path, "w") as fh:
        json.dump({"rc": rc, "device": str(torch.cuda.current_device()),
                   "launches": launches, "seconds": seconds, **info}, fh)
    return rc


def fresh_cache(ktx: str, path: str) -> str:
    """A cache directory at path with the index's Bloom bitmaps and no seed
    tables, so that a run builds its tables (kernel A) without racing
    another process for the index's own cache."""
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    for f in os.listdir(ktx):
        if f.startswith("bloom_"):
            os.symlink(os.path.join(ktx, f), os.path.join(path, f))
    return path


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def held_by_rule(p: int, nprocs: int, n_shards: int) -> list:
    """The shards process p of nprocs must hold: p mod S for N >= S (one
    card a process, index axis innermost, as kaiju_tpu's mesh), the
    shards o with o mod N = p for N < S."""
    if nprocs >= n_shards:
        return [p % n_shards]
    return [o for o in range(n_shards) if o % nprocs == p]


def run_processes(index, reads, ktx, nodes, mode, n_shards, base_tsv):
    """tools.kaiju.main on the path `mode` (with --mesh-index n_shards if
    given) as NPROCS processes (--dist-nprocs, a coordinator on 127.0.0.1,
    --dist-pid p, each with its own -o and seed-table cache), process p on
    cuda:{p % cards}, on the first MESH_READS reads: each process must
    launch every kernel of its path on its card, each read must be in
    exactly one output, the one its batch share names, and the lines
    merged by read must equal phase 4's lines (base_tsv).  With
    --mesh-index each process must hold exactly the shards of
    held_by_rule and map every other one from process o mod N, and each
    kernel of the path must equal its plain version on process 0's first
    call, on the mapped shards (check_first_calls).  Then the one-process
    main() of the same reads, timed beside the processes' wall.  Returns
    the launch counts of all the processes and each process's report."""
    import torch

    from kaiju_tpu_torch.parallel.multihost import local_rows
    from kaiju_tpu_torch.tools import kaiju

    work = os.path.dirname(ktx)
    mesh = ["--mesh-index", str(n_shards)] if n_shards else []
    name = f"{mode}{' --mesh-index %d' % n_shards if n_shards else ''}"
    fq = mesh_fastq(reads, ktx)
    argv = ["-t", nodes, "-f", ktx, "-i", fq, *PATHS[mode][1], *mesh,
            "-b", str(BATCH)]
    coord = f"127.0.0.1:{free_port()}"
    outs, counts, logs, procs = [], [], [], []
    tag = f"{mode}_mesh{n_shards}"
    gc.collect()  # this process's cached card memory, out of the readings
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        for p in range(NPROCS):
            outs.append(os.path.join(work, f"out_procs_{tag}_p{p}.tsv"))
            counts.append(os.path.join(work, f"counts_{tag}_p{p}.json"))
            logs.append(open(os.path.join(work, f"log_{tag}_p{p}.txt"), "w"))
            env = dict(os.environ, KAIJU_TPU_CACHE=fresh_cache(
                ktx, os.path.join(work, f"cache_{tag}_p{p}")))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--kaiju-worker",
                 counts[p], *argv, "-o", outs[p], "--dist-nprocs",
                 str(NPROCS), "--dist-coordinator", coord, "--dist-pid",
                 str(p)], env=env, stdout=logs[p], stderr=subprocess.STDOUT))
        rcs = [proc.wait(timeout=300) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for fh in logs:
            fh.close()
    wall = time.perf_counter() - t0
    if any(rcs):
        for p, fh in enumerate(logs):
            with open(fh.name) as f:
                log(f"process {p} ({rcs[p]}): " + f.read()[-3000:])
        raise AssertionError(f"{name} x{NPROCS}: exit codes {rcs}")
    path = kernels_of(mode, index.text is not None, bool(n_shards))
    cards = torch.cuda.device_count()
    launches = {k: 0 for k in REPLACES}
    reports = []
    for p, cpath in enumerate(counts):
        with open(cpath) as fh:
            got = json.load(fh)
        reports.append(got)
        idle = [k for k in path if got["launches"][k] <= 0]
        stray = [k for k in REPLACES if k not in path and got["launches"][k]]
        log(f"e2e {name} process {p} of {NPROCS}: cuda:{got['device']}, "
            f"{got['seconds']:.2f} s in main(); card memory used after "
            f"set-up {got['card_used']:,} bytes (this process's caching "
            f"allocator {got['allocated']:,}); launches "
            f"{json.dumps(got['launches'])}")
        if idle or stray or got["device"] != str(p % cards):
            raise AssertionError(f"{name} process {p}: kernels that did not "
                                 f"launch {idle}, others {stray}, card "
                                 f"{got['device']}")
        for k in launches:
            launches[k] += got["launches"][k]
        if not n_shards:
            continue
        lay = got["layout"]
        log(f"memory {name} process {p}: caching allocator "
            f"{got['allocated']:,} bytes + held shards "
            f"{sum(lay['bytes_held'].values()):,} bytes outside it")
        want = held_by_rule(p, NPROCS, n_shards)
        opened = {int(o): q for o, q in lay["opened"].items()}
        log(f"shards {name} process {p}: holds {lay['held']} "
            f"({json.dumps(lay['bytes_held'])} bytes), maps "
            + ", ".join(f"{o} from process {q}" for o, q in opened.items())
            + f" ({json.dumps(lay['bytes_opened'])} bytes)")
        if lay["held"] != want or opened != {
                o: o % NPROCS for o in range(n_shards) if o not in want}:
            raise AssertionError(f"{name} process {p}: holds {lay['held']} "
                                 f"and maps {opened}, the rule gives {want}")
        for k, c in got["checks"].items():
            log(f"kernel {k} [{name}, process {p}, {c['opened']} of "
                f"{n_shards} shards mapped from the peer]: max_abs_err "
                f"{c['err']} against its plain version and its launch on "
                f"copies in this process; {c['ms']:.4f} ms on the mapped "
                f"shards, {c['ms_local']:.4f} ms on the copies "
                f"({c['ms'] / c['ms_local'] - 1:+.1%})")
        unchecked = [k for k in path if p == 0 and k not in got["checks"]]
        if unchecked or any(c["err"] for c in got["checks"].values()):
            raise AssertionError(f"{name} process {p}: kernels unchecked "
                                 f"{unchecked} or differing from their plain "
                                 "versions on the mapped shards")
    if n_shards:
        held = sum(sum(r["layout"]["bytes_held"].values()) for r in reports)
        lay = reports[0]["layout"]
        whole = sum(lay["bytes_held"].values()) + sum(
            lay["bytes_opened"].values())
        log(f"shards {name} x{NPROCS}: the index shards (rec, SA samples, "
            f"text) take {held:,} bytes of card memory held apart, against "
            f"{NPROCS * whole:,} as {NPROCS} whole copies (every process "
            "holding all the shards)")

    names = [n for n, _q, _r in reads[:MESH_READS]]
    owner = {}
    for b0 in range(0, MESH_READS, BATCH):
        for p in range(NPROCS):
            lo, hi = local_rows(min(BATCH, MESH_READS - b0), NPROCS, p)
            owner.update((names[r], p) for r in range(b0 + lo, b0 + hi))
    lines = {}
    for p, out in enumerate(outs):
        with open(out) as fh:
            for ln in fh:
                n = ln.split("\t")[1]
                if n in lines or owner.get(n) != p:
                    raise AssertionError(f"{name}: read {n} twice or in "
                                         f"process {p}'s output")
                lines[n] = ln
    with open(base_tsv) as fh:
        want = [next(fh) for _ in range(MESH_READS)]
    same = sum(lines.get(n) == w for n, w in zip(names, want))

    fq_cache = fresh_cache(ktx, os.path.join(work, f"cache_{tag}_one"))
    os.environ["KAIJU_TPU_CACHE"] = fq_cache
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rc = kaiju.main(argv + ["-o", os.path.join(work, f"out_one_{tag}.tsv")])
        torch.cuda.synchronize()
        one = time.perf_counter() - t1
    finally:
        del os.environ["KAIJU_TPU_CACHE"]
    log(f"e2e {name} x{NPROCS} on cuda:" + ",".join(
        sorted({r["device"] for r in reports})) + f": {MESH_READS:,} reads, "
        f"{len(lines):,} written once each, {same:,} equal to phase 4's "
        f"lines; wall {wall:.2f} s for the processes (start-up, index load, "
        f"seed tables and classification) against {one:.2f} s for the "
        "one-process main() in this process")
    if rc != 0 or len(lines) != MESH_READS or same != MESH_READS:
        raise AssertionError(f"{name} x{NPROCS}: the merged lines differ "
                             "from phase 4's")
    return launches, reports


def run_phase_4f(index, reads, ktx, nodes, tsvs) -> dict:
    """Phase 4f: run_processes for each of PROC_RUNS on the text index
    (ktx), held against phase 4's lines tsvs[mode]["text"]; prints the
    cards used and the card memory after set-up.  Returns the launch
    counts of all the runs."""
    import torch

    cards = torch.cuda.device_count()
    log(f"4f: process p on cuda:{{p % {cards}}}: " + (
        "each process maps its peer's shards over NVLink from another card"
        if cards > 1 else "one card, so the processes map each other's "
        "shards on cuda:0; the cross-card form (over NVLink) was not run"))
    launches = {k: 0 for k in REPLACES}
    used = {}
    for n_shards, mode in PROC_RUNS:
        counts, reports = run_processes(index, reads, ktx, nodes, mode,
                                        n_shards, tsvs[mode]["text"])
        for k, c in counts.items():
            launches[k] += c
        used[mode, n_shards] = max(r["card_used"] for r in reports)
    log("4f: card memory used after set-up, the larger of the processes' "
        "readings: " + "; ".join(
            f"{mode} {'--mesh-index %d' % n if n else 'one index'} "
            f"{b:,} bytes" for (mode, n), b in used.items()))
    return launches


# ---------------------------------------------------------------------------
# phase 4g: the index above 2^31 letters (K17)
# ---------------------------------------------------------------------------


def big_checks(ix, reads, smi):
    """L and M against their plain versions on the card on the 1,024
    demo reads (65,536 lanes): {name: measure() tuple}; on an index past
    2^31 + 10^6 letters also asserts that a lane's interval starts at 2^31
    or later."""
    import torch

    from kaiju_tpu_torch.ops import big_mem

    codes = torch.from_numpy(reads).cuda()
    R, L = codes.shape
    got = big_mem.big_extend_all(ix, codes)
    touched = []
    want = big_mem.big_extend_all_plain(ix, codes, touched)
    out = {"big_extend_all": measure(
        got, want, lambda: big_mem.big_extend_all(ix, codes),
        lambda: big_mem.big_extend_all_plain(ix, codes), touched,
        R * L * (1 + 4 + 8 + 8), f"[{R}, {L}] lanes")}
    i, s0, s1 = got
    kf = torch.where(s1 > s0, s0, -1).reshape(-1)
    ids = big_mem.big_sa_walk(ix, kf)
    touched, slots = [], []
    want_ids = big_mem.big_sa_walk_plain(ix, kf, touched, slots)
    walked = int((kf >= 0).sum())
    n_slots = int(torch.unique(torch.cat(slots)).numel()) if slots else 0
    out["big_sa_walk"] = measure(
        ids, want_ids, lambda: big_mem.big_sa_walk(ix, kf),
        lambda: big_mem.big_sa_walk_plain(ix, kf), touched,
        kf.numel() * 16 + 4 * n_slots,
        f"{walked:,} walks of {kf.numel():,} lanes, {n_slots:,} samples")
    big = int((s0 >= 1 << 31).sum())
    log(f"4g: {big:,} of {s0.numel():,} lanes have s0 >= 2^31; largest s1 "
        f"{int(s1.max()):,}, largest id {int(ids.max()):,} [{smi}]")
    if not big and ix.N > (1 << 31) + 1_000_000:
        raise AssertionError("4g: no interval starts at 2^31 or later")
    return out


def steady_big(ix, db, smi) -> None:
    """A steady step over READS reads of the demo's length: big_mem_step's
    reads/s (host clock, synchronised), L's and M's ms (CUDA events), the
    host statistics' seconds."""
    import torch

    from kaiju_tpu_torch.ops import big_mem
    from kaiju_tpu_torch.tools import big_classify

    reads, _truth = big_classify.make_reads(db, READS, BIG_LEN, seed=8)
    codes = torch.from_numpy(reads).cuda()
    big_mem.big_mem_step(ix, codes)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step = big_mem.big_mem_step(ix, codes)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    i, s0, s1, _ids = step
    kf = torch.where(s1 > s0, s0, -1).reshape(-1)
    l_ms = cuda_ms(lambda: big_mem.big_extend_all(ix, codes), reps=5)
    m_ms = cuda_ms(lambda: big_mem.big_sa_walk(ix, kf), reps=5)
    arrays = tuple(a.cpu().numpy() for a in step)
    t0 = time.perf_counter()
    _res, n_cls = big_classify.host_stats(reads, *arrays,
                                          ix.seq_tax.cpu().numpy())
    host_s = time.perf_counter() - t0
    log(f"4g steady: {READS:,} reads of {BIG_LEN}: big_mem_step "
        f"{step_s:.4f} s = {READS / step_s:,.1f} reads/s (L {l_ms:.3f} ms, "
        f"M {m_ms:.3f} ms, {int((kf >= 0).sum()):,} walks); host "
        f"statistics {host_s:.2f} s; with them {READS / (step_s + host_s):,.1f}"
        f" reads/s; {n_cls:,} classified [{smi}]")


def start_big_build(letters: int) -> dict:
    """Phase 4g's DB build (parallel.big_index.build_db on every host
    thread) started in a thread of its own, so that it runs beside phases
    4c-4f: the builder releases the GIL.  Returns the box that
    receives "db" or "error", and "seconds", and holds the "thread"."""
    import threading

    from kaiju_tpu_torch.parallel.big_index import build_db

    box = {"threads": os.cpu_count() or 1}

    def work():
        t0 = time.perf_counter()
        try:
            box["db"] = build_db(None, letters, box["threads"], BIG_SEED,
                                 letters <= (1 << 31) + 1_000_000)
        except Exception as exc:  # re-raised by run_phase_4g
            box["error"] = exc
        box["seconds"] = time.perf_counter() - t0

    box["thread"] = threading.Thread(target=work, name="big-build",
                                     daemon=True)
    box["thread"].start()
    return box


def run_phase_4g(build: dict, smi: str):
    """Phase 4g: the big DB of `build` (start_big_build's box; waits for
    it), then tools.big_classify.run at S = 2 and 8 on the demo's reads
    (each counted from 0), L and M against their plain versions, S = 8
    against S = 2, the oracle on the sampled reads, a steady step.
    Returns (measure() tuples, launch counts)."""
    import gc

    import numpy as np
    import torch

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.parallel.big_index import peak_rss_gb
    from kaiju_tpu_torch.tools import big_classify

    work = os.path.join(ROOT, "build", "chip_smoke", "big")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    build["thread"].join()
    if "error" in build:
        raise build["error"]
    db, threads = build.pop("db"), build["threads"]
    log(f"4g: built N = {db['N']:,} ({db['N'] / 2**31:.4f} x 2^31), "
        f"{db['nseq']:,} sequences, e = {db['e']} in {build['seconds']:.1f}"
        f" s on {threads} threads beside phases 4c-4f (waited "
        f"{time.perf_counter() - t0:.1f} s for it here), host peak RSS "
        f"{peak_rss_gb():.1f} GB")
    launches = {k: 0 for k in BIG_KERNELS}
    rows, arrays = {}, {}
    for S in BIG_SHARDS:
        out = os.path.join(work, f"s{S}")
        args = big_classify.parse_args([
            "--letters", str(db["N"] - db["nseq"]), "--threads", str(threads),
            "--shards", str(S), "--reads", str(BIG_READS),
            "--read-len", str(BIG_LEN), "--out", out,
            "--verify", str(BIG_VERIFY if S == BIG_SHARDS[0] else 0)])
        kernels.reset_counts()
        res = big_classify.run(args, db=db)
        counts = {k: kernels.LAUNCHES[k] for k in BIG_KERNELS}
        for k, c in counts.items():
            launches[k] += c
        if not all(counts.values()):
            raise AssertionError(f"4g S = {S}: a kernel did not launch: "
                                 f"{counts}")
        ix, secs = res["index"], res["seconds"]
        log(f"4g S = {S}: {res['summary']}; save {secs['save']:.1f} s, "
            f"load {secs['load']:.1f} s, {sum(ix.nbytes.values()):,} card "
            f"bytes ({ix.nbytes}), first step {secs['first_step']:.2f} s, "
            f"steady step {secs['step']:.4f} s, host statistics "
            f"{secs['host_stats']:.2f} s; launches {counts}; host peak RSS "
            f"{peak_rss_gb():.1f} GB [{smi}]")
        arrays[S] = res["step"]
        if S == BIG_SHARDS[0]:
            if res["summary"]["verified"] != BIG_VERIFY:
                raise AssertionError("4g: the oracle checked too few reads")
            rows = big_checks(ix, res["reads"], smi)
            steady_big(ix, db, smi)
        else:
            same = all(np.array_equal(a, b) for a, b in
                       zip(arrays[S], arrays[BIG_SHARDS[0]]))
            log(f"4g: S = {S} {'equals' if same else 'DIFFERS FROM'} "
                f"S = {BIG_SHARDS[0]} on all four arrays")
            if not same:
                raise AssertionError(f"4g: S = {S} differs")
        del res, ix
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(out, ignore_errors=True)
    return rows, launches


def log_checks(checks: dict, tag: str) -> None:
    for name, (err, ms, plain_ms, bound_ms, note) in checks.items():
        log(f"kernel {name} [{tag}]: max_abs_err {err}, {ms:.4f} ms "
            f"(plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms) [{note}]")


def check_repeats(seed: int, lat_ns: float) -> dict:
    """Phase 3 on the DB with repeats (make_repeats_db), one batch of 4,096
    of its reads: B on the MEM batch (screened, the hybrid's narrow lanes
    stopping, on the text index; unscreened and not stopping on db.ktx)
    and on the Greedy batch, and E at -e 3 (its last level's hybrid on the
    text index, none on db.ktx), against their plain versions.  Returns
    {index tag: check_kernels' dict}."""
    from kaiju_tpu_torch.index.core import KaijuIndex

    records, ktx = make_repeats_db(seed)
    reads = make_reads(seed, records, BATCH)
    out = {}
    for tag in ("fmi", "text"):
        out[tag], _inputs = check_kernels(KaijuIndex.load(ktx[tag]), reads,
                                          ktx[tag], lat_ns, full=False)
        log_checks(out[tag], f"repeats, {tag}")
    return out


def latency(smi: str) -> float:
    """Logs the card's dependent-load latency in the L2 (a 16 MiB cycle,
    walked twice) and in device memory (a 256 MiB cycle, on addresses not
    walked before); returns the L2's, in ns."""
    from kaiju_tpu_torch import kernels

    l2 = kernels.chase_ns(1 << 22, cached=True)
    dram = kernels.chase_ns(1 << 26, cached=False)
    log(f"latency: {l2:.1f} ns a dependent load in the L2, {dram:.1f} ns "
        f"in device memory (csrc/chase.cu; {smi})")
    return l2


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
    log(f"build: nvcc built {len(kernels.SOURCES)} kernel libraries "
        f"({len(kernels.LAUNCHES)} kernels) in {secs:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    lat_ns = latency(smi)

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

    if args.only_processes:  # phase 4f and the lines it is held against
        tsvs = {mode: {"text": run_cli(indexes["text"], reads, ktx["text"],
                                       nodes, fq, mode, "text")[1]}
                for mode in PATHS}
        run_phase_4f(indexes["text"], reads, ktx["text"], nodes, tsvs)
        log("--only-processes: phases 1, 2, 4 on db_text.ktx and 4f passed; "
            "no kernels line")
        return 0

    # ---- 3. kernels against their plain versions -----------------------
    checks = {}
    for tag in ("fmi", "text"):
        checks[tag], inputs = check_kernels(indexes[tag], reads, ktx[tag],
                                            lat_ns)
        v_checks, v_inputs = check_verbose_kernels(indexes[tag], nodes,
                                                   reads, ktx[tag])
        checks[tag].update(v_checks)
        inputs.update(v_inputs)
        log_checks(checks[tag], tag)
        # the sharded instantiations on the same inputs; the line carries
        # the text index's measurements at the most shards
        for n_shards in MESH:
            sharded = check_sharded(indexes[tag], inputs, n_shards,
                                    timed=tag == "text")
            for name, v in sharded.items():
                log(f"kernel {name} [{tag}, {n_shards} shards]: max_abs_err "
                    f"{v[0]} against the unsharded kernel"
                    + (f" and its plain version; {v[1]:.4f} ms (plain "
                       f"{v[2]:.3f} ms, bound {v[3]:.4f} ms) [{v[4]}]"
                       if len(v) > 1 else ""))
                err = max(v[0], checks[tag].get(name, (0,))[0])
                checks[tag][name] = (err, *(v[1:] if len(v) > 1 else
                                            checks[tag].get(name, (0,))[1:]))
        del inputs
    # B and E on the DB with repeats; their errors join the line's
    for tag, rc in check_repeats(args.seed, lat_ns).items():
        checks["repeats " + tag] = rc
        for name in ("mem_extend", "greedy_search"):
            err, *rest = checks["text"][name]
            checks["text"][name] = (max(err, rc[name][0]), *rest)
    bad = [(t, n) for t, c in checks.items() for n, v in c.items() if v[0]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    gathers, g_launches = check_gather(args.seed)
    if any(v[0] for v in gathers.values()):
        raise AssertionError("P1 or P2 differs from its plain version")

    # ---- 4. end to end through the CLI, each run counted from 0 --------
    launches = {name: 0 for name in REPLACES}
    tsvs = {}
    for mode in PATHS:
        tsv = tsvs[mode] = {}
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
    rates = {}
    for tag in ("text", "fmi"):
        for mode in PATHS:
            rates[mode, tag] = steady_stream(indexes[tag], nodes, reads, warm,
                                             mode, tag)

    # phase 4g's DB builds from here on, beside phases 4c-4f, whose host
    # stages it slows; the steady rates above ran alone
    big_build = start_big_build(BIG_LETTERS)

    # ---- 4c. the verbose paths, each run counted from 0 ----------------
    for mode in VERBOSE_PATHS:
        for tag, n_reads in (("text", V_READS), ("fmi", BATCH)):
            counts = run_verbose_cli(indexes[tag], reads, ktx[tag], nodes,
                                     mode, tag, n_reads, tsvs[mode][tag],
                                     rates[mode, tag])
            for name, n in counts.items():
                launches[name] += n
    tie_counts, tie_err = check_tie_overflow(nodes, args.seed)
    for name, n in tie_counts.items():
        launches[name] += n
    # J's error over both of its comparisons (phase 3 and the nine-tie run)
    err, *rest = checks["text"]["extend_all"]
    checks["text"]["extend_all"] = (max(err, tie_err), *rest)

    # ---- 4d. the taxonomy-free tools and kaiju-multi, on db.ktx, each
    # run counted from 0 ----------------------------------------------------
    work = os.path.dirname(ktx["fmi"])
    for name, (_t, _f, kind, n, _k) in X_RUNS.items():
        items, xfq = x_items(records, reads, args.seed, kind, n, work)
        counts, x_checks, _tsv = run_taxfree(index, ktx["fmi"], items, xfq,
                                             name)
        for k, c in counts.items():
            launches[k] += c
        for k, (x_err, *_r) in x_checks.items():  # errors over all checks
            err, *rest = checks["text"][k]
            checks["text"][k] = (max(err, x_err), *rest)
        if name in X_STEADY:
            steady_taxfree(index, items, warm, name)
    for k, c in run_multi(ktx["fmi"], nodes, reads,
                          tsvs["greedy"]["fmi"]).items():
        launches[k] += c

    # ---- 4e. the index-sharded paths, each run counted from 0 ------------
    for tag in ("text", "fmi"):
        for n_shards in MESH:
            for mode in PATHS:
                for k, c in run_mesh(indexes[tag], reads, ktx[tag], nodes,
                                     tag, mode, n_shards, tsvs[mode][tag],
                                     rates[mode, tag], warm).items():
                    launches[k] += c
            for k, c in run_sharded_primitives(indexes[tag], reads,
                                               n_shards).items():
                launches[k] += c

    # ---- 4f. many processes, each counted from 0 --------------------------
    for k, c in run_phase_4f(indexes["text"], reads, ktx["text"], nodes,
                             tsvs).items():
        launches[k] += c
    launches.update(g_launches)  # P1, P2: their benchmark's run

    # ---- 4g. the index above 2^31 letters, each run counted from 0 ------
    big_rows, big_launches = run_phase_4g(big_build, smi)
    for name, v in big_rows.items():
        log(f"kernel {name}: max_abs_err {v[0]}, {v[1]:.4f} ms (plain "
            f"{v[2]:.3f} ms, bound {v[3]:.4f} ms) [{v[4]}]")
    if any(v[0] for v in big_rows.values()):
        raise AssertionError("L or M differs from its plain version")
    launches.update(big_launches)

    # ---- 5. result lines ----------------------------------------------
    rows = {name: (*v, None) for name, v in checks["text"].items()}
    rows.update(gathers)
    rows.update({name: (*v, None) for name, v in big_rows.items()})
    missing = [name for name in REPLACES if name not in rows]
    if missing:
        raise AssertionError(f"kernels without a measurement: {missing}")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"kaiju_tpu_torch/csrc/{kernels.source(name)}.cu",
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms}
        for name, (err, ms, plain_ms, bound_ms, _n, lib_ms) in rows.items()
        if name in REPLACES
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--kaiju-worker"]:  # one process of phase 4f
        return kaiju_worker(argv[1], argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20240817)
    ap.add_argument("--db-letters", type=int, default=64_000_000)
    ap.add_argument("--only-processes", action="store_true",
                    help="run phase 4f alone, with the phase 4 lines it is "
                    "held against (for a machine with several cards); no "
                    "kernels line and no result line")
    args = ap.parse_args(argv)
    try:
        return run(args)
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
