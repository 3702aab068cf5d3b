"""Classify reads against an index of more than 2^31 letters on the cards
of one process (K17): the counterpart of scripts/big_classify_demo.py's
main (:493-627).

    python -m kaiju_tpu_torch.tools.big_classify [--letters 4400000000]
        [--threads 2] [--shards 8] [--reads 1024] [--read-len 64]
        [--verify 24] [--seed 20260821] [--allow-small] [--out DIR]
        [--log PATH] [--device cpu|cuda:0,cuda:1,...]

  1. build a synthetic protein DB of --letters letters with the int64
     threaded builder (``parallel.big_index.build_db``);
  2. save it as the demo's sharded layout in --out, --shards shards
     (local int32 occ a shard, int64 shard bases, C and SA samples);
  3. load it onto the cards (--device; every visible card by default),
     each shard an allocation of its own on card o mod D, the step on the
     first card reading the others' shards over NVLink (``BigIndex``),
     and record the load's seconds and each card's bytes;
  4. classify --reads reads of --read-len letters (the demo's generator:
     substrings of DB sequences, every fourth mutated twice, every fourth
     junk) with ``ops.big_mem.big_mem_step``: kernel L extends every end
     position, kernel M walks the first SA row of every non-empty
     interval to a sequence id; then the demo's host greedyExact
     statistics (maxl, the taxa of the longest matches);
  5. check --verify sampled reads against ``HostOracle``, an independent
     host int64 rank over the same BWT (``tools.big_build.BigRank``):
     every lane's (i, s0, s1), the walked ids of the longest matches,
     maxl and the read's source taxon.

Two differences from the demo, on purpose: the oracle's SA walk returns
the LF result at a terminator, the content rank of the sequence (as the
reference's get_suffix and the JAX step do; the demo's oracle returns the
raw row there, :483-484), and the log goes to --log, by default
``big_classify.log`` inside --out (the demo overwrites BIGCLASSIFY.log at
the repository root).  The last line of standard output is the demo's
JSON summary.  Runs on the cards unless --device cpu (or cpu,cpu, ...:
slots on the CPU), where the plain PyTorch versions of L and M run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..ops.big_mem import big_mem_step
from ..parallel.multihost import local_cards
from ..parallel.big_index import (BigIndex, build_db, log, peak_rss_gb,
                                  save_sharded_ktx)
from .big_build import BigRank

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MIN_LEN = 11


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--letters", type=int, default=4_400_000_000)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--reads", type=int, default=1024)
    ap.add_argument("--read-len", type=int, default=64)
    ap.add_argument("--verify", type=int, default=24)
    ap.add_argument("--seed", type=int, default=20260821)
    ap.add_argument("--allow-small", action="store_true")
    ap.add_argument("--out", default=None, help="sharded ktx dir "
                    "(default: .bench_cache/bigktx)")
    ap.add_argument("--log", default=None, help="log file (default: "
                    "big_classify.log inside --out)")
    ap.add_argument("--device", default=None, help="every visible card "
                    "(the default), one device (cuda:1, cpu), or a comma "
                    "list of them: shard o on the o mod D-th, the step on "
                    "the first")
    return ap.parse_args(argv)


def make_reads(db, n, L, seed=7):
    """n reads of L codes (0-padded) and their source taxa (-1: junk):
    substrings of DB sequences, kind 1 with two letters mutated, kind 3
    uniform junk (the demo's generator, :516-536)."""
    rng = np.random.default_rng(seed)
    reads = np.zeros((n, L), dtype=np.uint8)
    truth = np.zeros(n, dtype=np.int64)
    for t in range(n):
        kind = t % 4
        if kind == 3:
            reads[t] = rng.integers(1, db["alen"], size=L)
            truth[t] = -1
            continue
        iseq = int(rng.integers(0, db["nseq"]))
        ln = int(db["seq_len"][iseq])
        take = min(L, ln)
        p = int(db["starts"][iseq]) + int(rng.integers(0, ln - take + 1))
        reads[t, :take] = db["text"][p : p + take]
        if kind == 1:
            for _ in range(2):
                reads[t, int(rng.integers(0, take))] = int(
                    rng.integers(1, db["alen"])
                )
        truth[t] = int(db["taxids"][iseq])
    return reads, truth


def host_stats(reads, i_a, s0_a, s1_a, ids_a, seq_tax, min_len=MIN_LEN):
    """The demo's greedyExact statistics from the step's arrays (:566-591):
    ([(maxl, taxa)] a read, reads classified)."""
    L = reads.shape[1]
    n_cls = 0
    results = []
    for t in range(reads.shape[0]):
        lens = np.where(
            (reads[t] > 0) & (s1_a[t] > s0_a[t]),
            np.arange(L) - i_a[t] + 1, 0,
        )
        got = (reads[t] > 0) & (i_a[t] <= 1) & (s1_a[t] > s0_a[t])
        jstop = int(np.max(np.where(got, np.arange(L), -1)))
        elig = (np.arange(L) >= jstop) & (lens >= min_len)
        maxl = int(np.max(np.where(elig, lens, 0)))
        taxs = set()
        if maxl > 0:
            for j in np.nonzero(elig & (lens == maxl))[0]:
                r = int(ids_a[t, j])
                if r >= 0:
                    if r < len(seq_tax):
                        taxs.add(int(seq_tax[r]))
        results.append((maxl, taxs))
        if maxl > 0 and taxs:
            n_cls += 1
    return results, n_cls


class HostOracle:
    """The demo's host oracle (:428-490) on an independent int64 rank over
    the same BWT, with the SA walk returning the LF result at a
    terminator."""

    def __init__(self, db):
        self.br = BigRank(db["bwt"], db["alen"])
        self.db = db
        self.order = np.argsort(db["content_rank"], kind="stable")
        self.e = db["e"]
        self.first = db["first"]

    def extensions(self, codes):
        """(i, s0, s1) of every end position j of codes, as the step
        computes them: a position on code 0 keeps (j, C[1], C[2]) and a
        code 0 stops an extension."""
        br = self.br
        exts = []
        for j in range(len(codes)):
            c = int(codes[j])
            if c == 0:
                exts.append((j, int(br.C[1]), int(br.C[2])))
                continue
            s0, s1 = int(br.C[c]), int(br.C[c + 1])
            i = j
            while i > 0 and s0 < s1:
                c = int(codes[i - 1])
                if c == 0:
                    break
                n0, n1 = br.fmindex(c, s0), br.fmindex(c, s1)
                if n0 >= n1:
                    break
                s0, s1, i = n0, n1, i - 1
            exts.append((i, s0, s1))
        return exts

    def classify(self, codes, min_len=MIN_LEN):
        """greedyExact MEM semantics for one protein read (codes 1..20):
        per-end-position maximal extensions, jstop, maxl, tie taxids."""
        L = len(codes)
        exts = self.extensions(codes)
        jstop = max(
            (j for j in range(L) if exts[j][0] <= 1), default=-1
        )
        maxl = 0
        for j in range(L):
            i, s0, s1 = exts[j]
            ln = j - i + 1
            if j >= jstop and ln >= min_len and s1 > s0:
                maxl = max(maxl, ln)
        if maxl == 0:
            return 0, set()
        ids = set()
        for j in range(L):
            i, s0, s1 = exts[j]
            if j >= jstop and (j - i + 1) == maxl and s1 > s0:
                for k in range(s0, min(s1, s0 + 16)):
                    ids.add(self.sa_id(k))
        taxs = {int(self.db["taxids"][self.order[r]]) for r in ids}
        return maxl, taxs

    def sa_id(self, k):
        br = self.br
        steps = 0
        while True:
            if k >= self.first and ((k - self.first) & ((1 << self.e) - 1)) == 0:
                return int(self.db["sa_seq"][(k - self.first) >> self.e])
            c = int(br.bwt[k])
            k = br.fmindex(c, k)
            if c == 0:
                return int(k)  # the content rank of the sequence
            steps += 1
            assert steps < 10_000


def verify(db, reads, truth, step, results, n_verify, min_len=MIN_LEN,
           fh=None):
    """The demo's parity check (:593-613) on n_verify sampled reads, and
    every lane of each against the oracle's extensions and walks.
    Returns the reads checked; raises AssertionError on a difference."""
    if n_verify <= 0:
        return 0
    i_a, s0_a, s1_a, ids_a = step
    t0 = time.time()
    oracle = HostOracle(db)
    log(fh, f"oracle rank ready in {time.time()-t0:.1f}s")
    n_ok = 0
    for t in range(0, len(reads), max(1, len(reads) // n_verify))[
        : n_verify
    ]:
        got = list(zip(i_a[t].tolist(), s0_a[t].tolist(), s1_a[t].tolist()))
        assert got == oracle.extensions(reads[t]), t
        codes = reads[t][reads[t] > 0]
        maxl_h, taxs_h = oracle.classify(codes, min_len)
        maxl_m, taxs_m = results[t]
        assert maxl_h == maxl_m, (t, maxl_h, maxl_m)
        if maxl_h > 0:
            for j, (i, s0, s1) in enumerate(got):
                if reads[t, j] and s1 > s0 and j - i + 1 == maxl_h:
                    assert int(ids_a[t, j]) == oracle.sa_id(s0), (t, j)
            # the step walks only the first position per tie interval;
            # the host oracle's id set is a superset
            assert taxs_m <= taxs_h or taxs_m == taxs_h, (t, taxs_m, taxs_h)
            assert taxs_m, t
            if truth[t] >= 0:
                assert int(truth[t]) in taxs_h, (t, truth[t], taxs_h)
        n_ok += 1
    log(fh, f"parity OK: {n_ok} sampled reads match the host big-rank "
            f"oracle ({time.time()-t0:.0f}s)")
    return n_ok


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, db=None) -> dict:
    """Steps 1-5 for parsed args; `db` (build_db's dict) skips the build.
    Returns {"summary", "index", "reads", "truth", "step" (the four
    arrays, numpy), "results", "db", "seconds" (build, save, load, first
    and steady step, host statistics)}."""
    cards = local_cards(None if args.device is None
                        else args.device.split(","))
    dev = cards[0]
    out = args.out or os.path.join(ROOT, ".bench_cache", "bigktx")
    os.makedirs(out, exist_ok=True)
    secs = {}
    with open(args.log or os.path.join(out, "big_classify.log"), "w") as fh:
        t0 = time.time()
        if db is None:
            db = build_db(fh, args.letters, args.threads, args.seed,
                          args.allow_small)
        secs["build"] = time.time() - t0
        t0 = time.time()
        save_sharded_ktx(fh, db, out, args.shards)
        secs["save"] = time.time() - t0
        reads, truth = make_reads(db, args.reads, args.read_len)

        log(fh, "devices: " + ", ".join(
            str(c) + (f" ({torch.cuda.get_device_name(c)})"
                      if c.type == "cuda" else "") for c in cards))
        ix = BigIndex.load(out, cards, fh)
        secs["load"] = ix.load_seconds
        codes = torch.from_numpy(reads).to(dev)

        t0 = time.time()
        big_mem_step(ix, codes)
        _sync(dev)
        secs["first_step"] = time.time() - t0
        t0 = time.time()
        step = big_mem_step(ix, codes)
        _sync(dev)
        step_s = secs["step"] = time.time() - t0
        step = tuple(a.cpu().numpy() for a in step)

        t0 = time.time()
        seq_tax = ix.seq_tax.cpu().numpy()
        results, n_cls = host_stats(reads, *step, seq_tax)
        secs["host_stats"] = time.time() - t0
        log(fh, f"big classify: {args.reads} reads, first step "
                f"{secs['first_step']:.2f}s, steady step {step_s:.4f}s "
                f"({args.reads/step_s:.0f} reads/s), host statistics "
                f"{secs['host_stats']:.2f}s, {n_cls} classified")

        n_ok = verify(db, reads, truth, step, results, args.verify,
                      fh=fh)

        summary = dict(
            metric="big_index_mesh_classify", letters=int(db["N"]),
            over_2_31=float(db["N"] / 2**31), shards=args.shards,
            reads=args.reads, reads_per_sec=round(args.reads / step_s, 1),
            classified=n_cls, verified=n_ok,
            peak_rss_gb=round(peak_rss_gb(), 1),
        )
        log(fh, json.dumps(summary))
    return {"summary": summary, "index": ix, "reads": reads, "truth": truth,
            "step": step, "results": results, "db": db, "seconds": secs}


def main(argv=None) -> int:
    res = run(parse_args(argv))
    print(json.dumps(res["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
