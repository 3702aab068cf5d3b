#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kaiju_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 20240817] [--db-letters 64000000]
    python3 chip_smoke.py --only-processes    # phases 1, 2, 4 (text), 4f
    python3 chip_smoke.py --only-cards        # phases 1, 2, 4 (text), 4i
    python3 chip_smoke.py --only-warm         # phases 1, 2, 4h
    python3 chip_smoke.py --only-hosts        # phases 1, 2, 4 (text), 4j

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
  3. hold every kernel of both paths against its plain PyTorch version
     on the card, on the inputs the main path gives it, on each index:
     the seed-table build's last depth for A (its letters form on the
     20^4 intervals of depth 4, its probe form on their 20^5 repeated
     probes, both with bytes and latency floors); the first 4,096-read
     batch of the MEM path for B, C (and its floors), D (and G) and J
     (its fragments as a 0-padded code matrix) and of the Greedy path at
     -e 3 for B, E, F.  On the text index B screens
     its lanes, G finishes the narrow ones, E runs its last-level hybrid
     and D, F read virtual rows. Then the verbose paths' kernels: one
     batch of each -v pipeline on the card records the inputs of its
     first launch of H (the SA positions of the MEM batch's ties), K
     (B's lanes of the Greedy batch, Lmap 7, screened on the text index;
     its rows row for row; and the batch's longest fragment alone, the
     lazy launch's shape) and I (the first co-simulation round's variant
     lanes, also run in the code-row form; its note counts the lanes that
     reach another lane's state, lane_meetings).  Integer outputs equal; time both.  Then each kernel
     that reads the index (A in both forms, J, H, B, G, D, E, F)
     launched on the index in 2 and 4 shards (K16's sharded
     instantiations) on the same inputs must equal the unsharded kernel,
     and on the text index its plain version on the shards (timed).
     Every kernel also prints a second floor: the plain versions' longest
     chain of dependent row reads (or loads) times the card's L2
     latency, which csrc/chase.cu measures first.  D and F run twice on each index:
     with the flat tree of phase 4 and with every sequence mapped to a
     species of a taxonomy of NCBI's size and depth
     (readgen.DeepTaxonomy: 2.5 M nodes, species 20-40 levels deep,
     taxids up to 3 M; its nodes.dmp written under build/chip_smoke/),
     each with both floors, bytes and the plain versions' longest chain
     of dependent loads (range expansion, SA walk rounds, sample, taxon,
     depth, lift and climb rounds) times the L2 latency.  Then B (the
     MEM batch screened with the hybrid's stop on the text index,
     unscreened without it on db.ktx; the Greedy batch), E (-e 3, with
     and without the hybrid), D and F (both trees; on the deep one each
     gene family's copies lie under one random clade, so that their LCAs
     fall at mixed depths), A in both forms, C and J on a DB with repeats
     (readgen.gen_realistic, bench.py's generator, 8 M letters, one
     batch of 4,096 of its reads), and the verbose paths' H, I and K on
     the same batch, equal to their plain versions, timed.
     Then P1 and P2 through their benchmark, tools.bench_gather (250,000
     rows of 512 bytes, 262,144 random rows): each equal to its plain
     version, bit for bit, timed beside torch.index_select and
     tab[idx].sum(1);
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
     the first 8,192 reads (two batches) of db_text.ktx and on one
     batch of db.ktx, counting launches (MEM -v must launch A's letters
     form, B, C, H, Greedy -v A in both forms, B, K, I, H; on the text
     index every B screened, G never), each line's first three columns
     equal to phase 4's line of the same read, path and index, 256
     sampled lines equal to ExactClassifier's with verbose=True, and on
     the text index the steady -v rate beside phase 4b's with the host
     seconds of each stage, and the device's idle share of a traced
     pass; then a small constructed index whose read has a fragment with
     nine ties (more than TIE_CAP) through MEM -v: J must launch, equal
     its plain version on the inputs of each of its calls there, and
     every line equal ExactClassifier's;
  4d. the taxonomy-free tools on db.ktx, through their main and
     engine.batch.BatchRunner: kaijux -a mem on 8,192 reads, kaijux
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
  4f. many processes: tools.kaiju.main as 2 processes, each on its share
     of the cards (multihost.process_cards; on one card both on cuda:0,
     and the script says that the cross-card form was not run)
     (--dist-nprocs 2, a coordinator on 127.0.0.1, --dist-pid p; this
     script started again with --kaiju-worker, each process with its own
     -o and seed-table cache), on the first 16,384 reads of db_text.ktx:
     -a mem with and without --mesh-index 2, the default flags without it
     and with --mesh-index 4, and the default flags with --mesh-index 4 on
     two cards a process (--cards: cards 2p and 2p + 1, or cuda:0 twice
     on one card): each process must launch every kernel of its path,
     each read must be in exactly one output, the one its batch share
     names, and the lines merged by read must equal phase 4's; with
     --mesh-index each card must hold, read and map exactly the shards of
     the slot rules (slot g = p D + c holds g mod S for G = N D >= S, o mod
     G = g for G < S; the others from a card of its process, else over
     CUDA IPC from a process that holds them), and process 0 holds each
     kernel of its path (A; B, G, C, D; B, E, F) on the arguments of its
     first call on its first card, on the shards read there, against its
     plain version and against its launch on copies in its own memory
     (both launches timed); the card memory used after set-up, the index
     bytes held apart beside whole copies, and the processes' wall and
     stream beside the one-process main() of the same reads; with four
     cards, the default flags at --mesh-index 4 as 1 x 4, 2 x 2 and 4 x 1
     (processes x cards), each twice, their streams side by side;
  4h. warm start: tools.mkdb --aot -t nodes.dmp --aot-batch 4096, a
     process of its own, on a FASTA of phase 2's first records up to 8 M
     letters into build/chip_smoke/aot.ktx (the seconds of each step: the
     libraries built into aot.ktx/aot/<key>/, the seed tables, each mode's
     batch); then this script started again with --warm-worker, a fresh
     process that runs tools.kaiju.main with -a mem and then the default
     flags on phase 4's first 4,096 reads: on aot.ktx every library it
     loads must come from aot.ktx/aot/<key>/ with 0 nvcc runs and A must
     not launch (the tables are read); on a copy without aot/, kmer*/ and
     bloom_* the libraries come from build/ and A builds the tables.  Each
     prints one JSON line: its main()'s set-up split (libraries, index,
     taxonomy, seed tables, bitmaps, the card's context and uploads, first
     batch), launches, each library's directory, nvcc runs, imports.  Both
     TSVs must equal tools.kaiju.main's in this process on aot.ktx byte for
     byte; phase 1's build seconds are printed beside the prepared
     process's library seconds;
  4i. the index over the cards of one process: every visible card (on a
     machine with one card ["cuda:0", "cuda:0"], two data rows and no
     peer read); under torch.cuda.device(i) every kernel library's
     runtime must take card i as current; then tools.kaiju.main(...,
     device=cards) with -a mem and with the default flags, each with
     --mesh-index 1, 2 and 4, on the first 16,384 reads of db_text.ktx
     (seed tables built afresh by card 0 on its view): one pipeline a card
     on its share of each batch (engine.pipeline.CardShare), each card
     launching every kernel of its path (A on card 0 alone), counted per
     card, no unsharded kernel, each card holding the shards of the rule
     (card c: c mod S for D >= S, o mod D = c for D < S) and reading the
     others in place from their holders' cards, with layout()'s bytes, and
     the TSV equal to phase 4's lines byte for byte; with S > 1 each kernel
     of the path on card 0's first call against its plain version and its
     launch on copies of every shard on card 0 (both timed), at S = 4 J
     and H on card 0's view too; steady passes over the cards and on one
     card in turns (one, cards, cards, one) with each card's host seconds
     by stage and its set-up seconds; then tools.big_classify.run over the
     cards at S = 2 and 4 on a DB of 64 M letters (the demo's seed, built
     here): shard o on card o mod D, the step on card 0, 24 sampled reads
     held to the oracle lane for lane, S = 4 equal to S = 2, and at S = 4
     L and M on the peer shards against their launches on copies on card 0
     (timed) and the plain versions;
  4g. the index above 2^31 letters (K17): a synthetic DB of 2.2 G
     letters (N about 1.03 x 2^31) from the demo's
     seed, built with the int64 builder on every host thread in a thread
     of its own that starts after phase 4b and runs beside phases 4c-4i
     (it slows their host stages; 4b's steady rates run alone);
     then tools.big_classify.run on the demo's 1,024 reads of 64 at S = 2
     (saved, loaded onto the card, L then M twice, the host statistics,
     every lane of 24 sampled reads against its host oracle) and at S = 8
     (each run counted from 0; L and M must launch in each), the four
     arrays of S = 8 equal to S = 2's; L and M against their plain
     versions on the card on the S = 2 run's reads (timed, bound from the
     distinct rows, latency floor from the plain versions' longest chain
     of dependent rows times the device-memory latency, M's heads against
     its lanes to walk and its longest walk), an interval starting at
     2^31 or later; a steady big_mem_step over 65,536 reads (reads/s, the
     host statistics' seconds) and L and M against their plain versions
     on its reads (the same figures, the plain versions untimed), with
     build, save and load seconds, the card's bytes for the index and the
     host's peak RSS;
  4j. processes on several hosts, rehearsed on one machine (each process
     given a host label through peer_shards.host_name; every host is this
     machine, and the rounds run card to card over NCCL where every slot
     of the group has a card of its own, else over gloo on loopback):
     tools.kaiju.main with
     the default flags (Greedy) with --mesh-index 2 as 2 processes on
     hosts a, b, Greedy and -a mem with --mesh-index 4 as 3 processes on
     a, a, b (and 4 processes on a, a, b, b where there are four cards),
     each process on its share of the cards, and Greedy with --mesh-index
     4 as 2 processes on hosts a, b of two cards each (--cards, as in 4f),
     on the first 4,096 reads of db_text.ktx (and of db.ktx for Greedy
     at --mesh-index 4), each process with an empty
     seed-table cache, so that the group builds the tables by rounds of
     N: each process must launch every kernel of its mode's hosts path
     (N, O, U, X, Q, V and W's resolved form for Greedy; N, O, C, W and
     Q for MEM; on db_text.ktx kernel Y too, the text-compare hybrid, and
     its stages "switch" and "text") and no
     one-host kernel that reads the index (no E, F, B, D or G), each card
     must hold, read, map and have served in rounds the shards of the slot
     rules, with rounds in every stage of the path on every card (the seed
     tables' on card 0) over the transport that the rule restated here
     gives (transport_rule; no copy under NCCL), each read must be
     written once by its owner and the merged lines equal phase 4's lines
     of the mode; with --only-hosts and two cards or more, Greedy on
     db_text.ktx at --mesh-index 2 on a, b (and 4 on a, a, b, b) is
     followed by its twin over gloo, whose lines and rounds must be equal,
     the pair's rates and seconds printed; on db_text.ktx a
     line counts the intervals switched to Y and the positions Q walked
     of those listed; process 0 holds
     each hosts kernel on the arguments of its first card's first rounds
     (each form of U, X, V, N, O, Q, W, Y) against its plain version on
     copies (timed in the runs at 4 shards on a, a, b of db_text.ktx, on
     the kernels' launches alone, launch_ms, and as the wrappers' whole
     calls, with the count that U's list pass, O, Q and X read back); each
     process's main(), set-up and stream seconds, the rounds a batch of
     each stage with their queries, bytes and seconds in copies,
     transport and N, and the stream's rate against a one-host group of
     2 processes of the mode at --mesh-index 2 on the same reads, run
     first;
  5. print the kernels' JSON line (the text index's measurements, the
     sharded kernels' on 4 shards, L's and M's on the big index, N, O, Q,
     W, U, X, V and Y from 4j's runs at 4 shards on hosts a, a, b, and each
     kernel's latency floor where its note states one; the
     launches of every run of phases 4, 4c, 4d, 4e, 4f, 4h, 4i, 4j and 4g,
     each counted from 0, and of P1 and P2's benchmark; each error the
     largest of all the kernel's comparisons), then the result line.

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
import re
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
    "update_si_letters": "kaiju_tpu/ops/kmer.py:94",
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
    "update_si_letters_sharded": "kaiju_tpu/parallel/sharded_index.py:102",
    "extend_all_sharded": "kaiju_tpu/parallel/sharded_index.py:123",
    "sa_lookup_sharded": "kaiju_tpu/parallel/sharded_index.py:185",
    "mem_extend_sharded": "kaiju_tpu/parallel/sharded_fused.py:52",
    "text_extend_sharded": "kaiju_tpu/parallel/sharded_fused.py:153",
    "read_lca_sharded": "kaiju_tpu/parallel/sharded_fused.py:78",
    "greedy_search_sharded": "kaiju_tpu/parallel/sharded_fused.py:278",
    "ranges_lca_sharded": "kaiju_tpu/parallel/sharded_fused.py:278",
    "big_extend_all": "scripts/big_classify_demo.py:296",
    "big_sa_walk": "scripts/big_classify_demo.py:332",
    "fm_serve": "kaiju_tpu/parallel/sharded_index.py:102",
    "mem_extend_hosts": "kaiju_tpu/parallel/sharded_fused.py:52",
    "walk_hosts": "kaiju_tpu/parallel/sharded_fused.py:78",
    "read_lca_hosts": "kaiju_tpu/ops/fused_classify.py:298",
    "greedy_levels": "kaiju_tpu/ops/fused_greedy.py:298",
    "greedy_variants_hosts": "kaiju_tpu/ops/fused_greedy.py:103",
    "ranges_lca_hosts": "kaiju_tpu/ops/fused_classify.py:153",
    "switch_hosts": "kaiju_tpu/parallel/sharded_fused.py:153",
}
# P1, P2: the one PyTorch call computing the same function, if any
LIBRARY = {"gather_rows": "torch.index_select(tab, 0, idx)"}
# a kernel launched as passes, one device function each: the symbols whose
# profiler rows phase 4b sums into its total
PASSES = {"G": ("text_extend_list", "text_extend_switch", "text_extend_keep")}
# the kernels that read the index, whose sharded instantiations (K16) the
# index-sharded paths run (A's letters form for the seed tables; B, G, D
# for MEM; B, E, F for Greedy; A's probe form, H and J beside them)
SHARDED = ("update_si", "update_si_letters", "extend_all", "sa_lookup",
           "mem_extend", "text_extend", "read_lca", "greedy_search",
           "ranges_lca")
MESH = (2, 4)  # index shards of phase 3's sharded checks and phase 4e
MESH_READS = 4 * BATCH  # reads of each phase 4e and 4f run
NPROCS = 2  # processes of each phase 4f run
# phase 4i, the index over the cards of one process: the --mesh-index of its
# runs, and its big index's letters and shards (tools.big_classify.run)
CARD_SHARDS = (1, 2, 4)
CARD_BIG_LETTERS = 64_000_000
CARD_BIG_SHARDS = (2, 4)
# phase 4f's runs (--mesh-index, path, cards a process): one index a
# process; the shards held apart with N = S; N < S (two shards held and two
# mapped a process); 2 processes of 2 cards, a slot a shard (each card
# reading one shard from its process's other card and mapping two)
PROC_RUNS = ((0, "mem", 1), (0, "greedy", 1), (2, "mem", 1),
             (4, "greedy", 1), (4, "greedy", 2))
# where there are four cards, the same Greedy reads at --mesh-index 4 on
# the four in three layouts: (processes, cards a process)
LAYOUTS = ((1, 4), (2, 2), (4, 1))
# phase 4j, processes on several hosts rehearsed on one machine: each run's
# --mesh-index and hosts (process p labelled hosts[p]), four processes on
# two hosts where there are four cards; each mode's indexes, the kernels of
# its hosts path (A's tables by rounds of N; Greedy: O, U, X, Q, V and W's
# resolved form; MEM: O, C, W, Q), the stages of its rounds and the forms
# process 0 must check
HOST_RUNS_4 = ((4, "aabb"),)
# the run of two cards a process: (mode, index, --mesh-index, hosts, cards)
HOST_CARD_RUN = ("greedy", "text", 4, "ab", 2)
HOST_READS = BATCH  # reads of each 4j run, its one-host reference's too
# the 4j run whose process 0 times its hosts kernels for the kernels line
# (the other runs compare them with their plain versions untimed)
HOST_TIMED = ("text", 4, "aab", 1)
HOST_INDEXES = {"greedy": ("text", "fmi"), "mem": ("text",)}
# under --only-hosts with two cards or more, the runs (mode, index,
# --mesh-index, hosts) that a twin over gloo follows (kaiju_worker's
# --transport gloo replaces the rule), aabb where there are four cards
HOST_TWINS = (("greedy", "text", 2, "ab"), ("greedy", "text", 4, "aabb"))
# the runs of each mode (--mesh-index, hosts), and of Greedy on db.ktx
HOST_MODE_RUNS = {"greedy": ((2, "ab"), (4, "aab")), "mem": ((4, "aab"),)}
HOST_FMI_RUNS = ((4, "aab"), (4, "aabb"))
HOST_PATHS = {
    "greedy": ("fm_serve", "mem_extend_hosts", "greedy_levels",
               "greedy_variants_hosts", "walk_hosts", "ranges_lca_hosts",
               "read_lca_hosts", "switch_hosts"),
    "mem": ("fm_serve", "mem_extend_hosts", "mem_stats", "read_lca_hosts",
            "walk_hosts", "switch_hosts"),
}
HOST_STAGES = {"greedy": ("seed", "extend", "variants", "switch", "text",
                          "walk"),
               "mem": ("seed", "extend", "switch", "text", "walk")}
HOST_FORMS = {"greedy": 13, "mem": 7}
# what only an index with a text copy runs across hosts, the hybrid: kernel
# Y, its stages, and the forms process 0 must check besides HOST_FORMS (N's
# walk and text rows, Y's start and finish)
HOST_HYBRID = ("switch_hosts",)
HOST_HYBRID_STAGES = ("switch", "text")
HOST_HYBRID_FORMS = ("fm_serve w2", "fm_serve w32", "switch_hosts start",
                     "switch_hosts finish")
# the kernels each path launches on an index without text (the text index
# adds G to MEM), A's letters form where the seed tables are built, and the
# CLI flags that select the path
PATHS = {
    "mem": (("update_si_letters", "mem_extend", "mem_stats", "read_lca"),
            ["-a", "mem"]),
    "greedy": (("update_si_letters", "mem_extend", "greedy_search",
                "ranges_lca"), []),
}
BLOOM_M = {"mem": 11, "greedy": 7}  # -m 11; Lmap = min(-l 7, -m 11)
# the kernels each verbose path launches (J only on a fragment with more
# than TIE_CAP ties; Greedy's co-simulation probes through A's probe form),
# and its flags
VERBOSE_PATHS = {
    "mem": (("update_si_letters", "mem_extend", "mem_stats", "sa_lookup"),
            ["-a", "mem", "-v"]),
    "greedy": (("update_si_letters", "update_si", "mem_extend",
                "greedy_map", "extend_from", "sa_lookup"), ["-v"]),
}
V_READS = 2 * BATCH  # reads of the verbose runs on the text index
# phase 4d, on db.ktx: each run of a taxonomy-free tool (tool, flags, kind
# of reads, read count) and the kernels it must launch; the kernel wrappers
# BatchRunner calls (engine.batch; extend_rows launches extend_from)
X_SERVE = ("extend_all", "extend_from", "update_si", "sa_lookup")
X_RUNS = {
    "kaijux mem": ("kaijux", ["-a", "mem"], "dna", 2 * BATCH,
                   ("extend_all", "sa_lookup")),
    "kaijux greedy": ("kaijux", [], "dna", BATCH, X_SERVE),
    "kaijup greedy": ("kaijup", [], "protein", BATCH, X_SERVE),
    "kaijux -v": ("kaijux", ["-v"], "dna", BATCH, X_SERVE),
}
X_WRAPPERS = ("extend_all", "extend_rows", "update_si", "sa_lookup")
X_STEADY = ("kaijux mem", "kaijux greedy")  # the runs timed again
# phase 4h, warm start: the letters of the DB that mkdb --aot builds (phase
# 2's first records), and the set-up steps a fresh process's main() is split
# into
AOT_LETTERS = 8_000_000
WARM_STEPS = ("libraries", "index", "taxonomy", "seed_tables", "bitmaps",
              "upload", "first_batch")
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
# phase 3's taxonomy of NCBI depth (readgen.DeepTaxonomy from seed + 3):
# a gene family of the DB with repeats goes under the clade 1 to
# DEEP_FAMILY_UP levels above a random species; each tree's D and F checks
# carry this suffix (none for the flat tree)
DEEP_FAMILY_UP = 12
TREES = ("", " (deep tree)")
_DEEP = {}


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


def launch_ms(fn, reps: int = 15, warm: int = 2, kernels=None) -> float:
    """Median milliseconds that a call of fn() spends in its kernels on the
    card: CUDA events around each launch of the kernel loader `kernels`
    (this checkout's by default; compare_kernels.py passes another
    checkout's) inside fn, summed over the call, each launch behind a
    sleep kernel that keeps the stream busy while the host enqueues it.
    What fn does between its launches (a count read back from the card,
    host work) is left out, where cuda_ms holds it."""
    import torch

    if kernels is None:
        from kaiju_tpu_torch import kernels

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    inner = kernels.launch
    pairs: list = []

    def timed(name, *args):
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)  # about 1 ms at 1.98 GHz
            start.record()
            inner(name, *args)
            end.record()
        pairs.append((start, end))

    times = []
    kernels.launch = timed
    try:
        for _ in range(reps):
            pairs.clear()
            fn()
            torch.cuda.synchronize()
            times.append(sum(a.elapsed_time(b) for a, b in pairs))
    finally:
        kernels.launch = inner
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
    with text}, each record's gene family) of a DB with repeats:
    readgen.gen_realistic (bench.py's generator: gene families copied
    exactly and at ~90 % identity, with low-complexity runs) from seed +
    2, indexed with the native builder; the text index's cache holds its
    two Bloom bitmaps."""
    import numpy as np

    from kaiju_tpu_torch.index import native_builder
    from kaiju_tpu_torch.index.core import KaijuIndex
    from kaiju_tpu_torch.ops import bloom
    from kaiju_tpu_torch.tools import readgen

    t0 = time.perf_counter()
    families = []
    records = readgen.gen_realistic(random.Random(seed + 2), letters,
                                    families)
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
    return records, ktx, families


def deep_tree(seed: int):
    """The taxonomy of NCBI depth (readgen.DeepTaxonomy from seed + 3),
    made once a process; its nodes.dmp is written under
    build/chip_smoke/."""
    if seed not in _DEEP:
        from kaiju_tpu_torch.tools import readgen

        t0 = time.perf_counter()
        tree = readgen.DeepTaxonomy(seed + 3)
        path = os.path.join(ROOT, "build", "chip_smoke", f"deep_seed{seed}",
                            "nodes.dmp")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tree.write_nodes_dmp(path)
        d = tree.depth[tree.species]
        log(f"deep tree: {len(tree.internal) + len(tree.species):,} nodes, "
            f"{len(tree.species):,} species at depth {int(d.min())}-"
            f"{int(d.max())} (mean {float(d.mean()):.1f}), taxids below "
            f"{tree.parent.shape[0]:,} (parent and depth "
            f"{tree.parent.nbytes:,} bytes each), {path} written, in "
            f"{time.perf_counter() - t0:.1f} s")
        _DEEP[seed] = tree
    return _DEEP[seed]


def deep_seq_tax(tree, index, seed: int, families=None):
    """Each sequence of the index mapped to a species of the deep tree
    (int32 [nseq]): a random species each; with families (each input
    record's gene family), a random leaf under its family's clade, itself
    1 to DEEP_FAMILY_UP levels above a random species."""
    import numpy as np

    rng = np.random.default_rng(seed + 4)
    if families is None:
        return tree.species[rng.integers(0, len(tree.species), index.nseq)]
    fam = np.asarray(families)[index.seq_term_order]
    ufam, inv = np.unique(fam, return_inverse=True)
    top = tree.ancestor(
        tree.species[rng.integers(0, len(tree.species), len(ufam))],
        rng.integers(1, DEEP_FAMILY_UP + 1, len(ufam)))
    return tree.leaves_under(rng, top[inv])


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
    versions of B, E, D and F run inside the block.  Their lanes step in
    lockstep, so a round is one link of the batch's longest chain of
    dependent reads.  Yields a dict filled on exit: "steps", B's FM-step
    rounds (a step's two ranks read in parallel: one round); "levels",
    E's rounds of each variant level: the probe, then the longer of the
    resumed extension and the last level's SA walks; "walks", D's and F's
    SA walk rounds, and "parents" their rounds of parent loads (the lift,
    then the climb)."""
    from kaiju_tpu_torch.ops import classify, device_index, greedy, search

    trace = []
    orig = (search.rank, greedy.rank, device_index.rank, greedy._resume,
            classify._up)

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

    def up(*a, **k):
        trace.append("u")
        return orig[4](*a, **k)

    search.rank = greedy.rank = pair_rank
    device_index.rank = walk_rank
    greedy._resume = resume
    classify._up = up
    out = {}
    try:
        yield out
    finally:
        (search.rank, greedy.rank, device_index.rank, greedy._resume,
         classify._up) = orig
    out["steps"] = trace.count("p") // 2
    # D's and F's: SA walk rounds, lift and climb rounds
    out["walks"], out["parents"] = trace.count("w"), trace.count("u")
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


@contextlib.contextmanager
def walk_rounds():
    """Counts the lockstep walk rounds of kernel Y's plain version run
    inside the block (each is one LF step of the longest walks, one link
    of the chain of dependent row reads): yields {"rounds"}, filled as it
    goes."""
    from kaiju_tpu_torch.ops import hybrid

    out = {"rounds": 0}
    rank = hybrid.rank

    def counted(*a, **k):
        out["rounds"] += 1
        return rank(*a, **k)

    hybrid.rank = counted
    try:
        yield out
    finally:
        hybrid.rank = rank


def floor_note(chain: int, lat_ns: float, what: str = "row reads") -> str:
    """The latency floor of a chain of `chain` dependent loads, each at
    least one L2 hit (lat_ns)."""
    return (f"longest chain {chain} dependent {what}: latency floor "
            f"{chain * lat_ns / 1e6:.6f} ms at {lat_ns:.1f} ns")


def floor_ms(note: str):
    """The largest latency floor (floor_note) that a kernel's note states,
    else None: the kernels line's "floor_ms" beside "bound_ms"."""
    found = re.findall(r"latency floor ([0-9.]+) ms", note)
    return max(map(float, found)) if found else None


def measure(got, want, fn, plain_fn, touched, other_bytes, note):
    """(max_abs_err, ms, plain_ms, bound_ms, note) of a kernel whose
    outputs `got` its plain version gave as `want`: fn and plain_fn timed
    on the card (a false plain_fn: not timed, plain_ms nan), the bound from
    the distinct record rows in `touched` and `other_bytes`."""
    rb, nrows = row_bytes(touched)
    return (max_abs_err(got, want), cuda_ms(fn),
            cuda_ms(plain_fn, reps=3, warm=1) if plain_fn else float("nan"),
            (rb + other_bytes) / HBM_BYTES_PER_S * 1e3,
            f"{note}, {nrows:,} row reads of {rb // 256:,} rows")


def check_sa_lookup(h, lat_ns: float, note: str):
    """H against its plain version on the arguments h of a sa_lookup call:
    measure()'s tuple, the note with the latency floor (the position, the
    longest walk's rounds, the sample)."""
    from kaiju_tpu_torch.ops import device_index

    touched = []
    with dependent_reads() as dep:
        want = device_index.sa_lookup_plain(*h, touched)
    return measure(device_index.sa_lookup(*h), want,
                   lambda: device_index.sa_lookup(*h),
                   lambda: device_index.sa_lookup_plain(*h), touched,
                   h[-1].shape[0] * (4 + 8 + 8),
                   f"{note}; walk {dep['walks']} rounds: "
                   f"{floor_note(dep['walks'] + 2, lat_ns)}")


def check_kernels(index, reads, ktx_dir, lat_ns: float, deep=None):
    """Per kernel: (max_abs_err, ms, plain_ms, bound_ms, note), on the
    index at ktx_dir; with a text copy, B screens (its bitmaps cached in
    ktx_dir), G finishes the narrow MEM lanes, E runs its last-level hybrid
    and D, F read the virtual rows.  The bound counts each input byte once:
    the distinct record rows that the plain version reads, plus the other
    inputs and the outputs (E's per-position and per-source scratch is its
    own, not counted).  B's, G's, E's, D's and F's notes carry their
    second floor, the longest chain of dependent loads times the L2
    latency lat_ns.  D and F run on the flat tree and, given deep =
    (seq_tax int32 [nseq], readgen.DeepTaxonomy), on the deep one too
    ("read_lca (deep tree)", "ranges_lca (deep tree)").  H runs on the SA
    positions of the MEM batch's tie rows ("sa_lookup (tie rows)", its
    floor in its note too).  A's ("update_si_letters", "update_si") and
    C's notes carry their latency floors, their chains of dependent loads
    times lat_ns."""
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

    # A at the seed-table build's last depth: its letters form on the
    # 20^4 intervals of depth 4, then its probe form on their 20 * 20^4
    # repeated probes (the build's form before the letters form)
    kt = KmerTables.build_device(index, search.SEED_K, dv)
    p0, p1 = (torch.from_numpy(a.astype(np.int32)).to(cuda)
              for a in kt.tables[search.SEED_K - 2])
    m = p0.shape[0]
    la = (dv.rec, dv.C, p0, p1)
    touched = []
    want = device_index.update_si_letters_plain(*la, touched)
    probe_bound = (row_bytes(touched)[0] + NLET * m * (12 + 9)) / \
        HBM_BYTES_PER_S * 1e3
    # the interval, then its rows
    report("update_si_letters", device_index.update_si_letters(*la), want,
           lambda: device_index.update_si_letters(*la),
           lambda: device_index.update_si_letters_plain(*la), touched,
           m * 8 + NLET * m * 8,
           f"{m:,} intervals ({int((p0 < p1).sum()):,} alive), "
           f"{NLET * m:,} results; the probe form's bound on the same "
           f"results {probe_bound:.4f} ms; {floor_note(2, lat_ns, 'loads')}",
           call=(la, {}))
    c = torch.arange(1, NLET + 1, dtype=torch.int32,
                     device=cuda).repeat_interleave(m)
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
    # the probe, then its row
    report("update_si", device_index.update_si(dv.rec, dv.C, c, s0, s1),
           want, lambda: device_index.update_si(dv.rec, dv.C, c, s0, s1),
           update_si_plain, touched, n * (12 + 9),
           f"{n:,} probes; {floor_note(2, lat_ns, 'loads')}",
           call=((dv.rec, dv.C, c, s0, s1), {}))
    del want, touched

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
    if text:
        g = (*lanes, flat, frag_off, sw_len, dv.text, dv.rank_start, dv.rec,
             dv.C, dv.sa_seq, dv.sa_off, dv.nseq, dv.chpt_exp)
        res = hybrid.text_extend(*g)
        sw = hybrid.switched(*lanes, frag_off, sw_len)
        width = (lanes[2] - lanes[1])[sw]
        nsw, nocc = int(sw.sum()), int(width.sum())
        touched = []
        with dependent_reads() as dep:
            want = hybrid.text_extend_plain(*g, touched)
        ext = (lanes[0] - want[0])[sw]
        ext_len, n_ach = int(ext.sum()), (want[2] - want[1])[sw]
        n_ids = int(n_ach.sum())
        at = torch.nonzero(sw).squeeze(1).cpu().numpy()
        run = max((len(r) for r in np.split(at, np.flatnonzero(
            np.diff(at) != 1) + 1)), default=0)
        # the lane, the walk rounds, the sample and the text start, then
        # the compare rounds of a group of 8 (64 letters a round, the
        # stopping letter included)
        chain = (3 + dep["walks"] + (int(ext.max()) + 64) // 64
                 if nsw else 0)
        report("text_extend", res, want, lambda: hybrid.text_extend(*g),
               lambda: hybrid.text_extend_plain(*g), touched,
               P * 24 + 4 * (F + 1) + nocc * 12
               + 2 * (ext_len + nsw) + 4 * n_ids,
               f"{nsw:,} switched lanes of {P:,} (longest run {run:,}), "
               f"{nocc:,} occurrences (lanes of 1-8: "
               f"{torch.bincount(width, minlength=9)[1:].tolist()}), "
               f"{int((n_ach > 1).sum()):,} lanes keeping ties, "
               f"{ext_len:,} letters extended, {n_ids:,} ids; walk "
               f"{dep['walks']} rounds: {floor_note(chain, lat_ns)}",
               call=(g, {}))
        lanes, sw_ids = res[:3], res[3]

    # the taxonomies D and F run on: (seq_tax, parent, depth) by suffix
    trees = {TREES[0]: (dv.seq_tax, *(put(a) for a in Taxonomy(
        {1: 1, 10: 1, **{t: 10 for t in range(100, 197)}}).dense_arrays()))}
    if deep is not None:
        trees[TREES[1]] = (put(deep[0]), put(deep[1].parent),
                           put(deep[1].depth))

    def tail_report(name, fn, plain, args, kw, other_bytes, note, expand):
        """D or F (fn, its plain version) on args, kw; the latency floor's
        chain: `expand` loads to the ranges, the walk rounds, the sample,
        the taxon and its depth, then the lift and climb rounds."""
        got = fn(*args, **kw)
        touched = []
        with dependent_reads() as dep_r:
            want = plain(*args, touched, **kw)
        chain = expand + dep_r["walks"] + 3 + dep_r["parents"]
        n_ids = want[1] if isinstance(want, tuple) else want[:, 3]
        report(name, got, want, lambda: fn(*args, **kw),
               lambda: plain(*args, **kw), touched, other_bytes,
               f"{note}, {int((n_ids > 1).sum()):,} with several taxa; "
               f"walk {dep_r['walks']} rounds, lift and climb "
               f"{dep_r['parents']}: {floor_note(chain, lat_ns, 'loads')}",
               call=(args, kw))

    st = (*lanes, frag_off, min_len, T)
    stats = search.mem_stats(*st)
    want = search.mem_stats_plain(*st)
    flen = frag_off[1:] - frag_off[:-1]
    stored = int(torch.clamp(want[1], max=T).sum())
    out_bytes = 4 * (F + 1) + F * (8 + 12 * T)
    every_lane = (12 * P + out_bytes) / HBM_BYTES_PER_S * 1e3
    # every lane's i, the stored ties' (s0, s1), the outputs; the chain:
    # the fragment's start, its i, the ties' (s0, s1)
    report("mem_stats", stats, want, lambda: search.mem_stats(*st),
           lambda: search.mem_stats_plain(*st), [],
           4 * P + 8 * stored + out_bytes,
           f"{F:,} fragments of {P:,} positions (longest {int(flen.max())}, "
           f"{int((flen > 64).sum()):,} past 64), {stored:,} ties stored "
           f"({int(want[1].sum()):,} in all); with every lane's (s0, s1) "
           f"the bound is {every_lane:.4f} ms; "
           f"{floor_note(3, lat_ns, 'loads')}", call=(st, {}))
    # J on the MEM batch's fragments as a 0-padded code matrix
    fl = flen.to(torch.int32)
    L = max(int(fl.max()), 1)
    x = torch.arange(L, dtype=torch.int32, device=cuda)
    valid = x < fl[:, None]
    codes = torch.where(valid, flat[torch.clamp(
        frag_off[:-1, None] + x, max=P - 1).long()], 0).to(torch.uint8)
    j_args = (dv.rec, dv.C, codes.contiguous(), fl)
    touched = []
    want = device_index.extend_all_plain(*j_args, touched)
    steps = int((x - want[0])[valid].sum())
    tiles, mean_it, max_it, j_steps = j_tiles(*j_args)
    # the lane's letter, its interval (C), then one row pair a step
    report("extend_all", device_index.extend_all(*j_args), want,
           lambda: device_index.extend_all(*j_args),
           lambda: device_index.extend_all_plain(*j_args), touched,
           F * L * (1 + 12) + 4 * F,
           f"{F:,} fragments of the MEM batch as [{F:,}, {L}] codes, "
           f"{P:,} valid lanes, {steps:,} steps; the kernel's tiles "
           f"(j_tiles): {tiles:,} tiles of {mean_it:.2f} iterations "
           f"(largest {max_it}), {j_steps:,} steps; "
           f"{floor_note(row_rounds(touched, 2) + 2, lat_ns)}",
           call=(j_args, {}))
    del want, touched
    # H on the SA positions that the MEM -v path resolves first: each real
    # tie row's first max_match_ids + 6 (engine/mem_fast.py's chunk)
    chunk = cli_config("mem", True).max_match_ids + 6
    ts0, ts1 = stats[3].reshape(-1), stats[4].reshape(-1)
    real = (ts1 > ts0) & (ts1 < hybrid.VBASE)
    x = torch.arange(chunk, dtype=torch.int32, device=cuda)
    k = torch.unique((ts0[real][:, None] + x)[
        x < (ts1 - ts0)[real][:, None]]).to(torch.int32)
    h = (dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.nseq, dv.chpt_exp, k)
    out["sa_lookup (tie rows)"] = check_sa_lookup(
        h, lat_ns, f"{k.shape[0]:,} SA positions of the MEM batch's "
        f"{int(real.sum()):,} real tie rows (the first {chunk} of each)")
    inputs["sa_lookup (tie rows)"] = (dv, h, {}, k.shape[0] * (4 + 8 + 8),
                                      out["sa_lookup (tie rows)"][-1])
    B, S = rf_rows.shape
    virt = 0 if sw_ids is None else int((stats[3] >= hybrid.VBASE).sum())
    for suffix, tax in trees.items():
        # rf_rows, then maxl, then the tie ranges
        tail_report("read_lca" + suffix, classify.read_lca,
                    classify.read_lca_plain,
                    (*stats[:2], *stats[3:], rf_rows, dv.rec, dv.C,
                     dv.sa_seq, dv.sa_off, *tax, MemPipeline.R_BUDGET, 20,
                     dv.nseq, dv.chpt_exp), {"sw_ids": sw_ids},
                    4 * B * S + 16 * B + F * (8 + 8 * T),
                    f"{B:,} reads, {virt:,} virtual tie rows", 3)

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

    for suffix, tax in trees.items():
        tail_report("ranges_lca" + suffix, classify.ranges_lca,
                    classify.ranges_lca_plain,
                    (found[2], found[3], dv.rec, dv.C, dv.sa_seq, dv.sa_off,
                     *tax, GreedyPipeline.R_BUDGET, 20, dv.nseq,
                     dv.chpt_exp), {"sw_ids": found[4]},
                    8 * B * T + 16 * B,
                    f"{B:,} reads, {int((found[0] > 0).sum()):,} with a best",
                    1)
    torch.cuda.synchronize()
    del dv, screens
    torch.cuda.empty_cache()
    return out, inputs


def j_tiles(rec, C, codes, flen, lanes=64):
    """Kernel J's tiles (csrc/extend_all.cu) stepped as its plain rank
    steps them, all tiles at once: the valid lanes of the fragments packed
    into tiles of `lanes`, whole fragments while they fit (the kernel's
    cut, over all fragments rather than each block's), each lane merging
    where it reaches the interval that the last unmerged lane to its left
    had at the same position.  Returns (tiles, iterations a tile: mean,
    largest; the steps taken)."""
    import numpy as np
    import torch

    from kaiju_tpu_torch.ops import device_index

    F, L = codes.shape
    fl = torch.clamp(flen.long(), 0, L).cpu().numpy()
    first = np.concatenate([[0], np.cumsum(fl)])
    cut, at, q = [], 0, 0  # the tiles' first lanes
    while at < first[-1]:
        while first[q + 1] <= at:
            q += 1
        e = q
        while e < F and first[e + 1] - at <= lanes:
            e += 1
        cut.append(at)
        at = first[e] if e > q else min(at + lanes, first[-1])
    if not cut:
        return 0, 0.0, 0, 0
    dev = codes.device
    lane = torch.arange(int(first[-1]), device=dev)
    f = torch.from_numpy(np.repeat(np.arange(F), fl)).to(dev)
    j = lane - torch.from_numpy(first[:-1]).to(dev)[f]
    cut = torch.tensor(cut, device=dev)
    tile = torch.searchsorted(cut, lane, right=True) - 1
    slot = lane - cut[tile]
    row = codes.reshape(-1).long()
    base = f * L
    c = row[base + j]
    s0, s1, i = C[c].long(), C[c + 1].long(), j.clone()
    n, nt = lane.shape[0], cut.shape[0]
    t0 = torch.zeros((nt, lanes), dtype=torch.long, device=dev)
    t1 = torch.zeros_like(t0)
    who = torch.full_like(t0, -1)
    t0[tile, slot], t1[tile, slot], who[tile, slot] = s0, s1, slot
    active = torch.ones(n, dtype=torch.bool, device=dev)
    stop = torch.zeros(n, dtype=torch.long, device=dev)
    steps, k = 0, 0
    while bool(active.any()):
        go = torch.nonzero(active & (i > 0)).squeeze(1)
        x = row[base[go] + i[go] - 1].int()
        n0 = device_index.rank(rec, C, x, s0[go].int()).long()
        n1 = device_index.rank(rec, C, x, s1[go].int()).long()
        steps += go.numel()
        ok = torch.zeros(n, dtype=torch.bool, device=dev)
        ok[go] = n0 < n1
        stop[active & ~ok] = k
        active &= ok
        g = go[(n0 < n1)]
        s0[g], s1[g], i[g] = n0[n0 < n1], n1[n0 < n1], i[g] - 1
        ps = slot[g] - (j[g] - i[g])
        g, ps = g[ps >= 0], ps[ps >= 0]
        tg = tile[g]
        merged = ((who[tg, ps] >= 0) & (t0[tg, ps] == s0[g])
                  & (t1[tg, ps] == s1[g]))
        active[g[merged]] = False
        stop[g[merged]] = k
        w, pw = g[~merged], ps[~merged]
        t0[tile[w], pw], t1[tile[w], pw] = s0[w], s1[w]
        who[tile[w], pw] = slot[w]
        k += 1
    iters = torch.zeros(nt, dtype=torch.long, device=dev)
    iters.scatter_reduce_(0, tile, stop + 1, reduce="amax")
    return nt, float(iters.float().mean()), int(iters.max()), steps


def lane_meetings(rec, C, flat, base, pos, sub, start_i, s0, s1, act):
    """Kernel I's lanes stepped as its plain version steps them, round by
    round: (the lanes that reach a state (base, i, s0, s1) that another
    lane reached in an earlier round, or in the same round with a lower
    index; the rounds they take after it; the launch's longest chain in
    rounds if each of them stopped there).  Lanes in one state extend
    alike from it, so this is what merging I's lanes, as J merges its
    lanes, would save."""
    import numpy as np
    import torch

    from kaiju_tpu_torch.ops import device_index

    i, a0, a1 = start_i.clone(), s0.clone(), s1.clone()
    live = torch.nonzero(act & (i > 0)).squeeze(1)
    states, rnd = [], 0  # (lane, round, base, i, s0, s1) at each round's top
    while live.numel():
        states.append(torch.stack([live, torch.full_like(live, rnd)] + [
            t[live].long() for t in (base, i, a0, a1)], 1).cpu())
        x = i[live] - 1
        c = torch.where(x == pos[live], sub[live],
                        flat[(base[live] + x).long()].to(torch.int32))
        n0 = device_index.rank(rec, C, c, a0[live])
        n1 = device_index.rank(rec, C, c, a1[live])
        ok = n0 < n1
        live = live[ok]
        a0[live], a1[live], i[live] = n0[ok], n1[ok], x[ok]
        live = live[i[live] > 0]
        rnd += 1
    if not states:
        return 0, 0, 0
    st = torch.cat(states).numpy()
    st = st[np.lexsort((st[:, 0], st[:, 1], st[:, 5], st[:, 4], st[:, 3],
                        st[:, 2]))]
    later = np.zeros(st.shape[0], dtype=bool)
    later[1:] = (st[1:, 2:] == st[:-1, 2:]).all(1)
    n = start_i.shape[0]
    rounds = np.zeros(n, dtype=np.int64)
    np.maximum.at(rounds, st[:, 0], st[:, 1] + 1)
    meet = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(meet, st[later, 0], st[later, 1])
    met = meet < rounds
    return (int(met.sum()), int((rounds - meet)[met].sum()),
            int(np.where(met, meet, rounds).max()))


def longest_fragment(i, s0, s1, frag_off, lmap):
    """Kernel K's arguments (i, s0, s1, frag_off, lmap) cut to the longest
    fragment of frag_off alone: the shape of the Greedy -v pipeline's lazy
    launch of one fragment."""
    import torch

    f = int(torch.argmax(frag_off[1:] - frag_off[:-1]))
    a, b = int(frag_off[f]), int(frag_off[f + 1])
    return (i[a:b].contiguous(), s0[a:b].contiguous(), s1[a:b].contiguous(),
            torch.tensor([0, b - a], dtype=torch.int32,
                         device=frag_off.device), lmap)


def check_verbose_kernels(index, nodes, reads, ktx_dir, lat_ns: float):
    """H, I and K against their plain versions on the inputs the -v paths
    give them, on the index at ktx_dir: one batch through each -v
    pipeline on the card records the first launch of H (MEM: the SA
    positions of the batch's ties), K (Greedy: B's lanes, Lmap 7) and I
    (Greedy: the first co-simulation round's variant lanes).  I runs its
    code-row form on the same lanes too (each lane's parent codes with
    its substitution), which must agree; K runs on the batch's longest
    fragment alone too ("greedy_map (one fragment)"), and its rows must
    equal the plain version's row for row.  Same tuples as check_kernels,
    with I's and K's latency floors; I's note also counts its lanes'
    meetings (lane_meetings)."""
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
    out["sa_lookup"] = check_sa_lookup(
        h, lat_ns, f"{h[-1].shape[0]:,} SA positions of the MEM -v batch's "
        "ties")
    inputs["sa_lookup"] = (mem_pipe.dev, h, {}, h[-1].shape[0] * (4 + 8 + 8),
                           out["sa_lookup"][-1])

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
    meet, saved, longest = lane_meetings(*i_args)
    # the lane, its first letter, then one row pair a step
    report("extend_from", got, want, lambda: device_index.extend_from(*i_args),
           lambda: device_index.extend_from_plain(*i_args), touched,
           n * (25 + 12) + steps + n,
           f"{n:,} variant lanes of the first Greedy -v round, {steps:,} "
           f"steps; the code-row form agrees; {meet:,} lanes meet an "
           f"earlier lane's (base, i, s0, s1), {saved:,} rounds after it, "
           f"the longest chain {longest} rounds with them stopped there; "
           f"{floor_note(row_rounds(touched, 2) + 2, lat_ns)}",
           call=(i_args, {}))

    # K on B's lanes of the Greedy batch and on its longest fragment alone
    # (the lazy launch of one fragment): i of every lane, s0 and s1 of
    # each lane that makes a row, and the rows
    li, _s0, _s1, off, lmap = seen["greedy_map"]
    P, F = li.shape[0], off.shape[0] - 1
    one = longest_fragment(*seen["greedy_map"])
    for name, k_args, what in (
            ("greedy_map", seen["greedy_map"],
             f"{P:,} lanes of {F:,} fragments (mean {P / max(F, 1):.1f} "
             "positions) of the Greedy -v batch"),
            ("greedy_map (one fragment)", one,
             f"the batch's longest fragment alone, {one[0].shape[0]} "
             "lanes")):
        rows, n_rows = search.greedy_map(*k_args)
        want, n_want = search.greedy_map_plain(*k_args)
        nr = int(n_rows)
        if nr != int(n_want):
            raise AssertionError(f"K: {nr} rows, the plain version "
                                 f"{int(n_want)}")
        p, f = k_args[0].shape[0], k_args[3].shape[0] - 1
        # the fragment's start, its lanes' i, the rows' offset (the
        # predecessors' status words), the rows' s0 and s1
        report(name, rows[:nr], want,
               lambda a=k_args: search.greedy_map(*a),
               lambda a=k_args: search.greedy_map_plain(*a), [],
               4 * p + 4 * (f + 1) + (8 + 20) * nr + 4,
               f"{what}, Lmap {lmap}, {nr:,} rows (compared row for row); "
               f"{floor_note(4, lat_ns, 'loads')}", call=(k_args, {}))
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
           "update_si_letters": (device_index.update_si_letters,
                                 device_index.update_si_letters_plain),
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
    traced by `prof` (torch.profiler, card only), its `top` kernels, and
    the total of every row of each kernel of PASSES."""
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
    for kname, syms in PASSES.items():  # every row of a kernel of passes
        mine = {s: [r for r in rows if s in r.key] for s in syms}
        if not any(mine.values()):
            continue
        us = {s: sum(r.self_device_time_total for r in v)
              for s, v in mine.items()}
        log(f"steady {name}: kernel {kname} {sum(us.values()) / 1e3:.3f} ms "
            "(" + ", ".join(f"{s} {us[s] / 1e3:.3f} ms x"
                            f"{sum(r.count for r in mine[s])}"
                            for s in syms) + ")")
    sets = [r for r in rows if r.key.startswith("Memset")]
    if sets:
        us = sum(r.self_device_time_total for r in sets)
        log(f"steady {name}: memsets {us / 1e3:.3f} ms "
            f"x{sum(r.count for r in sets)} (G's counters among them)")


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


def x_kernel_checks(first, name, lat_ns: float):
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
            f"{name}: the warm-up's first length group, [{F:,}, {L}] codes; "
            f"{floor_note(row_rounds(touched, 2) + 2, lat_ns)}")
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
            f"{L}] code rows, {steps:,} steps; "
            f"{floor_note(row_rounds(touched, 2) + 2, lat_ns)}")
    if "update_si" in first:
        a = first["update_si"]
        n = a[2].shape[0]
        touched = []
        want = dvi.update_si_plain(*a, touched)
        out["update_si"] = measure(
            dvi.update_si(*a), want, lambda: dvi.update_si(*a),
            lambda: dvi.update_si_plain(*a), touched, n * (12 + 9),
            f"{name}: the first round's {n:,} probes, "
            f"{int((a[4] == a[3]).sum()):,} on empty intervals; "
            f"{floor_note(2, lat_ns, 'loads')}")
    if "sa_lookup" in first:
        a = first["sa_lookup"]
        out["sa_lookup"] = check_sa_lookup(
            a, lat_ns, f"{name}: the first round's {a[-1].shape[0]:,} SA "
            "positions")
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


def run_taxfree(index, ktx, items, fq, name, lat_ns: float):
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
    checks = x_kernel_checks(first, name, lat_ns)
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


def mesh_fastq(reads, ktx, n: int = MESH_READS) -> str:
    """The first n reads as a FASTQ beside the index at ktx."""
    from kaiju_tpu_torch.tools import readgen

    fq = os.path.join(os.path.dirname(ktx), f"reads_{n}.fastq")
    if not os.path.exists(fq):
        readgen.write_fastq([(r, q) for r, q, _ in reads[:n]], fq)
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


def batch_codes(reads, dev):
    """The fragments of the first MEM batch as J takes them: (codes uint8
    [F, L], 0-padded, flen int32 [F]) on dev."""
    import numpy as np
    import torch

    from kaiju_tpu_torch.engine.fragments_native import NativeFragmenter2
    from kaiju_tpu_torch.engine.mem import MemPipeline
    from kaiju_tpu_torch.engine.pipeline import _bucket

    frag = NativeFragmenter2("mem", 11, 65, True, False)
    flat, _chars, off, nf, _k, _rf, _o = frag.run(
        reads[:BATCH], MemPipeline.S_SLOTS, _bucket)
    flen = np.diff(off[:nf + 1]).astype(np.int32)
    codes = np.zeros((nf, int(flen.max())), dtype=np.uint8)
    for t in range(nf):
        codes[t, :flen[t]] = flat[off[t]:off[t + 1]]
    return torch.from_numpy(codes).to(dev), torch.from_numpy(flen).to(dev)


def run_sharded_primitives(index, reads, n_shards):
    """The sharded primitives of item 10a, which no CLI path reaches yet
    (--mesh-index with -v or a taxonomy-free tool raises): on the index in
    n_shards shards, sharded_extend_all (J) over the fragments of the first
    MEM batch as a padded code matrix, then sharded_sa_lookup (H) on the
    first SA position of every lane's match.  Counts from 0; then each
    output must equal the unsharded kernel's.  Returns the launch counts."""
    import torch

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.ops import device_index
    from kaiju_tpu_torch.parallel.sharded_index import (ShardedIndex,
                                                        sharded_extend_all,
                                                        sharded_sa_lookup)

    cuda = torch.device("cuda")
    codes, flen = batch_codes(reads, cuda)
    nf = codes.shape[0]
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


_SPIED: list = []  # (module, name, wrapper) that spy_first_calls replaced


def spy_first_calls(mode: str, only=None) -> dict:
    """Wrap the kernel wrappers of the path `mode` where its pipeline
    looks them up (A where the seed tables are built), so that each keeps
    the arguments of its first call (of the first for which only() is
    true, if given): {kernel: (wrapper, plain version, args, kwargs)},
    filled as the run goes; unspy() puts the wrappers back."""
    from kaiju_tpu_torch.ops import (classify, device_index, greedy, hybrid,
                                     kmer, search)

    where = {"update_si_letters": (kmer,
                                   device_index.update_si_letters_plain)}
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
            if only is None or only():
                first.setdefault(_name, (_fn, _plain, args, kw))
            return _fn(*args, **kw)

        _SPIED.append((mod, name, getattr(mod, name)))
        setattr(mod, name, wrap)
    return first


def unspy() -> None:
    """Undo spy_first_calls."""
    while _SPIED:
        mod, name, fn = _SPIED.pop()
        setattr(mod, name, fn)


def check_first_calls(first: dict, dev) -> dict:
    """Each kernel of `first` (spy_first_calls) on the arguments of its
    first call, whose Shards hold the shards mapped from the peer process
    (or held by another card of this process, phase 4i): launched again,
    it must equal its plain version on the same Shards (on copies made
    here of the shards that lie on another card, which the plain versions
    refuse) and its launch on a Shards of copies of every shard in this
    card's own memory; both launches timed.  Returns {kernel: {"err",
    "ms" (mapped shards), "ms_local" (own copies), "opened" (shards read
    from a peer)}}."""
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
            "opened": max((len(sh.peer) for sh, _c in found.values()),
                          default=0)}
        del found, largs, lkw
        torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def kaiju_worker(counts_path: str, argv: list) -> int:
    """One process of a phase 4f run: tools.kaiju.main(argv) on this
    process's cards (the --dist-* flags in argv; phase 4j puts `--host
    NAME` first, the process's host label, and then process 0 checks the
    hosts kernels instead, check_hosts_calls, and the exchange's counts
    are reported; `--cards c0,c1` next gives main() those cards, else the
    process takes its share of the machine's, multihost.process_cards;
    `--transport gloo` between them replaces the rule that picks the
    rounds' transport, exchange.backend_for, as --host replaces
    host_name: the gloo twin of an NCCL run).
    Right after set-up (the runner made, its seconds kept) every process
    waits for the others and reads the card's used memory; with
    --mesh-index it reports the shards each of its cards holds and maps
    (ShardedIndex.layout), and process 0 keeps the arguments of each
    kernel's first call on its first card, which it checks after main()
    (check_first_calls), while the mapped shards are still open: they are
    released when the process leaves its group, at exit.  Writes its exit
    code, cards, launch counts (main()'s only), seconds, memory, layouts,
    rounds and checks to counts_path as JSON."""
    import threading

    import torch
    import torch.distributed as dist

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.engine.pipeline import CardShare
    from kaiju_tpu_torch.parallel import exchange, peer_shards
    from kaiju_tpu_torch.tools import kaiju

    host = cards = None
    if argv[:1] == ["--host"]:  # phase 4j: this process's host label
        host = argv[1]
        argv = argv[2:]
        peer_shards.host_name = lambda: host
    if argv[:2] == ["--transport", "gloo"]:  # 4j: an NCCL run's twin
        argv = argv[2:]
        exchange.backend_for = lambda slots: "gloo"
    if argv[:1] == ["--cards"]:
        cards = argv[1].split(",")
        argv = argv[2:]
    mesh = "--mesh-index" in argv
    pid = int(argv[argv.index("--dist-pid") + 1])

    def first_card():  # the set-up (main thread) and card 0's thread
        return threading.current_thread().name in ("MainThread", "card0_0")

    first = {}
    if host is not None:  # every process: the hybrid's tallies
        info_work = tally_hosts_work()
    if host is not None:  # every process counts its forms' launches
        first = spy_hosts_calls("mem" if "mem" in argv else "greedy",
                                only=first_card if pid == 0
                                else (lambda: False))
    elif mesh and pid == 0:
        first = spy_first_calls("mem" if "mem" in argv else "greedy",
                                only=first_card)
    info = {}
    make_runner = kaiju.make_runner

    def keep(*args, **kw):
        t0 = time.perf_counter()
        info["runner"] = runner = make_runner(*args, **kw)
        info["setup"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        if dist.is_initialized():
            dist.barrier()  # every process set up
        free, total = torch.cuda.mem_get_info()
        info["card_used"] = total - free
        info["allocated"] = torch.cuda.memory_allocated()
        return runner

    kaiju.make_runner = keep
    kernels.reset_counts()
    t0 = time.perf_counter()
    rc = kaiju.main(argv, device=cards)
    runner = info.pop("runner")
    share = getattr(runner, "pipe", runner)  # one process: no ProcessShare
    pipes = share.pipes if isinstance(share, CardShare) else [share]
    for dev in dict.fromkeys(p.device for p in pipes):
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)  # before the checks' launches
    info["cards"] = [str(p.device) for p in pipes]
    if mesh:
        info["layout"] = [p.dev.layout() for p in pipes]
    if host is not None:
        info["work"] = dict(info_work)  # before the checks' launches
        info["forms"] = dict(FORM_LAUNCHES)
        info["rounds"] = exchange.COUNTS
        info["card_rounds"] = [p.dev.exchange.counts if p.dev.exchange
                               else {} for p in pipes]
        info["backends"] = [p.dev.exchange.backend if p.dev.exchange
                            else None for p in pipes]
        info["checks"] = check_hosts_calls(
            first, timed=os.environ.get("CHIP_SMOKE_TIMED") == "1")
    else:
        info["checks"] = check_first_calls(first, pipes[0].device)
    with open(counts_path, "w") as fh:
        json.dump({"rc": rc, "device": str(torch.cuda.current_device()),
                   "launches": launches, "seconds": seconds, **info}, fh)
    return rc


def worker_cards(p: int, nprocs: int, per: int):
    """The `--cards` of process p of nprocs on `per` > 1 cards each: on a
    machine with nprocs per cards or more, cards per p to per p + per - 1;
    else its card p mod cards, `per` times (two data rows on one card).
    None for per = 1: the process takes its share of the machine's cards
    (multihost.process_cards), dealt_cards."""
    import torch

    if per == 1:
        return None
    n = torch.cuda.device_count()
    if n >= nprocs * per:
        return [f"cuda:{per * p + i}" for i in range(per)]
    return [f"cuda:{p % n}"] * per


def dealt_cards(p: int, nprocs: int) -> list:
    """The cards process p of nprocs on this machine takes when it is
    given none, restated from multihost.deal_cards: cards // nprocs each,
    or card p mod cards where the processes outnumber the cards."""
    import torch

    n = torch.cuda.device_count()
    if nprocs > n:
        return [f"cuda:{p % n}"]
    k = n // nprocs
    return [f"cuda:{p * k + i}" for i in range(k)]


def transport_rule(slots: list) -> str:
    """The transport of the rounds of a group whose process p runs on the
    cards slots[p] ("cuda:i" on this machine), restated from
    exchange.backend_for: NCCL where every slot is a card and no two
    slots share one, else gloo."""
    cards = [c for cs in slots for c in cs]
    if all(c.startswith("cuda:") for c in cards) and \
            len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def slot_rule(g: int, hosts: str, per: int, n_shards: int):
    """The slot rules (parallel.peer_shards), restated from held_by_rule:
    (held, {shard: card of its process it is read from}, {shard: slot of
    another process of its host it is mapped from}, {shard: process that
    serves it in rounds}) for slot g = p per + c of a group of processes
    on hosts (one letter a process), each on `per` cards."""
    G = len(hosts) * per
    p = g // per
    reads, opened, remote = {}, {}, {}
    for o in range(n_shards):
        if o in held_by_rule(g, G, n_shards):
            continue
        holders = [h for h in range(G) if o in held_by_rule(h, G, n_shards)]
        own = [h for h in holders if h // per == p]
        near = [h for h in holders if hosts[h // per] == hosts[p]]
        if own:
            reads[o] = (o % G if o % G in own else min(own)) - p * per
        elif near:
            opened[o] = o % G if o % G in near else min(near)
        else:
            remote[o] = (o % G) // per
    return held_by_rule(g, G, n_shards), reads, opened, remote


def check_slots(name: str, p: int, got: dict, hosts: str, per: int,
                n_shards: int) -> None:
    """Process p's report: its cards must be worker_cards' (or, for per =
    1, dealt_cards'), and each must hold, read, map and have served the
    shards of the slot rules."""
    want = (worker_cards(p, len(hosts), per)
            or dealt_cards(p, len(hosts)))
    if got["cards"] != want:
        raise AssertionError(f"{name} process {p}: cards {got['cards']}, "
                             f"expected {want}")
    per = len(want)
    for c, lay in enumerate(got.get("layout", ())):
        held, reads, opened, remote = slot_rule(p * per + c, hosts, per,
                                                n_shards)
        mine = (lay["held"], {int(o): h for o, h in lay["reads"].items()},
                {int(o): h for o, h in lay["opened_slot"].items()},
                {int(o): q for o, q in lay["remote"].items()})
        if mine != (held, reads, opened, remote):
            raise AssertionError(
                f"{name} process {p} card {c}: holds, reads, maps, served "
                f"{mine}; the slot rules give {held, reads, opened, remote}")


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


def run_processes(index, reads, ktx, nodes, mode, n_shards, base_tsv,
                  per=1, nprocs=NPROCS, one_process=True):
    """tools.kaiju.main on the path `mode` (with --mesh-index n_shards if
    given) as nprocs processes (--dist-nprocs, a coordinator on 127.0.0.1,
    --dist-pid p, each with its own -o and seed-table cache), each on
    `per` cards (worker_cards; with one card a process, its share of the
    machine's cards, dealt_cards), on the first MESH_READS reads: each
    process must launch every kernel of its path on its cards, each read
    must be in exactly one output, the one its batch share names, and the
    lines merged by read must equal phase 4's lines (base_tsv).  With
    --mesh-index each card must hold, read and map exactly the shards of
    the slot rules (check_slots), and each kernel of the path must equal
    its plain version on process 0's first call on its first card, on the
    shards read and mapped there (check_first_calls).  Then, where
    one_process, the one-process main() of the same reads, timed beside
    the processes' wall.  Returns the launch counts of all the processes,
    each process's report and the stream's rate after set-up (the slowest
    process)."""
    import torch

    from kaiju_tpu_torch.parallel.multihost import local_rows
    from kaiju_tpu_torch.tools import kaiju

    work = os.path.dirname(ktx)
    mesh = ["--mesh-index", str(n_shards)] if n_shards else []
    name = (f"{mode}{' --mesh-index %d' % n_shards if n_shards else ''}"
            f"{', %d cards a process' % per if per > 1 else ''}")
    fq = mesh_fastq(reads, ktx)
    argv = ["-t", nodes, "-f", ktx, "-i", fq, *PATHS[mode][1], *mesh,
            "-b", str(BATCH)]
    coord = f"127.0.0.1:{free_port()}"
    outs, counts, logs, procs = [], [], [], []
    tag = f"{mode}_mesh{n_shards}_{nprocs}x{per}"
    gc.collect()  # this process's cached card memory, out of the readings
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        for p in range(nprocs):
            outs.append(os.path.join(work, f"out_procs_{tag}_p{p}.tsv"))
            counts.append(os.path.join(work, f"counts_{tag}_p{p}.json"))
            logs.append(open(os.path.join(work, f"log_{tag}_p{p}.txt"), "w"))
            env = dict(os.environ, KAIJU_TPU_CACHE=fresh_cache(
                ktx, os.path.join(work, f"cache_{tag}_p{p}")))
            cards = worker_cards(p, nprocs, per)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--kaiju-worker",
                 counts[p], *(["--cards", ",".join(cards)] if cards else []),
                 *argv, "-o", outs[p], "--dist-nprocs", str(nprocs),
                 "--dist-coordinator", coord, "--dist-pid", str(p)],
                env=env, stdout=logs[p], stderr=subprocess.STDOUT))
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
        raise AssertionError(f"{name} x{nprocs}: exit codes {rcs}")
    path = kernels_of(mode, index.text is not None, bool(n_shards))
    launches = {k: 0 for k in REPLACES}
    reports = []
    for p, cpath in enumerate(counts):
        with open(cpath) as fh:
            got = json.load(fh)
        reports.append(got)
        idle = [k for k in path if got["launches"][k] <= 0]
        stray = [k for k in REPLACES if k not in path and got["launches"][k]]
        log(f"e2e {name} process {p} of {nprocs}: {','.join(got['cards'])}, "
            f"{got['seconds']:.2f} s in main() (set-up {got['setup']:.2f} s);"
            f" card memory used after set-up {got['card_used']:,} bytes "
            f"(this process's caching allocator {got['allocated']:,}); "
            f"launches {json.dumps(got['launches'])}")
        if idle or stray:
            raise AssertionError(f"{name} process {p}: kernels that did not "
                                 f"launch {idle}, others {stray}")
        check_slots(name, p, got, "a" * nprocs, per, n_shards)
        for k in launches:
            launches[k] += got["launches"][k]
        if not n_shards:
            continue
        for c, lay in enumerate(got["layout"]):
            log(f"shards {name} process {p} card {c} ({lay['card']}): holds "
                f"{lay['held']} ({json.dumps(lay['bytes_held'])} bytes, "
                f"outside the caching allocator), reads " + ", ".join(
                    f"{o} from card {h}" for o, h in lay["reads"].items())
                + " (" + json.dumps(lay["bytes_read"]) + " bytes), maps "
                + ", ".join(f"{o} from process {q}"
                            for o, q in lay["opened"].items())
                + f" ({json.dumps(lay['bytes_opened'])} bytes)")
        for k, c in got["checks"].items():
            log(f"kernel {k} [{name}, process {p}, {c['opened']} of "
                f"{n_shards} shards read or mapped from another card or "
                f"process]: max_abs_err {c['err']} against its plain version "
                f"and its launch on copies in this process; {c['ms']:.4f} ms "
                f"on those shards, {c['ms_local']:.4f} ms on the copies "
                f"({c['ms'] / c['ms_local'] - 1:+.1%})")
        unchecked = [k for k in path if p == 0 and k not in got["checks"]]
        if unchecked or any(c["err"] for c in got["checks"].values()):
            raise AssertionError(f"{name} process {p}: kernels unchecked "
                                 f"{unchecked} or differing from their plain "
                                 "versions on the mapped shards")
    if n_shards:
        lays = [lay for r in reports for lay in r["layout"]]
        held = sum(sum(lay["bytes_held"].values()) for lay in lays)
        whole = sum(lays[0]["bytes_held"].values()) + sum(
            lays[0]["bytes_read"].values()) + sum(
            lays[0]["bytes_opened"].values())
        log(f"shards {name} x{nprocs}: the index shards (rec, SA samples, "
            f"text) take {held:,} bytes of card memory held apart, against "
            f"{len(lays) * whole:,} as {len(lays)} whole copies (every card "
            "holding all the shards)")

    names = [n for n, _q, _r in reads[:MESH_READS]]
    owner = {}
    for b0 in range(0, MESH_READS, BATCH):
        for p in range(nprocs):
            lo, hi = local_rows(min(BATCH, MESH_READS - b0), nprocs, p)
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
    stream = max(r["seconds"] - r["setup"] for r in reports)
    one, rc = float("nan"), 0
    if one_process:
        fq_cache = fresh_cache(ktx, os.path.join(work, f"cache_{tag}_one"))
        os.environ["KAIJU_TPU_CACHE"] = fq_cache
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rc = kaiju.main(argv + ["-o", os.path.join(
                work, f"out_one_{tag}.tsv")])
            torch.cuda.synchronize()
            one = time.perf_counter() - t1
        finally:
            del os.environ["KAIJU_TPU_CACHE"]
    log(f"e2e {name} x{nprocs} on " + ",".join(
        sorted({c for r in reports for c in r["cards"]})) + f": "
        f"{MESH_READS:,} reads, {len(lines):,} written once each, {same:,} "
        f"equal to phase 4's lines; wall {wall:.2f} s for the processes "
        f"(start-up, index load, seed tables and classification), the "
        f"stream after set-up {stream:.3f} s = {MESH_READS / stream:,.1f} "
        f"reads/s (the slowest process), against {one:.2f} s for the "
        "one-process main() in this process")
    if rc != 0 or len(lines) != MESH_READS or same != MESH_READS:
        raise AssertionError(f"{name} x{nprocs}: the merged lines differ "
                             "from phase 4's")
    return launches, reports, MESH_READS / stream


def run_phase_4f(index, reads, ktx, nodes, tsvs, smi: str) -> dict:
    """Phase 4f: run_processes for each of PROC_RUNS on the text index
    (ktx), held against phase 4's lines tsvs[mode]["text"]; prints the
    cards used and the card memory after set-up.  Where there are four
    cards, the same Greedy reads at --mesh-index 4 over the four cards in
    each of LAYOUTS, the stream's rate of each (no gain is claimed: every
    single-host cell is host-bound).  Returns the launch counts of all the
    runs."""
    import torch

    cards = torch.cuda.device_count()
    log(f"4f: {cards} card(s); with no --cards a process takes its share "
        "of them (process_cards): " + (
            "processes map their peers' shards over NVLink from other cards"
            if cards > 1 else "one card, so the processes map each other's "
            "shards on cuda:0 and a process's two cards are two data rows "
            "there; the cross-card form (over NVLink) was not run"))
    launches = {k: 0 for k in REPLACES}
    used = {}
    for n_shards, mode, per in PROC_RUNS:
        counts, reports, _rate = run_processes(
            index, reads, ktx, nodes, mode, n_shards, tsvs[mode]["text"], per)
        for k, c in counts.items():
            launches[k] += c
        used[mode, n_shards, per] = max(r["card_used"] for r in reports)
    log("4f: card memory used after set-up, the larger of the processes' "
        "readings: " + "; ".join(
            f"{mode} {'--mesh-index %d' % n if n else 'one index'}"
            f"{' (%d cards a process)' % per if per > 1 else ''} {b:,} bytes"
            for (mode, n, per), b in used.items()))
    if cards >= 4:
        rates = {}
        for nprocs, per in LAYOUTS + LAYOUTS[::-1]:
            counts, _r, rate = run_processes(
                index, reads, ktx, nodes, "greedy", 4, tsvs["greedy"]["text"],
                per, nprocs, one_process=False)
            for k, c in counts.items():
                launches[k] += c
            rates.setdefault((nprocs, per), []).append(rate)
        log("4f layouts on 4 cards, Greedy --mesh-index 4, the stream after "
            f"set-up on the same {MESH_READS:,} reads (turns: each layout, "
            "then again in reverse order): " + "; ".join(
                f"{n} x {per}: " + ", ".join(f"{r:,.1f}" for r in v)
                + " reads/s" for (n, per), v in rates.items()) + f" [{smi}]")
    return launches


# ---------------------------------------------------------------------------
# phase 4i: the index over the cards of one process
# ---------------------------------------------------------------------------


def card_list() -> list:
    """Phase 4i's cards: every visible card; on a machine with one card
    ["cuda:0", "cuda:0"], two data rows there and no peer read."""
    import torch

    n = torch.cuda.device_count()
    return ([f"cuda:{i}" for i in range(n)] if n > 1
            else ["cuda:0", "cuda:0"])


def sync_cards(cards) -> None:
    import torch

    for i in sorted({torch.device(c).index for c in cards}):
        torch.cuda.synchronize(i)


def check_library_devices(cards) -> None:
    """Under torch.cuda.device(i), every kernel library's runtime must
    take card i as current (kernels.library_device: its cudaGetDevice),
    which is what lets kernels.launch put a kernel on its tensors' card
    from any thread."""
    import torch

    from kaiju_tpu_torch import kernels

    ids = sorted({torch.device(c).index for c in cards}, reverse=True)
    bad = []
    for i in ids:
        with torch.cuda.device(i):
            bad += [(src, i, got) for src in kernels.SOURCES
                    if (got := kernels.library_device(src)) != i]
    log(f"4i runtime: under torch.cuda.device(i) for i in {ids}, "
        f"cudaGetDevice in each of the {len(kernels.SOURCES)} libraries "
        f"(nvcc's static runtime) gave i: {'yes' if not bad else bad}")
    if bad:
        raise AssertionError(f"4i: a library's current card does not follow "
                             f"the device guard: {bad}")


def card_steady(runner, batches, warm, engine) -> float:
    """Seconds of a steady pass of `batches` through runner, warmed by one
    batch of other reads (host clock, every card synchronised)."""
    import torch

    runner.classify_batch(warm)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    engine.reset_counts()
    for pipe in getattr(runner, "pipes", [runner]):
        pipe.host_seconds.clear()
    t0 = time.perf_counter()
    n = sum(len(r) for r in runner.classify_stream(batches))
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    if n != sum(len(b) for b in batches):
        raise AssertionError("4i: a steady pass lost reads")
    return time.perf_counter() - t0


def card_primitives(index, reads, view, smi) -> dict:
    """J and H on card 0's view of the shards over the cards (the shards
    it does not hold read in place on their cards): equal to the
    unsharded kernels on card 0, and timed against the same launches on a
    copy of every shard on card 0.  Returns {kernel: error}."""
    from kaiju_tpu_torch.ops import device_index
    from kaiju_tpu_torch.parallel.sharded_index import (ShardedIndex,
                                                        sharded_extend_all,
                                                        sharded_sa_lookup)

    dev = view.device
    codes, flen = batch_codes(reads, dev)
    local = ShardedIndex(index, view.S, dev)
    dv = device_index.DeviceIndex(index, dev)
    maps = sharded_extend_all(view, codes, flen)
    k = maps[1][maps[2] > maps[1]]
    walks = sharded_sa_lookup(view, k)
    err = {"extend_all_sharded": max_abs_err(maps, device_index.extend_all(
        dv.rec, dv.C, codes, flen)), "sa_lookup_sharded": max_abs_err(
        walks, device_index.sa_lookup(dv.rec, dv.C, dv.sa_seq, dv.sa_off,
                                      dv.nseq, dv.chpt_exp, k))}
    ms = {"extend_all_sharded": [cuda_ms(lambda ix=ix: sharded_extend_all(
        ix, codes, flen)) for ix in (view, local)],
        "sa_lookup_sharded": [cuda_ms(lambda ix=ix: sharded_sa_lookup(ix, k))
                              for ix in (view, local)]}
    for name, (peer, own) in ms.items():
        log(f"4i kernel {name} [{view.S} shards, card {dev} reading "
            f"{sorted(view.reads)} in place on "
            f"{sorted({str(view.cards[c]) for c in view.reads.values()})}]: "
            f"max_abs_err {err[name]} against the unsharded kernel; "
            f"{peer:.4f} ms on the peer shards, {own:.4f} ms on copies on "
            f"{dev} ({peer / own - 1:+.1%}); J over [{codes.shape[0]:,}, "
            f"{codes.shape[1]}] codes, H on {k.shape[0]:,} positions [{smi}]")
    if any(err.values()):
        raise AssertionError(f"4i: J or H on peer shards differs: {err}")
    del local, dv
    return err


def run_cards(index, reads, ktx, nodes, mode, n_shards, base_tsv, cards,
              warm, smi):
    """kaiju --mesh-index n_shards on the path `mode` through
    tools.kaiju.main(..., device=cards) on the first MESH_READS reads of
    the text index (seed tables built afresh, by card 0 on its view): a
    CardShare of one pipeline a card, card c on local_rows(n, D, c) of
    each batch.  Each card must launch every kernel of the path (A on card
    0 alone, which builds the seed tables), no unsharded kernel may
    launch, each card must hold the shards of peer_shards.held(c, D, S)
    and read the others from their holders' cards, with layout()'s bytes,
    and the TSV must equal phase 4's lines byte for byte.  With S > 1
    each kernel of the path on card 0's first call is held against its
    plain version on copies and timed on the peer shards against copies
    on card 0 (check_first_calls), and at the most shards J and H too
    (card_primitives).  Then steady passes, one card (the sharded pipeline
    on cards[0]) and the cards in turns (one, cards, cards, one), with
    each card's host seconds by stage and set-up seconds.  Returns (launch
    counts, {kernel: error})."""
    import threading

    import torch

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.engine import greedy, mem
    from kaiju_tpu_torch.engine.pipeline import CardShare
    from kaiju_tpu_torch.io.taxonomy import Taxonomy, parse_nodes_dmp
    from kaiju_tpu_torch.parallel import peer_shards, sharded_fused
    from kaiju_tpu_torch.tools import kaiju

    engine = greedy if mode == "greedy" else mem
    Pipeline = (sharded_fused.ShardedGreedyPipeline if mode == "greedy"
                else sharded_fused.ShardedMemPipeline)
    D = len(cards)
    name = f"{mode} --mesh-index {n_shards} on {D} cards"
    path = kernels_of(mode, True, True)
    fq = mesh_fastq(reads, ktx)
    shutil.rmtree(os.path.join(ktx, "kmer5"), ignore_errors=True)
    out_tsv = os.path.join(os.path.dirname(ktx),
                           f"out_{mode}_cards{n_shards}.tsv")
    first = spy_first_calls(mode, only=lambda: threading.current_thread(
    ).name in ("MainThread", "card0_0")) if n_shards > 1 else {}
    box = {}
    make_runner = kaiju.make_runner

    def keep(*args, **kw):
        box["runner"] = make_runner(*args, **kw)
        return box["runner"]

    kaiju.make_runner = keep
    kernels.reset_counts()
    engine.reset_counts()
    try:
        sync_cards(cards)
        t0 = time.perf_counter()
        rc = kaiju.main(["-t", nodes, "-f", ktx, "-i", fq, *PATHS[mode][1],
                         "--mesh-index", str(n_shards), "-o", out_tsv,
                         "-b", str(BATCH)], device=cards)
        sync_cards(cards)
        dt = time.perf_counter() - t0
    finally:
        kaiju.make_runner = make_runner
        unspy()
    launches = dict(kernels.LAUNCHES)
    share = box.get("runner")
    if rc != 0 or not isinstance(share, CardShare):
        raise AssertionError(f"4i {name}: main returned {rc}, runner "
                             f"{type(share).__name__}")
    log(f"4i e2e {name} ({', '.join(str(c) for c in share.cards)}): "
        f"{MESH_READS:,} reads in {dt:.2f} s = {MESH_READS / dt:.1f} reads/s "
        f"with set-up (set-up seconds a card "
        f"{[round(x, 3) for x in share.setup_seconds]}); host replay "
        f"{engine.HOST_REPLAY['flagged']} reads; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    unsharded = [k for k in SHARDED if launches[k]]
    stray = [k for k in REPLACES if launches[k] and k not in path]
    problems = []
    if unsharded or stray:
        problems.append(f"unsharded kernels {unsharded}, others {stray}")
    for c, pipe in enumerate(share.pipes):
        mine = share.launches[c]
        need = [k for k in path if c == 0 or k != "update_si_letters_sharded"]
        idle = [k for k in need if mine.get(k, 0) <= 0]
        lay = pipe.dev.layout()
        held = peer_shards.held(c, D, n_shards)
        reads_from = {o: peer_shards.source(o, D) for o in range(n_shards)
                      if o not in held}
        placed = all(
            getattr(pipe.dev, a).parts[o].device == share.cards[
                reads_from.get(o, c)]
            for a in ("rec", "sa_seq", "sa_off", "text")
            for o in range(n_shards))
        sums = {a: sum(getattr(pipe.dev, a).parts[o].nbytes for o in held)
                for a in lay["bytes_held"]}
        log(f"4i card {c} ({share.cards[c]}) {name}: holds {lay['held']} "
            f"({json.dumps(lay['bytes_held'])} bytes), reads "
            + (", ".join(f"{o} from card {h}" for o, h in lay["reads"]
                         .items()) or "nothing")
            + f" ({json.dumps(lay['bytes_read'])} bytes); launches "
            f"{json.dumps(mine)}; host seconds in main() "
            f"{json.dumps({k: round(v, 3) for k, v in pipe.host_seconds.items()})}")
        if (idle or lay["held"] != held or lay["reads"] != reads_from
                or not placed or sums != lay["bytes_held"]):
            problems.append(f"card {c}: kernels that did not launch {idle}, "
                            f"holds {lay['held']} reads {lay['reads']} (the "
                            f"rule: {held}, {reads_from}), placed {placed}, "
                            f"bytes {sums} against {lay['bytes_held']}")
    for card in dict.fromkeys(share.cards):
        log(f"4i memory {name}: {card} allocated "
            f"{torch.cuda.memory_allocated(card):,} bytes")
    with open(out_tsv) as fh:
        got = fh.readlines()
    with open(base_tsv) as fh:
        want = [next(fh) for _ in range(MESH_READS)]
    same = sum(g == w for g, w in zip(got, want))
    log(f"4i check {name}: {same:,} of {MESH_READS:,} lines equal phase 4's "
        f"{mode} lines on db_text.ktx")
    if len(got) != MESH_READS or same != MESH_READS:
        problems.append("the TSV differs from phase 4's")
    if problems:
        raise AssertionError(f"4i {name}: " + "; ".join(problems))

    errs = {}
    for k, c in check_first_calls(first, share.cards[0]).items():
        errs[k] = c["err"]
        log(f"4i kernel {k} [{name}, card 0's first call, {c['opened']} of "
            f"{n_shards} shards read from other cards]: max_abs_err "
            f"{c['err']} against its plain version and its launch on copies "
            f"on {share.cards[0]}; {c['ms']:.4f} ms on the peer shards, "
            f"{c['ms_local']:.4f} ms on the copies "
            f"({c['ms'] / c['ms_local'] - 1:+.1%}) [{smi}]")
    unchecked = [k for k in path if n_shards > 1 and k not in errs]
    if unchecked or any(errs.values()):
        raise AssertionError(f"4i {name}: kernels unchecked {unchecked} or "
                             f"differing on the peer shards {errs}")
    if n_shards == max(CARD_SHARDS):
        errs.update(card_primitives(index, reads, share.pipes[0].dev, smi))

    tax = Taxonomy(parse_nodes_dmp(nodes))
    one = Pipeline(index, tax, cli_config(mode), n_shards,
                   device=share.cards[0], kmer_cache_dir=ktx)
    batches = [reads[i:i + BATCH] for i in range(0, MESH_READS, BATCH)]
    walls = {"one": [], "cards": []}
    for who in ("one", "cards", "cards", "one"):
        walls[who].append(card_steady(one if who == "one" else share,
                                      batches, warm, engine))
    share.close()
    rate = {k: [MESH_READS / w for w in v] for k, v in walls.items()}
    log(f"4i steady {name}: over the cards {rate['cards'][0]:.1f} and "
        f"{rate['cards'][1]:.1f} reads/s, one card ({share.cards[0]}) "
        f"{rate['one'][0]:.1f} and {rate['one'][1]:.1f} reads/s (turns: one, "
        f"cards, cards, one; {MESH_READS:,} reads in batches of {BATCH:,}, "
        f"untraced); the cards' last pass, host seconds a card by stage: "
        + "; ".join(f"card {c} " + json.dumps(
            {k: round(v, 3) for k, v in p.host_seconds.items()})
            for c, p in enumerate(share.pipes)) + f" [{smi}]")
    del one, share, box
    gc.collect()
    for card in dict.fromkeys(cards):
        with torch.cuda.device(card):
            torch.cuda.empty_cache()
    return {k: launches[k] for k in REPLACES}, errs


def run_cards_big(cards, smi) -> tuple[dict, dict]:
    """tools.big_classify.run over the cards at S = CARD_BIG_SHARDS on a DB
    of CARD_BIG_LETTERS letters (the demo's generator and seed, built
    here): shard o on card o mod D, the step on card 0; each run's
    sampled reads held to the host oracle lane for lane, L and M launched
    in each, S = 4's arrays equal to S = 2's; at the most shards L and M
    on the peer shards against their launches on copies of every shard on
    card 0 (timed) and the plain versions on the copies.  Returns (launch
    counts, {kernel: error})."""
    import copy

    import numpy as np
    import torch

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.ops import big_mem
    from kaiju_tpu_torch.ops.device_index import Shards
    from kaiju_tpu_torch.parallel.big_index import build_db
    from kaiju_tpu_torch.parallel.multihost import local_cards
    from kaiju_tpu_torch.tools import big_classify

    work = os.path.join(ROOT, "build", "chip_smoke", "big_cards")
    shutil.rmtree(work, ignore_errors=True)
    threads = os.cpu_count() or 1
    t0 = time.perf_counter()
    db = build_db(None, CARD_BIG_LETTERS, threads, BIG_SEED, True)
    log(f"4i big: built N = {db['N']:,} ({db['nseq']:,} sequences) in "
        f"{time.perf_counter() - t0:.1f} s on {threads} threads")
    devs = local_cards(cards)
    launches = {k: 0 for k in BIG_KERNELS}
    arrays, errs = {}, {}
    for S in CARD_BIG_SHARDS:
        out = os.path.join(work, f"s{S}")
        args = big_classify.parse_args([
            "--letters", str(CARD_BIG_LETTERS), "--threads", str(threads),
            "--shards", str(S), "--reads", str(BIG_READS),
            "--read-len", str(BIG_LEN), "--verify", str(BIG_VERIFY),
            "--allow-small", "--out", out, "--device", ",".join(cards)])
        kernels.reset_counts()
        res = big_classify.run(args, db=db)
        counts = {k: kernels.LAUNCHES[k] for k in BIG_KERNELS}
        for k, c in counts.items():
            launches[k] += c
        ix, secs = res["index"], res["seconds"]
        placed = all(p.device == devs[o % len(devs)] for sh in
                     (ix.rec, ix.sa_seq) for o, p in enumerate(sh.parts))
        log(f"4i big S = {S} on {len(devs)} cards: {res['summary']}; save "
            f"{secs['save']:.1f} s, load {secs['load']:.1f} s, card bytes "
            + ", ".join(f"{devs[c]} {b:,}" for c, b in
                        sorted(ix.card_bytes.items()))
            + f", shards read from other cards {sorted(ix.rec.peer)}; first "
            f"step {secs['first_step']:.2f} s, steady step "
            f"{secs['step']:.4f} s; launches {counts} [{smi}]")
        if (not all(counts.values()) or not placed
                or res["summary"]["verified"] != BIG_VERIFY):
            raise AssertionError(f"4i big S = {S}: launches {counts}, placed "
                                 f"{placed}, verified "
                                 f"{res['summary']['verified']}")
        arrays[S] = res["step"]
        if S == max(CARD_BIG_SHARDS):
            dev = ix.device
            lx = copy.copy(ix)
            for a in ("rec", "sa_seq"):
                sh = getattr(ix, a)
                setattr(lx, a, Shards([p.to(dev, copy=True)
                                       for p in sh.parts], sh.per,
                                      sh.shape[0], dev))
            codes = torch.from_numpy(res["reads"]).to(dev)
            got = big_mem.big_extend_all(ix, codes)
            kf = torch.where(got[2] > got[1], got[1], -1).reshape(-1)
            ids = big_mem.big_sa_walk(ix, kf)
            errs["big_extend_all"] = max(
                max_abs_err(got, big_mem.big_extend_all(lx, codes)),
                max_abs_err(got, big_mem.big_extend_all_plain(lx, codes)))
            errs["big_sa_walk"] = max(
                max_abs_err(ids, big_mem.big_sa_walk(lx, kf)),
                max_abs_err(ids, big_mem.big_sa_walk_plain(lx, kf)))
            for name, fn in (("big_extend_all", big_mem.big_extend_all),
                             ("big_sa_walk", big_mem.big_sa_walk)):
                arg = codes if name == "big_extend_all" else kf
                peer = cuda_ms(lambda: fn(ix, arg))
                own = cuda_ms(lambda: fn(lx, arg))
                log(f"4i kernel {name} [big index, S = {S}, {BIG_READS:,} "
                    f"reads, card {dev} reading {sorted(ix.rec.peer)} in "
                    f"place]: max_abs_err {errs[name]} against its launch "
                    f"and its plain version on copies on {dev}; {peer:.4f} "
                    f"ms on the peer shards, {own:.4f} ms on the copies "
                    f"({peer / own - 1:+.1%}) [{smi}]")
            del lx, codes, got, kf, ids
        del res, ix
        gc.collect()
        torch.cuda.empty_cache()
    same = all(np.array_equal(a, b) for a, b in
               zip(arrays[CARD_BIG_SHARDS[0]], arrays[CARD_BIG_SHARDS[-1]]))
    log(f"4i big: S = {CARD_BIG_SHARDS[-1]} "
        f"{'equals' if same else 'DIFFERS FROM'} S = {CARD_BIG_SHARDS[0]} on "
        "all four arrays")
    shutil.rmtree(work, ignore_errors=True)
    if not same or any(errs.values()):
        raise AssertionError(f"4i big: arrays differ or kernels on the peer "
                             f"shards differ: {errs}")
    return launches, errs


def run_phase_4i(index, reads, ktx, nodes, tsvs, warm, smi):
    """Phase 4i: the index over the cards of one process (card_list):
    the runtime check, run_cards for each path and --mesh-index of
    CARD_SHARDS on the text index, then run_cards_big.  Returns (launch
    counts over all the runs, {kernel: largest error})."""
    cards = card_list()
    log(f"4i: cards {cards}: " + (
        "each card holds its shards and reads the others in place over "
        "NVLink" if len(set(cards)) > 1 else "one card, so two data rows on "
        "cuda:0 and no peer read; the cross-card form was not run"))
    check_library_devices(cards)
    launches = {k: 0 for k in REPLACES}
    errs: dict = {}
    for n_shards in CARD_SHARDS:
        for mode in PATHS:
            counts, e = run_cards(index, reads, ktx, nodes, mode, n_shards,
                                  tsvs[mode]["text"], cards, warm, smi)
            for k, c in counts.items():
                launches[k] += c
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0), v)
    counts, e = run_cards_big(cards, smi)
    for k, c in counts.items():
        launches[k] += c
    errs.update(e)
    return launches, errs


# ---------------------------------------------------------------------------
# phase 4j: processes on several hosts, rehearsed on one machine
# ---------------------------------------------------------------------------


def _snapshot(x):
    """A copy of a call's argument: tensors cloned, tuples (named or not)
    copied element by element, the rest (the index's Shards, scalars) as
    they are."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        items = [_snapshot(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def on_its_card(x, found: dict):
    """x with every index Shards that holds a part on another card (a
    shard another card of the process holds, or one mapped from a peer
    there) replaced by copies on the Shards' own card, remote parts kept
    None: the plain versions read one card's tensors.  found keeps each
    Shards' copy, so that arguments sharing one share its copy."""
    from kaiju_tpu_torch.ops.device_index import Shards

    if isinstance(x, Shards) and any(p is not None and p.device != x.device
                                     for p in x.parts):
        if id(x) not in found:
            found[id(x)] = Shards(
                [None if p is None else p.to(x.device, copy=True)
                 for p in x.parts], x.per, x.shape[0], x.device,
                like=next(p for p in x.parts if p is not None))
        return found[id(x)]
    if isinstance(x, tuple):
        items = [on_its_card(v, found) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


# the calls with work of each hosts kernel's form in this process, by
# spy_hosts_calls' keys (run_hosts holds N's and O's sums to their
# kernels' launch counts)
FORM_LAUNCHES: dict = {}


def spy_hosts_calls(mode: str, only=None) -> dict:
    """Wrap the hosts kernels' wrappers where the hosts path of `mode`
    looks them up (N in parallel.exchange; O, Q and W's two forms in
    ops.classify for MEM; O, U's forms, X, Q, V and W's resolved form in
    ops.greedy for Greedy), so that each keeps a copy of the arguments of
    its first call with work (of the first for which only() is true, if
    given), by form: {form: (wrapper, plain version, args, kwargs)},
    filled as the run goes, and counts each form's calls with work, from
    every thread, in FORM_LAUNCHES; unspy() puts the wrappers back."""
    import threading
    from kaiju_tpu_torch.ops import (classify, device_index, greedy, hybrid,
                                     search)
    from kaiju_tpu_torch.parallel import exchange

    def form(name):
        def key(a, k):
            if name == "fm_serve":  # the seed tables' ROW, or a round's
                return f"fm_serve w{a[5]}", a[4].shape[0]
            if name in ("mem_extend_hosts", "walk_hosts",
                        "greedy_variants_hosts"):
                start = k.get("parked") is None
                work = ({"mem_extend_hosts": lambda: a[5].shape[0],
                         "walk_hosts": lambda: k["rows"].shape[0],
                         "greedy_variants_hosts": lambda: a[3].shape[0]}[
                             name]() if start else k["parked"].shape[0])
                sw = " sw" if k.get("sw") else ""  # X's last-level stop
                return f"{name} {'start' if start else 'resume'}{sw}", work
            if name == "greedy_levels":  # form, and the fan-out's pass
                sub = ("" if a[0] != 1 else
                       " counts" if k.get("voff") is None else " list")
                if k.get("vnid") is not None:  # the settle's virtual rows
                    sub = " sw"
                work = (int(k["voff"][-1]) if sub == " list"
                        else a[4].shape[0])
                return f"greedy_levels {a[0]}{sub}", work
            if name == "switch_hosts":  # Y: start, resume (width), finish
                if a[0] == 0:
                    return "switch_hosts start", k["s0"].shape[0]
                if a[0] == 1:
                    return (f"switch_hosts resume w{k['answers'].shape[1]}",
                            k["parked"].shape[0])
                return "switch_hosts finish", a[10].qg.shape[0]
            return name, a[0].shape[0]
        return key

    where = classify if mode == "mem" else greedy
    specs = [(exchange, "fm_serve", device_index.fm_serve_plain),
             (where, "mem_extend_hosts", search.mem_extend_hosts_plain),
             (classify, "walk_hosts", device_index.walk_hosts_plain),
             (hybrid, "switch_hosts", hybrid.switch_hosts_plain)]
    if mode == "mem":
        specs += [(classify, "read_lca_list", classify.read_lca_list_plain)]
    else:
        specs += [(greedy, "greedy_levels", greedy.greedy_levels_plain),
                  (greedy, "greedy_variants_hosts",
                   greedy.greedy_variants_hosts_plain),
                  (greedy, "ranges_lca_list", classify.ranges_lca_list_plain)]
    specs.append((where, "lca_resolved", classify.lca_resolved_plain))
    first = {}
    lock = threading.Lock()
    for mod, name, plain in specs:
        def wrap(*args, _fn=getattr(mod, name), _plain=plain,
                 _key=form(name), **kw):
            key, work = _key(args, kw)
            if work:
                with lock:
                    FORM_LAUNCHES[key] = FORM_LAUNCHES.get(key, 0) + 1
            if work and key not in first and (only is None or only()):
                first[key] = (_fn, _plain, _snapshot(args),
                              {k: _snapshot(v) for k, v in kw.items()})
            return _fn(*args, **kw)

        _SPIED.append((mod, name, getattr(mod, name)))
        setattr(mod, name, wrap)
    return first


def tally_hosts_work() -> dict:
    """Wrap kernel Y's wrapper and classify.walk_listed where the hosts
    paths look them up, so that the process tallies over its run the
    intervals the hybrid switched (Y's start forms: MEM's lanes, Greedy's
    last-level variants), the positions W or V listed and those kernel Q
    walked (the rest are virtual rows, whose ids the list forms give):
    {"switched", "listed", "walked"}, filled as the run goes."""
    from kaiju_tpu_torch.ops import classify, greedy, hybrid

    work = {"switched": 0, "listed": 0, "walked": 0}
    y = hybrid.switch_hosts

    def switch(form, *a, **k):
        if form == 0:
            work["switched"] += int(k["s0"].shape[0])
        return y(form, *a, **k)

    walk = classify.walk_listed

    def listed(sh, ex, pos, seq=None):
        n = pos >= 0
        work["listed"] += int(n.sum())
        work["walked"] += int((n if seq is None else n & (seq < 0)).sum())
        return walk(sh, ex, pos, seq)

    hybrid.switch_hosts = switch
    classify.walk_listed = greedy.walk_listed = listed
    return work


def _by_lane(park, q):
    """Parked lanes (and their queries) in lane order: a kernel parks them
    in no fixed order."""
    o = park[:, 0].long().argsort()
    return park[o], q[o]


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _levels_bytes(a, k, got, before) -> int:
    """U's bytes, each input read once and each output written once, as
    each form touches them (before: the level state before the launch, a[7]
    after it).  Every form reads the reads' fragment rows, their offsets
    and the scoring tables.  Form 0 reads the lanes' i at the positions its
    node scan visits (j >= Lmap - 1), every code, and s0 and s1 at its
    nodes (at least one a kept tie or a source); it writes the prefix
    sums, the state, the level-1 sources and the ties.  Form 1 reads the
    state and each live source (not over vcap), with one code and one
    prefix sum a source that has substitutions, and writes the counts, or
    reads voff and writes the list.  Form 2 reads the state, voff, each
    variant's last four ints, X's results, and two prefix sums a variant
    whose interval holds; it writes the state, the ties and the next
    level's sources, or at the last level the rows."""
    import torch

    form, level, flat, frag_off, rf_rows, tables, params, st = a[:8]
    Lmap, mfl, _score, mismatches, T, vcap = params
    B = rf_rows.shape[0]
    over = before.state[:, 3] != 0
    b = _nbytes(rf_rows, frag_off, *tables)

    def ties_written(last):
        """8 bytes a tie row this launch writes: the ties it adds (all of
        the read's kept ties after a new best), and at the last level the
        zeros after the kept ones, with best and flags."""
        kept = st.state[:, 1].clamp(max=T)
        new = torch.where(st.state[:, 0] == before.state[:, 0],
                          kept - before.state[:, 1].clamp(max=T), kept)
        new = torch.where(over, 0, new.clamp(min=0))
        if not last:
            return 8 * int(new.sum())
        kept = torch.where(over, 0, kept)
        return 8 * int((new + T - kept).sum()) + 8 * B

    if form == 0:
        flen = (frag_off[1:] - frag_off[:-1]).long()
        scanned = int((flen - (Lmap - 1)).clamp(min=0).sum())
        n_src = st.state[:, 2].clamp(max=vcap)  # written, over vcap too
        nodes = int(torch.maximum(n_src, st.state[:, 1].clamp(max=T)).sum())
        return (b + 4 * scanned + flat.numel() + 8 * nodes
                + _nbytes(st.pincl, st.state) + 32 * int(n_src.sum())
                + ties_written(mismatches == 0))
    if form == 1:
        n = torch.where(over, 0, st.state[:, 2])
        live = torch.arange(vcap, device=n.device)[None, :] < n[:, None]
        e = st.src[:, (level - 1) & 1]
        subs = live & (e[..., 1] > 0) & (e[..., 2] >= mfl)
        b += _nbytes(st.state) + 32 * int(live.sum()) + 5 * int(subs.sum())
        if k.get("voff") is None:
            return b + 4 * B
        return b + _nbytes(k["voff"]) + (_nbytes(got) if got is not None
                                         else 0)
    var, vout = k["var"], k["vout"]
    if k.get("vnid") is not None:  # Y's ids in, the virtual rows' out
        b += _nbytes(k["vnid"], k["vids"], k["sw_ids"])
    need, veff = var[:, 4], var[:, 7] >> 8
    has_si = (vout[:, 0] < vout[:, 1]) & (veff - vout[:, 2] >= need)
    last = level == mismatches
    b += (2 * _nbytes(st.state) + _nbytes(k["voff"], vout) + 16 * var.shape[0]
          + 8 * int(has_si.sum()) + ties_written(last))
    if not last:  # the next level's sources, vcap at most a read
        b += 32 * int(torch.where(over, 0, st.state[:, 2].clamp(max=vcap))
                      .sum())
    return b


# the longest chain of dependent loads of each of U's forms: the fragment
# rows, their offsets, then form 0 the lanes and codes (s0 and s1 may be
# loaded beside them); form 1 a source's record, its code and prefix sum,
# then the substitution tables; form 2 the variant and X's result, then
# its prefix sums
LEVELS_CHAIN = {"greedy_levels 0": 3, "greedy_levels 1 counts": 4,
                "greedy_levels 1 list": 4, "greedy_levels 2": 3,
                "greedy_levels 2 sw": 3}


def check_hosts_calls(first: dict, timed: bool = True) -> dict:
    """Each hosts kernel of `first` (spy_hosts_calls) launched again on a
    copy of its round's own arguments, against its plain version on
    another copy, whose shards on another card are copied to the kernel's
    card (on_its_card; the parked lanes compared in lane order, U's state
    in place); both timed where `timed` (else "ms", "wrapper_ms" and
    "plain_ms" are nan): "ms" the kernels' launches alone (launch_ms),
    "wrapper_ms" the whole call, with the count its wrapper reads back
    from the card to size its outputs (U's list pass, O, Q, X).
    Returns {form: {"err", "ms", "plain_ms", "bytes"
    (the distinct record rows the plain version read, with the other
    inputs and the outputs), "work" (queries, lanes, variants, walks or
    reads), "chain" (the longest chain of dependent loads)}}."""
    import torch

    out = {}
    for key, (fn, plain, args, kw) in first.items():
        def fresh():
            return [_snapshot(a) for a in args], {k: _snapshot(v)
                                                  for k, v in kw.items()}

        a1, k1 = fresh()
        got = fn(*a1, **k1)
        a2, k2 = fresh()
        copies: dict = {}  # the plain version reads this card's tensors
        a2 = [on_its_card(a, copies) for a in a2]
        k2 = {k: on_its_card(v, copies) for k, v in k2.items()}
        touched = []
        if key.startswith(("fm_serve", "mem_extend_hosts", "walk_hosts",
                           "greedy_variants_hosts", "switch_hosts")):
            k2["touched"] = touched
        with dependent_reads() as dep, walk_rounds() as wr:
            want = plain(*a2, **k2)
        k2.pop("touched", None)
        name = key.split()[0]
        chain = None
        if name == "fm_serve":
            err = max_abs_err(got[0], want[0]) + int(got[1])
            work = a1[4].shape[0]
            other = work * (8 + 4 * a1[5])
            chain = 1  # a query, then its record row
        elif name == "mem_extend_hosts":
            err = max(max_abs_err(got[0], want[0]),
                      max_abs_err(_by_lane(*got[1:]), _by_lane(*want[1:])))
            work = (k1["parked"].shape[0] if "parked" in k1
                    else a1[5].shape[0])
            other = 13 * got[0].shape[1] + 32 * (got[1].shape[0] + work)
            # B's: the seed row and the bitmap word (the start form) or
            # the parked lane and its answer (resume), then one row pair
            # a step
            chain = dep["steps"] + (1 if "parked" in k1 else
                                    1 + (k1.get("bloom") is not None))
        elif name == "greedy_variants_hosts":
            err = max(max_abs_err(a1[4], a2[4]),
                      max_abs_err(_by_lane(*got), _by_lane(*want)))
            work = (k1["parked"].shape[0] if "parked" in k1
                    else a1[3].shape[0])
            # the variants and their results; the lanes parked (and, in
            # the resume form, taken) with their queries and answers
            other = 44 * a1[3].shape[0] + 32 * got[0].shape[0] + (
                24 * work if "parked" in k1 else 0)
            # the variant (or the parked lane), then one row a step: each
            # step's two ranks read in parallel
            chain = 1 + sum(t.numel() > 0 for t in touched) // 2
        elif name == "greedy_levels":
            err = max(max_abs_err(g, w) for g, w in zip(a1[7], a2[7]))
            if got is not None:
                err = max(err, max_abs_err(got, want))
            work = (int(k1["voff"][-1]) if key.endswith("list")
                    else a1[4].shape[0])
            other = _levels_bytes(a1, k1, got, args[7])
            chain = LEVELS_CHAIN[key]
        elif name == "switch_hosts":
            st1, st2 = a1[10], a2[10]  # the state, updated in place
            n = st1.qg.shape[0]
            if a1[0] == 2:
                err = max_abs_err(got, want)
                work, other, chain = n, 104 * n, 1
            else:
                err = max(max_abs_err(st1, st2),
                          max_abs_err(_by_lane(*got), _by_lane(*want)))
                ext = st2.ext.view(-1)
                if a1[0] == 0:
                    work = n
                    mine = ext
                    other = 16 * n + 64 * n
                else:
                    work = k1["parked"].shape[0]
                    mine = ext[k1["parked"][:, 0].long()]
                    other = (16 + 4 * k1["answers"].shape[1] + 8) * work
                # the letters compared (text and query), the lanes parked
                reach = mine[mine >= 0]
                other += 2 * int((reach + 1).sum()) + 24 * got[0].shape[0]
                # the interval (or the parked lane), each walk round, the
                # sample, then 64 letters a compare round
                top = int(reach.max()) if reach.numel() else 0
                chain = 2 + wr["rounds"] + -(-top // 64)
        elif name == "walk_hosts":
            err = max(max_abs_err(a1[5], a2[5]),
                      max_abs_err(_by_lane(*got), _by_lane(*want)))
            work = (k1["parked"] if "parked" in k1 else k1["rows"]).shape[0]
            other = 8 * work + 16 * got[0].shape[0]
            # the row (or the parked walk and its answer), each LF round,
            # then the sample
            chain = 2 + dep["walks"]
        elif name in ("read_lca_list", "ranges_lca_list"):
            err = max_abs_err(got, want)
            work = a1[0].shape[0] if name == "ranges_lca_list" else \
                a1[4].shape[0]
            ins = a1[:2] if name == "ranges_lca_list" else a1[:5]
            other = _nbytes(*ins, *got)
            # V: the ranges; W: the slots, their longest, then their ties
            chain = 1 if name == "ranges_lca_list" else 3
        else:  # lca_resolved
            err = max_abs_err(got, want)
            work = a1[0].shape[0]
            other = _nbytes(a1[0], a1[1], *got)
            # info and seq, the taxon, its depth, then the lift and climb
            chain = 3 + dep["parents"]
        ms = plain_ms = wrapper_ms = float("nan")
        if timed:
            a3, k3 = fresh()
            a4, k4 = fresh()
            a4 = [on_its_card(a, copies) for a in a4]
            k4 = {k: on_its_card(v, copies) for k, v in k4.items()}
            a5, k5 = fresh()
            ms = launch_ms(lambda: fn(*a3, **k3))
            wrapper_ms = cuda_ms(lambda: fn(*a5, **k5))
            plain_ms = cuda_ms(lambda: plain(*a4, **k4), reps=3, warm=1)
        out[key] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                    "wrapper_ms": wrapper_ms,
                    "bytes": row_bytes(touched)[0] + other, "work": work,
                    "chain": chain}
        del copies
        torch.cuda.synchronize()
    return out


def start_workers(argv: list, hosts: str, tag: str, work: str, ktx: str,
                  timed: bool, per: int = 1, transport=None):
    """len(hosts) processes of this script as --kaiju-worker, process p
    labelled host hosts[p] and on `per` cards (worker_cards; with one, its
    share of the machine's, dealt_cards), each with an empty seed-table
    cache of its own, process 0 timing its checks where `timed`, the rule
    of the rounds' transport replaced by `transport` where given; returns
    (outputs, counts files, logs, exit codes, wall seconds)."""
    coord = f"127.0.0.1:{free_port()}"
    outs, counts, logs, procs = [], [], [], []
    t0 = time.perf_counter()
    try:
        for p, host in enumerate(hosts):
            outs.append(os.path.join(work, f"out_hosts_{tag}_p{p}.tsv"))
            counts.append(os.path.join(work, f"counts_hosts_{tag}_p{p}.json"))
            logs.append(open(os.path.join(work, f"log_hosts_{tag}_p{p}.txt"),
                             "w"))
            env = dict(os.environ, KAIJU_TPU_CACHE=fresh_cache(
                ktx, os.path.join(work, f"cache_hosts_{tag}_p{p}")),
                CHIP_SMOKE_TIMED="1" if timed else "0")
            cards = worker_cards(p, len(hosts), per)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--kaiju-worker",
                 counts[p], "--host", host,
                 *(["--transport", transport] if transport else []),
                 *(["--cards", ",".join(cards)] if cards else []), *argv,
                 "-o", outs[p],
                 "--dist-nprocs", str(len(hosts)), "--dist-coordinator",
                 coord, "--dist-pid", str(p)], env=env, stdout=logs[p],
                stderr=subprocess.STDOUT))
        rcs = [proc.wait(timeout=300) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for fh in logs:
            fh.close()
    return outs, counts, logs, rcs, time.perf_counter() - t0


def run_hosts(index, reads, ktx, nodes, mode, n_shards, hosts, base_tsv,
              tag, per=1, transport=None):
    """tools.kaiju.main in `mode` with --mesh-index n_shards as len(hosts)
    processes, process p labelled host hosts[p] (peer_shards.host_name)
    on `per` cards (worker_cards, dealt_cards), on the first HOST_READS
    reads: each process must launch every kernel of the mode's hosts path
    (HOST_PATHS) and no kernel of the one-host paths that reads the index,
    each card must hold, read, map and have served in rounds the shards of
    the slot rules (check_slots), with rounds in every stage of the path
    on every card (the seed tables' on the first) over the transport of
    the rule (transport_rule, or `transport` where given, which replaces
    it: the gloo twin), with no copy under NCCL, and the lines merged by
    read must equal phase 4's of the mode (base_tsv).  Process 0 holds
    each hosts kernel on its first card's first rounds' arguments against
    its plain version (check_hosts_calls).  Returns (launch counts of all
    the processes, each process's report, the stream's rate, the merged
    lines by read)."""
    import torch

    from kaiju_tpu_torch.parallel.multihost import local_rows

    work = os.path.dirname(ktx)
    name = (f"{mode} --mesh-index {n_shards} on hosts {','.join(hosts)} "
            f"({tag}{', %d cards a process' % per if per > 1 else ''}"
            f"{', the gloo twin' if transport else ''})")
    argv = ["-t", nodes, "-f", ktx, "-i", mesh_fastq(reads, ktx, HOST_READS),
            *PATHS[mode][1], "--mesh-index", str(n_shards), "-b", str(BATCH)]
    gc.collect()
    torch.cuda.empty_cache()
    outs, counts, logs, rcs, wall = start_workers(
        argv, hosts, f"{mode}_{tag}_{n_shards}_{hosts}_{per}"
        + (f"_{transport}" if transport else ""), work, ktx,
        (tag, n_shards, hosts, per) == HOST_TIMED and not transport, per,
        transport)
    if any(rcs):
        for p, fh in enumerate(logs):
            with open(fh.name) as f:
                log(f"process {p} ({rcs[p]}): " + f.read()[-3000:])
        raise AssertionError(f"{name}: exit codes {rcs}")
    across = len(set(hosts)) > 1
    backend = (transport or transport_rule(
        [worker_cards(q, len(hosts), per) or dealt_cards(q, len(hosts))
         for q in range(len(hosts))])) if across else None

    def served(c: int, per: int) -> bool:
        """Whether a slot of card index c has a shard served in rounds."""
        return any(slot_rule(q * per + c, hosts, per, n_shards)[3]
                   for q in range(len(hosts)))

    text = index.text is not None  # the hybrid runs across hosts
    path = ([k for k in HOST_PATHS[mode] if text or k not in HOST_HYBRID]
            if across else kernels_of(mode, text, True))
    stages = [st for st in HOST_STAGES[mode]
              if text or st not in HOST_HYBRID_STAGES]
    batches = -(-HOST_READS // BATCH)
    launches = {k: 0 for k in REPLACES}
    reports = []
    for p, cpath in enumerate(counts):
        with open(cpath) as fh:
            got = json.load(fh)
        reports.append(got)
        idle = [k for k in path if got["launches"][k] <= 0]
        stray = [k for k in REPLACES if k not in path and got["launches"][k]]
        log(f"4j {name} process {p} on host {hosts[p]}, "
            f"{','.join(got['cards'])}: main() {got['seconds']:.2f} s, "
            f"set-up {got['setup']:.2f} s, the stream "
            f"{got['seconds'] - got['setup']:.2f} s; launches "
            + json.dumps({k: v for k, v in got["launches"].items() if v}))
        for c, lay in enumerate(got["layout"]):
            log(f"4j {name} process {p} card {c} ({lay['card']}): holds "
                f"{lay['held']}, reads " + ", ".join(
                    f"{o} from card {h}" for o, h in lay["reads"].items())
                + ", maps " + ", ".join(f"{o} from process {q}" for o, q in
                                        lay["opened"].items())
                + ", served " + ", ".join(f"{o} by {q}" for o, q in
                                          lay["remote"].items())
                + f" ({json.dumps(lay['bytes_held'])} held, "
                f"{json.dumps(lay['bytes_remote'])} served, bytes)")
        for c, rounds in enumerate(got["card_rounds"]):
            took = got["backends"][c]
            if across:
                log(f"4j {name} process {p} card {c} ({got['cards'][c]}): "
                    f"rounds over {took}, the rule {backend}")
            if took != backend:
                raise AssertionError(f"{name} process {p} card {c}: its "
                                     f"exchange runs over {took}, the rule "
                                     f"gives {backend}")
            for stage, k in sorted(rounds.items()):
                r = max(k["rounds"], 1)
                each = (f"{k['rounds'] / batches:.1f} a batch"
                        if stage != "seed" else "at set-up")
                log(f"4j rounds {name} process {p} card {c} {stage}: "
                    f"{k['rounds']} rounds ({each}), {k['queries'] / r:,.1f} "
                    f"queries and {k['sent'] / r:,.1f} sent to a peer a "
                    f"round, {k['bytes'] / r:,.0f} bytes a round over "
                    f"{took}; seconds: copies {k['copy_s']:.4f}, transport "
                    f"{k['transport_s']:.4f}, N {k['serve_s']:.4f}")
                if took == "nccl" and k["copy_s"]:
                    raise AssertionError(f"{name} process {p} card {c} "
                                         f"{stage}: copies under NCCL")
            # card c's group runs rounds where a slot of card index c has
            # a remote shard (with one whole index a process, none does);
            # the seed tables' rounds run on card 0 alone
            ran = [bool(rounds.get(st, {}).get("rounds"))
                   for st in stages if st != "seed"]
            seeded = bool(rounds.get("seed", {}).get("rounds"))
            want = served(c, len(got["cards"]))
            if across and (ran != [want] * len(ran) or seeded != (c == 0)):
                raise AssertionError(f"{name} process {p} card {c}: rounds "
                                     f"in the stages {ran}, seed {seeded}; "
                                     f"a slot of its card index is served a "
                                     f"shard: {want}")
        if idle or stray:
            raise AssertionError(f"{name} process {p}: kernels that did not "
                                 f"launch {idle}, others {stray}")
        for k in ("fm_serve", "mem_extend_hosts"):  # the forms' launches
            n = sum(c for f, c in got["forms"].items() if f.split()[0] == k)
            if n != got["launches"][k]:
                raise AssertionError(f"{name} process {p}: {k}'s forms "
                                     f"counted {n} calls with work, the "
                                     f"kernel {got['launches'][k]} launches")
        check_slots(name, p, got, hosts, per, n_shards)
        for k, c in got["checks"].items():
            log(f"4j kernel {k} [{name}, process 0]: max_abs_err {c['err']} "
                f"against its plain version on the round's own arguments "
                f"({c['work']:,} items); {c['ms']:.4f} ms in its launches, "
                f"{c['wrapper_ms']:.4f} ms the wrapper's whole call (plain "
                f"{c['plain_ms']:.3f} ms), {c['bytes']:,} bytes")
        every = any(served(c, len(got["cards"]))
                    for c in range(len(got["cards"])))
        missing = [f for f in HOST_HYBRID_FORMS
                   if text and f not in got["checks"]]
        if across and p == 0 and (every and (len(got["checks"]) <
                                             HOST_FORMS[mode] or missing)
                                  or any(c["err"] for c in
                                         got["checks"].values())):
            raise AssertionError(f"{name}: hosts kernels unchecked or "
                                 "differing from their plain versions: "
                                 f"{sorted(got['checks'])}, missing "
                                 f"{missing}")
        for k in launches:
            launches[k] += got["launches"][k]

    if across and text:
        work = {k: sum(r["work"][k] for r in reports)
                for k in ("switched", "listed", "walked")}
        what = "lanes" if mode == "mem" else "last-level variants"
        log(f"4j hybrid {name}: {work['switched']:,} {what} switched to "
            f"kernel Y over the processes ({work['switched'] / batches:,.1f}"
            f" a batch); kernel Q walked {work['walked']:,} of the "
            f"{work['listed']:,} positions W or V listed, the rest virtual "
            "rows (without the hybrid Q walks every listed position, and "
            "the hybrid leaves each read's listed positions as they are)")
        if not work["switched"]:
            raise AssertionError(f"{name}: the hybrid switched nothing")
    names = [n for n, _q, _r in reads[:HOST_READS]]
    owner = {}
    for b0 in range(0, HOST_READS, BATCH):
        for p in range(len(hosts)):
            lo, hi = local_rows(min(BATCH, HOST_READS - b0), len(hosts), p)
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
        want = [next(fh) for _ in range(HOST_READS)]
    same = sum(lines.get(n) == w for n, w in zip(names, want))
    stream = max(r["seconds"] - r["setup"] for r in reports)
    log(f"4j e2e {name}: {len(lines):,} reads written once each, {same:,} "
        f"equal to phase 4's {mode} lines; wall {wall:.2f} s; the stream "
        f"after set-up {stream:.3f} s = {HOST_READS / stream:,.1f} reads/s "
        f"(the slowest process); set-up "
        f"{max(r['setup'] for r in reports):.2f} s")
    if len(lines) != HOST_READS or same != HOST_READS:
        raise AssertionError(f"{name}: the merged lines differ from phase 4's")
    return launches, reports, HOST_READS / stream, lines


# the kernels line's row of each hosts kernel: its forms on process 0's
# first rounds (the text index, S = 4, hosts a, a, b; W's resolved form
# from the MEM run, which comes after Greedy's) and its note
HOST_ROWS = {
    "fm_serve": (("fm_serve w1", "fm_serve w2", "fm_serve w20",
                  "fm_serve w32"),
                 "a round's queries, one record row (or sample, or text "
                 "row) each"),
    "mem_extend_hosts": (("mem_extend_hosts start",
                          "mem_extend_hosts resume"),
                         "B's pass 1 and the steps on this host's rows; "
                         "the parked lanes resumed from their answers"),
    "walk_hosts": (("walk_hosts start",),
                   "the walks' steps on this host's rows"),
    "read_lca_hosts": (("read_lca_list", "lca_resolved"),
                       "D without its walks, and the resolved form that V's "
                       "reads take too: statistics rows, positions, ids "
                       "and rows out"),
    "greedy_levels": (("greedy_levels 0", "greedy_levels 1 counts",
                       "greedy_levels 1 list", "greedy_levels 2"),
                      "E's level 0, one level's fan-out (counts, list) and "
                      "settle: lanes, codes, state, sources, variants, ties; "
                      "no index row"),
    "greedy_variants_hosts": (("greedy_variants_hosts start",),
                              "one level's probes and resumed extensions "
                              "on this host's rows"),
    "ranges_lca_hosts": (("ranges_lca_list",),
                         "F's positions without the walks (W's resolved "
                         "form finishes the reads): ranges in, positions "
                         "out"),
    "switch_hosts": (("switch_hosts start", "switch_hosts finish"),
                     "the hybrid's switch of a batch's narrow intervals "
                     "(start: walks and compares on this host's rows and "
                     "text; finish: reaches to ids): rows walked, letters "
                     "compared, state and parked lanes"),
}


def run_twin(index, reads, ktx, nodes, mode, n_shards, hosts, base_tsv,
             tag, first) -> dict:
    """The gloo twin of an NCCL run (run_hosts with transport "gloo", the
    same reads): its merged lines must equal the first run's (`first`, as
    run_hosts returns it) and every card's rounds, queries, sent and bytes
    in every stage; logs the pair's rates and process 0's seconds in the
    transport, the copies and N.  Returns the twin's launch counts."""
    counts, reports, rate, lines = run_hosts(
        index, reads, ktx, nodes, mode, n_shards, hosts, base_tsv, tag,
        transport="gloo")
    _c, first_reports, first_rate, first_lines = first
    name = f"{mode} --mesh-index {n_shards} on hosts {','.join(hosts)} ({tag})"
    if lines != first_lines:
        raise AssertionError(f"{name}: the gloo twin's lines differ")
    keep = ("rounds", "queries", "sent", "bytes")
    for p, (a, b) in enumerate(zip(first_reports, reports)):
        for c, (ra, rb) in enumerate(zip(a["card_rounds"], b["card_rounds"])):
            if {st: [k[f] for f in keep] for st, k in ra.items()} != \
                    {st: [k[f] for f in keep] for st, k in rb.items()}:
                raise AssertionError(f"{name} process {p} card {c}: rounds "
                                     f"{ra} over {a['backends'][c]}, {rb} "
                                     f"over {b['backends'][c]}")

    def seconds(rep):
        return {f: sum(k[f] for r in rep["card_rounds"] for k in r.values())
                for f in ("transport_s", "copy_s", "serve_s")}

    for rep, r in ((first_reports, first_rate), (reports, rate)):
        sec = seconds(rep[0])
        log(f"4j pair {name}, over {rep[0]['backends'][0]}: {r:,.1f} reads/s "
            f"(the stream after set-up, the slowest process); process 0's "
            f"seconds over its cards and stages, the seed tables' rounds at "
            f"set-up among them: transport {sec['transport_s']:.4f}, "
            f"copies {sec['copy_s']:.4f}, N {sec['serve_s']:.4f}")
    log(f"4j pair {name}: the lines and every card's rounds, queries, sent "
        f"and bytes in every stage equal over "
        f"{first_reports[0]['backends'][0]} and gloo; rate "
        f"{first_rate / rate:.3f}x the twin's")
    return counts


def run_phase_4j(indexes, reads, ktx, nodes, base_tsvs: dict, lat_ns: float,
                 smi: str, twins: bool = False) -> tuple[dict, dict]:
    """Phase 4j: Greedy and MEM with --mesh-index over processes labelled
    as several hosts (HOST_MODE_RUNS, and HOST_RUNS_4 where there are four
    cards) on each mode's indexes (HOST_INDEXES; db.ktx at HOST_FMI_RUNS
    only), and HOST_CARD_RUN, two
    cards a process, with a one-host group of the same mode, first, as
    the reference rate (2 processes, --mesh-index 2, db_text.ktx, the same
    HOST_READS reads); base_tsvs: phase 4's TSV of each mode on the text
    index.  With `twins` and two cards or more, each run of HOST_TWINS is
    followed by its gloo twin (run_twin).
    Returns (launch counts over all the runs, the
    kernels line's rows of the hosts kernels: (err, ms, plain_ms,
    bound_ms, note), from the text index's runs at S = 4 on hosts a, a, b,
    errors over every run)."""
    import torch

    cards = torch.cuda.device_count()
    log(f"4j: processes on hosts labelled by peer_shards.host_name, each on "
        f"its share of the {cards} card(s) or on the cards given (the run "
        "of two cards a process); every host is this machine, and the "
        "rounds go card to card over NCCL (NVLink or P2P here) where every "
        "slot has a card of its own, else over gloo on loopback: no run "
        f"spans two real hosts ({smi})")
    launches = {k: 0 for k in REPLACES}
    forms: dict = {}  # each hosts kernel form's launches over 4j's runs
    checks: dict = {}
    errs: dict = {}
    for mode in HOST_INDEXES:
        ref = None
        runs = HOST_MODE_RUNS[mode] + (HOST_RUNS_4 if cards >= 4 else ())
        mode_runs = [(n, h, 1, HOST_INDEXES[mode]) for n, h in
                     ((2, "aa"),) + runs]
        if HOST_CARD_RUN[0] == mode:
            mode_runs.append((*HOST_CARD_RUN[2:], HOST_CARD_RUN[1:2]))
        for n_shards, hosts, per, tags in mode_runs:
            for tag in tags:
                if tag == "fmi" and (n_shards, hosts) not in HOST_FMI_RUNS:
                    continue
                run = run_hosts(
                    indexes[tag], reads, ktx[tag], nodes, mode, n_shards,
                    hosts, base_tsvs[mode], tag, per)
                counts, reports, rate, _lines = run
                for k, c in counts.items():
                    launches[k] += c
                for r in reports:
                    for k, c in r.get("forms", {}).items():
                        forms[k] = forms.get(k, 0) + c
                if twins and cards >= 2 and per == 1 and \
                        (mode, tag, n_shards, hosts) in HOST_TWINS:
                    for k, c in run_twin(indexes[tag], reads, ktx[tag],
                                         nodes, mode, n_shards, hosts,
                                         base_tsvs[mode], tag, run).items():
                        launches[k] += c
                if len(set(hosts)) == 1:
                    ref = rate
                    continue
                log(f"4j rate {mode} {n_shards} shards on hosts {hosts} "
                    f"({tag}, {len(reports[0]['cards'])} card(s) a "
                    f"process): {rate:,.1f} reads/s "
                    f"against {ref:,.1f} of the "
                    f"one-host group (2 processes, --mesh-index 2, "
                    f"db_text.ktx), the stream after set-up, both on the "
                    f"first {HOST_READS:,} reads")
                for key, c in reports[0]["checks"].items():
                    name = next(k for k, (forms, _n) in HOST_ROWS.items()
                                if key in forms or key.split()[0] == k)
                    errs[name] = max(errs.get(name, 0), c["err"])
                if (tag, n_shards, hosts, per) == HOST_TIMED:
                    checks.update(reports[0]["checks"])
    rows = hosts_rows(checks, lat_ns, forms)
    for name, e in errs.items():
        rows[name] = (max(e, rows[name][0]), *rows[name][1:])
    return launches, rows


def hosts_rows(checks: dict, lat_ns: float, launches: dict) -> dict:
    """The kernels line's rows of the hosts kernels (HOST_ROWS) from
    process 0's checks: N's forms that ran (w1 the extension's rounds,
    w2 the switch's, w20 the seed tables' ROW, w32 the text rows), O's
    start and resume forms, Q and X on their start forms, U, V and W as
    their forms together; ms: the forms' launches alone, one launch of
    each, summed, the wrappers' whole calls (with the count read back) in
    the note, beside each form's items, its launches over 4j's runs (of
    every process, `launches`; the gloo twins' left out) and its ms;
    bound: the bytes at 3.35 TB/s, the note with the latency floor of the
    forms' chains of dependent loads, one after another."""
    rows = {}
    for name, (forms, note) in HOST_ROWS.items():
        forms = [f for f in forms if f in checks]
        if not forms:
            raise AssertionError(f"4j: no form of {name} was checked")
        cs = [checks[f] for f in forms]
        b = sum(c["bytes"] for c in cs)
        work = ", ".join(f"{f} {c['work']:,} items, "
                         f"{launches.get(f, 0):,} launches, "
                         f"{c['ms']:.4f} ms" for f, c in zip(forms, cs))
        if all(c["chain"] is not None for c in cs):
            note += ": " + floor_note(sum(c["chain"] for c in cs), lat_ns,
                                      "loads")
        whole = sum(c["wrapper_ms"] for c in cs)
        rows[name] = (max(c["err"] for c in cs), sum(c["ms"] for c in cs),
                      sum(c["plain_ms"] for c in cs),
                      b / HBM_BYTES_PER_S * 1e3,
                      f"{note}; {work}; the wrapper's whole call {whole:.4f} "
                      "ms")
    return rows


# ---------------------------------------------------------------------------
# phase 4h: warm start (mkdb --aot) and fresh processes
# ---------------------------------------------------------------------------


def warm_worker(argv: list) -> int:
    """One fresh process of phase 4h: tools.kaiju.main with -a mem, then
    with the default flags (Greedy), on the index at ktx (argv: ktx,
    nodes.dmp, FASTQ, output prefix), one batch of BATCH reads each.  Each
    main() is split into WARM_STEPS: the seconds in kernels.load (builds
    and dlopen, wherever they fall), loading the index, parsing the
    taxonomy, the seed tables, the bitmaps, the rest of the runner's set-up
    (the card's context, the uploads) and the first batch (the rest of
    main()), each but the first without the library seconds inside it.
    Prints one JSON line: the split and launches of each mode, where each
    library came from (kernels.ORIGIN), this process's nvcc runs and its
    import seconds."""
    t0 = time.perf_counter()
    import torch

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.engine import pipeline
    from kaiju_tpu_torch.tools import kaiju

    imports = time.perf_counter() - t0
    ktx, nodes, fq, prefix = argv
    cur = {}

    def timed(step, fn):
        def wrap(*args, **kw):
            lib0, t1 = kernels.LOADER["seconds"], time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                cur[step] += (time.perf_counter() - t1
                              - (kernels.LOADER["seconds"] - lib0))
        return wrap

    kaiju.load_index = timed("index", kaiju.load_index)
    kaiju.parse_nodes_dmp = timed("taxonomy", kaiju.parse_nodes_dmp)
    kaiju.make_runner = timed("set_up", kaiju.make_runner)
    pipeline.KmerTables.load_or_build = timed(
        "seed_tables", pipeline.KmerTables.load_or_build)
    pipeline.BloomScreen.load_or_build = timed(
        "bitmaps", pipeline.BloomScreen.load_or_build)
    report = {"imports": imports, "modes": {}}
    rc = 0
    for mode in PATHS:
        cur.update(dict.fromkeys(("index", "taxonomy", "set_up",
                                  "seed_tables", "bitmaps"), 0.0))
        kernels.reset_counts()
        lib0, t1 = kernels.LOADER["seconds"], time.perf_counter()
        rc |= kaiju.main(["-t", nodes, "-f", ktx, "-i", fq, *PATHS[mode][1],
                          "-o", f"{prefix}{mode}.tsv", "-b", str(BATCH)])
        torch.cuda.synchronize()
        total = time.perf_counter() - t1
        split = {"libraries": kernels.LOADER["seconds"] - lib0,
                 **{k: cur[k] for k in ("index", "taxonomy", "seed_tables",
                                        "bitmaps")},
                 "upload": cur["set_up"] - cur["seed_tables"] - cur["bitmaps"]}
        split["first_batch"] = total - sum(split.values())
        report["modes"][mode] = {"main": total, "split": split,
                                 "launches": dict(kernels.LAUNCHES)}
    report.update(origin=dict(kernels.ORIGIN),
                  nvcc_runs=kernels.LOADER["nvcc_runs"])
    print(json.dumps(report), flush=True)
    return rc


def run_phase_4h(records, reads, nodes, build_secs: float) -> dict:
    """Phase 4h: mkdb --aot -t nodes.dmp --aot-batch BATCH (a process of
    its own) from a FASTA of phase 2's first records up to AOT_LETTERS
    letters into build/chip_smoke/aot.ktx, its steps' seconds printed;
    then warm_worker as a fresh process on that index, which must load
    every library from aot.ktx/aot/<key>/ with no nvcc run and read the
    seed tables (A launches in neither mode), and again on a copy without
    aot/, kmer*/ and bloom_* (its libraries from build/, the tables built by
    A, the bitmaps filled); both on the first BATCH reads of phase 4, their
    TSVs byte-identical to tools.kaiju.main's in this process on aot.ktx.
    Prints both set-up splits and phase 1's build seconds beside the
    prepared process's library seconds.  Returns the launch counts of the
    two processes and of the in-process runs, each counted from 0."""
    import torch

    from kaiju_tpu_torch import kernels
    from kaiju_tpu_torch.tools import kaiju, readgen
    from kaiju_tpu_torch.utils import aot

    work = os.path.join(ROOT, "build", "chip_smoke")
    ktx, cold = (os.path.join(work, f"aot{t}.ktx") for t in ("", "_cold"))
    for path in (ktx, cold):
        shutil.rmtree(path, ignore_errors=True)
    faa, fq = (os.path.join(work, f"aot.{x}") for x in ("faa", "fastq"))
    letters = n_seq = 0
    with open(faa, "w") as fh:
        for name, seq in records:
            if letters >= AOT_LETTERS:
                break
            fh.write(f">{name}\n{seq}\n")
            letters, n_seq = letters + len(seq), n_seq + 1
    readgen.write_fastq([(n, q) for n, q, _ in reads[:BATCH]], fq)
    env = {k: v for k, v in os.environ.items() if k != "KAIJU_TPU_CACHE"}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kaiju_tpu_torch.tools.mkdb", "-o", ktx,
         "--aot", "-t", nodes, "--aot-batch", str(BATCH), faa], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    for line in proc.stderr.strip().splitlines()[-40:]:
        log(f"4h mkdb --aot: {line}")
    if proc.returncode:
        raise AssertionError(f"mkdb --aot exited {proc.returncode}")
    pre = aot.prebuilt_dir(ktx)
    manifest = aot.read_manifest(pre)
    libs = sorted(f for f in os.listdir(pre) if f.endswith(".so"))
    log(f"4h mkdb --aot: {n_seq:,} sequences, {letters:,} letters, "
        f"{wall:.2f} s of process wall; {len(libs)} libraries under "
        f"{os.path.relpath(pre, ROOT)} (machine {json.dumps(manifest['machine'])}"
        f"), nvcc {manifest['build_seconds']:.1f} s")
    if libs != sorted(f"lib{s}.so" for s in kernels.SOURCES) or (
            manifest["key"] != os.path.basename(pre)):
        raise AssertionError(f"{pre}: libraries {libs}, manifest {manifest}")
    shutil.copytree(ktx, cold, ignore=lambda d, names: [
        n for n in names if d == ktx and (
            n == "aot" or n.startswith(("kmer", "bloom_")))])

    launches = {k: 0 for k in REPLACES}
    reports = {}
    for tag, path in (("prepared", ktx), ("unprepared", cold)):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--warm-worker", path,
             nodes, fq, os.path.join(work, f"aot_out_{tag}_")], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode:
            log(f"4h {tag} process ({proc.returncode}): "
                + proc.stderr[-3000:])
            raise AssertionError(f"4h: the {tag} process failed")
        line = proc.stdout.strip().splitlines()[-1]
        log(f"4h {tag} process: {line}")
        rep = reports[tag] = json.loads(line)
        rep["wall"] = wall
        for mode, got in rep["modes"].items():
            s = got["split"]
            log(f"4h {tag} {mode}: main() {got['main']:.3f} s = "
                + " + ".join(f"{k} {s[k]:.3f}" for k in WARM_STEPS)
                + f"; process wall {wall:.2f} s with imports "
                f"{rep['imports']:.2f} s")
            for k in REPLACES:
                launches[k] += got["launches"].get(k, 0)
            idle = [k for k in kernels_of(mode, True, False)
                    if k != "update_si_letters" and got["launches"][k] <= 0]
            built = got["launches"]["update_si_letters"]
            if idle or bool(built) != (tag == "unprepared" and mode == "mem"):
                raise AssertionError(f"4h {tag} {mode}: kernels that did not "
                                     f"launch {idle}; A's letters form "
                                     f"{built} launches")
    origin = reports["prepared"]["origin"]
    if reports["prepared"]["nvcc_runs"] or not origin or set(
            origin.values()) != {pre}:
        raise AssertionError(f"4h prepared: {reports['prepared']['nvcc_runs']}"
                             f" nvcc runs, libraries from {origin}")
    if set(reports["unprepared"]["origin"].values()) != {kernels.BUILD_DIR}:
        raise AssertionError("4h unprepared: libraries from "
                             f"{reports['unprepared']['origin']}")

    for mode in PATHS:  # the same reads on the same DB in this process
        out = os.path.join(work, f"aot_out_here_{mode}.tsv")
        kernels.reset_counts()
        rc = kaiju.main(["-t", nodes, "-f", ktx, "-i", fq, *PATHS[mode][1],
                         "-o", out, "-b", str(BATCH)])
        torch.cuda.synchronize()
        for k in REPLACES:
            launches[k] += kernels.LAUNCHES[k]
        with open(out, "rb") as fh:
            want = fh.read()
        same = []
        for tag in reports:
            with open(os.path.join(work, f"aot_out_{tag}_{mode}.tsv"),
                      "rb") as fh:
                same.append(fh.read() == want)
        log(f"4h {mode}: the prepared and unprepared processes' TSVs "
            f"{'equal' if all(same) else 'DIFFER FROM'} this process's "
            f"({want.count(b'C'):,} of {BATCH:,} lines classified, sha256 "
            f"{hashlib.sha256(want).hexdigest()[:16]})")
        if rc or not all(same):
            raise AssertionError(f"4h {mode}: TSVs differ ({same}, rc {rc})")
    kernels.use_prebuilt(None)  # later phases load from build/ again
    prep, unprep = reports["prepared"], reports["unprepared"]
    log(f"4h nvcc bill: phase 1 built {len(kernels.SOURCES)} libraries in "
        f"{build_secs:.1f} s and mkdb --aot in {manifest['build_seconds']:.1f}"
        f" s; the prepared process loaded {len(origin)} of them from "
        f"aot.ktx/aot/ in {sum(m['split']['libraries'] for m in prep['modes'].values()):.3f} s"
        f" with 0 nvcc runs (the unprepared one {len(unprep['origin'])} from "
        f"build/ in {sum(m['split']['libraries'] for m in unprep['modes'].values()):.3f} s, "
        f"{unprep['nvcc_runs']} nvcc runs); MEM main() "
        f"{prep['modes']['mem']['main']:.3f} s prepared, "
        f"{unprep['modes']['mem']['main']:.3f} s unprepared")
    return launches


# ---------------------------------------------------------------------------
# phase 4g: the index above 2^31 letters (K17)
# ---------------------------------------------------------------------------


def run_heads(kf):
    """The heads of kernel M's runs of equal kf (csrc/big_mem.cu): lanes
    with kf >= 0 that open a warp-aligned window of 32 or differ from
    the lane before.  Returns their count."""
    import torch

    lane = torch.arange(kf.numel(), device=kf.device)
    prev = torch.roll(kf, 1)
    return int(((kf >= 0) & ((lane % 32 == 0) | (kf != prev))).sum())


def row_rounds(touched, per_round=1) -> int:
    """The rounds of a plain version's longest chain of dependent row
    reads: the rounds that read rows, from its list of row indices
    (per_round lists a round: 2 for L's rank pair)."""
    return sum(1 for t in touched if t.numel()) // per_round


def big_checks(ix, reads, smi, dram_ns, tag, plain=True):
    """L and M against their plain versions on the card on the demo's
    reads uint8 [R, 64] (tag names the shape): {name: measure() tuple};
    the notes carry the latency floors (the plain versions' longest
    chain of dependent rows, times the device-memory latency dram_ns)
    and M's work (lanes walked by one thread each before, the heads of
    the runs walked now, the longest walk).  plain=False leaves the
    plain versions untimed.  On an index past 2^31 + 10^6 letters also
    asserts that a lane's interval starts at 2^31 or later."""
    import torch

    from kaiju_tpu_torch.ops import big_mem

    codes = torch.from_numpy(reads).cuda()
    R, L = codes.shape
    got = big_mem.big_extend_all(ix, codes)
    touched = []
    want = big_mem.big_extend_all_plain(ix, codes, touched)
    steps = row_rounds(touched, 2)
    out = {"big_extend_all": measure(
        got, want, lambda: big_mem.big_extend_all(ix, codes),
        plain and (lambda: big_mem.big_extend_all_plain(ix, codes)), touched,
        R * L * (1 + 4 + 8 + 8), f"{tag}: [{R}, {L}] lanes; longest chain "
        f"{steps} steps + 1: latency floor "
        f"{(steps + 1) * dram_ns / 1e6:.4f} ms at {dram_ns:.1f} ns")}
    i, s0, s1 = got
    kf = torch.where(s1 > s0, s0, -1).reshape(-1)
    ids = big_mem.big_sa_walk(ix, kf)
    touched, slots = [], []
    want_ids = big_mem.big_sa_walk_plain(ix, kf, touched, slots)
    walked = int((kf >= 0).sum())
    heads = run_heads(kf)
    longest = row_rounds(touched)
    n_slots = int(torch.unique(torch.cat(slots)).numel()) if slots else 0
    out["big_sa_walk"] = measure(
        ids, want_ids, lambda: big_mem.big_sa_walk(ix, kf),
        plain and (lambda: big_mem.big_sa_walk_plain(ix, kf)), touched,
        kf.numel() * 16 + 4 * n_slots,
        f"{tag}: {walked:,} lanes to walk of {kf.numel():,}, {heads:,} heads "
        f"walked ({heads / max(walked, 1):.3f}), {n_slots:,} samples; "
        f"longest walk {longest} steps + 2: latency floor "
        f"{(longest + 2) * dram_ns / 1e6:.4f} ms at {dram_ns:.1f} ns")
    big = int((s0 >= 1 << 31).sum())
    log(f"4g {tag}: {big:,} of {s0.numel():,} lanes have s0 >= 2^31; "
        f"largest s1 {int(s1.max()):,}, largest id {int(ids.max()):,} "
        f"[{smi}]")
    if not big and ix.N > (1 << 31) + 1_000_000:
        raise AssertionError("4g: no interval starts at 2^31 or later")
    return out


def steady_big(ix, db, smi, dram_ns) -> dict:
    """A steady step over READS reads of the demo's length: big_mem_step's
    reads/s (host clock, synchronised), the host statistics' seconds, and
    L and M against their plain versions on these reads (big_checks,
    the plain versions untimed): {name + " (steady)": measure() tuple}."""
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
    arrays = tuple(a.cpu().numpy() for a in step)
    t0 = time.perf_counter()
    _res, n_cls = big_classify.host_stats(reads, *arrays,
                                          ix.seq_tax.cpu().numpy())
    host_s = time.perf_counter() - t0
    del step, codes
    rows = {f"{k} (steady)": v for k, v in big_checks(
        ix, reads, smi, dram_ns, f"{READS:,} reads", plain=False).items()}
    log(f"4g steady: {READS:,} reads of {BIG_LEN}: big_mem_step "
        f"{step_s:.4f} s = {READS / step_s:,.1f} reads/s (L "
        f"{rows['big_extend_all (steady)'][1]:.3f} ms, M "
        f"{rows['big_sa_walk (steady)'][1]:.3f} ms); host statistics "
        f"{host_s:.2f} s; with them {READS / (step_s + host_s):,.1f} reads/s;"
        f" {n_cls:,} classified [{smi}]")
    return rows


def start_big_build(letters: int) -> dict:
    """Phase 4g's DB build (parallel.big_index.build_db on every host
    thread) started in a thread of its own, so that it runs beside phases
    4c-4i: the index build releases the GIL.  Returns the box that
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


def run_phase_4g(build: dict, smi: str, dram_ns: float):
    """Phase 4g: the big DB of `build` (start_big_build's box; waits for
    it), then tools.big_classify.run at S = 2 and 8 on the demo's reads
    (each counted from 0), L and M against their plain versions on the
    demo's reads and on a steady step's, S = 8 against S = 2, the oracle
    on the sampled reads.  Returns (measure() tuples, the steady shape's
    as "<name> (steady)", launch counts)."""
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
        f" s on {threads} threads beside phases 4c-4i (waited "
        f"{time.perf_counter() - t0:.1f} s for it here), host peak RSS "
        f"{peak_rss_gb():.1f} GB")
    launches = {k: 0 for k in BIG_KERNELS}
    rows, arrays = {}, {}
    for S in BIG_SHARDS:
        out = os.path.join(work, f"s{S}")
        args = big_classify.parse_args([
            "--letters", str(db["N"] - db["nseq"]), "--threads", str(threads),
            "--shards", str(S), "--reads", str(BIG_READS),
            "--read-len", str(BIG_LEN), "--out", out, "--device", "cuda:0",
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
            rows = big_checks(ix, res["reads"], smi, dram_ns,
                              f"{BIG_READS:,} reads")
            rows.update(steady_big(ix, db, smi, dram_ns))
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


def check_repeats(seed: int, lat_ns: float, nodes: str) -> dict:
    """Phase 3 on the DB with repeats (make_repeats_db), one batch of 4,096
    of its reads: A in both forms at the seed-table build's last depth, B
    on the MEM batch (screened, the hybrid's narrow lanes stopping, on the
    text index; unscreened and not stopping on db.ktx), G on the text
    index's stopped lanes (intervals of 1 to 8 occurrences), C, J on the
    MEM batch's fragments, H on the tie rows' SA positions, B on the
    Greedy batch,
    E at -e 3 (its last level's hybrid on the text index, none on
    db.ktx), D and F on the flat and the deep tree (each gene family
    under one clade), and H, I and K on the inputs the -v pipelines give
    them on the same batch (check_verbose_kernels, the uniform DB's
    nodes.dmp, whose taxa the records name too), against their plain
    versions.  Returns {index tag: check_kernels' dict with
    check_verbose_kernels'}."""
    from kaiju_tpu_torch.index.core import KaijuIndex

    records, ktx, families = make_repeats_db(seed)
    reads = make_reads(seed, records, BATCH)
    out = {}
    for tag in ("fmi", "text"):
        index = KaijuIndex.load(ktx[tag])
        tree = deep_tree(seed)
        out[tag], _inputs = check_kernels(
            index, reads, ktx[tag], lat_ns,
            deep=(deep_seq_tax(tree, index, seed, families), tree))
        out[tag].update(check_verbose_kernels(index, nodes, reads, ktx[tag],
                                              lat_ns)[0])
        log_checks(out[tag], f"repeats, {tag}")
    return out


def fold_errors(checks: dict, name: str, *more: dict) -> None:
    """checks[name]'s error raised to the largest of every check of kernel
    `name` in checks and in `more` (its runs on other trees and DBs), so
    that the kernels line carries them all."""
    err, *rest = checks[name]
    for c in (checks, *more):
        err = max([err] + [v[0] for k, v in c.items()
                           if k == name or k.startswith(name + " (")])
    checks[name] = (err, *rest)


def latency(smi: str) -> tuple[float, float]:
    """Logs the card's dependent-load latency in the L2 (a 16 MiB cycle,
    walked twice) and in device memory (a 256 MiB cycle, on addresses not
    walked before); returns both, in ns."""
    from kaiju_tpu_torch import kernels

    l2 = kernels.chase_ns(1 << 22, cached=True)
    dram = kernels.chase_ns(1 << 26, cached=False)
    log(f"latency: {l2:.1f} ns a dependent load in the L2, {dram:.1f} ns "
        f"in device memory (csrc/chase.cu; {smi})")
    return l2, dram


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


T0 = time.perf_counter()  # the script's start, for the phases' times


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
    lat_ns, dram_ns = latency(smi)

    log(f"time: phase 2 starts at {time.perf_counter() - T0:.1f} s")
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

    if args.only_warm:  # phase 4h alone
        run_phase_4h(records, reads, nodes, secs)
        log("--only-warm: phases 1, 2 and 4h passed; no kernels line")
        return 0

    if args.only_cards:  # phase 4i and the lines it is held against
        tsvs = {mode: {"text": run_cli(indexes["text"], reads, ktx["text"],
                                       nodes, fq, mode, "text")[1]}
                for mode in PATHS}
        run_phase_4i(indexes["text"], reads, ktx["text"], nodes, tsvs,
                     make_reads(args.seed + 1, records, BATCH), smi)
        log("--only-cards: phases 1, 2, 4 on db_text.ktx and 4i passed; no "
            "kernels line")
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.only_hosts or args.only_processes:  # 4f, 4j and their lines
        tsvs = {mode: {"text": run_cli(indexes["text"], reads, ktx["text"],
                                       nodes, fq, mode, "text")[1]}
                for mode in PATHS}
        if args.only_processes:
            run_phase_4f(indexes["text"], reads, ktx["text"], nodes, tsvs,
                         smi)
            log(f"time: 4f ended at {time.perf_counter() - T0:.1f} s")
        if args.only_hosts:
            counts, rows = run_phase_4j(
                indexes, reads, ktx, nodes,
                {m: t["text"] for m, t in tsvs.items()}, lat_ns, smi,
                twins=True)
            log_checks(rows, "4j, text index, 4 shards on hosts a, a, b")
            if any(v[0] for v in rows.values()):
                raise AssertionError("a hosts kernel differs from its plain "
                                     "version")
            log("4j launches: " + json.dumps(
                {k: c for k, c in counts.items() if c}))
            log(f"time: 4j ended at {time.perf_counter() - T0:.1f} s")
        log("--only-processes / --only-hosts: phases 1, 2, 4 on db_text.ktx "
            "and the phases asked for passed; no kernels line")
        if args.only_hosts:
            log(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}))
        return 0

    log(f"time: phase 3 starts at {time.perf_counter() - T0:.1f} s")
    # ---- 3. kernels against their plain versions -----------------------
    checks = {}
    tree = deep_tree(args.seed)
    for tag in ("fmi", "text"):
        checks[tag], inputs = check_kernels(
            indexes[tag], reads, ktx[tag], lat_ns,
            deep=(deep_seq_tax(tree, indexes[tag], args.seed), tree))
        v_checks, v_inputs = check_verbose_kernels(indexes[tag], nodes,
                                                   reads, ktx[tag], lat_ns)
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
    # A, B, G, C, J, E, D, F and H, I, K on the DB with repeats; their
    # errors, D's and F's on the deep tree, H's on the tie rows and K's on
    # one fragment join the line's
    repeats = check_repeats(args.seed, lat_ns, nodes)
    for tag, rc in repeats.items():
        checks["repeats " + tag] = rc
    for name in ("update_si", "update_si_letters", "mem_extend",
                 "text_extend", "mem_stats", "extend_all", "greedy_search",
                 "read_lca", "ranges_lca", "sa_lookup", "extend_from",
                 "greedy_map"):
        fold_errors(checks["text"], name, checks["fmi"], *repeats.values())
    bad = [(t, n) for t, c in checks.items() for n, v in c.items() if v[0]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    gathers, g_launches = check_gather(args.seed)
    if any(v[0] for v in gathers.values()):
        raise AssertionError("P1 or P2 differs from its plain version")

    log(f"time: phase 4 starts at {time.perf_counter() - T0:.1f} s")
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

    log(f"time: phase 4b starts at {time.perf_counter() - T0:.1f} s")
    # ---- 4b. where the time goes ----------------------------------------
    warm = make_reads(args.seed + 1, records, BATCH)
    rates = {}
    for tag in ("text", "fmi"):
        for mode in PATHS:
            rates[mode, tag] = steady_stream(indexes[tag], nodes, reads, warm,
                                             mode, tag)

    # phase 4g's DB builds from here on, beside phases 4c-4i, whose host
    # stages it slows; the steady rates above ran alone
    big_build = start_big_build(BIG_LETTERS)

    log(f"time: phase 4c starts at {time.perf_counter() - T0:.1f} s")
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

    log(f"time: phase 4d starts at {time.perf_counter() - T0:.1f} s")
    # ---- 4d. the taxonomy-free tools and kaiju-multi, on db.ktx, each
    # run counted from 0 ----------------------------------------------------
    work = os.path.dirname(ktx["fmi"])
    for name, (_t, _f, kind, n, _k) in X_RUNS.items():
        items, xfq = x_items(records, reads, args.seed, kind, n, work)
        counts, x_checks, _tsv = run_taxfree(index, ktx["fmi"], items, xfq,
                                             name, lat_ns)
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

    log(f"time: phase 4e starts at {time.perf_counter() - T0:.1f} s")
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

    log(f"time: phase 4f starts at {time.perf_counter() - T0:.1f} s")
    # ---- 4f. many processes, each counted from 0 --------------------------
    proc_launches = run_phase_4f(indexes["text"], reads, ktx["text"], nodes,
                                 tsvs, smi)
    for k, c in proc_launches.items():
        launches[k] += c
    launches.update(g_launches)  # P1, P2: their benchmark's run

    log(f"time: phase 4h starts at {time.perf_counter() - T0:.1f} s")
    # ---- 4h. warm start: mkdb --aot, fresh processes, each counted from 0
    for k, c in run_phase_4h(records, reads, nodes, secs).items():
        launches[k] += c

    log(f"time: phase 4i starts at {time.perf_counter() - T0:.1f} s")
    # ---- 4i. the index over the cards of one process, each run counted
    # from 0; its errors join the sharded kernels' and L's and M's -----------
    card_launches, card_errs = run_phase_4i(indexes["text"], reads,
                                            ktx["text"], nodes, tsvs, warm,
                                            smi)
    for k, c in card_launches.items():
        launches[k] += c
    for k, e in card_errs.items():
        if k in checks["text"]:
            err, *rest = checks["text"][k]
            checks["text"][k] = (max(err, e), *rest)

    log(f"time: phase 4j starts at {time.perf_counter() - T0:.1f} s")
    # ---- 4j. processes on several hosts, each run counted from 0; N, O,
    # Q, W, U, X and V join the line -------------------------------------
    host_launches, host_rows = run_phase_4j(
        indexes, reads, ktx, nodes, {m: t["text"] for m, t in tsvs.items()},
        lat_ns, smi)
    for k, c in host_launches.items():
        launches[k] += c
    log_checks(host_rows, "4j, text index, 4 shards on hosts a, a, b")
    if any(v[0] for v in host_rows.values()):
        raise AssertionError("a hosts kernel differs from its plain version")
    checks["text"].update(host_rows)

    log(f"time: phase 4g starts at {time.perf_counter() - T0:.1f} s")
    # ---- 4g. the index above 2^31 letters, each run counted from 0 ------
    big_rows, big_launches = run_phase_4g(big_build, smi, dram_ns)
    for name, v in big_rows.items():
        log(f"kernel {name}: max_abs_err {v[0]}, {v[1]:.4f} ms (plain "
            f"{v[2]:.3f} ms, bound {v[3]:.4f} ms) [{v[4]}]")
    if any(v[0] for v in big_rows.values()):
        raise AssertionError("L or M differs from its plain version")
    for name in BIG_KERNELS:  # the steady shape's and 4i's errors join
        fold_errors(big_rows, name)
        err, *rest = big_rows[name]
        big_rows[name] = (max(err, card_errs.get(name, 0)), *rest)
        launches[name] += big_launches[name]

    log(f"time: phase 5 starts at {time.perf_counter() - T0:.1f} s")
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
         "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
         "floor_ms": floor_ms(note)}
        for name, (err, ms, plain_ms, bound_ms, note, lib_ms) in rows.items()
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
    if argv[:1] == ["--warm-worker"]:  # one fresh process of phase 4h
        return warm_worker(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20240817)
    ap.add_argument("--db-letters", type=int, default=64_000_000)
    ap.add_argument("--only-processes", action="store_true",
                    help="run phase 4f alone, with the phase 4 lines it is "
                    "held against (for a machine with several cards); no "
                    "kernels line and no result line")
    ap.add_argument("--only-cards", action="store_true",
                    help="run phase 4i alone, with the phase 4 lines it is "
                    "held against (for a machine with several cards); no "
                    "kernels line")
    ap.add_argument("--only-hosts", action="store_true",
                    help="run phase 4j (processes on several hosts, "
                    "labels on this machine, Greedy and MEM) alone, with "
                    "the phase 4 lines it is held against; no kernels line")
    ap.add_argument("--only-warm", action="store_true",
                    help="run phase 4h (warm start) alone after phases 1 "
                    "and 2; no kernels line and no result line")
    args = ap.parse_args(argv)
    try:
        return run(args)
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
