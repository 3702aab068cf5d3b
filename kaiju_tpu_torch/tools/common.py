"""Shared CLI plumbing: index loading, engine selection, output streams."""

from __future__ import annotations

import os
import sys

from .. import kernels
from ..engine.config import KaijuConfig
from ..index.core import KaijuIndex
from ..ops.device_index import resolve_device


def load_index(path: str) -> KaijuIndex:
    """Load either a reference-format .fmi file or a ktx directory."""
    if os.path.isdir(path):
        return KaijuIndex.load(path)
    from ..index import fmi_reader

    return fmi_reader.read_fmi(path)


def open_output(path: str | None):
    if path:
        return open(path, "w")
    return sys.stdout


def _kmer_dir(index):
    """Where the seed tables, the Bloom bitmaps and the prebuilt kernel
    libraries are cached: KAIJU_TPU_CACHE, else beside the index."""
    return os.environ.get("KAIJU_TPU_CACHE") or getattr(
        index, "source_dir", None)


def make_runner(index, taxonomy, cfg: KaijuConfig, args=None, device=None):
    """The engine for the configuration, as kaiju_tpu chooses it: -d runs
    the host ExactClassifier (its per-fragment stderr trace interleaves as
    in the reference's single-threaded run, ConsumerThread.cpp:437-470);
    the taxonomy-free tools (kaijux, kaijup), with or without -v, run the
    coroutine runner engine.batch.BatchRunner on the device; -v runs the
    host-tail pipelines on the device (engine.mem_fast,
    engine.greedy_fast), whose lines carry the names and fragments; MEM and
    Greedy otherwise run the device pipelines (engine.mem, engine.greedy),
    or with --mesh-index S their index-sharded forms
    (parallel.sharded_fused).

    device: None for the card (with --mesh-index in one process, every
    visible card; in a group of processes, the process's share of its
    machine's cards), "cpu" for the plain versions, or a list of devices,
    the cards of the process in order, where a device may repeat (["cpu"]
    * 4: four slots on the CPU; ["cuda:0", "cuda:0"]: two data rows on one
    card); a run in one process without --mesh-index takes a list's first
    device.  With --mesh-index S in one process the shards lie over those
    cards (ShardedIndex.on_cards) and each card runs a pipeline on its
    share of every batch (engine.pipeline.CardShare), as kaiju_tpu's mesh
    spans the process's devices; on one card, the pipeline itself.

    Many processes (--dist-nprocs N > 1 with --dist-coordinator and
    --dist-pid, or KAIJU_TPU_NPROCS, _COORDINATOR and _PID, which kaiju_tpu
    reads too) join a group (parallel.multihost), and then each takes its
    cards (multihost.process_cards: the caller's, else its share of its
    machine's; every process as many) and runs the pipeline the other
    flags choose on each of them, each card on its share of the process's
    share of every batch (engine.pipeline.ProcessShare over a CardShare;
    on one card, over the pipeline).  Without --mesh-index every card
    holds the whole index; with --mesh-index S each card holds only its
    shards, reading the others from the process's other cards or mapping
    them from the processes of its host that hold them
    (ShardedIndex.in_group, parallel.peer_shards); over processes on
    several hosts, the steps whose rows lie on another host are served by
    their owners in rounds (parallel.exchange), in MEM and in Greedy.  As
    in kaiju_tpu, --mesh-index and many processes run MEM and Greedy
    without -v, and a taxonomy-free tool or -v exits with its message; -d
    exits too, since the trace needs the one-process host engine
    (kaiju_tpu drops the trace there)."""
    n_index = int(getattr(args, "mesh_index", 0) or 0)
    nprocs = int(getattr(args, "dist_nprocs", 0)
                 or os.environ.get("KAIJU_TPU_NPROCS", 0) or 0)
    pid = 0
    if nprocs > 1:
        coord = (getattr(args, "dist_coordinator", None)
                 or os.environ.get("KAIJU_TPU_COORDINATOR"))
        pid = int(getattr(args, "dist_pid", None)
                  or os.environ.get("KAIJU_TPU_PID", 0) or 0)
        if not coord:
            raise SystemExit("multi-process run needs --dist-coordinator "
                             "(or KAIJU_TPU_COORDINATOR)")
    if n_index or nprocs > 1:
        if cfg.verbose or cfg.taxonomy_free:
            raise SystemExit("--mesh-index / --dist-* support mem and greedy "
                             "modes without -v")
        if cfg.debug:
            raise SystemExit("-d traces reads through the host engine in "
                             "one process: it does not run with --mesh-index"
                             " / --dist-*")
    group = None
    if nprocs > 1:
        import torch.distributed as dist

        from ..parallel import multihost

        multihost.init_distributed(coord, nprocs, pid)
        group = dist.group.WORLD
        cards = multihost.process_cards(group, device)
    elif n_index:
        from ..parallel import multihost

        cards = multihost.local_cards(device)
    else:
        cards = [device[0] if isinstance(device, (list, tuple)) else device]
    if cfg.debug:
        from ..engine.core import ExactClassifier

        return ExactClassifier(index, taxonomy, cfg)
    kmer_dir = _kmer_dir(index)
    for card in dict.fromkeys(cards):
        if resolve_device(card).type == "cuda":
            # the kernel libraries that mkdb --aot prebuilt beside the
            # index or in KAIJU_TPU_CACHE, where their key matches
            # (utils/aot.py)
            kernels.use_prebuilt(kmer_dir, card)
    device = cards[0]
    if cfg.taxonomy_free:
        from ..engine.batch import BatchRunner

        return BatchRunner(index, taxonomy, cfg, device=device)
    if cfg.verbose:
        if cfg.mode == "greedy":
            from ..engine.greedy_fast import GreedyFastPipeline as Pipeline
        else:
            from ..engine.mem_fast import MemFastPipeline as Pipeline
        return Pipeline(index, taxonomy, cfg, device=device,
                        kmer_cache_dir=kmer_dir)
    if n_index:
        from ..parallel import sharded_fused
        from ..parallel.sharded_index import ShardedIndex

        Pipeline = (sharded_fused.ShardedGreedyPipeline
                    if cfg.mode == "greedy"
                    else sharded_fused.ShardedMemPipeline)
        views = (ShardedIndex.in_group(index, n_index, cards, group)
                 if group is not None else
                 ShardedIndex.on_cards(index, n_index, cards))

        def make(c):
            return Pipeline(index, taxonomy, cfg, n_index,
                            kmer_cache_dir=kmer_dir, view=views[c])
    else:
        if cfg.mode == "greedy":
            from ..engine.greedy import GreedyPipeline as Pipeline
        else:
            from ..engine.mem import MemPipeline as Pipeline

        def make(c):
            return Pipeline(index, taxonomy, cfg, device=cards[c],
                            kmer_cache_dir=kmer_dir)
    if len(cards) > 1:
        from ..engine.pipeline import CardShare

        pipe = CardShare(make, cards)
    else:
        pipe = make(0)
    if nprocs > 1:
        from ..engine.pipeline import ProcessShare

        return ProcessShare(pipe, nprocs, pid)
    return pipe


def print_verbose_parameters(cfg: KaijuConfig, args, multi=False) -> None:
    """-v startup parameter dump, line-identical to the reference
    (reference: src/kaiju.cpp:204-221, kaiju-multi.cpp:205-219)."""
    err = sys.stderr
    err.write("Parameters: \n")
    err.write(
        f"  run mode: {'MEM' if cfg.mode == 'mem' else 'Greedy'}\n"
    )
    err.write(f"  minimum match length: {cfg.min_fragment_length}\n")
    if cfg.mode == "greedy":
        err.write(f"  seed length: {cfg.seed_length}\n")
        err.write(
            f"  minimum blosum62 score for matches: {cfg.min_score}\n"
        )
        err.write(f"  minimum E-value: {cfg.min_Evalue:g}\n")
        err.write(
            f"  max number of mismatches within a match: {cfg.mismatches}\n"
        )
    s = "s" if multi else ""
    err.write(f"  input file{s} 1: {args.input1}\n")
    if getattr(args, "input2", None):
        err.write(f"  input file{s} 2: {args.input2}\n")
    if multi:
        err.write(f"  output files: {getattr(args, 'output', '') or ''}\n")
    elif getattr(args, "output", None):
        err.write(f"  output file: {args.output}\n")
    else:
        err.write("  output to STDOUT\n")
    err.flush()


def classify_stream(runner, reads_iter, out, cfg: KaijuConfig, batch_size=4096):
    """Stream reads in batches through the runner, writing TSV lines (the
    taxonomy-free form for kaijux and kaijup); a None result is a read
    that another process writes."""
    from ..engine.core import format_output_line, format_output_line_x
    from ..io.fastx import prefetch_batches

    def emit(results):
        for item in results:
            if item is None:  # many processes: a read a peer owns
                continue
            name, res = item
            if cfg.taxonomy_free:
                out.write(format_output_line_x(name, res))
            else:
                out.write(format_output_line(name, res, cfg.verbose))
        out.flush()

    batches = prefetch_batches(reads_iter, batch_size)
    if hasattr(runner, "classify_stream"):
        for results in runner.classify_stream(batches):
            emit(results)
    else:
        for batch in batches:
            emit(runner.classify_batch(batch))


def add_engine_args(ap, protein_tool=False):
    ap.add_argument("-f", dest="fmi", required=True, help="database (.fmi or .ktx) file")
    ap.add_argument("-i", dest="input1", required=True, help="input reads (FASTA/FASTQ)")
    if not protein_tool:
        ap.add_argument("-j", dest="input2", help="second file for paired-end reads")
    ap.add_argument("-o", dest="output", help="output file (default: stdout)")
    ap.add_argument("-z", dest="threads", type=int, default=1, help="worker threads (compat; batching is automatic)")
    ap.add_argument("-a", dest="mode", choices=["mem", "greedy"], default="greedy")
    ap.add_argument("-e", dest="mismatches", type=int, default=3)
    ap.add_argument("-m", dest="min_fragment_length", type=int, default=11)
    ap.add_argument("-s", dest="min_score", type=int, default=65)
    ap.add_argument("-E", dest="min_evalue", type=float, default=0.01)
    ap.add_argument("-l", dest="seed_length", type=int, default=7)
    ap.add_argument("-x", dest="seg", action="store_true", default=True,
                    help="enable SEG low complexity filter (default)")
    ap.add_argument("-X", dest="seg", action="store_false",
                    help="disable SEG low complexity filter")
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("-d", dest="debug", action="store_true",
                    help="per-read debug tracing on stderr (runs the "
                         "exact host engine)")
    ap.add_argument("-b", dest="batch_size", type=int, default=4096,
                    help="reads per device batch")
    ap.add_argument("--mesh-index", dest="mesh_index", type=int, default=0,
                    help="split the index into N shards (MEM and Greedy "
                         "without -v; 0 = one index) over every card of "
                         "the process, each card classifying its share of "
                         "every batch; with --dist-* over every card of "
                         "every process, each card holding its shards and "
                         "reading or mapping the others")
    ap.add_argument("--dist-coordinator", dest="dist_coordinator",
                    help="host:port of process 0 of a multi-process run "
                         "(or KAIJU_TPU_COORDINATOR)")
    ap.add_argument("--dist-nprocs", dest="dist_nprocs", type=int,
                    default=0, help="total processes of a multi-process "
                    "run, each classifying and writing its share of every "
                    "batch (or KAIJU_TPU_NPROCS)")
    ap.add_argument("--dist-pid", dest="dist_pid", type=int, default=None,
                    help="this process's id, 0..N-1 (or KAIJU_TPU_PID)")


def config_from_args(args, taxonomy_free=False, protein=False) -> KaijuConfig:
    cfg = KaijuConfig(
        mode=args.mode,
        seg=args.seg,
        verbose=args.verbose,
        debug=getattr(args, "debug", False),
        min_fragment_length=args.min_fragment_length,
        mismatches=args.mismatches,
        min_score=args.min_score,
        seed_length=args.seed_length,
        min_Evalue=args.min_evalue,
        use_Evalue=(args.mode == "greedy"),
        taxonomy_free=taxonomy_free,
        input_is_protein=protein or getattr(args, "protein", False),
    )
    cfg.validate()
    return cfg
