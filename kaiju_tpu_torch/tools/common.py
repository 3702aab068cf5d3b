"""Shared CLI plumbing: index loading, engine selection, output streams."""

from __future__ import annotations

import os
import sys

from ..engine.config import KaijuConfig
from ..index.core import KaijuIndex


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


def make_runner(index, taxonomy, cfg: KaijuConfig, args=None, device=None):
    """The engine for the configuration.  This port runs MEM with a
    taxonomy and without -v on the device; the other modes raise
    NotImplementedError naming the ROADMAP.md item that ports them."""
    if getattr(args, "mesh_index", 0) or (getattr(args, "dist_nprocs", 0) or 0) > 1:
        raise NotImplementedError(
            "--mesh-index / --dist-*: multi-GPU is ROADMAP.md queue 1 item 10"
        )
    if cfg.debug:
        raise NotImplementedError("-d: ROADMAP.md queue 1 item 7")
    if cfg.taxonomy_free:
        raise NotImplementedError(
            "taxonomy-free tools (kaijux, kaijup): ROADMAP.md queue 1 item 8"
        )
    if cfg.verbose:
        raise NotImplementedError("-v: ROADMAP.md queue 1 item 7")
    if cfg.mode != "mem":
        raise NotImplementedError(
            "Greedy (the default -a greedy): ROADMAP.md queue 1 items 5-6; "
            "this port runs -a mem"
        )
    kmer_dir = os.environ.get("KAIJU_TPU_CACHE") or getattr(
        index, "source_dir", None
    )
    from ..engine.mem import MemPipeline

    return MemPipeline(index, taxonomy, cfg, device=device,
                       kmer_cache_dir=kmer_dir)


def classify_stream(runner, reads_iter, out, cfg: KaijuConfig, batch_size=4096):
    """Stream reads in batches through the runner, writing TSV lines."""
    from ..engine.core import format_output_line
    from ..io.fastx import prefetch_batches

    def emit(results):
        for name, res in results:
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
                    help="shard the index over N devices (not ported yet)")
    ap.add_argument("--dist-coordinator", dest="dist_coordinator",
                    help="host:port of process 0 of a multi-process run "
                         "(not ported yet)")
    ap.add_argument("--dist-nprocs", dest="dist_nprocs", type=int,
                    default=0, help="total processes of a multi-process "
                    "run (not ported yet)")
    ap.add_argument("--dist-pid", dest="dist_pid", type=int, default=None,
                    help="this process's id (not ported yet)")


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
