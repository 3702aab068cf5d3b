"""The port's verbose paths on the CPU: kaiju_tpu_torch.engine.mem_fast
(`kaiju -a mem -v`) and engine.greedy_fast (`kaiju -v`) must write, byte
for byte, the verbose TSV (score, taxon ids, accessions, matched
fragments in pop order) of kaiju_tpu's MemFastPipeline / GreedyFastPipeline
with verbose=True (SEG on and off, a two-batch stream) and of the host
ExactClassifier with verbose=True (those cases, -p, paired reads, a forced
flush of the fragment memo, a fragment with more than TIE_CAP ties that
goes through kernel J, and an index with a text copy: screen on, hybrid
off).  The CLI: `-v` prints kaiju_tpu's parameter dump on stderr, `-d`
writes kaiju_tpu's stdout and stderr trace, the multi-GPU flags raise, and
make_runner sends the taxonomy-free tools to BatchRunner.

The JAX pipelines run in one fresh subprocess, started with the module's
fixture and read by the tests at the end of the file, so that its XLA:CPU
compiles overlap the port's runs."""

import json
import random
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.engine.core import ExactClassifier, format_output_line
from kaiju_tpu.index import py_builder as jax_py_builder
from kaiju_tpu.io.taxonomy import Taxonomy
from kaiju_tpu.tools import common as jax_common
from kaiju_tpu.tools import kaiju as jax_kaiju
from kaiju_tpu_torch.engine import mem_fast
from kaiju_tpu_torch.engine.batch import BatchRunner
from kaiju_tpu_torch.engine.config import KaijuConfig as TorchConfig
from kaiju_tpu_torch.engine.greedy_fast import GreedyFastPipeline
from kaiju_tpu_torch.engine.pipeline import DevicePipeline
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.io.taxonomy import Taxonomy as TorchTaxonomy
from kaiju_tpu_torch.ops.search import TIE_CAP
from kaiju_tpu_torch.tools import common
from kaiju_tpu_torch.tools import kaiju as tkaiju

from conftest import make_db_records, random_protein, write_nodes_dmp
from readgen import (make_protein_reads, make_reads, reverse_translate,
                     write_fastq)
from test_exact_parity import _diff, _lowcomp_reads

# (mode, SEG) of the JAX comparisons
CONFIGS = {
    "mem_seg": ("mem", True),
    "mem_noseg": ("mem", False),
    "greedy_seg": ("greedy", True),
    "greedy_noseg": ("greedy", False),
}

WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.engine.core import format_output_line
from kaiju_tpu.engine.greedy_fast import GreedyFastPipeline
from kaiju_tpu.engine.mem_fast import MemFastPipeline
from kaiju_tpu.index import py_builder
from kaiju_tpu.io.taxonomy import Taxonomy, parse_nodes_dmp

job = json.load(open(sys.argv[1]))
index = py_builder.build_index(job["records"])
index.text = None  # the .fmi configuration: no screen
tax = Taxonomy(parse_nodes_dmp(job["nodes_dmp"]))
reads = [tuple(r) for r in job["reads"]]
half = len(reads) // 2
out = {}
for name, (mode, seg) in job["configs"].items():
    cfg = KaijuConfig(mode=mode, seg=seg, verbose=True,
                      use_Evalue=mode == "greedy")
    Pipe = MemFastPipeline if mode == "mem" else GreedyFastPipeline
    pipe = Pipe(index, tax, cfg)
    assert pipe._bloom_words is None
    out[name] = "".join(format_output_line(n, r, True)
                        for res in pipe.classify_stream([reads[:half],
                                                         reads[half:]])
                        for n, r in res)
json.dump(out, open(sys.argv[2], "w"))
"""


def _tsv(results):
    return "".join(format_output_line(n, r, True) for n, r in results)


def _config(mode, seg=True, protein=False):
    return KaijuConfig(mode=mode, seg=seg, verbose=True,
                       use_Evalue=mode == "greedy", input_is_protein=protein)


def _motif_reads(rng, records, n):
    """Periodic DB motifs: fragments with more ties than TIE_CAP."""
    out = []
    for t in range(n):
        _, prot = records[rng.randrange(len(records))]
        st = rng.randrange(0, len(prot) - 14)
        out.append((f"rep{t}", reverse_translate(
            rng, ("W" + prot[st:st + 14]) * 9), None))
    return out


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = random.Random(151)
    records = make_db_records(rng, nseq=40)
    work = tmp_path_factory.mktemp("torch_verbose_pipeline")
    nodes_dmp = str(work / "nodes.dmp")
    nodes = write_nodes_dmp(nodes_dmp)
    reads = [(n, s, None) for n, s in make_reads(rng, records, n=150)
             + _lowcomp_reads(rng, records, n=30)] + _motif_reads(
                 rng, records, 6)
    job = {"records": records, "nodes_dmp": nodes_dmp, "configs": CONFIGS,
           "reads": reads}
    job_path, out_path = str(work / "job.json"), str(work / "jax.json")
    with open(job_path, "w") as fh:
        json.dump(job, fh)
    proc = subprocess.Popen([sys.executable, "-c", WORKER, job_path,
                             out_path], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)

    def jax_tsv():
        if "jax" not in env_:
            _out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-3000:]
            with open(out_path) as fh:
                env_["jax"] = json.load(fh)
        return env_["jax"]

    tidx = py_builder.build_index(records)
    notext = py_builder.build_index(records)
    notext.text = None
    env_ = {
        "records": records, "nodes": nodes, "nodes_dmp": nodes_dmp,
        "work": work, "reads": reads, "jax_tsv": jax_tsv,
        "jidx": jax_py_builder.build_index(records),
        "index": {"fmi": notext, "text": tidx},
    }
    yield env_
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _exact(env, cfg, items):
    """ExactClassifier's verbose TSV, computed once per configuration and
    reads."""
    key = (repr(cfg), tuple(items))
    cache = env.setdefault("exact", {})
    if key not in cache:
        cache[key] = _tsv(ExactClassifier(
            env["jidx"], Taxonomy(env["nodes"]), cfg).classify_batch(items))
    return cache[key]


def _port(env, cfg, batches, tag="fmi", **attrs):
    """(the port's verbose TSV over the batches, the pipeline); seed tables
    and bitmaps cached per index in the work directory."""
    Pipe = mem_fast.MemFastPipeline if cfg.mode == "mem" else GreedyFastPipeline
    cache = env["work"] / f"cache_{tag}"
    cache.mkdir(exist_ok=True)
    pipe = Pipe(env["index"][tag], TorchTaxonomy(env["nodes"]), cfg,
                device="cpu", kmer_cache_dir=str(cache))
    for k, v in attrs.items():
        setattr(pipe, k, v)
    tsv = "".join(_tsv(r) for r in pipe.classify_stream(batches))
    return tsv, pipe


def _check(port, exact, n_reads):
    assert port == exact, _diff(port, exact)
    verbose = [ln for ln in port.splitlines() if ln.startswith("C")]
    assert len(verbose) > n_reads // 3
    assert all(len(ln.split("\t")) == 7 for ln in verbose)  # -v columns


@pytest.mark.parametrize("mode", ["mem", "greedy"])
def test_verbose_protein_input(env, mode):
    items = [(n, s, None) for n, s in
             make_protein_reads(random.Random(152), env["records"], n=60)]
    cfg = _config(mode, protein=True)
    port, _pipe = _port(env, cfg, [items])
    _check(port, _exact(env, cfg, items), len(items))


@pytest.mark.parametrize("mode", ["mem", "greedy"])
def test_verbose_paired_reads(env, mode):
    rng = random.Random(153)
    r1 = make_reads(rng, env["records"], n=60)
    r2 = make_reads(rng, env["records"], n=60)
    items = [(r1[i][0], r1[i][1], r2[i][1]) for i in range(60)]
    cfg = _config(mode)
    port, _pipe = _port(env, cfg, [items])
    _check(port, _exact(env, cfg, items), len(items))


@pytest.mark.parametrize("mode", ["mem", "greedy"])
def test_verbose_forced_cache_flush(env, mode):
    """A fragment memo capped at 20 fragments: the stream drains and the
    memo is dropped between batches, and the TSV does not change."""
    items = env["reads"]
    cfg = _config(mode)
    port, pipe = _port(env, cfg, [items[i:i + 40] for i in range(0, 160, 40)],
                       _cache_cap=20)
    full, ref = _port(env, cfg, [items[:160]])
    assert len(ref._frags) > len(pipe._frags)
    assert port == full, _diff(port, full)
    _check(port, _exact(env, cfg, items[:160]), 160)


def test_mem_verbose_tie_overflow_runs_kernel_j(env, monkeypatch):
    """Nine DB peptides P1..P9 and a read whose fragment is P1 W P2 W ..
    P9: nine ties of the longest length, more than TIE_CAP, so the
    fragment's map is recomputed in full through extend_all (kernel J);
    the TSV equals the ExactClassifier's."""
    rng = random.Random(154)
    peps = []
    while len(peps) < 9:
        p = random_protein(rng, 12).replace("W", "A")
        if p not in peps:
            peps.append(p)
    records = [(f"PEP{i}.1_{[101, 102, 201][i % 3]}", p)
               for i, p in enumerate(peps)]
    records += [(f"RND{i}.1_301", random_protein(rng, 200)) for i in range(20)]
    reads = [(f"tie{t}", reverse_translate(rng, "W".join(peps)), None)
             for t in range(3)]
    reads += [(n, s, None) for n, s in make_reads(rng, records[9:], n=20)]
    idx = py_builder.build_index(records)
    idx.text = None
    calls = []
    real = mem_fast.extend_all

    def counted(*args):
        calls.append(args[2].shape)
        return real(*args)

    monkeypatch.setattr(mem_fast, "extend_all", counted)
    cfg = _config("mem")
    pipe = mem_fast.MemFastPipeline(idx, TorchTaxonomy(env["nodes"]), cfg,
                                    device="cpu")
    port = _tsv(pipe.classify_batch(reads))
    exact = _tsv(ExactClassifier(jax_py_builder.build_index(records),
                                 Taxonomy(env["nodes"]), cfg)
                 .classify_batch(reads))
    assert port == exact, _diff(port, exact)
    assert calls and calls[0][0] == 1  # one fragment, once
    tie_line = port.splitlines()[0].split("\t")
    assert tie_line[0] == "C" and tie_line[3] == "12"
    assert len(tie_line[5].rstrip(",").split(",")) == 9 > TIE_CAP  # accs
    assert sum(1 for u in range(len(pipe._frags))
               if len(pipe._stats[u][1]) > TIE_CAP) == 1


@pytest.mark.parametrize("mode", ["mem", "greedy"])
def test_verbose_text_index(env, mode):
    """On an index with a text copy B screens its lanes (bitmap at m = -m
    for MEM, Lmap for Greedy, cached next to the index) and the hybrid
    stays off, as in kaiju_tpu's -v paths."""
    items = env["reads"]
    cfg = _config(mode)
    port, pipe = _port(env, cfg, [items[:90], items[90:]], tag="text")
    # the hybrid is DevicePipeline's; the -v pipelines build on DeviceSetup
    assert pipe._bloom is not None and not isinstance(pipe, DevicePipeline)
    assert getattr(pipe, "_hyb", None) is None
    m = 11 if mode == "mem" else 7
    assert pipe._bloom[1] == m
    assert any(p.name.startswith(f"bloom_m{m}_")
               for p in (env["work"] / "cache_text").iterdir())
    _check(port, _exact(env, cfg, items), len(items))


@pytest.mark.parametrize("mode", ["mem", "greedy"])
def test_cli_verbose_prints_parameters(env, capsys, mode):
    """main([... "-v"], device="cpu") on a saved .ktx: kaiju_tpu's
    parameter dump on stderr, and the ExactClassifier's verbose TSV."""
    work = env["work"]
    ktx = str(work / "db.ktx")
    env["index"]["fmi"].save(ktx)
    fq = str(work / "reads_v.fastq")
    reads = [(n, s) for n, s, _ in env["reads"][:60]]
    write_fastq(reads, fq)
    out = str(work / f"out_v_{mode}.tsv")
    flags = ["-a", "mem"] if mode == "mem" else []
    argv = ["-t", env["nodes_dmp"], "-f", ktx, "-i", fq, *flags, "-v",
            "-o", out, "-b", "32"]
    capsys.readouterr()
    assert tkaiju.main(argv, device="cpu") == 0
    err = capsys.readouterr().err
    args = jax_kaiju.build_parser().parse_args(argv)
    jax_common.print_verbose_parameters(jax_common.config_from_args(args),
                                        args)
    want = capsys.readouterr().err
    assert err == want and want.startswith("Parameters: \n")
    with open(out) as fh:
        got = fh.read()
    exact = _exact(env, _config(mode), [(n, s, None) for n, s in reads])
    assert got == exact, _diff(got, exact)


@pytest.mark.parametrize("mode", ["mem", "greedy"])
def test_cli_debug_trace_matches_jax(env, capsys, mode):
    """main([... "-d"], device="cpu"): the same stdout TSV and stderr
    trace as kaiju_tpu.tools.kaiju.main with -d (the host engine on both
    sides); with --mesh-index the port exits, since kaiju_tpu drops the
    trace there (ROADMAP.md queue 3)."""
    work = env["work"]
    ktx = str(work / "db_d.ktx")
    env["index"]["fmi"].save(ktx)
    fq = str(work / "reads_d.fastq")
    write_fastq([(n, s) for n, s, _ in env["reads"][:24]], fq)
    flags = ["-a", "mem"] if mode == "mem" else []
    argv = ["-t", env["nodes_dmp"], "-f", ktx, "-i", fq, *flags, "-d"]
    capsys.readouterr()
    assert tkaiju.main(argv, device="cpu") == 0
    port = capsys.readouterr()
    assert jax_kaiju.main(argv) == 0
    want = capsys.readouterr()
    assert port.out == want.out and port.err == want.err
    assert "Searching fragment " in port.err and port.out.count("\n") == 24
    with pytest.raises(SystemExit, match="-d traces reads"):
        tkaiju.main(argv + ["--mesh-index", "2"], device="cpu")


V_ONLY = "--mesh-index / --dist-\\* support mem and greedy modes without -v"
NO_COORD = "multi-process run needs --dist-coordinator"
COORD = {"dist_nprocs": 2, "dist_coordinator": "127.0.0.1:1", "dist_pid": 1}


def _kmer_cache(env, monkeypatch):
    """One seed-table cache for the pipelines make_runner builds here."""
    path = env["work"] / "kmer_fmi"
    path.mkdir(exist_ok=True)
    monkeypatch.setenv("KAIJU_TPU_CACHE", str(path))


@pytest.mark.parametrize("what, args, expect", [
    ({"taxonomy_free": True}, None, "BatchRunner"),
    ({"taxonomy_free": True, "verbose": True, "mode": "mem",
      "use_Evalue": False}, None, "BatchRunner"),
    ({"verbose": True, "taxonomy_free": True}, SimpleNamespace(mesh_index=2),
     V_ONLY),
    ({"debug": True}, SimpleNamespace(**COORD), "-d traces reads"),
    ({}, SimpleNamespace(mesh_index=2), "ShardedGreedyPipeline"),
    ({"mode": "mem", "use_Evalue": False, "verbose": True},
     SimpleNamespace(mesh_index=2), V_ONLY),
    ({"mode": "mem", "use_Evalue": False, "debug": True},
     SimpleNamespace(mesh_index=1), "-d traces reads"),
    ({"mode": "mem", "use_Evalue": False, "taxonomy_free": True},
     SimpleNamespace(mesh_index=2), V_ONLY),
    ({"mode": "mem", "use_Evalue": False}, SimpleNamespace(
        mesh_index=2, dist_nprocs=2), NO_COORD),
])
def test_make_runner_refuses_unported_modes(env, monkeypatch, what, args,
                                           expect):
    """make_runner routes as kaiju_tpu's: --mesh-index with Greedy (the
    default) and a taxonomy gets ShardedGreedyPipeline, all shards on the
    one device; --mesh-index or many processes with -v or a taxonomy-free
    tool exit with kaiju_tpu's message, and many processes without a
    coordinator too, before anything is built or joined; -d with either
    exits, naming why (kaiju_tpu drops the trace there).  The
    taxonomy-free tools (kaijux, kaijup), MEM and Greedy, with or without
    -v, get the coroutine runner BatchRunner."""
    cfg = TorchConfig(**{"mode": "greedy", **what})
    if expect == "BatchRunner":
        runner = common.make_runner(env["index"]["fmi"], None, cfg, args=args,
                                    device="cpu")
        assert isinstance(runner, BatchRunner) and runner.cfg is cfg
        assert runner.dev.device == torch.device("cpu")
        return
    if expect == "ShardedGreedyPipeline":
        _kmer_cache(env, monkeypatch)
        runner = common.make_runner(env["index"]["fmi"],
                                    TorchTaxonomy(env["nodes"]), cfg,
                                    args=args, device="cpu")
        assert type(runner).__name__ == expect and runner.cfg is cfg
        assert runner.dev.S == 2 and runner.device == torch.device("cpu")
        return
    with pytest.raises(SystemExit, match=expect):
        common.make_runner(env["index"]["fmi"], TorchTaxonomy(env["nodes"]),
                           cfg, args=args, device="cpu")


@pytest.mark.parametrize("mesh_index", [0, 2])
def test_make_runner_refuses_kaiju_tpu_nprocs(env, monkeypatch, mesh_index):
    """KAIJU_TPU_NPROCS > 1 starts a multi-process run, as in kaiju_tpu:
    without KAIJU_TPU_COORDINATOR it exits with kaiju_tpu's message before
    it joins anything; with it, process KAIJU_TPU_PID joins the group and
    then takes its cards over it (both stubbed here, the cards the
    caller's; tests/test_torch_multihost.py and test_torch_dist_cards.py
    run real processes) and gets its ProcessShare of the pipeline the
    other flags choose; 1 is a single-process run."""
    from kaiju_tpu_torch.engine.pipeline import ProcessShare
    from kaiju_tpu_torch.parallel import multihost

    cfg = TorchConfig(mode="mem", use_Evalue=False)
    args = SimpleNamespace(mesh_index=mesh_index)
    tax = TorchTaxonomy(env["nodes"])
    want = "ShardedMemPipeline" if mesh_index else "MemPipeline"
    _kmer_cache(env, monkeypatch)
    joined = []
    monkeypatch.setattr(multihost, "init_distributed",
                        lambda *a: joined.append(a))
    monkeypatch.setattr(multihost, "process_cards", lambda group, device: (
        joined.append(("cards", device)), multihost.local_cards(device))[1])
    monkeypatch.setenv("KAIJU_TPU_NPROCS", "2")
    with pytest.raises(SystemExit, match=NO_COORD):
        common.make_runner(env["index"]["fmi"], tax, cfg, args=args,
                           device="cpu")
    assert joined == []
    monkeypatch.setenv("KAIJU_TPU_COORDINATOR", "127.0.0.1:29400")
    monkeypatch.setenv("KAIJU_TPU_PID", "1")
    runner = common.make_runner(env["index"]["fmi"], tax, cfg, args=args,
                                device="cpu")
    assert joined == [("127.0.0.1:29400", 2, 1), ("cards", "cpu")]
    assert isinstance(runner, ProcessShare)
    assert (runner.nprocs, runner.pid) == (2, 1)
    assert type(runner.pipe).__name__ == want
    monkeypatch.setenv("KAIJU_TPU_NPROCS", "1")
    runner = common.make_runner(env["index"]["fmi"], tax, cfg, args=args,
                                device="cpu")
    assert type(runner).__name__ == want


@pytest.mark.parametrize("name", list(CONFIGS))
def test_verbose_tsv_matches_jax_and_exact(env, name):
    """SEG on and off, a two-batch stream, on the .fmi configuration (no
    screen): the port's TSV equals kaiju_tpu's -v pipelines' and the
    ExactClassifier's.  The motif reads send fragments through kernel J
    on the port and through kaiju_tpu's extend_all."""
    mode, seg = CONFIGS[name]
    items = env["reads"]
    cfg = _config(mode, seg=seg)
    half = len(items) // 2
    port, pipe = _port(env, cfg, [items[:half], items[half:]])
    _check(port, _exact(env, cfg, items), len(items))
    want = env["jax_tsv"]()[name]
    assert port == want, _diff(port, want)
    if mode == "mem":
        assert any(len(s[1]) > TIE_CAP for s in pipe._stats if s)
