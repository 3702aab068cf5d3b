"""Many processes of the port's `kaiju` on the CPU (--dist-*,
KAIJU_TPU_NPROCS; kaiju_tpu_torch.parallel.multihost and
engine.pipeline.ProcessShare): 2 and 3 processes over gloo on 127.0.0.1,
MEM and Greedy, each with and without --mesh-index 2, with a batch size
that gives 3 processes uneven shares and one of them an empty share of
the last batch, and 2 processes with --mesh-index 4 in Greedy on an index
with a text copy.  Every read must be written by exactly one process, the
one that multihost.local_rows names, and the lines merged by read must be
the single-process TSV byte for byte, which is the ExactClassifier's.
With --mesh-index each process must hold exactly the shards of the
ownership rule (parallel.peer_shards) and map every other shard from
process o mod N, and no file of the mapped shards may outlive the
processes.  MEM and Greedy (the default flags, and -e 0 on two of the
runs) with --mesh-index over processes labelled as several hosts (2 on
hosts a, b at S = 2; 3 on a, a, b at S = 4; with and without a text
copy) must merge to the same TSV, each process holding,
mapping and having served in rounds the shards of the routing rule, with
rounds in every stage of the path.  Each process is
tests/torch_multihost_worker.py."""

import json
import os
import random
import socket
import subprocess
import sys

import pytest

from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.engine.core import ExactClassifier, format_output_line
from kaiju_tpu.index import py_builder as jax_py_builder
from kaiju_tpu.io.taxonomy import Taxonomy
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.parallel.multihost import local_rows
from kaiju_tpu_torch.tools import kaiju as tkaiju

from conftest import make_db_records, write_nodes_dmp
from readgen import make_reads, write_fastq
from test_exact_parity import _diff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_multihost_worker.py")
N_READS, BATCH = 100, 32  # last batch 4 reads: 3 processes get 2, 2, 0
MODES = {"mem": ["-a", "mem"], "greedy": []}
# each run's flags: the modes, and Greedy with no variant level
FLAGS = {**MODES, "greedy-e0": ["-e", "0"]}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = random.Random(171)
    records = make_db_records(rng, nseq=40)
    work = tmp_path_factory.mktemp("torch_multihost")
    nodes_dmp = str(work / "nodes.dmp")
    nodes = write_nodes_dmp(nodes_dmp)
    idx = py_builder.build_index(records)
    ktx_text = str(work / "db_text.ktx")
    idx.save(ktx_text)
    idx.text = None
    ktx = str(work / "db.ktx")
    idx.save(ktx)
    reads = make_reads(rng, records, n=N_READS)
    fq = str(work / "reads.fastq")
    write_fastq(reads, fq)
    return {"work": work, "nodes": nodes, "nodes_dmp": nodes_dmp, "ktx": ktx,
            "ktx_text": ktx_text, "fq": fq, "reads": reads,
            "records": records}


def _single(env, mode, ktx="ktx"):
    """The one-process TSV of the mode on env[ktx] (its run also fills the
    seed-table cache and Bloom bitmaps beside the index, which the
    processes then share) and the ExactClassifier's."""
    key = ("single", mode, ktx)
    if key not in env:
        out = str(env["work"] / f"single_{mode}_{ktx}.tsv")
        assert tkaiju.main(["-t", env["nodes_dmp"], "-f", env[ktx], "-i",
                            env["fq"], *FLAGS[mode], "-b", str(BATCH), "-o",
                            out], device="cpu") == 0
        with open(out) as fh:
            tsv = fh.read()
        cfg = (KaijuConfig(mode="mem", seg=True, use_Evalue=False)
               if mode == "mem" else
               KaijuConfig(mismatches=0 if mode == "greedy-e0" else 3))
        idx = jax_py_builder.build_index(env["records"])
        exact = "".join(format_output_line(n, r, False) for n, r in
                        ExactClassifier(idx, Taxonomy(env["nodes"]), cfg)
                        .classify_batch([(n, s, None)
                                         for n, s in env["reads"]]))
        env[key] = (tsv, exact)
    return env[key]


# the sockets that hold the coordinator ports _free_port gave out
_HELD: list = []


def _free_port():
    """A port for a group's coordinator, held by this test process until
    it exits: a socket bound to it with SO_REUSEADDR and not listening.
    No other bind, of this process or another, gets the port then (a
    port merely found free and let go can go to the next one who asks:
    two groups of concurrent tests with one coordinator port, one group's
    process 0 refused with EADDRINUSE and its peers waiting on a store
    that is not theirs, for c10d's 30 minutes), while the group's process
    0 still listens on it (c10d's store binds with SO_REUSEADDR)."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    _HELD.append(s)
    return s.getsockname()[1]


def _run(env, nprocs, by_env, argv, tag, hosts=None):
    """Start nprocs workers with argv and the process flags (or the
    KAIJU_TPU_* variables), process p on host hosts[p] if given; returns
    each process's output lines."""
    coord = f"127.0.0.1:{_free_port()}"
    procs, outs = [], []
    for p in range(nprocs):
        out = str(env["work"] / f"{tag}_p{p}.tsv")
        outs.append(out)
        # one thread a process: the reads are few, and the lane runs
        # several test files at once
        penv = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT
                    + os.pathsep + os.environ.get("PYTHONPATH", ""))
        if by_env:
            penv.update(KAIJU_TPU_NPROCS=str(nprocs),
                        KAIJU_TPU_COORDINATOR=coord, KAIJU_TPU_PID=str(p))
            dist = []
        else:
            dist = ["--dist-nprocs", str(nprocs), "--dist-coordinator",
                    coord, "--dist-pid", str(p)]
        host = ["--host", hosts[p]] if hosts else []
        if hosts and (p > 0 or len(set(hosts)) == nprocs):
            # a seed-table cache of its own, empty: the group builds the
            # tables by rounds, where process 0 of a, a, b finds them in
            # the index's cache and still serves its peers' rounds
            penv["KAIJU_TPU_CACHE"] = str(env["work"] / f"cache_{tag}_p{p}")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, *host, *argv, *dist, "-o", out], cwd=ROOT,
            env=penv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    errors = []
    try:
        for p, proc in enumerate(procs):
            _o, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                errors.append(f"process {p}: rc {proc.returncode}\n"
                              f"{err[-2000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errors, "\n".join(errors)
    lines = []
    for out in outs:
        with open(out) as fh:
            lines.append(fh.readlines())
    return lines


def _check_run(env, mode, mesh, nprocs, by_env, ktx="ktx", hosts=None):
    """Run nprocs workers on env[ktx] (process p on host hosts[p] if
    given) and check their outputs and, with --mesh-index, their
    shards."""
    single, exact = _single(env, mode, ktx)
    assert single == exact, _diff(single, exact)
    argv = ["-t", env["nodes_dmp"], "-f", env[ktx], "-i", env["fq"],
            *FLAGS[mode], "-b", str(BATCH)]
    if mesh:
        argv += ["--mesh-index", str(mesh)]
    tag = f"{mode}_{mesh}_{nprocs}_{ktx}" + ("_" + "".join(hosts)
                                             if hosts else "")
    lines = _run(env, nprocs, by_env, argv, tag, hosts)
    # the reads each process owns, batch by batch
    names = [n for n, _s in env["reads"]]
    want_owner = {}
    for b0 in range(0, N_READS, BATCH):
        n = min(BATCH, N_READS - b0)
        for p in range(nprocs):
            lo, hi = local_rows(n, nprocs, p)
            for r in range(b0 + lo, b0 + hi):
                want_owner[names[r]] = p
    if nprocs == 3:  # uneven shares of a full batch, an empty last share
        assert [local_rows(BATCH, 3, p) for p in range(3)] == [
            (0, 11), (11, 22), (22, 32)]
        assert local_rows(N_READS % BATCH, 3, 2) == (4, 4)
    by_name = {}
    for p, ls in enumerate(lines):
        for ln in ls:
            name = ln.split("\t")[1]
            assert name not in by_name, f"{name} written twice"
            assert want_owner[name] == p, name
            by_name[name] = ln
    assert sorted(by_name) == sorted(names)
    merged = "".join(by_name[n] for n in names)
    assert merged == single, _diff(merged, single)
    assert merged.count("C\t") > 40
    if mesh:
        _check_shards(env, tag, nprocs, mesh, ktx == "ktx_text",
                      hosts or ["one"] * nprocs, mode)
    return single


def _routes(p, hosts, S):
    """The routing rule, restated: ({shard: process mapped from}, {shard:
    process serving it in rounds}) for process p."""
    N = len(hosts)

    def holds(q):
        return [q % S] if N >= S else [o for o in range(S) if o % N == q]

    opened, remote = {}, {}
    for o in range(S):
        if o in holds(p):
            continue
        near = [q for q in range(N) if hosts[q] == hosts[p] and o in holds(q)]
        if hosts[o % N] == hosts[p]:
            opened[o] = o % N
        elif near:
            opened[o] = min(near)
        else:
            remote[o] = o % N
    return opened, remote


def _check_shards(env, tag, nprocs, S, text, hosts, mode):
    """Each process held exactly its shards (process p: shard p mod S for
    N >= S, the shards o with o mod N = p for N < S), mapped every other
    one of its host from the process the routing rule names (over one
    host: process o mod N), had the others served in rounds (in every
    stage of the mode's path; on the text index the hybrid's stages
    "switch" and "text" ran too, but for -e 0, whose funnel never
    switches: each with rounds in MEM, and "switch" with rounds in Greedy,
    whose few last-level switches of these reads may find every text row
    on their host, over gloo, since CPU slots rule NCCL out), and left no
    file of them behind."""
    stages = ("extend", "variants", "walk") if mode == "greedy" else (
        "extend", "walk")  # no variant level at -e 0
    hybrid = ("switch", "text") if text and mode != "greedy-e0" else ()
    served = stages + (hybrid if mode == "mem" else hybrid[:1])
    arrays = {"rec", "sa_seq", "sa_off"} | ({"text"} if text else set())
    holders = set()
    for p in range(nprocs):
        with open(env["work"] / f"{tag}_p{p}.tsv.shards.json") as fh:
            got = json.load(fh)
        want = ([p % S] if nprocs >= S
                else [o for o in range(S) if o % nprocs == p])
        opened, remote = _routes(p, hosts, S)
        assert got["held"] == want, (p, got)
        assert got["opened"] == {str(o): q for o, q in opened.items()}, (p, got)
        assert got["remote"] == {str(o): q for o, q in remote.items()}, (p, got)
        assert set(got["bytes_held"]) == arrays
        assert all(got["bytes_held"][a] > 0 for a in arrays)
        assert all((got["bytes_opened"][a] > 0) == bool(opened)
                   for a in arrays)
        if len(set(hosts)) > 1:  # every stage ran rounds, over gloo
            assert got["host"] == hosts[p]
            assert got["backend"] == "gloo"  # CPU slots: no NCCL
            assert {"seed", *stages, *hybrid} == set(got["rounds"])
            assert all(got["rounds"][k]["rounds"] > 0 for k in served), (
                got["rounds"])
            assert got["rounds"]["seed"]["queries"] > 0
        else:
            assert not remote and not got["rounds"]
            assert got["backend"] is None
        holders.update(want)
        assert not os.path.exists(got["run_dir"]), got["run_dir"]
    assert holders == set(range(S))


@pytest.mark.parametrize("nprocs, by_env", [(2, False), (3, True)],
                         ids=["2-flags", "3-env"])
@pytest.mark.parametrize("mesh", [0, 2], ids=["flat", "mesh2"])
@pytest.mark.parametrize("mode", list(MODES))
def test_processes_merge_to_the_single_process_tsv(env, mode, mesh, nprocs,
                                                   by_env):
    _check_run(env, mode, mesh, nprocs, by_env)


def test_two_processes_hold_four_text_index_shards_apart(env):
    """N < S: 2 processes, --mesh-index 4, Greedy, on the index with a
    text copy (E's hybrid reads the text shards): two shards held and two
    mapped a process, and the TSV equal to the one from db.ktx."""
    single = _check_run(env, "greedy", 4, 2, False, "ktx_text")
    assert single == _single(env, "greedy")[0]


HOST_RUNS = pytest.mark.parametrize(
    "nprocs, mesh, hosts, by_env", [(2, 2, ["a", "b"], False),
                                    (3, 4, ["a", "a", "b"], True)],
    ids=["2-hosts-ab-mesh2", "3-hosts-aab-mesh4"])


@pytest.mark.parametrize("ktx", ["ktx", "ktx_text"])
@HOST_RUNS
def test_mem_across_hosts_merges_to_the_single_process_tsv(env, nprocs, mesh,
                                                           hosts, by_env,
                                                           ktx):
    """MEM with --mesh-index over processes labelled as several hosts: a
    shard that no process of a host holds is served by its owner in rounds
    (the seed tables, O's steps, Q's walks, and on the text index the
    hybrid's walks and text rows, stages "switch" and "text", each of
    which ran rounds); the merged TSV is the single-process TSV and the
    ExactClassifier's, with and without a text copy."""
    single = _check_run(env, "mem", mesh, nprocs, by_env, ktx, hosts)
    if ktx == "ktx_text":
        assert single == _single(env, "mem")[0]


@pytest.mark.parametrize("ktx", ["ktx", "ktx_text"])
@HOST_RUNS
def test_greedy_across_hosts_merges_to_the_single_process_tsv(
        env, nprocs, mesh, hosts, by_env, ktx):
    """Greedy (the default flags, -e 3) with --mesh-index over processes
    labelled as several hosts: the seed tables, O's steps, X's variant
    steps (each level's rounds) and Q's walks of a remote shard are served
    by its owner in rounds, and on the text index the last level's
    switched variants' walks and text rows (stages "switch" and "text",
    each of which ran rounds); the merged TSV is the single-process TSV
    and the ExactClassifier's, with and without a text copy."""
    single = _check_run(env, "greedy", mesh, nprocs, by_env, ktx, hosts)
    if ktx == "ktx_text":
        assert single == _single(env, "greedy")[0]


@pytest.mark.parametrize("nprocs, mesh, hosts, by_env, ktx", [
    (2, 2, ["a", "b"], False, "ktx"), (3, 4, ["a", "a", "b"], True,
                                       "ktx_text")],
    ids=["2-hosts-ab-mesh2-ktx", "3-hosts-aab-mesh4-ktx_text"])
def test_greedy_e0_across_hosts_merges_to_the_single_process_tsv(
        env, nprocs, mesh, hosts, by_env, ktx):
    """Greedy with -e 0 (no variant level: U's level 0 writes the rows and
    no "variants" round runs) over processes labelled as several hosts:
    the merged TSV is the single-process TSV and the ExactClassifier's."""
    _check_run(env, "greedy-e0", mesh, nprocs, by_env, ktx, hosts)
