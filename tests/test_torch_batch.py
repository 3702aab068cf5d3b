"""The port's coroutine runner (kaiju_tpu_torch.engine.batch.BatchRunner)
and the tools it serves, kaijux and kaijup, with kaiju-multi, on the CPU.

- The plain versions of the kernels the runner launches against
  kaiju_tpu's blocks/occ forms: A (update_si_plain) against
  probe_updates, I's code-row form (extend_rows) against extend_from, H
  (sa_lookup_plain) against sa_lookup, on the test DB and on one whose BWT
  length is a multiple of 128, probed at s1 = length.  Integer outputs,
  tolerance 0.
- The runner's taxonomy-free TSV (format_output_line_x) against
  kaiju_tpu's BatchRunner, run in one fresh JAX subprocess that the module
  fixture starts (kaijux MEM and Greedy, SEG on), and against the host
  ExactClassifier: both modes, SEG on and off, with and without -v; kaijup
  on protein reads, with reads that have no fragment; kaijux on paired
  files; a fragment tied in several sequences; a DB whose names carry no
  taxon id; with a taxonomy, kaiju's lines (format_output_line).
- The CLIs kaijux.main, kaijup.main and kaiju_multi.main with
  device="cpu": kaiju-multi's outputs, to files and to stdout, equal the
  port's kaiju run per sample; the list-length errors; -v's dump; and
  main refusing without a card."""

import argparse
import json
import random
import subprocess
import sys
from dataclasses import asdict

import numpy as np
import pytest
import torch

from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.engine.core import (ExactClassifier, format_output_line,
                                   format_output_line_x)
from kaiju_tpu.index import py_builder as jax_py_builder
from kaiju_tpu.io.taxonomy import Taxonomy
from kaiju_tpu.ops import device_index as jdev
from kaiju_tpu.tools import common as jax_common
from kaiju_tpu_torch.engine import batch
from kaiju_tpu_torch.engine.config import KaijuConfig as TorchConfig
from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.io.taxonomy import Taxonomy as TorchTaxonomy
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.tools import kaiju as tkaiju
from kaiju_tpu_torch.tools import kaiju_multi, kaijup, kaijux

from conftest import make_db_records, random_protein, write_nodes_dmp
from readgen import (make_protein_reads, make_reads, reverse_translate,
                     write_fastq, write_reads_fasta)
from test_exact_parity import _diff, _lowcomp_reads

JAX_CONFIGS = {"mem": "mem", "greedy": "greedy"}  # kaijux, SEG on

WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
from kaiju_tpu.engine.batch import BatchRunner
from kaiju_tpu.engine.config import KaijuConfig
from kaiju_tpu.engine.core import format_output_line_x
from kaiju_tpu.index import py_builder

job = json.load(open(sys.argv[1]))
index = py_builder.build_index(job["records"])
reads = [tuple(r) for r in job["reads"]]
out = {}
for name, mode in job["configs"].items():
    cfg = KaijuConfig(mode=mode, seg=True, taxonomy_free=True,
                      use_Evalue=mode == "greedy")
    runner = BatchRunner(index, None, cfg)
    out[name] = "".join(format_output_line_x(n, r)
                        for n, r in runner.classify_batch(reads))
json.dump(out, open(sys.argv[2], "w"))
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small tensor ops, for which torch's
    intra-op threads add CPU time and no speed; one thread for this file
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tie_reads(rng, base, n):
    """DNA reads of a stretch of the DB's shared `base` protein, which
    several DB sequences hold: fragments tied in several sequences."""
    out = []
    for t in range(n):
        st = rng.randrange(0, 60)
        out.append((f"tie{t}", reverse_translate(rng, base[st:st + 30]), None))
    return out


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    rng = random.Random(161)
    records = make_db_records(rng, nseq=40)
    base = records[2][1]  # kind 2: the shared protein, in several sequences
    assert sum(base in s for _n, s in records) > 2
    work = tmp_path_factory.mktemp("torch_batch")
    nodes_dmp = str(work / "nodes.dmp")
    nodes = write_nodes_dmp(nodes_dmp)
    reads = [(n, s, None) for n, s in make_reads(rng, records, n=60)
             + _lowcomp_reads(rng, records, n=20)] + _tie_reads(rng, base, 4)
    job = {"records": records, "configs": JAX_CONFIGS, "reads": reads[:48]}
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

    index = py_builder.build_index(records)
    index.text = None
    ktx = str(work / "db.ktx")
    index.save(ktx)
    env_ = {
        "rng": rng, "records": records, "work": work, "reads": reads,
        "jax_reads": job["reads"], "jax_tsv": jax_tsv, "nodes": nodes,
        "nodes_dmp": nodes_dmp, "index": index, "ktx": ktx,
        "jidx": jax_py_builder.build_index(records),
    }
    yield env_
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _config(mode, seg=True, verbose=False, protein=False, taxonomy_free=True):
    return KaijuConfig(mode=mode, seg=seg, verbose=verbose,
                       use_Evalue=mode == "greedy", input_is_protein=protein,
                       taxonomy_free=taxonomy_free)


def _exact_x(jidx, cfg, items, tax=None):
    """The host ExactClassifier's TSV: taxonomy-free without a taxonomy."""
    eng = ExactClassifier(jidx, tax, cfg)
    if tax is None:
        return "".join(format_output_line_x(n, r)
                       for n, r in eng.classify_batch(items))
    return "".join(format_output_line(n, r, cfg.verbose)
                   for n, r in eng.classify_batch(items))


def _port(index, cfg, items, tax=None):
    """(the port's runner TSV, the runner), on the CPU."""
    runner = batch.BatchRunner(index, tax, TorchConfig(**asdict(cfg)),
                               device="cpu")
    return "".join(runner.classify_to_lines(items)), runner


# ---------------------------------------------------------------------------
# the plain versions against kaiju_tpu's blocks/occ forms
# ---------------------------------------------------------------------------


def _aligned_records(records):
    """records plus one filler protein, so that the BWT length (letters
    plus one terminator a sequence) is a multiple of 128."""
    total = sum(len(s) for _n, s in records) + len(records)
    fill = (-(total + 1)) % 128
    fill += 128 if fill < 30 else 0
    out = records + [("FILL0001.1_301", random_protein(random.Random(5), fill))]
    assert (sum(len(s) for _n, s in out) + len(out)) % 128 == 0
    return out


@pytest.fixture(scope="module", params=["db", "aligned"])
def pair(request, env):
    """(kaiju_tpu's DeviceIndex, the port's on the CPU, length) of the test
    DB, or of it with a BWT length that is a multiple of 128."""
    records = env["records"]
    if request.param == "aligned":
        records = _aligned_records(records)
    jidx = jax_py_builder.build_index(records)
    tidx = py_builder.build_index(records)
    assert request.param == "db" or jidx.length % 128 == 0
    return jdev.DeviceIndex(jidx), tdev.DeviceIndex(tidx, "cpu"), jidx


def _t(a, dtype=np.int32):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_update_si_plain_matches_probe_updates(pair):
    """Probes on random intervals, empty intervals, and the ends 0, block
    boundaries and s1 = length."""
    jd, td, jidx = pair
    rng = np.random.default_rng(21)
    n, length = 3000, jidx.length
    c = rng.integers(1, jidx.alen, n)
    s0 = rng.integers(0, length, n)
    s1 = np.minimum(length, s0 + rng.integers(0, 300, n))
    s1[::7] = s0[::7]  # empty
    s1[::11] = length
    s0[::13] = 0
    s0[5::17] = (s0[5::17] >> 7) << 7
    s1[3::19] = np.minimum(length, ((s1[3::19] >> 7) + 1) << 7)
    want = jdev.probe_updates(jd.blocks, jd.occ, jd.C, *(
        np.asarray(a, np.int32) for a in (c, s0, s1)))
    got = tdev.update_si_plain(td.rec, td.C, _t(c), _t(s0), _t(s1))
    _equal(got, want)
    assert np.asarray(want[2]).sum() > 100 and not np.asarray(want[2]).all()


def test_extend_rows_matches_extend_from(pair):
    """Code rows of DB substrings and of random letters, resumed from an
    interval of the row's letter or from a random or an empty one; lanes
    from start_i 0, inactive lanes, lanes whose interval empties at once."""
    jd, td, jidx = pair
    rng = np.random.default_rng(22)
    n, L = 1200, 48
    text = np.asarray(jidx.text)  # the DB's letter codes, 0 separators
    codes = rng.integers(1, 21, (n, L)).astype(np.uint8)
    real = rng.random(n) < 0.6
    starts = rng.integers(0, text.shape[0] - L, n)
    codes[real] = np.stack([text[s:s + L] for s in starts[real]])
    codes[codes == 0] = 1  # no terminators inside a row
    start = rng.integers(0, L + 1, n)
    start[::9] = 0
    start[1::9] = L
    C = np.asarray(jd.C)
    c = codes[np.arange(n), np.maximum(start - 1, 0)].astype(np.int64)
    s0, s1 = C[c], C[c + 1]
    rnd = rng.random(n) < 0.2
    s0 = np.where(rnd, rng.integers(0, jidx.length, n), s0)
    s1 = np.where(rnd, np.minimum(jidx.length, s0 + rng.integers(1, 400, n)),
                  s1)
    s1[::10] = s0[::10]  # empties at once
    act = rng.random(n) < 0.85
    lanes = [np.asarray(a, np.int32) for a in (start, s0, s1)]
    want = jdev.extend_from(jd.blocks, jd.occ, jd.C, codes, *lanes, act)
    got = tdev.extend_rows(td.rec, td.C, _t(codes, np.uint8),
                           *(_t(a) for a in lanes), _t(act, bool))
    _equal(got, want)
    i = got[0].numpy()
    for g, a in zip(got, lanes):  # inactive lanes come back unchanged
        np.testing.assert_array_equal(g.numpy()[~act], a[~act])
    assert (i[act] < start[act]).sum() > 200  # extensions happened
    assert (i[act & (start > 0)] == 0).any()  # to the row's start


def test_sa_lookup_plain_matches_sa_lookup(pair):
    """Random positions, every sampled slot, the terminator rows and the
    last position: iseq and pos."""
    jd, td, jidx = pair
    e = jidx.chpt_exp
    rng = np.random.default_rng(23)
    k = np.concatenate([
        rng.integers(0, jidx.length, 2000), np.arange(0, jidx.length, 1 << e),
        np.arange(jidx.nseq), [jidx.length - 1],
    ]).astype(np.int32)
    want = jdev.sa_lookup(jd.blocks, jd.occ, jd.C, jd.sa_seq, jd.sa_off,
                          jidx.nseq, k, e)
    got = tdev.sa_lookup_plain(td.rec, td.C, td.sa_seq, td.sa_off, td.nseq,
                               e, _t(k))
    _equal(got, want)
    # every position walks to its suffix's own sequence
    assert np.array_equal(got[0].numpy()[:50], np.asarray(
        [jidx.get_suffix(int(x))[0] for x in k[:50]]))


# ---------------------------------------------------------------------------
# the runner's TSV
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(JAX_CONFIGS))
def test_tsv_matches_jax_batch_runner(env, mode):
    """kaijux MEM and Greedy, SEG on: the port's runner on the CPU writes
    kaiju_tpu's BatchRunner TSV, byte for byte."""
    items = [tuple(r) for r in env["jax_reads"]]
    port, _runner = _port(env["index"], _config(mode), items)
    want = env["jax_tsv"]()[mode]
    assert port == want, _diff(port, want)
    assert port.count("\nC\t") > len(items) // 3


@pytest.mark.parametrize("verbose", [False, True])
@pytest.mark.parametrize("seg", [True, False])
@pytest.mark.parametrize("mode", ["mem", "greedy"])
def test_tsv_matches_exact(env, mode, seg, verbose):
    """kaijux's TSV equals ExactClassifier's with taxonomy_free=True; with
    -v the fifth column carries the matched fragments."""
    items = env["reads"]
    cfg = _config(mode, seg=seg, verbose=verbose)
    port, runner = _port(env["index"], cfg, items)
    want = _exact_x(env["jidx"], cfg, items)
    assert port == want, _diff(port, want)
    lines = [ln.split("\t") for ln in port.splitlines()]
    classified = [ln for ln in lines if ln[0] == "C"]
    assert len(classified) > len(items) // 3
    assert all(len(ln) == 5 for ln in classified)
    assert all(bool(ln[4]) == verbose for ln in classified)
    assert runner._ext_cache  # the warm-up filled the cache


def test_fragment_tied_in_several_sequences(env):
    """Reads of the DB's shared protein: their line names every sequence
    that holds the match, in content-rank order, once each."""
    items = _tie_reads(random.Random(162), env["records"][2][1], 6)
    for mode in ("mem", "greedy"):
        cfg = _config(mode)
        port, _runner = _port(env["index"], cfg, items)
        want = _exact_x(env["jidx"], cfg, items)
        assert port == want, _diff(port, want)
        names = [ln.split("\t")[3].rstrip(",").split(",")
                 for ln in port.splitlines() if ln.startswith("C")]
        assert names and all(len(n) == len(set(n)) for n in names)
        assert max(len(n) for n in names) > 2


@pytest.mark.parametrize("mode", ["mem", "greedy"])
def test_kaijup_protein_reads(env, mode):
    """kaijup: protein reads, some too short for a fragment ("U\\tname\\t0")
    and some with fragments but no match ("U\\tname")."""
    items = [(n, s, None) for n, s in
             make_protein_reads(random.Random(163), env["records"], n=60)]
    items += [("short0", "MKV", None), ("short1", "ACDEFGHIK", None)]
    cfg = _config(mode, protein=True)
    port, _runner = _port(env["index"], cfg, items)
    want = _exact_x(env["jidx"], cfg, items)
    assert port == want, _diff(port, want)
    lines = port.splitlines()
    assert "U\tshort0\t0" in lines and "U\tshort1\t0" in lines
    assert any(ln.count("\t") == 1 and ln.startswith("U\t") for ln in lines)
    assert sum(ln.startswith("C\t") for ln in lines) > 20


@pytest.mark.parametrize("mode", ["mem", "greedy"])
def test_names_without_taxon_ids(env, mode):
    """A kaijux DB of free-text names: no taxon id, or a trailing run of
    digits past 2^31; the runner neither raises nor depends on them."""
    rng = random.Random(164)
    records = [(name, s) for name, (_n, s) in zip(
        ["toxA", "blaTEM-1", "gene_beta", "mcr-1.1", "sp|P0A9Q7|ADHE_ECOLI",
         "toxin_B_9876543210", "cry1Ac", "vanA_12345678901"] * 5,
        env["records"])]
    records = [(f"{n}.{i}" if i >= 8 else n, s)
               for i, (n, s) in enumerate(records)]
    index = py_builder.build_index(records)
    assert int(index.seq_taxids.max()) > 2 ** 31
    items = [(n, s, None) for n, s in make_reads(rng, records, n=40)]
    cfg = _config(mode)
    port, _runner = _port(index, cfg, items)
    want = _exact_x(jax_py_builder.build_index(records), cfg, items)
    assert port == want, _diff(port, want)
    assert "toxin_B_9876543210" in port or "vanA_12345678901" in port


@pytest.mark.parametrize("mode,verbose", [("mem", False), ("greedy", True)])
def test_runner_with_taxonomy_writes_kaiju_lines(env, mode, verbose):
    """With a taxonomy (not taxonomy-free) the runner gives kaiju's lines,
    as tests/test_batch_parity.py holds kaiju_tpu's runner."""
    items = env["reads"]
    cfg = _config(mode, verbose=verbose, taxonomy_free=False)
    port, _runner = _port(env["index"], cfg, items, TorchTaxonomy(env["nodes"]))
    want = _exact_x(env["jidx"], cfg, items, Taxonomy(env["nodes"]))
    assert port == want, _diff(port, want)
    assert port.count("\nC\t") > len(items) // 3


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["-a", "mem", "-X"], ["-v"]])
def test_kaijux_cli_paired_files(env, flags):
    """kaijux.main on two files: each mate a read of its own under the
    pair's name, mate 1 first; the ExactClassifier's TSV."""
    work, rng = env["work"], random.Random(165)
    r1 = make_reads(rng, env["records"], n=30)
    r2 = make_reads(rng, env["records"], n=30)
    r2 = [(r1[i][0], r2[i][1]) for i in range(30)]
    f1, f2 = str(work / "pair_1.fastq"), str(work / "pair_2.fastq")
    write_fastq(r1, f1)
    write_fastq(r2, f2)
    out = str(work / f"x_pair{len(flags)}.tsv")
    assert kaijux.main(["-f", env["ktx"], "-i", f1, "-j", f2, *flags,
                        "-o", out, "-b", "16"], device="cpu") == 0
    with open(out) as fh:
        got = fh.read()
    mode = "mem" if "mem" in flags else "greedy"
    cfg = _config(mode, seg="-X" not in flags, verbose="-v" in flags)
    items = [(n, s, None) for i in range(30)
             for n, s in (r1[i], r2[i])]
    want = _exact_x(env["jidx"], cfg, items)
    assert got == want, _diff(got, want)


def test_kaijup_cli(env, capsys):
    """kaijup.main on a protein FASTA, to stdout."""
    items = make_protein_reads(random.Random(166), env["records"], n=40)
    fa = str(env["work"] / "prot.faa")
    write_reads_fasta(items, fa)
    capsys.readouterr()
    assert kaijup.main(["-f", env["ktx"], "-i", fa, "-b", "16"],
                       device="cpu") == 0
    got = capsys.readouterr().out
    want = _exact_x(env["jidx"], _config("greedy", protein=True),
                    [(n, s, None) for n, s in items])
    assert got == want, _diff(got, want)


def _samples(env):
    """Three small samples, the second paired: [(file 1, file 2 or None)]."""
    work, rng = env["work"], random.Random(167)
    samples = []
    for s in range(3):
        reads = make_reads(rng, env["records"], n=24 + 8 * s)
        f1 = str(work / f"multi{s}_1.fastq")
        write_fastq(reads, f1)
        f2 = None
        if s == 1:
            f2 = str(work / f"multi{s}_2.fastq")
            write_fastq([(n, sq[::-1]) for n, sq in reads], f2)
        samples.append((f1, f2))
    return samples


@pytest.mark.parametrize("flags", [[], ["-a", "mem"], ["-v"]])
def test_kaiju_multi_equals_kaiju_per_sample(env, capsys, flags):
    """kaiju_multi.main on three samples (the second paired, the others
    with an empty -j entry): each -o file equals the port's kaiju run on
    that sample alone, and without -o stdout is their concatenation.  One
    engine serves every sample, so nothing of a sample's stream (the
    lookahead, the host replay, the fragment memo) may reach the next."""
    work, samples = env["work"], _samples(env)
    tag = "".join(flags).replace("-", "") or "greedy"
    base = ["-t", env["nodes_dmp"], "-f", env["ktx"], *flags, "-b", "16"]
    want = []
    for s, (f1, f2) in enumerate(samples):
        out = str(work / f"kaiju_{tag}_{s}.tsv")
        assert tkaiju.main(base + ["-i", f1, *(["-j", f2] if f2 else []),
                                   "-o", out], device="cpu") == 0
        with open(out) as fh:
            want.append(fh.read())
    lists = ["-i", ",".join(f1 for f1, _ in samples),
             "-j", ",".join(f2 or "" for _, f2 in samples)]
    outs = [str(work / f"multi_{tag}_{s}.tsv") for s in range(3)]
    assert kaiju_multi.main(base + lists + ["-o", ",".join(outs)],
                            device="cpu") == 0
    for fo, w in zip(outs, want):
        with open(fo) as fh:
            got = fh.read()
        assert got == w, _diff(got, w)
    capsys.readouterr()
    assert kaiju_multi.main(base + lists, device="cpu") == 0
    got, cat = capsys.readouterr().out, "".join(want)
    assert got == cat, _diff(got, cat)
    assert all(w.count("\nC\t") > 5 for w in want)


def test_kaiju_multi_list_errors_and_verbose_dump(env, capsys):
    """-j or -o lists of another length than -i's: the reference's error
    and exit code 1, before the index loads; -v prints kaiju_tpu's
    kaiju-multi parameter dump."""
    (f1, _), (g1, g2), _s = _samples(env)
    base = ["-t", env["nodes_dmp"], "-f", env["ktx"], "-i", f"{f1},{g1}"]
    capsys.readouterr()
    assert kaiju_multi.main(base + ["-j", g2], device="cpu") == 1
    assert capsys.readouterr().err == (
        "Error: -i and -j lists have different lengths\n")
    assert kaiju_multi.main(base + ["-o", "a.tsv,b.tsv,c.tsv"],
                            device="cpu") == 1
    assert capsys.readouterr().err == (
        "Error: -i and -o lists have different lengths\n")
    outs = [str(env["work"] / f"dump{s}.tsv") for s in range(2)]
    argv = base + ["-a", "mem", "-v", "-o", ",".join(outs)]
    assert kaiju_multi.main(argv, device="cpu") == 0
    err = capsys.readouterr().err
    args = argparse.ArgumentParser()
    args.add_argument("-t", dest="nodes")
    jax_common.add_engine_args(args)
    args = args.parse_args(argv)
    jax_common.print_verbose_parameters(jax_common.config_from_args(args),
                                        args, multi=True)
    want = capsys.readouterr().err
    assert err == want and "output files: " in want


@pytest.mark.parametrize("tool", ["kaijux", "kaijup", "kaiju_multi"])
def test_cli_refuses_without_a_card(env, monkeypatch, tool):
    """Without device="cpu" the tools run on the card, and raise when
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fq = str(env["work"] / "one.fastq")
    write_fastq(make_reads(random.Random(168), env["records"], n=2), fq)
    main = {"kaijux": kaijux, "kaijup": kaijup,
            "kaiju_multi": kaiju_multi}[tool].main
    argv = ["-f", env["ktx"], "-i", fq]
    if tool == "kaiju_multi":
        argv = ["-t", env["nodes_dmp"]] + argv
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_kaijux_debug_trace_matches_jax(env, capsys):
    """kaijux -d runs the host ExactClassifier, as kaiju_tpu's does: the
    same stdout TSV and stderr trace."""
    from kaiju_tpu.tools import kaijux as jax_kaijux

    fq = str(env["work"] / "debug.fastq")
    write_fastq([(n, s) for n, s, _ in env["reads"][:16]], fq)
    argv = ["-f", env["ktx"], "-i", fq, "-d"]
    capsys.readouterr()
    assert kaijux.main(argv, device="cpu") == 0
    port = capsys.readouterr()
    assert jax_kaijux.main(argv) == 0
    want = capsys.readouterr()
    assert port.out == want.out and port.err == want.err
    assert "Searching fragment " in port.err and port.out.count("\n") == 16
