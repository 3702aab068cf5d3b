"""Warm start on the CPU (utils/aot.py, kernels.use_prebuilt, mkdb
--aot): the prebuilt directory's source key follows every byte of csrc/,
a directory of another key is never chosen and a matching one whose
library does not load raises; mkdb --aot keeps kaiju_tpu's contract (-t
required, --kmer implied) and, on the CPU, writes the seed tables of
--kmer byte for byte beside those of both paths and their bitmaps, which a
later kaiju run reads without building anything.  No test here compiles
XLA: the references are the port's own --kmer run and kaiju_tpu's exit
code contract."""

import json
import os
import random
import shutil

import pytest

from kaiju_tpu_torch import kernels
from kaiju_tpu_torch.ops import bloom, kmer
from kaiju_tpu_torch.tools import kaiju as tkaiju
from kaiju_tpu_torch.tools import mkdb
from kaiju_tpu_torch.tools.readgen import make_reads, write_fastq
from kaiju_tpu_torch.utils import aot

from conftest import make_db_records, write_fasta, write_nodes_dmp


@pytest.mark.parametrize("name", ["update_si.cu", "fm_common.cuh"])
def test_source_key_follows_every_byte(tmp_path, name):
    """A copy of csrc/ has the checkout's key (content, not paths or
    mtimes); one byte changed in one .cu or .cuh changes it, and putting
    the byte back restores it."""
    src = str(tmp_path / "csrc")
    shutil.copytree(kernels.CSRC_DIR, src)
    key = aot.source_key(src)
    assert key == aot.source_key() and len(key) == 16
    path = os.path.join(src, name)
    os.utime(path, (0, 0))
    assert aot.source_key(src) == key
    with open(path, "rb") as fh:
        data = fh.read()
    pos = len(data) // 2
    with open(path, "wb") as fh:
        fh.write(data[:pos] + bytes([data[pos] ^ 1]) + data[pos + 1:])
    assert aot.source_key(src) != key
    with open(path, "wb") as fh:
        fh.write(data)
    assert aot.source_key(src) == key
    os.rename(path, os.path.join(src, "z" + name))  # the names count too
    assert aot.source_key(src) != key


def _fake_prebuilt(cache, machine):
    """A prebuilt directory under machine key `machine` whose update_si
    library is not a shared object."""
    path = os.path.join(cache, "aot", f"cuda-{machine}-{aot.source_key()}")
    os.makedirs(path)
    with open(os.path.join(path, aot.MANIFEST), "w") as fh:
        json.dump({"key": os.path.basename(path)}, fh)
    with open(os.path.join(path, "libupdate_si.so"), "wb") as fh:
        fh.write(b"not a shared object")
    return path


def test_prebuilt_of_another_key_is_never_chosen(tmp_path, monkeypatch):
    """use_prebuilt chooses only the directory of this machine's key and
    the checkout's source key; a matching directory whose library does not
    load raises, naming the file, with no build and no plain version."""
    monkeypatch.setattr(kernels, "_prebuilt", None)
    cache = str(tmp_path)
    other = _fake_prebuilt(cache, "0badc0de")
    stale = os.path.join(cache, "aot", "cuda-5ca1ab1e-0123456789abcdef")
    shutil.copytree(other, stale)
    monkeypatch.setattr(aot, "machine_key", lambda device=None: "5ca1ab1e")
    assert aot.prebuilt_dir(cache) != stale  # another source key
    assert kernels.use_prebuilt(cache) is None and kernels._prebuilt is None
    assert kernels.use_prebuilt(None) is None

    monkeypatch.setattr(aot, "machine_key", lambda device=None: "0badc0de")
    assert aot.prebuilt_dir(cache) == other
    assert kernels.use_prebuilt(cache) == other
    assert "update_si" not in kernels._libs
    runs = kernels.LOADER["nvcc_runs"]
    with pytest.raises(RuntimeError, match="libupdate_si.so"):
        kernels.load("update_si")
    assert "update_si" not in kernels._libs and "update_si" not in (
        kernels.ORIGIN)
    assert kernels.LOADER["nvcc_runs"] == runs

    with open(os.path.join(other, aot.MANIFEST), "w") as fh:
        json.dump({"key": os.path.basename(stale)}, fh)
    with pytest.raises(RuntimeError, match="manifest.json"):
        kernels.use_prebuilt(cache)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    w = tmp_path_factory.mktemp("aot")
    rng = random.Random(23)
    records = make_db_records(rng, 40)
    fasta, nodes = str(w / "db.faa"), str(w / "nodes.dmp")
    write_fasta(records, fasta)
    write_nodes_dmp(nodes)
    fq = str(w / "reads.fastq")
    write_fastq(make_reads(rng, records, n=96), fq)
    return {"w": w, "fasta": fasta, "nodes": nodes, "fq": fq}


def test_mkdb_aot_needs_nodes(db, capsys):
    """--aot without -t exits 2 (argparse's error), as kaiju_tpu's mkdb,
    before anything is written; --aot-batch is 4096 by default."""
    out = str(db["w"] / "no_t.ktx")
    with pytest.raises(SystemExit) as e:
        mkdb.main(["-o", out, "--aot", db["fasta"]], device="cpu")
    assert e.value.code == 2 and not os.path.exists(out)
    assert "--aot needs -t" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        mkdb.main(["-h"])
    assert "(default 4096)" in capsys.readouterr().out


def _tree(path):
    out = {}
    for root, _dirs, names in os.walk(path):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = fh.read()
    return out


def test_mkdb_aot_on_cpu_writes_what_kaiju_reads(db, monkeypatch):
    """mkdb --aot -t ... --aot-batch 64 on the CPU writes everything
    mkdb --kmer writes, byte for byte, plus the seed tables of both paths
    and their two bitmaps, and no library; kaiju then reads them (no seed
    table built, no bitmap filled) and writes the TSV of a run on the
    --kmer index, which builds them."""
    w = db["w"]
    plain, warm = str(w / "kmer.ktx"), str(w / "aot.ktx")
    assert mkdb.main(["-o", plain, "--kmer", db["fasta"]], device="cpu") == 0
    assert mkdb.main(["-o", warm, "--aot", "-t", db["nodes"], "--aot-batch",
                      "64", db["fasta"]], device="cpu") == 0
    want, got = _tree(plain), _tree(warm)
    for name in want:
        assert got.get(name) == want[name], name
    extra = sorted({n.split(os.sep)[0] for n in set(got) - set(want)})
    assert extra == ["bloom_m11_lb20.npy", "bloom_m7_lb20.npy", "kmer5"]
    assert not os.path.exists(os.path.join(warm, "aot"))

    def refuse(*a, **kw):
        raise AssertionError("built at first use")

    outs = {}
    for tag, ktx in (("warm", warm), ("plain", plain)):
        if tag == "warm":  # everything must come from the files
            monkeypatch.setattr(kmer.KmerTables, "build", refuse)
            monkeypatch.setattr(kmer.KmerTables, "build_device", refuse)
            monkeypatch.setattr(bloom, "fill_from_text", refuse)
        for mode in ("mem", "greedy"):
            out = str(w / f"{tag}_{mode}.tsv")
            flags = ["-a", "mem"] if mode == "mem" else []
            assert tkaiju.main(["-t", db["nodes"], "-f", ktx, "-i", db["fq"],
                                *flags, "-o", out, "-b", "32"],
                               device="cpu") == 0
            with open(out) as fh:
                outs[tag, mode] = fh.read()
        monkeypatch.undo()
    for mode in ("mem", "greedy"):
        assert outs["warm", mode] == outs["plain", mode]
        assert outs["warm", mode].count("\n") == 96
        assert outs["warm", mode].count("C\t") > 10
    assert sorted(_tree(plain)) == sorted(got)  # the run built them there


def test_mkdb_aot_raises_when_it_cannot_write(db, monkeypatch):
    """Unlike the first-use caches, --aot raises when a table or bitmap it
    should write is not there afterwards."""
    monkeypatch.setattr(kmer.KmerTables, "save", lambda self, d: None)
    with pytest.raises(OSError, match="kmer5"):
        mkdb.main(["-o", str(db["w"] / "ro.ktx"), "--aot", "-t", db["nodes"],
                   "--aot-batch", "8", db["fasta"]], device="cpu")
