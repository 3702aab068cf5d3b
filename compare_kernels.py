#!/usr/bin/env python3
"""Kernels B (mem_extend) and E (greedy_search) of this checkout against
the same kernels of another checkout of the port, on one NVIDIA GPU.

    python3 compare_kernels.py OTHER [--seed 20240817] [--db-letters N]

OTHER is a directory that holds another checkout's kaiju_tpu_torch, for
example the parent commit unpacked with ``git archive`` into a directory
that .gitignore lists, or a copy of this checkout with a kernel's source
changed.  Its wrappers ``ops.search.mem_extend`` and
``ops.greedy.greedy_search`` must take the arguments this checkout's
take.  Both packages are imported side by side in this process, each
with its own kernel loader, which builds its checkout's kernels into that
checkout's build/ directory; nothing of either loader is replaced.

On chip_smoke.py phase 3's inputs (both 64 Maa indexes, the DB with
repeats with and without text, and the 64 Maa indexes in 4 shards),
B on the MEM and the Greedy batch and E at -e 3: this checkout's kernels
against their plain versions (phase 3's check, with both floors), each
design's outputs against this checkout's kernel (they must be equal, and
each design's launches must be counted by its own package), then each
design timed twice in turns, other, this, this, other (CUDA events, the
median of 15 launches).  Prints a line a shape and exits non-zero when
a design disagrees, a launch went to the wrong package, or there is no
CUDA device.  Imports nothing of JAX or of kaiju_tpu.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
import traceback

PKG = "kaiju_tpu_torch"
# the modules a design is called through: the two wrappers, the loader
# that counts their launches, and the class of a sharded index array
MODULES = ("kernels", "ops.search", "ops.greedy", "ops.device_index")
# phase 3's calls of B and E, by their name in chip_smoke.check_kernels
COMPARED = {"mem_extend": ("ops.search", "mem_extend"),
            "mem_extend (Greedy batch)": ("ops.search", "mem_extend"),
            "greedy_search": ("ops.greedy", "greedy_search")}
SHARDS = 4  # phase 4e's widest split


def _ours() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == PKG or k.startswith(PKG + ".")}


def import_checkout(path: str) -> dict:
    """{name: module} of MODULES imported from the kaiju_tpu_torch under
    path, as a second copy beside the one in sys.modules, which is left
    as it was."""
    path = os.path.abspath(path)
    saved = _ours()
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, path)
    try:
        mods = {n: importlib.import_module(f"{PKG}.{n}") for n in MODULES}
    finally:
        sys.path.remove(path)
        for k in _ours():
            del sys.modules[k]
        sys.modules.update(saved)
    where = os.path.dirname(os.path.dirname(mods["kernels"].__file__))
    if os.path.realpath(where) != os.path.realpath(os.path.join(path, PKG)):
        raise RuntimeError(f"{PKG} of {path} not found (got {where})")
    return mods


def to_design(x, mods: dict):
    """x with every index array in shards (ops.device_index.Shards of
    this checkout) rebuilt as the Shards class of the design's modules,
    inside tuples too; other values unchanged."""
    cls = mods["ops.device_index"].Shards
    if type(x).__name__ == "Shards" and not isinstance(x, cls):
        return cls(x.parts, x.per, x.shape[0], x.device, x.opened)
    if isinstance(x, tuple):
        return tuple(to_design(y, mods) for y in x)
    return x


def design_call(mods: dict, name: str, args, kw):
    """A call of kernel `name`'s wrapper of the design's package on
    args, kw, and the name of the kernel it launches."""
    mod, fn = COMPARED[name]
    wrapper = getattr(mods[mod], fn)
    a = to_design(tuple(args), mods)
    k = {key: to_design(v, mods) for key, v in kw.items()}
    sharded = any(type(x).__name__ == "Shards" for x in args)
    kname = fn + ("_sharded" if sharded else "")
    return (lambda: wrapper(*a, **k)), kname


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kaiju_tpu_torch.index.core import KaijuIndex
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    designs = {"other": import_checkout(args.other),
               "this": {n: importlib.import_module(f"{PKG}.{n}")
                        for n in MODULES}}
    for tag, mods in designs.items():
        secs = mods["kernels"].build(verbose=True)
        cs.log(f"build [{tag}]: {secs:.1f} s, "
               f"{os.path.dirname(mods['kernels'].CSRC_DIR)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    cs.log(smi)
    lat_ns = cs.latency(smi)
    records, _nodes, ktx = cs.make_db(args.seed, args.db_letters)
    reads = cs.make_reads(args.seed, records, cs.BATCH)
    r_records, r_ktx = cs.make_repeats_db(args.seed)
    r_reads = cs.make_reads(args.seed, r_records, cs.BATCH)
    cases = [(tag, ktx[tag], reads) for tag in ("fmi", "text")]
    cases += [(f"repeats, {tag}", r_ktx[tag], r_reads)
              for tag in ("fmi", "text")]
    bad = []

    def compare(name, where, a, kw, want):
        """Each design's B or E (phase 3's call `name`) on a, kw against
        want, then timed."""
        calls = {tag: design_call(mods, name, a, kw)
                 for tag, mods in designs.items()}
        kname = calls["this"][1]
        for tag, (call, _k) in calls.items():
            before = {t: dict(m["kernels"].LAUNCHES)
                      for t, m in designs.items()}
            err = cs.max_abs_err(call(), want)
            moved = {t: m["kernels"].LAUNCHES[kname] - before[t][kname]
                     for t, m in designs.items()}
            if err or moved != {t: int(t == tag) for t in designs}:
                bad.append((name, where, tag, err, moved))
        times = {tag: [] for tag in designs}
        for tag in ("other", "this", "this", "other"):
            times[tag].append(cs.cuda_ms(calls[tag][0]))
        cs.log(f"compare {name} [{where}]: " + "; ".join(
            f"{tag} {t[0]:.4f} {t[1]:.4f} ms" for tag, t in times.items())
            + f"; this/other {sum(times['this']) / sum(times['other']):.3f}"
            f" ({smi})")

    for where, path, rd in cases:
        index = KaijuIndex.load(path)
        checks, inputs = cs.check_kernels(index, rd, path, lat_ns,
                                          full=False)
        cs.log_checks(checks, where)
        bad += [(n, where, "plain", v[0]) for n, v in checks.items() if v[0]]
        sh = (ShardedIndex(index, SHARDS, torch.device("cuda"))
              if where in ("fmi", "text") else None)
        for name in COMPARED:
            dv, a, kw, _b, _n = inputs[name]
            want = design_call(designs["this"], name, a, kw)[0]()
            compare(name, where, a, kw, want)
            if sh is not None and name != "mem_extend (Greedy batch)":
                sa, skw = cs.shard_call(sh, dv, a, kw)
                compare(name, f"{where}, {SHARDS} shards", sa, skw, want)
        del inputs, sh
        torch.cuda.empty_cache()
    if bad:
        cs.log(f"designs differ or launched the wrong kernels: {bad}")
        return 1
    cs.log("compare_kernels: every design equal to this checkout's "
           "kernels, which equal their plain versions")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="a directory holding another checkout's "
                    f"{PKG}")
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
