#!/usr/bin/env python3
"""Kernels A (update_si, update_si_letters), B (mem_extend), G
(text_extend), C (mem_stats), J (extend_all), I (extend_from), E
(greedy_search), D (read_lca), F (ranges_lca), H (sa_lookup), K
(greedy_map), L (big_extend_all) and M (big_sa_walk) of this checkout
against the same kernels of other checkouts of the port, on one NVIDIA
GPU.

    python3 compare_kernels.py OTHER [OTHER ...] [--seed 20240817]
        [--db-letters N] [--only-big | --no-big] [--big-dir DIR]

OTHER is a directory that holds another checkout's kaiju_tpu_torch, for
example the parent commit unpacked with ``git archive`` into a directory
that .gitignore lists, or a copy of this checkout with a kernel's source
changed; each design is named by its directory.  Its wrappers
``ops.device_index.update_si``, ``ops.search.mem_extend``,
``ops.hybrid.text_extend``, ``ops.search.mem_stats``,
``ops.device_index.extend_all``, ``ops.device_index.extend_from``,
``ops.device_index.extend_rows``, ``ops.greedy.greedy_search``,
``ops.classify.read_lca``, ``ops.classify.ranges_lca``,
``ops.device_index.sa_lookup``, ``ops.search.greedy_map``,
``ops.big_mem.big_extend_all`` and ``ops.big_mem.big_sa_walk`` must take
the arguments this checkout's take; a design without
``ops.device_index.update_si_letters`` (A's seed-table form) runs its
update_si on the 20 repeated probes of each interval instead, made
outside the timed call, its outputs masked and shaped as
update_si_letters' for the comparison (the seed-table build's launch
before that form).  The packages are imported side by
side in this process, each with its own kernel loader, which builds its
checkout's kernels into that checkout's build/ directory; nothing of any
loader is replaced.

On chip_smoke.py phase 3's inputs (both 64 Maa indexes, the DB with
repeats with and without text, and the 64 Maa indexes in 4 shards),
A's letters form on the seed-table build's last depth and its probe
form on the same depth's repeated probes and, on db.ktx alone, on the
first Probes round of a BatchRunner (kaijux, Greedy, phase 4d's),
B on the MEM and the Greedy batch, G on the text indexes' stopped MEM
lanes, C on the MEM batch's lanes (not in shards: C reads no index, and
the sharded path gives it the same lanes), J on the MEM batch's
fragments as a 0-padded code matrix and, on db.ktx alone, on the first
ExtendAll launch of a BatchRunner (kaijux -a mem, phase 4d's,
unsharded), I (no sharded form) on the first Greedy -v co-simulation
round's variant lanes and, on db.ktx alone, in its code-row form
(extend_rows) on the first ExtendFrom round of a BatchRunner (kaijux,
Greedy, phase 4d's), E at -e 3, D and F on the flat tree and on the
taxonomy of NCBI depth, H on the SA positions of the MEM batch's tie
rows, of the MEM -v batch's first round (phase 3's -v check) and, on
db.ktx alone, of the first SaLookup round of a BatchRunner
(kaijux -a mem, phase 4d's, unsharded), K (not in shards: it reads no
index) on B's lanes of the Greedy -v batch and on its longest fragment
alone (the lazy launch's shape), its rows sorted by (f, j) before they
are compared, since the parent's come in no fixed order (the -v checks
of H, I and K on all four indexes); and on phase 4g's index above
2^31 letters at S = 2 (built here beside the rest, on every host thread,
~380 s on 8; or --big-dir), L on the demo's 1,024 reads of 64 and on
the steady step's 65,536 and M on the kf of each (--only-big: L and M
alone; --no-big: all but L and M): this checkout's kernels against
their plain versions (phase 3's and 4g's checks, with the floors), each
design's outputs against this checkout's kernel (they must be equal, and
each design's launches must be counted by its own package; a big index
goes to a design as its own BigIndex class), then each
design timed twice in turns, the others, this, this, the others in
reverse (CUDA events, the median of 15 launches).  Prints a line a
shape and exits non-zero when a design disagrees, a launch went to the
wrong package, or there is no CUDA device.  Imports nothing of JAX or of
kaiju_tpu.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
import traceback

PKG = "kaiju_tpu_torch"
# the modules a design is called through: the wrappers, the loader that
# counts their launches, and the class of a sharded index array
MODULES = ("kernels", "ops.search", "ops.hybrid", "ops.greedy",
           "ops.classify", "ops.device_index", "ops.big_mem",
           "parallel.big_index")
# phase 3's calls of A, B, G, C, J, I, E, D, F, H and K, by their name in
# chip_smoke.check_kernels (H's, I's and K's -v calls:
# check_verbose_kernels), and A's, J's, I's and H's BatchRunner rounds
COMPARED = {"update_si_letters": ("ops.device_index", "update_si_letters"),
            "update_si": ("ops.device_index", "update_si"),
            "update_si (BatchRunner)": ("ops.device_index", "update_si"),
            "mem_extend": ("ops.search", "mem_extend"),
            "mem_extend (Greedy batch)": ("ops.search", "mem_extend"),
            "text_extend": ("ops.hybrid", "text_extend"),
            "mem_stats": ("ops.search", "mem_stats"),
            "extend_all": ("ops.device_index", "extend_all"),
            "extend_all (BatchRunner)": ("ops.device_index", "extend_all"),
            "extend_from": ("ops.device_index", "extend_from"),
            "extend_rows (BatchRunner)": ("ops.device_index", "extend_rows"),
            "greedy_search": ("ops.greedy", "greedy_search"),
            "read_lca": ("ops.classify", "read_lca"),
            "read_lca (deep tree)": ("ops.classify", "read_lca"),
            "ranges_lca": ("ops.classify", "ranges_lca"),
            "ranges_lca (deep tree)": ("ops.classify", "ranges_lca"),
            "sa_lookup": ("ops.device_index", "sa_lookup"),
            "sa_lookup (tie rows)": ("ops.device_index", "sa_lookup"),
            "sa_lookup (BatchRunner)": ("ops.device_index", "sa_lookup"),
            "greedy_map": ("ops.search", "greedy_map"),
            "greedy_map (one fragment)": ("ops.search", "greedy_map"),
            "big_extend_all": ("ops.big_mem", "big_extend_all"),
            "big_extend_all (steady)": ("ops.big_mem", "big_extend_all"),
            "big_sa_walk": ("ops.big_mem", "big_sa_walk"),
            "big_sa_walk (steady)": ("ops.big_mem", "big_sa_walk")}
# L's and M's shapes on chip_smoke phase 4g's index at S = 2, by the
# suffix of their names: (reads of 64, big_classify.make_reads' seed),
# the demo's 1,024 (big_classify.run's seed) and the steady step's 65,536
BIG = {"": (1_024, 7), " (steady)": (65_536, 8)}
BIG_SHARDS = 2
# the calls not repeated on the index in shards: their paths never run
# sharded (Greedy's B is timed on the MEM batch; kaijux refuses
# --mesh-index; I has no sharded form), or they read no index (C, K)
UNSHARDED = ("mem_extend (Greedy batch)", "sa_lookup (BatchRunner)",
             "update_si (BatchRunner)", "extend_all (BatchRunner)",
             "extend_from", "extend_rows (BatchRunner)", "mem_stats",
             "greedy_map", "greedy_map (one fragment)")
# the kernel a wrapper launches, where its name differs
LAUNCHED = {"extend_rows": "extend_from"}
SHARDS = 4  # phase 4e's widest split
# kernels N and O on a hosts view of phase 3's text index: the index in
# HOSTS_SHARDS shards, those of HOSTS_REMOTE on "another host", their rows
# served in rounds within this process (tests/test_torch_hosts.py's way)
HOSTS_SHARDS = 4
HOSTS_REMOTE = (1, 3)
N_WIDTHS = (1, 2, 20, 32)  # N's forms: the seed tables' ROW is w20, the
# extension's and the walks' w1, the hybrid's switch w2 and text rows w32
NLET = 20  # letters of the seed tables: A's letters form's rows


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
    and a big index (parallel.big_index.BigIndex) as its BigIndex over
    the same arrays, inside tuples too; other values unchanged."""
    cls = mods["ops.device_index"].Shards
    if type(x).__name__ == "Shards" and not isinstance(x, cls):
        return cls(x.parts, x.per, x.shape[0], x.device, x.peer)
    big = mods["parallel.big_index"].BigIndex
    if type(x).__name__ == "BigIndex" and not isinstance(x, big):
        y = big.__new__(big)
        y.__dict__.update({k: to_design(v, mods)
                           for k, v in vars(x).items()})
        return y
    if isinstance(x, tuple):
        return tuple(to_design(y, mods) for y in x)
    return x


def letters_stand_in(mods: dict, args):
    """(a call, the map of its outputs) standing in for update_si_letters
    on args = (rec, C, s0, s1) in a design without it: the design's
    update_si on the NLET * n repeated probes of the intervals, made here
    and not in the call, its (n0, n1, ok) masked (ok, a live interval)
    and shaped [NLET, n] by the map."""
    import torch

    rec, C, s0, s1 = args
    update_si = mods["ops.device_index"].update_si
    n = s0.shape[0]
    c = torch.arange(1, NLET + 1, dtype=torch.int32,
                     device=s0.device).repeat_interleave(n)
    rs0, rs1 = s0.repeat(NLET), s1.repeat(NLET)
    alive = (s0 < s1).repeat(NLET)

    def shaped(out):
        keep = out[2] & alive
        return tuple(torch.where(keep, x, 0).view(NLET, n) for x in out[:2])

    return (lambda: update_si(rec, C, c, rs0, rs1)), shaped


def sorted_rows(out):
    """K's (rows, n) as (its first n rows sorted by (f, j), n), on the
    host: a design's rows in any order compare equal to this checkout's."""
    import numpy as np
    import torch

    rows, n = out
    r = rows[: int(n)].cpu().numpy()
    return torch.from_numpy(r[np.lexsort((r[:, 1], r[:, 0]))]), n.cpu()


def design_call(mods: dict, name: str, args, kw):
    """(a call of kernel `name`'s wrapper of the design's package on
    args, kw; the name of the kernel it launches; the map of its outputs
    to this checkout's form, outside the call).  A design without A's
    letters form runs letters_stand_in; K's rows are sorted
    (sorted_rows)."""
    mod, fn = COMPARED[name]
    a = to_design(tuple(args), mods)
    k = {key: to_design(v, mods) for key, v in kw.items()}
    suffix = ("_sharded" if any(type(x).__name__ == "Shards" for x in args)
              else "")
    if fn == "update_si_letters" and not hasattr(mods[mod], fn):
        call, shaped = letters_stand_in(mods, a)
        return call, "update_si" + suffix, shaped
    wrapper = getattr(mods[mod], fn)
    return ((lambda: wrapper(*a, **k)), LAUNCHED.get(fn, fn) + suffix,
            sorted_rows if fn == "greedy_map" else (lambda out: out))


def runner_round(index, reads, device=None, wrapper="sa_lookup",
                 run="kaijux mem"):
    """The arguments of BatchRunner's first launch through `wrapper`
    (engine.batch's sa_lookup: kernel H's SaLookup round; update_si: A's
    Probes round; extend_all: J's first length group; extend_rows: I's
    ExtendFrom round) on a batch of reads, as the tool of chip_smoke's
    X_RUNS[run] classifies them (phase 4d); device as for BatchRunner."""
    import chip_smoke as cs
    from kaiju_tpu_torch.engine import batch

    first = []
    real = getattr(batch, wrapper)

    def spy(*a):
        first.append(a)
        return real(*a)

    setattr(batch, wrapper, spy)
    try:
        batch.BatchRunner(index, None, cs.x_config(run),
                          device=device).classify_batch(reads)
    finally:
        setattr(batch, wrapper, real)
    if not first:
        raise RuntimeError(f"the BatchRunner round launched no {wrapper}")
    return first[0]


def big_index(big_dir, build=None, device=None, seed=None):
    """(the big index at S = BIG_SHARDS, the dict of its text that
    big_classify.make_reads reads): phase 4g's DB from `build`
    (chip_smoke.start_big_build's box; waits for it) saved under build/,
    or the directory big_dir that tools.big_classify --out saved, its text
    made again from seed (by default phase 4g's, tools.big_classify's
    default)."""
    import json

    import chip_smoke as cs
    from kaiju_tpu_torch.parallel import big_index as bi

    if big_dir:
        seed = cs.BIG_SEED if seed is None else seed
        with open(os.path.join(big_dir, "meta.json")) as f:
            meta = json.load(f)
        db = bi.make_text(None, meta["N"] - meta["nseq"], seed, True)
        if (db["N"], db["nseq"]) != (meta["N"], meta["nseq"]):
            raise ValueError(f"{big_dir} was not built from seed {seed}")
        return bi.BigIndex.load(big_dir, device), db
    build["thread"].join()
    if "error" in build:
        raise build["error"]
    db = build.pop("db")
    path = os.path.join(cs.ROOT, "build", "compare_kernels", "big")
    bi.save_sharded_ktx(None, db, path, BIG_SHARDS)
    return bi.BigIndex.load(path, device), db


def big_calls(ix, reads) -> dict:
    """{kernel: (args, kwargs)} of L on the read codes uint8 [R, L] and of
    M on the kf of this checkout's L on them (phase 4g's step)."""
    import torch

    from kaiju_tpu_torch.ops import big_mem

    codes = torch.from_numpy(reads).to(ix.device)
    _i, s0, s1 = big_mem.big_extend_all(ix, codes)
    kf = torch.where(s1 > s0, s0, -1).reshape(-1)
    return {"big_extend_all": ((ix, codes), {}),
            "big_sa_walk": ((ix, kf), {})}


def hosts_inputs(index, reads, nodes, ktx_dir, device=None):
    """The arguments of kernels N and O on a hosts view of `index` (at
    ktx_dir, whose cache holds its seed tables and bitmaps; a
    ShardedIndex in HOSTS_SHARDS shards on the card, HOSTS_REMOTE remote):
    the seed tables built by ROW rounds (KmerTables.build_hosts), then one
    MEM batch of `reads` through ShardedMemPipeline on that view (with the
    hybrid on a text index: rounds of the extension, the switch, the text
    rows and the walks), every round answered by this checkout's N on the
    whole index.  Returns (the whole index, [(form, its round's queries)]
    of N: "fm_serve wW", the largest round of width W, and "fm_serve wW
    (median round)", each round's queries split as Exchange.serve splits
    them, (those to the remote shards, which their owner receives; this
    process's own), [(form, (args, kwargs))] of O: "mem_extend_hosts
    start", "mem_extend_hosts resume", the round with the most parked
    lanes, "mem_extend_hosts resume (median round)" and the largest round
    with each of its lanes 4 times, the lanes of a batch of 4 times the
    reads (a lane's copies write the same results and park the same
    queries)), each a copy taken when it was made.  device: the card (a
    CPU rehearsal passes the CPU)."""
    import copy

    import torch

    import chip_smoke as cs
    from kaiju_tpu_torch.engine.pipeline import _bucket
    from kaiju_tpu_torch.io.taxonomy import Taxonomy, parse_nodes_dmp
    from kaiju_tpu_torch.ops import classify, search
    from kaiju_tpu_torch.ops import device_index as tdev
    from kaiju_tpu_torch.ops.kmer import KmerTables
    from kaiju_tpu_torch.parallel.exchange import Exchange
    from kaiju_tpu_torch.parallel.sharded_fused import ShardedMemPipeline
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    whole = ShardedIndex(index, HOSTS_SHARDS, device or torch.device("cuda"))
    kept: dict = {}

    class Rounds:
        """A hosts view's rounds in this process: each round's queries
        kept, split as the exchange splits them, and answered by N on
        `whole`."""

        rounds = Exchange.rounds

        def parked_anywhere(self, n, stage):
            return n > 0

        def all_agree(self, flag):
            return bool(flag)

        def serve(self, queries, width, stage):
            shard = tdev.query_shard(view.rec, view.sa_seq, queries,
                                     view.text)
            own = ~torch.isin(shard, torch.tensor(HOSTS_REMOTE,
                                                  device=shard.device))
            kept.setdefault(width, []).append((queries[~own].clone(),
                                               queries[own].clone()))
            ans, bad = tdev.fm_serve(whole.rec, whole.C, whole.sa_seq,
                                     whole.sa_off, queries, width,
                                     whole.text)
            if int(bad):
                raise RuntimeError(f"{int(bad)} queries of a round unread")
            return ans

    view = copy.copy(whole)
    for name in ("rec", "sa_seq", "sa_off", "text"):
        a = getattr(whole, name)
        if a is not None:
            setattr(view, name, tdev.Shards(
                [None if o in HOSTS_REMOTE else part
                 for o, part in enumerate(a.parts)],
                a.per, a.shape[0], a.device, like=a.parts[0]))
    view.remote = {o: 0 for o in HOSTS_REMOTE}
    view.exchange = Rounds()
    view.shared = {}
    KmerTables.build_hosts(index, search.SEED_K, view)
    calls: list = []  # O's calls: the start, then each resume
    real = classify.mem_extend_hosts

    def spy(*a, **kw):
        calls.append((a, {k: v.clone() if isinstance(v, torch.Tensor)
                          else v for k, v in kw.items()}))
        return real(*a, **kw)

    pipe = ShardedMemPipeline(
        index, Taxonomy(parse_nodes_dmp(nodes)), cs.cli_config("mem"),
        HOSTS_SHARDS, kmer_cache_dir=ktx_dir, view=view)
    flat, chars, frag_off, n_frags, _k, rf_rows, _o = pipe._fragmenter.run(
        reads, pipe.S_SLOTS, _bucket)
    batch = [torch.from_numpy(x.copy()).to(whole.device) for x in
             (flat[:chars], frag_off[:n_frags + 1], rf_rows)]
    classify.mem_extend_hosts = spy
    try:
        pipe._device_rows(*batch)
    finally:
        classify.mem_extend_hosts = real

    def largest_and_median(rounds, size):
        by = sorted((r for r in rounds if size(r)), key=size)
        return (by[-1], by[(len(by) - 1) // 2]) if by else ()

    n_forms = []
    for w in N_WIDTHS:
        for r, tag in zip(largest_and_median(
                kept.get(w, []), lambda q: q[0].shape[0] + q[1].shape[0]),
                          ("", " (median round)")):
            n_forms.append((f"fm_serve w{w}{tag}", r))
    o_forms = [("mem_extend_hosts start", calls[0])]
    for r, tag in zip(largest_and_median(
            calls[1:], lambda c: c[1]["parked"].shape[0]),
            ("", " (median round)")):
        o_forms.append((f"mem_extend_hosts resume{tag}", r))
    if len(o_forms) > 1:  # a batch of 4 times the reads
        a, kw = o_forms[1][1]
        o_forms.append(("mem_extend_hosts resume (largest, its lanes 4x)",
                        (a, {**kw, **{k: torch.cat([kw[k]] * 4)
                                      for k in ("parked", "answers")}})))
    return whole, n_forms, o_forms


def hosts_calls(designs: dict, whole, form: str, inp):
    """{design: (a call of kernel N's or O's form `form` through the
    design's wrapper, the launches it makes, the map of its outputs to a
    common form, outside the call)} and the plain version's call.  N
    (inp: the round's queries as the exchange splits them, (received,
    own)) answers the received queries, then the process's own where it
    has any, a launch each, as Exchange.serve launches it; its outputs
    joined.  O (inp: (args, kwargs)) maps its outputs to (out, the parked
    lanes' (p, i, s0, s1) and their queries, both in lane order); its
    resume form gets the parked records in the width the design's start
    form gives them (the first four columns where it keeps four)."""
    import torch

    from kaiju_tpu_torch.ops import device_index as tdev
    from kaiju_tpu_torch.ops import search

    out: dict = {}
    if form.startswith("fm_serve"):
        width = int(form.split()[1][1:])
        segs = [q for q in inp if q.shape[0]]
        for tag, mods in designs.items():
            fn = mods["ops.device_index"].fm_serve
            idx = to_design((whole.rec, whole.C, whole.sa_seq, whole.sa_off),
                            mods)
            text = to_design(whole.text, mods)
            out[tag] = ((lambda fn=fn, idx=idx, text=text:
                         [fn(*idx, q, width, text) for q in segs]),
                        len(segs),
                        lambda o: (torch.cat([a for a, _b in o]),
                                   sum(b for _a, b in o)))

        def plain():
            return tdev.fm_serve_plain(whole.rec, whole.C, whole.sa_seq,
                                       whole.sa_off, torch.cat(segs), width,
                                       text=whole.text)
        return out, plain

    args, kw = inp

    def lanes(o):
        park, qs = o[1], o[2]
        order = park[:, 0].long().argsort()
        return o[0], park[order][:, :4], qs[order]

    resume = kw.get("parked") is not None
    start_args = args
    for tag, mods in designs.items():
        fn = mods["ops.search"].mem_extend_hosts
        a = to_design(tuple(args), mods)
        k = {key: to_design(v, mods) for key, v in kw.items()}
        if resume:
            skw = {key: v for key, v in k.items()
                   if key not in ("out", "parked", "answers")}
            width = fn(*to_design(tuple(start_args), mods), **skw)[1].shape[1]
            k["parked"] = kw["parked"][:, :width].contiguous()
            k["out"] = kw["out"].clone()  # written in place, the same
            # values each call
        out[tag] = ((lambda fn=fn, a=a, k=k: fn(*a, **k)), 1, lanes)

    def plain():
        k = dict(kw)
        if resume:
            k["out"] = kw["out"].clone()
        return lanes(search.mem_extend_hosts_plain(*args, **k))
    return out, plain


def compare_hosts(designs: dict, inputs, whole, where: str, smi: str, bad,
                  repeats: int = 3):
    """N's forms and O's two forms: this checkout's against its plain
    version, each design against this checkout, each design's launches
    counted by its own loader, then the designs timed in turns, `repeats`
    times over (the others, this, this, the others reversed; their
    launches alone, chip_smoke.launch_ms through each design's loader):
    the median ms of each design, and the range of this/other over the
    repeats."""
    import statistics

    import chip_smoke as cs

    others = [t for t in designs if t != "this"]
    for form, inp in inputs:
        calls, plain = hosts_calls(designs, whole, form, inp)
        want = calls["this"][2](calls["this"][0]())
        err = cs.max_abs_err(plain(), want)
        if err:
            bad.append((form, where, "plain", err))
        kname = form.split()[0]
        for tag, (call, n, shaped) in calls.items():
            before = {t: m["kernels"].LAUNCHES.get(kname, 0)
                      for t, m in designs.items()}
            e = cs.max_abs_err(shaped(call()), want)
            moved = {t: m["kernels"].LAUNCHES.get(kname, 0) - before[t]
                     for t, m in designs.items()}
            if e or moved != {t: n * int(t == tag) for t in designs}:
                bad.append((form, where, tag, e, moved))
        if form.startswith("fm_serve"):
            work = (f"{inp[0].shape[0] + inp[1].shape[0]:,} items "
                    f"({inp[0].shape[0]:,} received, {inp[1].shape[0]:,} "
                    f"own; {calls['this'][1]} launches)")
        else:
            lanes = (inp[1]["parked"] if "parked" in inp[1] else inp[0][5])
            work = f"{lanes.shape[0]:,} items"
        times = {tag: [] for tag in designs}
        ratios = {o: [] for o in others}
        for _ in range(repeats):
            now = {tag: [] for tag in designs}
            for tag in [*others, "this", "this", *others[::-1]]:
                now[tag].append(cs.launch_ms(
                    calls[tag][0], kernels=designs[tag]["kernels"]))
            for tag, t in now.items():
                times[tag] += t
            for o in others:
                ratios[o].append(sum(now["this"]) / sum(now[o]))
        cs.log(f"compare {form} [{where}, {work}, launches alone, "
               f"{repeats} repeats; the plain version's max_abs_err {err}]: "
               + "; ".join(f"{tag} {statistics.median(t):.4f} ms"
                           for tag, t in times.items())
               + "".join(f"; this/{o} {statistics.median(r):.3f} "
                         f"({min(r):.3f}-{max(r):.3f})"
                         for o, r in ratios.items()) + f" ({smi})")


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kaiju_tpu_torch.index.core import KaijuIndex
    from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

    designs = {os.path.basename(os.path.normpath(d)): import_checkout(d)
               for d in args.other}
    others = list(designs)
    if "this" in designs or len(others) != len(args.other):
        raise ValueError(f"designs need distinct names besides 'this': "
                         f"{args.other}")
    designs["this"] = {n: importlib.import_module(f"{PKG}.{n}")
                       for n in MODULES}
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
    lat_ns, dram_ns = cs.latency(smi)
    # phase 4g's DB builds beside the other kernels' comparisons
    build = (None if args.big_dir or args.no_big or args.only_hosts
             else cs.start_big_build(cs.BIG_LETTERS))
    cases = []
    if args.only_hosts:
        records, nodes, ktx = cs.make_db(args.seed, args.db_letters)
        reads = cs.make_reads(args.seed, records, cs.BATCH)
    elif not args.only_big:
        records, nodes, ktx = cs.make_db(args.seed, args.db_letters)
        reads = cs.make_reads(args.seed, records, cs.BATCH)
        r_records, r_ktx, families = cs.make_repeats_db(args.seed)
        r_reads = cs.make_reads(args.seed, r_records, cs.BATCH)
        tree = cs.deep_tree(args.seed)
        cases = [(tag, ktx[tag], reads, None) for tag in ("fmi", "text")]
        cases += [(f"repeats, {tag}", r_ktx[tag], r_reads, families)
                  for tag in ("fmi", "text")]
    bad = []

    def compare(name, where, a, kw, want):
        """Each design's kernel (phase 3's call `name`) on a, kw against
        want, then timed."""
        calls = {tag: design_call(mods, name, a, kw)
                 for tag, mods in designs.items()}
        for tag, (call, kname, shaped) in calls.items():
            before = {t: dict(m["kernels"].LAUNCHES)
                      for t, m in designs.items()}
            err = cs.max_abs_err(shaped(call()), want)
            moved = {t: m["kernels"].LAUNCHES.get(kname, 0)
                     - before[t].get(kname, 0) for t, m in designs.items()}
            if err or moved != {t: int(t == tag) for t in designs}:
                bad.append((name, where, tag, err, moved))
        times = {tag: [] for tag in designs}
        for tag in [*others, "this", "this", *others[::-1]]:
            times[tag].append(cs.cuda_ms(calls[tag][0]))
        cs.log(f"compare {name} [{where}]: " + "; ".join(
            f"{tag} {t[0]:.4f} {t[1]:.4f} ms" for tag, t in times.items())
            + "".join(f"; this/{o} {sum(times['this']) / sum(times[o]):.3f}"
                      for o in others) + f" ({smi})")

    for where, path, rd, fam in cases:
        index = KaijuIndex.load(path)
        checks, inputs = cs.check_kernels(
            index, rd, path, lat_ns,
            deep=(cs.deep_seq_tax(tree, index, args.seed, fam), tree))
        # H, I and K on the -v paths' inputs
        v_checks, v_inputs = cs.check_verbose_kernels(index, nodes, rd,
                                                      path, lat_ns)
        checks.update(v_checks)
        inputs.update(v_inputs)
        if where == "fmi":  # H, A, J and I on a BatchRunner round
            h = runner_round(index, rd[:cs.BATCH])
            inputs["sa_lookup (BatchRunner)"] = (None, h, {}, None, None)
            checks["sa_lookup (BatchRunner)"] = cs.check_sa_lookup(
                h, lat_ns, f"{h[-1].shape[0]:,} SA positions of a "
                "BatchRunner round (kaijux -a mem)")
            u = runner_round(index, rd[:cs.BATCH], wrapper="update_si",
                             run="kaijux greedy")
            inputs["update_si (BatchRunner)"] = (None, u, {}, None, None)
            checks["update_si (BatchRunner)"] = cs.x_kernel_checks(
                {"update_si": u}, "kaijux greedy", lat_ns)["update_si"]
            j = runner_round(index, rd[:cs.BATCH], wrapper="extend_all")
            inputs["extend_all (BatchRunner)"] = (None, j, {}, None, None)
            checks["extend_all (BatchRunner)"] = cs.x_kernel_checks(
                {"extend_all": j}, "kaijux mem", lat_ns)["extend_all"]
            r = runner_round(index, rd[:cs.BATCH], wrapper="extend_rows",
                             run="kaijux greedy")
            inputs["extend_rows (BatchRunner)"] = (None, r, {}, None, None)
            checks["extend_rows (BatchRunner)"] = cs.x_kernel_checks(
                {"extend_rows": r}, "kaijux greedy", lat_ns)["extend_from"]
        cs.log_checks(checks, where)
        bad += [(n, where, "plain", v[0]) for n, v in checks.items() if v[0]]
        sh = (ShardedIndex(index, SHARDS, torch.device("cuda"))
              if where in ("fmi", "text") else None)
        for name in COMPARED:
            if name not in inputs:  # G without text; H's other rounds
                continue
            dv, a, kw, _b, _n = inputs[name]
            call, _k, shaped = design_call(designs["this"], name, a, kw)
            want = shaped(call())
            compare(name, where, a, kw, want)
            if sh is not None and name not in UNSHARDED:
                sa, skw = cs.shard_call(sh, dv, a, kw)
                compare(name, f"{where}, {SHARDS} shards", sa, skw, want)
        del inputs, sh
        torch.cuda.empty_cache()
    if not args.only_big:  # N and O on a hosts view of the text index
        where = (f"text, {HOSTS_SHARDS} shards, {list(HOSTS_REMOTE)} "
                 "remote")
        whole, n_forms, o_forms = hosts_inputs(
            KaijuIndex.load(ktx["text"]), reads, nodes, ktx["text"])
        compare_hosts(designs, n_forms + o_forms, whole, where, smi, bad)
        del whole, n_forms, o_forms
        torch.cuda.empty_cache()
    from kaiju_tpu_torch.tools import big_classify

    if not args.no_big and not args.only_hosts:
        ix, db = big_index(args.big_dir, build)
        where = f"big index, S = {ix.S}"
        for suffix, (n, seed) in BIG.items():
            rd = big_classify.make_reads(db, n, cs.BIG_LEN, seed=seed)[0]
            checks = {k + suffix: v for k, v in cs.big_checks(
                ix, rd, smi, dram_ns, f"{n:,} reads",
                plain=not suffix).items()}
            cs.log_checks(checks, where)
            bad += [(k, where, "plain", v[0]) for k, v in checks.items()
                    if v[0]]
            for name, (a, kw) in big_calls(ix, rd).items():
                call, _k, shaped = design_call(designs["this"],
                                               name + suffix, a, kw)
                want = shaped(call())
                compare(name + suffix, where, a, kw, want)
                del want
            torch.cuda.empty_cache()
    if bad:
        cs.log(f"designs differ or launched the wrong kernels: {bad}")
        return 1
    cs.log("compare_kernels: every design equal to this checkout's "
           "kernels, which equal their plain versions")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="+", help="a directory holding another "
                    f"checkout's {PKG}")
    ap.add_argument("--seed", type=int, default=20240817)
    ap.add_argument("--db-letters", type=int, default=64_000_000)
    big = ap.add_mutually_exclusive_group()
    big.add_argument("--only-big", action="store_true",
                     help="compare L and M alone")
    big.add_argument("--no-big", action="store_true",
                     help="compare all but L and M")
    big.add_argument("--only-hosts", action="store_true",
                     help="compare N and O alone")
    ap.add_argument("--big-dir", default=None, help="the big index as "
                    "tools.big_classify --out saved it, from its default "
                    "seed (default: phase 4g's DB, built here)")
    args = ap.parse_args(argv)
    try:
        return run(args)
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
