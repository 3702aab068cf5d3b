"""Batched classification by per-read coroutines on the device: the engine
of the taxonomy-free tools (``kaijux``, ``kaijup``).

Runs one ``ReadClassifier`` coroutine per read (``engine/core.py``) in
lockstep rounds: each round gathers every coroutine's pending request,
groups them by kind and serves each kind with ONE kernel launch over the
whole round and one copy back to the host:

    ExtendAll   kernel J ``extend_all``, through the extension-map cache
    ExtendFrom  kernel I ``extend_from`` in its code-row form
                (``extend_rows``), no substitution
    Probes      kernel A ``update_si``
    SaLookup    kernel H ``sa_lookup``

The responses go back to the coroutines as Python ints and tuples (the
extension maps as numpy int32 rows), so the host logic, and with it every
output line, is the sequential engine's.  A warm-up fills the cache with
the maps of every fragment the reads can search (the originals and their
SEG pieces) before the first round, so every ExtendAll of a round is a
cache hit.

This is ``kaiju_tpu.engine.batch.BatchRunner`` over the fused ``rec``
records instead of ``blocks``/``occ``.  The JAX runner pads every launch
to a power of two to bound XLA recompiles; the kernels here take exact
sizes.  Only the grouping of J's launches by length bucket stays: one
``[F, Lmax]`` launch would give every fragment the widest one's lanes.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..index.alphabet import trans_table
from ..index.core import KaijuIndex
from ..io.taxonomy import Taxonomy
from ..ops.device_index import (
    DeviceIndex,
    extend_all,
    extend_rows,
    resolve_device,
    sa_lookup,
    update_si,
)
from .config import GREEDY, KaijuConfig
from .core import (
    ClassifyResult,
    ExtendAll,
    ExtendFrom,
    Probes,
    ReadClassifier,
    SaLookup,
    _calc_score,
    format_output_line,
    format_output_line_x,
)
from .fragments import FragmentSource
from .pipeline import _bucket

# host seconds of each stage, over all runners: the warm-up's fragment
# enumeration and SEG, building the code and lane arrays, each request
# kind's upload, launch, wait and copy back (the warm-up's J launches count
# under extend_all), and stepping the coroutines
HOST_SECONDS = dict.fromkeys(
    ("warmup", "encode", "extend_all", "extend_from", "probes", "sa_lookup",
     "steps"), 0.0)
# reads classified and lockstep rounds served, over all runners
COUNTS = {"reads": 0, "rounds": 0}


def reset_counts() -> None:
    for k in HOST_SECONDS:
        HOST_SECONDS[k] = 0.0
    for k in COUNTS:
        COUNTS[k] = 0


class BatchRunner:
    def __init__(
        self,
        index: KaijuIndex,
        taxonomy: Optional[Taxonomy],
        config: KaijuConfig,
        device_index: Optional[DeviceIndex] = None,
        device=None,
    ):
        """device: None for the GPU, "cpu" for the plain versions; a given
        device_index brings its own device."""
        self.cfg = config
        self.index = index
        self.core = ReadClassifier(config, index, taxonomy)
        self.dev = device_index or DeviceIndex(index, resolve_device(device))
        self.device = self.dev.device
        self._trans = trans_table(index.alphabet)
        # fragment -> its extension map (start, si0, si1), never emptied
        self._ext_cache: dict[str, tuple] = {}

    # ------------------------------------------------------------------

    def _encode(self, seq: str) -> np.ndarray:
        raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        return self._trans[raw].astype(np.uint8)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _extend_all_batch(self, frags: list[str]) -> None:
        """Fill the extension-map cache for a list of fragments."""
        frags = [f for f in dict.fromkeys(frags) if f not in self._ext_cache]
        if not frags:
            return
        frags.sort(key=len)
        # one launch per length bucket bounds the padding
        group: list[str] = []
        for f in frags:
            if group and _bucket(len(f), 16) != _bucket(len(group[0]), 16):
                self._run_extend_group(group)
                group = []
            group.append(f)
        if group:
            self._run_extend_group(group)

    def _run_extend_group(self, group: list[str]) -> None:
        t0 = time.perf_counter()
        L = max(len(f) for f in group)
        codes = np.zeros((len(group), L), dtype=np.uint8)
        flen = np.zeros(len(group), dtype=np.int32)
        for i, f in enumerate(group):
            e = self._encode(f)
            codes[i, : len(e)] = e
            flen[i] = len(e)
        t1 = time.perf_counter()
        maps = torch.stack(extend_all(self.dev.rec, self.dev.C,
                                      self._put(codes), self._put(flen)))
        start, si0, si1 = maps.cpu().numpy()
        for i, f in enumerate(group):
            n = len(f)
            self._ext_cache[f] = (start[i, :n], si0[i, :n], si1[i, :n])
        HOST_SECONDS["encode"] += t1 - t0
        HOST_SECONDS["extend_all"] += time.perf_counter() - t1

    def _serve_round(self, requests: list) -> list:
        """Serve one round of heterogeneous requests, one launch per kind."""
        responses: list = [None] * len(requests)
        dev = self.dev

        # --- ExtendAll: through the cache ---
        ext_idx = [i for i, r in enumerate(requests) if isinstance(r, ExtendAll)]
        if ext_idx:
            self._extend_all_batch([requests[i].frag for i in ext_idx])
            for i in ext_idx:
                responses[i] = self._ext_cache[requests[i].frag]

        # --- ExtendFrom: kernel I on the lanes' code rows ---
        ef_idx = [i for i, r in enumerate(requests) if isinstance(r, ExtendFrom)]
        if ef_idx:
            t0 = time.perf_counter()
            N = len(ef_idx)
            codes = np.zeros((N, max(len(requests[i].frag) for i in ef_idx)),
                             dtype=np.uint8)
            lanes = np.zeros((3, N), dtype=np.int32)  # start_i, s0, s1
            for n, i in enumerate(ef_idx):
                r = requests[i]
                e = self._encode(r.frag)
                codes[n, : len(e)] = e
                lanes[:, n] = (len(e) - r.matchlen, r.si0, r.si1)
            t1 = time.perf_counter()
            start_i, s0, s1 = self._put(lanes)
            act = torch.ones(N, dtype=torch.bool, device=self.device)
            res = torch.stack(extend_rows(dev.rec, dev.C, self._put(codes),
                                          start_i, s0, s1, act))
            for i, row in zip(ef_idx, res.t().tolist()):
                responses[i] = tuple(row)
            HOST_SECONDS["encode"] += t1 - t0
            HOST_SECONDS["extend_from"] += time.perf_counter() - t1

        # --- Probes: kernel A ---
        pr_idx = [i for i, r in enumerate(requests) if isinstance(r, Probes)]
        if pr_idx:
            t0 = time.perf_counter()
            flat = [item for i in pr_idx for item in requests[i].items]
            lanes = np.asarray(flat, dtype=np.int32).T  # c, s0, s1
            t1 = time.perf_counter()
            c, s0, s1 = self._put(lanes)
            n0, n1, ok = update_si(dev.rec, dev.C, c, s0, s1)
            got = torch.stack((n0, n1, ok.to(torch.int32))).t().tolist()
            pos = 0
            for i in pr_idx:
                k = len(requests[i].items)
                responses[i] = [(a, b) if hit else None
                                for a, b, hit in got[pos : pos + k]]
                pos += k
            HOST_SECONDS["encode"] += t1 - t0
            HOST_SECONDS["probes"] += time.perf_counter() - t1

        # --- SaLookup: kernel H ---
        sa_idx = [i for i, r in enumerate(requests) if isinstance(r, SaLookup)]
        if sa_idx:
            t0 = time.perf_counter()
            flat = np.asarray([k for i in sa_idx
                               for k in requests[i].positions], dtype=np.int32)
            t1 = time.perf_counter()
            iseq, _pos = sa_lookup(dev.rec, dev.C, dev.sa_seq, dev.sa_off,
                                   dev.nseq, dev.chpt_exp, self._put(flat))
            iseq = iseq.tolist()
            pos = 0
            for i in sa_idx:
                n = len(requests[i].positions)
                responses[i] = iseq[pos : pos + n]
                pos += n
            HOST_SECONDS["encode"] += t1 - t0
            HOST_SECONDS["sa_lookup"] += time.perf_counter() - t1

        return responses

    # ------------------------------------------------------------------

    def _warmup_fragments(self, reads) -> list[str]:
        """All fragments whose extension maps can be needed: the originals
        of every read plus their SEG split pieces (a superset of what the
        lazy queue will actually search)."""
        cfg = self.cfg
        frags: list[str] = []
        for _name, seq1, seq2 in reads:
            src = FragmentSource(cfg.mode, cfg.min_fragment_length, cfg.min_score)
            if cfg.input_is_protein:
                if len(seq1) >= cfg.min_fragment_length:
                    src.add_protein(seq1)
            else:
                if len(seq1) >= cfg.min_fragment_length * 3:
                    src.add_dna(seq1)
                if seq2 is not None and len(seq2) >= cfg.min_fragment_length * 3:
                    src.add_dna(seq2)
            for _key, frag in src.items:
                frags.append(frag)
                if cfg.seg:
                    locs = self.core.seg_intervals(frag)
                    if locs:
                        start = 0
                        for left, right in locs:
                            self._piece(frag, start, left - start, frags)
                            start = right + 1
                        self._piece(frag, start, len(frag) - start, frags)
        return frags

    def _piece(self, seq, start, length, out):
        """A SEG piece the queue would requeue (ConsumerThread.cpp:298-322:
        strict > on length, and in Greedy the score gate)."""
        cfg = self.cfg
        if length > cfg.min_fragment_length:
            if cfg.mode == GREEDY:
                if _calc_score(seq, start, length, 0) < cfg.min_score:
                    return
            out.append(seq[start : start + length])

    # ------------------------------------------------------------------

    def classify_batch(self, reads) -> list[tuple[str, ClassifyResult]]:
        """reads: list of (name, seq1, seq2-or-None)."""
        t0 = time.perf_counter()
        frags = self._warmup_fragments(reads)
        HOST_SECONDS["warmup"] += time.perf_counter() - t0
        self._extend_all_batch(frags)

        t0 = time.perf_counter()
        gens = []
        results: list = [None] * len(reads)
        pending: dict[int, object] = {}
        for rid, (name, seq1, seq2) in enumerate(reads):
            gen = self.core.run(name, seq1, seq2)
            gens.append(gen)
            try:
                pending[rid] = next(gen)
            except StopIteration as stop:
                results[rid] = stop.value
        HOST_SECONDS["steps"] += time.perf_counter() - t0

        while pending:
            rids = list(pending)
            resps = self._serve_round([pending[r] for r in rids])
            t0 = time.perf_counter()
            new_pending = {}
            for r, resp in zip(rids, resps):
                try:
                    new_pending[r] = gens[r].send(resp)
                except StopIteration as stop:
                    results[r] = stop.value
            pending = new_pending
            HOST_SECONDS["steps"] += time.perf_counter() - t0
            COUNTS["rounds"] += 1

        COUNTS["reads"] += len(reads)
        return [(reads[i][0], results[i]) for i in range(len(reads))]

    def classify_to_lines(self, reads) -> list[str]:
        """The TSV lines of the reads: the taxonomy-free form with
        cfg.taxonomy_free, kaiju's otherwise."""
        if self.cfg.taxonomy_free:
            return [format_output_line_x(name, res)
                    for name, res in self.classify_batch(reads)]
        return [format_output_line(name, res, self.cfg.verbose)
                for name, res in self.classify_batch(reads)]
