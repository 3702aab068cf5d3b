"""MEM classification with verbose output (``kaiju -a mem -v``) on the
device: the host-tail half of ``kaiju_tpu.engine.mem_fast``.

Verbose lines need the names of the matched sequences and the matched
fragments, which the device tail (``engine.mem``) does not return.  Per
batch: the native fragmenter (``NativeFragmenter``, native/fragments.cpp)
gives each read's fragments in the reference's pop order; every fragment
not seen before is searched once on the device, B -> C
(``ops.search.mem_search``, with B's Bloom screen on an index with a text
copy and without the hybrid, as the JAX path runs it), giving its maxl and
up to TIE_CAP ties; the rare fragment with more ties is extended again in
full by kernel J and its ties are taken on the host.  The host assembles
each read's ties in pop order, resolves their SA intervals to sequence
names through kernel H (``SaResolveMixin``) with the reference's id caps,
and takes the LCA (ConsumerThread.cpp:543-628, :799-845).

The fragment memo (uid -> statistics) lives across batches and is dropped
wholesale between batches once it holds more than KAIJU_FRAG_CACHE_CAP
fragments (the JAX package's variable), as in kaiju_tpu.  The JAX path's
static-shape machinery (shape buckets, lane capacities and their retry,
the padded SA-walk shape) has no counterpart: B evaluates every lane and
the kernels take any shape.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Optional

import numpy as np

from ..index.alphabet import trans_table
from ..index.core import KaijuIndex, parse_taxid
from ..io.taxonomy import Taxonomy
from ..ops.device_index import extend_all, sa_lookup
from ..ops.search import SEED_K, TIE_CAP, mem_search
from .config import KaijuConfig
from .core import ClassifyResult
from .fragments_native import NativeFragmenter
from .pipeline import DeviceSetup


# host seconds of each stage of a batch, over all pipelines: fragmenting,
# the device search (B -> C, J; its upload, launches and wait), assembling
# each read's ties, resolving them to ids (H) and building the results
HOST_SECONDS = dict.fromkeys(
    ("fragment", "search", "assemble", "resolve", "results"), 0.0)


def reset_counts() -> None:
    for k in HOST_SECONDS:
        HOST_SECONDS[k] = 0.0


def _flat_layout(encoded: list[np.ndarray]):
    """(flat uint8 [P], frag_off int32 [F+1]) of the fragments' codes."""
    frag_off = np.zeros(len(encoded) + 1, dtype=np.int32)
    np.cumsum([len(e) for e in encoded], out=frag_off[1:])
    return np.concatenate(encoded), frag_off


class SaResolveMixin:
    """Batched SA-position -> taxon-id resolution with the reference's
    enumeration caps, shared by the MEM and Greedy host-tail pipelines
    (requires self.cfg, self.index, self.dev and self._put)."""

    def _sa_lookup_batch(self, ks: list[int], sa_cache: dict[int, int]) -> None:
        """One launch of kernel H for the positions of ks not in sa_cache."""
        uniq = [k for k in dict.fromkeys(ks) if k not in sa_cache]
        if not uniq:
            return
        dv = self.dev
        iseq, _pos = sa_lookup(dv.rec, dv.C, dv.sa_seq, dv.sa_off, dv.nseq,
                               dv.chpt_exp,
                               self._put(np.asarray(uniq, dtype=np.int32)))
        sa_cache.update(zip(uniq, iseq.tolist()))

    def _resolve_ids(self, per_read_ranges: list[list[tuple[int, int]]]):
        """ids/dbnames per read with the reference enumeration caps.

        The reference checks `ids.size() > max_match_ids` before every
        position of every SI, so once exceeded, every later range breaks at
        its first position too: enumeration stops globally
        (reference: ConsumerThread.cpp:799-845)."""
        cfg = self.cfg
        idx = self.index
        states = []
        for ranges in per_read_ranges:
            states.append(
                {
                    "ids": set(),
                    "dbnames": set(),
                    "ri": 0,
                    "off": 0,
                    "done": not ranges,
                    "ranges": ranges,
                }
            )
        chunk = cfg.max_match_ids + 6
        sa_cache: dict[int, int] = {}
        while True:
            postings: list[tuple[int, list[int]]] = []
            all_ks: list[int] = []
            for rid, st in enumerate(states):
                if st["done"]:
                    continue
                ks = []
                while st["ri"] < len(st["ranges"]) and len(ks) < chunk:
                    s0, s1 = st["ranges"][st["ri"]]
                    if s0 + st["off"] >= s1:
                        st["ri"] += 1
                        st["off"] = 0
                        continue
                    take = min(chunk - len(ks), s1 - (s0 + st["off"]))
                    ks.extend(range(s0 + st["off"], s0 + st["off"] + take))
                    st["off"] += take
                if ks:
                    postings.append((rid, ks))
                    all_ks.extend(ks)
                else:
                    st["done"] = True
            if not postings:
                break
            self._sa_lookup_batch(all_ks, sa_cache)
            for rid, ks in postings:
                st = states[rid]
                for k in ks:
                    if len(st["ids"]) > cfg.max_match_ids:
                        st["done"] = True
                        break
                    name = idx.names[sa_cache[k]]
                    taxid = parse_taxid(name)
                    if (
                        "_" in name
                        and cfg.verbose
                        and len(st["dbnames"]) < cfg.max_match_acc
                    ):
                        st["dbnames"].add(name.rsplit("_", 1)[0])
                    st["ids"].add(taxid)
        return [(sorted(st["ids"]), sorted(st["dbnames"])) for st in states]

    def _result(self, longest: int, ids, dbnames, vfrags) -> ClassifyResult:
        """The result of a read with a best match of score `longest`."""
        if len(ids) == 1:
            lca = ids[0]
        elif self.tax is not None:
            lca = self.tax.lca(ids, verbose=self.cfg.verbose)
        else:
            lca = 0
        return ClassifyResult(
            classified=lca > 0, lca=lca, score=longest, match_ids=ids,
            match_dbnames=dbnames, match_fragments=vfrags,
        )


class MemFastPipeline(SaResolveMixin, DeviceSetup):
    LOOKAHEAD = 3  # batches submitted ahead of the one being collected

    def __init__(
        self,
        index: KaijuIndex,
        taxonomy: Optional[Taxonomy],
        config: KaijuConfig,
        device=None,
        kmer_cache_dir: Optional[str] = None,
    ):
        if config.mode != "mem":
            raise ValueError("MemFastPipeline runs -a mem")
        super().__init__(index, taxonomy, config, device, kmer_cache_dir,
                         min(SEED_K, config.min_fragment_length),
                         config.min_fragment_length)
        self._trans = trans_table(index.alphabet)
        self._fragmenter = NativeFragmenter(
            config.mode, config.min_fragment_length, config.min_score,
            config.seg, config.input_is_protein,
        )
        self._frag_ids: dict[str, int] = {}
        self._frags: list[str] = []
        # uid -> (maxl, [(tie j, si0, si1) ascending j])
        self._stats: list = []
        # generation flush: the fragment memo tables grow with unique
        # fragments seen; on a production-scale stream they are dropped
        # wholesale once the cap is hit (between batches only: uids in
        # submitted-but-uncollected states must stay valid)
        self._cache_cap = int(os.environ.get("KAIJU_FRAG_CACHE_CAP", 1 << 18))
        self._inflight = 0

    # ---- map computation: B -> C, J on tie overflow ------------------

    def _uid(self, frag: str) -> int:
        uid = self._frag_ids.get(frag)
        if uid is None:
            uid = len(self._frags)
            self._frag_ids[frag] = uid
            self._frags.append(frag)
            self._stats.append(None)
        return uid

    def _encode(self, frag: str) -> np.ndarray:
        raw = np.frombuffer(frag.encode("ascii"), dtype=np.uint8)
        return self._trans[raw].astype(np.uint8)

    def _dispatch_maps(self, uids: list[int]):
        """Queue B -> C for every not-yet-known fragment; returns a pending
        handle (or None) without waiting for the card."""
        cfg = self.cfg
        todo = [u for u in dict.fromkeys(uids) if self._stats[u] is None]
        if not todo:
            return None
        encoded = [self._encode(self._frags[u]) for u in todo]
        flat, frag_off = _flat_layout(encoded)
        stats = mem_search(
            self.dev.rec, self.dev.C, self._seed, self._put(flat),
            self._put(frag_off), self.seed_K, cfg.min_fragment_length - 1,
            cfg.min_fragment_length, TIE_CAP, bloom=self._bloom,
        )
        return todo, encoded, stats

    def _finish_maps(self, pending) -> None:
        """Fetch a dispatched search and store per-uid (maxl, ties)."""
        if pending is None:
            return
        todo, encoded, (maxl, tie_cnt, tie_j, tie_s0, tie_s1) = pending
        maxl, tie_cnt = maxl.tolist(), tie_cnt.tolist()
        tie_j, tie_s0, tie_s1 = (t.tolist() for t in (tie_j, tie_s0, tie_s1))
        overflow = [fi for fi in range(len(todo)) if tie_cnt[fi] > TIE_CAP]
        full: dict[int, tuple] = {}
        if overflow:
            full = self._full_maps(encoded, overflow,
                                   self.cfg.min_fragment_length - 1)
        for fi, u in enumerate(todo):
            if fi in full:
                self._stats[u] = full[fi]
                continue
            ties = [(tie_j[fi][t], tie_s0[fi][t], tie_s1[fi][t])
                    for t in range(min(tie_cnt[fi], TIE_CAP))]
            self._stats[u] = (maxl[fi], ties)

    def _full_maps(self, encoded_all, rows, j0):
        """Fallback for tie-cap overflow: the full extension map of the
        given fragments through kernel J, ties recomputed on the host
        (rare: repeat-heavy DBs)."""
        cfg = self.cfg
        enc = [encoded_all[fi] for fi in rows]
        L = max(len(e) for e in enc)
        oc = np.zeros((len(rows), L), dtype=np.uint8)
        ol = np.zeros(len(rows), dtype=np.int32)
        for t, e in enumerate(enc):
            oc[t, : len(e)] = e
            ol[t] = len(e)
        start, si0, si1 = (
            a.cpu().numpy()
            for a in extend_all(self.dev.rec, self.dev.C, self._put(oc),
                                self._put(ol))
        )
        out = {}
        jg = np.arange(L, dtype=np.int64)
        for t, fi in enumerate(rows):
            n = int(ol[t])
            valid = (jg >= j0) & (jg < n)
            length = jg - start[t] + 1
            jstop = int(np.where(valid & (start[t] <= 1), jg, -1).max())
            eligible = valid & (jg >= jstop) & (length >= cfg.min_fragment_length)
            maxl = int(np.where(eligible, length, 0).max())
            ties = [
                (int(j), int(si0[t, j]), int(si1[t, j]))
                for j in np.nonzero(eligible & (length == maxl) & (maxl > 0))[0]
            ]
            out[fi] = (maxl, ties)
        return out

    # ---- per-read assembly -------------------------------------------

    def _assemble(self, order: list[int], longest: int):
        """([SI ranges in enumeration order], verbose strings)."""
        cfg = self.cfg
        ranges = []
        verbose_frags = []
        for u in order:
            maxl, ties = self._stats[u]
            if maxl != longest:
                continue
            # greedyExact chains ties newest-first => ascending j already
            for j, s0, s1 in ties:
                ranges.append((s0, s1))
            if cfg.verbose and ties:
                qi = ties[0][0] - longest + 1
                frag = self._frags[u]
                verbose_frags.append(frag[qi : qi + longest])
        return ranges, verbose_frags

    # ---- entry --------------------------------------------------------

    def _maybe_flush_caches(self):
        if self._inflight == 0 and len(self._frags) > self._cache_cap:
            self._frag_ids.clear()
            self._frags.clear()
            self._stats.clear()

    def submit_batch(self, reads):
        """Host fragmenting and the device search of the batch's new
        fragments, queued without waiting; collect_batch takes the state."""
        self._maybe_flush_caches()
        self._inflight += 1
        try:
            t0 = time.perf_counter()
            frags, orders_local = self._fragmenter.run(reads)
            guid = [self._uid(f) for f in frags]
            orders = [[guid[u] for u in o] for o in orders_local]
            t1 = time.perf_counter()
            pending = self._dispatch_maps([u for o in orders for u in o])
            HOST_SECONDS["fragment"] += t1 - t0
            HOST_SECONDS["search"] += time.perf_counter() - t1
            return reads, orders, pending
        except BaseException:
            # a failed submit never reaches collect_batch; undo the
            # in-flight count so cache flushing keeps firing
            self._inflight = max(0, self._inflight - 1)
            raise

    def classify_stream(self, batches):
        """Yield each batch's results in order, with up to LOOKAHEAD
        batches queued ahead; the lookahead drains when the memo is over
        its cap, so that the flush can fire at the next submit."""
        q: deque = deque()
        for batch in batches:
            if len(self._frags) > self._cache_cap:
                while q:
                    yield self.collect_batch(q.popleft())
            q.append(self.submit_batch(batch))
            if len(q) > self.LOOKAHEAD:
                yield self.collect_batch(q.popleft())
        while q:
            yield self.collect_batch(q.popleft())

    def collect_batch(self, state) -> list[tuple[str, ClassifyResult]]:
        self._inflight = max(0, self._inflight - 1)
        reads, orders, pending = state
        t0 = time.perf_counter()
        self._finish_maps(pending)
        t1 = time.perf_counter()

        assembled = []
        read_longest = []
        for order in orders:
            if not order:
                read_longest.append(0)
                assembled.append(([], []))
                continue
            longest = max(self._stats[u][0] for u in order)
            read_longest.append(longest)
            if longest == 0:
                assembled.append(([], []))
            else:
                assembled.append(self._assemble(order, longest))
        t2 = time.perf_counter()

        resolved = self._resolve_ids([a[0] for a in assembled])
        t3 = time.perf_counter()

        out = []
        for (name, _s1, _s2), longest, (_r, vfrags), (ids, dbnames) in zip(
            reads, read_longest, assembled, resolved
        ):
            if longest == 0 or not ids:
                out.append((name, ClassifyResult(False, 0)))
            else:
                out.append((name, self._result(longest, ids, dbnames, vfrags)))
        HOST_SECONDS["search"] += t1 - t0
        HOST_SECONDS["assemble"] += t2 - t1
        HOST_SECONDS["resolve"] += t3 - t2
        HOST_SECONDS["results"] += time.perf_counter() - t3
        return out
