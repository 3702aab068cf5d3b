"""MEM classification pipeline on the device (``kaiju -a mem`` with a
taxonomy and without ``-v``).

Per batch: the native fragmenter translates the reads, splits them at
stops, applies SEG and simulates the reference's fragment queue, writing
the fragment codes, their offsets and each read's pop-order slot table
(``NativeFragmenter2``); the device runs B -> C -> D
(``ops.classify.fused_mem_classify``) and returns 16 bytes a read.  Reads
whose fragments overflow their S slots, and reads the device flags
(FLAG_TIE_OVER / FLAG_NEED_MORE), are replayed by the host
``ExactClassifier``, so every output line equals the reference's
(ConsumerThread.cpp:543-628, :799-845, util.cpp:194-263).

This is the device-tail path of ``kaiju_tpu.engine.mem_fast``.  The JAX
path's static-shape machinery (shape buckets, learned lane capacities and
their retry) has no counterpart: the kernels take any shape and have no
lane capacities.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..index.core import KaijuIndex
from ..io.taxonomy import Taxonomy
from ..ops.classify import FLAG_NEED_MORE, FLAG_TIE_OVER, fused_mem_classify
from ..ops.device_index import DeviceIndex, resolve_device
from ..ops.kmer import KmerTables
from ..ops.search import SEED_K, TIE_CAP
from .config import KaijuConfig
from .core import ClassifyResult, ExactClassifier
from .fragments_native import NativeFragmenter2

# reads classified and reads replayed on the host, over all pipelines
HOST_REPLAY = {"reads": 0, "flagged": 0}
# host seconds of each stage of a batch, over all pipelines: fragmenting,
# upload and kernel enqueue, waiting for the result rows, host replay and
# building the result objects
HOST_SECONDS = dict.fromkeys(
    ("fragment", "submit", "wait", "replay", "results"), 0.0)


def reset_counts() -> None:
    HOST_REPLAY["reads"] = 0
    HOST_REPLAY["flagged"] = 0
    for k in HOST_SECONDS:
        HOST_SECONDS[k] = 0.0


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class MemPipeline:
    S_SLOTS = 16  # pop-order slots per read in the device slot table
    R_BUDGET = 32  # SA positions resolved on the device per read
    LOOKAHEAD = 2  # batches submitted ahead of the one being collected

    def __init__(
        self,
        index: KaijuIndex,
        taxonomy: Taxonomy,
        config: KaijuConfig,
        device=None,
        kmer_cache_dir: Optional[str] = None,
    ):
        if config.mode != "mem" or config.verbose or taxonomy is None:
            raise ValueError("MemPipeline runs -a mem with a taxonomy, no -v")
        self.cfg = config
        self.index = index
        self.tax = taxonomy
        self.device = resolve_device(device)
        self.dev = DeviceIndex(index, self.device)
        self.seed_K = min(SEED_K, config.min_fragment_length)
        kmer = KmerTables.load_or_build(index, kmer_cache_dir, self.seed_K,
                                        device_index=self.dev)
        self._seed = tuple(self._put(a) for a in kmer.planar_seed(self.seed_K))
        par, dep = taxonomy.dense_arrays()
        self._parent = self._put(par)
        self._depth = self._put(dep)
        self._fragmenter = NativeFragmenter2(
            config.mode, config.min_fragment_length, config.min_score,
            config.seg, config.input_is_protein,
        )
        self._exact = None  # host replay engine, made at first use

    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def submit_batch(self, reads):
        """Fragment a batch on the host and queue its device work; the
        result is taken by collect_batch.  Submitting the next batch before
        collecting this one overlaps host work with the device's."""
        cfg = self.cfg
        t0 = time.perf_counter()
        flat, chars, frag_off, n_frags, _keys, rf_rows, oflow = (
            self._fragmenter.run(reads, self.S_SLOTS, _bucket)
        )
        t1 = time.perf_counter()
        out = fused_mem_classify(
            self.dev.rec, self.dev.C, self._seed,
            self._put(flat[:chars]), self._put(frag_off[: n_frags + 1]),
            self._put(rf_rows), self.dev.sa_seq, self.dev.sa_off,
            self.dev.seq_tax, self._parent, self._depth, self.seed_K,
            cfg.min_fragment_length - 1, cfg.min_fragment_length, TIE_CAP,
            self.R_BUDGET, cfg.max_match_ids, self.dev.nseq,
            self.dev.chpt_exp,
        )
        HOST_SECONDS["fragment"] += t1 - t0
        HOST_SECONDS["submit"] += time.perf_counter() - t1
        return reads, oflow, out

    def collect_batch(self, state) -> list[tuple[str, ClassifyResult]]:
        reads, oflow, out = state
        t0 = time.perf_counter()
        rows = out.cpu().numpy()
        t1 = time.perf_counter()
        flagged = np.flatnonzero(
            (oflow != 0) | ((rows[:, 2] & (FLAG_TIE_OVER | FLAG_NEED_MORE)) != 0)
        ).tolist()
        HOST_REPLAY["reads"] += len(reads)
        HOST_REPLAY["flagged"] += len(flagged)
        redo = {}
        if flagged:
            if self._exact is None:
                self._exact = ExactClassifier(self.index, self.tax, self.cfg)
            sub = [reads[r] for r in flagged]
            for r, (_n, res) in zip(flagged, self._exact.classify_batch(sub)):
                redo[r] = res
        t2 = time.perf_counter()
        unclassified = ClassifyResult(False, 0)
        results = []
        for r, ((name, _s1, _s2), (lca, score, _f, n_ids)) in enumerate(
            zip(reads, rows.tolist())
        ):
            if r in redo:
                results.append((name, redo[r]))
            elif score == 0 or n_ids == 0:
                results.append((name, unclassified))
            else:
                results.append((name, ClassifyResult(lca > 0, lca, score=score)))
        HOST_SECONDS["wait"] += t1 - t0
        HOST_SECONDS["replay"] += t2 - t1
        HOST_SECONDS["results"] += time.perf_counter() - t2
        return results

    def classify_batch(self, reads) -> list[tuple[str, ClassifyResult]]:
        return self.collect_batch(self.submit_batch(reads))

    def classify_stream(self, batches):
        """Yield each batch's results in order, with up to LOOKAHEAD
        batches queued on the device ahead of the one being collected."""
        q: deque = deque()
        for batch in batches:
            q.append(self.submit_batch(batch))
            if len(q) > self.LOOKAHEAD:
                yield self.collect_batch(q.popleft())
        while q:
            yield self.collect_batch(q.popleft())
