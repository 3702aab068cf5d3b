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

On an index with a text copy (what ``tools.mkdb`` writes), B screens its
lanes with the m-mer Bloom bitmap (m = -m) and kernel G finishes the
narrow ones by text comparison (B -> G -> C -> D), as ``kaiju_tpu`` does;
neither changes a result.

This is the device-tail path of ``kaiju_tpu.engine.mem_fast``.  The JAX
path's static-shape machinery (shape buckets, learned lane capacities and
their retry) has no counterpart: the kernels take any shape and have no
lane capacities.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..index.core import KaijuIndex
from ..io.taxonomy import Taxonomy
from ..ops.classify import FLAG_NEED_MORE, FLAG_TIE_OVER, fused_mem_classify
from ..ops.search import SEED_K, TIE_CAP
from .config import KaijuConfig
from .core import ClassifyResult
from .pipeline import DevicePipeline, _bucket, tally

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


class MemPipeline(DevicePipeline):
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
        super().__init__(index, taxonomy, config, device, kmer_cache_dir,
                         min(SEED_K, config.min_fragment_length),
                         config.min_fragment_length)

    def submit_batch(self, reads):
        """Fragment a batch on the host and queue its device work; the
        result is taken by collect_batch.  Submitting the next batch before
        collecting this one overlaps host work with the device's."""
        t0 = time.perf_counter()
        flat, chars, frag_off, n_frags, _keys, rf_rows, oflow = (
            self._fragmenter.run(reads, self.S_SLOTS, _bucket)
        )
        t1 = time.perf_counter()
        out = self._device_rows(self._put(flat[:chars]),
                                self._put(frag_off[: n_frags + 1]),
                                self._put(rf_rows))
        tally(HOST_SECONDS, self.host_seconds, fragment=t1 - t0,
              submit=time.perf_counter() - t1)
        return reads, oflow, out

    def _device_rows(self, flat, frag_off, rf_rows):
        """The device's rows (lca, score, flags, n_ids) of a batch's
        fragments (``ops.classify.fused_mem_classify``)."""
        cfg = self.cfg
        return fused_mem_classify(
            self.dev.rec, self.dev.C, self._seed, flat, frag_off, rf_rows,
            self.dev.sa_seq, self.dev.sa_off, self.dev.seq_tax, self._parent,
            self._depth, self.seed_K, cfg.min_fragment_length - 1,
            cfg.min_fragment_length, TIE_CAP, self.R_BUDGET,
            cfg.max_match_ids, self.dev.nseq, self.dev.chpt_exp,
            bloom=self._bloom, hyb=self._hyb)

    def collect_batch(self, state) -> list[tuple[str, ClassifyResult]]:
        reads, oflow, out = state
        t0 = time.perf_counter()
        rows = out.cpu().numpy()
        t1 = time.perf_counter()
        flagged = np.flatnonzero(
            (oflow != 0) | ((rows[:, 2] & (FLAG_TIE_OVER | FLAG_NEED_MORE)) != 0)
        ).tolist()
        tally(HOST_REPLAY, reads=len(reads), flagged=len(flagged))
        redo = self._replay(reads, flagged)
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
        tally(HOST_SECONDS, self.host_seconds, wait=t1 - t0,
              replay=t2 - t1, results=time.perf_counter() - t2)
        return results
