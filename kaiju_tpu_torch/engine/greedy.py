"""Greedy classification pipeline on the device (``kaiju`` in its default
mode, ``-a greedy``, with a taxonomy and without ``-v``).

Per batch: the native fragmenter translates the reads, splits them at
stops, applies SEG and simulates the reference's fragment queue in Greedy
mode, writing the fragment codes, their offsets and each read's pop-order
slot table (``NativeFragmenter2``); the device runs B -> E -> F
(``ops.greedy.fused_greedy_classify``) and returns 16 bytes a read.  The
host applies the float64 E-value gate (ConsumerThread.cpp:500-513) and
replays through ``ExactClassifier`` the reads whose fragments overflow
their S slots, the reads with a fragment of QLCAP aa or more (the
planned-node rule clamps lengths there) and the reads the device flags, so
every output line equals the reference's.

This is ``kaiju_tpu.engine.greedy_device.GreedyDevicePipeline`` without the
JAX path's static-shape machinery (shape buckets, learned lane capacities
and their retry): the kernels take any shape.  On an index with a text
copy (what ``tools.mkdb`` writes) B screens its lanes with the Lmap-mer
Bloom bitmap and E finishes the last level's narrow variants by text
comparison, as the JAX pipeline does; on an index without, both are off.
Neither changes a result.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..constants import LAMBDA, LN_2, LN_K
from ..index.alphabet import trans_table
from ..index.core import KaijuIndex
from ..io.taxonomy import Taxonomy
from ..ops.greedy import (
    FLAG_NEED_MORE,
    FLAG_SCRATCH,
    FLAG_TIE_ORDER,
    FLAG_TIE_OVER,
    QLCAP,
    VCAP,
    fused_greedy_classify,
    greedy_scoring_tables,
)
from ..ops.search import SEED_K
from .config import KaijuConfig
from .core import ClassifyResult
from .pipeline import DevicePipeline, _bucket, tally

# the device flags that send a read to the host replay, by name
REPLAY_FLAGS = {"tie_over": FLAG_TIE_OVER, "need_more": FLAG_NEED_MORE,
                "scratch": FLAG_SCRATCH, "tie_order": FLAG_TIE_ORDER}

# reads classified and reads replayed on the host, over all pipelines; and
# the reads replayed for each reason (a read may have several): more
# fragments than slots or a fragment of QLCAP aa ("host"), and each flag
HOST_REPLAY = dict.fromkeys(("reads", "flagged", "host", *REPLAY_FLAGS), 0)
# host seconds of each stage of a batch, over all pipelines: fragmenting,
# upload and kernel enqueue, waiting for the result rows, host replay and
# building the result objects (with the E-value gate)
HOST_SECONDS = dict.fromkeys(
    ("fragment", "submit", "wait", "replay", "results"), 0.0)


def reset_counts() -> None:
    for k in HOST_REPLAY:
        HOST_REPLAY[k] = 0
    for k in HOST_SECONDS:
        HOST_SECONDS[k] = 0.0


class GreedyPipeline(DevicePipeline):
    VCAP = VCAP  # sources a read and level in kernel E's scratch

    def __init__(
        self,
        index: KaijuIndex,
        taxonomy: Taxonomy,
        config: KaijuConfig,
        device=None,
        kmer_cache_dir: Optional[str] = None,
    ):
        if (config.mode != "greedy" or config.verbose or taxonomy is None
                or config.taxonomy_free):
            raise ValueError(
                "GreedyPipeline runs -a greedy with a taxonomy, no -v")
        # the lowest end position evaluated is Lmap - 1, and the K-mer seed
        # may not reach below it
        self.lmap = min(config.seed_length, config.min_fragment_length)
        super().__init__(index, taxonomy, config, device, kmer_cache_dir,
                         min(SEED_K, config.seed_length, self.lmap), self.lmap)
        self._tables = tuple(self._put(a) for a in greedy_scoring_tables(
            index.alphabet, trans_table(index.alphabet)))

    def submit_batch(self, reads):
        """Fragment a batch on the host and queue its device work; the
        result is taken by collect_batch.  Submitting the next batch before
        collecting this one overlaps host work with the device's."""
        cfg = self.cfg
        t0 = time.perf_counter()
        flat, chars, frag_off, n_frags, _keys, rf_rows, oflow = (
            self._fragmenter.run(reads, self.S_SLOTS, _bucket)
        )
        # reads with a fragment of QLCAP aa or more replay on the host (the
        # planned-node rule clamps lengths there)
        off = frag_off[: n_frags + 1]
        long_row = np.append(np.diff(off) >= QLCAP, False)
        replay = (oflow != 0) | long_row[np.where(rf_rows >= 0, rf_rows,
                                                  n_frags)].any(1)
        t1 = time.perf_counter()
        out = self._device_rows(self._put(flat[:chars]), self._put(off),
                                self._put(rf_rows))
        tally(HOST_SECONDS, self.host_seconds, fragment=t1 - t0,
              submit=time.perf_counter() - t1)
        return reads, replay, out

    def _device_rows(self, flat, frag_off, rf_rows):
        """The device's rows (lca, best, flags, n_ids) of a batch's
        fragments (``ops.greedy.fused_greedy_classify``)."""
        cfg = self.cfg
        return fused_greedy_classify(
            self.dev.rec, self.dev.C, self._seed, flat, frag_off, rf_rows,
            self.dev.sa_seq, self.dev.sa_off, self.dev.seq_tax, self._parent,
            self._depth, self._tables, self.seed_K, self.lmap,
            cfg.min_fragment_length, cfg.min_score, cfg.mismatches,
            cfg.max_matches_SI, self.R_BUDGET, cfg.max_match_ids,
            self.dev.nseq, self.dev.chpt_exp, self.VCAP, bloom=self._bloom,
            hyb=self._hyb)

    def collect_batch(self, state) -> list[tuple[str, ClassifyResult]]:
        cfg = self.cfg
        reads, replay, out = state
        t0 = time.perf_counter()
        rows = out.cpu().numpy()
        t1 = time.perf_counter()
        flags = rows[:, 2]
        flagged = np.flatnonzero(
            replay | ((flags & sum(REPLAY_FLAGS.values())) != 0)).tolist()
        tally(HOST_REPLAY, reads=len(reads), flagged=len(flagged),
              host=int(replay.sum()),
              **{why: int(np.count_nonzero(flags & bit))
                 for why, bit in REPLAY_FLAGS.items()})
        redo = self._replay(reads, flagged)
        t2 = time.perf_counter()
        # the float64 E-value gate, vectorized: np.power on float64 is the
        # same libm pow as the reference's math.pow
        B = len(reads)
        if cfg.use_Evalue:
            if cfg.input_is_protein:
                qlen = np.fromiter((float(len(s1)) for _n, s1, _s2 in reads),
                                   dtype=np.float64, count=B)
            else:
                qlen = np.fromiter(
                    (len(s1) / 3.0 + (len(s2) / 3.0 if s2 else 0.0)
                     for _n, s1, s2 in reads), dtype=np.float64, count=B)
            bitscore = (LAMBDA * rows[:, 1].astype(np.float64) - LN_K) / LN_2
            evalue = (float(self.index.db_length) * qlen
                      * np.power(2.0, -bitscore))
            e_kill = (evalue > cfg.min_Evalue).tolist()
        else:
            e_kill = [False] * B
        unclassified = ClassifyResult(False, 0)
        results = []
        for r, ((name, _s1, _s2), (lca, best, _f, n_ids), kill) in enumerate(
            zip(reads, rows.tolist(), e_kill)
        ):
            if r in redo:
                results.append((name, redo[r]))
            elif best <= 0 or n_ids == 0 or kill:
                results.append((name, unclassified))
            else:
                results.append((name, ClassifyResult(lca > 0, lca, score=best)))
        tally(HOST_SECONDS, self.host_seconds, wait=t1 - t0,
              replay=t2 - t1, results=time.perf_counter() - t2)
        return results
