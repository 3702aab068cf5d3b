"""What the pipelines on the card share.  ``DeviceSetup``: the device
index, the seed tables and kernel B's Bloom screen, and uploads; the
host-tail pipelines of -v (``engine.mem_fast``, ``engine.greedy_fast``)
build on it alone.  ``DevicePipeline`` adds what the device pipelines
(``engine.mem.MemPipeline`` and ``engine.greedy.GreedyPipeline``) share:
the taxonomy on the card, the text-compare hybrid of an index with a text
copy, the native fragmenter, the host replay of flagged reads, and the
stream with its lookahead.  Each pipeline keeps its own counters
(``HOST_REPLAY``, ``HOST_SECONDS`` in its module) and defines
``submit_batch`` and ``collect_batch``.  ``ProcessShare`` runs any of
them as one process of several (``parallel.multihost``) on its share of
each batch."""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from ..index.core import KaijuIndex
from ..io.taxonomy import Taxonomy
from ..ops.bloom import BloomScreen
from ..ops.device_index import DeviceIndex, resolve_device
from ..ops.hybrid import VBASE
from ..ops.kmer import KmerTables
from .config import KaijuConfig
from .core import ExactClassifier
from .fragments_native import NativeFragmenter2


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class DeviceSetup:
    def __init__(self, index: KaijuIndex, taxonomy: Optional[Taxonomy],
                 config: KaijuConfig, device, kmer_cache_dir: Optional[str],
                 seed_K: int, bloom_m: int):
        """bloom_m: the window of kernel B's screen, the shortest match the
        path records.  As in kaiju_tpu, the screen is loaded from
        kmer_cache_dir or the index's directory, or built from the first
        text source there is (None without one); it changes no result."""
        self.cfg = config
        self.index = index
        self.tax = taxonomy
        self.device = resolve_device(device)
        self.dev = self._device_index(index)
        self.seed_K = seed_K
        kmer = KmerTables.load_or_build(index, kmer_cache_dir, seed_K,
                                        device_index=self.dev)
        self._seed = tuple(self._put(a) for a in kmer.planar_seed(seed_K))
        screen = BloomScreen.load_or_build(
            index, kmer_cache_dir or index.source_dir, bloom_m, self.device)
        self._bloom = None if screen is None else screen.args

    def _device_index(self, index: KaijuIndex):
        """The index on self.device that every kernel of the path reads
        (``parallel.sharded_fused`` gives it in shards)."""
        return DeviceIndex(index, self.device)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def classify_batch(self, reads):
        return self.collect_batch(self.submit_batch(reads))


class DevicePipeline(DeviceSetup):
    S_SLOTS = 16  # pop-order slots per read in the device slot table
    R_BUDGET = 32  # SA positions resolved on the device per read
    LOOKAHEAD = 2  # batches submitted ahead of the one being collected

    def __init__(self, index: KaijuIndex, taxonomy: Taxonomy,
                 config: KaijuConfig, device, kmer_cache_dir: Optional[str],
                 seed_K: int, bloom_m: int):
        """The hybrid is on exactly when the index has a text copy and
        fewer than VBASE positions; it changes no result."""
        super().__init__(index, taxonomy, config, device, kmer_cache_dir,
                         seed_K, bloom_m)
        self._hyb = ((self.dev.text, self.dev.rank_start)
                     if self.dev.has_text and index.length < VBASE else None)
        par, dep = taxonomy.dense_arrays()
        self._parent = self._put(par)
        self._depth = self._put(dep)
        self._fragmenter = NativeFragmenter2(
            config.mode, config.min_fragment_length, config.min_score,
            config.seg, config.input_is_protein,
        )
        self._exact = None  # host replay engine, made at first use

    def _replay(self, reads, flagged: list[int]) -> dict:
        """ExactClassifier's result for each read index in `flagged`."""
        if not flagged:
            return {}
        if self._exact is None:
            self._exact = ExactClassifier(self.index, self.tax, self.cfg)
        sub = [reads[r] for r in flagged]
        return {r: res for r, (_n, res)
                in zip(flagged, self._exact.classify_batch(sub))}

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


class ProcessShare:
    """Process pid of nprocs running `pipe` (a device pipeline) on its
    share of each batch, ``multihost.local_rows``: only those reads are
    fragmented, uploaded and classified, and the results hold None for
    every read a peer owns (kaiju_tpu's collect_batch,
    parallel/sharded_fused.py:636-638).  A process whose share of a batch
    is empty launches nothing for it.  The stream ends at a barrier of all
    the processes."""

    LOOKAHEAD = DevicePipeline.LOOKAHEAD

    def __init__(self, pipe, nprocs: int, pid: int):
        self.pipe = pipe
        self.nprocs = nprocs
        self.pid = pid

    def submit_batch(self, reads):
        from ..parallel.multihost import local_rows

        lo, hi = local_rows(len(reads), self.nprocs, self.pid)
        sub = self.pipe.submit_batch(reads[lo:hi]) if hi > lo else None
        return len(reads), lo, sub

    def collect_batch(self, state) -> list:
        n, lo, sub = state
        out = [None] * n
        if sub is not None:
            mine = self.pipe.collect_batch(sub)
            out[lo:lo + len(mine)] = mine
        return out

    classify_batch = DeviceSetup.classify_batch

    def classify_stream(self, batches):
        from ..parallel.multihost import barrier

        yield from DevicePipeline.classify_stream(self, batches)
        barrier()
