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
each batch; ``CardShare`` runs one on each card of a process, each on its
share of each batch (of the process's share, under a ``ProcessShare``)."""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
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


_TALLY = threading.Lock()


def tally(totals: dict, mine: Optional[dict] = None, **add) -> None:
    """Add each of `add` to `totals` (a module's ``HOST_SECONDS`` or
    ``HOST_REPLAY``, shared by the pipelines of every card of the process)
    under one lock, and to `mine` (a pipeline's own) if given."""
    with _TALLY:
        for k, v in add.items():
            totals[k] += v
            if mine is not None:
                mine[k] = mine.get(k, 0) + v


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
        self._seed = tuple(self._put(a) for a in self._seed_tables(
            index, kmer_cache_dir, seed_K))
        screen = BloomScreen.load_or_build(
            index, kmer_cache_dir or index.source_dir, bloom_m, self.device)
        self._bloom = None if screen is None else screen.args

    def _device_index(self, index: KaijuIndex):
        """The index on self.device that every kernel of the path reads
        (``parallel.sharded_fused`` gives it in shards)."""
        return DeviceIndex(index, self.device)

    def _seed_tables(self, index: KaijuIndex, kmer_cache_dir, seed_K: int):
        """Kernel B's seed inputs on the host (``KmerTables.planar_seed``),
        the tables read from the cache or built by kernel A on self.dev
        and saved there."""
        kmer = KmerTables.load_or_build(index, kmer_cache_dir, seed_K,
                                        device_index=self.dev)
        return kmer.planar_seed(seed_K)

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
        self.host_seconds: dict = {}  # this pipeline's, by stage (tally)

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


def in_rounds(pipe) -> bool:
    """Whether `pipe` (a device pipeline) runs rounds of a group on
    several hosts: its index has an ``exchange``."""
    return getattr(getattr(pipe, "dev", None), "exchange", None) is not None


class ProcessShare:
    """Process pid of nprocs running `pipe` (a device pipeline, or a
    ``CardShare`` of one a card) on its share of each batch,
    ``multihost.local_rows``: only those reads are fragmented, uploaded
    and classified, and the results hold None for every read a peer owns
    (kaiju_tpu's collect_batch, parallel/sharded_fused.py:636-638).  A
    process whose share of a batch is empty launches nothing for it,
    except over a group on several hosts (the pipeline's index has an
    ``exchange``, ``in_rounds``): there every process runs every batch, an
    empty share included, since each of its rounds is a collective of the
    whole group.  The rounds run in submit_batch, and
    every process submits the batches in stream order (collect_batch holds
    no collective), so the lookahead cannot reorder them: every process
    runs the same collectives in the same order.  The stream ends at a
    barrier of all the processes; ``close`` closes a ``CardShare``."""

    LOOKAHEAD = DevicePipeline.LOOKAHEAD

    def __init__(self, pipe, nprocs: int, pid: int):
        self.pipe = pipe
        self.nprocs = nprocs
        self.pid = pid
        self.lockstep = (pipe.lockstep if isinstance(pipe, CardShare)
                         else in_rounds(pipe))

    def submit_batch(self, reads):
        from ..parallel.multihost import local_rows

        lo, hi = local_rows(len(reads), self.nprocs, self.pid)
        sub = (self.pipe.submit_batch(reads[lo:hi])
               if hi > lo or self.lockstep else None)
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

    def close(self) -> None:
        if isinstance(self.pipe, CardShare):
            self.pipe.close()


def _card_thread(card: torch.device, launches: dict) -> None:
    """The start of a card's worker thread: the card made current, its
    launches counted into `launches`."""
    from .. import kernels

    if card.type == "cuda":
        torch.cuda.set_device(card)
    kernels.count_into(launches)


class CardShare:
    """The pipelines of one process, one a card of `cards`
    (``multihost.local_cards``; a card may repeat), each on its share of
    every batch, card c of D the reads ``multihost.local_rows(n, D, c)``:
    kaiju_tpu's data axis over the devices of a process
    (kaiju_tpu/parallel/sharded_fused.py:506-545), one data row a card.

    make(c) builds card c's pipeline; they are built one after another,
    in order, so that what the first one writes to the cache directory
    (seed tables, bitmaps) is there before the next one reads it.  Each
    card's
    submit_batch and collect_batch then run in one worker thread of its
    own, with that card made current there (the kernels release the GIL
    while they launch), and the results come back in read order with
    LOOKAHEAD batches queued ahead, as ``DevicePipeline.classify_stream``
    queues them.  A card whose share of a batch is empty does nothing for
    it, except in ``lockstep`` (the pipelines run rounds of a group on
    several hosts, ``in_rounds``): there every card submits every batch,
    an empty share included, since card c's rounds are collectives of card
    c of every process; every card's batches go to its thread in stream
    order, so each card's rounds keep one order in every process.  A
    failure in a card's thread is raised where its batch is collected.
    ``launches`` holds each card's kernel launches (its set-up's and
    its batches'; ``kernels.count_into``), ``setup_seconds`` each card's
    set-up, ``pipes[c].host_seconds`` its host seconds by stage.  The
    threads start with the first batch; ``close`` stops them (a later
    batch starts them again)."""

    LOOKAHEAD = DevicePipeline.LOOKAHEAD

    def __init__(self, make, cards: list):
        from .. import kernels

        self.cards = [torch.device(c) for c in cards]
        self.launches = [{} for _ in self.cards]
        self.setup_seconds = []
        self.pipes = []
        for c in range(len(self.cards)):
            kernels.count_into(self.launches[c])
            t0 = time.perf_counter()
            try:
                self.pipes.append(make(c))
            finally:
                kernels.count_into(None)
            self.setup_seconds.append(time.perf_counter() - t0)
        self.lockstep = in_rounds(self.pipes[0])
        self._workers = None

    def _worker(self, c: int) -> ThreadPoolExecutor:
        if self._workers is None:
            self._workers = [ThreadPoolExecutor(
                1, thread_name_prefix=f"card{k}", initializer=_card_thread,
                initargs=(card, self.launches[k]))
                for k, card in enumerate(self.cards)]
        return self._workers[c]

    def submit_batch(self, reads):
        from ..parallel.multihost import local_rows

        D = len(self.cards)
        jobs = []
        for c, pipe in enumerate(self.pipes):
            lo, hi = local_rows(len(reads), D, c)
            if hi > lo or self.lockstep:
                jobs.append((c, self._worker(c).submit(pipe.submit_batch,
                                                       reads[lo:hi])))
        return jobs

    def collect_batch(self, jobs) -> list:
        done = [self._worker(c).submit(
            lambda pipe=self.pipes[c], sub=sub: pipe.collect_batch(
                sub.result())) for c, sub in jobs]
        out = []
        for f in done:
            out.extend(f.result())
        return out

    classify_batch = DeviceSetup.classify_batch
    classify_stream = DevicePipeline.classify_stream

    def close(self) -> None:
        for w in self._workers or ():
            w.shutdown(cancel_futures=True)
        self._workers = None
