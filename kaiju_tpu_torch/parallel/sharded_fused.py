"""The index-sharded paths, ``kaiju --mesh-index S`` with ``-a mem`` (K16e)
and in Greedy, the default mode (K16f).

``ShardedMemPipeline`` is the counterpart of kaiju_tpu's
``ShardedMemClassifier`` (kaiju_tpu/parallel/sharded_fused.py:681-967) and
of the program under it, ``make_sharded_mem_classify`` (:178-275): the
port's ``engine.mem.MemPipeline`` over a ``ShardedIndex``, with the same
host side (``NativeFragmenter2``, the replicated seed tables and Bloom
bitmap, the ``ExactClassifier`` replay of flagged reads).  Every kernel of
the path that reads the index runs its sharded instantiation: A builds the
seed tables, B extends, G finishes the narrow lanes on a text index, D
walks the SA; C reads no index.  Its rows and its TSV equal the unsharded
pipeline's.

``ShardedGreedyPipeline`` is the counterpart of ``ShardedGreedyClassifier``
(:393-679) and ``make_sharded_greedy_classify`` (:278-390): the port's
``engine.greedy.GreedyPipeline`` over a ``ShardedIndex``.  A builds the
seed tables, B extends with the Lmap-mer screen, E runs the variant levels
(the last one with the text-compare hybrid on an index with a text copy,
exactly when kaiju_tpu turns it on: a text copy and fewer than 2^30
positions) and F walks the ties, each in its sharded instantiation.  The
host side is GreedyPipeline's: the S = 16 slot fragmenter, R = 32, the
float64 E-value gate and the ``ExactClassifier`` replay of the reads the
kernels flag.  kaiju_tpu replays through ``GreedyFastPipeline`` (:622-630),
which carries the Greedy tie-order fault of ROADMAP.md queue 3; the port
does not.

kaiju_tpu's capacity budgets (``CapStore``) and their retry, its v1
fragmenter with the S = 16 slot fallback and its ``MemFastPipeline``
fallback have no counterpart: the kernels take exact sizes.  In one
process on one card all shards live on that card.  Over the D cards of
one process, D pipelines share one placement of the shards
(``ShardedIndex.on_cards``): each runs on its card, reads its card's view
(the shards it holds, the others in place on their holders' cards) and
classifies its share of every batch (``engine.pipeline.CardShare``).
Several processes each run pipelines on their share of every batch
(``parallel.multihost``, ``engine.pipeline.ProcessShare``), one a card
of the process (``CardShare``) on a view of ``ShardedIndex.in_group``:
each card holds only its shards, reads those of its process's other
cards in place and maps the others from the processes of its host that
hold them (``parallel.peer_shards``).  Over a group whose processes lie
on several hosts, ``ShardedMemPipeline`` runs A → O → C → W → Q → W
(``ops.classify.fused_mem_classify_hosts``) and ``ShardedGreedyPipeline``
A → O → U → (X → U) a level → V → Q → V
(``ops.greedy.fused_greedy_classify_hosts``), each step whose row lies on
another host answered by its owner in rounds (``parallel.exchange``).
Both run the text-compare hybrid there exactly when kaiju_tpu turns it on
(a text copy and fewer than 2^30 positions, sharded_fused.py:205 and
:312): O stops MEM's narrow lanes and X the last Greedy level's narrow
variants, and kernel Y (``ops.hybrid.switch_hosts``) finishes them, its
walks, SA samples and text rows on another host answered by their owners
in the rounds of stages "switch" and "text", as kaiju_tpu's
``_make_walk(..., want_pos=True)`` and ``_make_hyb.text_row`` (:78-175)
assemble them from their owner shards.
"""

from __future__ import annotations

from typing import Optional

from ..engine.config import KaijuConfig
from ..engine.greedy import GreedyPipeline
from ..engine.mem import MemPipeline
from ..index.core import KaijuIndex
from ..io.taxonomy import Taxonomy
from ..ops.classify import fused_mem_classify_hosts
from ..ops.greedy import fused_greedy_classify_hosts
from ..ops.search import TIE_CAP
from .sharded_index import ShardedIndex


class _OnShards:
    """A device pipeline whose index is a ``ShardedIndex`` of n_index
    shards on its device; given `view`, one card's view of a placement
    over the cards of this process (``ShardedIndex.on_cards``) or over
    the slots of a group (``ShardedIndex.in_group``), on whose card the
    pipeline runs."""

    def __init__(
        self,
        index: KaijuIndex,
        taxonomy: Taxonomy,
        config: KaijuConfig,
        n_index: int,
        device=None,
        kmer_cache_dir: Optional[str] = None,
        view: Optional[ShardedIndex] = None,
    ):
        if n_index < 1:
            raise ValueError(f"--mesh-index must be >= 1, got {n_index}")
        if view is not None and view.S != n_index:
            raise ValueError(f"a card's view of {view.S} shards, expected "
                             f"{n_index}")
        self.n_index = n_index
        self.view = view
        super().__init__(index, taxonomy, config,
                         device if view is None else view.device,
                         kmer_cache_dir)

    def _device_index(self, index: KaijuIndex) -> ShardedIndex:
        if self.view is not None:
            return self.view
        return ShardedIndex(index, self.n_index, self.device)

    def _seed_tables(self, index: KaijuIndex, kmer_cache_dir, seed_K: int):
        """As DeviceSetup's; the cards of one placement compute the host
        arrays once (the first card's pipeline) and each uploads them."""
        if self.view is None:
            return super()._seed_tables(index, kmer_cache_dir, seed_K)
        key = ("seed", seed_K, kmer_cache_dir)
        if key not in self.view.shared:
            self.view.shared[key] = super()._seed_tables(
                index, kmer_cache_dir, seed_K)
        return self.view.shared[key]


class ShardedMemPipeline(_OnShards, MemPipeline):
    """Over a group of processes on several hosts the batch runs
    ``fused_mem_classify_hosts``."""

    def _device_rows(self, flat, frag_off, rf_rows):
        if self.dev.exchange is None:
            return super()._device_rows(flat, frag_off, rf_rows)
        cfg = self.cfg
        return fused_mem_classify_hosts(
            self.dev, self.dev.exchange, self._seed, flat, frag_off, rf_rows,
            self.dev.seq_tax, self._parent, self._depth, self.seed_K,
            cfg.min_fragment_length - 1, cfg.min_fragment_length, TIE_CAP,
            self.R_BUDGET, cfg.max_match_ids, bloom=self._bloom,
            hyb=self._hyb)


class ShardedGreedyPipeline(_OnShards, GreedyPipeline):
    """Over a group of processes on several hosts the batch runs
    ``fused_greedy_classify_hosts``."""

    def _device_rows(self, flat, frag_off, rf_rows):
        if self.dev.exchange is None:
            return super()._device_rows(flat, frag_off, rf_rows)
        cfg = self.cfg
        return fused_greedy_classify_hosts(
            self.dev, self.dev.exchange, self._seed, flat, frag_off, rf_rows,
            self.dev.seq_tax, self._parent, self._depth, self._tables,
            self.seed_K, self.lmap, cfg.min_fragment_length, cfg.min_score,
            cfg.mismatches, cfg.max_matches_SI, self.R_BUDGET,
            cfg.max_match_ids, self.VCAP, bloom=self._bloom, hyb=self._hyb)
