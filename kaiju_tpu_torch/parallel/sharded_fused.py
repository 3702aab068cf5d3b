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
process all shards live on the device the pipeline runs on.  Several
processes each run a pipeline on their share of every batch
(``parallel.multihost``, ``engine.pipeline.ProcessShare``); given their
group, each holds only its shards and maps the others from their holders
(``parallel.peer_shards``).
"""

from __future__ import annotations

from typing import Optional

from ..engine.config import KaijuConfig
from ..engine.greedy import GreedyPipeline
from ..engine.mem import MemPipeline
from ..index.core import KaijuIndex
from ..io.taxonomy import Taxonomy
from .sharded_index import ShardedIndex


class _OnShards:
    """A device pipeline whose index is a ``ShardedIndex`` of n_index
    shards on its device; with a group of several processes, the shards
    held apart by them (``ShardedIndex``'s group)."""

    def __init__(
        self,
        index: KaijuIndex,
        taxonomy: Taxonomy,
        config: KaijuConfig,
        n_index: int,
        device=None,
        kmer_cache_dir: Optional[str] = None,
        group=None,
    ):
        if n_index < 1:
            raise ValueError(f"--mesh-index must be >= 1, got {n_index}")
        self.n_index = n_index
        self.group = group
        super().__init__(index, taxonomy, config, device, kmer_cache_dir)

    def _device_index(self, index: KaijuIndex) -> ShardedIndex:
        return ShardedIndex(index, self.n_index, self.device, self.group)


class ShardedMemPipeline(_OnShards, MemPipeline):
    pass


class ShardedGreedyPipeline(_OnShards, GreedyPipeline):
    pass
