"""The index-sharded MEM path, ``kaiju -a mem --mesh-index S`` (K16e).

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

kaiju_tpu's capacity budgets (``CapStore``) and their retry, its v1
fragmenter with the S = 16 slot fallback and its ``MemFastPipeline``
fallback have no counterpart: the kernels take exact sizes.  All shards
live on the one device the pipeline runs on; spreading them over cards and
processes is ROADMAP item 10d.
"""

from __future__ import annotations

from typing import Optional

from ..engine.config import KaijuConfig
from ..engine.mem import MemPipeline
from ..index.core import KaijuIndex
from ..io.taxonomy import Taxonomy
from .sharded_index import ShardedIndex


class ShardedMemPipeline(MemPipeline):
    def __init__(
        self,
        index: KaijuIndex,
        taxonomy: Taxonomy,
        config: KaijuConfig,
        n_index: int,
        device=None,
        kmer_cache_dir: Optional[str] = None,
    ):
        if n_index < 1:
            raise ValueError(f"--mesh-index must be >= 1, got {n_index}")
        self.n_index = n_index
        super().__init__(index, taxonomy, config, device, kmer_cache_dir)

    def _device_index(self, index: KaijuIndex) -> ShardedIndex:
        return ShardedIndex(index, self.n_index, self.device)
