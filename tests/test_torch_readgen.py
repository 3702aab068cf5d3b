"""The port's copy of the benchmark's DB generator with repeats
(kaiju_tpu_torch/tools/readgen.py:gen_realistic) gives the records of
bench.py:_gen_realistic for the same random.Random seed; the taxonomy of
NCBI's depth (readgen.DeepTaxonomy) that chip_smoke.py times kernels D
and F on."""

import random

import numpy as np
import pytest

import bench
from kaiju_tpu_torch.tools import readgen


@pytest.mark.parametrize("seed", [0, 7, 20240817])
def test_gen_realistic_matches_bench(seed):
    want = bench._gen_realistic(random.Random(seed), 60_000)
    got = readgen.gen_realistic(random.Random(seed), 60_000)
    assert got == want
    assert sum(len(s) for _, s in got) >= 60_000
    seqs = [s for _, s in got]
    assert len(set(seqs)) < len(seqs) or any(
        a[:100] == b[:100] for a, b in zip(seqs, seqs[1:]))  # repeats


def test_gen_realistic_families():
    """The family list numbers each record's gene family: the first record
    of a family, whose copies follow it; the records are bench.py's."""
    fam = []
    got = readgen.gen_realistic(random.Random(5), 60_000, fam)
    assert got == bench._gen_realistic(random.Random(5), 60_000)
    assert len(fam) == len(got) and fam[0] == 0
    for i, f in enumerate(fam):
        assert f <= i and (f == i or fam[i - 1] == f)
    assert 1 < len(set(fam)) < len(fam)


@pytest.mark.parametrize("seed", [1, 2])
def test_deep_taxonomy_is_ncbi_shaped(seed, tmp_path):
    """DeepTaxonomy at a small size: its nodes.dmp parses (Taxonomy) to its
    own dense arrays, species lie 20-40 levels deep (depth 21-40 below the
    root's 1), every clade has a child, taxids are sparse, a random
    descent ends at a species under its node, and ancestor lifts."""
    from kaiju_tpu_torch.io.taxonomy import Taxonomy

    t = readgen.DeepTaxonomy(seed, n_species=5000, max_taxid=40_000,
                             width=60)
    path = tmp_path / "nodes.dmp"
    t.write_nodes_dmp(str(path))
    tax = Taxonomy.from_nodes_dmp(str(path))
    par, dep = tax.dense_arrays()
    n = par.shape[0]
    assert (par == t.parent[:n]).all() and (dep == t.depth[:n]).all()
    assert not t.parent[n:].any() and not t.depth[n:].any()
    d = t.depth[t.species]
    assert d.min() >= 20 and d.max() == 40
    assert set(np.unique(t.parent[t.internal[1:]])) | set(
        t.parent[t.species]) >= set(t.internal.tolist())
    assert len(t.internal) + len(t.species) < 0.2 * t.parent.shape[0]
    rng = np.random.default_rng(seed)
    top = t.internal[rng.integers(0, len(t.internal), 200)]
    leaves = t.leaves_under(rng, top)
    assert set(leaves.tolist()) <= set(t.species.tolist())
    up = t.depth[leaves] - t.depth[top]
    assert (t.ancestor(leaves, up) == top).all()
    with open(path) as fh:
        ranks = {line.split("\t|\t")[2].split("\t")[0] for line in fh}
    assert ranks == {"no rank", "species"}
