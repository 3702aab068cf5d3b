"""The port's copy of the benchmark's DB generator with repeats
(kaiju_tpu_torch/tools/readgen.py:gen_realistic) gives the records of
bench.py:_gen_realistic for the same random.Random seed."""

import random

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
