"""Index shards held apart by processes (kaiju_tpu_torch.parallel.
peer_shards), without processes: the ownership rule for N processes and S
shards, ``Shards`` over read-only memory maps of shard files (as a
process maps its peers' shards on the CPU) against the whole tensor and
through the plain SA walk and extension, the plain versions' refusal of a
shard on another device, and the routing rule over several hosts (mapped
on the host, else served in rounds).  The processes themselves run in tests/test_torch_multihost.py."""

import random

import numpy as np
import pytest
import torch

from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.parallel import peer_shards
from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex, _split

from conftest import make_db_records


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("N", [1, 2, 3, 4])
def test_every_shard_has_a_holder_that_serves_it(N, S):
    held = [peer_shards.held(p, N, S) for p in range(N)]
    # kaiju_tpu's mesh of one card a process, index axis innermost (N >= S),
    # or S / N shards a process (N < S)
    for p in range(N):
        want = ([p % S] if N >= S else [o for o in range(S) if o % N == p])
        assert held[p] == want
        if N < S:
            assert len(held[p]) in (S // N, -(-S // N))
    assert set().union(*map(set, held)) == set(range(S))
    for p in range(N):
        for o in range(S):
            src = peer_shards.source(o, N)
            assert src == o % N and o in held[src], (p, o)
    if N >= S:  # processes p >= S hold replicas
        assert all(held[p] == held[p % S] for p in range(N))


@pytest.fixture(scope="module")
def index():
    return py_builder.build_index(make_db_records(random.Random(88),
                                                  nseq=30))


def _mapped(tmp_path, name, parts):
    """Each part written to a file and mapped read-only, as a reader maps
    a peer's shard on the CPU."""
    out = []
    for o, a in enumerate(parts):
        path = tmp_path / f"{name}_{o}"
        np.ascontiguousarray(a).tofile(path)
        out.append(peer_shards.map_file(str(path), a.shape, a.dtype))
    return out


@pytest.mark.parametrize("S", [2, 3])
def test_shards_of_memory_maps_read_as_the_whole_index(tmp_path, index, S):
    whole = tdev.DeviceIndex(index, "cpu")
    sh = ShardedIndex(index, S, "cpu")
    # shard 0 held, the others mapped from files, as process 0 of S has them
    for name, per, length in (("rec", sh.nb_s, whole.rec.shape[0]),
                              ("sa_seq", sh.ns_s, whole.sa_seq.shape[0]),
                              ("sa_off", sh.ns_s, whole.sa_off.shape[0])):
        full = getattr(whole, name).numpy()
        extra = 1 if name == "rec" else 0
        parts = _split(full, S, per, extra, full[-1] if extra else 0)
        shards = tdev.Shards([torch.from_numpy(parts[0].copy())]
                             + _mapped(tmp_path, name, parts[1:]),
                             per, length, "cpu", peer=range(1, S))
        idx = torch.arange(length)
        assert torch.equal(shards[idx], getattr(whole, name)[idx])
        setattr(sh, name, shards)
    k = torch.arange(0, index.length, 3, dtype=torch.int32)
    got = tdev.sa_lookup_plain(sh.rec, sh.C, sh.sa_seq, sh.sa_off, sh.nseq,
                               sh.chpt_exp, k)
    want = tdev.sa_lookup_plain(whole.rec, whole.C, whole.sa_seq,
                                whole.sa_off, whole.nseq, whole.chpt_exp, k)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    rng = np.random.default_rng(S)
    codes = torch.from_numpy(rng.integers(1, 21, (40, 12), dtype=np.uint8))
    flen = torch.from_numpy(rng.integers(1, 13, 40).astype(np.int32))
    got = tdev.extend_all_plain(sh.rec, sh.C, codes, flen)
    want = tdev.extend_all_plain(whole.rec, whole.C, codes, flen)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_plain_versions_refuse_a_shard_on_another_device():
    shards = tdev.Shards([torch.zeros(4, dtype=torch.int32),
                          torch.zeros(4, dtype=torch.int32, device="meta")],
                         4, 8, "cpu", peer=[1])
    with pytest.raises(ValueError, match="shard 1 lies on meta"):
        shards[torch.arange(8)]


@pytest.mark.parametrize("hosts, S", [
    ("ab", 2), ("aab", 4), ("aabb", 4), ("abab", 2), ("abc", 2), ("aab", 2),
    ("aaa", 3)])
def test_routes_map_on_the_host_and_serve_the_rest(hosts, S):
    """For every shard a process does not hold: mapped from its source o
    mod N when that is on the process's host, else from the lowest holder
    on its host, else served in rounds by its source, which holds it; one
    host maps everything from the sources, as before."""
    N = len(hosts)
    for p in range(N):
        opened, remote = peer_shards.routes(p, list(hosts), S)
        mine = peer_shards.held(p, N, S)
        assert set(opened) | set(remote) | set(mine) == set(range(S))
        assert not set(opened) & set(remote) and not set(mine) & set(opened)
        for o, q in opened.items():
            assert hosts[q] == hosts[p] and o in peer_shards.held(q, N, S)
            if hosts[o % N] == hosts[p]:
                assert q == o % N
            else:
                assert q == min(r for r in range(N) if hosts[r] == hosts[p]
                                and o in peer_shards.held(r, N, S))
        for o, q in remote.items():
            assert q == o % N and o in peer_shards.held(q, N, S)
            assert all(o not in peer_shards.held(r, N, S) for r in range(N)
                       if hosts[r] == hosts[p])
        if len(set(hosts)) == 1:
            assert not remote
    if hosts == "aab" and S == 4:  # the processes of the CPU tests
        assert peer_shards.routes(0, list(hosts), 4) == ({1: 1}, {2: 2})
        assert peer_shards.routes(2, list(hosts), 4) == ({}, {0: 0, 1: 1,
                                                              3: 0})
