"""One of two processes of the two-card exchange cases of
tests/test_torch_kernels.py: process p of 2 on cuda:p, labelled host
"ab"[p] (peer_shards.host_name), joins a group at the coordinator and
takes a hosts view of a small index in S = 4 shards
(ShardedIndex.in_group), whose other host's shards are remote.  Every
slot has a card of its own, so its exchange runs over NCCL; then a
second view whose exchange.backend_for is replaced by gloo's (the staged
form) runs the same inputs.  On each: one round of N's four query kinds
to every shard (Exchange.serve), against N's plain version on the whole
index, and Q's walks in rounds (walk_hosts, Exchange.rounds), against
the plain SA walk on the whole index.  Writes to its JSON file each
form's backend, remote shards, equalities and rounds, and whether the
two forms' answers are equal.

    python tests/torch_exchange_worker.py HOST:PORT PID OUT.json
"""

import json
import random
import sys

import numpy as np
import torch

from kaiju_tpu_torch.index import py_builder
from kaiju_tpu_torch.ops import device_index as tdev
from kaiju_tpu_torch.parallel import exchange, multihost, peer_shards
from kaiju_tpu_torch.parallel.sharded_index import ShardedIndex

AA = "ACDEFGHIKLMNPQRSTVWY"
S = 4


def small_index(seed: int = 83):
    rng = random.Random(seed)
    records = [(f"ACC{i:04d}.1_{100 + i % 3}",
                "".join(rng.choice(AA) for _ in range(rng.randint(40, 300))))
               for i in range(80)]
    return py_builder.build_index(records)


def queries(idx, whole, seed: int) -> torch.Tensor:
    """int32 [Q, 2]: RANK, ROW, LF and SAMPLE queries over every shard."""
    rng = np.random.default_rng(seed)
    n = 6000
    k = rng.integers(0, idx.length + 1, n).astype(np.int32)
    kind = rng.integers(0, 4, n).astype(np.int32)
    c = rng.integers(1, idx.alen, n).astype(np.int32)
    x = np.where(kind == tdev.Q_SAMPLE, k % whole.sa_seq.shape[0],
                 np.where(kind == tdev.Q_LF, np.minimum(k, idx.length - 1),
                          k))
    op = kind << 8 | np.where(kind == tdev.Q_RANK, c, 0)
    return torch.from_numpy(np.stack([op, x], 1).astype(np.int32))


def run_form(idx, whole, plain, card, pid):
    """One view's exchange on the inputs of process pid: (report, answers
    of the round, sequences of the walks)."""
    import torch.distributed as dist

    view = ShardedIndex.in_group(idx, S, [card], dist.group.WORLD)[0]
    ex = view.exchange
    q = queries(idx, whole, 10 + pid)
    ans = ex.serve(q.to(card), 20, "seed")
    want, _bad = tdev.fm_serve_plain(whole.rec, whole.C, whole.sa_seq,
                                     whole.sa_off, q, 20)
    rows = torch.from_numpy(np.random.default_rng(20 + pid).integers(
        idx.nseq, idx.length, 3000).astype(np.int32))
    seq = torch.empty_like(rows).to(card)

    def walk(**kw):
        return tdev.walk_hosts(view.rec, view.C, view.sa_seq, idx.nseq,
                               idx.chpt_exp, seq, **kw)

    parked, asks = walk(rows=rows.to(card))
    walked = parked.shape[0]
    ex.rounds("walk", parked, asks, 1, lambda pk, a: walk(
        parked=pk, answers=a.reshape(-1).contiguous()))
    torch.cuda.synchronize(card)
    want_seq = tdev.sa_walk(plain.rec, plain.C, plain.sa_seq, plain.sa_off,
                            plain.nseq, plain.chpt_exp, rows)[0]
    report = {"backend": ex.backend, "staged": ex.staged,
              "remote": sorted(view.remote), "parked": walked,
              "serve_equal": torch.equal(ans.cpu(), want),
              "walk_equal": torch.equal(seq.cpu(), want_seq),
              "counts": ex.counts}
    return report, ans.cpu(), seq.cpu()


def main(argv) -> int:
    coord, pid, out = argv[0], int(argv[1]), argv[2]
    card = torch.device("cuda", pid)
    torch.cuda.set_device(card)
    peer_shards.host_name = lambda: "ab"[pid]
    multihost.init_distributed(coord, 2, pid)
    idx = small_index()
    whole = ShardedIndex(idx, S, "cpu")
    plain = tdev.DeviceIndex(idx, "cpu")
    nccl = run_form(idx, whole, plain, card, pid)
    exchange.backend_for = lambda slots: "gloo"  # the staged twin
    gloo = run_form(idx, whole, plain, card, pid)
    with open(out, "w") as fh:
        json.dump({"nccl": nccl[0], "gloo": gloo[0],
                   "same": all(torch.equal(a, b) for a, b in
                               zip(nccl[1:], gloo[1:]))}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
