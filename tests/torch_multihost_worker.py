"""One process of a multi-process run of the port's `kaiju` on the CPU:
kaiju_tpu_torch.tools.kaiju.main(argv, device="cpu") with this command
line's arguments (tests/test_torch_multihost.py and
tests/test_torch_dist_cards.py start it N times, with --dist-* flags or
the KAIJU_TPU_* variables).  Leading options, in this order: `--host
NAME` gives the process that host name (peer_shards.host_name), so that
processes on one machine rehearse a group on several hosts; `--slots K`
runs the process on K CPU slots, device=["cpu"] * K, as a process on K
cards.  With --mesh-index it also writes, beside its -o file as
<out>.shards.json, the layout of its ShardedIndex (the shards it holds,
maps and has served in rounds, with the rounds of the whole process and
its exchange's transport, "gloo" or "nccl", None without rounds) and
the run directory of the mapped shards, before the process leaves its
group and the shards are released; with slots, a list of those layouts,
one a slot, each with its own rounds.

The worker arms faulthandler: every thread's stack reaches its stderr on a
fatal signal, on SIGTERM (which then ends it, as it would have), and, where
KAIJU_TEST_STACKS_AFTER holds a number of seconds, once that long after the
start, so that a run that fails or overruns shows where each thread was."""

import faulthandler
import json
import os
import signal
import sys

from kaiju_tpu_torch.engine.pipeline import CardShare
from kaiju_tpu_torch.parallel import exchange, peer_shards
from kaiju_tpu_torch.tools import kaiju


def arm_stacks() -> None:
    """Every thread's stack to stderr on a fatal signal, on SIGTERM (then
    the default action, which ends the process) and, with
    KAIJU_TEST_STACKS_AFTER set, that many seconds from now."""
    faulthandler.enable()
    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    after = os.environ.get("KAIJU_TEST_STACKS_AFTER")
    if after:
        faulthandler.dump_traceback_later(float(after))


def main(argv) -> int:
    if argv[:1] == ["--host"]:
        name = argv[1]
        peer_shards.host_name = lambda: name
        argv = argv[2:]
    device = "cpu"
    if argv[:1] == ["--slots"]:
        device = ["cpu"] * int(argv[1])
        argv = argv[2:]
    runners = []
    make_runner = kaiju.make_runner

    def keep(*args, **kw):
        runners.append(make_runner(*args, **kw))
        return runners[-1]

    kaiju.make_runner = keep
    rc = kaiju.main(argv, device=device)
    if "--mesh-index" in argv:
        pipe = runners[0].pipe
        pipes = pipe.pipes if isinstance(pipe, CardShare) else [pipe]
        reports = []
        for p in pipes:
            report = p.dev.layout()
            report["run_dir"] = p.dev.share.run_dir
            report["rounds"] = exchange.COUNTS
            report["backend"] = None
            if p.dev.exchange is not None:
                report["card_rounds"] = p.dev.exchange.counts
                report["backend"] = p.dev.exchange.backend
            reports.append(report)
        with open(argv[argv.index("-o") + 1] + ".shards.json", "w") as fh:
            json.dump(reports if isinstance(pipe, CardShare) else reports[0],
                      fh)
    return rc


if __name__ == "__main__":
    arm_stacks()
    sys.exit(main(sys.argv[1:]))
