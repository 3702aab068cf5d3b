"""One process of a multi-process run of the port's `kaiju` on the CPU:
kaiju_tpu_torch.tools.kaiju.main(argv, device="cpu") with this command
line's arguments (tests/test_torch_multihost.py starts it N times, with
--dist-* flags or the KAIJU_TPU_* variables).  A first argument `--host
NAME` gives the process that host name (peer_shards.host_name), so that
processes on one machine rehearse a group on several hosts.  With
--mesh-index it also writes, beside its -o file as <out>.shards.json, the
layout of its ShardedIndex (the shards it holds, maps and has served in
rounds) and the run directory of the mapped shards, before the process
leaves its group and the shards are released."""

import json
import sys

from kaiju_tpu_torch.parallel import exchange, peer_shards
from kaiju_tpu_torch.tools import kaiju


def main(argv) -> int:
    if argv[:1] == ["--host"]:
        name = argv[1]
        peer_shards.host_name = lambda: name
        argv = argv[2:]
    runners = []
    make_runner = kaiju.make_runner

    def keep(*args, **kw):
        runners.append(make_runner(*args, **kw))
        return runners[-1]

    kaiju.make_runner = keep
    rc = kaiju.main(argv, device="cpu")
    if "--mesh-index" in argv:
        sharded = runners[0].pipe.dev
        report = sharded.layout()
        report["run_dir"] = sharded.share.run_dir
        report["rounds"] = exchange.COUNTS
        with open(argv[argv.index("-o") + 1] + ".shards.json", "w") as fh:
            json.dump(report, fh)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
