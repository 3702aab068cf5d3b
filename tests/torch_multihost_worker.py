"""One process of a multi-process run of the port's `kaiju` on the CPU:
kaiju_tpu_torch.tools.kaiju.main(argv, device="cpu") with this command
line's arguments (tests/test_torch_multihost.py starts it N times, with
--dist-* flags or the KAIJU_TPU_* variables)."""

import sys

from kaiju_tpu_torch.tools import kaiju

if __name__ == "__main__":
    sys.exit(kaiju.main(sys.argv[1:], device="cpu"))
