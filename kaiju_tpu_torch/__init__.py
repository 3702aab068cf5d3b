"""kaiju-tpu-torch: the PyTorch/CUDA port of kaiju-tpu for NVIDIA Hopper.

Kaiju's metagenomic read classifier (six-frame translation, FM-index
backward search, SA resolution, taxonomy LCA) with its device work in
CUDA kernels written for sm_90a (``csrc/``, built by ``kernels``) and the
host layers copied from ``kaiju_tpu`` with their imports changed.  Each
kernel has a plain PyTorch version beside it with the same contract; a
wrapper takes the plain version only for tensors that lie on the CPU.

Entry point: ``python -m kaiju_tpu_torch.tools.kaiju -a mem ...``.
"""

__version__ = "0.1.0"
