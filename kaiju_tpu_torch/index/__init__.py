from .core import KaijuIndex, BLOCK, OCC_WIDTH  # noqa: F401
