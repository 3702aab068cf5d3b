"""Prebuilt kernel libraries beside an index: the port's warm start.

``kaiju_tpu.utils.aot`` keeps the exported fused programs beside the
index, because tracing them takes minutes a process.  The port traces
nothing; what a fresh process pays instead is the ``nvcc`` build of the
kernel libraries (``kernels.build``), the seed tables and the Bloom
bitmaps.  ``tools.mkdb --aot`` pays all three once, at index build time:
it builds every library into ``prebuilt_dir(<ktx>)`` and writes the seed
tables and bitmaps beside the index.  Every later process on that index
loads the libraries from there (``kernels.use_prebuilt``), with no
``nvcc``.

The directory is ``<cache_dir>/aot/cuda-<machine>-<source>/``, keyed by
content, never by mtimes (which a copied or checked-out tree does not
keep):

- the source key, a sha256 over every ``csrc/*.cu`` and ``csrc/*.cuh``
  by sorted name and content, and over ``kernels.NVCC_FLAGS``;
- the machine key, a sha256 over the card's compute capability (the
  libraries are ``sm_90a`` code, which runs only on 9.0), the release
  line of ``nvcc --version`` and ``platform.machine()``.

It holds ``lib<source>.so`` for every entry of ``kernels.SOURCES`` and a
manifest, ``manifest.json``, that lists the sources and both keys.  A
directory is built under a temporary name and renamed into place, so a
crash leaves no half directory under a key.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import platform
import shutil
import subprocess
import tempfile
import time

from .. import kernels

MANIFEST = "manifest.json"
_NVCC_RELEASE: str | None = None


def source_key(csrc_dir: str = kernels.CSRC_DIR) -> str:
    """16 hex digits of the sha256 over csrc_dir's *.cu and *.cuh (sorted
    by name, each name and content) and the nvcc flags."""
    h = hashlib.sha256()
    paths = glob.glob(os.path.join(csrc_dir, "*.cu"))
    paths += glob.glob(os.path.join(csrc_dir, "*.cuh"))
    for path in sorted(paths, key=os.path.basename):
        with open(path, "rb") as fh:
            data = fh.read()
        h.update(os.path.basename(path).encode() + b"\0")
        h.update(len(data).to_bytes(8, "little") + data)
    h.update("\0".join(kernels.NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_release() -> str:
    """The release line of ``nvcc --version`` ("none" without nvcc)."""
    global _NVCC_RELEASE
    if _NVCC_RELEASE is None:
        try:
            out = subprocess.run([kernels._nvcc(), "--version"],
                                 capture_output=True, text=True,
                                 timeout=60, check=True).stdout
            lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
            _NVCC_RELEASE = lines[0] if lines else out.strip()
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _NVCC_RELEASE = "none"
    return _NVCC_RELEASE


def machine_parts(device=None) -> dict:
    """What the machine key hashes: the card's compute capability, nvcc's
    release line and the host's architecture."""
    import torch

    major, minor = torch.cuda.get_device_capability(device)
    return {"capability": f"{major}.{minor}", "nvcc": nvcc_release(),
            "arch": platform.machine()}


def machine_key(device=None) -> str:
    """8 hex digits of the sha256 over machine_parts(device)."""
    parts = machine_parts(device)
    text = "|".join(parts[k] for k in ("capability", "nvcc", "arch"))
    return hashlib.sha256(text.encode()).hexdigest()[:8]


def key(device=None) -> str:
    """The directory name of this checkout's libraries on this machine."""
    return f"cuda-{machine_key(device)}-{source_key()}"


def prebuilt_dir(cache_dir: str, device=None) -> str:
    """<cache_dir>/aot/cuda-<machine>-<source>/ (it may not exist)."""
    return os.path.join(cache_dir, "aot", key(device))


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as fh:
        return json.load(fh)


def prebuild(cache_dir: str, device=None, verbose: bool = False) -> str:
    """Build every library of kernels.SOURCES into prebuilt_dir(cache_dir)
    (one nvcc a source, all started together, in a temporary directory
    renamed into place; a directory already there is replaced) with its
    manifest; returns the directory.  Raises when a source does not
    compile or the directory cannot be written."""
    final = prebuilt_dir(cache_dir, device)
    parent = os.path.dirname(final)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".build-", dir=parent)
    try:
        t0 = time.perf_counter()
        kernels.compile_into(tmp, kernels.SOURCES, verbose=verbose)
        manifest = {
            "key": os.path.basename(final),
            "source_key": source_key(), "machine_key": machine_key(device),
            "machine": machine_parts(device),
            "nvcc_flags": kernels.NVCC_FLAGS,
            "sources": list(kernels.SOURCES),
            "build_seconds": time.perf_counter() - t0,
        }
        with open(os.path.join(tmp, MANIFEST), "w") as fh:
            json.dump(manifest, fh, indent=1)
        os.chmod(tmp, 0o755)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final
