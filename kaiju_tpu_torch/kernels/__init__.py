"""Build loader for the port's CUDA kernels.

Every ``kaiju_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
sm_90a into its own plain-C shared library,
``build/kaiju_tpu_torch/lib<name>.so`` at the repository root, and loaded
with ctypes.  A library is built at first use and again whenever its
source or a shared header (``csrc/*.cuh``) is newer; stale sources compile
in parallel, one ``nvcc`` each.  Nothing is compiled when a module is
imported, so the CPU tests import everything without a CUDA toolkit.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.  Wrappers
count their launches in ``LAUNCHES`` (one per kernel launch, nowhere
else), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kaiju_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# C signatures, the stream last: "p" = pointer (c_void_p), "i" = int32
_SIGNATURES = {
    # rec nb1 C | c s0 s1 n | n0 n1 ok
    "update_si": ("kt_update_si", "pip" "pppi" "ppp" "p"),
    # rec nb1 C | seed_s0 seed_s1 seed_d nseed | flat P frag_off F K j0 |
    # i s0 s1
    "mem_extend": ("kt_mem_extend", "pip" "pppi" "pipiii" "ppp" "p"),
    # i s0 s1 frag_off F min_len T | maxl tie_cnt tie_j tie_s0 tie_s1
    "mem_stats": ("kt_mem_stats", "ppppiii" "ppppp" "p"),
    # maxl tie_cnt tie_s0 tie_s1 T | rf_rows B S | rec nb1 C sa_seq nsamp |
    # seq_tax ntax parent depth maxtax | R cap nseq chpt_exp | out
    "read_lca": ("kt_read_lca",
                 "ppppi" "pii" "pippi" "pippi" "iiii" "p" "p"),
}

LAUNCHES = {name: 0 for name in _SIGNATURES}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    srcs = [os.path.join(CSRC_DIR, f"{name}.cu")]
    srcs += glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return os.path.getmtime(lib) < max(os.path.getmtime(s) for s in srcs)


def build(force: bool = False, verbose: bool = False) -> float:
    """Compile every stale kernel library (all of them with force), one
    nvcc process per source, all started together.  Returns the wall
    seconds spent; raises with the compiler's output on a failure."""
    t0 = time.perf_counter()
    todo = [n for n in _SIGNATURES if force or _stale(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, _lib_path(name))
        if verbose and log.strip():
            print(f"nvcc {name}.cu:\n{log.strip()}", flush=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed (the
    sources are checked once a process, at the first load)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(_lib_path(name))
            fn_name, sig = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p if s == "p" else ctypes.c_int for s in sig
            ]
            lib.kt_error_string.restype = ctypes.c_char_p
            lib.kt_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point on the current stream with
    `args` (tensors pass their data pointer, None a null pointer, ints
    as int32) and count the launch; raises on a CUDA error."""
    lib = library(name)
    fn_name, sig = _SIGNATURES[name]
    conv = []
    for a in args:
        if isinstance(a, torch.Tensor):
            conv.append(ctypes.c_void_p(a.data_ptr()))
        elif a is None:
            conv.append(ctypes.c_void_p(None))
        else:
            conv.append(int(a))
    conv.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if len(conv) != len(sig):
        raise TypeError(f"{fn_name}: {len(conv)} arguments, expected {len(sig)}")
    LAUNCHES[name] += 1
    rc = getattr(lib, fn_name)(*conv)
    if rc != 0:
        msg = lib.kt_error_string(rc).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {rc} ({msg})")


def check(t: torch.Tensor, what: str, dtype: torch.dtype, device,
          ndim: int | None = None) -> None:
    """Raise unless t is a contiguous tensor of `dtype` on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what}: {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
