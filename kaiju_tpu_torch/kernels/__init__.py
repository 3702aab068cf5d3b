"""Build loader for the port's CUDA kernels.

Every ``kaiju_tpu_torch/csrc/<source>.cu`` is compiled by ``nvcc`` for
sm_90a into its own plain-C shared library,
``build/kaiju_tpu_torch/lib<source>.so`` at the repository root, and loaded
with ctypes.  A kernel is one C entry point of a source: most sources hold
one kernel of their own name; ``gather.cu`` holds P1 and P2,
``big_mem.cu`` L and M (the int64 step over an index above 2^31 letters,
K17, ``ops/big_mem.py``), and a
``<name>_sharded`` kernel is kernel ``<name>`` instantiated on an index
split into shards (K16, ``parallel/sharded_index.py``); ``peer.cu`` holds
no kernel, only the CUDA IPC calls that share shards between processes
(``parallel/peer_shards.py``), and ``chase.cu`` a latency probe outside
every path (``chase_ns``).  A library is
built at first use and again whenever its source or a shared header
(``csrc/*.cuh``) is newer; stale sources compile in parallel, one
``nvcc`` each.  Nothing is compiled when a module is
imported, so the CPU tests import everything without a CUDA toolkit.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.  Wrappers
count their launches in ``LAUNCHES`` (one per kernel launch, nowhere
else), and kernel B's launches with its Bloom screen in ``SCREENED`` too,
so a run can show that it went through the kernels.
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

# C signatures, the stream last: "p" = pointer (c_void_p), "i" = int32,
# "q" = int64
_SIGNATURES = {
    # rec nb1 C | c s0 s1 n | n0 n1 ok
    "update_si": ("kt_update_si", "pip" "pppi" "ppp" "p"),
    # rec nb1 C | seed_s0 seed_s1 seed_d nseed | flat P frag_off F K j0 |
    # words m lb sw_steps | i s0 s1
    "mem_extend": ("kt_mem_extend", "pip" "pppi" "pipiii" "piii" "ppp" "p"),
    # i s0 s1 frag_off F min_len T | maxl tie_cnt tie_j tie_s0 tie_s1
    "mem_stats": ("kt_mem_stats", "ppppiii" "ppppp" "p"),
    # maxl tie_cnt tie_s0 tie_s1 T | rf_rows B S | rec nb1 C sa_seq nsamp |
    # seq_tax ntax parent depth maxtax | R cap nseq chpt_exp | sw_ids nsw |
    # out
    "read_lca": ("kt_read_lca",
                 "ppppi" "pii" "pippi" "pippi" "iiii" "pi" "p" "p"),
    # g_s0 g_s1 B G | rec nb1 C sa_seq nsamp | seq_tax ntax parent depth
    # maxtax | R cap nseq chpt_exp | sw_ids nsw | lca n_ids need_more
    # tie_order
    "ranges_lca": ("kt_ranges_lca",
                   "ppii" "pippi" "pippi" "iiii" "pi" "pppp" "p"),
    # li ls0 ls1 flat frag_off F rf_rows B S | rec nb1 C | diag submat
    # subcode subdiag | Lmap mfl min_score mismatches T vcap | node pincl
    # src | best flags g_s0 g_s1 | text rank_start sa_seq sa_off nsamp nseq
    # chpt_exp sw_ids
    "greedy_search": ("kt_greedy_search",
                      "ppppp" "ipii" "pip" "pppp" "iiiiii" "ppp" "pppp"
                      "pppp" "iii" "p" "p"),
    # rec nb1 C sa_seq sa_off nsamp nseq chpt_exp | text rank_start | flat
    # P frag_off F sw_len | i s0 s1 | out_i out_s0 out_s1 sw_ids
    "text_extend": ("kt_text_extend",
                    "pip" "ppiii" "pp" "pipii" "ppp" "pppp" "p"),
    # rec nb1 C | sa_seq sa_off nsamp nseq chpt_exp | k n | iseq pos
    "sa_lookup": ("kt_sa_lookup", "pip" "ppiii" "pi" "pp" "p"),
    # rec nb1 C flat | base pos sub start_i s0 s1 act n | i s0 s1
    "extend_from": ("kt_extend_from", "pipp" "pppppppi" "ppp" "p"),
    # rec nb1 C | codes flen F L | start si0 si1
    "extend_all": ("kt_extend_all", "pip" "ppii" "ppp" "p"),
    # i s0 s1 frag_off F lmap | rows n_rows
    "greedy_map": ("kt_greedy_map", "ppppii" "pp" "p"),
    # tab idx n | out
    "gather_rows": ("kt_gather_rows", "ppi" "p" "p"),
    "gather_sum": ("kt_gather_sum", "ppi" "p" "p"),
    # the big index (K17, csrc/big_mem.cu): rec_tab nb_s S C base alen |
    # codes R L | i s0 s1
    "big_extend_all": ("kt_big_extend_all", "piippi" "pii" "ppp" "p"),
    # rec_tab nb_s S C base alen | seq_tab ns_s first e | kf n | ids
    "big_sa_walk": ("kt_big_sa_walk", "piippi" "piqi" "pq" "p" "p"),
}
# The shard arguments that take the place of rec/nb1 (and of the SA samples
# and the text) in a sharded entry point: rec_tab nb_s seq_tab off_tab ns_s
# nsamp text_tab nt_s S (KT_SHARD_PARAMS, csrc/fm_common.cuh)
SHARD_SIG = "pippiipii"
_SIGNATURES.update({
    # SHARD | C | c s0 s1 n | n0 n1 ok
    "update_si_sharded": ("kt_update_si_sharded",
                          SHARD_SIG + "p" "pppi" "ppp" "p"),
    # SHARD | C nseq chpt_exp | k n | iseq pos
    "sa_lookup_sharded": ("kt_sa_lookup_sharded",
                          SHARD_SIG + "pii" "pi" "pp" "p"),
    # SHARD | C | codes flen F L | start si0 si1
    "extend_all_sharded": ("kt_extend_all_sharded",
                           SHARD_SIG + "p" "ppii" "ppp" "p"),
    # SHARD | C | seed_s0 seed_s1 seed_d nseed | flat P frag_off F K j0 |
    # words m lb sw_steps | i s0 s1
    "mem_extend_sharded": ("kt_mem_extend_sharded",
                           SHARD_SIG + "p" "pppi" "pipiii" "piii" "ppp" "p"),
    # SHARD | C nseq chpt_exp | rank_start flat P frag_off F sw_len | i s0
    # s1 | out_i out_s0 out_s1 sw_ids
    "text_extend_sharded": ("kt_text_extend_sharded",
                            SHARD_SIG + "pii" "ppipii" "ppp" "pppp" "p"),
    # maxl tie_cnt tie_s0 tie_s1 T | rf_rows B S | SHARD | C | seq_tax ntax
    # parent depth maxtax | R cap nseq chpt_exp | sw_ids nsw | out
    "read_lca_sharded": ("kt_read_lca_sharded",
                         "ppppi" "pii" + SHARD_SIG + "p" "pippi" "iiii" "pi"
                         "p" "p"),
    # g_s0 g_s1 B G | SHARD | C | seq_tax ntax parent depth maxtax | R cap
    # nseq chpt_exp | sw_ids nsw | lca n_ids need_more tie_order
    "ranges_lca_sharded": ("kt_ranges_lca_sharded",
                           "ppii" + SHARD_SIG + "p" "pippi" "iiii" "pi"
                           "pppp" "p"),
    # li ls0 ls1 flat frag_off F rf_rows B S | SHARD | C | diag submat
    # subcode subdiag | Lmap mfl min_score mismatches T vcap | node pincl
    # src | best flags g_s0 g_s1 | rank_start nseq chpt_exp sw_ids
    "greedy_search_sharded": ("kt_greedy_search_sharded",
                              "ppppp" "ipii" + SHARD_SIG + "p" "pppp"
                              "iiiiii" "ppp" "pppp" "pii" "p" "p"),
})
# the source file of each kernel (csrc/<source>.cu), where it is not the
# kernel's own name
_SOURCE = {"gather_rows": "gather", "gather_sum": "gather",
           "big_extend_all": "big_mem", "big_sa_walk": "big_mem",
           **{n: n[:-len("_sharded")] for n in _SIGNATURES
              if n.endswith("_sharded")}}
# sources that hold no kernel of a path, only entry points whose
# signatures their users set (csrc/peer.cu: parallel/peer_shards.py;
# csrc/chase.cu: chase_ns)
HELPERS = ("chase", "peer")


def source(name: str) -> str:
    """The csrc/<source>.cu that holds kernel `name`."""
    return _SOURCE.get(name, name)


SOURCES = sorted({source(n) for n in _SIGNATURES} | set(HELPERS))

LAUNCHES = {name: 0 for name in _SIGNATURES}
# launches of kernel B with its Bloom screen (each counted in LAUNCHES too)
SCREENED = {"mem_extend": 0}

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_int64}
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SCREENED["mem_extend"] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{src}.so")


def _stale(src: str) -> bool:
    lib = _lib_path(src)
    if not os.path.exists(lib):
        return True
    srcs = [os.path.join(CSRC_DIR, f"{src}.cu")]
    srcs += glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return os.path.getmtime(lib) < max(os.path.getmtime(s) for s in srcs)


def build(force: bool = False, verbose: bool = False) -> float:
    """Compile every stale kernel library (all of them with force), one
    nvcc process per source, all started together.  Returns the wall
    seconds spent; raises with the compiler's output on a failure."""
    t0 = time.perf_counter()
    todo = [s for s in SOURCES if force or _stale(s)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC_DIR, f"{src}.cu")]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc {src}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, _lib_path(src))
        if verbose and log.strip():
            print(f"nvcc {src}.cu:\n{log.strip()}", flush=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`'s source, built first if needed
    (the sources are checked once a process, at the first load), with the
    C signature of every kernel it holds set."""
    return load(source(name))


def load(src: str) -> ctypes.CDLL:
    """The loaded library of csrc/<src>.cu, as library() gives it."""
    lib = _libs.get(src)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            build()
            lib = ctypes.CDLL(_lib_path(src))
            for kname, (fn_name, sig) in _SIGNATURES.items():
                if source(kname) != src:
                    continue
                fn = getattr(lib, fn_name)
                fn.restype = ctypes.c_int
                fn.argtypes = [_CTYPES[s] for s in sig]
            lib.kt_error_string.restype = ctypes.c_char_p
            lib.kt_error_string.argtypes = [ctypes.c_int]
            _libs[src] = lib
        return lib


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point on the current stream with
    `args` (tensors pass their data pointer, None a null pointer, ints
    as int32 or int64 as the signature says) and count the launch; raises
    on a CUDA error."""
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


def chase_ns(n_ints: int, cached: bool, steps: int = 20_000,
             seed: int = 0) -> float:
    """Nanoseconds of one dependent load on the current card (csrc/chase.cu)
    along a random cycle through n_ints int32, CUDA events around a walk
    of `steps` loads.  cached: the walk repeats the warm-up walk's
    addresses, now in the L2; else it starts half the cycle away, on
    addresses not loaded before (device memory, for a cycle of 4 n_ints
    bytes well past the 50 MB L2)."""
    lib = load("chase")
    lib.kt_chase.restype = ctypes.c_int
    lib.kt_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p]
    gen = torch.Generator().manual_seed(seed)
    order = torch.randperm(n_ints, generator=gen, dtype=torch.int32)
    nxt = torch.empty(n_ints, dtype=torch.int32)
    nxt[order] = torch.roll(order, -1)  # one cycle through every slot
    nxt = nxt.cuda()
    out = torch.empty(1, dtype=torch.int32, device=nxt.device)
    stream = torch.cuda.current_stream()

    def walk(start, n):
        rc = lib.kt_chase(nxt.data_ptr(), start, n, out.data_ptr(),
                          stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kt_chase: CUDA error {rc}")

    walk(int(order[0]), steps)
    if not cached:  # evict the upload's last lines: 256 MiB written
        torch.zeros(1 << 26, dtype=torch.int32, device=nxt.device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    walk(int(order[0 if cached else n_ints // 2]), steps)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e6 / steps


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
