"""Build, load and launch the port's hand-written Hopper kernels.

Each source under csrc/ is compiled by nvcc for sm_90a into its own shared
library with a plain C interface, loaded with ctypes. The libraries live in
`_build/<digest>/` beside this file, where the digest covers the sources and
the compiler flags: a fresh checkout builds them at first use, all sources
at once (one nvcc process each), and an unchanged tree reuses them.

Every wrapper that launches a kernel goes through `launch`, which runs it
on the card its tensors lie on, adds one to that kernel's count in
`launches` and raises if the C entry point returns a non-zero cudaError_t. A run resets the counts with
`reset_launches()` and reads them afterwards to show which kernels it went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "_build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

# library name -> (source file, extra nvcc flags)
SOURCES = {
    # -fmad=false: the chain score must round like the plain version's
    # separate multiply and add, or parents flip on near-ties
    "chain": ("chain.cu", ["-fmad=false"]),
    "ed": ("ed.cu", []),
    "verify": ("verify.cu", []),
    "sw": ("sw_banded.cu", []),
    "sw_full": ("sw_full.cu", []),
    "banded": ("banded_cigar.cu", []),
}

# launches per library; chain.cu's splice instantiation counts apart
launches = {name: 0 for name in (*SOURCES, "chain_splice")}

_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc_path() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(SOURCES):
        src, extra = SOURCES[name]
        h.update(name.encode())
        h.update(" ".join(ARCH_FLAGS + COMMON_FLAGS + extra).encode())
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    return os.path.join(BUILD_ROOT, _digest())


def lib_path(name: str) -> str:
    return os.path.join(build_dir(), f"lib{name}.so")


def build_all() -> dict:
    """Compile every library that is missing, all nvcc processes started
    together. Returns {name: path}."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name, (src, extra) in SOURCES.items():
        dst = lib_path(name)
        if os.path.isfile(dst):
            continue
        tmp = f"{dst}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *ARCH_FLAGS, *COMMON_FLAGS, *extra,
               "-o", tmp, os.path.join(CSRC, src)]
        procs.append((name, dst, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, dst, tmp, cmd, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, dst)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return {name: lib_path(name) for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not os.path.isfile(path):
                build_all()
            lib = _libs[name] = ctypes.CDLL(path)
        return lib


def entry(lib_name: str, fn_name: str, n_ptr: int, n_int: int,
          n_float: int = 0):
    """A C entry point taking n_ptr device pointers, n_int ints, n_float
    floats and the stream, returning a cudaError_t. A float argument must be
    counted in n_float: declared as an int, ctypes would cut it."""
    fn = getattr(library(lib_name), fn_name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(lib_name: str, fn, *args, counter: str | None = None) -> None:
    """Call a C entry point on the current stream of the card its tensor
    arguments lie on, with that card made current; raise on its error.
    Tensors pass as their data pointers and must share one CUDA device. The
    launch counts under `counter` (default: the library's name)."""
    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"{lib_name}: the tensor arguments must lie on one "
                         f"CUDA device, got {sorted(map(str, devs))}")
    (dev,) = devs
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launches[counter or lib_name] += 1
        err = fn(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{lib_name} kernel launch failed: cudaError_t "
                           f"{err}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple | None = None) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, contiguity and
    (where given) shape; -1 in `shape` matches any extent."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None:
        ok = len(shape) == t.dim() and all(
            s == -1 or s == d for s, d in zip(shape, t.shape))
        if not ok:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
