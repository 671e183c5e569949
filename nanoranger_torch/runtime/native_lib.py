"""Build + ctypes bindings of the host C++ libraries.

Counterpart of the JAX package's runtime/native_lib.py, with its three host
sources: `banded_align_batch` (base-level global alignment with traceback,
for the clonotyper's frame pinning and the BAM boundary) with its numpy
twin; `wl_verify_all`, the host twin of the one-vs-all whitelist DP
(csrc/verify.cu on the card), which ops/whitelist_verify.verify_all runs
for CPU tensors; and `NativeFastqReader`, the streaming fastq(.gz) reader
that io/fastq.iter_batches takes whenever a batch width cap is given. This
is host code in both packages, not a device kernel.

Each library is built by g++ at first use into its own directory under
`_build/` beside the package (keyed by a digest of its sources, flags and
link libraries) and loaded with ctypes. The reader links zlib and builds
apart from the other two, so a host without zlib still builds the aligner
and the DP twin. When a library cannot be built its callers run their
torch or numpy versions, or the Python parser, instead, as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_ROOT = os.path.join(_PKG, "_build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]
# library -> (sources under runtime/native/, link libraries)
LIBS = {
    "nrnative": (("banded_align.cpp", "whitelist_verify.cpp"), ()),
    "nrfastq": (("fastq_reader.cpp",), ("-lz",)),
}

_loaded: dict = {}


def _srcs(name: str) -> list:
    return [os.path.join(_PKG, "runtime", "native", f)
            for f in LIBS[name][0]]


def _lib_path(name: str = "nrnative") -> str:
    libs = list(LIBS[name][1])
    h = hashlib.sha256(" ".join(_FLAGS + libs).encode())
    for src in _srcs(name):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, f"host_{h.hexdigest()[:16]}",
                        f"lib{name}.so")


def build(name: str) -> str | None:
    """Build library `name` unless its file is there. Returns None, or the
    reason it could not be built (the compiler's message)."""
    dst = _lib_path(name)
    if os.path.isfile(dst):
        return None
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    tmp = f"{dst}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, *_srcs(name), "-o", tmp,
                        *LIBS[name][1]], check=True, capture_output=True)
    except OSError as e:
        return str(e)
    except subprocess.CalledProcessError as e:
        return e.stderr.decode(errors="replace")
    os.replace(tmp, dst)
    return None


def _declare(name: str, lib) -> None:
    if name == "nrfastq":
        lib.fq_open.restype = ctypes.c_void_p
        lib.fq_open.argtypes = [ctypes.c_char_p]
        lib.fq_next_batch.restype = ctypes.c_int
        lib.fq_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
        lib.fq_close.restype = None
        lib.fq_close.argtypes = [ctypes.c_void_p]
        return
    lib.banded_align_batch.restype = ctypes.c_int
    lib.banded_align_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.wl_verify_all.restype = ctypes.c_int
    lib.wl_verify_all.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int]


def load(name: str):
    """The loaded library `name`, or None when it cannot be built or
    loaded (tried once a process)."""
    if name not in _loaded:
        lib = None
        if build(name) is None:
            try:
                lib = ctypes.CDLL(_lib_path(name))
            except OSError:
                lib = None
        if lib is not None:
            _declare(name, lib)
        _loaded[name] = lib
    return _loaded[name]


def get_lib():
    """The aligner and DP twin's library, or None."""
    return load("nrnative")


class NativeFastqReader:
    """Streaming fastq(.gz) reader backed by the host C++ library (zlib
    inflate + parse + base-encode in one pass). Raises OSError if the
    library is unavailable or the file cannot be opened: callers fall back
    to the Python parser."""

    def __init__(self, path: str, batch_size: int, max_len: int):
        lib = load("nrfastq")
        if lib is None:
            raise OSError("native fastq reader library unavailable")
        self._lib = lib
        self._h = lib.fq_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")
        self.batch_size = batch_size
        self.max_len = max_len

    def next_batch(self):
        """Returns (codes (n, max_len) int8, lengths (n,) i32, names
        list[str], quals list[bytes]) or None at EOF."""
        B, L = self.batch_size, self.max_len
        codes = np.empty((B, L), np.int8)
        lengths = np.empty(B, np.int32)
        name_cap = B * 1024
        qual_cap = B * L
        name_buf = np.empty(name_cap, np.uint8)
        qual_buf = np.empty(qual_cap, np.uint8)
        name_off = np.empty(B + 1, np.int32)
        qual_off = np.empty(B + 1, np.int32)
        n = self._lib.fq_next_batch(
            self._h, B, L, codes.ctypes.data, lengths.ctypes.data,
            name_buf.ctypes.data, name_cap, name_off.ctypes.data,
            qual_buf.ctypes.data, qual_cap, qual_off.ctypes.data)
        if n == 0:
            return None
        if n < 0:
            raise ValueError(f"malformed fastq or arena overflow (rc={n})")
        nb = name_buf[:name_off[n]].tobytes()
        qb = qual_buf[:qual_off[n]].tobytes()
        names = [nb[name_off[i]:name_off[i + 1]].decode("ascii")
                 for i in range(n)]
        quals = [qb[qual_off[i]:qual_off[i + 1]] for i in range(n)]
        return codes[:n], lengths[:n], names, quals

    def close(self):
        if self._h:
            self._lib.fq_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def banded_align_batch(q_segs: list[np.ndarray], t_segs: list[np.ndarray],
                       band: int = 64):
    """Align each query segment to its target segment (global, affine).

    Returns (cigars list[str], scores (n,), nm (n,)). Segments are int8
    base-code arrays."""
    n = len(q_segs)
    if n == 0:
        return [], np.zeros(0, np.int32), np.zeros(0, np.int32)
    lib = get_lib()
    if lib is None:
        return _banded_align_numpy(q_segs, t_segs, band)
    q = np.concatenate([np.zeros(0, np.int8)] + [s.astype(np.int8) for s in q_segs])
    t = np.concatenate([np.zeros(0, np.int8)] + [s.astype(np.int8) for s in t_segs])
    q_len = np.asarray([len(s) for s in q_segs], np.int32)
    t_len = np.asarray([len(s) for s in t_segs], np.int32)
    q_off = np.zeros(n, np.int32)
    np.cumsum(q_len[:-1], out=q_off[1:])
    t_off = np.zeros(n, np.int32)
    np.cumsum(t_len[:-1], out=t_off[1:])
    cap = int(q_len.sum() + t_len.sum() + 16 * n + 1024)
    cig_buf = ctypes.create_string_buffer(cap)
    cig_off = np.zeros(n + 1, np.int32)
    scores = np.zeros(n, np.int32)
    nm = np.zeros(n, np.int32)
    rc = lib.banded_align_batch(
        q.ctypes.data, q_off.ctypes.data, q_len.ctypes.data,
        t.ctypes.data, t_off.ctypes.data, t_len.ctypes.data,
        n, band, cig_buf, cap,
        cig_off.ctypes.data, scores.ctypes.data, nm.ctypes.data)
    if rc != 0:
        raise RuntimeError("banded_align_batch: cigar buffer overflow")
    raw = cig_buf.raw
    cigars = [raw[cig_off[i]:cig_off[i + 1]].decode() for i in range(n)]
    return cigars, scores, nm


def _banded_align_numpy(q_segs, t_segs, band):
    """Slow-but-correct fallback (full DP, no banding)."""
    cigars, scores, nms = [], [], []
    for q, t in zip(q_segs, t_segs):
        cig, sc, nm = _align_numpy_one(np.asarray(q), np.asarray(t))
        cigars.append(cig)
        scores.append(sc)
        nms.append(nm)
    return cigars, np.asarray(scores, np.int32), np.asarray(nms, np.int32)


def _align_numpy_one(q, t):
    MATCH, MIS, GO, GE = 2, -4, -4, -2
    lq, lt = len(q), len(t)
    NEGV = -(1 << 28)
    M = np.full((lq + 1, lt + 1), NEGV, np.int32)
    X = np.full_like(M, NEGV)
    Y = np.full_like(M, NEGV)
    M[0, 0] = 0
    for j in range(1, lt + 1):
        Y[0, j] = GO + GE * j
    for i in range(1, lq + 1):
        X[i, 0] = GO + GE * i
        for j in range(1, lt + 1):
            s = MATCH if (q[i-1] == t[j-1] and q[i-1] < 4) else MIS
            M[i, j] = max(M[i-1, j-1], X[i-1, j-1], Y[i-1, j-1]) + s
            X[i, j] = max(M[i-1, j] + GO + GE, X[i-1, j] + GE,
                          Y[i-1, j] + GO + GE)
            Y[i, j] = max(M[i, j-1] + GO + GE, Y[i, j-1] + GE,
                          X[i, j-1] + GO + GE)
    i, j = lq, lt
    sc = max(M[i, j], X[i, j], Y[i, j])
    state = 0 if sc == M[i, j] else (1 if sc == X[i, j] else 2)
    ops = []
    nm = 0
    while i > 0 or j > 0:
        if i == 0:
            ops.append("D"); j -= 1; nm += 1; continue
        if j == 0:
            ops.append("I"); i -= 1; nm += 1; continue
        if state == 0:
            eq = q[i-1] == t[j-1] and q[i-1] < 4
            ops.append("=" if eq else "X")
            nm += 0 if eq else 1
            prev = max(M[i-1, j-1], X[i-1, j-1], Y[i-1, j-1])
            state = 0 if prev == M[i-1, j-1] else (1 if prev == X[i-1, j-1] else 2)
            i -= 1; j -= 1
        elif state == 1:
            ops.append("I"); nm += 1
            state = 1 if X[i, j] == X[i-1, j] - 2 else 0
            i -= 1
        else:
            ops.append("D"); nm += 1
            state = 2 if Y[i, j] == Y[i, j-1] - 2 else 0
            j -= 1
    ops.reverse()
    cig = ""
    k = 0
    while k < len(ops):
        op = ops[k]
        run = 0
        while k < len(ops) and ops[k] == op:
            run += 1; k += 1
        cig += f"{run}{op}"
    return cig, int(sc), nm


# ---------------------------------------------------------------------------
# One-vs-all exhaustive whitelist scorer (whitelist_verify.cpp), the host
# twin of csrc/verify.cu. Returns None when the library is unavailable
# (callers then run the plain torch DP).

def wl_verify_all(q: np.ndarray, qlen: np.ndarray, coresT: np.ndarray,
                  pad_left: int, pad_right: int,
                  n_threads: int | None = None):
    """q: (C, Lq) int8; qlen: (C,) int32; coresT: (m, R) int8, every row
    live. Returns (best, bidx_smallest, nties) int32 arrays or None."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, np.int8)
    qlen = np.ascontiguousarray(qlen, np.int32)
    coresT = np.ascontiguousarray(coresT, np.int8)
    C, Lq = q.shape
    m, R = coresT.shape
    # the scorer reads q[i, :qlen[i]] and every row of coresT
    if qlen.shape != (C,) or (C and int(qlen.max()) > Lq):
        raise ValueError(f"qlen must be (C,) = ({C},) with values <= "
                         f"Lq = {Lq}")
    best = np.empty(C, np.int32)
    bidx = np.empty(C, np.int32)
    nties = np.empty(C, np.int32)
    if n_threads is None:
        n_threads = torch.get_num_threads()
    rc = lib.wl_verify_all(
        q.ctypes.data, qlen.ctypes.data, C, Lq,
        coresT.ctypes.data, R, m, int(pad_left), int(pad_right),
        best.ctypes.data, bidx.ctypes.data, nties.ctypes.data,
        int(n_threads))
    if rc != 0:
        return None
    return best, bidx, nties
