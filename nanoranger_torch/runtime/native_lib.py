"""Build + ctypes binding of the host C++ banded aligner.

Counterpart of the JAX package's runtime/native_lib.py, of which it keeps
`banded_align_batch` (base-level global alignment with traceback, for the
clonotyper's frame pinning and later the BAM boundary) and its numpy twin.
This is host code in both packages, not a device kernel. The fastq reader
and the whitelist scorer of the JAX package's native library are not
carried: the port has its own parser and runs the one-vs-all DP on the
card.

The library is built by g++ at first use into `_build/` beside the
package (keyed by a digest of the source) and loaded with ctypes; when no
compiler is available the numpy version runs instead, as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "runtime", "native", "banded_align.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_tried = False


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_PKG, "_build", f"host_{h.hexdigest()[:16]}",
                        "libnrnative.so")


def _build(dst: str) -> bool:
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    tmp = f"{dst}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(tmp, dst)
    return True


def get_lib():
    """The loaded library, or None when it cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _lib_path()
    if not os.path.isfile(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.banded_align_batch.restype = ctypes.c_int
    lib.banded_align_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return _lib


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
