"""Banded global affine alignment with traceback -> CIGAR, for a batch of
(query segment, target segment) pairs: the genome stage's exon blocks and
the clonotyper's V spans.

`banded_align(q_segs, t_segs, band, device)` returns what
`runtime/native_lib.banded_align_batch` returns, (cigars list[str], scores
(n,) int32, nm (n,) int32), bit for bit. The route follows `device`: on a
CUDA device the batch goes through csrc/banded_cigar.cu, anywhere else
through the host C++ routine (runtime/native/banded_align.cpp), which is
the kernel's plain version and its oracle. Counters (trace.py):
banded.device_segments and banded.host_segments, the segments each route
aligned.

The kernel's layout: every segment's bases sit in one int8 buffer (queries,
then targets); a (n, 7) int64 meta row holds each segment's offsets and
lengths, the offset of its traceback bytes ((lq + 1) * bw, bw = 2 *
max(band, |lq - lt| + 16) + 1) in the launch's buffer, of its CIGAR slot
(2 * (lq + lt) bytes) and of its DP rows (3 * bw int32). Segments whose
traceback would pass TB_CAP bytes in one launch go into the next launch,
which reuses the buffer, so the card holds at most TB_CAP bytes of
traceback (or one segment's, where that is more).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels, trace
from ..runtime.native_lib import banded_align_batch

TB_CAP = 1 << 26          # traceback bytes a launch may hold (64 MiB)
WARPS = 4                 # segments a block


def banded_align(q_segs: list, t_segs: list, band: int, device):
    """Align each query segment to its target segment (global, affine,
    banded) on `device`. Segments are int8 base-code arrays."""
    n = len(q_segs)
    if torch.device(device).type != "cuda":
        trace.count("banded.host_segments", n)
        return banded_align_batch(q_segs, t_segs, band=band)
    trace.count("banded.device_segments", n)
    if n == 0:
        return [], np.zeros(0, np.int32), np.zeros(0, np.int32)
    return _banded_cuda(q_segs, t_segs, band, torch.device(device))


def _exclusive_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a), np.int64)
    np.cumsum(a[:-1], out=out[1:])
    return out


def _launches(tb_n: np.ndarray):
    """(start, end) runs of the segments, each holding at most TB_CAP
    traceback bytes or one segment."""
    runs, s = [], 0
    while s < len(tb_n):
        e, total = s, 0
        while e < len(tb_n) and (e == s or total + tb_n[e] <= TB_CAP):
            total += int(tb_n[e])
            e += 1
        runs.append((s, e))
        s = e
    return runs


def _banded_cuda(q_segs, t_segs, band, dev):
    n = len(q_segs)
    q_len = np.fromiter(map(len, q_segs), np.int64, n)
    t_len = np.fromiter(map(len, t_segs), np.int64, n)
    # one pad byte first, so that the buffer is never empty
    seq = np.concatenate([np.zeros(1, np.int8)]
                         + [s.astype(np.int8) for s in q_segs]
                         + [s.astype(np.int8) for s in t_segs])
    q_off = 1 + _exclusive_cumsum(q_len)
    t_off = 1 + int(q_len.sum()) + _exclusive_cumsum(t_len)
    bw = 2 * np.maximum(band, np.abs(q_len - t_len) + 16) + 1
    tb_n = np.where((q_len == 0) & (t_len == 0), 0, (q_len + 1) * bw)
    slot = 2 * (q_len + t_len)
    row_n = 3 * bw
    runs = _launches(tb_n)
    tb_off = np.zeros(n, np.int64)
    row_off = np.zeros(n, np.int64)
    for s, e in runs:
        tb_off[s:e] = _exclusive_cumsum(tb_n[s:e])
        row_off[s:e] = _exclusive_cumsum(row_n[s:e])
    meta = np.stack([q_off, q_len, t_off, t_len, tb_off,
                     _exclusive_cumsum(slot), row_off], 1)

    seq_d = torch.from_numpy(seq).to(dev)
    meta_d = torch.from_numpy(np.ascontiguousarray(meta)).to(dev)
    tb_d = torch.empty(max(max(int(tb_n[s:e].sum()) for s, e in runs), 1),
                       dtype=torch.uint8, device=dev)
    rows_d = torch.empty(max(int(row_n[s:e].sum()) for s, e in runs),
                         dtype=torch.int32, device=dev)
    text_d = torch.empty(max(int(slot.sum()), 1), dtype=torch.uint8,
                         device=dev)
    out_d = torch.empty((n, 4), dtype=torch.int32, device=dev)
    fn = kernels.entry("banded", "banded_cigar", 6, 3)
    for s, e in runs:
        kernels.launch("banded", fn, seq_d, meta_d[s:e], tb_d, rows_d,
                       text_d, out_d[s:e], e - s, int(band), WARPS)
    res = out_d.cpu().numpy()
    text = text_d.cpu().numpy().tobytes()
    # the host routine's text buffer and its refusal when it overflows
    cap = int(q_len.sum() + t_len.sum() + 16 * n + 1024)
    if int(res[:, 3].sum()) > cap:
        raise RuntimeError("banded_align_batch: cigar buffer overflow")
    cigars = [text[a:a + k].decode()
              for a, k in zip(res[:, 2].tolist(), res[:, 3].tolist())]
    return cigars, res[:, 0].copy(), res[:, 1].copy()
