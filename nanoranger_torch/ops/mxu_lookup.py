"""Occurrence-window table lookup for the aligner's anchor fetch.

Counterpart of the JAX package's ops/mxu_lookup.py. That module packs the
windows as int8 byte planes so a TPU can fetch them with a one-hot matmul
or a row gather; here the windows stay plain int32 and the fetch is one
row gather.
"""

from __future__ import annotations

import numpy as np
import torch

WINDOW_BLOCK = 1 << 20    # index rows one gather of build_windows fills


def build_windows(arrays: list, occ: int, device="cpu") -> torch.Tensor:
    """Sliding windows of each (E,) int32 array, built on `device`.

    Returns (E_pad, occ, len(arrays)) int32 with row e holding, for slot j
    and array a, a[(e + j) mod E] (callers mask out-of-bucket slots); rows
    past E, up to a multiple of 128, are zero. The rows are filled
    WINDOW_BLOCK at a time from the arrays on the device, so a
    whole-transcriptome index (29M rows, 5.6 GB of windows) needs neither
    a host copy of its windows nor an (E, occ) index array."""
    E = len(arrays[0])
    E_pad = -(-E // 128) * 128
    out = torch.zeros((E_pad, occ, len(arrays)), dtype=torch.int32,
                      device=device)
    if E:
        src = torch.from_numpy(np.stack(
            [np.asarray(a).astype(np.uint32).view(np.int32) for a in arrays],
            axis=1)).to(device)
        j = torch.arange(occ, device=device)
        for e0 in range(0, E, WINDOW_BLOCK):
            e1 = min(e0 + WINDOW_BLOCK, E)
            slot = (torch.arange(e0, e1, device=device)[:, None] + j) % E
            out[e0:e1] = src[slot]
    return out


def windowed_lookup(starts, windows):
    """Device: rows windows[starts] -> (N, occ, n_arrays) int32."""
    E_pad = windows.shape[0]
    return windows[starts.clamp(0, E_pad - 1).long()]
