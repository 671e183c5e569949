"""Bounded edit-distance infix search — the adapter-motif scanner.

Counterpart of the JAX package's ops/edit_distance.py (semantics and
the plain recurrence) and ops/pallas_ed.py (the kernels).
Replaces edlib.align(pattern, window, 'HW', 'locations', k[, ad_seq]):

- 'HW' (infix) mode: pattern fully consumed, text flanks free.
- k cutoff: distance > k reports no hit (-1).
- N wildcards: with `wildcard=True` N in either sequence matches any base.
- locations: ends ascend; `pick_last` picks the last optimal end (5'
  modes) instead of the first, and for that end the start is the SMALLEST
  optimal start (edlib aligns the reversed pattern in SHW mode).

The row recurrence D[i][j] = min(D[i-1][j-1] + c, D[i-1][j] + 1,
D[i][j-1] + 1) collapses, because horizontal moves cost exactly 1, to a
prefix-min: row = cummin(t - iota) + iota with t[j] = min(prev[j-1] + c,
prev[j] + 1).

`hw_locate` launches csrc/ed.cu for CUDA tensors and runs `hw_locate_plain`
for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..io.encode import N as N_CODE
from ..io.encode import PAD as PAD_CODE

BIG = 1 << 20
MAX_KERNEL_WIDTH = 512     # csrc/ed.cu: 64 rows of W bytes staged a block


def _match_mask(p_char: int, t_chars, wildcard: bool):
    """True where pattern char aligns with text char at cost 0."""
    eq = t_chars == p_char
    if wildcard:
        eq = eq | (t_chars == N_CODE) | (p_char == N_CODE)
    # PAD never matches anything (even pattern N)
    return eq & (t_chars != PAD_CODE)


def _rows_scan(pattern: list, texts, init_row, wildcard: bool):
    """Run the m-row DP; returns the final row (B, W+1). init_row encodes
    the mode (HW: D[0][j] = 0, SHW: D[0][j] = j); D[i][0] = i."""
    B, W = texts.shape
    iota = torch.arange(W + 1, dtype=torch.int32, device=texts.device)[None]
    row = init_row
    for i, p_char in enumerate(pattern, start=1):
        c = torch.where(_match_mask(p_char, texts, wildcard), 0, 1)
        t = torch.minimum(row[:, :-1] + c, row[:, 1:] + 1)
        t = torch.cat([torch.full((B, 1), i, dtype=torch.int32,
                                  device=texts.device), t.to(torch.int32)],
                      dim=1)
        row = torch.cummin(t - iota, dim=1).values + iota
    return row


def hw_locate_plain(pattern, texts, lengths, k: int, wildcard: bool = False,
                    pick_last: bool = False):
    """Plain torch version of the batched edlib-HW 'locations' search.

    pattern: (m,) int8 codes; texts: (B, W) int8, PAD beyond each row's
    length; lengths: (B,) int32. Returns (dist, start, end) int32 (B,):
    dist = -1 where the best distance exceeds k; start/end (end INCLUSIVE)
    are the edlib location pair of the chosen end, -1 without a hit."""
    pat = [int(x) for x in pattern.tolist()]
    texts = texts.to(torch.int32)
    lengths = lengths.to(torch.int32)
    B, W = texts.shape
    dev = texts.device
    iota = torch.arange(W + 1, dtype=torch.int32, device=dev)[None]

    # forward HW pass: best distance + optimal ends
    final = _rows_scan(pat, texts, torch.zeros((B, W + 1), dtype=torch.int32,
                                               device=dev), wildcard)
    valid = (iota >= 1) & (iota <= lengths[:, None])
    scores = torch.where(valid, final, BIG)
    dist = scores.min(dim=1).values
    is_opt = scores == dist[:, None]
    col = iota.expand(B, W + 1)
    end_first = torch.where(is_opt, col, BIG).min(dim=1).values - 1
    end_last = torch.where(is_opt, col, -1).max(dim=1).values - 1
    end = end_last if pick_last else end_first

    # anchored reverse SHW pass: smallest optimal start for `end`
    x = torch.arange(W, dtype=torch.int32, device=dev)[None]
    src = (end[:, None] - x).clamp(0, W - 1).long()
    rtexts = torch.gather(texts, 1, src)
    rtexts = torch.where(x <= end[:, None], rtexts, PAD_CODE)
    rfinal = _rows_scan(pat[::-1], rtexts,
                        iota.expand(B, W + 1).contiguous(), wildcard)
    rvalid = (iota >= 1) & (iota <= end[:, None] + 1)
    ropt = (torch.where(rvalid, rfinal, BIG) == dist[:, None])
    x_max = torch.where(ropt, col, 0).max(dim=1).values - 1
    start = end - x_max

    hit = dist <= k
    neg = torch.full_like(dist, -1)
    return (torch.where(hit, dist, neg), torch.where(hit, start, neg),
            torch.where(hit, end, neg))


def hw_locate(pattern, texts, lengths, k: int, wildcard: bool = False,
              pick_last: bool = False):
    """(dist, start, end) of the motif in each text row: csrc/ed.cu on
    CUDA tensors, the plain version on CPU tensors."""
    if not texts.is_cuda:
        return hw_locate_plain(pattern, texts, lengths, k, wildcard,
                               pick_last)
    R, W = texts.shape
    m = int(pattern.shape[0])
    if not 1 <= W <= MAX_KERNEL_WIDTH or not 1 <= m <= 64:
        raise ValueError(f"hw_locate kernel takes 1 <= W <= "
                         f"{MAX_KERNEL_WIDTH} and 1 <= m <= 64, got W={W}, "
                         f"m={m}")
    kernels.check(pattern, "pattern", torch.int8, (m,))
    kernels.check(texts, "texts", torch.int8, (R, W))
    kernels.check(lengths, "lengths", torch.int32, (R,))
    dist = torch.empty(R, dtype=torch.int32, device=texts.device)
    start = torch.empty_like(dist)
    end = torch.empty_like(dist)
    fn = kernels.entry("ed", "hw_locate", 6, 6)
    kernels.launch("ed", fn, pattern, texts, lengths, dist, start, end, m,
                   R, W, int(k), int(bool(wildcard)),
                   int(bool(pick_last)))
    return dist, start, end
