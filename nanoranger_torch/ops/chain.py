"""Windowed colinear chain DP: the Hopper kernel and its plain version.

Counterpart of the JAX package's ops/pallas_chain.py (the kernel) and
align/aligner.py::_chain_dp_xla (the recurrence). Over
(seg, t, q)-sorted anchors of each read, anchor i looks back over the G = 64
anchors before it; only predecessors of the same seg count, with the
minimap2 chain score min(dq, dt, k) - (0.01*k*dd + 0.5*log2(dd)) under gap
and band limits. The parent is the LAST argmax of the window (torch.argmax
returns the first, so neither version uses it) and the chain root is
carried along.

max_intron > 0 adds the minimap2 `-x splice` intron class: a predecessor
with a small query gap (0 < dq <= max_gap) and a target gap beyond the band
(bandwidth < dt - dq, dt <= max_intron) costs
0.01*k*dq + splice_pen + 0.5*log2(dt - dq); where both classes admit a
predecessor the map-ont one counts.

`chain_dp` launches csrc/chain.cu for CUDA tensors and runs `chain_dp_plain`
for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import torch

from .. import kernels

G = 64
NEGF = -1e18


def chain_dp_plain(t, q, seg, valid, k_span: int, max_gap: int,
                   bandwidth: int, max_intron: int = 0,
                   splice_pen: float = 6.0):
    """t, q, seg: (B, A) int32 sorted anchors; valid: (B, A) bool.
    Returns (f (B, A) float32, parent (B, A) int32, root (B, A) int32)."""
    B, A = t.shape
    dev = t.device
    f32 = torch.float32
    # window = padded columns [i, i+G) == anchors [i-G, i)
    tf = torch.cat([torch.full((B, G), -3e9, dtype=f32, device=dev),
                    t.to(f32)], dim=1)
    qf = torch.cat([torch.zeros((B, G), dtype=f32, device=dev), q.to(f32)],
                   dim=1)
    sg = torch.cat([torch.full((B, G), -7, dtype=torch.int32, device=dev),
                    seg.to(torch.int32)], dim=1)
    f = torch.full((B, A + G), NEGF, dtype=f32, device=dev)
    roots = torch.full((B, A + G), -1, dtype=torch.int32, device=dev)
    parent = torch.full((B, A), -1, dtype=torch.int32, device=dev)
    sub = torch.arange(G, dtype=torch.int32, device=dev)[None, :]
    negf = torch.tensor(NEGF, dtype=f32, device=dev)
    gap_coef = 0.01 * k_span
    # past the last column valid in any row every slot keeps its initial
    # value (f NEGF, parent and root -1): the walk stops there
    live = torch.nonzero(valid.any(dim=0))
    n_cols = int(live[-1, 0]) + 1 if len(live) else 0
    for i in range(n_cols):
        wt, wq = tf[:, i:i + G], qf[:, i:i + G]
        ws, wf = sg[:, i:i + G], f[:, i:i + G]
        ti, qi = tf[:, i + G:i + G + 1], qf[:, i + G:i + G + 1]
        si = sg[:, i + G:i + G + 1]
        vi = valid[:, i:i + 1]
        dt = ti - wt
        dq = qi - wq
        dd = torch.abs(dq - dt)
        dg = torch.clamp(torch.minimum(dq, dt), max=float(k_span))
        gap = gap_coef * dd + 0.5 * torch.log2(torch.clamp(dd, min=1.0))
        gap = torch.where(dd > 0, gap, torch.zeros_like(gap))
        seg_eq = (ws == si) & (wf > NEGF / 2)
        ok = seg_eq & (dt > 0) & (dq > 0) & \
            (dt <= max_gap) & (dq <= max_gap) & (dd <= bandwidth)
        if max_intron:
            gap_s = gap_coef * dq + splice_pen + \
                0.5 * torch.log2(torch.clamp(dt - dq, min=1.0))
            ok_s = seg_eq & (dq > 0) & (dq <= max_gap) & \
                (dt - dq > bandwidth) & (dt <= max_intron)
            gap = torch.where(ok, gap, gap_s)
            ok = ok | ok_s
        cand = torch.where(ok, (wf + dg) - gap, negf)
        best = cand.max(dim=1, keepdim=True).values
        bestg = torch.where(cand == best, sub, -1).max(dim=1,
                                                       keepdim=True).values
        fi = torch.clamp(best, min=float(k_span))
        extend = best > float(k_span)
        par = torch.where(extend, i - G + bestg, -1)
        root_from_par = torch.gather(roots[:, i:i + G], 1, bestg.clamp(min=0))
        root = torch.where(extend, root_from_par, i)
        f[:, i + G:i + G + 1] = torch.where(vi, fi, negf)
        roots[:, i + G:i + G + 1] = torch.where(vi, root, -1)
        parent[:, i:i + 1] = torch.where(vi, par, -1)
    return f[:, G:].contiguous(), parent, roots[:, G:].contiguous()


def chain_dp(t, q, seg, valid, k_span: int, max_gap: int, bandwidth: int,
             max_intron: int = 0, splice_pen: float = 6.0):
    """Chain DP of (B, A) sorted anchors: the Hopper kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if not t.is_cuda:
        return chain_dp_plain(t, q, seg, valid, k_span, max_gap, bandwidth,
                              max_intron, splice_pen)
    B, A = t.shape
    if k_span <= 0 or bandwidth > 10239:
        raise ValueError("the chain kernel takes k_span > 0 and bandwidth "
                         "<= 10239 (its log2 table), got "
                         f"k_span={k_span}, bandwidth={bandwidth}")
    for name, x, dt in (("t", t, torch.int32), ("q", q, torch.int32),
                        ("seg", seg, torch.int32),
                        ("valid", valid, torch.bool)):
        kernels.check(x, name, dt, (B, A))
    f = torch.empty((B, A), dtype=torch.float32, device=t.device)
    parent = torch.empty((B, A), dtype=torch.int32, device=t.device)
    root = torch.empty((B, A), dtype=torch.int32, device=t.device)
    fn = kernels.entry("chain", "chain_dp", 7, 6, n_float=1)
    kernels.launch("chain", fn, t, q, seg, valid, f, parent, root, B, A,
                   int(k_span), int(max_gap),
                   int(bandwidth), int(max_intron), float(splice_pen),
                   counter="chain_splice" if max_intron > 0 else "chain")
    return f, parent, root
