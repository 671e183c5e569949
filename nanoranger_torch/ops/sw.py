"""End-to-end rescore of a candidate against a padded whitelist row — the
UMI locator of the staged match, banded and over the full row.

Counterpart of the JAX package's ops/sw.py (scoring model, dispatch, the
XLA scorer) and ops/pallas_sw.py (the full-row and the banded kernels).
Scoring replicates the reference's STAR call: query aligned end to end,
free reference flanks, match +1 / mismatch -1, N scores 0, linear gaps -1.

`sw_end2end` is the general entry: without `pad_left` it scores against the
full rows as given (csrc/sw_full.cu on CUDA tensors, `sw_end2end_plain` on
CPU tensors); with `pad_left` it takes the banded route below.

A padded whitelist row is N*c_lo + core + N*(Lr - c), so only the band
columns c_lo..c need DP; the N columns outside have closed forms:

    entry       F[i][c_lo]   = -max(0, i - c_lo)
    completion  from (i, c)  = -max(0, (qlen - i) - (Lr - c))
    backward    B[i][c+1]    = -max(0, (qlen - i) - (Lr - c - 1))

The UMI position is the LARGEST query index qi aligned diagonally to the
reference column c on an optimal path (the diagonal-preferring traceback),
i.e. F[qi][c] + s(q[qi], r[c]) + B[qi+1][c+1] == score.

`sw_end2end_banded` launches csrc/sw_banded.cu for CUDA tensors and runs
`sw_banded_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..io.encode import N as N_CODE
from ..io.encode import PAD as PAD_CODE

NEG = -(1 << 20)
MAX_FULL_LQ = 127          # csrc/sw_full.cu, sw_banded.cu: Lq + 1 DP rows,
                           # 4 to a lane of one warp
MAX_BANDED_NB = 64         # csrc/sw_banded.cu: band held in two registers
MAX_FULL_LR = 128          # csrc/sw_full.cu: reference row staged per pair


def _sub(qsh, rj):
    s = torch.where(qsh == rj, 1, -1)
    s = torch.where((rj == N_CODE) | (qsh == N_CODE), 0, s)
    s = torch.where((qsh == PAD_CODE) | (rj == PAD_CODE), -1, s)
    return s.to(torch.int32)


def sw_banded_plain(query, qlen, band, Lr: int, c_lo: int, c: int):
    """query (P, Lq) int8, qlen (P,) int32, band (P, c - c_lo + 1) int8 =
    reference columns c_lo..c. Returns (score, qpos, valid) (P,)."""
    P, Lq = query.shape
    dev = query.device
    CB = c - c_lo
    Wl = Lq + 2
    lane = torch.arange(Wl, dtype=torch.int32, device=dev)[None]
    ql = qlen.to(torch.int32)[:, None]
    band = band.to(torch.int32)
    # lane i (>= 1) holds q[i-1]; lane 0 and lanes past Lq hold PAD
    qsh = torch.full((P, Wl), PAD_CODE, dtype=torch.int32, device=dev)
    qsh[:, 1:Lq + 1] = query.to(torch.int32)
    row_ok = lane <= ql
    negt = torch.tensor(NEG, dtype=torch.int32, device=dev)

    def at_qlen(col):
        return torch.gather(col, 1, ql.long())[:, 0]

    col = torch.where(row_ok, -(lane - c_lo).clamp(min=0), negt)
    best = at_qlen(col)
    for jp in range(CB):
        s = _sub(qsh, band[:, jp:jp + 1])
        diag = torch.roll(col, 1, dims=1) + s
        diag[:, 0] = NEG
        t = torch.maximum(diag, col - 1)
        t[:, 0] = 0                                        # row 0 free
        col = torch.cummax(t + lane, dim=1).values - lane
        col = torch.where(row_ok, col, negt)
        best = torch.maximum(best, at_qlen(col))
    fc = col                                               # F[:, c]
    comp = -((ql - lane) - (Lr - c)).clamp(min=0)
    full = torch.where(row_ok, fc + comp, negt).max(dim=1).values
    best = torch.maximum(best, full)

    bc1 = torch.where(row_ok, -((ql - lane) - (Lr - c - 1)).clamp(min=0),
                      negt)
    s_c = _sub(qsh, band[:, CB:CB + 1])
    f_qi = torch.roll(fc, 1, dims=1)                       # lane i: F[i-1][c]
    tot = f_qi + s_c + bc1
    ok = (lane >= 1) & row_ok & (tot == best[:, None])
    qpos = torch.where(ok, lane - 1, -1).max(dim=1).values
    valid = qpos >= 0
    return best.to(torch.int32), qpos.to(torch.int32), valid


def sw_end2end_banded(query, qlen, band, Lr: int, c_lo: int, c: int):
    """(score, qpos, valid) of each candidate against its band: the Hopper
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if not query.is_cuda:
        return sw_banded_plain(query, qlen, band, Lr, c_lo, c)
    P, Lq = query.shape
    nb = c - c_lo + 1
    if not (1 <= nb <= MAX_BANDED_NB and 1 <= Lq <= MAX_FULL_LQ):
        raise ValueError(f"sw_banded kernel takes 1 <= band columns <= "
                         f"{MAX_BANDED_NB} and 1 <= Lq <= {MAX_FULL_LQ}, got "
                         f"{nb} and Lq={Lq}")
    kernels.check(query, "query", torch.int8, (P, Lq))
    kernels.check(qlen, "qlen", torch.int32, (P,))
    kernels.check(band, "band", torch.int8, (P, nb))
    score = torch.empty(P, dtype=torch.int32, device=query.device)
    qpos = torch.empty_like(score)
    valid = torch.empty(P, dtype=torch.bool, device=query.device)
    fn = kernels.entry("sw", "sw_banded", 6, 6)
    kernels.launch("sw", fn, query, qlen, band, score, qpos, valid, P, Lq,
                   nb, int(Lr), int(c_lo), int(c))
    return score, qpos, valid


def sw_end2end_plain(query, qlen, refs, rlen, umi_ref_offset: int):
    """Plain torch version of the full-row scorer. query (P, Lq) int8, qlen
    (P,) int32, refs (P, Lr) int8 (PAD beyond rlen), rlen (P,) int32.
    Returns (score, qpos, valid) (P,): the best end-to-end score, the
    largest query index aligned diagonally to reference column
    `umi_ref_offset` on an optimal path (-1 if none), and whether there is
    one."""
    P, Lq = query.shape
    Lr = refs.shape[1]
    c = int(umi_ref_offset)
    if not 0 <= c < Lr:
        raise ValueError(f"umi_ref_offset {c} outside the {Lr} reference "
                         "columns")
    dev = query.device
    Wl = Lq + 1
    lane = torch.arange(Wl, dtype=torch.int32, device=dev)[None]
    ql = qlen.to(torch.int32)[:, None]
    rl = rlen.to(torch.int32)[:, None]
    refs = refs.to(torch.int32)
    # lane i (>= 1) holds q[i-1]; lane 0 holds PAD
    qsh = torch.full((P, Wl), PAD_CODE, dtype=torch.int32, device=dev)
    qsh[:, 1:] = query.to(torch.int32)
    row_ok = lane <= ql
    negt = torch.tensor(NEG, dtype=torch.int32, device=dev)

    def at_qlen(col):
        return torch.gather(col, 1, ql.long())[:, 0]

    # forward: col = F[:, j] entering column j
    col = torch.where(row_ok, -lane, negt)
    best = at_qlen(col)
    fc = torch.zeros_like(col)
    for j in range(Lr):
        if j == c:
            fc = col                                       # F[:, c]
        s = _sub(qsh, refs[:, j:j + 1])
        diag = torch.roll(col, 1, dims=1) + s
        diag[:, 0] = NEG
        t = torch.maximum(diag, col - 1)
        t[:, 0] = 0                                        # row 0 free
        new = torch.cummax(t + lane, dim=1).values - lane
        # columns past a pair's reference length take no part
        col = torch.where(row_ok & (j < rl), new, negt)
        best = torch.maximum(best, at_qlen(col))

    # backward: col = B[:, j+1] entering column j
    colT = torch.where(row_ok, -(ql - lane), negt)
    col = colT
    bc = colT
    for j in range(Lr - 1, -1, -1):
        if j == c:
            bc = col                                       # B[:, c+1]
        s = _sub(qsh, refs[:, j:j + 1])
        # row i consumes q[i] = qsh at lane i+1
        diag = torch.roll(col, -1, dims=1) + torch.roll(s, -1, dims=1)
        t = torch.maximum(diag, col - 1)
        t = torch.where(lane == ql, 0, t)                  # row qlen free
        t = torch.where(lane > ql, negt, t)
        rev = torch.flip(t - lane, dims=[1])
        new = torch.flip(torch.cummax(rev, dim=1).values, dims=[1]) + lane
        new = torch.where(row_ok, new, negt)
        col = torch.where(j < rl, new, colT)

    s_c = _sub(qsh, refs[:, c:c + 1])                      # lane i: q[i-1]
    tot = torch.roll(fc, 1, dims=1) + s_c + bc
    ok = (lane >= 1) & row_ok & (tot == best[:, None]) & (c < rl)
    qpos = torch.where(ok, lane - 1, -1).max(dim=1).values
    return best.to(torch.int32), qpos.to(torch.int32), qpos >= 0


def sw_end2end_full(query, qlen, refs, rlen, umi_ref_offset: int):
    """Full-row (score, qpos, valid): the Hopper kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if not query.is_cuda:
        return sw_end2end_plain(query, qlen, refs, rlen, umi_ref_offset)
    P, Lq = query.shape
    Lr = int(refs.shape[1])
    c = int(umi_ref_offset)
    if not (1 <= Lq <= MAX_FULL_LQ and 1 <= Lr <= MAX_FULL_LR
            and 0 <= c < Lr):
        raise ValueError(f"sw_full kernel takes 1 <= Lq <= {MAX_FULL_LQ}, "
                         f"1 <= Lr <= {MAX_FULL_LR} and 0 <= c < Lr, got "
                         f"Lq={Lq}, Lr={Lr}, c={c}")
    kernels.check(query, "query", torch.int8, (P, Lq))
    kernels.check(qlen, "qlen", torch.int32, (P,))
    kernels.check(refs, "refs", torch.int8, (P, Lr))
    kernels.check(rlen, "rlen", torch.int32, (P,))
    score = torch.empty(P, dtype=torch.int32, device=query.device)
    qpos = torch.empty_like(score)
    valid = torch.empty(P, dtype=torch.bool, device=query.device)
    fn = kernels.entry("sw_full", "sw_full", 7, 4)
    kernels.launch("sw_full", fn, query, qlen, refs, rlen, score, qpos,
                   valid, P, Lq, Lr, c)
    return score, qpos, valid


def sw_end2end(query, qlen, refs, rlen, umi_ref_offset: int,
               pad_left: int | None = None, full_len: int | None = None):
    """Score query[i] against refs[i] end to end and locate the UMI query
    index; tensors on one device.

    pad_left (when given) asserts the padded-whitelist structure
    N*pad_left + core + N*(Lr - umi_ref_offset): the banded route then runs
    the DP over the core columns only (refs may be the full rows or already
    the band pad_left..umi_ref_offset, with full_len the full row width).
    Without it every column of refs is scored."""
    if pad_left is None:
        return sw_end2end_full(query, qlen, refs, rlen, umi_ref_offset)
    Lr = int(full_len if full_len is not None else refs.shape[1])
    w = umi_ref_offset - pad_left + 1
    band = refs if refs.shape[1] == w else \
        refs[:, pad_left:umi_ref_offset + 1].contiguous()
    return sw_end2end_banded(query, qlen, band, Lr, pad_left,
                             umi_ref_offset)
