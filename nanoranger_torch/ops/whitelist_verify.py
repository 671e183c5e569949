"""Exhaustive one-vs-all whitelist scoring — the STAR-parity closer.

Counterpart of the JAX package's ops/whitelist_verify.py. Scores ONE BC-UMI
candidate against EVERY padded whitelist row exactly (match +1, mismatch
-1, linear indels -1, N neutral, free ref flanks, end-to-end query) and
reduces to (best score, smallest best index, number of best-scoring rows).

The DP is "flipped": the state is the (core_len)-column band profile of a
whitelist row, and the loop runs over query positions. N-pad columns
outside the core have closed forms:

    H_t[0]  = -max(0, t - pad_left)                    (prefix-N entry)
    H_0[j]  = 0                                        (free ref start)
    H_t[j]  = max(H_{t-1}[j-1] + s(q_t, core_j),       (diag)
                  H_{t-1}[j] - 1,                      (query insertion)
                  H_t[j-1] - 1)                        (core deletion)
    score   = max( max_j H_qlen[j],                    (end anywhere)
                   max_t H_t[m] - max(0, (qlen-t) - pad_right) )
                                                       (suffix-N runout)

Reverse-strand scoring needs no second table:
score(q, revcomp(row)) == score(revcomp(q), row).

`verify_all` launches csrc/verify.cu for CUDA tensors and runs
`verify_all_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..io.encode import N as N_CODE
from ..io.encode import PAD as PAD_CODE

NEG = -(1 << 20)
BIG = 1 << 30


def _sub_scores_t(qt, core):
    """(C,) query chars at step t vs (m, R) core chars -> (C, m, R)."""
    qt = qt[:, None, None]
    c = core[None, :, :]
    s = torch.where(qt == c, 1, -1)
    s = torch.where((qt == N_CODE) | (c == N_CODE), 0, s)
    s = torch.where((qt == PAD_CODE) | (c == PAD_CODE), -1, s)
    return s.to(torch.int32)


def _verify_chunk(q, qlen, core, pad_left: int, pad_right: int):
    """Exact scores (C, R) of q (C, Lq) int32 against core (m, R) int32."""
    C, Lq = q.shape
    m, R = core.shape
    dev = q.device
    jvec = torch.arange(1, m + 1, dtype=torch.int32, device=dev)[None, :, None]
    H = torch.zeros((C, m, R), dtype=torch.int32, device=dev)
    ql = qlen[:, None]
    best_a = torch.where(ql == 0, 0, NEG).to(torch.int32).expand(C, R)
    best_b = (-(ql - pad_right).clamp(min=0)).to(torch.int32).expand(C, R)
    # steps past a row's qlen change neither best: stop at the longest
    for t in range(1, int(qlen.max()) + 1 if C else 1):
        s = _sub_scores_t(q[:, t - 1], core)
        b_prev = -max(t - 1 - pad_left, 0)
        b_cur = -max(t - pad_left, 0)
        diag_src = torch.cat(
            [torch.full((C, 1, R), b_prev, dtype=torch.int32, device=dev),
             H[:, :-1, :]], dim=1)
        tmp = torch.maximum(diag_src + s, H - 1)
        A = torch.clamp(tmp + jvec, min=b_cur)
        H = torch.cummax(A, dim=1).values - jvec
        hmax = torch.clamp(H.max(dim=1).values, min=b_cur)
        best_a = torch.where(ql == t, torch.maximum(best_a, hmax), best_a)
        comp = -(ql - t - pad_right).clamp(min=0)
        best_b = torch.where(ql >= t, torch.maximum(best_b, H[:, m - 1] + comp),
                             best_b)
    return torch.maximum(best_a, best_b)


def verify_all_plain(q, qlen, coreT, r_valid: int, pad_left: int,
                     pad_right: int, r_chunk: int = 65536):
    """Plain torch version: q (C, Lq) int8, qlen (C,) int32, coreT (m, R)
    int8 core columns (transposed); rows at index >= r_valid never win.
    Returns (best, smallest argmax, n_ties) int32 (C,)."""
    C = q.shape[0]
    m, R = coreT.shape
    dev = q.device
    q32 = q.to(torch.int32)
    ql = qlen.to(torch.int32)
    best = torch.full((C,), NEG, dtype=torch.int32, device=dev)
    idx = torch.full((C,), -1, dtype=torch.int32, device=dev)
    nbest = torch.zeros((C,), dtype=torch.int32, device=dev)
    for rs in range(0, R, r_chunk):
        core = coreT[:, rs:rs + r_chunk].to(torch.int32)
        sc = _verify_chunk(q32, ql, core, pad_left, pad_right)
        col = torch.arange(core.shape[1], dtype=torch.int32, device=dev)[None]
        sc = torch.where(col < r_valid - rs, sc, NEG)
        b = sc.max(dim=1).values
        is_best = sc == b[:, None]
        n = is_best.sum(dim=1).to(torch.int32)
        i = torch.where(is_best, col + rs, BIG).min(dim=1).values
        i = torch.where(b > NEG, i, -1).to(torch.int32)
        take = b > best
        tie = b == best
        nbest = torch.where(take, n, torch.where(tie, nbest + n, nbest))
        idx = torch.where(take, i, torch.where(tie, torch.minimum(idx, i),
                                               idx))
        best = torch.maximum(best, b)
    return best, idx, nbest


def verify_all(q, qlen, coreT, r_valid: int, pad_left: int, pad_right: int):
    """(best, smallest argmax, n_ties) of each candidate against every
    whitelist row: csrc/verify.cu on CUDA tensors, the plain version on
    CPU tensors."""
    if not q.is_cuda:
        return verify_all_plain(q, qlen, coreT, r_valid, pad_left, pad_right)
    C, Lq = q.shape
    m, R = coreT.shape
    if m not in (16, 32) or Lq > 128:
        raise ValueError(f"verify kernel takes core length 16 or 32 and "
                         f"Lq <= 128, got m={m}, Lq={Lq}")
    kernels.check(q, "q", torch.int8, (C, Lq))
    kernels.check(qlen, "qlen", torch.int32, (C,))
    kernels.check(coreT, "coreT", torch.int8, (m, R))
    nb = -(-R // 256)                       # csrc/verify.cu: 256 rows a block
    best_b = torch.empty((nb, C), dtype=torch.int32, device=q.device)
    idx_b = torch.empty_like(best_b)
    ties_b = torch.empty_like(best_b)
    fn = kernels.entry("verify", "verify_all", 6, 7)
    kernels.launch("verify", fn, q, qlen, coreT, best_b, idx_b, ties_b, C,
                   Lq, m, R, int(r_valid),
                   int(pad_left), int(pad_right))
    # cross-block merge: best is a max, ties sum at the best, and the
    # smallest row index at the best wins
    best = best_b.max(dim=0).values
    sel = best_b == best[None]
    ties = torch.where(sel, ties_b, 0).sum(dim=0).to(torch.int32)
    idx = torch.where(sel, idx_b, BIG).min(dim=0).values
    idx = torch.where(best > NEG, idx, -1).to(torch.int32)
    return best, idx, ties
