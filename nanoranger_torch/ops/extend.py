"""Base-level extension of chain ends (minimap2's extension DP analogue).

Counterpart of the JAX package's ops/extend.py. The seed-chain aligner's
qstart/qend/tstart/tend come from terminal minimizer anchors, a ±~w(=10nt)
drift from minimap2's base-exact spans. For each record end, the query
flank beyond the terminal anchor is DP-aligned against the reference flank
with FREE far ends, and the max-scoring cell gives the (query, target)
extension lengths. Scoring is minimap2 map-ont-flavored (match 2, mismatch
-4, gap -4 linear) over short flanks (F <= 48): plain torch ops, one row
step per query base over all record ends at once.

extend_spans is the one extension loop. Its two callers are adapters: the
fused step's slots (stages/cli_step._extend_slots) and the unfused path's
AlignmentRecords (extend_records_host), both on the reads' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.encode import COMPLEMENT

MATCH = 2
MIS = -4
GAP = -4
F_EXT = 48         # flank length examined beyond each terminal anchor
NEGI = -(1 << 20)


def extend_scores(q, qlen, t, tlen, F: int = F_EXT):
    """q, t: (N, F) int8 flanks oriented AWAY from the chain end (position
    0 adjoins the terminal anchor). qlen/tlen: valid lengths.
    Returns (q_ext, t_ext): per row, the (i, j) of the max-scoring DP cell
    — #query / #target bases the alignment extends. Ties prefer smaller
    i+j then smaller i (a zero-length extension scores 0, so extension
    happens only when bases actually align)."""
    N = q.shape[0]
    dev = q.device
    i32 = torch.int32
    q = q.to(i32)
    t = t.to(i32)
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    jj = torch.arange(F + 1, dtype=i32, device=dev)[None]
    row = torch.where(jj <= tlen[:, None], GAP * jj, NEGI).to(i32)  # H[0, :]
    best = torch.zeros(N, dtype=i32, device=dev)    # H[0,0] = 0 baseline
    bi = torch.zeros(N, dtype=i32, device=dev)
    bj = torch.zeros(N, dtype=i32, device=dev)
    for i in range(1, F + 1):
        qi = q[:, i - 1:i]
        sub = torch.where((qi == t[:, :F]) & (qi < 4) & (qi >= 0), MATCH, MIS)
        diag = row[:, :-1] + sub                      # H[i-1,j-1]+s
        up = row[:, 1:] + GAP                         # H[i-1,j]+g
        new = torch.maximum(diag, up)
        head = torch.where(i <= qlen, GAP * i, NEGI)[:, None]   # H[i,0]
        shifted = torch.cat([head.to(i32), new.to(i32)], dim=1)
        # left gaps: H[i,j] = max(new[j], H[i,j-1]+GAP) — running max of
        # (new[j] - GAP*j) + GAP*j
        rowi = torch.cummax(shifted - GAP * jj, dim=1).values + GAP * jj
        rowi = torch.where((jj <= tlen[:, None]) & (i <= qlen[:, None]),
                           rowi, NEGI).to(i32)
        # track the best cell (score desc, i+j asc, i asc)
        rbest = rowi.max(dim=1).values
        rj = (rowi == rbest[:, None]).to(i32).argmax(dim=1)     # first j
        better = rbest > best
        best = torch.where(better, rbest, best)
        bi = torch.where(better, i, bi)
        bj = torch.where(better, rj.to(i32), bj)
        row = rowi
    return bi, bj


def extend_spans(codes, read_idx, rlen, strand, ref_id, spans, active,
                 ref_flat, ref_off, ref_lens, F: int = F_EXT,
                 rounds: int = 4):
    """The extension of chain ends, the one routine: rows are records,
    read_idx (R,) maps each to its row of `codes` (B, L) int8 and rlen (R,)
    gives that read's length; spans = (s_qs, s_qe, ts, te), each (R,),
    the stored-orientation query span and the reference span of each
    record on reference ref_id (R,) of strand (R,). The reference is
    ref_flat with each reference's offset ref_off and length ref_lens
    (PanelIndex.ref_tensors). Every tensor is on the reads' device.

    Each round runs extend_scores over both ends of every row at once and
    moves the spans of the `active` rows; an end that consumed (nearly) the
    whole flank may still have drift left, so its row stays active and
    re-extends from the new boundary (each round must independently gain
    score; rounds*F bounds the total drift covered). A round after the
    first runs only while some row is active (one host read of
    `active.any()`): the rounds after none is change nothing.

    Returns the extended (s_qs, s_qe, ts, te)."""
    L = codes.shape[1]
    dev = codes.device
    R = read_idx.shape[0]
    s_qs, s_qe, ts, te = spans
    rid = ref_id.long()
    roff = ref_off[rid]
    rl = ref_lens[rid]

    comp = torch.from_numpy(COMPLEMENT).to(dev)
    jj = torch.arange(F, dtype=torch.int32, device=dev)[None]
    rev = strand[:, None] == 1
    neg = torch.tensor(-1, dtype=torch.int8, device=dev)

    def stored_gather(x):
        """stored-orientation bases at read positions x (R, F)."""
        xc = x.clamp(0, L - 1)
        pos = torch.where(rev, rlen[:, None] - 1 - xc, xc).clamp(0, L - 1)
        v = codes[read_idx[:, None], pos.long()]
        return torch.where(rev, comp[v.long()], v)

    def ref_gather(y):
        yc = (roff[:, None] + y.clamp(min=0)).clamp(0, ref_flat.shape[0] - 1)
        return ref_flat[yc.long()]

    for rnd in range(rounds):
        if rnd and not bool(active.any()):
            break
        lo_qn = s_qs.clamp(max=F)
        lo_tn = ts.clamp(max=F)
        hi_qn = (rlen - s_qe).clamp(0, F)
        hi_tn = (rl - te).clamp(0, F)
        q_lo = torch.where(jj < lo_qn[:, None],
                           stored_gather(s_qs[:, None] - 1 - jj), neg)
        t_lo = torch.where(jj < lo_tn[:, None],
                           ref_gather(ts[:, None] - 1 - jj), neg)
        q_hi = torch.where(jj < hi_qn[:, None],
                           stored_gather(s_qe[:, None] + jj), neg)
        t_hi = torch.where(jj < hi_tn[:, None],
                           ref_gather(te[:, None] + jj), neg)
        qf = torch.cat([q_lo, q_hi]).to(torch.int8)
        tf = torch.cat([t_lo, t_hi]).to(torch.int8)
        qn = torch.cat([lo_qn, hi_qn]).to(torch.int32)
        tn = torch.cat([lo_tn, hi_tn]).to(torch.int32)
        bi, bj = extend_scores(qf, qn, tf, tn, F=F)
        qi_l, qi_r = bi[:R], bi[R:]
        tj_l, tj_r = bj[:R], bj[R:]
        s_qs = torch.where(active, s_qs - qi_l, s_qs)
        s_qe = torch.where(active, s_qe + qi_r, s_qe)
        ts = torch.where(active, ts - tj_l, ts)
        te = torch.where(active, te + tj_r, te)
        capped = ((qi_l >= F - 4) | (tj_l >= F - 4) |
                  (qi_r >= F - 4) | (tj_r >= F - 4)) & \
            ((qi_l + qi_r + tj_l + tj_r) > 0)
        active = active & capped
    return s_qs, s_qe, ts, te


def extend_records_host(rec, index, codes, lengths, device, F: int = F_EXT,
                        max_rounds: int = 4):
    """Refine the spans of AlignmentRecords `rec` in place through
    extend_spans on `device`; returns per-record (ql, tl, qr, tr) total
    extension amounts (stored-orientation left/right). codes: (B, L) int8
    reads, numpy or already on `device`; lengths: (B,) numpy."""
    R = len(rec)
    if R == 0:
        return np.zeros((0, 4), np.int32)
    dev = torch.device(device)
    rlen = np.asarray(lengths)[rec.read_idx].astype(np.int64)
    rev = rec.strand == 1
    span0 = [np.asarray(x, np.int64) for x in (
        np.where(rev, rlen - rec.qend, rec.qstart),
        np.where(rev, rlen - rec.qstart, rec.qend), rec.tstart, rec.tend)]
    if not isinstance(codes, torch.Tensor):
        codes = torch.from_numpy(np.ascontiguousarray(codes))
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)
    sqs, sqe, ts, te = (x.cpu().numpy() for x in extend_spans(
        codes.to(dev), tt(rec.read_idx), tt(rlen),
        tt(rec.strand), tt(rec.ref_id), [tt(x) for x in span0],
        torch.ones(R, dtype=torch.bool, device=dev),
        *index.ref_tensors(dev), F=F, rounds=max_rounds))
    rec.tstart, rec.tend = ts, te
    rec.qstart = np.where(rev, rlen - sqe, sqs)
    rec.qend = np.where(rev, rlen - sqs, sqe)
    return np.stack([span0[0] - sqs, span0[2] - ts, sqe - span0[1],
                     te - span0[3]], axis=1)
