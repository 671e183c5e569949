"""Product-structure whitelist screen: distinct-half matmuls + pair table.

Counterpart of the JAX package's ops/product_screen.py: the host tables
(ProductTable and its helpers) are its code; the screens are torch ops on
the device of the tensors they are given, with no kernel of their own.
The half-key products are float32 matmuls of 0/1 one-hot operands: the
counts are at most 4 * l = 32, so they are exact in any accumulation.

10x barcode whitelists are combinatorial products: 737K-august-2016 has
only 1920 distinct first halves and 1536 distinct second halves. The
gather-based bucket screen (ops/seed_screen.py) pays ~500-entry bucket
gathers per (read, offset); here we instead compute, with two small
one-hot matmuls, each read's full mismatch profile against EVERY
distinct half key, take the top-T half keys per side, and join them
through a dense (n1, n2) pair → barcode-id table. Cost per batch is two
(B·O, 32) @ (32, n_distinct) matmuls + two top_k + B·T² tiny gathers —
no large gathers at all.

Recall argument: an accepted barcode (<=1 edit, AS>=14) has mm<=1 on each
half at some searched offset (offset jitter covers indels), so its half
keys rank in the per-side top-T (T=8 default) unless 8+ distinct keys tie
closer — not possible with mm<=1 vs mm>=? competitors; the exact DP
rescorer then arbitrates. Non-product or huge whitelists (pair table
> PAIR_LIMIT, where ProductTable.build returns None) take the bucket
screen instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .seed_screen import stable_top_k

PAIR_LIMIT = 32_000_000  # max dense pair-table entries (128MB int32)


@dataclasses.dataclass
class ProductTable:
    """Host-built arrays for the product screen."""
    n1: int
    n2: int
    planes1: np.ndarray      # (32 or 4*l1, n1) int8 one-hot of distinct half1
    planes2: np.ndarray
    pair: np.ndarray         # (n1, n2) int32 bc index or -1
    l1: int
    l2: int
    q_delta2: int            # query offset of half2 start minus half1 start

    @classmethod
    def build(cls, bc_codes: np.ndarray, half_bounds, q_deltas):
        (lo1, hi1), (lo2, hi2) = half_bounds
        l1, l2 = hi1 - lo1, hi2 - lo2
        k1 = _pack(bc_codes[:, lo1:hi1])
        k2 = _pack(bc_codes[:, lo2:hi2])
        u1, inv1 = np.unique(k1, return_inverse=True)
        u2, inv2 = np.unique(k2, return_inverse=True)
        if len(u1) * len(u2) > PAIR_LIMIT:
            return None
        pair = np.full((len(u1), len(u2)), -1, np.int32)
        pair[inv1, inv2] = np.arange(len(bc_codes), dtype=np.int32)
        return cls(len(u1), len(u2),
                   _onehot_planes(u1, l1), _onehot_planes(u2, l2),
                   pair, l1, l2, q_deltas[1] - q_deltas[0])

    # quarter planes (prefix/suffix split) for the indel-tolerant profile
    def split_planes(self):
        if not hasattr(self, "_split"):
            self._split = {}
            for side, (planes, l) in enumerate(
                    [(self.planes1, self.l1), (self.planes2, self.l2)]):
                h = l // 2
                self._split[side] = (planes[: 4 * h], planes[4 * h:], h)
        return self._split


def _pack(codes: np.ndarray) -> np.ndarray:
    keys = np.zeros(codes.shape[0], np.int64)
    for t in range(codes.shape[1]):
        keys = keys * 4 + codes[:, t].astype(np.int64)
    return keys


def _onehot_planes(keys: np.ndarray, l: int) -> np.ndarray:
    """(4*l, n) int8: row 4*t+base is 1 where key's base at position t
    equals base."""
    n = len(keys)
    out = np.zeros((4 * l, n), np.int8)
    for t in range(l):
        base = (keys >> (2 * (l - 1 - t))) & 3
        out[4 * t + base, np.arange(n)] = 1
    return out


def _query_onehot(q, offsets, l: int):
    """(B, O, 4l) float32 one-hot windows of q at the given offsets
    (invalid bases → zero rows)."""
    B, Lq = q.shape
    qp = torch.nn.functional.pad(q, (0, l + max(offsets) + 8), value=5)
    cols = [qp[:, o:o + l] if o >= 0
            else torch.full((B, l), 5, dtype=q.dtype, device=q.device)
            for o in offsets]
    win = torch.stack(cols, dim=1)                 # (B, O, l)
    oh = win[:, :, :, None] == torch.arange(4, dtype=win.dtype,
                                            device=q.device)
    return oh.reshape(B, len(offsets), 4 * l).to(torch.float32)


def _matches(oh, planes):
    """(..., 4l) one-hot windows @ (4l, n) planes: int32 matched bases."""
    m = oh.reshape(-1, oh.shape[-1]) @ planes.to(torch.float32)
    return m.to(torch.int32)


def product_screen(q, qlen, planes1, planes2, pair, nominal, jitter,
                   q_delta2, l1, l2, top_t=8, top_k=8):
    """Candidates via the product screen, on the device of q (the
    ProductTable's arrays as tensors on the same device).

    Per-side profile = max over offsets of
      max(full ungapped matches,
          prefix-quarter matches + best suffix-quarter matches at ±1 shift)
    — the split term keeps indel-inside-half barcodes competitive.

    Returns (cand (B, top_k) int32 [-1 none], cheap (B, top_k) matched-base
    counts)."""
    B = q.shape[0]
    q = q.to(torch.int8)
    qlen = qlen.to(torch.int32)
    offs1 = [nominal + d for d in range(-jitter, jitter + 1)]
    offs2 = [nominal + q_delta2 + d for d in range(-jitter, jitter + 1)]

    def matmul(oh, planes, n_off):
        return _matches(oh, planes).reshape(B, n_off, -1)

    def offs_ok(offs, l):
        return torch.stack([(qlen >= o + l) & (o >= 0) for o in offs],
                           dim=1)                   # (B, O)

    def side(planes, offs, l):
        O = len(offs)
        h = l // 2
        m_full = matmul(_query_onehot(q, offs, l), planes, O)
        m_pre = matmul(_query_onehot(q, offs, h), planes[: 4 * h], O)
        offs_s = [offs[0] + h - 1 + d for d in range(O + 2)]
        m_suf = matmul(_query_onehot(q, offs_s, l - h), planes[4 * h:],
                       O + 2)
        # best suffix at shifts -1/0/+1 relative to each prefix offset
        smax = torch.maximum(torch.maximum(m_suf[:, 0:O], m_suf[:, 1:O + 1]),
                             m_suf[:, 2:O + 2])
        m = torch.maximum(m_full, m_pre + smax)
        ok = offs_ok(offs, l)[:, :, None]
        m = torch.where(ok, m, 0)
        mf = torch.where(ok, m_full, 0)
        # profile (indel-tolerant) + pure ungapped max (exactness signal)
        return m.max(dim=1).values, mf.max(dim=1).values

    m1, f1 = side(planes1, offs1, l1)
    m2, f2 = side(planes2, offs2, l2)
    top_t = min(top_t, m1.shape[1], m2.shape[1])    # tiny whitelists
    # T×T pairs rank by the PURE ungapped profile (substitution cases);
    # indel cases ride the partner expansion below — the split term would
    # otherwise inflate random keys and crowd the top-T
    v1, i1 = stable_top_k(f1, top_t)                # (B, T)
    v2, i2 = stable_top_k(f2, top_t)

    # all T×T pairs through the dense pair table
    ii1 = [i1.repeat_interleave(top_t, dim=1)]      # (B, T²)
    ii2 = [i2.repeat(1, top_t)]
    vv1 = [v1.repeat_interleave(top_t, dim=1)]
    vv2 = [v2.repeat(1, top_t)]

    # partner expansion — the exact-bucket equivalent: an accepted barcode
    # has at least one EXACT half (pigeonhole); its bucket = the pair-table
    # row/column of that key. For the top-E exact-ranked keys per side,
    # take that row's (column's) validity and keep the top-RK partners by
    # the other side's (indel-tolerant) profile. This reproduces the gather
    # screen's candidate set without large gathers.
    pv = pair >= 0
    n1, n2 = pv.shape
    E, RK = min(4, n1, n2), min(12, n1, n2)
    e1v, e1i = stable_top_k(f1, E)
    e2v, e2i = stable_top_k(f2, E)
    for e in range(E):
        row_ok = pv[e1i[:, e]]                      # (B, n2)
        r2v, r2i = stable_top_k(torch.where(row_ok, m2, -1), RK)
        ii1.append(e1i[:, e:e + 1].repeat(1, RK))
        ii2.append(r2i)
        vv1.append(e1v[:, e:e + 1].repeat(1, RK))
        vv2.append(r2v)
        col_ok = pv[:, e2i[:, e]].T                 # (B, n1)
        r1v, r1i = stable_top_k(torch.where(col_ok, m1, -1), RK)
        ii1.append(r1i)
        ii2.append(e2i[:, e:e + 1].repeat(1, RK))
        vv1.append(r1v)
        vv2.append(e2v[:, e:e + 1].repeat(1, RK))

    ii1 = torch.cat(ii1, dim=1)
    ii2 = torch.cat(ii2, dim=1)
    cand = pair[ii1, ii2]                           # (B, pool) gather (tiny)
    cheap = torch.cat(vv1, dim=1) + torch.cat(vv2, dim=1)
    cheap = torch.where(cand >= 0, cheap, -1)
    topc, topi = stable_top_k(cheap, top_k)
    top_bc = torch.gather(cand, 1, topi)
    top_bc = torch.where(topc >= 0, top_bc, -1)
    return top_bc, topc


def product_screen_joint(q, qlen, planes1, planes2, pair, lo, hi,
                         q_delta2, l1, l2, top_w=8, min_joint=None,
                         chunk=16):
    """Wide-offset screen: rank half-PAIRS jointly per offset.

    The per-side top-T of product_screen breaks down over a wide offset
    range: spurious full-match halves at random offsets crowd out a true
    barcode's 7/8-match half (observed when naively widening jitter).
    Here each offset o in [lo, hi] contributes its top-2 halves PER SIDE
    at that exact offset, joined through the pair table — a spurious
    joint hit needs BOTH halves matching at a consistent spacing AND a
    real barcode pairing them, which is rare. The global top_w pairs
    across offsets feed the exact DP rescorer, by joint count descending
    and, among equal counts, in the order the offsets and pairs were
    visited (a stable sort).

    Catches >= as_min alignments ANYWHERE the N pads allow. min_joint
    (default l1+l2-2 = 14 ungapped matches) filters noise. Offsets
    process in chunked batched matmuls."""
    B, Lq = q.shape
    dev = q.device
    qlen = qlen.to(torch.int32)
    if min_joint is None:
        min_joint = l1 + l2 - 2
    offsets = list(range(lo, hi + 1))
    all_v, all_bc = [], []
    for cs in range(0, len(offsets), chunk):
        offs = offsets[cs:cs + chunk]
        O = len(offs)
        m1 = _matches(_query_onehot(q, offs, l1), planes1)    # (B*O, n1)
        m2 = _matches(_query_onehot(q, [o + q_delta2 for o in offs], l2),
                      planes2)

        # top-2 via two max/argmax reductions (argmax: the first index
        # of the largest)
        def top2(m):
            v_a, i_a = m.max(dim=1).values, m.argmax(dim=1)
            masked = torch.where(
                torch.arange(m.shape[1], device=dev)[None, :]
                == i_a[:, None], -(1 << 20), m)
            v_b, i_b = masked.max(dim=1).values, masked.argmax(dim=1)
            return (torch.stack([v_a, v_b], dim=1),
                    torch.stack([i_a, i_b], dim=1))

        v1, i1 = top2(m1)                                  # (B*O, 2)
        v2, i2 = top2(m2)
        cb = pair[i1[:, :, None], i2[:, None, :]]          # (B*O, 2, 2)
        jv = v1[:, :, None] + v2[:, None, :]
        feas = (torch.tensor(offs, dtype=torch.int32, device=dev)[None, :]
                + q_delta2 + l2 <= qlen[:, None])          # (B, O)
        jv = torch.where((cb >= 0) & feas.reshape(B * O, 1, 1)
                         & (jv >= min_joint), jv, -1)
        all_v.append(jv.reshape(B, O * 4))
        all_bc.append(cb.reshape(B, O * 4))
    cat_v = torch.cat(all_v, dim=1)
    cat_bc = torch.cat(all_bc, dim=1)
    best_v, order = stable_top_k(cat_v, top_w)
    best_bc = torch.where(best_v >= 0, torch.gather(cat_bc, 1, order), -1)
    return best_bc, best_v
