"""Pigeonhole seed screen: find candidate whitelist barcodes for each BC-UMI
query without scoring all 737K refs.

Counterpart of the JAX package's ops/seed_screen.py: the host tables
(SeedPlan, plan_for, SeedTable) are its code; the screen is torch ops on
the device of the tensors it is given, with no kernel of its own.

Rationale (replaces STAR's suffix-array seed search, scripts/barcode_align.sh):
an accepted barcode match needs AS >= 14 on a 16nt barcode (or >= 30 on the
slideseq bc8+linker+bc6 structure), i.e. at most one edit — so at least one
barcode *half* appears EXACTLY in the query (pigeonhole). We look up each
query offset's packed half-k-mer in a direct-address bucket table of
whitelist halves, cheaply rank every bucket entry by verifying the other
half (XOR + popcount on 2-bit packs, with ±1 indel shifts), and hand the
top-K to the exact DP rescorer (ops/sw.py).

Bucket sizes are data-dependent and can be large: the 737K-august-2016 10x
whitelist is a combinatorial *product* — only 1920 distinct first halves
(384 barcodes each) and 1536 second halves (480 each) — so buckets must be
gathered in full (cap auto-sized at table build, default limit 1024).
Knowing one half exactly still narrows 737K to ~500, and the other-half
popcount ranking separates the true barcode from its bucket-mates.

Offsets searched are `nominal ± jitter` where nominal is the chemistry-known
barcode offset inside the extracted candidate (the adapter scan has already
anchored the barcode's position; jitter covers accumulated indels). The scan
loops over offsets with a running top-K merge so peak memory stays
O(B * bucket_cap), independent of the number of offsets.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BUCKET_LIMIT = 1024  # absolute cap on gathered bucket size


@dataclasses.dataclass(frozen=True)
class SeedPlan:
    """Two exact-seed halves of the whitelist barcode and where they sit in
    the query. half i = bc[bc_lo_i:bc_hi_i]; its query offset is
    nominal + q_delta_i (± jitter)."""
    bc_len: int
    half_bounds: tuple          # ((lo0, hi0), (lo1, hi1)) within the barcode
    q_deltas: tuple             # query-offset delta of each half's start
    nominal: int                # query offset of bc start (chemistry known)
    jitter: int = 6


def plan_for(spec, nominal: int, jitter: int = 6) -> SeedPlan:
    """SeedPlan from a BarcodeMatchSpec. slideseq-style barcodes are split
    8+6 around the 18nt linker (utils.py:595), so the second half sits
    8+18=26 query bases after the first."""
    if spec.slideseq_linker:
        return SeedPlan(spec.bc_len, ((0, 8), (8, spec.bc_len)), (0, 26),
                        nominal, jitter)
    return SeedPlan(spec.bc_len, ((0, 8), (8, 16)), (0, 8), nominal, jitter)


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


class SeedTable:
    """Host-built direct-address bucket tables; arrays are device-shippable."""

    def __init__(self, bc_codes: np.ndarray, plan: SeedPlan):
        assert bc_codes.shape[1] == plan.bc_len
        self.plan = plan
        self.n_bc = bc_codes.shape[0]
        self.half_len = tuple(hi - lo for lo, hi in plan.half_bounds)
        self.starts, self.counts, self.entries, self.half_keys = [], [], [], []
        max_bucket = 1
        for (lo, hi) in plan.half_bounds:
            half = bc_codes[:, lo:hi]
            # barcodes with N in this half (2584/17753 slideseq beads) can
            # never seed here — they stay reachable via their other half;
            # their key is poisoned so cheap-verify treats it as mismatch
            valid = (half < 4).all(axis=1)
            keys = _pack_np(np.where(half < 4, half, 0))
            space = 4 ** (hi - lo)
            counts = np.bincount(keys[valid], minlength=space).astype(np.int32)
            starts = np.zeros(space, np.int32)
            np.cumsum(counts[:-1], out=starts[1:])
            order = np.argsort(np.where(valid, keys, space + 1),
                               kind="stable").astype(np.int32)
            max_bucket = max(max_bucket, int(counts.max()))
            self.starts.append(starts)
            self.counts.append(counts)
            self.entries.append(order)
            self.half_keys.append(
                np.where(valid, keys, -1).astype(np.int32))
        # gather whole buckets; truncation only beyond BUCKET_LIMIT
        self.maxocc = min(_next_pow2(max_bucket), BUCKET_LIMIT)


def _pack_np(codes: np.ndarray) -> np.ndarray:
    keys = np.zeros(codes.shape[0], dtype=np.int64)
    for t in range(codes.shape[1]):
        keys = keys * 4 + codes[:, t].astype(np.int64)
    return keys


def _packed_keys_all_offsets(q, l: int):
    """(B, Lq-l+1) packed int32 keys + validity for every window of
    length l."""
    B, Lq = q.shape
    n = Lq - l + 1
    acc = torch.zeros((B, n), dtype=torch.int32, device=q.device)
    ok = torch.ones((B, n), dtype=torch.bool, device=q.device)
    for t in range(l):
        chunk = q[:, t:t + n]
        ok = ok & (chunk < 4)
        acc = acc * 4 + torch.where(chunk < 4, chunk, 0)
    return acc, ok


def popcount32(x):
    """Set bits of each int32 (SWAR; torch has no population count). An
    arithmetic shift leaves the masked fields as a logical one would, so
    negative values count their two's-complement bits."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def _mm_count(a, b, l: int):
    """Mismatching base count between two 2-bit packed l-mers."""
    v = a ^ b
    g = (v | (v >> 1)) & (0x55555555 & ((1 << (2 * l)) - 1))
    return popcount32(g)


def stable_top_k(x, k: int):
    """The k largest of each row, largest first and, among equal values,
    lower index first (the order of lax.top_k): a stable descending
    sort."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def screen(q, qlen, starts0, counts0, entries0, hkeys0,
           starts1, counts1, entries1, hkeys1,
           plan: SeedPlan, top_k: int = 8, maxocc: int = 512):
    """Candidate barcodes per query, on the device of q (the SeedTable's
    arrays as tensors on the same device).

    Returns (cand_bc (B, top_k) int32 [-1 = none], cheap (B, top_k) int32
    ranked matched-base counts). Guarantee: any barcode sharing an exact
    half with the query at a searched offset is ranked by its full ungapped
    match count (±1-shift tolerant on the other half)."""
    dev = q.device
    i32 = torch.int32
    q = q.to(i32)
    qlen = qlen.to(i32)
    B, Lq = q.shape
    (lo0, hi0), (lo1, hi1) = plan.half_bounds
    l0, l1 = hi0 - lo0, hi1 - lo1
    keys0, ok0 = _packed_keys_all_offsets(q, l0)
    keys1, ok1 = (keys0, ok0) if l1 == l0 else _packed_keys_all_offsets(q, l1)

    tables = ((starts0, counts0, entries0, hkeys0, l0, keys0, ok0),
              (starts1, counts1, entries1, hkeys1, l1, keys1, ok1))
    t_occ = torch.arange(maxocc, dtype=i32, device=dev)

    def bucket_for(h: int, off: int):
        """Candidates + cheap scores for half h at query offset nominal+off."""
        starts, counts, entries, _, lh, keys_h, ok_h = tables[h]
        other = 1 - h
        _, _, _, hkeys_o, lo_, keys_o, ok_o = tables[other]
        o = plan.nominal + plan.q_deltas[h] + off
        n_h = keys_h.shape[1]
        if o < 0 or o >= n_h:
            return None
        key = keys_h[:, o].long()                            # (B,)
        okk = ok_h[:, o] & ((o + lh) <= qlen)
        cnt = torch.where(okk, counts[key], 0)
        cnt = cnt.clamp(max=maxocc)
        st = starts[key]
        idx = st[:, None] + t_occ[None, :]                   # (B, maxocc)
        ent_ok = t_occ[None, :] < cnt[:, None]
        bc = torch.where(ent_ok,
                         entries[idx.clamp(0, entries.shape[0] - 1).long()],
                         -1)

        # cheap verify: other half of each candidate vs query at implied offset
        d = plan.q_deltas[other] - plan.q_deltas[h]
        best_mm = torch.full((B, maxocc), lo_, dtype=i32, device=dev)
        bkey = hkeys_o[bc.clamp(0, hkeys_o.shape[0] - 1).long()]
        n_o = keys_o.shape[1]
        for shift in (-1, 0, 1):
            oo = o + d + shift
            if oo < 0 or oo >= n_o:
                continue
            qk = keys_o[:, oo]                               # (B,)
            qok = ok_o[:, oo]
            mm = _mm_count(qk[:, None], bkey, lo_)
            mm = torch.where(qok[:, None], mm, lo_)
            best_mm = torch.minimum(best_mm, mm)
        cheap = lh + (lo_ - best_mm)
        cheap = torch.where(ent_ok, cheap, -1)
        return bc, cheap

    carry_bc = torch.full((B, top_k), -1, dtype=i32, device=dev)
    carry_cheap = torch.full((B, top_k), -1, dtype=i32, device=dev)
    for off in range(-plan.jitter, plan.jitter + 1):
        step_bc, step_cheap = [carry_bc], [carry_cheap]
        for h in (0, 1):
            r = bucket_for(h, off)
            if r is not None:
                step_bc.append(r[0])
                step_cheap.append(r[1])
        if len(step_bc) == 1:
            continue
        all_bc = torch.cat(step_bc, dim=1)
        all_cheap = torch.cat(step_cheap, dim=1)
        carry_cheap, topi = stable_top_k(all_cheap, top_k)
        carry_bc = torch.gather(all_bc, 1, topi)
    carry_bc = torch.where(carry_cheap >= 0, carry_bc, -1)
    return carry_bc, carry_cheap
