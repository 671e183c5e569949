"""Barcode matching stage: exact structure tiers + exhaustive DP.

Counterpart of the JAX package's stages/barcode.py (its staged match,
`_match_tpu`). Replaces the reference's STAR sub-stack with a match that is
EXACT by construction.

The end-to-end score of a candidate against a padded whitelist row
N^PL + core + N^PR decomposes as  score = m - 2(mm + del) - ins - ov
where m = core length and ov = pad-overflow insertions
(max(0, start - PL) + max(0, tail - PR)). The top three scores admit a
COMPLETE hash enumeration ("tiers"):

  cost 0  exact core window                      (1 / window)
  cost 1  one interior insertion                 (m-1 / window)
  cost 2  one substitution                       (3m / window)
          one core-char deletion                 (4m / window)
          two interior insertions                (C(m,2) / window)

bucketed by tier = m - (class_cost + ov) in {m, m-1, m-2}; everything
scoring below m-2 on BOTH strands goes to the exhaustive one-vs-all DP
(ops/whitelist_verify.py) against the FULL whitelist, and the winner's
UMI position comes from the banded rescore (ops/sw.py). Ties at the best
score drop the read (STAR --outFilterMultimapNmax 1 /
--outFilterMultimapScoreRange 0), a better reverse-strand alignment is a
flag-16 row the reference rejects.

The match runs in stages on the matcher's device — exact-class tier-m
pass over every row, full-class pass over the rows it left unresolved,
exhaustive DP over the rows with no tier structure, then the verdicts —
with the same code on CPU and CUDA: only the two DP kernels differ
(Hopper kernels on CUDA, their plain versions on the CPU). Keys are looked
up with torch.searchsorted in sorted tables.

Status codes per candidate (what the reference observes from STAR's SAM):
  0 ACCEPT    — unique best, AS >= as_min, UMI intact
  1 LOW_AS    — unique best below as_min (score histogram only)
  2 MULTIMAP  — score tie across barcodes/strands (never reaches the SAM)
  3 NO_CAND   — empty candidate (never aligned)
  4 BAD_UMI   — accepted barcode but UMI column unaligned or truncated
  6 RC_BEST   — reverse-strand alignment strictly outscores every forward
                one (flag-16 row, rejected by the reference's flag==0)
  7 DP_PENDING — the fused step's exact-class pass (match_device_with)
                left the row to the match after the stream
"""

from __future__ import annotations

import numpy as np
import torch

from ..chemistry import BarcodeMatchSpec
from ..io import whitelist as wl
from ..io.encode import COMPLEMENT, PAD, encode_batch
from ..ops.sw import sw_end2end_banded
from ..ops.whitelist_verify import NEG, verify_all

ACCEPT, LOW_AS, MULTIMAP, NO_CAND, BAD_UMI = 0, 1, 2, 3, 4
RC_BEST = 6
# the fused step's verdict for rows its exact-class pass leaves to the
# post-stream match
DP_PENDING = 7

# tiers resolved by hash enumeration: m, m-1, m-2
N_TIERS = 3
BIGV = 1 << 30


def _pack_keys(codes: np.ndarray) -> np.ndarray:
    """2-bit keys of (N, L <= 16) code rows as int64 (values < 2^32)."""
    k = np.zeros(codes.shape[0], np.int64)
    for t in range(codes.shape[1]):
        k = (k << 2) | codes[:, t].astype(np.int64)
    return k


def build_tables(barcodes: np.ndarray, spec: BarcodeMatchSpec):
    """Host-side whitelist tables of one chemistry as numpy arrays.

    Returns (tables, ref_len) with tables holding:
      band    (R, core_len + 1) int8  padded-row columns pad_left ..
              umi_ref_offset (the banded rescore's reference)
      coreT   (core_len, R) int8      core columns, transposed (the
              one-vs-all DP's table)
    and, for whitelists whose structure fits 16 bases:
      ex_keys / ex_idx   sorted 2-bit core keys and their row indices
      rc_ex_keys         sorted keys of the reverse-complemented cores
      bnd                the 8 sorted key tables of the 1- and 2-truncated
                         cores (suf1, suf2, pre1, pre2, then rc_*), which
                         route boundary-truncated alignments to the DP
    """
    barcodes = np.asarray(barcodes)
    refs, ref_len = wl.padded_refs(barcodes, spec)
    tables = {
        "band": np.ascontiguousarray(
            refs[:, spec.pad_left:spec.umi_ref_offset + 1]),
        "coreT": np.ascontiguousarray(
            refs[:, spec.pad_left:spec.umi_ref_offset].T),
    }
    if not spec.slideseq_linker and spec.bc_len <= 16:
        bc_codes, _ = encode_batch(list(barcodes), max_len=spec.bc_len)
        keys = _pack_keys(bc_codes)
        order = np.argsort(keys, kind="stable")
        rc_codes = COMPLEMENT[bc_codes][:, ::-1]
        tables["ex_keys"] = keys[order]
        tables["ex_idx"] = order.astype(np.int64)
        tables["rc_ex_keys"] = np.sort(_pack_keys(rc_codes))
        tables["bnd"] = tuple(np.sort(_pack_keys(c)) for c in (
            bc_codes[:, 1:], bc_codes[:, 2:], bc_codes[:, :-1],
            bc_codes[:, :-2], rc_codes[:, 1:], rc_codes[:, 2:],
            rc_codes[:, :-1], rc_codes[:, :-2]))
    return tables, int(ref_len)


def tables_to(tables: dict, device) -> dict:
    """The numpy tables of `build_tables` as tensors on `device`."""
    out = {}
    for k, v in tables.items():
        if isinstance(v, tuple):
            out[k] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                           for a in v)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def pack_window_keys(q, bc_len: int):
    """2-bit keys of every bc_len-window of each row: (B, W) int64 +
    validity (no N/PAD inside the window). bc_len <= 16. Keys pack RAW
    codes: windows containing N/PAD have garbage bits and must be masked
    via the returned validity."""
    B, Lq = q.shape
    W = Lq - bc_len + 1
    c = q.to(torch.int64)
    ok = (q >= 0) & (q < 4)
    keys = torch.zeros((B, W), dtype=torch.int64, device=q.device)
    allok = torch.ones((B, W), dtype=torch.bool, device=q.device)
    for t in range(bc_len):
        keys = (keys << 2) | c[:, t:t + W]
        allok = allok & ok[:, t:t + W]
    return keys, allok


def _class_entries(q, qlen, m: int, classes: str = "full"):
    """All candidate-structure occurrences for the tier enumeration: list
    of (keys (B, K) int64, kept-chars-real (B, K) bool, start (1 or B, K),
    wlen int, cost int). Classes: exact, 1 interior insertion,
    1 substitution, 1 deletion, 2 interior insertions. Packing uses
    CLEANED codes (N/PAD -> 0); garbage is rejected by the real-char range
    sums, never by key value. classes="exact" emits only the cost-0 exact
    windows."""
    B, Lq = q.shape
    dev = q.device
    real = (q >= 0) & (q < 4)
    cs = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                    torch.cumsum(real.to(torch.int64), dim=1)], dim=1)

    def ok_range(p0, length: int):
        p0 = p0.expand(B, -1)
        a = torch.gather(cs, 1, p0.clamp(0, Lq))
        b = torch.gather(cs, 1, (p0 + length).clamp(0, Lq))
        return (b - a) == length

    def iota(n):
        return torch.arange(n, dtype=torch.int64, device=dev)[None]

    clean = torch.where(real, q.to(torch.int64), 0)
    qpad = torch.nn.functional.pad(clean, (0, m + 2))
    keysF, _ = pack_window_keys(qpad, m)               # (B, Lq+3)
    out = []

    # --- exact (cost 0)
    W = Lq - m + 1
    i0 = iota(W)
    out.append((keysF[:, :W], ok_range(i0, m), i0, m, 0))
    if classes == "exact":
        return out

    # --- 1 interior insertion (cost 1): (m+1)-windows, delete offset d
    W1 = Lq - m
    if W1 >= 1:
        i1 = iota(W1)
        pre = torch.zeros((B, W1), dtype=torch.int64, device=dev)
        pre_ok = torch.ones((B, W1), dtype=torch.bool, device=dev)
        ks, vs = [], []
        for d in range(1, m):
            pre = (pre << 2) | clean[:, d - 1:d - 1 + W1]
            pre_ok = pre_ok & real[:, d - 1:d - 1 + W1]
            suf = keysF[:, d + 1:d + 1 + W1] >> (2 * d)
            suf_ok = ok_range(i1 + d + 1, m - d)
            ks.append((pre << (2 * (m - d))) | suf)
            vs.append(pre_ok & suf_ok)
        out.append((torch.stack(ks, 2).reshape(B, -1),
                    torch.stack(vs, 2).reshape(B, -1),
                    i1.repeat_interleave(m - 1, dim=1), m + 1, 1))

    # --- 1 substitution (cost 2): m-windows, replace position p
    base_k = keysF[:, :W]
    base_ok = ok_range(i0, m)
    ks = []
    for p in range(m):
        sh = 2 * (m - 1 - p)
        orig = (base_k >> sh) & 3
        stripped = base_k & ~(3 << sh)
        for d in range(1, 4):
            ks.append(stripped | (((orig + d) & 3) << sh))
    out.append((torch.stack(ks, 2).reshape(B, -1),
                base_ok.repeat_interleave(3 * m, dim=1),
                i0.repeat_interleave(3 * m, dim=1), m, 2))

    # --- 1 deletion (cost 2): (m-1)-windows, re-insert any char anywhere
    Wd = Lq - m + 2
    idd = iota(Wd)
    k15 = keysF[:, :Wd] >> 2                           # top m-1 chars
    ok15 = ok_range(idd, m - 1)
    ks = []
    for p in range(m):
        lo_bits = 2 * (m - 1 - p)
        hi = (k15 >> lo_bits) << (lo_bits + 2)
        lo = k15 & ((1 << lo_bits) - 1)
        for x in range(4):
            ks.append(hi | (x << lo_bits) | lo)
    out.append((torch.stack(ks, 2).reshape(B, -1),
                ok15.repeat_interleave(4 * m, dim=1),
                idd.repeat_interleave(4 * m, dim=1), m - 1, 2))

    # --- 2 interior insertions (cost 2): (m+2)-windows, delete a<b
    W2 = Lq - m - 1
    if W2 >= 1:
        i2 = iota(W2)
        okW = ok_range(i2, m + 2)
        ks = []
        for a in range(1, m + 1):
            pre = keysF[:, :W2] >> (2 * (m - a)) if a < m else keysF[:, :W2]
            for b in range(a + 1, m + 2):
                lmid = b - a - 1
                lsuf = m + 1 - b
                mid = (keysF[:, a + 1:a + 1 + W2] >> (2 * (m - lmid))
                       if lmid else 0)
                suf = (keysF[:, b + 1:b + 1 + W2] >> (2 * (m - lsuf))
                       if lsuf else 0)
                ks.append((pre << (2 * (lmid + lsuf)))
                          | (mid << (2 * lsuf)) | suf)
        npairs = len(ks)
        out.append((torch.stack(ks, 2).reshape(B, -1),
                    okW.repeat_interleave(npairs, dim=1),
                    i2.repeat_interleave(npairs, dim=1), m + 2, 2))
    return out


def _hits_summary(found, hit_bc, end_pos):
    """Across a row's hit set: (any hit, >=2 DISTINCT barcodes, smallest
    hitting barcode id or -1, largest end_pos among hits of that
    barcode)."""
    mn = torch.where(found, hit_bc, BIGV).min(dim=1).values
    mx = torch.where(found, hit_bc, -1).max(dim=1).values
    any_ = mx >= 0
    multi = any_ & (mn != mx)
    ebc = torch.where(any_, mn, -1)
    last = torch.where(found & (hit_bc == ebc[:, None]), end_pos,
                       -1).max(dim=1).values
    return any_, multi, ebc, torch.where(any_, last, -1)


def tier_hits(q, qlen, keys_sorted, idx_sorted, bc_len: int, max_pre: int,
              max_suf: int, any_only: bool = False, classes: str = "full"):
    """Per tier t in (m, m-1, m-2): (any, multi, ebc, eqpos) of every
    score-t locus — class enumerations bucketed by
    tier = m - (class_cost + pad_overflow). With any_only=True returns just
    the three `any` vectors (the reverse-strand pass; idx_sorted may then
    be None). classes="exact": only the tier-m bucket (res[0]) is
    complete."""
    entries = _class_entries(q, qlen, bc_len, classes)
    keys = torch.cat([e[0] for e in entries], dim=1)
    valid = torch.cat([e[1] for e in entries], dim=1)
    start = torch.cat([e[2].expand_as(e[0]) for e in entries], dim=1)
    wlen = torch.cat([torch.full((e[0].shape[1],), e[3], dtype=torch.int64,
                                 device=q.device) for e in entries])[None]
    cost = torch.cat([torch.full((e[0].shape[1],), e[4], dtype=torch.int64,
                                 device=q.device) for e in entries])[None]
    tail = qlen.to(torch.int64)[:, None] - (start + wlen)
    ov = (start - max_pre).clamp(min=0) + (tail - max_suf).clamp(min=0)
    total = cost + ov
    base = valid & (tail >= 0)
    pos = torch.searchsorted(keys_sorted, keys).clamp(
        max=keys_sorted.shape[0] - 1)
    found_all = base & (keys_sorted[pos] == keys)
    if idx_sorted is not None:
        hit_val = idx_sorted[pos]
        found_all = found_all & (hit_val >= 0)
    ends = start + wlen
    res = []
    for t in range(N_TIERS):
        found = found_all & (total == t)
        if any_only:
            res.append(found.any(dim=1))
        else:
            hit_bc = torch.where(found, hit_val, BIGV)
            res.append(_hits_summary(found, hit_bc, ends))
    return res


def boundary_flags(q, qlen, tabs, m: int, max_pre: int, max_suf: int):
    """(B,) bool: the candidate admits a boundary-truncated alignment at
    tier >= m-2 against SOME core — a 1- or 2-truncated core suffix
    anchored at query position 0, or core prefix anchored at qlen,
    optionally with one interior insertion or one pad overflow. Those
    structures are invisible to the interior edit classes, so flagged
    candidates must resolve through the exhaustive DP. tabs = (suf1, suf2,
    pre1, pre2) sorted key tables of the truncated cores for ONE strand."""
    B, Lq = q.shape
    dev = q.device
    suf1, suf2, pre1, pre2 = tabs
    real = (q >= 0) & (q < 4)
    c = torch.where(real, q.to(torch.int64), 0)
    qlen = qlen.to(torch.int64)
    flag = torch.zeros(B, dtype=torch.bool, device=dev)
    if int(suf1.shape[0]) == 0 or m < 4 or Lq < m:
        return flag

    def in_tab(keys, tab):
        pos = torch.searchsorted(tab, keys).clamp(max=tab.shape[0] - 1)
        return tab[pos] == keys

    def pack_start(L):
        k = torch.zeros(B, dtype=torch.int64, device=dev)
        v = qlen >= L
        for i in range(L):
            k = (k << 2) | c[:, i]
            v = v & real[:, i]
        return k, v

    def gather_end(L):
        idx = qlen[:, None] - L + torch.arange(L, device=dev)[None]
        ok = idx >= 0
        idxc = idx.clamp(0, Lq - 1)
        return torch.gather(c, 1, idxc), torch.gather(real, 1, idxc) & ok

    def pack_rows(ch, rl):
        k = torch.zeros(B, dtype=torch.int64, device=dev)
        for i in range(ch.shape[1]):
            k = (k << 2) | ch[:, i]
        return k, rl.all(dim=1)

    def del_keys(ch, rl):
        """All L-1 char keys of ch with one position deleted: (B, L)."""
        L = ch.shape[1]
        pre = torch.zeros(B, dtype=torch.int64, device=dev)
        suf = [torch.zeros(B, dtype=torch.int64, device=dev)]
        for i in range(L - 1, 0, -1):
            suf.append(suf[-1] | (ch[:, i] << (2 * (L - 1 - i))))
        suf = suf[::-1]          # suf[p] = pack of ch[p+1:], aligned low
        base_ok = rl.all(dim=1)
        ks = []
        for p in range(L):
            ks.append((pre << (2 * (L - 1 - p))) | suf[p])
            pre = (pre << 2) | ch[:, p]
        return torch.stack(ks, 1), base_ok[:, None].expand(B, L)

    def ov_s(wl_):                 # start-anchored pad overflow
        return (qlen - wl_ - max_suf).clamp(min=0)

    def ov_e(wl_):                 # end-anchored pad overflow
        return (qlen - wl_ - max_pre).clamp(min=0)

    # start-anchored: core suffix at query 0
    k, v = pack_start(m - 1)
    flag |= v & in_tab(k, suf1) & (1 + ov_s(m - 1) <= 2)
    k, v = pack_start(m - 2)
    flag |= v & in_tab(k, suf2) & (2 + ov_s(m - 2) <= 2)
    rl0 = real[:, :m] & (torch.arange(m, device=dev)[None] < qlen[:, None])
    kd, vd = del_keys(c[:, :m], rl0)
    flag |= ((vd & in_tab(kd, suf1)).any(dim=1) &
             (2 + ov_s(m) <= 2) & (qlen >= m))

    # end-anchored: core prefix at qlen
    k, v = pack_rows(*gather_end(m - 1))
    flag |= v & in_tab(k, pre1) & (1 + ov_e(m - 1) <= 2)
    k, v = pack_rows(*gather_end(m - 2))
    flag |= v & in_tab(k, pre2) & (2 + ov_e(m - 2) <= 2)
    kd, vd = del_keys(*gather_end(m))
    flag |= (vd & in_tab(kd, pre1)).any(dim=1) & (2 + ov_e(m) <= 2)
    return flag & (qlen > 0)


def combine_verdicts(q, qlen, spec, core_len: int, tiers, dp):
    """Verdicts: rc > fwd -> RC_BEST; rc == fwd or fwd ties -> MULTIMAP;
    fwd < as_min -> LOW_AS; else ACCEPT/BAD_UMI. `tiers` is None or
    (fwd_tiers, rc_any) with fwd_tiers = [(any, multi, ebc, eqpos)] and
    rc_any = [any] for tier scores (m, m-1, m-2); `dp` is (need_dp, fb,
    fidx, fties, rb, fqpos, fuval). Returns (bc, score, status, umi,
    qpos)."""
    B, Lq = q.shape
    dev = q.device
    s = spec
    m = core_len
    i32 = torch.int32
    nonempty = qlen > 0
    need_dp, fb, fidx, fties, rb, fqpos, fuval = dp

    status = torch.full((B,), NO_CAND, dtype=i32, device=dev)
    score = torch.full((B,), NEG, dtype=i32, device=dev)
    bc = torch.full((B,), -1, dtype=i32, device=dev)
    qpos = torch.full((B,), -1, dtype=i32, device=dev)

    dp_mm = (rb == fb) | (fties > 1)
    umi_ok = fuval & (fqpos >= 0) & (fqpos + s.umi_len <= qlen)
    dp_status = torch.where(
        rb > fb, RC_BEST,
        torch.where(dp_mm, MULTIMAP,
                    torch.where(fb < s.as_min, LOW_AS,
                                torch.where(umi_ok, ACCEPT, BAD_UMI))))
    dp_status = dp_status.to(i32)
    dp_bc = torch.where((dp_status == ACCEPT) | (dp_status == BAD_UMI),
                        fidx, -1)
    status = torch.where(need_dp, dp_status, status)
    score = torch.where(need_dp, fb, score)
    bc = torch.where(need_dp, dp_bc, bc)
    qpos = torch.where(need_dp, fqpos, qpos)

    if tiers is not None:
        fwd, rc_any = tiers
        higher_fwd = torch.zeros((B,), dtype=torch.bool, device=dev)
        rc_higher = torch.zeros((B,), dtype=torch.bool, device=dev)
        for t in range(N_TIERS):
            any_t, multi_t, ebc_t, eq_t = fwd[t]
            r_t = rc_any[t]
            row = nonempty & ~higher_fwd & any_t
            st = torch.where(rc_higher, RC_BEST,
                             torch.where(multi_t | r_t, MULTIMAP,
                                         torch.where((eq_t >= 0) &
                                                     (eq_t + s.umi_len <= qlen),
                                                     ACCEPT, BAD_UMI)))
            st = st.to(i32)
            status = torch.where(row, st, status)
            score = torch.where(row, m - t, score)
            keepers = row & ((st == ACCEPT) | (st == BAD_UMI))
            bc = torch.where(keepers, ebc_t.to(i32), bc)
            qpos = torch.where(keepers, eq_t.to(i32), qpos)
            higher_fwd = higher_fwd | any_t
            rc_higher = rc_higher | r_t
        # rc-only rows: some rc structure outranks every fwd one
        rc_only = nonempty & ~higher_fwd & rc_higher
        status = torch.where(rc_only, RC_BEST, status)
        score = torch.where(rc_only, m - 1, score)

    off = torch.arange(s.umi_len, device=dev)[None]
    uidx = (qpos.to(torch.int64)[:, None] + off).clamp(0, Lq - 1)
    umi = torch.gather(q, 1, uidx)
    umi = torch.where((status == ACCEPT)[:, None], umi,
                      torch.tensor(PAD, dtype=q.dtype, device=dev))
    return bc, score, status, umi, qpos


def revcomp_rows(q, qlen):
    """Per-row reverse complement of the valid prefix (PAD tail stays)."""
    B, Lq = q.shape
    jj = torch.arange(Lq, device=q.device)[None]
    src = (qlen.to(torch.int64)[:, None] - 1 - jj).clamp(0, Lq - 1)
    comp = torch.from_numpy(COMPLEMENT).to(q.device)
    vals = comp[torch.gather(q, 1, src).long()]
    return torch.where(jj < qlen[:, None], vals,
                       torch.tensor(PAD, dtype=q.dtype, device=q.device))


class BarcodeMatcher:
    """Whitelist tables for one chemistry on one device, and the staged
    exact match over them."""

    PASS2_CHUNK = 256
    DP_CHUNK = 256        # candidates per one-vs-all DP launch

    def __init__(self, barcodes: np.ndarray, spec: BarcodeMatchSpec,
                 device):
        self.spec = spec
        self.device = torch.device(device)
        self.barcodes = np.asarray(barcodes)
        self.core_len = spec.umi_ref_offset - spec.pad_left
        if spec.as_min > self.core_len - (N_TIERS - 1):
            raise ValueError("tier scores must clear as_min")
        host, self.ref_len = build_tables(self.barcodes, spec)
        self.tables = tables_to(host, self.device)

    def device_tables(self) -> dict:
        """The whitelist tables on the matcher's device, for callers that
        pass them to `match_device_with` (the fused step's tables). The
        sorted key tables only: tier lookups binary-search them with
        torch.searchsorted, where the JAX package adds cuckoo hash tables
        on accelerators that give the same answers. A torch probe of
        those tables took no less time than the search on an H100 (the
        device step and the fused CLI step, PERF.md), so it is not
        carried."""
        return self.tables

    def _tiers(self, q, qlen, classes: str = "full"):
        return self._tiers_with(q, qlen, self.tables, classes)

    def _tiers_with(self, q, qlen, t, classes: str = "full"):
        """(fwd_tiers, rc_any, tier_hit) from the tables `t`, or (None,
        None, all-False) when the whitelist has no tier tables; with
        classes="exact" only the tier-m bucket is meaningful and tier_hit
        is the fwd tier-m any."""
        s = self.spec
        if "ex_keys" not in t:
            return None, None, torch.zeros(q.shape[0], dtype=torch.bool,
                                           device=q.device)
        fwd = tier_hits(q, qlen, t["ex_keys"], t["ex_idx"], s.bc_len,
                        s.pad_left, s.pad_right, classes=classes)
        rc = tier_hits(q, qlen, t["rc_ex_keys"], None, s.bc_len,
                       s.pad_right, s.pad_left, any_only=True,
                       classes=classes)
        if classes == "exact":
            return fwd, rc, fwd[0][0]
        # boundary-truncated structures (free core entry/exit at the query
        # edges) are outside the interior classes: flagged rows resolve
        # through the exhaustive DP instead of the tier summaries
        bt = t["bnd"]
        fl = boundary_flags(q, qlen, bt[0:4], s.bc_len, s.pad_left,
                            s.pad_right)
        fl = fl | boundary_flags(q, qlen, bt[4:8], s.bc_len, s.pad_right,
                                 s.pad_left)
        fl = fl | ((qlen > 0) & (qlen <= s.bc_len + 1))
        keep = ~fl
        fwd = [(a & keep, mlt, ebc, eqp) for (a, mlt, ebc, eqp) in fwd]
        rc = [r & keep for r in rc]
        hit = torch.zeros_like(keep)
        for k in range(N_TIERS):
            hit = hit | fwd[k][0] | rc[k]
        return fwd, rc, hit

    def _dp(self, qs, qls, t):
        """Exhaustive forward + reverse scoring of rows with no tier
        structure against the tables `t`, and the forward winner's UMI
        position."""
        s = self.spec
        n = qs.shape[0]
        R = len(self.barcodes)
        qq = torch.cat([qs, revcomp_rows(qs, qls)]).contiguous()
        best, idx, ties = verify_all(qq, torch.cat([qls, qls]), t["coreT"],
                                     R, s.pad_left, s.pad_right)
        band = t["band"][idx[:n].clamp(0, R - 1).long()].contiguous()
        _, qp, uv = sw_end2end_banded(qs, qls, band, self.ref_len,
                                      s.pad_left, s.umi_ref_offset)
        return best[:n], idx[:n], ties[:n], best[n:], qp, uv

    def _dp_pass(self, q, qlen, t, need):
        """The exhaustive DP over the rows flagged in `need`, DP_CHUNK rows
        a launch: full-size (fb, fidx, fties, rb, fqpos, fuval), rows not
        flagged at NEG / -1 / 0 / False. Reading the flagged rows is the
        one host synchronisation; a row's result does not depend on the
        rows it shares a chunk with."""
        B = q.shape[0]
        dev = q.device
        i32 = torch.int32
        fb = torch.full((B,), NEG, dtype=i32, device=dev)
        fidx = torch.full((B,), -1, dtype=i32, device=dev)
        fties = torch.zeros(B, dtype=i32, device=dev)
        rb = torch.full((B,), NEG, dtype=i32, device=dev)
        fqpos = torch.full((B,), -1, dtype=i32, device=dev)
        fuval = torch.zeros(B, dtype=torch.bool, device=dev)
        flagged = torch.nonzero(need)[:, 0]
        for base in range(0, len(flagged), self.DP_CHUNK):
            rows = flagged[base:base + self.DP_CHUNK]
            (fb[rows], fidx[rows], fties[rows], rb[rows], fqpos[rows],
             fuval[rows]) = self._dp(q[rows].contiguous(), qlen[rows], t)
        return fb, fidx, fties, rb, fqpos, fuval

    def match(self, q: np.ndarray, qlen: np.ndarray) -> dict:
        """q: (B, Lq) int8 BC-UMI candidates; returns dict of numpy
        arrays (bc_idx, score, status, umi, qpos)."""
        dev = self.device
        qd = torch.from_numpy(np.ascontiguousarray(q, np.int8)).to(dev)
        qld = torch.from_numpy(np.asarray(qlen, np.int32)).to(dev)
        B = qd.shape[0]
        need = torch.zeros(B, dtype=torch.bool, device=dev)

        tiers = None
        if "ex_keys" in self.tables:
            # pass 1: exact-class tier-m summaries of every row
            fwd, rc, _ = self._tiers(qd, qld, classes="exact")
            (a16, m16, e16, p16), r16 = fwd[0], rc[0]
            tA = torch.zeros((N_TIERS, B), dtype=torch.bool, device=dev)
            tM = torch.zeros_like(tA)
            tR = torch.zeros_like(tA)
            tE = torch.full((N_TIERS, B), -1, dtype=torch.int64, device=dev)
            tQ = torch.full_like(tE, -1)
            tA[0], tM[0], tE[0], tQ[0], tR[0] = a16, m16, e16, p16, r16
            # pass 2: full classes over the rows pass 1 left unresolved
            unres = torch.nonzero((qld > 0) & ~a16)[:, 0]
            for base in range(0, len(unres), self.PASS2_CHUNK):
                rows = unres[base:base + self.PASS2_CHUNK]
                fwd, rc, hit = self._tiers(qd[rows], qld[rows])
                for k in range(N_TIERS):
                    tA[k, rows], tM[k, rows], tE[k, rows], tQ[k, rows] = \
                        fwd[k]
                    tR[k, rows] = rc[k]
                need[rows] = ~hit
            tiers = ([(tA[k], tM[k], tE[k], tQ[k]) for k in range(N_TIERS)],
                     [tR[k] for k in range(N_TIERS)])
        else:
            need = qld > 0            # no tier tables: every row to the DP

        # pass 3: exhaustive DP over the rows with no tier structure
        fb, fidx, fties, rb, fqpos, fuval = self._dp_pass(qd, qld,
                                                          self.tables, need)

        bc, score, status, umi, qpos = combine_verdicts(
            qd, qld, self.spec, self.core_len, tiers,
            (need, fb, fidx, fties, rb, fqpos, fuval))
        return {"bc_idx": bc.cpu().numpy(), "score": score.cpu().numpy(),
                "status": status.cpu().numpy(), "umi": umi.cpu().numpy(),
                "qpos": qpos.cpu().numpy()}

    def match_device_with(self, q, qlen, t, dp: bool = True):
        """The match of (B, Lq) int8 candidate tensors on the device of the
        tables `t` (device_tables()): returns tensors (bc, score, status,
        umi, qpos).

        dp=True is the full match inside a step: the full-class tier pass
        over every row, then the exhaustive DP and the UMI rescore over the
        non-empty rows with no tier hit (without tier tables: every
        non-empty row), DP_CHUNK rows a launch. Finding the flagged rows
        synchronises with the host once; the verdicts equal match()'s.

        dp=False is the fused step's pass, with no host synchronisation:
        only the exact (cost-0) class is enumerated, and any candidate
        without a forward tier-m hit comes back DP_PENDING, for the
        pipeline to match after the stream (pipeline.match_barcodes with
        prematched=). Verdicts of forward tier-m rows are final and equal
        the full match's: ties at the best score decide them within the
        tier-m summaries, so the lower tiers, zeroed here, are never read
        for them. Without tier tables every non-empty candidate is
        pending."""
        B = q.shape[0]
        dev = q.device
        i32 = torch.int32
        if dp:
            fwd, rc, tier_hit = self._tiers_with(q, qlen, t)
            need = (qlen > 0) & ~tier_hit
            return combine_verdicts(
                q, qlen, self.spec, self.core_len,
                None if fwd is None else (fwd, rc),
                (need, *self._dp_pass(q, qlen, t, need)))
        fwd, rc, fwd16_any = self._tiers_with(q, qlen, t, classes="exact")
        if fwd is None:
            pend = qlen > 0
            tiers = None
        else:
            zf = torch.zeros(B, dtype=torch.bool, device=dev)
            neg1 = torch.full((B,), -1, dtype=torch.int64, device=dev)
            zsum = (zf, zf, neg1, neg1)
            tiers = ([fwd[0], zsum, zsum], [rc[0], zf, zf])
            pend = (qlen > 0) & ~fwd16_any
        no_dp = (torch.zeros(B, dtype=torch.bool, device=dev),
                 torch.full((B,), NEG, dtype=i32, device=dev),
                 torch.full((B,), -1, dtype=i32, device=dev),
                 torch.zeros(B, dtype=i32, device=dev),
                 torch.full((B,), NEG, dtype=i32, device=dev),
                 torch.full((B,), -1, dtype=i32, device=dev),
                 torch.zeros(B, dtype=torch.bool, device=dev))
        bc, score, status, umi, qpos = combine_verdicts(
            q, qlen, self.spec, self.core_len, tiers, no_dp)
        status = torch.where(pend, DP_PENDING, status).to(i32)
        return bc, score, status, umi, qpos

    def match_device(self, q, qlen):
        """The full match of candidate tensors on the matcher's device:
        (bc, score, status, umi, qpos)."""
        return self.match_device_with(q, qlen, self.device_tables())

    def bc_strings(self, bc_idx: np.ndarray) -> np.ndarray:
        out = np.full(bc_idx.shape, "", dtype=object)
        ok = bc_idx >= 0
        out[ok] = self.barcodes[bc_idx[ok]]
        return out
