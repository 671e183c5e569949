"""Panel and genome aligner: device seed -> chain, host records.

Counterpart of the JAX package's align/aligner.py, for both of its presets:
  - "map-ont" against transcript panels (minimap2 `-aY --eqx -x map-ont
    --secondary=no`, reference scripts/align_trns.sh:9)
  - "splice" against genomes (minimap2 `-x splice`, reference
    scripts/align_genome.sh:9): the chain DP also admits an intron gap
    class (large target gap, small query gap, log-penalised) up to
    MAX_INTRON, extract_exons splits each chain into exon blocks, and
    clip_exon_blocks clips the blocks that overlap.
The contract is the set of (qstart, qend, strand, ref, ref span) alignment
records per read, primary plus supplementaries.

Device (torch, on the aligner's device):
  1. sketch reads (align/minimizers.py)
  2. anchor lookup: hash-bucket window gather over the sorted index,
     occurrence-capped (minimap2's frequent-minimizer filter analogue)
  3. (seg, t, q) anchor sort, then the colinear chain DP (ops/chain.py,
     the Hopper kernel on CUDA)
  4. per-chain segment reductions (_chain_summaries)

Host (numpy): score/min-anchor filters and minimap2-style primary
selection (greedy query-overlap masking: < 50% overlap with a better
chain keeps a record as supplementary, otherwise it is dropped); exon
blocks of the splice preset.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.chain import chain_dp
from ..ops.mxu_lookup import build_windows, windowed_lookup
from .index import PanelIndex
from .minimizers import K, sketch_batch

HASH_BITS = 30
PREFIX_BITS = 20

MAX_GAP = 5000        # minimap2 -g default band for map-ont chaining
BANDWIDTH = 500       # minimap2 -r 500 (map-ont)
MAX_INTRON = 200_000  # minimap2 -G 200k (-x splice)
SPLICE_PEN = 6.0      # flat intron-open penalty (noncanonical-splice class)
MIN_CHAIN_SCORE = 40  # minimap2 -m
MIN_CHAIN_CNT = 3     # minimap2 -n
OCC_CAP = 16          # per-minimizer occurrence cap (frequent-seed filter)
MASK_LEVEL = 0.5      # minimap2 primary overlap threshold

SEG_INVALID = 1 << 30   # sorts all invalid anchors to the tail
NEGF = -1e18


def seed_and_chain(codes, lengths, prefix_start, prefix_count, windows,
                   max_minimizers: int = 256, max_intron: int = 0):
    """Per-read sorted anchors + chain DP results.

    codes (B, L) int8 and lengths (B,) int32 on the device of the index
    tensors; max_intron > 0 turns on the splice gap class. Returns a dict
    of (B, A) tensors: t (local target coord),
    q (chain coord), qpos (original read position, -1 on dead slots),
    seg (= ref_id*2 + rel_strand; SEG_INVALID on dead slots), strand,
    valid, f, parent, root; and overflow (B,) bool."""
    B, L = codes.shape
    dev = codes.device
    occ_cap = windows.shape[1]
    hq, qpos, qstrand, n_mini = sketch_batch(codes, lengths, max_minimizers)
    M = hq.shape[1]

    p = (hq >> (HASH_BITS - PREFIX_BITS)).clamp(0, prefix_start.shape[0] - 1)
    start = prefix_start[p]                                   # (B, M)
    cnt = prefix_count[p]
    win = windowed_lookup(start.reshape(-1), windows)         # (B*M, occ, 3)
    win = win.reshape(B, M, occ_cap, 3)
    t_idx = win[..., 0]
    w_hash = win[..., 1].to(torch.int64)
    seg_idx = win[..., 2]

    o = torch.arange(occ_cap, dtype=torch.int32, device=dev)[None, None]
    ok = (o < cnt.clamp(max=occ_cap)[:, :, None]) \
        & (qpos[:, :, None] >= 0) & (w_hash == hq[:, :, None])
    rel_strand = (seg_idx & 1) ^ qstrand[:, :, None]
    seg = (seg_idx & ~1) | rel_strand                # ref_id*2 + rel_strand
    qp = qpos[:, :, None]
    q_chain = torch.where(rel_strand == 1, lengths[:, None, None] - K - qp, qp)

    A_raw = M * occ_cap
    seg = torch.where(ok, seg, SEG_INVALID).reshape(B, A_raw)
    t = torch.where(ok, t_idx, 0).reshape(B, A_raw)
    q = torch.where(ok, q_chain, 0).reshape(B, A_raw).to(torch.int32)
    qp_all = torch.where(ok, qp.expand_as(ok), -1).reshape(B, A_raw)
    A = min(A_raw, 4 * max_minimizers)

    # capacity-overflow flag: a read whose anchors exceed the A slots (or
    # whose minimizers hit the sketch cap) gets a truncated anchor set
    n_anchor = ok.sum(dim=(1, 2))
    overflow = n_anchor > A
    if M == max_minimizers:
        overflow = overflow | (n_mini >= M)

    # lexicographic (seg, t, q) sort as three stable sorts, least
    # significant key first; equal (seg, t, q) implies equal qpos, so the
    # order of ties never shows. Invalid anchors sink to the tail and the
    # first A slots keep every valid one a read can hold.
    perm = torch.sort(q, dim=1, stable=True).indices
    perm = perm.gather(1, torch.sort(t.gather(1, perm), dim=1,
                                     stable=True).indices)
    perm = perm.gather(1, torch.sort(seg.gather(1, perm), dim=1,
                                     stable=True).indices)
    perm = perm[:, :A]
    seg = seg.gather(1, perm).contiguous()
    t = t.gather(1, perm).contiguous()
    q = q.gather(1, perm).contiguous()
    qp_flat = qp_all.gather(1, perm)
    valid = seg != SEG_INVALID
    strand = torch.where(valid, seg & 1, 0)

    f, parent, root = chain_dp(t, q, seg, valid, K, MAX_GAP, BANDWIDTH,
                               max_intron, SPLICE_PEN)
    return {"t": t, "q": q, "qpos": qp_flat, "seg": seg, "strand": strand,
            "valid": valid, "f": f, "parent": parent, "root": root,
            "overflow": overflow}


def prepare_index_arrays(index: PanelIndex, device):
    """Flatten the index into device lookup tensors: direct-address
    (start, count) tables over the top PREFIX_BITS of the hash, and the
    (t_local, hash, seg) occurrence windows (seg = ref_id*2 + strand)."""
    t = index.tpos.astype(np.int32)
    seg = (index.ref_id.astype(np.int32) << 1) | index.strand.astype(np.int32)
    h = index.hashes.astype(np.uint32)                 # sorted ascending
    pref = (h >> np.uint32(HASH_BITS - PREFIX_BITS)).astype(np.int64)
    space = 1 << PREFIX_BITS
    counts = np.bincount(pref, minlength=space).astype(np.int32)
    starts = np.zeros(space, np.int32)
    np.cumsum(counts[:-1], out=starts[1:])
    windows = build_windows([t, h.astype(np.int32), seg], OCC_CAP, device)
    return (torch.from_numpy(starts).to(device),
            torch.from_numpy(counts).to(device), windows)


@dataclasses.dataclass
class AlignmentRecords:
    """Columnar alignment records (replacement for SAM rows between
    stages)."""
    read_idx: np.ndarray
    ref_id: np.ndarray
    strand: np.ndarray     # 0 fwd / 1 rev
    flag: np.ndarray       # 0/16 primary, 2048/2064 supplementary
    qstart: np.ndarray     # ORIGINAL-read coordinates (the decon stage
    qend: np.ndarray       # converts strand-1 records to stored ones)
    tstart: np.ndarray
    tend: np.ndarray
    score: np.ndarray
    n_anchors: np.ndarray
    root: np.ndarray | None = None   # flat b*A + chain root
    mapq: np.ndarray | None = None   # minimap2-style mapping quality

    def __len__(self):
        return len(self.read_idx)


def _chain_summaries(t, q, qpos, seg, valid, f, root):
    """Per-chain segment reductions on the device; only the kept chains
    (cnt >= MIN_CHAIN_CNT and best f >= MIN_CHAIN_SCORE, in flat index
    order) come back."""
    B, A = t.shape
    dev = t.device
    size = B * A
    INF = 1 << 30
    lab = torch.where(root >= 0, root,
                      torch.arange(A, dtype=torch.int32, device=dev)[None])
    flat = (torch.arange(B, dtype=torch.int64, device=dev)[:, None] * A
            + lab).reshape(-1)
    flat = torch.where(valid.reshape(-1), flat, size)  # invalid -> dump slot
    qpos_f = qpos.reshape(-1).to(torch.int32)

    def sreduce(v, init, how):
        base = torch.full((size + 1,), init, dtype=v.dtype, device=dev)
        return base.scatter_reduce(0, flat, v.reshape(-1), how)

    cnt = torch.bincount(flat, minlength=size + 1)
    qlo = sreduce(qpos_f, INF, "amin")
    qhi = sreduce(qpos_f + K, -1, "amax")
    tlo = sreduce(t, INF, "amin")
    thi = sreduce(t, -1, "amax")
    fmax = sreduce(f, NEGF, "amax")
    sg = sreduce(seg, -1, "amax")                   # uniform within a chain
    keep = (cnt[:size] >= MIN_CHAIN_CNT) & (fmax[:size] >= MIN_CHAIN_SCORE)
    g = torch.nonzero(keep)[:, 0]
    out = {"gidx": g, "cnt": cnt[g], "qlo": qlo[g], "qhi": qhi[g],
           "tlo": tlo[g], "thi": thi[g], "fmax": fmax[g], "sg": sg[g]}
    return {k: v.cpu().numpy() for k, v in out.items()}


def extract_records(chain_out: dict, index: PanelIndex) -> AlignmentRecords:
    """Chains -> alignment records: device segment reductions, host-side
    primary/supplementary flag assignment."""
    B, A = chain_out["t"].shape
    s = _chain_summaries(chain_out["t"], chain_out["q"], chain_out["qpos"],
                         chain_out["seg"], chain_out["valid"],
                         chain_out["f"], chain_out["root"])
    gidx = s["gidx"].astype(np.int64)
    if len(gidx) == 0:
        z = np.zeros(0, np.int64)
        return AlignmentRecords(z, z, z, z, z, z, z, z, z.astype(float), z,
                                z.copy(), z.copy())

    read_idx = gidx // A
    score = s["fmax"].astype(np.float64)
    qstart = s["qlo"].astype(np.int64)
    qend = s["qhi"].astype(np.int64)
    tstart = s["tlo"].astype(np.int64)
    tend = s["thi"].astype(np.int64) + K
    sg = s["sg"].astype(np.int64)
    ref_of = sg >> 1
    chain_strand = sg & 1
    n_anchors = s["cnt"].astype(np.int64)
    tend = np.minimum(tend, index.ref_lens[ref_of].astype(np.int64))

    # primary selection per read: score-descending greedy query-overlap.
    # Single-record reads are handled vectorized; only multi-record
    # (chimera/concatemer) reads run the greedy loop.
    order = np.lexsort((-score, read_idx))
    rid_sorted = read_idx[order]
    starts = np.flatnonzero(
        np.r_[True, rid_sorted[1:] != rid_sorted[:-1]])
    ends = np.r_[starts[1:], len(order)]
    flag = np.full(len(gidx), -1, np.int64)
    # minimap2-style MAPQ: sub = best score of a dropped (secondary) chain
    # overlapping a kept one >= MASK_LEVEL
    sub_best = np.zeros(len(gidx), np.float64)
    single = (ends - starts) == 1
    oi_single = order[starts[single]]
    flag[oi_single] = 16 * chain_strand[oi_single]
    for s_, e_ in zip(starts[~single], ends[~single]):
        kept: list[tuple[int, int, int]] = []      # (qs, qe, record idx)
        for oi in order[s_:e_]:
            a, b = qstart[oi], qend[oi]
            ov, ov_k = 0, -1
            for (ka, kb, ki) in kept:
                o = min(b, kb) - max(a, ka)
                if o > ov:
                    ov, ov_k = o, ki
            if not kept:
                flag[oi] = 0 + 16 * chain_strand[oi]
                kept.append((a, b, oi))
            elif ov < MASK_LEVEL * (b - a):
                flag[oi] = 2048 + 16 * chain_strand[oi]
                kept.append((a, b, oi))
            else:
                sub_best[ov_k] = max(sub_best[ov_k], score[oi])

    sel = flag >= 0
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(score > 0, 1.0 - sub_best / np.maximum(score, 1e-9),
                        0.0)
    mapq = np.clip(40.0 * frac * np.minimum(1.0, n_anchors / 10.0),
                   0, 60).astype(np.int64)
    mapq = np.where(sub_best <= 0, 60, mapq)
    return AlignmentRecords(
        read_idx[sel], ref_of[sel], chain_strand[sel], flag[sel],
        qstart[sel], qend[sel], tstart[sel], tend[sel],
        score[sel], n_anchors[sel], gidx[sel], mapq[sel])


def extract_exons(chain_out: dict, records: AlignmentRecords,
                  min_intron: int = 50) -> list:
    """Per-record exon blocks from the chain anchors (splice preset).

    Returns, for each record, a list of (t_lo, t_hi, q_lo, q_hi) segments
    in stored-read orientation (q coords are chain coords, which equal the
    stored-orientation positions for both strands), split wherever the
    target gap between consecutive anchors exceeds the query gap by
    >= min_intron, the intron signature. Single-exon records get one
    block. The genome stage turns the gaps into N CIGAR ops."""
    if len(records) == 0:
        return []
    A = chain_out["t"].shape[1]
    g = records.root.astype(np.int64)
    rows, row_of = np.unique(g // A, return_inverse=True)
    sel = torch.from_numpy(rows).to(chain_out["t"].device)
    t, q, root, valid = (chain_out[k][sel].cpu().numpy()
                         for k in ("t", "q", "root", "valid"))
    out = []
    for r, root_local in zip(row_of, g % A):
        m = (root[r] == root_local) & valid[r]
        ts, qs = t[r][m], q[r][m]      # (seg, t, q)-sorted: t ascending
        cut = np.flatnonzero(np.diff(ts) - np.diff(qs) >= min_intron) + 1
        lo = np.r_[0, cut]
        hi = np.r_[cut - 1, len(ts) - 1]
        out.append([(int(ts[a]), int(ts[b]) + K, int(qs[a]), int(qs[b]) + K)
                    for a, b in zip(lo, hi)])
    return out


def clip_exon_blocks(blocks: list) -> tuple:
    """(blocks, n_trimmed, n_dropped): each block of one record clipped
    against the end of the block kept before it, on the query and on the
    target.

    A block ends at its last anchor + K, so the next block, which starts
    at its first anchor, may start before that end on the query or the
    target. Joined as they are, such blocks give a CIGAR that consumes
    more query bases than the read holds, or puts aligned runs where no
    block aligned. Deliberate fix of a defect shared with the reference
    implementation: both starts advance by the larger of the two overlaps
    (the block stays on its diagonal), and a block the clip empties is
    dropped. Every query and target gap between kept blocks is then >= 0.
    Records without overlapping blocks are unchanged."""
    out = [blocks[0]]
    trimmed = dropped = 0
    for (t_lo, t_hi, q_lo, q_hi) in blocks[1:]:
        ov = max(out[-1][1] - t_lo, out[-1][3] - q_lo, 0)
        if ov:
            t_lo, q_lo = t_lo + ov, q_lo + ov
            if t_lo >= t_hi or q_lo >= q_hi:
                dropped += 1
                continue
            trimmed += 1
        out.append((t_lo, t_hi, q_lo, q_hi))
    return out, trimmed, dropped


class PanelAligner:
    """End-to-end wrapper on one device, or round-robin over several.

    preset "map-ont" (panels/transcriptomes) or "splice" (genomes:
    intron-tolerant chaining, minimap2 -x splice analogue).

    devices: optional list of devices for data-parallel streaming — batch
    i runs on devices[i % n] (pass shard= to _chain); the index tensors
    are copied once to each distinct device, and the work follows the
    batch's placement.

    index_arrays: optional prepare_index_arrays(index, device) output built
    by the caller (one device only), used instead of a second copy."""

    def __init__(self, index: PanelIndex, device,
                 max_minimizers: int | None = None, preset: str = "map-ont",
                 devices: list | None = None, index_arrays=None):
        if preset not in ("map-ont", "splice"):
            raise ValueError(f"unknown preset {preset!r}")
        self.index = index
        self.device = torch.device(device)
        self.max_minimizers = max_minimizers
        self.max_intron = MAX_INTRON if preset == "splice" else 0
        self.devices = ([torch.device(d) for d in devices] if devices
                        else [self.device])
        self._idx = {}
        if index_arrays is not None:
            if len(self.devices) != 1:
                raise ValueError("index_arrays serve one device")
            self._idx[self.devices[0]] = tuple(index_arrays)
        for d in self.devices:
            if d not in self._idx:
                self._idx[d] = prepare_index_arrays(index, d)

    def _chain(self, codes: np.ndarray, lengths: np.ndarray,
               shard: int = 0) -> dict:
        L = codes.shape[1]
        # minimizer density is ~2/(W+1) ~ 0.18; L/4 leaves headroom so long
        # concatemers keep their tail seeds
        m = self.max_minimizers or max(64, ((L // 4) + 63) // 64 * 64)
        dev = self.devices[shard % len(self.devices)]
        dev_codes = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
        dev_lengths = torch.from_numpy(
            np.asarray(lengths, np.int32)).to(dev)
        out = seed_and_chain(dev_codes, dev_lengths, *self._idx[dev],
                             max_minimizers=m, max_intron=self.max_intron)
        # the uploaded batch rides along for the flank scan
        out["dev_codes"] = dev_codes
        out["dev_lengths"] = dev_lengths
        return out

    def align(self, codes: np.ndarray, lengths: np.ndarray
              ) -> AlignmentRecords:
        return extract_records(self._chain(codes, lengths), self.index)

    def align_with_exons(self, codes: np.ndarray, lengths: np.ndarray,
                         min_intron: int = 50):
        """(records, exon blocks per record): the genome stage's entry."""
        out = self._chain(codes, lengths)
        rec = extract_records(out, self.index)
        return rec, extract_exons(out, rec, min_intron=min_intron)
