"""Plain genome stage: the spliced, tagged genome record of one subread.

A plain copy of the semantics that nanoranger_torch's genome stage states
(`pipeline.genome_stage`, minimap2 `-x splice` as the port approximates
it), in NumPy and plain PyTorch on the CPU, float32. No operation here is
a matrix product, so TF32 never applies. Nothing of the program and
nothing of JAX is imported.

1. minimizers (k = 15, w = 10) of the subread and of every reference: in
   each window of w consecutive k-mer positions (windows run past the end,
   never before the start) the rightmost smallest hash is a minimizer; the
   hash is a murmur3-style 32-bit finalizer of the canonical 2-bit k-mer,
   masked to 30 bits; N-holding and palindromic k-mers are skipped;
2. the reference minimizers sorted by hash (stable); a subread minimizer
   looks up the first 16 entries of its 20-bit hash-prefix bucket and
   keeps those with its hash;
3. anchors (seg = 2 * ref + relative strand, t, q) sorted, at most 4 m of
   them kept for m minimizer slots (m from the batch width), the first m
   minimizers only; q counts on the stored strand (the reverse complement
   for strand 1);
4. the chain DP over the 64 anchors before each one, float32: the
   colinear arm min(dq, dt, k) - 0.01 k dd - 0.5 log2 dd (0 < dt, dq <=
   5000, dd <= 500) and the intron arm min(dq, dt, k) - (0.01 k dq + 6 +
   0.5 log2 (dt - dq)) (0 < dq <= 5000, dt - dq > 500, dt <= 200,000), the
   colinear arm where both admit a predecessor; the last best
   predecessor; chains of >= 3 anchors scoring >= 40;
5. the primary record: the best chain (ties to the lower root);
6. exon blocks at min_intron 50: the chain's anchors, t ascending, cut
   where the target step exceeds the query step by min_intron or more;
   a block runs from its first anchor to its last anchor + k;
7. each block clipped against the end of the block kept before it: both
   starts advance by the larger of the query and the target overlap, and a
   block the clip empties is dropped;
8. each block aligned globally, affine (match 2, mismatch or N -4, gap
   open -4, extend -2), in a band of max(160, |lq - lt| + 16) around the
   diagonal i * lt // lq; ties: diagonal from M before X before Y, a gap
   extended before it is opened; the traceback starts in M, then X, then Y;
9. the record: position the first anchor's t, flag 0 or 16, SEQ the
   subread on the stored strand, CIGAR the query before the first block
   soft-clipped, the blocks' CIGARs joined by N for a target gap and I
   for a query gap, the query after the last block soft-clipped; NM the
   blocks' edits plus a query gap that no N precedes; AS the sum of the
   blocks' scores.

Departures from minimap2 `-x splice`: no splice-site model (no GT-AG
scores, no `--splice-flank`), one flat intron-open cost and a log2 of the
intron's length in the chain; one affine gap class (minimap2 takes two,
-O4,24 -E2,1) and a fixed band; no z-drop and no end extension: the
subread beyond the first and last anchors is soft-clipped; exon ends sit
at anchors, not at refined junctions, and an exon too short to hold an
anchor becomes part of a gap; no MAPQ; only the primary record (the
program writes flags below 20 alone), no secondary or supplementary ones.
"""

from __future__ import annotations

import gzip

import numpy as np
import torch

K, W = 15, 10
MASK = (1 << 30) - 1
HINF = 0xFFFFFFFF
PREFIX_SHIFT = 10              # 30-bit hashes, 20-bit prefix buckets
OCC_CAP = 16
MAX_GAP, BANDWIDTH = 5000, 500
MAX_INTRON, SPLICE_PEN = 200_000, 6.0
MIN_CHAIN_SCORE, MIN_CHAIN_CNT = 40, 3
G = 64                         # chain DP look-back
NEGF = -1e18
SEG_INVALID = 1 << 30
MIN_INTRON = 50
BAND = 160
MATCH, MISMATCH, GAP_OPEN, GAP_EXT = 2, -4, -4, -2
NEG = -(1 << 28)

A, C, G_, T, N, PAD = 0, 1, 2, 3, 4, 5
_CODE = np.full(256, N, np.int8)
for _ch, _v in zip(b"ACGTacgt", (A, C, G_, T, A, C, G_, T)):
    _CODE[_ch] = _v
COMP = np.array([T, G_, C, A, N, PAD], np.int8)


def encode(seq: bytes) -> np.ndarray:
    return _CODE[np.frombuffer(seq, np.uint8)]


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP[codes[::-1]]


def read_fasta(path: str) -> tuple:
    """(names, sequences as codes) of a FASTA(.gz) in file order; a name
    is the header's first word."""
    names, seqs, parts = [], [], None
    with (gzip.open if path.endswith(".gz") else open)(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if parts is not None:
                    seqs.append(encode(b"".join(parts).upper()))
                names.append(line[1:].decode().split()[0])
                parts = []
            elif parts is not None:
                parts.append(line)
    if parts is not None:
        seqs.append(encode(b"".join(parts).upper()))
    return names, seqs


# --------------------------------------------------------------------------
# seeds and chains

def minimizer_slots(width: int) -> int:
    """Minimizer slots of a batch `width` bases wide."""
    return max(64, ((width // 4) + 63) // 64 * 64)


def _mix32(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint64)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & np.uint64(0xFFFFFFFF)
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & np.uint64(0xFFFFFFFF)
    h ^= h >> np.uint64(16)
    return (h & np.uint64(MASK)).astype(np.int64)


def minimizers(codes: np.ndarray) -> tuple:
    """(hash, position, strand) of every minimizer of one sequence, by
    position."""
    n = len(codes) - K + 1
    if n <= 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    c = np.lib.stride_tricks.sliding_window_view(
        codes.astype(np.int64), K)                      # (n, K)
    ok = (c < 4).all(axis=1)
    b = c & 3
    fwd = (b * 4 ** np.arange(K - 1, -1, -1, dtype=np.int64)).sum(axis=1)
    rev = ((3 - b) * (4 ** np.arange(K, dtype=np.int64))).sum(axis=1)
    strand = (rev < fwd).astype(np.int64)
    ok &= fwd != rev
    h = np.where(ok, _mix32(np.minimum(fwd, rev)), HINF)
    padded = np.concatenate([h, np.full(W - 1, HINF, np.int64)])
    win = np.lib.stride_tricks.sliding_window_view(padded, W)  # (n, W)
    low = win.min(axis=1)
    right = W - 1 - np.argmin(win[:, ::-1], axis=1)            # rightmost
    pick = np.unique((np.arange(n) + right)[low < HINF])
    return h[pick], pick, strand[pick]


class Genome:
    """The minimizer index of a genome: references in file order."""

    def __init__(self, names: list, codes: list):
        self.names = list(names)
        self.codes = list(codes)
        hs, ts, ss = [], [], []
        for rid, cd in enumerate(self.codes):
            h, p, s = minimizers(cd)
            hs.append(h)
            ts.append(p)
            ss.append(rid * 2 + s)
        h = np.concatenate(hs)
        order = np.argsort(h, kind="stable")
        self.h = h[order]
        self.t = np.concatenate(ts)[order]
        self.seg = np.concatenate(ss)[order]
        pref = self.h >> PREFIX_SHIFT
        self.pcount = np.bincount(pref, minlength=1 << 20)
        self.pstart = np.concatenate([[0], np.cumsum(self.pcount)[:-1]])

    @classmethod
    def from_fasta(cls, path: str) -> "Genome":
        return cls(*read_fasta(path))


def anchors(genome: Genome, codes: np.ndarray, width: int) -> tuple:
    """(t, q, seg) of one subread's sorted anchors, as a batch `width`
    bases wide keeps them."""
    m = minimizer_slots(width)
    hq, pos, strand = minimizers(codes)
    keep = min(m, width - K + 1)
    hq, pos, strand = hq[:keep], pos[:keep], strand[:keep]
    st = genome.pstart[hq >> PREFIX_SHIFT]
    cnt = np.minimum(genome.pcount[hq >> PREFIX_SHIFT], OCC_CAP)
    o = np.arange(OCC_CAP)[None]
    e = np.minimum(st[:, None] + o, max(len(genome.h) - 1, 0))
    ok = (o < cnt[:, None]) & (genome.h[e] == hq[:, None])
    seg_i = genome.seg[e]
    rel = (seg_i & 1) ^ strand[:, None]
    seg = (seg_i & ~1) | rel
    q = np.where(rel == 1, len(codes) - K - pos[:, None], pos[:, None])
    t, q, seg = (x[ok] for x in (genome.t[e], q, seg))
    order = np.lexsort((q, t, seg))[:4 * m]
    return t[order], q[order], seg[order]


def chain(t, q, seg, valid):
    """The splice chain DP over (B, A) sorted anchors, float32: (f, root)."""
    B, A_ = t.shape
    f32 = torch.float32
    tf = torch.cat([torch.full((B, G), -3e9, dtype=f32), t.to(f32)], dim=1)
    qf = torch.cat([torch.zeros((B, G), dtype=f32), q.to(f32)], dim=1)
    sg = torch.cat([torch.full((B, G), -7, dtype=torch.int64), seg], dim=1)
    f = torch.full((B, A_ + G), NEGF, dtype=f32)
    roots = torch.full((B, A_ + G), -1, dtype=torch.int64)
    sub = torch.arange(G)[None, :]
    negf = torch.tensor(NEGF, dtype=f32)
    coef = 0.01 * K
    live = torch.nonzero(valid.any(dim=0))
    n_cols = int(live[-1, 0]) + 1 if len(live) else 0
    for i in range(n_cols):
        wt, wq = tf[:, i:i + G], qf[:, i:i + G]
        ws, wf = sg[:, i:i + G], f[:, i:i + G]
        ti, qi = tf[:, i + G:i + G + 1], qf[:, i + G:i + G + 1]
        si = sg[:, i + G:i + G + 1]
        dt, dq = ti - wt, qi - wq
        dd = torch.abs(dq - dt)
        dg = torch.clamp(torch.minimum(dq, dt), max=float(K))
        gap = coef * dd + 0.5 * torch.log2(torch.clamp(dd, min=1.0))
        gap = torch.where(dd > 0, gap, torch.zeros_like(gap))
        same = (ws == si) & (wf > NEGF / 2)
        ok = same & (dt > 0) & (dq > 0) & (dt <= MAX_GAP) & \
            (dq <= MAX_GAP) & (dd <= BANDWIDTH)
        gap_s = coef * dq + SPLICE_PEN + \
            0.5 * torch.log2(torch.clamp(dt - dq, min=1.0))
        ok_s = same & (dq > 0) & (dq <= MAX_GAP) & \
            (dt - dq > BANDWIDTH) & (dt <= MAX_INTRON)
        gap = torch.where(ok, gap, gap_s)
        cand = torch.where(ok | ok_s, (wf + dg) - gap, negf)
        best = cand.max(dim=1, keepdim=True).values
        bestg = torch.where(cand == best, sub, -1).max(dim=1,
                                                       keepdim=True).values
        ext = best > float(K)
        root = torch.where(ext, torch.gather(roots[:, i:i + G], 1,
                                             bestg.clamp(min=0)), i)
        vi = valid[:, i:i + 1]
        f[:, i + G:i + G + 1] = torch.where(
            vi, torch.clamp(best, min=float(K)), negf)
        roots[:, i + G:i + G + 1] = torch.where(vi, root, -1)
    return f[:, G:].numpy(), roots[:, G:].numpy()


def primary_chains(genome: Genome, reads: list, widths: list) -> list:
    """Each subread's primary chain (dict: ref, strand, score, the chain's
    anchors t and q, t ascending), or None."""
    an = [anchors(genome, c, w) for c, w in zip(reads, widths)]
    A_ = max([1] + [len(a[0]) for a in an])
    B = len(reads)
    t = np.zeros((B, A_), np.int64)
    q = np.zeros((B, A_), np.int64)
    seg = np.full((B, A_), SEG_INVALID, np.int64)
    for b, (tt, qq, ss) in enumerate(an):
        t[b, :len(tt)], q[b, :len(tt)], seg[b, :len(tt)] = tt, qq, ss
    valid = seg != SEG_INVALID
    if not B:
        return []
    f, root = chain(torch.from_numpy(t), torch.from_numpy(q),
                    torch.from_numpy(seg), torch.from_numpy(valid))
    out = []
    for b in range(B):
        v = valid[b]
        best = None
        for lab in np.unique(root[b][v]):
            mem = v & (root[b] == lab)
            score = float(f[b][mem].max())
            if mem.sum() < MIN_CHAIN_CNT or score < MIN_CHAIN_SCORE:
                continue
            if best is None or score > best["score"]:
                sg = int(seg[b][mem].max())
                best = {"ref": sg >> 1, "strand": sg & 1, "score": score,
                        "t": t[b][mem], "q": q[b][mem]}
        out.append(best)
    return out


# --------------------------------------------------------------------------
# exon blocks

def exon_blocks(ts: np.ndarray, qs: np.ndarray,
                min_intron: int = MIN_INTRON) -> list:
    """[(t_lo, t_hi, q_lo, q_hi)] of a chain's anchors (t ascending)."""
    cut = np.flatnonzero(np.diff(ts) - np.diff(qs) >= min_intron) + 1
    lo, hi = np.r_[0, cut], np.r_[cut - 1, len(ts) - 1]
    return [(int(ts[a]), int(ts[b]) + K, int(qs[a]), int(qs[b]) + K)
            for a, b in zip(lo, hi)]


def clip_blocks(blocks: list) -> list:
    """Each block clipped against the end of the block kept before it."""
    out = [blocks[0]]
    for (t_lo, t_hi, q_lo, q_hi) in blocks[1:]:
        ov = max(out[-1][1] - t_lo, out[-1][3] - q_lo, 0)
        t_lo, q_lo = t_lo + ov, q_lo + ov
        if t_lo < t_hi and q_lo < q_hi:
            out.append((t_lo, t_hi, q_lo, q_hi))
    return out


# --------------------------------------------------------------------------
# the base alignment of a block

def global_align(q: np.ndarray, t: np.ndarray, band: int = BAND) -> tuple:
    """(CIGAR as [(n, op)], score, NM) of the banded global alignment of q
    against t (ops =, X, I, D). Rows in NumPy: M and X from the row
    before, Y along the row as a running maximum."""
    lq, lt = len(q), len(t)
    if lq == 0 and lt == 0:
        return [], 0, 0
    band = max(band, abs(lq - lt) + 16)
    bw = 2 * band + 1
    bi = np.arange(bw)
    q = np.asarray(q, np.int64)
    tp = np.concatenate([[-1], np.asarray(t, np.int64)])

    def center(i):
        return i * lt // lq if lq else 0

    j = center(0) - band + bi
    pm = np.where(j == 0, 0, NEG)
    px = np.full(bw, NEG, np.int64)
    py = np.where((j > 0) & (j <= lt), GAP_OPEN + GAP_EXT * j, NEG)
    tb = np.zeros((lq + 1, bw), np.uint8)
    half = NEG // 2
    for i in range(1, lq + 1):
        ci = center(i)
        shift = ci - center(i - 1)
        j = ci - band + bi
        inr = (j >= 0) & (j <= lt)
        # M: the diagonal from the row before, column j - 1
        bd = bi + shift - 1
        bdc = np.clip(bd, 0, bw - 1)
        dm, dx, dy = pm[bdc], px[bdc], py[bdc]
        gx = dx > dm
        best = np.where(gx, dx, dm)
        src = gx.astype(np.int64)
        gy = dy > best
        best = np.where(gy, dy, best)
        src = np.where(gy, 2, src)
        qi = q[i - 1]
        s = np.where((tp[np.clip(j, 0, lt)] == qi) & (qi < 4), MATCH,
                     MISMATCH)
        okm = inr & (j >= 1) & (bd >= 0) & (bd < bw) & (best > half)
        cm = np.where(okm, best + s, NEG)
        code = np.where(okm, src, 0)
        # X: a query base from the row before, column j
        bx = bi + shift
        bxc = np.clip(bx, 0, bw - 1)
        okx = inr & (bx >= 0) & (bx < bw)
        op = np.maximum(pm[bxc], py[bxc]) + GAP_OPEN + GAP_EXT
        ex = px[bxc] + GAP_EXT
        takex = okx & (ex >= op) & (ex > half)
        cx = np.where(takex, ex, np.where(okx & (op > half), op, NEG))
        code |= np.where(takex, 4, 0)
        # Y: a target base from column j - 1 of this row
        oky = inr & (bi >= 1) & (j >= 1)
        op = np.where(oky, np.maximum(np.r_[NEG, cm[:-1]],
                                      np.r_[NEG, cx[:-1]])
                      + GAP_OPEN + GAP_EXT, NEG)
        run = np.maximum.accumulate(op - GAP_EXT * bi) + GAP_EXT * bi
        cy = np.where(oky & (run > half), run, NEG)
        ey = np.r_[NEG, cy[:-1]] + GAP_EXT
        code |= np.where(oky & (ey >= op) & (ey > half), 8, 0)
        tb[i] = code
        pm, px, py = cm, cx, cy
    bT = lt - center(lq) + band
    score = int(max(pm[bT], px[bT], py[bT]))
    state = 0 if score == pm[bT] else (1 if score == px[bT] else 2)
    ops, i, j, nm = [], lq, lt, 0
    while i > 0 or j > 0:
        code = int(tb[i][j - center(i) + band]) if i > 0 and j > 0 else 0
        if i == 0:
            ops.append("D")
            j -= 1
        elif j == 0:
            ops.append("I")
            i -= 1
        elif state == 0:
            eq = q[i - 1] == tp[j] and q[i - 1] < 4
            ops.append("=" if eq else "X")
            state = code & 3
            i -= 1
            j -= 1
        elif state == 1:
            ops.append("I")
            state = 1 if code & 4 else 0
            i -= 1
        else:
            ops.append("D")
            state = 2 if code & 8 else 0
            j -= 1
        nm += ops[-1] != "="
    ops.reverse()
    cig, k = [], 0
    while k < len(ops):
        r = k
        while r < len(ops) and ops[r] == ops[k]:
            r += 1
        cig.append((r - k, ops[k]))
        k = r
    return cig, score, nm


# --------------------------------------------------------------------------
# the record

def genome_records(genome: Genome, reads: list, widths: list,
                   tags: list | None = None) -> list:
    """Each subread's primary genome record, or None: a dict of ref (its
    index), pos, flag, seq (codes, stored strand), cigar [(n, op)], NM, AS
    and the given tags (CB, UB, XT)."""
    out = []
    for k, (codes, ch) in enumerate(zip(
            reads, primary_chains(genome, reads, widths))):
        if ch is None:
            out.append(None)
            continue
        stored = revcomp(codes) if ch["strand"] else codes
        ref = genome.codes[ch["ref"]]
        blocks = clip_blocks(exon_blocks(ch["t"], ch["q"]))
        cig = [(blocks[0][2], "S")] if blocks[0][2] else []
        nm = score = 0
        for e, (t_lo, t_hi, q_lo, q_hi) in enumerate(blocks):
            if e:
                t_gap, q_gap = t_lo - blocks[e - 1][1], q_lo - blocks[e - 1][3]
                if t_gap > 0:
                    cig.append((t_gap, "N"))
                if q_gap > 0:
                    cig.append((q_gap, "I"))
                    nm += 0 if t_gap else q_gap
            c, s, n = global_align(stored[q_lo:q_hi], ref[t_lo:t_hi])
            cig += c
            score += s
            nm += n
        if len(stored) > blocks[-1][3]:
            cig.append((len(stored) - blocks[-1][3], "S"))
        out.append({"ref": ch["ref"], "pos": blocks[0][0],
                    "flag": 16 * ch["strand"], "seq": stored, "cigar": cig,
                    "tags": {"NM": nm, "AS": score,
                             **(tags[k] if tags else {})}})
    return out


def cigar_fault(rec: dict, seq: np.ndarray, ref: np.ndarray) -> str:
    """Why a record's CIGAR is wrong, or "": it must span the sequence,
    its = and X operations must agree with the reference, and NM must
    count every X, D and I but an I right after an N (the query between
    two exon blocks)."""
    qi, ti, nm = 0, rec["pos"], 0
    prev = None
    for k, (n, op) in enumerate(rec["cigar"]):
        if op in "=X" and ti + n > len(ref):
            return f"op {k} {n}{op} runs past the reference"
        if op == "=" and not np.array_equal(seq[qi:qi + n], ref[ti:ti + n]):
            return f"op {k} {n}= differs from the reference at {ti}"
        if op == "X" and (seq[qi:qi + n] == ref[ti:ti + n]).any():
            return f"op {k} {n}X equals the reference at {ti}"
        if op in "=XMIS":
            qi += n
        if op in "=XMDN":
            ti += n
        if op in "XD" or (op == "I" and prev != "N"):
            nm += n
        prev = op
    if qi != len(seq):
        return f"spans {qi} of {len(seq)} bases"
    if ti > len(ref):
        return "ends past the reference"
    if nm != rec["tags"].get("NM"):
        return f"NM {rec['tags'].get('NM')}, edits {nm}"
    return ""
