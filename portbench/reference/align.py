"""Plain seed-and-chain aligner: which alignment records a read has.

A frozen plain copy of the semantics the program states for its panel
aligner (minimap2 `-x map-ont`, primary plus supplementary records):

1. minimizers (k = 15, w = 10) of the read and of every reference: in each
   window of w consecutive k-mer positions (windows run past the end,
   never before the start) the rightmost smallest hash is a minimizer; the
   hash is a murmur3-style 32-bit finalizer of the canonical 2-bit k-mer,
   masked to 30 bits; N-holding and palindromic k-mers are skipped;
2. the reference minimizers sorted by hash (stable); a read minimizer
   looks up the first 16 entries of its 20-bit hash-prefix bucket and
   keeps those with its hash (the frequent-seed cap);
3. anchors (seg = 2 * ref + relative strand, t, q) sorted, at most 4 m of
   them kept for m minimizer slots (m from the batch width), the first m
   minimizers only;
4. the colinear chain DP over the 64 anchors before each one, float32 as
   the program states it (score min(dq, dt, k) - 0.01 k dd - 0.5 log2 dd,
   the last best predecessor), chains of >= 3 anchors scoring >= 40;
5. primary selection: chains by score, a chain overlapping the query span
   of a kept one by half its length or more is dropped, the others kept as
   supplementary;
6. each record end extended base by base (match 2, mismatch -4, gap -4,
   the best cell of a free-ended DP over 48 bases), up to four rounds.

NumPy, and plain PyTorch on the CPU for the two float and integer DPs.
Nothing of the program is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import plain

K, W = 15, 10
MASK = (1 << 30) - 1
HINF = 0xFFFFFFFF
PREFIX_SHIFT = 10              # 30-bit hashes, 20-bit prefix buckets
OCC_CAP = 16
MAX_GAP, BANDWIDTH = 5000, 500
MIN_CHAIN_SCORE, MIN_CHAIN_CNT = 40, 3
MASK_LEVEL = 0.5
G = 64                         # chain DP look-back
NEGF = -1e18
SEG_INVALID = 1 << 30
F_EXT = 48
EXT_MATCH, EXT_MIS, EXT_GAP = 2, -4, -4
NEGI = -(1 << 20)


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
    pw = 4 ** np.arange(K - 1, -1, -1, dtype=np.int64)
    fwd = (b * pw).sum(axis=1)
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


class Index:
    """The minimizer index of a panel: references in file order."""

    def __init__(self, names: list, seqs: list):
        self.names = list(names)
        self.codes = [plain.encode(s) for s in seqs]
        self.lens = np.asarray([len(s) for s in seqs], np.int64)
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
    def from_fastas(cls, paths: list) -> "Index":
        names, seqs = [], []
        for p in paths:
            for nm, s in plain.read_fasta_records(p):
                if nm.strip():
                    names.append(nm.split()[0])
                    seqs.append(s.upper())
        return cls(names, seqs)


def anchors(index: Index, codes: np.ndarray, width: int) -> tuple:
    """(t, q, qpos, seg) of one read's sorted anchors, as a batch
    `width` bases wide keeps them."""
    m = minimizer_slots(width)
    n_pos = width - K + 1
    hq, pos, strand = minimizers(codes)
    keep = min(m, n_pos)
    hq, pos, strand = hq[:keep], pos[:keep], strand[:keep]
    st = index.pstart[hq >> PREFIX_SHIFT]
    cnt = np.minimum(index.pcount[hq >> PREFIX_SHIFT], OCC_CAP)
    o = np.arange(OCC_CAP)[None]
    e = np.minimum(st[:, None] + o, max(len(index.h) - 1, 0))
    ok = (o < cnt[:, None])
    if len(index.h):
        ok &= index.h[e] == hq[:, None]
    else:
        ok &= False
    seg_i = index.seg[e]
    rel = (seg_i & 1) ^ strand[:, None]
    seg = (seg_i & ~1) | rel
    rlen = len(codes)
    q = np.where(rel == 1, rlen - K - pos[:, None], pos[:, None])
    qpos = np.broadcast_to(pos[:, None], ok.shape)
    t, q, qpos, seg = (x[ok] for x in (index.t[e], q, qpos, seg))
    order = np.lexsort((q, t, seg))[:4 * m]
    return t[order], q[order], qpos[order], seg[order]


def chain(t, q, seg, valid):
    """The chain DP over (B, A) sorted anchors, float32: (f, root)."""
    B, A = t.shape
    f32 = torch.float32
    tf = torch.cat([torch.full((B, G), -3e9, dtype=f32), t.to(f32)], dim=1)
    qf = torch.cat([torch.zeros((B, G), dtype=f32), q.to(f32)], dim=1)
    sg = torch.cat([torch.full((B, G), -7, dtype=torch.int64), seg], dim=1)
    f = torch.full((B, A + G), NEGF, dtype=f32)
    roots = torch.full((B, A + G), -1, dtype=torch.int64)
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
        cand = torch.where(ok, (wf + dg) - gap, negf)
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


def records(index: Index, reads: list, width, extend: bool = True) -> list:
    """The alignment records of each read (codes), in the program's record
    order: a list of dicts (ref, strand, flag, qstart, qend, tstart, tend,
    score) per read, q in the read's own orientation. `width` is the batch
    width of every read, or a list of one per read."""
    widths = (list(width) if isinstance(width, (list, tuple, np.ndarray))
              else [width] * len(reads))
    an = [anchors(index, c, w) for c, w in zip(reads, widths)]
    A = max([1] + [len(a[0]) for a in an])
    B = len(reads)
    t = np.zeros((B, A), np.int64)
    q = np.zeros((B, A), np.int64)
    qp = np.full((B, A), -1, np.int64)
    seg = np.full((B, A), SEG_INVALID, np.int64)
    for b, (tt, qq, pp, ss) in enumerate(an):
        n = len(tt)
        t[b, :n], q[b, :n], qp[b, :n], seg[b, :n] = tt, qq, pp, ss
    valid = seg != SEG_INVALID
    f, root = (chain(torch.from_numpy(t), torch.from_numpy(q),
                     torch.from_numpy(seg), torch.from_numpy(valid))
               if B else (np.zeros((0, A)), np.zeros((0, A), np.int64)))
    out = []
    for b in range(B):
        v = valid[b]
        labs = np.unique(root[b][v])
        chains = []
        for lab in labs:
            mem = v & (root[b] == lab)
            if mem.sum() < MIN_CHAIN_CNT:
                continue
            fmax = float(f[b][mem].max())
            if fmax < MIN_CHAIN_SCORE:
                continue
            sg = int(seg[b][mem].max())
            ref = sg >> 1
            chains.append({
                "ref": ref, "strand": sg & 1, "score": fmax,
                "qstart": int(qp[b][mem].min()),
                "qend": int(qp[b][mem].max()) + K,
                "tstart": int(t[b][mem].min()),
                "tend": min(int(t[b][mem].max()) + K,
                            int(index.lens[ref]))})
        out.append(_primary(chains))
    if extend:
        _extend(index, [(c, r) for c, recs in zip(reads, out) for r in recs])
    return out


def _primary(chains: list) -> list:
    """Flags by score-descending greedy query overlap; dropped chains
    leave."""
    order = sorted(range(len(chains)), key=lambda i: -chains[i]["score"])
    kept = []
    for i in order:
        c = chains[i]
        a, b = c["qstart"], c["qend"]
        ov = max([0] + [min(b, kb) - max(a, ka) for ka, kb in kept])
        if not kept:
            c["flag"] = 16 * c["strand"]
        elif ov < MASK_LEVEL * (b - a):
            c["flag"] = 2048 + 16 * c["strand"]
        else:
            continue
        kept.append((a, b))
    return [c for c in chains if "flag" in c]


def _ext_best(qf: np.ndarray, qn, tf: np.ndarray, tn):
    """(query, target) bases of the best cell of each free-ended DP: ties
    to the first row reached, then the smallest column."""
    N, F = qf.shape
    q = torch.from_numpy(qf.astype(np.int32))
    t = torch.from_numpy(tf.astype(np.int32))
    qn = torch.from_numpy(np.asarray(qn, np.int32))
    tn = torch.from_numpy(np.asarray(tn, np.int32))
    jj = torch.arange(F + 1, dtype=torch.int32)[None]
    row = torch.where(jj <= tn[:, None], EXT_GAP * jj,
                      NEGI).to(torch.int32)
    best = torch.zeros(N, dtype=torch.int32)
    bi = torch.zeros(N, dtype=torch.int32)
    bj = torch.zeros(N, dtype=torch.int32)
    for i in range(1, F + 1):
        qi = q[:, i - 1:i]
        s = torch.where((qi == t) & (qi < 4) & (qi >= 0), EXT_MATCH, EXT_MIS)
        new = torch.maximum(row[:, :-1] + s, row[:, 1:] + EXT_GAP)
        head = torch.where(i <= qn, EXT_GAP * i, NEGI)[:, None]
        cur = torch.cat([head.to(torch.int32), new.to(torch.int32)], dim=1)
        cur = torch.cummax(cur - EXT_GAP * jj, dim=1).values + EXT_GAP * jj
        cur = torch.where((jj <= tn[:, None]) & (i <= qn[:, None]), cur,
                          NEGI).to(torch.int32)
        rb = cur.max(dim=1).values
        rj = (cur == rb[:, None]).to(torch.int32).argmax(dim=1)
        up = rb > best
        best = torch.where(up, rb, best)
        bi = torch.where(up, i, bi)
        bj = torch.where(up, rj.to(torch.int32), bj)
        row = cur
    return bi.numpy().astype(np.int64), bj.numpy().astype(np.int64)


def _extend(index: Index, recs: list, rounds: int = 4) -> None:
    """Extend the ends of each (read codes, record) in place, in stored
    orientation, rounds repeated for ends that took nearly the whole
    flank."""
    F = F_EXT
    for codes, r in recs:
        n, st = len(codes), r["strand"]
        r["_s"] = plain.revcomp_codes(codes) if st else codes
        r["_qs"] = n - r["qend"] if st else r["qstart"]
        r["_qe"] = n - r["qstart"] if st else r["qend"]
    active = [r for _, r in recs]
    for _ in range(rounds):
        if not active:
            break
        n = len(active)
        qf = np.full((2 * n, F), -1, np.int8)
        tf = np.full((2 * n, F), -1, np.int8)
        qn = np.zeros(2 * n, np.int32)
        tn = np.zeros(2 * n, np.int32)
        for k, r in enumerate(active):
            s, ref = r["_s"], index.codes[r["ref"]]
            parts = (s[max(r["_qs"] - F, 0):r["_qs"]][::-1],
                     ref[max(r["tstart"] - F, 0):r["tstart"]][::-1],
                     s[r["_qe"]:r["_qe"] + F], ref[r["tend"]:r["tend"] + F])
            for row, (qq, tt) in ((2 * k, parts[:2]), (2 * k + 1, parts[2:])):
                qf[row, :len(qq)], tf[row, :len(tt)] = qq, tt
                qn[row], tn[row] = len(qq), len(tt)
        qi, tj = _ext_best(qf, qn, tf, tn)
        qi, tj = qi.reshape(n, 2), tj.reshape(n, 2)
        nxt = []
        for k, r in enumerate(active):
            r["_qs"] -= qi[k, 0]
            r["_qe"] += qi[k, 1]
            r["tstart"] -= tj[k, 0]
            r["tend"] += tj[k, 1]
            if ((qi[k] >= F - 4) | (tj[k] >= F - 4)).any() and \
                    (qi[k] + tj[k]).sum() > 0:
                nxt.append(r)
        active = nxt
    for codes, r in recs:
        n, st = len(codes), r["strand"]
        r["qstart"] = int(n - r["_qe"] if st else r["_qs"])
        r["qend"] = int(n - r["_qs"] if st else r["_qe"])
        r["tstart"], r["tend"] = int(r["tstart"]), int(r["tend"])
        for k in ("_s", "_qs", "_qe"):
            del r[k]
