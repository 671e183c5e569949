"""Plain CDR3 caller: the clone call each VDJ subread should get.

A frozen plain copy of the semantics the program states for its native
clonotyper (the MiXCR align + assemble replacement), read by read:

1. V assignment: the plain aligner (reference/align.py, no extension)
   over the merged V panels, as a batch of the subread file is as wide;
   the best forward-strand record by whole score, the first on ties;
2. frame pinning: the subread's aligned span against the V's aligned
   span, banded global affine alignment (match 2, mismatch -4, gap open
   -4, extend -2; band max(48, |lq - lt| + 16) around the diagonal),
   whose CIGAR maps the V's conserved Cys (the last Cys codon of its final
   15 codons) into the subread; or an ungapped extension of at most 9
   bases past the alignment's end;
3. the CDR3: from the Cys in frame to the first [FW]GxG motif (5 to 35
   codons), stop-free in frame 0, frames +1 and +2 as indel rescues;
   a read that ends inside the motif scan gives a partial junction;
4. the clone a read joins: clean calls (in frame, starting with C) found
   clones keyed by (chain, CDR3 nt); a clone of at most half another's
   size within max(1, len // 20) edits (or sharing a 24-base suffix)
   folds into it; rescued calls join the nearest clone within
   max(2, len // 10) edits and 6 bases of length; partial ones a unique
   clone whose CDR3 prefix is within that cap.

Step 4 is judged as a bound: a clean call must be in the clone table
under a clone whose CDR3 is within its folding distance, a rescued or
partial one only under a clone within its cap, and a subread with no call
not at all. Plain Python and NumPy; nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np

from . import align, plain

MIN_TAIL_COVER = 9
MAX_EXTRAPOLATE = 9
FALLBACK_VTAIL = 60
FALLBACK_MAX_NMFRAC = 0.40
PARTIAL_MIN_NT = 15
PARTIAL_WINDOW_NT = 3 * (35 + 4) + 2
BAND = 48
MATCH, MISMATCH, GAP_OPEN, GAP_EXT = 2, -4, -4, -2
NEG = -(1 << 28)
NESTED_MIN_NT = 24
RESCUE_LEN_DIFF = 6

_STD = ("TTT F TTC F TTA L TTG L CTT L CTC L CTA L CTG L ATT I ATC I ATA I "
        "ATG M GTT V GTC V GTA V GTG V TCT S TCC S TCA S TCG S CCT P CCC P "
        "CCA P CCG P ACT T ACC T ACA T ACG T GCT A GCC A GCA A GCG A TAT Y "
        "TAC Y TAA * TAG * CAT H CAC H CAA Q CAG Q AAT N AAC N AAA K AAG K "
        "GAT D GAC D GAA E GAG E TGT C TGC C TGA * TGG W CGT R CGC R CGA R "
        "CGG R AGT S AGC S AGA R AGG R GGT G GGC G GGA G GGG G").split()
CODON = dict(zip(_STD[::2], _STD[1::2]))
_ASCII = "ACGTN."


def decode(codes) -> str:
    return "".join(_ASCII[int(c)] for c in codes)


def translate(codes) -> str:
    s = decode(codes)
    return "".join(CODON.get(s[i:i + 3], "X")
                   for i in range(0, len(s) - len(s) % 3, 3))


def cys_position(v: np.ndarray) -> int:
    aa = translate(v)
    if not aa:
        return -1
    p = aa.rfind("C", max(0, len(aa) - 15))
    return -1 if p < 0 else 3 * p


def _motif(aa: str, lo: int = 5, hi: int = 35) -> int:
    for i in range(lo - 1, min(len(aa) - 3, hi)):
        if aa[i] in "FW" and aa[i + 1] == "G" and aa[i + 3] == "G":
            return i
    return -1


def cdr3(read: np.ndarray, cys: int, require_cys: bool):
    """(nt, aa) of the junction from the Cys at `cys`, or None."""
    if cys < 0 or cys + 15 > len(read):
        return None
    tail = read[cys:cys + 3 * 39 + 2]
    aa0 = translate(tail)
    if not aa0 or (require_cys and aa0[0] != "C"):
        return None
    for f in (0, 1, 2):
        aa = aa0 if f == 0 else translate(tail[f:])
        if not aa:
            continue
        i = _motif(aa)
        if i < 0 or (f == 0 and "*" in aa[:i + 1]):
            continue
        return decode(tail[:3 * (i + 1) + f]), aa0[:i + 1] + ("" if f == 0
                                                              else "_")
    return None


def banded_global(q: np.ndarray, t: np.ndarray, band: int = BAND):
    """(CIGAR, score, NM) of the banded global alignment of q against t;
    ("", NEG, -1) where the end falls outside the band."""
    lq, lt = len(q), len(t)
    if lq == 0 and lt == 0:
        return "", 0, 0
    band = max(band, abs(lq - lt) + 16)
    bw = 2 * band + 1

    def center(i):
        return i * lt // lq if lq else 0

    q = [int(x) for x in q]
    t = [int(x) for x in t]
    pm, px, py = [NEG] * bw, [NEG] * bw, [NEG] * bw
    for b in range(bw):
        j = center(0) - band + b
        if j == 0:
            pm[b] = 0
        elif 0 < j <= lt:
            py[b] = GAP_OPEN + GAP_EXT * j
    tb = [[0] * bw]
    for i in range(1, lq + 1):
        ci = center(i)
        shift = ci - center(i - 1)
        cm, cx, cy = [NEG] * bw, [NEG] * bw, [NEG] * bw
        codes = [0] * bw
        qi = q[i - 1]
        for b in range(bw):
            j = ci - band + b
            if j < 0 or j > lt:
                continue
            code = 0
            bd = b + shift - 1
            if j >= 1 and 0 <= bd < bw:
                s = MATCH if (qi == t[j - 1] and qi < 4) else MISMATCH
                best, src = pm[bd], 0
                if px[bd] > best:
                    best, src = px[bd], 1
                if py[bd] > best:
                    best, src = py[bd], 2
                if best > NEG // 2:
                    cm[b] = best + s
                    code |= src
            bx = b + shift
            if 0 <= bx < bw:
                op = max(pm[bx], py[bx]) + GAP_OPEN + GAP_EXT
                ex = px[bx] + GAP_EXT
                if ex >= op and ex > NEG // 2:
                    cx[b] = ex
                    code |= 4
                elif op > NEG // 2:
                    cx[b] = op
            if b >= 1 and j >= 1:
                op = max(cm[b - 1], cx[b - 1]) + GAP_OPEN + GAP_EXT
                ex = cy[b - 1] + GAP_EXT
                if ex >= op and ex > NEG // 2:
                    cy[b] = ex
                    code |= 8
                elif op > NEG // 2:
                    cy[b] = op
            codes[b] = code
        tb.append(codes)
        pm, px, py = cm, cx, cy
    bT = lt - center(lq) + band
    if not 0 <= bT < bw:
        return "", NEG, -1
    score = max(pm[bT], px[bT], py[bT])
    state = 0 if score == pm[bT] else (1 if score == px[bT] else 2)
    ops, i, j, nm = [], lq, lt, 0
    while i > 0 or j > 0:
        code = tb[i][j - center(i) + band] if i > 0 and j > 0 else 0
        if i == 0:
            ops.append("D")
            j -= 1
            nm += 1
        elif j == 0:
            ops.append("I")
            i -= 1
            nm += 1
        elif state == 0:
            eq = q[i - 1] == t[j - 1] and q[i - 1] < 4
            ops.append("=" if eq else "X")
            nm += 0 if eq else 1
            state = code & 3
            i -= 1
            j -= 1
        elif state == 1:
            ops.append("I")
            nm += 1
            state = 1 if code & 4 else 0
            i -= 1
        else:
            ops.append("D")
            nm += 1
            state = 2 if code & 8 else 0
            j -= 1
    ops.reverse()
    cig, k = [], 0
    while k < len(ops):
        r = k
        while r < len(ops) and ops[r] == ops[k]:
            r += 1
        cig.append(f"{r - k}{ops[k]}")
        k = r
    return "".join(cig), score, nm


def map_t_to_q(cigar: str, target: int) -> int:
    q = t = num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
            continue
        if ch in "=XM":
            if t + num > target:
                return q + (target - t)
            q += num
            t += num
        elif ch == "I":
            q += num
        elif ch in "DN":
            if t + num > target:
                return q
            t += num
        num = 0
    return -1


class Caller:
    """The V panels' index, each V's Cys, and the call of a subread."""

    def __init__(self, v_fastas: list):
        self.index = align.Index.from_fastas(v_fastas)
        self.cys = [cys_position(c) for c in self.index.codes]
        self.v_ids = {nm: i for i, nm in enumerate(self.index.names)}

    def _hint(self, name: str) -> int:
        parts = name.split("_")
        starts = range(min(4, len(parts) - 1), len(parts))
        for s in starts:
            if "_".join(parts[s:]) in self.v_ids:
                return self.v_ids["_".join(parts[s:])]
        for s in starts:
            c = "_".join(parts[s:])
            for nm, i in self.v_ids.items():
                if nm.startswith(c):
                    return i
        return -1

    def calls(self, subreads: list, widths: list) -> list:
        """[(kind, chain, nt)] of each (name, sequence bytes): kind is
        'clean', 'rescued', 'partial' or None (no call)."""
        codes = [plain.encode(s) for _, s in subreads]
        recs = align.records(self.index, codes, widths, extend=False)
        return [self._call(n, c, r) for (n, _), c, r in
                zip(subreads, codes, recs)]

    def _call(self, name, read, recs):
        best, best_s = None, -1
        for r in recs:
            if r["strand"] == 0 and int(r["score"]) > best_s:
                best, best_s = r, int(r["score"])
        if best is not None:
            v = best["ref"]
            vc = self.index.codes[v]
            if self.cys[v] < 0 or best["tend"] < self.cys[v] - MIN_TAIL_COVER:
                return None, "", ""
            qs, ts = best["qstart"], best["tstart"]
            q_seg = read[qs:best["qend"]]
            t_seg = vc[ts:min(best["tend"], len(vc))]
        else:
            v = self._hint(name)
            if v < 0 or self.cys[v] < 0:
                return None, "", ""
            vc = self.index.codes[v]
            t_seg = vc[-FALLBACK_VTAIL:]
            q_seg = read[:min(FALLBACK_VTAIL + 8, len(read))]
            qs, ts = 0, len(vc) - FALLBACK_VTAIL
        cig, _, nm = banded_global(q_seg, t_seg)
        if len(t_seg) and nm / max(len(t_seg), 1) > FALLBACK_MAX_NMFRAC:
            return None, "", ""
        tgt = self.cys[v] - ts
        if tgt < len(t_seg):
            off = map_t_to_q(cig, tgt)
            if off < 0:
                return None, "", ""
            pinned = True
        else:
            if tgt - len(t_seg) > MAX_EXTRAPOLATE:
                return None, "", ""
            off = len(q_seg) + tgt - len(t_seg)
            pinned = False
        at = qs + off
        chain = self.index.names[v][:3].upper()
        got = cdr3(read, at, require_cys=not pinned)
        if got is None:
            tail = read[at:]
            if pinned and PARTIAL_MIN_NT <= len(tail) < PARTIAL_WINDOW_NT:
                aa = translate(tail)
                if aa and "*" not in aa:
                    return "partial", chain, decode(tail)
            return None, "", ""
        nt, aa = got
        clean = not aa.endswith("_") and aa.startswith("C")
        return ("clean" if clean else "rescued"), chain, nt


def lev(a: str, b: str) -> int:
    """Edit distance, N matching any base (imputation fills a clone's N)."""
    row = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, y in enumerate(b, 1):
            cur = min(row[j] + 1, row[j - 1] + 1,
                      prev + (0 if x == y or "N" in (x, y) else 1))
            prev, row[j] = row[j], cur
    return row[-1]


def clone_fits(kind: str, nt: str, clone_nt: str) -> bool:
    """Whether a call of `kind` with junction `nt` may sit under a clone
    whose CDR3 is `clone_nt`."""
    if kind == "clean":
        nested = min(len(nt), len(clone_nt)) >= NESTED_MIN_NT and (
            nt.endswith(clone_nt) or clone_nt.endswith(nt))
        return nested or lev(nt, clone_nt) <= max(1, len(nt) // 20)
    cap = max(2, len(nt) // 10)
    if kind == "rescued":
        return (abs(len(nt) - len(clone_nt)) <= RESCUE_LEN_DIFF
                and lev(nt, clone_nt) <= cap)
    return len(clone_nt) >= len(nt) and lev(nt, clone_nt[:len(nt)]) <= cap
