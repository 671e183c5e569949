"""Plain versions of what the benchmark checks: the adapter scan, the
whitelist match with its UMI locator, and readers of FASTA and BAM.

Written from the published semantics of the upstream tools that nanoranger
replaces (edlib's 'HW' search for the adapter, STAR's end-to-end alignment
of a candidate against the padded whitelist), in NumPy and plain PyTorch.
Nothing of the program is imported here, and nothing the program made is
read except the outputs being judged.

Base codes: A=0 C=1 G=2 T=3 N=4, and PAD=5 beyond a sequence's end.
"""

from __future__ import annotations

import gzip
import struct
import zlib

import numpy as np
import torch

A, C, G, T, N, PAD = 0, 1, 2, 3, 4, 5
_CODE = np.full(256, N, np.int8)
for _ch, _v in zip(b"ACGTacgt", (A, C, G, T, A, C, G, T)):
    _CODE[_ch] = _v
COMP = np.array([T, G, C, A, N, PAD], np.int8)
NEG = -(1 << 20)
BIG = 1 << 20


def encode(seq: bytes) -> np.ndarray:
    return _CODE[np.frombuffer(seq, np.uint8)]


def encode_rows(seqs: list, width: int) -> tuple:
    """(B, width) int8 codes, PAD beyond each length, and the lengths; a
    longer sequence is cut to `width`."""
    out = np.full((len(seqs), width), PAD, np.int8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        c = encode(s)[:width]
        out[i, :len(c)] = c
        lens[i] = len(c)
    return out, lens


def revcomp_codes(c: np.ndarray) -> np.ndarray:
    return COMP[c[::-1]]


# --------------------------------------------------------------------------
# adapter scan: edlib.align(pattern, text, mode='HW', task='locations', k)

def _hw_rows(pattern, texts, first_row, wildcard):
    """Last row of the edit-distance table of `pattern` against each text
    row, starting from `first_row` (0 everywhere: the text's start is
    free; j: anchored at the text's start)."""
    B, W = texts.shape
    iota = np.arange(W + 1)[None]
    row = first_row.copy()
    for i, p in enumerate(pattern, start=1):
        same = texts == p
        if wildcard:
            same = same | (texts == N) | (p == N)
        cost = np.where(same & (texts != PAD), 0, 1)
        diag_or_up = np.minimum(row[:, :-1] + cost, row[:, 1:] + 1)
        cur = np.concatenate([np.full((B, 1), i), diag_or_up], axis=1)
        # a step left costs one: the row is a running minimum of cur - j
        row = np.minimum.accumulate(cur - iota, axis=1) + iota
    return row


def hw_locate(pattern: np.ndarray, texts: np.ndarray, lengths: np.ndarray,
              k: int, wildcard: bool, pick_last: bool):
    """(dist, start, end) of each text row, end inclusive: the smallest edit
    distance of the whole pattern against any infix, -1 where it is over
    k; the first (or with pick_last the last) end at that distance, and for
    it the smallest start that reaches it."""
    pat = [int(x) for x in pattern]
    B, W = texts.shape
    col = np.arange(W + 1)[None]
    final = _hw_rows(pat, texts, np.zeros((B, W + 1), np.int64), wildcard)
    scores = np.where((col >= 1) & (col <= lengths[:, None]), final, BIG)
    dist = scores.min(axis=1)
    opt = scores == dist[:, None]
    end = (np.where(opt, col, -1).max(axis=1) if pick_last else
           np.where(opt, col, BIG).min(axis=1)) - 1
    # the reversed pattern against the text read backwards from `end`
    x = np.arange(W)[None]
    src = np.clip(end[:, None] - x, 0, W - 1)
    rtexts = np.where(x <= end[:, None], np.take_along_axis(texts, src, 1),
                      PAD)
    rfinal = _hw_rows(pat[::-1], rtexts,
                      np.broadcast_to(col, (B, W + 1)).astype(np.int64),
                      wildcard)
    ropt = (np.where((col >= 1) & (col <= end[:, None] + 1), rfinal, BIG)
            == dist[:, None])
    start = end - (np.where(ropt, col, 0).max(axis=1) - 1)
    hit = dist <= k
    return (np.where(hit, dist, -1), np.where(hit, start, -1),
            np.where(hit, end, -1))


# --------------------------------------------------------------------------
# the whitelist match: STAR's end-to-end alignment of a candidate against
# every padded row N^pad_left + core + N^pad_right, match +1, mismatch -1,
# N 0, gaps -1, both reference flanks free

def _sub_table(core: torch.Tensor) -> torch.Tensor:
    """(6, m, R) int32: the score of each query code against each core
    column of each row."""
    q = torch.arange(6, device=core.device)[:, None, None]
    c = core[None].to(torch.int64)
    s = torch.where(q == c, 1, -1)
    s = torch.where((q == N) | (c == N), 0, s)
    s = torch.where((q == PAD) | (c == PAD), -1, s)
    return s.to(torch.int32)


def _scores_vs_rows(q, qlen, core, pad_left, pad_right):
    """(C, R) scores of the candidates q (C, Lq) against the rows whose
    core columns are core (m, R). The state after query base t is H[j],
    the best score with the query's first t bases aligned and the
    reference consumed up to core column j; the N columns have closed
    forms: before the core, -max(0, t - pad_left); after it, the rest of
    the query costs max(0, rest - pad_right)."""
    Cn, Lq = q.shape
    m, R = core.shape
    dev = core.device
    sub = _sub_table(core)
    jj = torch.arange(1, m + 1, device=dev, dtype=torch.int32)[None, :, None]
    H = torch.zeros((Cn, m, R), dtype=torch.int32, device=dev)
    ql = qlen.to(torch.int32)[:, None]
    # ending before the core, or with the whole query in the suffix N's
    best = torch.where(ql == 0, 0, NEG).to(torch.int32).expand(Cn, R).clone()
    best = torch.maximum(best, (-(ql - pad_right).clamp(min=0)).expand(Cn, R))
    tmax = int(qlen.max()) if Cn else 0
    for t in range(1, tmax + 1):
        entry_prev = -max(t - 1 - pad_left, 0)
        entry = -max(t - pad_left, 0)
        s = sub[q[:, t - 1].long()]                       # (C, m, R)
        diag = torch.cat([torch.full((Cn, 1, R), entry_prev,
                                     dtype=torch.int32, device=dev),
                          H[:, :-1]], dim=1) + s
        up = H - 1                                        # query base vs gap
        cur = torch.maximum(torch.maximum(diag, up), entry - jj)
        # a core column skipped costs one: running max of cur + j, less j
        H = torch.cummax(cur + jj, dim=1).values - jj
        live = (ql >= t)
        end_here = (ql == t) & live
        h_end = torch.maximum(H.max(dim=1).values,
                              torch.tensor(entry, device=dev))
        best = torch.where(end_here, torch.maximum(best, h_end), best)
        rest = -(ql - t - pad_right).clamp(min=0)
        best = torch.where(live, torch.maximum(best, H[:, m - 1] + rest),
                           best)
    return best


def best_rows(q, qlen, core, pad_left, pad_right, r_chunk=65536):
    """(best, smallest best row, rows at best) of each candidate over all
    rows, in chunks of rows."""
    Cn = q.shape[0]
    dev = core.device
    best = torch.full((Cn,), NEG, dtype=torch.int64, device=dev)
    idx = torch.full((Cn,), -1, dtype=torch.int64, device=dev)
    ties = torch.zeros((Cn,), dtype=torch.int64, device=dev)
    for r0 in range(0, core.shape[1], r_chunk):
        sc = _scores_vs_rows(q, qlen, core[:, r0:r0 + r_chunk], pad_left,
                             pad_right).to(torch.int64)
        b = sc.max(dim=1).values
        at = sc == b[:, None]
        n = at.sum(dim=1)
        i = at.to(torch.int64).argmax(dim=1) + r0
        ties = torch.where(b > best, n, torch.where(b == best, ties + n,
                                                    ties))
        idx = torch.where(b > best, i, idx)
        best = torch.maximum(best, b)
    return best.cpu().numpy(), idx.cpu().numpy(), ties.cpu().numpy()


def _forward_all(q: torch.Tensor, rows: torch.Tensor) -> tuple:
    """(C, Lq + 1, L + 1) table F of every candidate against its own row:
    F[c, i, j] is the best score of q[c, :i] aligned with the row consumed
    up to column j, the row's start free; and the (C, Lq, L) scores."""
    C, Lq = q.shape
    L = rows.shape[1]
    i32 = torch.int32
    a, b = q[:, :, None].to(i32), rows[:, None, :].to(i32)
    s = torch.where(a == b, 1, -1)
    s = torch.where((a == N) | (b == N), 0, s)
    s = torch.where((a == PAD) | (b == PAD), -1, s).to(i32)
    jj = torch.arange(L + 1, dtype=i32, device=q.device)
    F = torch.zeros((C, Lq + 1, L + 1), dtype=i32, device=q.device)
    cur = torch.empty((C, L + 1), dtype=i32, device=q.device)
    for i in range(1, Lq + 1):
        cur[:, 0] = -i
        cur[:, 1:] = torch.maximum(F[:, i - 1, :-1] + s[:, i - 1],
                                   F[:, i - 1, 1:] - 1)
        F[:, i] = torch.cummax(cur + jj, dim=1).values - jj
    return F, s


def umi_positions(q: np.ndarray, qlen: np.ndarray, rows: np.ndarray,
                  col: int, chunk: int = 4096, device="cpu") -> tuple:
    """(score, qpos) of each candidate q[c, :qlen[c]] against its own
    padded row over the whole row: the best end-to-end score, and the
    largest query index aligned base to base with reference column `col`
    on an optimal path (-1 where none is). The backward half of the path
    is the forward table of the reversed candidate against the reversed
    row. Runs in chunks of candidates on `device`."""
    C, Lq = q.shape
    L = rows.shape[1]
    score = np.zeros(C, np.int64)
    qpos = np.full(C, -1, np.int64)
    ii = torch.arange(Lq, device=device)[None]
    for c0 in range(0, C, chunk):
        qc = torch.from_numpy(q[c0:c0 + chunk]).to(device)
        nc = torch.from_numpy(qlen[c0:c0 + chunk]).to(device).long()[:, None]
        rc = torch.from_numpy(rows[c0:c0 + chunk]).to(device)
        n = len(qc)
        F, s = _forward_all(qc, rc)
        src = (nc - 1 - ii).clamp(0, Lq - 1)
        qr = torch.where(ii < nc, qc.gather(1, src), PAD).to(torch.int8)
        Fr, _ = _forward_all(qr, rc.flip(1))
        sc = F[torch.arange(n, device=device), nc[:, 0]].max(dim=1).values
        # F[qi][col] + s(q[qi], row[col]) + B[qi + 1][col + 1], with
        # B[i][j] = Fr[n - i][L - j]
        back = Fr[:, :, L - col - 1].gather(1, (nc - 1 - ii).clamp(0, Lq))
        tot = F[:, :Lq, col] + s[:, :, col] + back
        ok = (tot == sc[:, None]) & (ii < nc)
        last = Lq - 1 - ok.flip(1).to(torch.int32).argmax(dim=1)
        score[c0:c0 + n] = sc.cpu().numpy()
        qpos[c0:c0 + n] = torch.where(ok.any(dim=1), last, -1).cpu().numpy()
    return score, qpos


# --------------------------------------------------------------------------
# readers

def read_fasta(path: str) -> dict:
    """{name: sequence bytes} of a FASTA(.gz); the name is the header up to
    its first whitespace."""
    opener = gzip.open if path.endswith(".gz") else open
    out, name, parts = {}, None, []
    with opener(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    out[name] = b"".join(parts)
                name, parts = line[1:].split()[0].decode(), []
            elif line:
                parts.append(line)
    if name is not None:
        out[name] = b"".join(parts)
    return out


def read_fasta_records(path: str) -> list:
    """[(header, sequence)] of a FASTA(.gz) in file order."""
    recs, name, parts = [], None, []
    with (gzip.open if path.endswith(".gz") else open)(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line.startswith(b">"):
                if name is not None:
                    recs.append((name, b"".join(parts)))
                name, parts = line[1:].decode(), []
            else:
                parts.append(line)
    if name is not None:
        recs.append((name, b"".join(parts)))
    return recs


_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NT = "=ACMGRSVTWYHKDBN"


def read_bam(path: str) -> tuple:
    """(reference names, records) of a BAM; each record a dict with name,
    flag, ref_id, pos, mapq, cigar [(length, op)], seq (str) and tags."""
    with open(path, "rb") as f:
        raw = f.read()
    data = bytearray()
    off = 0
    while off < len(raw):                     # BGZF: concatenated members
        d = zlib.decompressobj(31)
        data += d.decompress(raw[off:])
        off = len(raw) - len(d.unused_data)
        if not d.eof:
            break
    data = bytes(data)
    if data[:4] != b"BAM\1":
        raise ValueError(f"{path}: not a BAM")
    l_text, = struct.unpack_from("<i", data, 4)
    p = 8 + l_text
    n_ref, = struct.unpack_from("<i", data, p)
    p += 4
    refs = []
    for _ in range(n_ref):
        ln, = struct.unpack_from("<i", data, p)
        refs.append(data[p + 4:p + 4 + ln - 1].decode())
        p += 4 + ln + 4
    recs = []
    while p < len(data):
        bs, = struct.unpack_from("<i", data, p)
        body = data[p + 4:p + 4 + bs]
        p += 4 + bs
        ref_id, pos, l_name, mapq, _bin, n_cig, flag, l_seq = \
            struct.unpack_from("<iiBBHHHi", body, 0)
        q = 32
        name = body[q:q + l_name - 1].decode()
        q += l_name
        cig = []
        for k in range(n_cig):
            v, = struct.unpack_from("<I", body, q + 4 * k)
            cig.append((v >> 4, _CIGAR_OPS[v & 15]))
        q += 4 * n_cig
        packed = body[q:q + (l_seq + 1) // 2]
        seq = "".join(_SEQ_NT[b >> 4] + _SEQ_NT[b & 15] for b in packed)
        seq = seq[:l_seq]
        q += (l_seq + 1) // 2 + l_seq
        tags = {}
        while q < len(body):
            tag = body[q:q + 2].decode()
            typ = chr(body[q + 2])
            q += 3
            if typ == "Z":
                e = body.index(b"\0", q)
                tags[tag] = body[q:e].decode()
                q = e + 1
            elif typ in "cC":
                tags[tag] = struct.unpack_from("<b" if typ == "c" else "<B",
                                               body, q)[0]
                q += 1
            elif typ in "sS":
                tags[tag] = struct.unpack_from("<h" if typ == "s" else "<H",
                                               body, q)[0]
                q += 2
            elif typ in "iI":
                tags[tag] = struct.unpack_from("<i" if typ == "i" else "<I",
                                               body, q)[0]
                q += 4
            elif typ == "f":
                tags[tag] = struct.unpack_from("<f", body, q)[0]
                q += 4
            else:
                raise ValueError(f"{path}: tag type {typ!r} not read")
        recs.append({"name": name, "flag": flag, "ref_id": ref_id,
                     "pos": pos, "mapq": mapq, "cigar": cig, "seq": seq,
                     "tags": tags})
    return refs, recs
