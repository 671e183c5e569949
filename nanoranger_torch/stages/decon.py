"""Deconcatenation / BC-UMI extraction stage.

Counterpart of the JAX package's stages/decon.py: one ChemistrySpec-driven
engine replacing the reference's decon_* functions. Per alignment record
(primary AND supplementary — the -Y chimera/concatemer recovery):

  1. work in SAM-stored orientation: strand-1 records see the reverse
     complement and reversed quals, with flipped qstart/qend
  2. gather the chemistry's flank window next to the aligned span
  3. adapter motif scan (ops/edit_distance.py, edlib.align 'HW' parity;
     the Hopper kernel on CUDA)
  4. slice the transcript subread and BC-UMI candidate per the chemistry's
     rules + acceptance predicates

Steps 2+3 are torch on the run's device; slicing/assembly is vectorized
numpy at the host boundary where variable-length strings are written.
The 5' modes scan the whole flank; the 3' modes scan sliding sub-windows
of it, all flattened into one scan call, and the first hitting sub-window
wins.

Deviation note (as in the JAX package): python negative-index wraparound
in the reference silently yields empty/garbage slices that the length
filters then drop; we clamp instead and drop explicitly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..align.aligner import AlignmentRecords
from ..chemistry import ChemistrySpec
from ..io.encode import COMPLEMENT, PAD, encode
from ..ops.edit_distance import hw_locate

# batch code->ASCII table + bytes-level revcomp (assembly is bytes
# slicing, not per-row numpy decode)
_CODE_TO_ASCII = np.frombuffer(b"ACGTN.", dtype=np.uint8).copy()
_RC_TABLE = bytes.maketrans(b"ACGTN.", b"TGCAN.")


# --------------------------------------------------------------------------
# device flank scan

def _sub_windows(window, wlen, wsize: int, stride: int, plus_one: bool):
    """Sliding sub-windows window[:, i*stride : i*stride + wsize] of every
    flank, flattened to (R * n_win, wsize) int8 rows with their lengths;
    a sub-window the reference's loop would not visit has length 0."""
    R, Wmax = window.shape
    dev = window.device
    n_win = Wmax // stride + (1 if plus_one else 0)
    i_w = torch.arange(n_win, dtype=torch.int32, device=dev)
    jj = torch.arange(wsize, dtype=torch.int32, device=dev)
    sub_src = (i_w[:, None] * stride + jj[None]).clamp(0, Wmax - 1)
    subs = window[:, sub_src.long()].reshape(R * n_win, wsize).contiguous()
    # sub-window i exists per the reference's loop bounds
    if plus_one:
        w_exists = (i_w[None] * stride) <= wlen[:, None]
    else:
        w_exists = i_w[None] < (wlen[:, None] // stride)
    sub_len = (wlen[:, None] - i_w[None] * stride).clamp(0, wsize)
    sub_len = torch.where(w_exists, sub_len, 0).to(torch.int32)
    return subs, sub_len.reshape(-1).contiguous(), n_win


def _gather_flanks(codes, lengths, read_idx, strand, qstart, qend,
                   anchor: int, lo: int, hi: int):
    """Per-record flank windows in stored orientation: (window (R, hi-lo)
    int8 with PAD beyond each length, wlen, wstart). All inputs are tensors
    on one device."""
    L = codes.shape[1]
    dev = codes.device
    rlen = lengths[read_idx.long()]
    # stored-orientation span
    s_qstart = torch.where(strand == 1, rlen - qend, qstart)
    s_qend = torch.where(strand == 1, rlen - qstart, qend)
    a = s_qstart if anchor == 0 else s_qend       # anchor: 0=qstart 1=qend
    wstart = (a + lo).clamp(min=0)
    wend = torch.minimum(a + hi, rlen)
    wlen = (wend - wstart).clamp(min=0).to(torch.int32)

    Wmax = hi - lo
    j = torch.arange(Wmax, dtype=torch.int32, device=dev)[None]
    src = wstart[:, None] + j
    pos = torch.where(strand[:, None] == 1, rlen[:, None] - 1 - src, src)
    pos = pos.clamp(0, L - 1)
    base = codes[read_idx.long()[:, None], pos.long()]
    comp = torch.from_numpy(COMPLEMENT).to(dev)
    base = torch.where(strand[:, None] == 1, comp[base.long()], base)
    window = torch.where(j < wlen[:, None], base,
                         torch.tensor(PAD, dtype=torch.int8, device=dev))
    return window.to(torch.int8).contiguous(), wlen, wstart


def _scan_flanks(codes, lengths, read_idx, strand, qstart, qend, anchor: int,
                 lo: int, hi: int, pattern, k: int, wildcard: bool,
                 pick_last: bool, wsize: int | None = None,
                 stride: int | None = None, plus_one: bool = False):
    """Gather per-record flank windows in stored orientation and run the
    adapter scan. All inputs are tensors on one device. Returns (window
    (R, hi-lo) int8, wlen, wstart, ed, gstart, gend) — gstart/gend are
    edlib locations within the flank window (gend INCLUSIVE), ed = -1 when
    no hit. With `wsize` the scan runs over sub-windows
    window[i*stride : i*stride + wsize] and reports the first one that
    hits, its offset added to both locations."""
    window, wlen, wstart = _gather_flanks(codes, lengths, read_idx, strand,
                                          qstart, qend, anchor, lo, hi)
    if wsize is None:
        ed, gs, ge = hw_locate(pattern, window, wlen, k, wildcard=wildcard,
                               pick_last=pick_last)
        return window, wlen, wstart, ed, gs, ge

    R = window.shape[0]
    subs, sub_len, n_win = _sub_windows(window, wlen, wsize, stride, plus_one)
    ed_w, gs_w, ge_w = (x.reshape(R, n_win) for x in hw_locate(
        pattern, subs, sub_len, k, wildcard=wildcard, pick_last=pick_last))
    hit_w = ed_w >= 0
    found = hit_w.any(dim=1)
    first = hit_w.to(torch.int32).argmax(dim=1, keepdim=True)
    off = first[:, 0].to(torch.int32) * stride
    neg = torch.full_like(off, -1)
    ed = torch.where(found, ed_w.gather(1, first)[:, 0], neg)
    gs = torch.where(found, gs_w.gather(1, first)[:, 0] + off, neg)
    ge = torch.where(found, ge_w.gather(1, first)[:, 0] + off, neg)
    return window, wlen, wstart, ed, gs, ge


# --------------------------------------------------------------------------

@dataclasses.dataclass
class DeconResult:
    """Host-side decon products for one batch."""
    # accepted transcript subreads (reference _deconcat/_VDJ fastq)
    sub_rec: np.ndarray          # indices into the AlignmentRecords
    sub_names: list
    sub_seqs: list               # str
    sub_quals: list              # str
    # BC-UMI candidates (reference _BCUMI fasta)
    bcumi_rec: np.ndarray
    bcumi_names: list
    bcumi_seqs: list             # str
    # per-mode stats
    eds_rows: list               # mode-specific tuples for _eds.csv
    raw_bc_counts: dict          # 3p10XGEX bcumi[3:19] counter
    polyA: list                  # slideseq (name, polyA) rows
    eds_rec: np.ndarray | None = None
    raw_rows: list | None = None          # [(record_idx, key), ...]


def _anchor_code(name: str) -> int:
    return 0 if name == "qstart" else 1


def run_decon(spec: ChemistrySpec, codes: np.ndarray, lengths: np.ndarray,
              names: list, quals: list, rec: AlignmentRecords,
              ref_names: list, sample: str = "sample", device="cuda",
              dev_codes=None) -> DeconResult:
    """Run decon for one read batch + its alignment records.

    The flank scan runs on `device`; dev_codes is an optional copy of
    `codes` already on that device (from the aligner call)."""
    R = len(rec)
    empty = DeconResult(np.zeros(0, int), [], [], [], np.zeros(0, int), [], [],
                        [], {}, [])
    if R == 0:
        return empty

    read_idx = rec.read_idx.astype(np.int32)
    strand = rec.strand.astype(np.int32)
    qstart = rec.qstart.astype(np.int32)
    qend = rec.qend.astype(np.int32)
    rlen = lengths[read_idx].astype(np.int64)
    s_qstart = np.where(strand == 1, rlen - qend, qstart)
    s_qend = np.where(strand == 1, rlen - qstart, qend)
    qlen = s_qend - s_qstart

    # ---- adapter scan on the device ---------------------------------------
    if spec.scan is not None:
        f = spec.flank
        dev = torch.device(device)
        tt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        window, wlen, wstart, ed, gs, ge = _scan_flanks(
            dev_codes if dev_codes is not None else tt(codes),
            tt(lengths.astype(np.int32)), tt(read_idx), tt(strand),
            tt(qstart), tt(qend), _anchor_code(f.anchor), f.lo, f.hi,
            tt(encode(spec.scan.pattern)), spec.scan.k,
            spec.scan.n_wildcard, spec.scan.pick_last,
            spec.scan.window_size, spec.scan.window_stride,
            spec.scan.windows_plus_one)
        window, wlen, wstart, ed, gs, ge = (
            x.cpu().numpy() for x in (window, wlen, wstart, ed, gs, ge))
        hit = (ed >= 0) & (ed < spec.scan.max_ed_exclusive)
    else:
        window = np.zeros((R, 0), np.int8)
        wlen = np.zeros(R, np.int64)
        wstart = np.zeros(R, np.int64)
        ed = np.full(R, -1)
        gs = np.full(R, -1)
        ge = np.full(R, -1)
        hit = np.zeros(R, bool)

    # ---- subread slice (stored coords) ----------------------------------
    sub = spec.subread
    sa = s_qstart if sub.start_anchor == "qstart" else s_qend
    ea = s_qstart if sub.end_anchor == "qstart" else s_qend
    sub_strt = sa + sub.start_ofs
    if spec.name == "5p10XTCR":
        # sub_strt = qend-60 only when qlen > 60 (utils.py:245-248)
        sub_strt = np.where(qlen > -sub.start_ofs, sub_strt, s_qstart)
    if sub.start_clamp0:
        sub_strt = np.maximum(sub_strt, 0)
    sub_end = ea + sub.end_ofs
    if sub.end_clamp_len:
        sub_end = np.minimum(sub_end, rlen)
    sub_len = np.maximum(sub_end - sub_strt, 0)

    accept_sub = sub_len > sub.min_len if sub.min_len else np.ones(R, bool)
    if spec.subread_requires == "clip40":       # RTX, utils.py:78,83
        accept_sub &= (sub_end - s_qend) > 40
    elif spec.subread_requires == "span400":    # slideseq, utils.py:405-407,429
        accept_sub &= (rec.tend - rec.tstart) > 400
    elif spec.subread_requires == "qlen100":    # 3p10XTCR, utils.py:350
        accept_sub &= qlen > 100
    if spec.requires_adapter_for_subread:
        accept_sub &= hit
    if spec.name == "3p10XTCR":
        accept_sub &= hit                       # dist<6 gates both outputs

    # ---- bcumi candidate slices within the flank window ------------------
    bgs = np.where(hit, gs, 0).astype(np.int64)
    bge = np.where(hit, ge, 0).astype(np.int64)
    rule = spec.bcumi_rule
    if rule == "slice":
        b_lo, b_hi, do_rev, post = bgs, bge, False, 0
    elif rule == "rev_slice14":
        b_lo, b_hi, do_rev, post = bgs, bge, True, 14
    elif rule == "rev_slideseq":
        b_lo, b_hi, do_rev, post = np.maximum(bgs - 22, 0), bge + 16, True, 0
    elif rule == "rev_nuc":
        b_lo, b_hi, do_rev, post = bgs - 35, bge - 12, True, 0
        bad = bgs < 35                           # python wrap → reject
        b_lo = np.where(bad, 0, b_lo)
        b_hi = np.where(bad, 0, b_hi)
    elif rule == "rev_3pgex":
        b_lo, b_hi, do_rev, post = bgs - 32, bgs + 3, True, 0
        bad = bgs < 32
        b_lo = np.where(bad, 0, b_lo)
        b_hi = np.where(bad, 0, b_hi)
    else:
        b_lo = b_hi = np.zeros(R, np.int64)
        do_rev, post = False, 0
    b_hi = np.minimum(b_hi, wlen)
    b_lo = np.clip(b_lo, 0, None)
    b_len = np.maximum(b_hi - b_lo, 0)

    accept_bc = hit.copy()
    # in all 3' modes the adapter scan runs INSIDE the subread-accept block
    # (utils.py:429-454,350-357,1039-1083,1353-1383), so no subread ⇒ no
    # BC-UMI; 5' modes emit them independently (5p10XTCR writes every
    # subread but BC-UMI only on adapter hit)
    if spec.name in ("3pXCR_slideseq", "3p10XTCR", "3p10XTCR_nuc", "3p10XGEX"):
        accept_bc &= accept_sub
    # 3p10XGEX counts raw barcodes for the data-driven whitelist on every
    # adapter hit, before the length filter (utils.py:1374-1383)
    raw_count_rows = np.where(accept_bc)[0] if spec.name == "3p10XGEX" else []
    if spec.bcumi_min_len:
        accept_bc &= (b_len - post) > spec.bcumi_min_len

    # slideseq extra plumbing: polyA + post filter (utils.py:443-474)
    polyA_rows = []
    slideseq_pre_rows = np.zeros(0, np.int64)
    if rule == "rev_slideseq":
        # _eds_names rows are every adapter hit BEFORE the post filter
        # (utils.py:451-461: c_eds/newnames append on hit; the length/polyA
        # filter only gates _BCUMI/_polyA emission)
        slideseq_pre_rows = np.where(accept_bc)[0]
        pa_hi = np.maximum(b_lo + 5, 0)          # dd[:upstart+5]
        select_len = b_len
        pa_len = np.minimum(pa_hi, wlen)
        # reference condition is `<70 or (>70 and frac)` — a polyA of
        # EXACTLY 70 is rejected unconditionally (utils.py:468-474)
        acc = (select_len > 45) & \
            ((pa_len < 70) | ((pa_len > 70) & _a_frac_ok(window, pa_len)))
        accept_bc &= acc

    # ---- host assembly ----------------------------------------------------
    # one vectorized code→ASCII pass for the whole batch (and a bytes
    # revcomp table); per-row work is then pure bytes slicing — no
    # per-row numpy decode/copy
    ascii_rows = _CODE_TO_ASCII[codes.astype(np.uint8) % 6]
    _rc_bytes_cache: dict = {}

    def _row_bytes(i: int, rev: bool) -> bytes:
        if not rev:
            return ascii_rows[i].tobytes()
        b = _rc_bytes_cache.get(i)
        if b is None:
            n = int(codes.shape[1])
            b = ascii_rows[i, :n].tobytes().translate(_RC_TABLE)[::-1]
            _rc_bytes_cache[i] = b
        return b

    def stored_seq_slice(r, lo_, hi_):
        i = read_idx[r]
        n = int(rlen[r])
        lo_, hi_ = int(max(lo_, 0)), int(min(hi_, n))
        if hi_ <= lo_:
            return ""
        if strand[r] == 1:
            # stored orientation = revcomp of the padded row; the row's
            # revcomp places base n-1 at padded offset L-n
            L = int(codes.shape[1])
            off = L - n
            return _row_bytes(i, True)[off + lo_:off + hi_].decode("ascii")
        return _row_bytes(i, False)[lo_:hi_].decode("ascii")

    def stored_qual_slice(r, lo_, hi_):
        i = read_idx[r]
        n = int(rlen[r])
        lo_, hi_ = int(max(lo_, 0)), int(min(hi_, n))
        if hi_ <= lo_:
            return ""
        qv = quals[i][:n]
        if strand[r] == 1:
            return qv[::-1][lo_:hi_].decode("ascii")
        return qv[lo_:hi_].decode("ascii")

    def fmt_name(r):
        i = read_idx[r]
        trans = ref_names[rec.ref_id[r]]
        if spec.name == "RTX":
            trans = trans.split("|")[0]                     # utils.py:61
        elif spec.name in ("3p10XTCR", "3p10XTCR_nuc"):
            trans = trans.split("-")[0]                     # utils.py:324,1005
        flag = int(rec.flag[r])
        if spec.name_format.startswith("{rname10}"):        # 3p10XTCR
            return (f"{names[i][-10:]}_q{int(qlen[r])}_d{int(ed[r])}"
                    f"_s{int(sub_strt[r])}_e{int(sub_end[r])}_f{flag}_{trans}")
        if "{sample}" in spec.name_format:                  # slideseq / nuc
            return (f"{names[i]}_{sample}_{int(sub_strt[r])}"
                    f"_{int(sub_end[r])}_{flag}_{trans}")
        # default: original-orientation coords (qstrt_mod/qend_mod)
        return (f"{names[i]}_{int(qstart[r])}_{int(qend[r])}_{flag}_{trans}")

    sub_rows = np.where(accept_sub)[0]
    sub_names, sub_seqs, sub_quals = [], [], []
    for r in sub_rows:
        sub_names.append(fmt_name(r))
        sub_seqs.append(stored_seq_slice(r, sub_strt[r], sub_end[r]))
        sub_quals.append(stored_qual_slice(r, sub_strt[r], sub_end[r]))

    ascii_win = (_CODE_TO_ASCII[window.astype(np.uint8) % 6]
                 if window.size else np.zeros((R, 0), np.uint8))

    def bcumi_str(r):
        w = ascii_win[r, int(b_lo[r]):int(b_hi[r])].tobytes()
        if do_rev:
            w = w.translate(_RC_TABLE)[::-1]
        s = w.decode("ascii")
        return s[post:] if post else s

    raw_counts: dict = {}
    raw_rows: list = []
    for r in raw_count_rows:
        key = bcumi_str(r)[3:3 + 16]                        # utils.py:1376
        raw_counts[key] = raw_counts.get(key, 0) + 1
        raw_rows.append((int(r), key))

    bc_rows = np.where(accept_bc)[0]
    bc_names, bc_seqs = [], []
    for r in bc_rows:
        s = bcumi_str(r)
        bc_names.append(fmt_name(r))
        bc_seqs.append(s)
        if rule == "rev_slideseq":
            pa_hi = int(min(b_lo[r] + 5, wlen[r]))
            polyA_rows.append(
                (bc_names[-1],
                 ascii_win[r, :pa_hi].tobytes().decode("ascii")))

    # eds stats rows (mode-specific, SURVEY.md §5 observability).
    # 5p10XGEX computes no eds artifact — the reference's decon_5p10XGEX
    # writes only _deconcat/_BCUMI (utils.py:173-176).
    eds_rows = []
    eds_rec = np.zeros(0, np.int64)
    if spec.name == "5p10XTCR":
        lclip = -spec.flank.lo
        eds_rec = np.where(hit)[0]
        for r in eds_rec:
            start_corr = (lclip - gs[r]) if s_qstart[r] > lclip else (s_qstart[r] - gs[r])
            eds_rows.append([int(start_corr), ref_names[rec.ref_id[r]],
                             int(bge[r] - bgs[r]), int(ed[r])])
    elif spec.name == "3p10XTCR":
        eds_rows = [int(x) for x in ed]                     # every record
        eds_rec = np.arange(R)
    elif spec.name == "3pXCR_slideseq":
        # (name-with-'>' , editDistance) per pre-filter hit — the exact
        # rows the reference accumulates for _eds_names.csv
        # (newnamef carries the fasta '>' prefix, utils.py:426,459-461)
        eds_rec = slideseq_pre_rows
        eds_rows = [(">" + fmt_name(r), int(ed[r]))
                    for r in eds_rec]

    return DeconResult(sub_rows, sub_names, sub_seqs, sub_quals,
                       bc_rows, bc_names, bc_seqs, eds_rows, raw_counts,
                       polyA_rows, eds_rec, raw_rows)


def _a_frac_ok(window: np.ndarray, pa_len: np.ndarray) -> np.ndarray:
    """slideseq polyA filter: A fraction > 0.5 (utils.py:472-474)."""
    R, Wmax = window.shape
    out = np.zeros(R, bool)
    for r in range(R):
        n = int(pa_len[r])
        if n <= 0:
            continue
        out[r] = (window[r, :n] == 0).sum() / n > 0.5
    return out
