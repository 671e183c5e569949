"""Native clonotype caller: subread fastq → MiXCR-shaped clone exports.

Counterpart of the JAX package's vdj/caller.py. Pipeline per batch (the
replacement for `mixcr align`+`assemble`, reference scripts/mixcr.sh:8-22):

1. V assignment — the panel seed-chain aligner (align/aligner.py, the chain
   DP kernel on CUDA) over the V-gene panel; best primary record per
   subread.
2. Frame pinning — the V alignment span is re-aligned base-level with the
   native banded aligner and the CIGAR maps the V reference's conserved
   Cys codon (vdj/cdr3.v_cys_position) into read coordinates.
3. CDR3 call — in-frame translation from the Cys to the J [FW]GxG motif
   (vdj/cdr3.extract_cdr3).
4. Fallback for short 5' windows — 5p10XTCR subreads carry only ~60 nt of
   V tail ([qend-60:qend+80], reference utils.py:245-253), often too few
   exact 15-mers for seeding; when the subread NAME already carries the
   decon-stage V assignment ('{qname}_{qstrt}_{qend}_{flag}_{trans}',
   utils.py:265), the known V's tail is banded-aligned to the subread
   head directly.
5. Clonotype assembly + exports — vdj/clonotype.

Subreads arrive transcript-forward (the decon stage emits slices in SAM
orientation, like the reference's pysam query_sequence), so frame
direction is known; reverse-strand panel hits are treated as junk.
"""

from __future__ import annotations

import time

import numpy as np

from ..align.aligner import PanelAligner
from ..align.index import PanelIndex
from ..io import fastq
from ..runtime.native_lib import banded_align_batch
from . import cdr3 as cdr3mod
from .clonotype import ReadCall, assemble, write_exports

MIN_TAIL_COVER = 9     # alignment may stop up to this many nt short of Cys
MAX_EXTRAPOLATE = 9    # ungapped extension allowed past alignment end
FALLBACK_VTAIL = 60    # 5' window V-tail length (utils.py:245: lclipV=60)
FALLBACK_MAX_NMFRAC = 0.40

PARTIAL_MIN_NT = 15    # >= min_cdr3 codons of junction prefix to rescue
PARTIAL_WINDOW_NT = 3 * (35 + 4) + 2   # extract_cdr3's J-motif scan
#                        window: only reads truncating INSIDE it are
#                        "partial" (a longer tail with no J motif is junk)

C_PROBE = 140          # nt probed downstream of the CDR3 for the C gene
C_HEAD = 160           # head of each C reference entered in the k-mer set
C_K = 11               # probe k-mer size (0.92^11 ≈ 0.4 survival at ONT err)
C_MIN_HITS = 3         # min shared k-mers to call the constant region


class _CPanel:
    """Constant-region identifier: shared-k-mer screen of the post-CDR3
    read segment against each C gene's head. Identifies the J/C locus for
    allJHitsWithScore/allCHitsWithScore (reference exports them from
    MiXCR's built-in library, scripts/mixcr.sh:15-22; no J-allele panel is
    bundled, so the native caller reports locus-level J evidence — the
    J-motif anchor plus the constant-region identity — and the real C
    gene hit). K-mer counting is offset-invariant, so the variable-length
    J segment between CDR3 end and C start needs no alignment."""

    def __init__(self, c_fastas: list):
        self.names: list = []
        kmer_sets = []
        for path in c_fastas:
            idx = PanelIndex.from_fasta(path)
            for nm, sc in zip(idx.names, idx.seq_codes):
                head = np.asarray(sc[:C_HEAD], np.int64)
                if len(head) < C_K:
                    continue
                self.names.append(nm.split("|")[0])
                kmer_sets.append(np.unique(_kmers(head)))
        self.kmer_sets = kmer_sets

    def assign(self, segs: list) -> list:
        """segs: list of int8 arrays (post-CDR3 probes).
        Returns [(c_name, n_shared_kmers) or ("", 0)] per seg."""
        out = []
        for seg in segs:
            seg = np.asarray(seg, np.int64)
            if len(seg) < C_K + 8:
                out.append(("", 0))
                continue
            q = np.unique(_kmers(seg))
            best, best_n = "", 0
            for nm, ks in zip(self.names, self.kmer_sets):
                n = int(np.isin(q, ks, assume_unique=True).sum())
                if n > best_n:
                    best, best_n = nm, n
            out.append((best, best_n) if best_n >= C_MIN_HITS else ("", 0))
        return out


def _kmers(codes: np.ndarray, k: int = C_K) -> np.ndarray:
    """Packed k-mer codes of an int8 sequence (N/PAD-containing dropped)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    w = np.lib.stride_tricks.sliding_window_view(codes, k)
    ok = ((w >= 0) & (w < 4)).all(axis=1)
    pw = 4 ** np.arange(k, dtype=np.int64)
    return (w[ok] * pw).sum(axis=1)


def _merged_index(v_fastas: list) -> PanelIndex:
    names, seqs = [], []
    for path in v_fastas:
        idx = PanelIndex.from_fasta(path)
        names += list(idx.names)
        seqs += [np.asarray(s, np.int8) for s in idx.seq_codes]
    return PanelIndex.build(names, seqs)


def _primary_per_read(rec, n_reads: int):
    """Best (highest-score) record index per read, -1 when none."""
    best = np.full(n_reads, -1, np.int64)
    best_score = np.full(n_reads, -1, np.int64)
    for r in range(len(rec)):
        if rec.strand[r] != 0:      # subreads are transcript-forward
            continue
        i = int(rec.read_idx[r])
        s = int(rec.score[r])
        if s > best_score[i]:
            best_score[i] = s
            best[i] = r
    return best


def _name_v_hint(name: str, v_ids: dict) -> int:
    """V panel row hinted by the decon read name's trailing trans field.
    Gene names may themselves contain '_' (e.g. '…|ENST…_463'), so try
    progressively longer underscore-joined suffixes."""
    parts = name.split("_")
    for start in range(min(4, len(parts) - 1), len(parts)):
        cand = "_".join(parts[start:])
        if cand in v_ids:
            return v_ids[cand]
    # prefix match: reference parses trns=split('_')[4], which truncates
    for start in range(min(4, len(parts) - 1), len(parts)):
        cand = "_".join(parts[start:])
        for nm, i in v_ids.items():
            if nm.startswith(cand):
                return i
    return -1


def call_clonotypes(sub_fastq: str, v_fastas: list, outdir: str,
                    sample: str, batch_size: int = 2048,
                    max_len: int = 2048, c_fastas: list | None = None,
                    log=print, device="cuda"):
    """Run the native clonotyper over a subread fastq; writes
    {sample}_clones.txt.gz and {sample}_cloneID.txt.gz in outdir.
    c_fastas: optional constant-region panels (data/TR_C_human.fa etc.)
    for J/C locus assignment. The V-panel alignment runs on `device`.
    Returns (clones_df, cloneID_df)."""
    t0 = time.time()
    index = _merged_index(v_fastas)
    aligner = PanelAligner(index, device)
    v_codes = [np.asarray(s, np.int8) for s in index.seq_codes]
    cys = np.asarray([cdr3mod.v_cys_position(s) for s in v_codes])
    v_ids = {nm: i for i, nm in enumerate(index.names)}
    cpanel = _CPanel(c_fastas) if c_fastas else None

    calls: list = []
    n_total = n_aligned = n_fallback = 0
    for batch in fastq.iter_batches(sub_fastq, batch_size, max_len=max_len):
        n = len(batch)
        n_total += n
        rec = aligner.align(batch.codes, batch.lengths)
        best = _primary_per_read(rec, n)

        # --- gather banded-alignment jobs -------------------------------
        jobs = []      # (read_i, v_id, qstart, tstart, q_seg, t_seg)
        for i in range(n):
            r = int(best[i])
            if r >= 0:
                v = int(rec.ref_id[r])
                if cys[v] < 0:
                    continue
                qs, qe = int(rec.qstart[r]), int(rec.qend[r])
                ts, te = int(rec.tstart[r]), int(rec.tend[r])
                if te < cys[v] - MIN_TAIL_COVER:
                    continue    # alignment ends before the junction
                te_c = min(te, len(v_codes[v]))
                jobs.append((i, v, qs, ts,
                             batch.codes[i, qs:qe].copy(),
                             v_codes[v][ts:te_c]))
                n_aligned += 1
            else:
                v = _name_v_hint(batch.names[i], v_ids)
                if v < 0 or cys[v] < 0:
                    continue
                # 5' window: subread head ≈ V tail (decon window starts at
                # qend-60 of the original V alignment)
                vt = v_codes[v][-FALLBACK_VTAIL:]
                qlen = int(batch.lengths[i])
                q_seg = batch.codes[i, :min(FALLBACK_VTAIL + 8, qlen)].copy()
                ts = len(v_codes[v]) - FALLBACK_VTAIL
                jobs.append((i, v, 0, ts, q_seg, vt))
                n_fallback += 1

        if not jobs:
            continue
        cigars, scores, nms = banded_align_batch(
            [j[4] for j in jobs], [j[5] for j in jobs], band=48)

        for (i, v, qs, ts, q_seg, t_seg), cig, sc, nm in zip(
                jobs, cigars, scores, nms):
            if len(t_seg) and nm / max(len(t_seg), 1) > FALLBACK_MAX_NMFRAC:
                continue
            t_tgt = int(cys[v]) - ts
            if t_tgt < len(t_seg):
                q_off = cdr3mod.cigar_map_t_to_q(cig, t_tgt)
                if q_off < 0:
                    continue
                pinned = True     # anchor position confirmed base-level
            else:
                over = t_tgt - len(t_seg)
                if over > MAX_EXTRAPOLATE:
                    continue
                q_off = len(q_seg) + over   # ungapped extension
                pinned = False
            cys_read = qs + q_off
            qlen = int(batch.lengths[i])
            got = cdr3mod.extract_cdr3(batch.codes[i, :qlen], cys_read,
                                       require_cys=not pinned)
            if got is None:
                # partial junction (assemblePartial/extend analogue,
                # reference scripts/mixcr4.sh:10-14): the read TRUNCATES
                # inside the J-motif scan window, so the junction prefix
                # is real but incomplete. Emit it for overlap-merge onto
                # an assembled clone (clonotype.assemble partials tier).
                # Only base-level-pinned anchors qualify, and the prefix
                # must be stop-free in the Cys frame.
                tail_len = qlen - cys_read
                if pinned and PARTIAL_MIN_NT <= tail_len < PARTIAL_WINDOW_NT:
                    tail = np.asarray(batch.codes[i, cys_read:qlen])
                    aa_p = cdr3mod.translate(tail)
                    if aa_p and "*" not in aa_p:
                        from ..io.encode import decode as _d
                        calls.append(ReadCall(
                            name=batch.names[i], v_name=index.names[v],
                            v_score=int(sc),
                            chain=cdr3mod.chain_of(index.names[v]),
                            cdr3_nt=_d(tail, tail_len), cdr3_aa="",
                            clean=False, partial=True,
                            seq=_d(np.asarray(batch.codes[i, :qlen]),
                                   qlen)))
                continue
            nt, aa = got
            clean = (not aa.endswith("_")) and aa.startswith("C")
            c_name, c_score = "", 0
            if cpanel is not None:
                j_start = cys_read + len(nt)
                seg = batch.codes[i, j_start: min(j_start + C_PROBE, qlen)]
                c_name, c_score = cpanel.assign([seg])[0]
            from ..io.encode import decode as _d
            calls.append(ReadCall(
                name=batch.names[i], v_name=index.names[v],
                v_score=int(sc), chain=cdr3mod.chain_of(index.names[v]),
                cdr3_nt=nt, cdr3_aa=aa, clean=clean,
                c_name=c_name, c_score=int(c_score),
                seq=_d(np.asarray(batch.codes[i, :qlen]), qlen)))

    # germline context for the clone exports: V tails from the conserved
    # Cys (CDR3 imputation) and the bundled D panel (junction D calls)
    from ..io.encode import decode as _dec
    v_tails = {index.names[v]: _dec(np.asarray(
        v_codes[v][cys[v]:], np.int8), len(v_codes[v]) - cys[v])
        for v in range(len(v_codes)) if cys[v] >= 0}
    d_panel = None
    import os as _os
    d_path = _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.dirname(_os.path.abspath(__file__)))), "data",
        "TR_D_human.fa")
    if _os.path.isfile(d_path):
        from .clonotype import DPanel
        d_panel = DPanel(d_path)
    stats: dict = {}
    clones, cloneID = assemble(calls, v_tails=v_tails, d_panel=d_panel,
                               stats=stats)
    write_exports(clones, cloneID, outdir, sample)
    npar = stats.get("n_partial_reads", 0)
    log(f"native clonotyper: {n_total} subreads → {n_aligned} V-aligned "
        f"+ {n_fallback} name-hinted, {len(calls) - npar} CDR3 calls "
        f"(+{npar} partial junctions, "
        f"{stats.get('n_partial_assigned', 0)} merged into clones), "
        f"{len(clones)} clones ({time.time() - t0:.1f}s)")
    return clones, cloneID
