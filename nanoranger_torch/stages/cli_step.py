"""Fused CLI decon step: the streamed pipeline's per-batch work in one call.

Counterpart of the JAX package's stages/cli_step.py. One call per read
batch runs seed -> chain DP (csrc/chain.cu on CUDA) -> EXACT chain-record
extraction -> base-level end extension -> flank adapter scan (csrc/ed.cu
on CUDA) over all B*S record slots -> BC-UMI slice -> the exact-class
whitelist pass, all on the batch's device; the host downloads the small
per-slot arrays once and assembles the byte-identical artifacts
(assemble_batch: subread fastq, BCUMI fasta, eds rows, polyA, raw counts).

Exactness contract: for every read with at most S kept chains, outputs are
those of the unfused path (align.aligner.extract_records +
ops.extend.extend_records_host + stages.decon.run_decon + the staged
match). Reads with more than S kept chains, or whose anchors overflowed
the bucket's slots, are flagged `defer` and the caller reruns them through
the unfused path, so the artifacts are identical for ALL reads.

Where the JAX step uses a device-side conditional (`lax.cond`), this eager
step either synchronises with the host or runs a masked pass:
  - the extension re-rounds run while some slot is still active (one host
    read of `active.any()` a round): the rounds after none is active
    change nothing;
  - the whitelist pass runs once over all B*S candidate rows; the rows
    the JAX step would have left in an unmatched spill (past the first B
    of the accepted-first order, when no accepted row spilled) get its
    no-spill values (bc -1, score -(1<<20), status 5, UMI PAD). The
    matcher is row-independent, so accepted rows get the same verdicts
    however the rows are grouped.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..align.aligner import (MIN_CHAIN_CNT, MIN_CHAIN_SCORE,
                             prepare_index_arrays, seed_and_chain)
from ..align.index import PanelIndex
from ..align.minimizers import K
from ..chemistry import ChemistrySpec
from ..io.encode import COMPLEMENT, PAD, encode
from ..ops.extend import F_EXT, extend_scores
from .decon import _anchor_code, _scan_flanks

BIG = 1 << 30
NEGF = -1e18
NO_SPILL_SCORE = -(1 << 20)
NO_SPILL_STATUS = 5


# ---------------------------------------------------------------------------
# exact device record extraction

def _records_exact(chain_out, lengths, ref_lens, S: int):
    """Per-read top-S chains with EXACT extract_records semantics.

    Returns a dict of (B, S) tensors in EMISSION order (root ascending,
    the order extract_records returns records in): ok (emitted), flag
    (0/16/2048/2064), strand, qstart/qend (original-read coords, before
    extension), tstart/tend, ref_id, score (meaningful where ok); plus (B,)
    n_chains and defer (the read has more kept chains than S slots, or its
    anchors overflowed).

    The per-chain reductions scatter each anchor into its chain root's slot
    of a (B, A) table (the root is a slot index of the read), so a column
    is one chain and the column index is its root. Max, min and count do
    not depend on order, so fmax equals _chain_summaries' bit for bit. The
    chain's seg is the maximum over its anchors: the chain DP links only
    anchors of equal seg, so seg is constant within a chain and any
    anchor's seg is the chain's (the JAX step reads it at a root group's
    end after an unstable sort, which is exact for the same reason).
    """
    t, qpos, seg = chain_out["t"], chain_out["qpos"], chain_out["seg"]
    valid, f, root = chain_out["valid"], chain_out["f"], chain_out["root"]
    B, A = t.shape
    dev = t.device
    i32 = torch.int32
    size = B * A
    in_chain = valid & (root >= 0)
    flat = torch.where(
        in_chain,
        torch.arange(B, dtype=torch.int64, device=dev)[:, None] * A
        + root.to(torch.int64), size).reshape(-1)

    def reduce(v, init, how):
        base = torch.full((size + 1,), init, dtype=v.dtype, device=dev)
        out = base.scatter_reduce(0, flat, v.reshape(-1), how)
        return out[:size].reshape(B, A)

    qp = qpos.to(i32)
    cnt = torch.bincount(flat, minlength=size + 1)[:size].reshape(B, A)
    fmax = reduce(f, NEGF, "amax")
    qlo = reduce(qp, BIG, "amin")
    qhi = reduce(qp, -1, "amax")
    tlo = reduce(t, BIG, "amin")
    thi = reduce(t, -1, "amax")
    sg = reduce(seg, -1, "amax")

    keep = (cnt >= MIN_CHAIN_CNT) & (fmax >= MIN_CHAIN_SCORE)
    n_chains = keep.sum(dim=1).to(i32)

    # top-S selection in extract_records order: score desc, ties root asc
    # (the first column among the maxima is the smallest root)
    taken = ~keep
    f_sel = torch.where(keep, fmax, NEGF)
    cols = {k: [] for k in ("root", "score", "qstart", "qend", "tstart",
                            "thi", "seg", "ok")}
    for _ in range(S):
        fm = torch.where(taken, NEGF, f_sel)
        m1 = fm.max(dim=1, keepdim=True).values
        cand = ~taken & (fm == m1)
        any_pick = cand.any(dim=1)
        idx = cand.to(i32).argmax(dim=1, keepdim=True)

        def g(a):
            return a.gather(1, idx)[:, 0]

        cols["root"].append(idx[:, 0].to(i32))
        cols["score"].append(g(fmax))
        cols["qstart"].append(g(qlo))
        cols["qend"].append(g(qhi) + K)
        cols["tstart"].append(g(tlo))
        cols["thi"].append(g(thi))
        cols["seg"].append(g(sg))
        cols["ok"].append(any_pick)
        taken = taken | (cand & (torch.arange(A, device=dev)[None] == idx))
    slots = {k: torch.stack(v, dim=1) for k, v in cols.items()}
    slot_ok = slots["ok"]

    zero = torch.zeros((), dtype=i32, device=dev)
    strand = torch.where(slot_ok, slots["seg"] & 1, zero)
    ref_id = torch.where(slot_ok, slots["seg"] >> 1, zero)
    qstart = torch.where(slot_ok, slots["qstart"], zero)
    qend = torch.where(slot_ok, slots["qend"], zero)
    tstart = torch.where(slot_ok, slots["tstart"], zero)
    tend = torch.where(slot_ok, torch.minimum(
        slots["thi"] + K, ref_lens[ref_id.long()]), zero)

    # greedy primary/supplementary selection by query overlap, in slot
    # (= score) order — extract_records' loop: the first kept chain is
    # primary, a later one is kept as supplementary iff its largest overlap
    # with a KEPT chain is < MASK_LEVEL (0.5) of its span (2*ov < span)
    kept, flag = [], []
    for s in range(S):
        ov = torch.zeros(B, dtype=i32, device=dev)
        for s2 in range(s):
            lo = torch.maximum(qstart[:, s], qstart[:, s2])
            hi = torch.minimum(qend[:, s], qend[:, s2])
            ov = torch.maximum(ov, torch.where(kept[s2], hi - lo, zero))
        span = qend[:, s] - qstart[:, s]
        first = (~torch.stack(kept, dim=1).any(dim=1) if s else
                 torch.ones(B, dtype=torch.bool, device=dev))
        kept.append(slot_ok[:, s] & (first | (2 * ov < span)))
        flag.append((torch.where(first, 0, 2048) + 16 * strand[:, s])
                    .to(i32))
    kept = torch.stack(kept, dim=1)
    flag = torch.stack(flag, dim=1)

    # reorder slots into emission (root asc) order: extract_records
    # returns records in root order, not score order
    emit_key = torch.where(kept, slots["root"], BIG)
    order = torch.sort(emit_key, dim=1, stable=True).indices

    def e(a):
        return a.gather(1, order)

    # defer: more kept chains than slots, or anchor-capacity overflow in
    # the seed stage (truncated anchors would make the result depend on
    # the length bucket; the caller recomputes at the full width)
    defer = n_chains > S
    if "overflow" in chain_out:
        defer = defer | chain_out["overflow"]
    return {"ok": e(kept), "flag": e(flag), "strand": e(strand),
            "qstart": e(qstart), "qend": e(qend), "tstart": e(tstart),
            "tend": e(tend), "ref_id": e(ref_id), "score": e(slots["score"]),
            "n_chains": n_chains, "defer": defer}


# ---------------------------------------------------------------------------
# base-level end extension over the slots (ops/extend.extend_records_host)

def _extend_slots(codes, lengths, rec, ref_flat, ref_off, ref_lens,
                  S: int, rounds: int = 4, F: int = F_EXT):
    """Extend slot spans in stored-read orientation: the math of
    extend_records_host (the same extend_scores DP, the same cap-gated
    re-rounds), over the B*S slots at once. A re-round runs while some slot
    is active; once none is, later rounds would change nothing."""
    B, L = codes.shape
    dev = codes.device
    R = B * S
    read_idx = torch.arange(B, dtype=torch.int64, device=dev) \
        .repeat_interleave(S)
    rlen = lengths[read_idx]
    strand = rec["strand"].reshape(R)
    ok = rec["ok"].reshape(R)
    rid = rec["ref_id"].reshape(R).long()
    roff = ref_off[rid]
    rl = ref_lens[rid]

    s_qs = torch.where(strand == 1, rlen - rec["qend"].reshape(R),
                       rec["qstart"].reshape(R))
    s_qe = torch.where(strand == 1, rlen - rec["qstart"].reshape(R),
                       rec["qend"].reshape(R))
    ts = rec["tstart"].reshape(R)
    te = rec["tend"].reshape(R)

    comp = torch.from_numpy(COMPLEMENT).to(dev)
    jj = torch.arange(F, dtype=torch.int32, device=dev)[None]
    rev = strand[:, None] == 1
    neg = torch.tensor(-1, dtype=torch.int8, device=dev)

    def stored_gather(x):
        """stored-orientation bases at read positions x (R, F)."""
        xc = x.clamp(0, L - 1)
        pos = torch.where(rev, rlen[:, None] - 1 - xc, xc).clamp(0, L - 1)
        v = codes[read_idx[:, None], pos.long()]
        return torch.where(rev, comp[v.long()], v)

    def ref_gather(y):
        yc = (roff[:, None] + y.clamp(min=0)).clamp(0, ref_flat.shape[0] - 1)
        return ref_flat[yc.long()]

    active = ok
    for rnd in range(rounds):
        if rnd and not bool(active.any()):
            break
        lo_qn = s_qs.clamp(max=F)
        lo_tn = ts.clamp(max=F)
        hi_qn = (rlen - s_qe).clamp(0, F)
        hi_tn = (rl - te).clamp(0, F)
        q_lo = torch.where(jj < lo_qn[:, None],
                           stored_gather(s_qs[:, None] - 1 - jj), neg)
        t_lo = torch.where(jj < lo_tn[:, None],
                           ref_gather(ts[:, None] - 1 - jj), neg)
        q_hi = torch.where(jj < hi_qn[:, None],
                           stored_gather(s_qe[:, None] + jj), neg)
        t_hi = torch.where(jj < hi_tn[:, None],
                           ref_gather(te[:, None] + jj), neg)
        qf = torch.cat([q_lo, q_hi]).to(torch.int8)
        tf = torch.cat([t_lo, t_hi]).to(torch.int8)
        qn = torch.cat([lo_qn, hi_qn]).to(torch.int32)
        tn = torch.cat([lo_tn, hi_tn]).to(torch.int32)
        bi, bj = extend_scores(qf, qn, tf, tn, F=F)
        qi_l, qi_r = bi[:R], bi[R:]
        tj_l, tj_r = bj[:R], bj[R:]
        s_qs = torch.where(active, s_qs - qi_l, s_qs)
        s_qe = torch.where(active, s_qe + qi_r, s_qe)
        ts = torch.where(active, ts - tj_l, ts)
        te = torch.where(active, te + tj_r, te)
        capped = ((qi_l >= F - 4) | (tj_l >= F - 4) |
                  (qi_r >= F - 4) | (tj_r >= F - 4)) & \
            ((qi_l + qi_r + tj_l + tj_r) > 0)
        active = active & capped

    qstart = torch.where(strand == 1, rlen - s_qe, s_qs)
    qend = torch.where(strand == 1, rlen - s_qs, s_qe)
    return {"qstart": qstart.reshape(B, S), "qend": qend.reshape(B, S),
            "tstart": ts.reshape(B, S), "tend": te.reshape(B, S)}


# ---------------------------------------------------------------------------

def build_cli_step(spec: ChemistrySpec, index: PanelIndex, matcher=None,
                   S: int = 4, Lc: int = 96, device="cuda"):
    """The per-batch step of the streamed pipeline on `device`.

    Returns (step, tables): step(codes (B, L) int8, lengths (B,) int32,
    tables) -> dict of flat (B*S,) tensors on the device (emission order:
    read-major, chain root ascending) plus (B,) n_chains/defer. `tables`
    holds the index (and, with a matcher, the whitelist) tensors and is
    passed as an argument, as the JAX step takes it. The host assembles
    the artifacts with assemble_batch(); reads with defer=True are
    recomputed on the unfused path by the caller. The matcher, when given,
    must live on `device`.

    Each part of a call is a span (trace.py): step.upload (the batch to
    the device), step.chain (sketch, anchor lookup, K1), step.records,
    step.extend (its re-round test waits for the card), step.scan (K2+K3),
    step.slice (subread and BC-UMI slices) and step.tiers (the exact-class
    whitelist pass).
    """
    dev = torch.device(device)
    n_bases = int(index.ref_lens.astype(np.int64).sum())
    if n_bases >= 1 << 31:
        raise ValueError(
            f"the reference holds {n_bases} bases; the step addresses it "
            "with int32 offsets, which reach 2^31 - 1")
    ps, pc, windows = prepare_index_arrays(index, dev)
    tables = {
        "prefix_start": ps, "prefix_count": pc, "windows": windows,
        "ref_lens": torch.from_numpy(index.ref_lens.astype(np.int32)).to(dev),
        "ref_flat": torch.from_numpy(
            np.concatenate([np.asarray(s, np.int8) for s in index.seq_codes])
            if index.n_refs else np.zeros(1, np.int8)).to(dev),
        "ref_off": torch.from_numpy(
            index.ref_offset.astype(np.int32)).to(dev),
    }
    do_match = matcher is not None and spec.barcode is not None
    if do_match:
        tables["m"] = matcher.device_tables()

    f = spec.flank
    scan = spec.scan
    sub = spec.subread
    rule = spec.bcumi_rule
    pattern = (torch.from_numpy(np.ascontiguousarray(encode(scan.pattern)))
               .to(dev) if scan else None)
    comp = torch.from_numpy(COMPLEMENT).to(dev)
    i32 = torch.int32

    def step(codes, lengths, t):
        with trace.span("step.upload"):
            codes = (codes if isinstance(codes, torch.Tensor) else
                     torch.from_numpy(np.ascontiguousarray(codes, np.int8)))
            lengths = (lengths if isinstance(lengths, torch.Tensor)
                       else torch.from_numpy(np.asarray(lengths, np.int32)))
            codes = codes.to(dev).contiguous()
            lengths = lengths.to(device=dev, dtype=i32)
        B, L = codes.shape
        m = max(64, ((L // 4) + 63) // 64 * 64)
        with trace.span("step.chain"):
            chain_out = seed_and_chain(codes, lengths, t["prefix_start"],
                                       t["prefix_count"], t["windows"],
                                       max_minimizers=m)
        with trace.span("step.records"):
            rec = _records_exact(chain_out, lengths, t["ref_lens"], S)
        with trace.span("step.extend"):
            ext = _extend_slots(codes, lengths, rec, t["ref_flat"],
                                t["ref_off"], t["ref_lens"], S)
        R = B * S
        read_idx = torch.arange(B, dtype=i32, device=dev).repeat_interleave(S)
        ok = rec["ok"].reshape(R)
        strand = rec["strand"].reshape(R)
        flag = rec["flag"].reshape(R)
        ref_id = rec["ref_id"].reshape(R)
        qstart = ext["qstart"].reshape(R)
        qend = ext["qend"].reshape(R)
        tstart = ext["tstart"].reshape(R)
        tend = ext["tend"].reshape(R)
        rlen = lengths[read_idx.long()]
        s_qstart = torch.where(strand == 1, rlen - qend, qstart)
        s_qend = torch.where(strand == 1, rlen - qstart, qend)
        qlen = s_qend - s_qstart

        out = {"ok": ok, "flag": flag, "strand": strand, "ref_id": ref_id,
               "qstart": qstart, "qend": qend,
               "n_chains": rec["n_chains"], "defer": rec["defer"]}

        # ---- adapter scan (stages/decon._scan_flanks, the decon stage's)
        with trace.span("step.scan"):
            if scan is not None:
                window, wlen, wstart, ed, gs, ge = _scan_flanks(
                    codes, lengths, read_idx, strand, qstart, qend,
                    _anchor_code(f.anchor), f.lo, f.hi, pattern, scan.k,
                    scan.n_wildcard, scan.pick_last, scan.window_size,
                    scan.window_stride, scan.windows_plus_one)
                Wmax = f.hi - f.lo
                hit = ok & (ed >= 0) & (ed < scan.max_ed_exclusive)
            else:
                wlen = wstart = torch.zeros(R, dtype=i32, device=dev)
                ed = gs = ge = torch.full((R,), -1, dtype=i32, device=dev)
                hit = torch.zeros(R, dtype=torch.bool, device=dev)
                window = None
                Wmax = 0

        # ---- subread slice + accepts (stages/decon.run_decon math)
        with trace.span("step.slice"):
            sa = s_qstart if sub.start_anchor == "qstart" else s_qend
            ea = s_qstart if sub.end_anchor == "qstart" else s_qend
            sub_strt = sa + sub.start_ofs
            if spec.name == "5p10XTCR":     # utils.py:245-248
                sub_strt = torch.where(qlen > -sub.start_ofs, sub_strt,
                                       s_qstart)
            if sub.start_clamp0:
                sub_strt = sub_strt.clamp(min=0)
            sub_end = ea + sub.end_ofs
            if sub.end_clamp_len:
                sub_end = torch.minimum(sub_end, rlen)
            sub_len = (sub_end - sub_strt).clamp(min=0)
            accept_sub = (sub_len > sub.min_len) if sub.min_len else \
                torch.ones(R, dtype=torch.bool, device=dev)
            if spec.subread_requires == "clip40":       # RTX utils.py:78,83
                accept_sub = accept_sub & ((sub_end - s_qend) > 40)
            elif spec.subread_requires == "span400":    # utils.py:405-407,429
                accept_sub = accept_sub & ((tend - tstart) > 400)
            elif spec.subread_requires == "qlen100":    # utils.py:350
                accept_sub = accept_sub & (qlen > 100)
            if spec.requires_adapter_for_subread or spec.name == "3p10XTCR":
                accept_sub = accept_sub & hit
            accept_sub = accept_sub & ok

            # ---- bcumi slice within the flank window
            zero = torch.zeros((), dtype=i32, device=dev)
            bgs = torch.where(hit, gs, zero)
            bge = torch.where(hit, ge, zero)
            if rule == "slice":
                b_lo, b_hi, do_rev, post = bgs, bge, False, 0
            elif rule == "rev_slice14":
                b_lo, b_hi, do_rev, post = bgs, bge, True, 14
            elif rule == "rev_slideseq":
                b_lo, b_hi, do_rev, post = (bgs - 22).clamp(min=0), \
                    bge + 16, True, 0
            elif rule == "rev_nuc":
                bad = bgs < 35
                b_lo = torch.where(bad, zero, bgs - 35)
                b_hi = torch.where(bad, zero, bge - 12)
                do_rev, post = True, 0
            elif rule == "rev_3pgex":
                bad = bgs < 32
                b_lo = torch.where(bad, zero, bgs - 32)
                b_hi = torch.where(bad, zero, bgs + 3)
                do_rev, post = True, 0
            else:
                b_lo = b_hi = torch.zeros(R, dtype=i32, device=dev)
                do_rev, post = False, 0
            b_hi = torch.minimum(b_hi, wlen)
            b_lo = b_lo.clamp(min=0)
            b_len = (b_hi - b_lo).clamp(min=0)

            accept_bc = hit
            if spec.name in ("3pXCR_slideseq", "3p10XTCR", "3p10XTCR_nuc",
                             "3p10XGEX"):
                accept_bc = accept_bc & accept_sub
            accept_pre = accept_bc   # pre-length-filter (raw counts / eds)
            if spec.bcumi_min_len:
                accept_bc = accept_bc & ((b_len - post) > spec.bcumi_min_len)
            if rule == "rev_slideseq":
                # post filter: len>45 and (polyA<70 or (polyA>70 and
                # A-frac>0.5)) — the reference REJECTS a polyA of exactly
                # 70 (utils.py:468-474); A-frac>0.5 as 2*count > len in
                # ints
                pa_len = torch.minimum((b_lo + 5).clamp(min=0), wlen)
                jw = torch.arange(Wmax, dtype=i32, device=dev)[None]
                a_cnt = ((window == 0) & (jw < pa_len[:, None])).sum(dim=1)
                acc = (b_len > 45) & ((pa_len < 70) |
                                      ((pa_len > 70) & (2 * a_cnt > pa_len)))
                accept_bc = accept_bc & acc
                out["pa_len"] = pa_len

            out.update(hit=hit, ed=ed, gs=gs, ge=ge, wstart=wstart,
                       wlen=wlen, sub_strt=sub_strt, sub_end=sub_end,
                       accept_sub=accept_sub, accept_bc=accept_bc,
                       accept_pre=accept_pre, b_lo=b_lo, b_hi=b_hi)

        # ---- whitelist exact-class pass on the sliced candidates
        if do_match:
            with trace.span("step.tiers"):
                jc = torch.arange(Lc, dtype=i32, device=dev)[None]
                eff_len = (b_len - post).clamp(min=0)
                blen = torch.where(accept_bc, eff_len.clamp(0, Lc), zero)
                if do_rev:
                    src = b_hi[:, None] - 1 - (jc + post)
                    vals = comp[window.gather(
                        1, src.clamp(0, Wmax - 1).long()).long()]
                else:
                    src = b_lo[:, None] + jc
                    vals = window.gather(1, src.clamp(0, Wmax - 1).long())
                cand = torch.where(jc < blen[:, None], vals,
                                   torch.tensor(PAD, dtype=vals.dtype,
                                                device=dev)).to(torch.int8)
                # dp=False: rows needing the one-vs-all DP come back
                # DP_PENDING and the pipeline matches them after the stream
                bc, score, status, umi, _ = matcher.match_device_with(
                    cand, blen, t["m"], dp=False)
                # the JAX step matches the first M = B rows of the accepted-
                # first order (a sort that keeps equal keys in row order on
                # the CPU), and the other rows only when an accepted row is
                # among them; unmatched rows carry its no-spill values
                M = R // S
                acc_i = accept_bc.to(i32)
                n_acc = acc_i.sum()
                rank = torch.where(accept_bc, torch.cumsum(acc_i, 0) - 1,
                                   n_acc + torch.cumsum(1 - acc_i, 0) - 1)
                unmatched = (rank >= M) & (n_acc <= M)
                out["bc_idx"] = torch.where(unmatched, -1, bc).to(i32)
                out["score"] = torch.where(unmatched, NO_SPILL_SCORE,
                                           score).to(i32)
                out["status"] = torch.where(unmatched, NO_SPILL_STATUS,
                                            status).to(i32)
                out["umi"] = torch.where(unmatched[:, None],
                                         torch.tensor(PAD, dtype=umi.dtype,
                                                      device=dev), umi)
        return out

    return step, tables


# ---------------------------------------------------------------------------
# host-side artifact assembly

_CODE_TO_ASCII = np.frombuffer(b"ACGTN.", dtype=np.uint8).copy()
_RC_TABLE = bytes.maketrans(b"ACGTN.", b"TGCAN.")


class BatchAssembly:
    """Host products of one fused batch — the fields DeconResult carries,
    plus per-candidate match results (match_* rows align with bcumi_*;
    match_bc < -1 marks rows from deferred reads, matched later)."""

    __slots__ = ("sub_names", "sub_seqs", "sub_quals", "bcumi_names",
                 "bcumi_seqs", "eds_rows", "raw_bc_counts", "polyA",
                 "match_bc", "match_score", "match_status", "match_umi",
                 "n_deferred_reads", "raw_keys", "read_bounds")

    def __init__(self):
        self.sub_names = []
        self.sub_seqs = []
        self.sub_quals = []
        self.bcumi_names = []
        self.bcumi_seqs = []
        self.eds_rows = []
        self.raw_bc_counts = {}
        self.polyA = []
        self.match_bc = []
        self.match_score = []
        self.match_status = []
        self.match_umi = []
        self.n_deferred_reads = 0
        # per-read chunking for out-of-order (length-bucketed) dispatch:
        # raw_keys mirrors raw_bc_counts increments in emission order;
        # read_bounds[i] = cumulative (n_sub, n_bc, n_eds, n_polyA, n_raw)
        # after batch row i, so row i's artifacts are the slices between
        # read_bounds[i-1] and read_bounds[i]
        self.raw_keys = []
        self.read_bounds = []


def assemble_batch(spec: ChemistrySpec, out: dict, codes, lengths, names,
                   quals, ref_names, sample, slow_fallback=None
                   ) -> BatchAssembly:
    """Build the per-batch artifacts from fused-step outputs.

    `out` is the downloaded (numpy) step output. Reads flagged defer
    (more kept chains than device slots) are recomputed through
    `slow_fallback(read_indices) -> DeconResult-like` and interleaved in
    read order, so the artifact byte-stream is identical to the unfused
    path for every read.
    """
    B, L = codes.shape
    S = out["flag"].shape[0] // B
    res = BatchAssembly()
    emit = out["ok"]
    defer = out["defer"]
    any_defer = bool(defer.any())

    # vectorized ASCII views of the batch (forward + complement); stored-
    # orientation slices come out of these without per-row decode calls
    fwd = _CODE_TO_ASCII[codes.astype(np.uint8) % 6]
    lengths = np.asarray(lengths)

    rc_cache: dict = {}

    def stored_bytes(i: int, strand: int) -> bytes:
        n = int(lengths[i])
        if strand == 0:
            return fwd[i, :n].tobytes()
        s = rc_cache.get(i)
        if s is None:
            s = fwd[i, :n].tobytes().translate(_RC_TABLE)[::-1]
            rc_cache[i] = s
        return s

    def stored_qual(i: int, strand: int) -> bytes:
        n = int(lengths[i])
        q = quals[i][:n]
        return q[::-1] if strand else q

    flag = out["flag"]
    strand = out["strand"]
    ref_id = out["ref_id"]
    qstart = out["qstart"]
    qend = out["qend"]
    sub_strt = out["sub_strt"]
    sub_end = out["sub_end"]
    accept_sub = out["accept_sub"]
    accept_bc = out["accept_bc"]
    accept_pre = out["accept_pre"]
    hit = out["hit"]
    ed = out["ed"]
    gs = out["gs"]
    wstart = out["wstart"]
    wlen = out["wlen"]
    b_lo = out["b_lo"]
    b_hi = out["b_hi"]
    ge = out["ge"]
    rule = spec.bcumi_rule
    do_rev = rule in ("rev_slice14", "rev_slideseq", "rev_nuc", "rev_3pgex")
    post = 14 if rule == "rev_slice14" else 0
    do_match = "bc_idx" in out

    def fmt_name(r: int, i: int) -> str:
        trans = ref_names[ref_id[r]]
        if spec.name == "RTX":
            trans = trans.split("|")[0]                     # utils.py:61
        elif spec.name in ("3p10XTCR", "3p10XTCR_nuc"):
            trans = trans.split("-")[0]                     # utils.py:324,1005
        fl = int(flag[r])
        if spec.name_format.startswith("{rname10}"):        # 3p10XTCR
            ql = int(qend[r]) - int(qstart[r])
            return (f"{names[i][-10:]}_q{ql}_d{int(ed[r])}"
                    f"_s{int(sub_strt[r])}_e{int(sub_end[r])}_f{fl}_{trans}")
        if "{sample}" in spec.name_format:                  # slideseq / nuc
            return (f"{names[i]}_{sample}_{int(sub_strt[r])}"
                    f"_{int(sub_end[r])}_{fl}_{trans}")
        return (f"{names[i]}_{int(qstart[r])}_{int(qend[r])}_{fl}_{trans}")

    def bcumi_str(r: int, i: int, st: int) -> str:
        lo = int(wstart[r]) + int(b_lo[r])
        hi = int(wstart[r]) + int(b_hi[r])
        sb = stored_bytes(i, st)[lo:hi]
        if do_rev:
            sb = sb.translate(_RC_TABLE)[::-1]
        return sb[post:].decode("ascii") if post else sb.decode("ascii")

    # deferred reads: recomputed through the unfused path by the caller,
    # grouped per read — slow_fallback(didx) returns
    # {global_read_idx: {"sub": [(name, seq, qual)...], "bc": [(name,
    # seq)...], "eds": [...], "polyA": [...], "raw": [key...]}}
    slow_by_read: dict = {}
    if any_defer:
        didx = np.where(defer)[0]
        res.n_deferred_reads = len(didx)
        slow_by_read = slow_fallback(didx)

    def _one_read(i):
        if lengths[i] == 0:
            return
        if defer[i]:
            g = slow_by_read.get(i)
            if not g:
                return
            for nm, sq, ql in g["sub"]:
                res.sub_names.append(nm)
                res.sub_seqs.append(sq)
                res.sub_quals.append(ql)
            for key in g["raw"]:
                res.raw_bc_counts[key] = res.raw_bc_counts.get(key, 0) + 1
                res.raw_keys.append(key)
            for nm, sq in g["bc"]:
                res.bcumi_names.append(nm)
                res.bcumi_seqs.append(sq)
                res.match_bc.append(-2)       # matched later by the caller
                res.match_score.append(0)
                res.match_status.append(0)
                res.match_umi.append(None)
            res.eds_rows.extend(g["eds"])
            res.polyA.extend(g["polyA"])
            return
        for s in range(S):
            r = i * S + s
            if not emit[r]:
                continue
            st = int(strand[r])
            if accept_sub[r]:
                res.sub_names.append(fmt_name(r, i))
                lo, hi = int(sub_strt[r]), int(sub_end[r])
                n = int(lengths[i])
                lo, hi = max(lo, 0), min(hi, n)
                if hi <= lo:
                    res.sub_seqs.append("")
                    res.sub_quals.append("")
                else:
                    res.sub_seqs.append(
                        stored_bytes(i, st)[lo:hi].decode("ascii"))
                    res.sub_quals.append(
                        stored_qual(i, st)[lo:hi].decode("ascii"))
            if spec.name == "3p10XGEX" and accept_pre[r]:
                key = bcumi_str(r, i, st)[3:3 + 16]         # utils.py:1376
                res.raw_bc_counts[key] = res.raw_bc_counts.get(key, 0) + 1
                res.raw_keys.append(key)
            if accept_bc[r]:
                s_str = bcumi_str(r, i, st)
                nm = fmt_name(r, i)
                res.bcumi_names.append(nm)
                res.bcumi_seqs.append(s_str)
                if do_match:
                    res.match_bc.append(int(out["bc_idx"][r]))
                    res.match_score.append(int(out["score"][r]))
                    res.match_status.append(int(out["status"][r]))
                    res.match_umi.append(out["umi"][r])
                if rule == "rev_slideseq":
                    pa_hi = int(wstart[r]) + int(
                        min(max(int(b_lo[r]) + 5, 0), int(wlen[r])))
                    res.polyA.append(
                        (nm, stored_bytes(i, st)[int(wstart[r]):pa_hi]
                         .decode("ascii")))
            # mode-specific eds rows (run_decon order: flat record order)
            if spec.name == "5p10XTCR" and hit[r]:
                n = int(lengths[i])
                s_qs = (n - int(qend[r])) if st else int(qstart[r])
                lclip = -spec.flank.lo
                start_corr = (lclip - int(gs[r])) if s_qs > lclip \
                    else (s_qs - int(gs[r]))
                res.eds_rows.append(
                    [start_corr, ref_names[ref_id[r]],
                     int(ge[r]) - int(gs[r]), int(ed[r])])
            elif spec.name == "3p10XTCR":
                res.eds_rows.append(int(ed[r]))
            elif spec.name == "3pXCR_slideseq" and accept_pre[r]:
                res.eds_rows.append((">" + fmt_name(r, i), int(ed[r])))

    for i in range(B):
        _one_read(i)
        res.read_bounds.append((len(res.sub_names), len(res.bcumi_names),
                                len(res.eds_rows), len(res.polyA),
                                len(res.raw_keys)))
    return res
