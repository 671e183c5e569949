"""Smoke run of the PyTorch/CUDA port (nanoranger_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  prewarm — python -m nanoranger_torch.tools.prewarm, as a deployment runs
               it before a first run: every kernel library (nvcc) and host
               library (g++) built, one line each; whether g++ finds zlib
               here (the native fastq reader needs it: only without zlib
               may the reader's library fail to build)
  1. card    — print the card's name and power limit (nvidia-smi), build
               the Hopper kernels from nanoranger_torch/csrc (timed),
               which must find every library the prewarm built
  2. kernels — hold every kernel against its plain PyTorch version on the
               card, at the shapes the main paths give it: the 5p10XGEX
               shapes of the K562 run, the chain DP's splice class at the
               genome stage's (512 reads of 1026_mtDNA_ASXL1_NRAS_SF3B1
               against MT_chr.fa, 512 synthetic 3-exon reads against a
               synthetic genome; each must link some anchors across an
               intron), the chain DP in both classes on 2048 reads with
               no valid slot and on 256 reads valid in all 4096 (the
               walk's floor and the per-step latency), then the other
               modes' (chain DP on
               the V and C panels, the adapter scan at every mode's window
               and pattern with windows cut from TCR3 and slideseq reads,
               the one-vs-all DP at core 32 against the full slideseq list,
               the banded rescore at band 33, the full-row rescore at the
               four pad geometries and on random rows of the 5' width
               whose optima lie left of, right of and across the UMI
               column), and the one-vs-all DP at the candidate
               rows of the K562 run's launch (118) and of the slideseq
               run's last (336), and on one whitelist shard at its r_valid
               as phase 5 launches it (74 rows against the last of 4 shards
               of the 737K list; the slideseq candidates against the second
               of 2 slideseq shards, one padding row past r_valid), and
               the fused step's shapes: the chain DP at the anchor slots
               of each length bucket (A = 1024, 2048, 4096) on K562 reads
               of that bucket, the adapter scan over the B*S = 8192
               record slots of a 1024-bucket batch, and the device step's:
               the chain DP at B = 1024, A = 2048 on K562 reads, the
               one-vs-all DP at batch 0's in-step need_dp rows against the
               737K list; one JSON line per kernel and shape with its time,
               the plain version's time and the mismatches
  step    — the single-dispatch device step (stages/device_step.py) at the
               bench.py _setup shape: the K562 sample at L = 2048 in
               batches of 1024 (3,072 reads), the RUNX1 panel, the full
               737K list, S = 2, max_minimizers 512; one warm pass, one
               timed pass (reads/s, ms per batch, accepted slots,
               n_deferred, the K1, K2+K3, K4 and K5 launches, all of which
               must be > 0), one pass under torch.profiler (the card's
               kernel time), and batch 0 again through the step built on
               the CPU: every output key bit-equal
  entry   — nanoranger_torch.entry: entry() on the card equal to
               entry(device='cpu'), reads accepted, counts summing to them;
               dryrun_multichip(4): a 2 x 2 mesh laid on the card(s)
  3. main    — run nanoranger_torch.pipeline.run_pipeline("5p10XGEX") on
               the K562 sample against the full 737,280-row whitelist,
               genome stage included, on its default (fused) path, hold
               the artifacts to the K562 golden counts
               (tests/goldens/real_samples.json, the tagged BAM's record
               count and the run's stages included), check that every
               kernel of that path was launched by the run, and the chain
               DP and the adapter scan from inside the fused step; then
               its unfused twin (fast=False), every artifact of the two
               outdirs equal (after gunzip, the BAM after BGZF), with one
               line of both walls, phase_s, deferred reads and the
               launches of both
  4. modes   — the same for the other three 5p10XGEX samples with their
               genomes (1022 and 1026 against panel_MT_trns.fa and
               MT_chr.fa, 97_6_CAR against CAR_CD28.fa), for 5p10XTCR on
               TCR3 (full 737K whitelist, clone
               tables included), 3pXCR_slideseq on slideseq_XCR (full
               17,753-row list) and RTX on TCR3 (subreads and clonotypes,
               no barcodes), launch counts reset before each run; every
               run of phases 3 to bench counts the files each fastq reader
               opened and fails if one fell back to the Python parser on a
               host that builds the native reader
  screens — ops/seed_screen.screen, ops/product_screen.product_screen and
               product_screen_joint over the K562 run's BC-UMI candidates
               at the match width (96) against the 737K list, on the card
               and on the CPU, equal; each screen's time on both and its
               recall (the share of the run's ACCEPT rows whose barcode is
               among its candidates)
  5. sharded — K562 again with wl_shards=4, data_shards=2 (a 2x4 mesh of
               cells laid on the card) and slideseq_XCR with wl_shards=2:
               every artifact byte-identical to the unsharded run's (after
               gunzip, the BAM after BGZF), the golden met, the one-vs-all
               DP launched once per shard and chunk (k562: >= 4, slideseq:
               >= 2 x its unsharded launches) and the UMI rescore (k562);
               the sharded match's spans (match.tiers, match.dp,
               match.verdicts: count and host seconds of each, from the
               run statistics' span_totals),
               and k562 once more with the tier pass over each data block
               whole (one chunk where the default takes 6), held the same;
               the aten calls one call of each tier function dispatches,
               at a chunk's rows and at a data block's
  bench   — the bench.py _cli_bench shape: K562 tiled to 20,000 reads,
               the RUNX1 panel, the full 737K list, no genome, batch 2048,
               fused and unfused in turns (fused, unfused, unfused, fused),
               each pair's artifacts equal; wall and reads/s of each;
               then one fused run under
               torch.profiler for the card's kernel time; then one fused
               run with the Python fastq parser forced, its artifacts
               equal to the first fused run's (the native reader's), its
               wall and phase_s.read beside theirs
  scale   — nanoranger_torch/tools/scale_bench.py's synthesize() and
               measure() at the full 1,000,000-row product list, the
               transcriptome and the reads cut (SCALE_CUT: 32 Mb over 800
               transcripts of 40,000 bases, 4,000 reads; printed as
               `reduced` beside the tool's defaults): the tool's result
               line; K1, K2+K3, K4 and K5 must each launch (the counts set
               to 0 just before the pipeline, `scale` in launches_by_run)
               and some reads be accepted; K4 at the run's first launch,
               cut to 128 rows, against its plain version on the 1M list
               (a phase-2 kernel row, taken here since the launch is known
               only now); one run of the same files under torch.profiler
               (the card's busy share, K4's time); the first 100 reads
               through the pipeline on the card and on the CPU, every
               artifact equal
  6. rescan  — the full-row rescorer on the real pairs of the two barcoded
               runs of phase 4: every accepted candidate against the full
               padded row of its barcode must give the banded rescorer's
               score, validity and position, and the UMI of the table
Then it prints the seconds of each phase, the kernel summary line, the
card line, and as the last line {"ok": true, "device": {...}}.

It needs a CUDA card and the repository around it: without a card, or
without the package beside it, it exits non-zero and prints no result.

    python3 chip_smoke.py --kernels

runs the prewarm and phases 1 and 2 only and prints the card line: the
quick check of the kernels, and the way to time two trees in turns (copy
this script into a checkout of each and run them old, new, new, old in
one call). Phase 2
first times an empty launch (a one-element fill_) in the same timer: the
floor under any one launch, which no bound counts.

    python3 chip_smoke.py --ptxas DIR

only builds every kernel library into DIR with -Xptxas -v and prints one
line per kernel: registers, spills, SASS instructions and the SASS loops
(first address and instructions of each backward branch), keeping the
SASS in DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
SAMPLE = os.path.join(DATA, "samples",
                      "K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1.fastq.gz")
PANEL = os.path.join(DATA, "RUNX1_RUNX1T1_ABL1_BCR.fa")
WHITELIST = os.path.join(DATA, "737K-august-2016.txt.gz")
TCR3 = os.path.join(DATA, "samples", "TCR3.fastq.gz")
V_PANEL = os.path.join(DATA, "TR_V_human.fa")
MT_PANEL = os.path.join(DATA, "panel_MT_trns.fa")
MT_GENOME = os.path.join(DATA, "MT_chr.fa")
CAR_PANEL = os.path.join(DATA, "CAR_CD28.fa")
S1022 = os.path.join(DATA, "samples", "1022_DNMT3A_RUNX1_SF3B1.fastq.gz")
S1026 = os.path.join(DATA, "samples", "1026_mtDNA_ASXL1_NRAS_SF3B1.fastq.gz")
S_CAR = os.path.join(DATA, "samples", "97_6_CAR.fastq.gz")
GOLDENS = os.path.join(HERE, "tests", "goldens", "real_samples.json")
SLIDESEQ = os.path.join(DATA, "samples", "slideseq_XCR.fastq.gz")
C_PANEL = os.path.join(DATA, "XR_C_mouse.fa")
SLIDESEQ_WL = os.path.join(DATA, "slideseq.matched.barcodes.tsv.gz")


# published peaks of one H100 SXM: HBM bandwidth, and the float32 rate
# outside the tensor cores, used as the ceiling of 32-bit scalar ops
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# packed 16-bit integer ops (16x2 adds and the DPX maxima): the float32 rate
# is 128 lanes x 2 flops (an FMA) a clock on each SM, and a 16x2 instruction
# does one op in each 16-bit half of a lane, so at one instruction a lane a
# clock the card does 2 x 33.5e12 16-bit ops a second
PACKED16_OPS_PER_S = 67e12

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "chain": ("nanoranger_torch/csrc/chain.cu",
              "nanoranger_tpu/ops/pallas_chain.py:33"),
    # the splice instantiation of the same source (the kernel's
    # max_intron arm, pallas_chain.py:83-92), counted apart
    "chain_splice": ("nanoranger_torch/csrc/chain.cu",
                     "nanoranger_tpu/ops/pallas_chain.py:33"),
    "ed": ("nanoranger_torch/csrc/ed.cu",        # K2 :64 and K3 :93
           "nanoranger_tpu/ops/pallas_ed.py:64"),
    "verify": ("nanoranger_torch/csrc/verify.cu",
               "nanoranger_tpu/ops/whitelist_verify.py:163"),
    "sw": ("nanoranger_torch/csrc/sw_banded.cu",
           "nanoranger_tpu/ops/pallas_sw.py:148"),
    "sw_full": ("nanoranger_torch/csrc/sw_full.cu",
                "nanoranger_tpu/ops/pallas_sw.py:55"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` runs (warm)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # hold the stream ~5 ms so the host queues every launch before the
    # first runs: the time is the card's, not the host's enqueue rate
    torch.cuda._sleep(10_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def plain_ms_of(fn):
    """(result, milliseconds) of one call of a plain version on the card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.time() - t0) * 1e3


def bound(n_bytes: float, n_ops: float, ops_per_s: float = SCALAR_OPS_PER_S):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def compare(got, ref):
    """(mismatch count, max abs difference) over paired integer tensors."""
    mism = int(sum((a != b).sum() for a, b in zip(got, ref)))
    err = float(max((a.int() - b.int()).abs().max() for a, b in zip(got, ref)))
    return mism, err


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version at main-path shapes

def longest_seg_run(seg, valid) -> int:
    """The most valid anchors in one run of one seg (slot order, invalid
    slots skipped) over all reads: the longest chain that a split of the
    reads at seg boundaries would leave to one warp."""
    import numpy as np
    best = 0
    for s, v in zip(seg.cpu().numpy(), valid.cpu().numpy()):
        x = s[v]
        if len(x):
            cuts = np.flatnonzero(np.diff(x)) + 1
            best = max(best, int(np.diff(np.r_[0, cuts, len(x)]).max()))
    return best


def check_chain_rows(t, q, seg, valid, max_intron):
    """K1 against its plain version on one (B, A) batch of anchors: f at
    every slot, parents and roots must be equal."""
    from nanoranger_torch.align.aligner import BANDWIDTH, MAX_GAP, SPLICE_PEN
    from nanoranger_torch.align.minimizers import K
    from nanoranger_torch.ops.chain import chain_dp, chain_dp_plain
    args = (t, q, seg, valid, K, MAX_GAP, BANDWIDTH, max_intron, SPLICE_PEN)
    fk, pk, rk = chain_dp(*args)
    (fp, pp, rp), plain_ms = plain_ms_of(lambda: chain_dp_plain(*args))
    ms = cuda_ms(lambda: chain_dp(*args), 20)
    per_read = valid.sum(dim=1)
    n_valid = int(per_read.sum())
    max_valid = int(per_read.max())
    mism = int((fk != fp).sum() + (pk != pp).sum() + (rk != rp).sum())
    B, A = t.shape
    # what these inputs need: the valid flag of every slot, t, q and seg of
    # the valid slots only (no other slot changes an output), and f, parent
    # and root of every slot written
    n_bytes = B * A * (1 + 4 * 3) + n_valid * 4 * 3
    # 64 window slots, ~16 flops each; the intron arm adds ~12 (a subtract,
    # four compares, two multiplies, two adds, log2, max, select)
    n_ops = n_valid * 64 * (28 if max_intron else 16)
    out = {"shape": [B, A], "valid_anchors": n_valid,
           "max_valid": max_valid,
           "max_seg_run": longest_seg_run(seg, valid), "ms": ms,
           "ns_per_valid_step": ms * 1e6 / max_valid if max_valid else None,
           "plain_ms": plain_ms, "mismatches": mism,
           "max_abs_err": float((fk[valid] - fp[valid]).abs().max())
           if n_valid else 0.0,
           "bound": bound(n_bytes, n_ops)}
    if max_intron:
        # parent links of the intron class: target gap beyond the band
        has = pk >= 0
        par = pk.clamp(min=0).long()
        d = (t - t.gather(1, par)) - (q - q.gather(1, par))
        out["splice_links"] = int((has & (d > BANDWIDTH)).sum())
        out["links"] = int(has.sum())
    return out


def check_chain(dev, index, batch, preset="map-ont"):
    """K1 against its plain version on the anchors of one read batch
    aligned to `index` with `preset`, padded to 4096 columns (A = 4096)."""
    import numpy as np

    from nanoranger_torch.align.aligner import PanelAligner
    from nanoranger_torch.io.encode import PAD
    L = 4096
    codes = np.full((batch.codes.shape[0], L), PAD, np.int8)
    codes[:, :batch.codes.shape[1]] = batch.codes[:, :L]
    aligner = PanelAligner(index, dev, preset=preset)
    ch = aligner._chain(codes, batch.lengths)
    return check_chain_rows(ch["t"], ch["q"], ch["seg"], ch["valid"],
                            aligner.max_intron), ch


def colinear_anchors(dev, rng, B, A, splice):
    """(t, q, seg, valid) of B reads whose A slots all hold one colinear
    chain of one seg: query steps of 5-30, target steps within 3 of them,
    and with `splice` two intron-sized target jumps (1-100 kb) a read."""
    import numpy as np
    import torch
    dq = rng.integers(5, 31, (B, A))
    dt = np.maximum(dq + rng.integers(-3, 4, (B, A)), 1)
    if splice:
        for b in range(B):
            dt[b, rng.choice(A, 2, replace=False)] += rng.integers(
                1_000, 100_000, 2)
    tt = lambda x: torch.from_numpy(
        np.ascontiguousarray(x, dtype=np.int32)).to(dev)
    return (tt(np.cumsum(dt, axis=1)), tt(np.cumsum(dq, axis=1)),
            tt(np.zeros((B, A))), torch.ones((B, A), dtype=torch.bool,
                                             device=dev))


def synthetic_gene_reads(rng, n_reads=512, genome_len=1_000_000,
                         n_genes=16):
    """(index, batch): a random genome holding n_genes 3-exon genes (exons
    400, 350 and 500, introns 3,000 and 12,000) and n_reads reads of their
    spliced transcripts, each on a random strand, with random flanks of
    20-80 bases and 2% substitutions."""
    import types

    import numpy as np

    from nanoranger_torch.align.index import PanelIndex
    from nanoranger_torch.io.encode import PAD, revcomp
    exon_lens, intron_lens = (400, 350, 500), (3_000, 12_000)
    genome = rng.integers(0, 4, genome_len).astype(np.int8)
    span = sum(exon_lens) + sum(intron_lens)
    tx = []
    for g in np.linspace(10_000, genome_len - span - 10_000, n_genes):
        pos, parts = int(g), []
        for el, il in zip(exon_lens, (*intron_lens, 0)):
            parts.append(genome[pos:pos + el])
            pos += el + il
        tx.append(np.concatenate(parts))
    flank = lambda: rng.integers(0, 4, int(rng.integers(20, 80))).astype(
        np.int8)
    reads = []
    for _ in range(n_reads):
        r = tx[int(rng.integers(n_genes))].copy()
        sub = rng.random(len(r)) < 0.02
        r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        r = np.concatenate([flank(), r, flank()])
        reads.append(revcomp(r) if rng.integers(2) else r)
    lengths = np.asarray([len(r) for r in reads], np.int32)
    codes = np.full((n_reads, int(lengths.max())), PAD, np.int8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = r
    return (PanelIndex.build(["chr_syn"], [genome]),
            types.SimpleNamespace(codes=codes, lengths=lengths))


def flank_windows(dev, spec, index, batch, ch=None):
    """The flank windows (R, hi - lo) and their lengths that `spec`'s
    adapter scan sees for one read batch aligned to `index`."""
    import numpy as np
    import torch

    from nanoranger_torch.align.aligner import PanelAligner, extract_records
    from nanoranger_torch.ops.extend import extend_records_host
    from nanoranger_torch.stages.decon import _gather_flanks
    if ch is None:
        ch = PanelAligner(index, dev)._chain(batch.codes, batch.lengths)
    rec = extract_records(ch, index)
    extend_records_host(rec, index, batch.codes, np.asarray(batch.lengths),
                        dev)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    f = spec.flank
    return _gather_flanks(
        tt(batch.codes), tt(np.asarray(batch.lengths, np.int32)),
        tt(rec.read_idx.astype(np.int32)), tt(rec.strand.astype(np.int32)),
        tt(rec.qstart.astype(np.int32)), tt(rec.qend.astype(np.int32)),
        0 if f.anchor == "qstart" else 1, f.lo, f.hi)[:2]


FUSED_BUCKETS = (1024, 2048, 4096)


def bucket_batch(reads, Lb, B=2048):
    """(codes (B, Lb), lengths) of the fused path's Lb bucket, filled by
    cycling through the reads of `reads` (a ReadBatch of a whole sample)
    whose length falls in that bucket (lengths cut at the widest bucket),
    as a run of the sample tiled to many reads fills it."""
    import numpy as np

    from nanoranger_torch.io.encode import PAD
    lens = np.minimum(np.asarray(reads.lengths), FUSED_BUCKETS[-1])
    lo = max([b for b in (0, *FUSED_BUCKETS) if b < Lb])
    rows = np.resize(np.flatnonzero((lens > lo) & (lens <= Lb)), B)
    codes = np.full((B, Lb), PAD, np.int8)
    w = min(reads.codes.shape[1], Lb)
    codes[:, :w] = reads.codes[rows, :w]
    return codes, lens[rows].astype(np.int32)


def fused_chain(dev, index, codes, lengths):
    """The fused step's seed and chain of one bucket batch: the anchor
    slots of its max_minimizers (256, 512, 1024 for the three buckets)."""
    import torch

    from nanoranger_torch.align.aligner import (prepare_index_arrays,
                                                seed_and_chain)
    L = codes.shape[1]
    m = max(64, ((L // 4) + 63) // 64 * 64)
    tc = torch.from_numpy(codes).to(dev)
    tl = torch.from_numpy(lengths).to(dev)
    return tc, tl, seed_and_chain(tc, tl, *prepare_index_arrays(index, dev),
                                  max_minimizers=m)


def fused_slot_windows(dev, spec, index, codes, lengths, S=4):
    """The flank windows of all B*S record slots that the fused step's
    adapter scan sees for one bucket batch (empty slots included)."""
    import torch

    from nanoranger_torch.stages.cli_step import _extend_slots, _records_exact
    from nanoranger_torch.stages.decon import _gather_flanks
    tc, tl, ch = fused_chain(dev, index, codes, lengths)
    ref_flat, ref_off, ref_lens = index.ref_tensors(dev)
    rec = _records_exact(ch, tl, ref_lens, S)
    ext = _extend_slots(tc, tl, rec, ref_flat, ref_off, ref_lens, S)
    B = codes.shape[0]
    f = spec.flank
    return _gather_flanks(
        tc, tl, torch.arange(B, dtype=torch.int32, device=dev)
        .repeat_interleave(S), rec["strand"].reshape(-1),
        ext["qstart"].reshape(-1), ext["qend"].reshape(-1),
        0 if f.anchor == "qstart" else 1, f.lo, f.hi)[:2]


# instructions of one column step of csrc/ed.cu's walks, (forward,
# reverse) by pattern words (one 32-bit word for m <= 32, two for m <= 64):
# each walk loop holds 4 steps, and its SASS (`chip_smoke.py --ptxas`
# lists each loop's instructions) has 108-109 / 97 instructions with one
# word and 149-152 / 143-145 with two, rounded down a step (CUDA 12.8)
ED_STEP_INSTR = {1: (27, 24), 2: (37, 35)}


def ed_columns(lengths, ref, m):
    """(forward, reverse) column steps the scan needs on these inputs:
    every column of each row, and for each hit the columns x = 0..min(e,
    m + dist - 1) of the reverse walk from its end e."""
    import torch
    fwd = int(lengths.clamp(min=0).sum())
    dist, _, end = ref
    hit = dist >= 0
    rev = int(torch.minimum(end[hit] + 1, m + dist[hit]).sum())
    return fwd, rev


def check_ed_setting(dev, pattern, texts, lengths, k, wildcard, pick_last):
    """K2+K3 against the plain scan on one set of window rows."""
    import numpy as np
    import torch

    from nanoranger_torch.io.encode import encode
    from nanoranger_torch.ops.edit_distance import hw_locate, hw_locate_plain
    p = torch.from_numpy(np.ascontiguousarray(encode(pattern))).to(dev)
    args = (p, texts, lengths, k, wildcard, pick_last)
    got = hw_locate(*args)
    ref, plain_ms = plain_ms_of(lambda: hw_locate_plain(*args))
    ms = cuda_ms(lambda: hw_locate(*args), 20)
    mism, err = compare(got, ref)
    R, W = texts.shape
    m = len(pattern)
    n_hit = int((ref[0] >= 0).sum())
    fwd, rev = ed_columns(lengths.clamp(max=W), ref, m)
    words = (m + 31) // 32
    return {"shape": [R, W], "m": m, "k": k,
            "wildcard": wildcard, "pick_last": pick_last, "hits": n_hit,
            "ms": ms, "plain_ms": plain_ms, "mismatches": mism,
            "max_abs_err": err, "fwd_columns": fwd, "rev_columns": rev,
            "words": words,
            # the count of the parent's cell kernel: 6 ops a DP cell of
            # both passes over the whole window
            "cell_bound_ms": (R + n_hit) * m * (W + 1) * 6
            / SCALAR_OPS_PER_S * 1e3,
            "bound": bound(R * W + 16 * R + m,
                           fwd * ED_STEP_INSTR[words][0]
                           + rev * ED_STEP_INSTR[words][1])}


def check_ed_mode(dev, spec, window, wlen):
    """K2+K3 at `spec`'s scan setting on real flank windows; the windowed
    modes scan the flattened sub-windows, as the decon stage does."""
    from nanoranger_torch.stages.decon import _sub_windows
    sc = spec.scan
    texts, lengths = window, wlen
    if sc.window_size is not None:
        texts, lengths, _ = _sub_windows(window, wlen, sc.window_size,
                                         sc.window_stride,
                                         sc.windows_plus_one)
    return check_ed_setting(dev, sc.pattern, texts, lengths, sc.k,
                            sc.n_wildcard, sc.pick_last)


def structured_candidates(rng, barcodes, n, spec, edits=(0, 4)):
    """(candidates, the barcode each was made from) laid out as `spec`'s
    BC-UMI slice: lead-in, barcode with a random number of edits from the
    half-open range `edits` (around the linker for slideseq rows), UMI,
    tail. Two or more edits are the rows the staged match sends to the
    exhaustive DP."""
    from nanoranger_torch.chemistry import SLIDESEQ_LINKER
    seqs, truth = [], []
    for _ in range(n):
        true_bc = str(barcodes[rng.integers(len(barcodes))])
        bc = list(true_bc)
        for _ in range(int(rng.integers(*edits))):
            i = int(rng.integers(len(bc)))
            op = rng.integers(3)
            if op == 0:
                bc[i] = "ACGT"[rng.integers(4)]
            elif op == 1 and len(bc) > 10:
                del bc[i]
            else:
                bc.insert(i, "ACGT"[rng.integers(4)])
        bc = "".join(bc)
        core = (bc[:8] + SLIDESEQ_LINKER + bc[8:] if spec.slideseq_linker
                else bc)
        acgt = lambda k: "".join("ACGT"[x] for x in rng.integers(0, 4, k))
        s = (acgt(spec.bc_query_offset + int(rng.integers(3))) + core
             + acgt(spec.umi_len) + acgt(int(rng.integers(0, 8))))
        seqs.append(s[:96])
        truth.append(true_bc)
    return seqs, truth


def verify_args(dev, coreT, spec, seqs, r_valid=None):
    """The one-vs-all DP's arguments as the staged match builds them: the
    candidates and their reverse complements (2 x len(seqs) rows of 96)
    against every row of coreT, the first r_valid of them live (all by
    default)."""
    import torch

    from nanoranger_torch.io.encode import encode_batch
    from nanoranger_torch.stages.barcode import revcomp_rows
    q_np, ql_np = encode_batch(seqs, max_len=96)
    qf = torch.from_numpy(q_np).to(dev)
    qlf = torch.from_numpy(ql_np).to(dev)
    qq = torch.cat([qf, revcomp_rows(qf, qlf)]).contiguous()   # (2n, 96)
    return (qq, torch.cat([qlf, qlf]), coreT,
            coreT.shape[1] if r_valid is None else r_valid, spec.pad_left,
            spec.pad_right)


def verify_cells(args) -> int:
    qq, qql, coreT = args[:3]
    return int(qql.sum()) * coreT.shape[0] * coreT.shape[1]


def verify_bound(args):
    """K4's bound: its DP cells at two packed 16-bit ops each (the add of
    the diagonal's score and the three-way maximum, one 16x2 instruction
    for two cells each) against the bytes of cores, candidates and the
    three outputs."""
    qq, _, coreT = args[:3]
    m, R = coreT.shape
    return bound(m * R + qq.numel() + 4 * qq.shape[0] * 4,
                 verify_cells(args) * 2, PACKED16_OPS_PER_S)


def check_verify(args):
    """K4 against its plain version on one launch's arguments."""
    from nanoranger_torch.ops.whitelist_verify import (verify_all,
                                                       verify_all_plain)
    got = verify_all(*args)
    ms = cuda_ms(lambda: verify_all(*args), 3)
    ref, plain_ms = plain_ms_of(
        lambda: verify_all_plain(*args, r_chunk=32768))
    mism, err = compare(got, ref)
    qq, _, coreT = args[:3]
    return {"shape": [int(qq.shape[0]), int(qq.shape[1]), *coreT.shape],
            "ms": ms, "plain_ms": plain_ms, "mismatches": mism,
            "max_abs_err": err, "bound": verify_bound(args)}, got


def check_verify_sw(dev, barcodes, spec, seqs, launch_rows):
    """K4 on the candidates and their reverse complements against every
    whitelist row, then K5 on the winners' bands; K4 also on the first
    rows of `seqs` at each candidate-row count of `launch_rows` (the
    pipeline's own launches)."""
    import torch

    from nanoranger_torch.ops.sw import sw_banded_plain, sw_end2end_banded
    from nanoranger_torch.stages.barcode import build_tables
    tables, ref_len = build_tables(barcodes, spec)
    coreT = torch.from_numpy(tables["coreT"]).to(dev)
    args = verify_args(dev, coreT, spec, seqs)
    verify, got = check_verify(args)
    at_launch = [check_verify(verify_args(dev, coreT, spec,
                                          seqs[:rows // 2]))[0]
                 for rows in launch_rows]
    qq, qql = args[:2]
    n = qq.shape[0] // 2
    qf, qlf = qq[:n], qql[:n]
    R = len(barcodes)

    band = torch.from_numpy(tables["band"]).to(dev)[
        got[1][:n].clamp(0, R - 1).long()].contiguous()
    sargs = (qf, qlf, band, ref_len, spec.pad_left, spec.umi_ref_offset)
    got = sw_end2end_banded(*sargs)
    ref, plain_ms = plain_ms_of(lambda: sw_banded_plain(*sargs))
    sms = cuda_ms(lambda: sw_end2end_banded(*sargs), 20)
    mism, err = compare(got, ref)
    nb = band.shape[1]
    sw = {"shape": [int(qf.shape[0]), int(qf.shape[1]), nb], "ms": sms,
          "plain_ms": plain_ms, "mismatches": mism, "max_abs_err": err,
          # one pass over the band: ~6 scalar ops a cell
          "bound": bound(qf.numel() + band.numel() + 16 * qf.shape[0],
                         int(qlf.sum()) * nb * 6)}
    return verify, at_launch, sw


def sw_full_row(args):
    """K6 against its plain version on (query, qlen, refs, rlen, c): the
    kernel's result and its phase-2 row."""
    from nanoranger_torch.ops.sw import sw_end2end, sw_end2end_plain
    q, ql, refs, rl, c = args
    P, Lr = refs.shape
    got = sw_end2end(*args)
    ref, plain_ms = plain_ms_of(lambda: sw_end2end_plain(*args))
    ms = cuda_ms(lambda: sw_end2end(*args), 20)
    mism, err = compare(got, ref)
    # one DP over each pair's (qlen + 1) rows x rlen live columns, ~8
    # scalar ops a cell
    cells = int(((ql + 1) * rl.clamp(0, Lr)).sum())
    return got, {"shape": [P, int(q.shape[1]), Lr], "c": c,
                 "valid": int(got[2].sum()), "ms": ms, "plain_ms": plain_ms,
                 "mismatches": mism, "max_abs_err": err,
                 "bound": bound(q.numel() + refs.numel() + 8 * P + 9 * P,
                                cells * 8)}


def check_sw_full(dev, barcodes, spec, rng):
    """K6 on 256 candidates, each against the full padded row of the
    barcode it was made from: against its plain version, and against the
    banded kernel on the same pairs."""
    import numpy as np
    import torch

    from nanoranger_torch.io import whitelist
    from nanoranger_torch.io.encode import encode_batch
    from nanoranger_torch.ops.sw import sw_end2end
    seqs, truth = structured_candidates(rng, barcodes, 256, spec)
    q_np, ql_np = encode_batch(seqs, max_len=96)
    refs_np, ref_len = whitelist.padded_refs(np.asarray(truth), spec)
    P, Lr = refs_np.shape
    q = torch.from_numpy(q_np).to(dev)
    ql = torch.from_numpy(ql_np).to(dev)
    refs = torch.from_numpy(np.ascontiguousarray(refs_np)).to(dev)
    rl = torch.full((P,), Lr, dtype=torch.int32, device=dev)
    args = (q, ql, refs, rl, spec.umi_ref_offset)
    got, r = sw_full_row(args)
    mism_banded, _ = compare(got, sw_end2end(*args, pad_left=spec.pad_left))
    r["mismatches"] += mism_banded
    r["vs_banded"] = mism_banded
    return r


def split_rows(rng, P, Lq, Lr, c):
    """P candidates against random rows with no N pads (PAD past each
    rlen), the inputs that exercise each term of K6's split at column
    k = min(c + 1, rlen): in turn a query planted wholly left of column c,
    wholly right of it, across it, and none, with some base changed,
    inserted or deleted; rlen ragged, at or below c on every seventh pair,
    qlen 0 and 1 on the first two. Returns numpy (q, qlen, refs, rlen)."""
    import numpy as np

    from nanoranger_torch.io.encode import PAD
    q = np.full((P, Lq), PAD, np.int8)
    qlen = rng.integers(0, Lq + 1, size=P).astype(np.int32)
    qlen[:2] = (0, min(1, Lq))
    refs = rng.integers(0, 4, size=(P, Lr)).astype(np.int8)
    rlen = rng.integers(1, Lr + 1, size=P).astype(np.int32)
    rlen[::3] = Lr
    rlen[5::7] = rng.integers(0, c + 1, size=len(rlen[5::7]))
    for i in range(P):
        n, lr = int(qlen[i]), int(rlen[i])
        q[i, :n] = rng.integers(0, 5, n)
        lo, hi = ((0, min(c, lr)), (c + 2, lr), (c - n // 2, c + n - n // 2),
                  (0, 0))[i % 4]
        lo, hi = max(lo, 0), min(hi, lr)
        m = min(n, hi - lo)
        if m > 0:
            at = lo + int(rng.integers(0, hi - lo - m + 1))
            q[i, :m] = refs[i, at:at + m]
            if i % 5 == 0 and m > 4:                 # a substitution
                q[i, m // 2] = (q[i, m // 2] + 1) % 4
            if i % 6 == 1 and 4 < m < n:             # an insertion
                q[i, m // 3 + 1:m + 1] = q[i, m // 3:m].copy()
            if i % 7 == 2 and m > 4:                 # a deletion
                q[i, m // 3:m - 1] = q[i, m // 3 + 1:m].copy()
        refs[i, lr:] = PAD
    return q, qlen, refs, rlen


def check_sw_full_split(dev, rng):
    """K6 on 256 split_rows pairs at the 5' row's width and UMI column."""
    import torch
    c = 46
    q, qlen, refs, rlen = (torch.from_numpy(a).to(dev)
                           for a in split_rows(rng, 256, 96, 86, c))
    r = sw_full_row((q, qlen, refs, rlen, c))[1]
    r["rlen_le_c"] = int((rlen <= c).sum())
    return r


# --------------------------------------------------------------------------
# the device step (stages/device_step.py) at the bench.py _setup shape

STEP_B, STEP_L, STEP_MM = 1024, 2048, 512   # reads a step, length, minimizers
STEP_KERNELS = ("chain", "ed", "verify", "sw")


def step_batches():
    """bench.py _setup's batches: the K562 sample read whole at L = 2048,
    its first floor(reads / 1024) * 1024 reads in batches of 1024."""
    from nanoranger_torch.io import fastq
    batch = fastq.read_all(SAMPLE, max_len=STEP_L, pad_to_multiple=STEP_L)
    n = len(batch) // STEP_B * STEP_B
    return [(batch.codes[s:s + STEP_B], batch.lengths[s:s + STEP_B])
            for s in range(0, n, STEP_B)]


def build_step(dev, barcodes, index, spec):
    """build_device_step on `dev` as bench.py _setup builds it: S = 2,
    max_minimizers 512, the matcher's tables on `dev`."""
    from nanoranger_torch.stages.barcode import BarcodeMatcher
    from nanoranger_torch.stages.device_step import build_device_step
    return build_device_step(spec, index,
                             BarcodeMatcher(barcodes, spec.barcode, dev),
                             S=2, max_minimizers=STEP_MM, device=dev)


def recorded_verify_args(fn):
    """The arguments of every one-vs-all DP launch one call of fn makes
    through the matcher (stages/barcode.verify_all)."""
    from nanoranger_torch.stages import barcode
    calls = []
    verify_all = barcode.verify_all

    def recording(*a):
        calls.append(a)
        return verify_all(*a)

    barcode.verify_all = recording
    try:
        fn()
    finally:
        barcode.verify_all = verify_all
    return calls


def kernel_time(prof, of=None) -> dict:
    """The card's kernel time in a torch.profiler run (one stream, so
    kernels do not overlap), its launches and the ten kernels with the most
    time; with `of`, also the milliseconds and launches of the kernels
    whose name holds it, from one key_averages() (slow on a run of
    100,000 launches)."""
    import torch
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    out = {"kernel_s": round(sum(e.self_device_time_total
                                 for e in kern) / 1e6, 4),
           "kernel_launches": int(sum(e.count for e in kern)),
           "top_kernels": [[e.key[:60], round(e.self_device_time_total
                                              / 1e3, 3), e.count]
                           for e in top]}
    if of:
        hit = [e for e in kern if of in e.key]
        out[f"{of}_ms"] = round(sum(e.self_device_time_total
                                    for e in hit) / 1e3, 3)
        out[f"{of}_launches"] = int(sum(e.count for e in hit))
    return out


def device_step_phase(card, step, batches, barcodes, index, spec):
    """bench.py _measure on the card: one warm pass over the batches, then
    one timed pass ending in a synchronise, the launch counts set to 0 just
    before it and read just after; then one pass under torch.profiler (the
    card's kernel time); batch 0 again through the same step built on the
    CPU (plain kernels, the host twin of K4), every output held equal.
    Returns a failure or None, and the timed pass's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nanoranger_torch import kernels
    for c, ln in batches:
        step(c, ln)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.time()
    outs = [step(c, ln) for c, ln in batches]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        for c, ln in batches:
            step(c, ln)
        torch.cuda.synchronize()
        prof_wall = time.time() - t1
    n = sum(len(ln) for _, ln in batches)
    t2 = time.time()
    ref = build_step(torch.device("cpu"), barcodes, index, spec)(
        *batches[0])
    cpu_s = time.time() - t2
    got = {k: v.cpu() for k, v in outs[0].items()}
    differ = sorted(k for k in ref if not torch.equal(got[k], ref[k]))
    emit({"phase": "device_step", "card": card, "reads": n,
          "batches": len(batches), "batch": STEP_B, "L": STEP_L, "S": 2,
          "max_minimizers": STEP_MM, "whitelist": len(barcodes),
          "wall_s": round(wall, 4), "reads_per_s": round(n / wall, 1),
          "ms_per_batch": round(wall * 1e3 / len(batches), 3),
          "accepted_slots": int(sum(int((o["status"] == 0).sum())
                                    for o in outs)),
          "ok_slots": int(sum(int(o["rec_ok"].sum()) for o in outs)),
          "n_deferred": int(sum(int(o["n_deferred"]) for o in outs)),
          "launches": {k: launches[k] for k in STEP_KERNELS},
          "profiled_wall_s": round(prof_wall, 4), **kernel_time(prof),
          "cpu_batch0_s": round(cpu_s, 2), "cpu_differ": differ})
    idle = [k for k in STEP_KERNELS if launches[k] <= 0]
    if idle:
        return f"the device step never launched {idle}", launches
    if differ:
        return (f"the device step on the card differs from the CPU step "
                f"on batch 0 in {differ}"), launches
    return None, launches


def entry_phase(card):
    """entry() on the card against entry(device='cpu') and the JAX entry's
    checks of a step's outputs, then dryrun_multichip(4): a 2 x 2 mesh laid
    on the card(s) there are. Returns a failure or None."""
    import torch

    from nanoranger_torch import entry
    t0 = time.time()
    step, args = entry.entry()
    got = {k: v.cpu() for k, v in step(*args).items()}
    ref = entry.entry(device="cpu")[0](*args)
    acc = int((got["status"] == 0).sum())
    differ = sorted(k for k in ref if not torch.equal(got[k], ref[k]))
    emit({"phase": "entry", "card": card, "seconds": round(time.time() - t0,
                                                           2),
          "reads": int(len(args[1])), "accepted_slots": acc,
          "n_deferred": int(got["n_deferred"]), "cpu_differ": differ})
    if differ or acc <= 0 or int(got["counts"].sum()) != acc or \
            int(got["n_deferred"]):
        return f"entry() on the card: differ {differ}, {acc} accepted"
    t0 = time.time()
    entry.dryrun_multichip(4)
    emit({"phase": "dryrun_multichip", "card": card, "n_devices": 4,
          "cards": torch.cuda.device_count(),
          "seconds": round(time.time() - t0, 2)})
    return None


# --------------------------------------------------------------------------
# --ptxas: what ptxas made of each kernel

def sass_loops(sass: str) -> dict:
    """{function: [[first address, instructions], ...]} of every backward
    branch in cuobjdump's SASS: the loops, each from its branch target to
    the branch."""
    import re
    loops, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            loops[fn] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not (m and fn):
            continue
        at = int(m.group(1), 16)
        b = re.search(r"\bBRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)",
                      m.group(2))
        if b and int(b.group(1), 16) <= at:
            start = int(b.group(1), 16)
            loops[fn].append([hex(start), (at - start) // 16 + 1])
    return loops


def ptxas_report(out_dir: str) -> int:
    """Build every library with -Xptxas -v into out_dir, emit one line per
    kernel with its registers, spills and SASS loops, and keep the SASS
    beside the libraries."""
    import re

    from nanoranger_torch import kernels
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name, (src, extra) in kernels.SOURCES.items():
        so = os.path.join(out_dir, f"lib{name}.so")
        cmd = [kernels.nvcc_path(), *kernels.ARCH_FLAGS,
               *kernels.COMMON_FLAGS, *extra, "-Xptxas", "-v", "-o", so,
               os.path.join(kernels.CSRC, src)]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()),
                             "cuobjdump")
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        with open(os.path.join(out_dir, f"lib{name}.sass"), "w") as f:
            f.write(sass)
        loops = sass_loops(sass)
        info, fn = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                info[fn] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn:
                info[fn]["spill_stores"] = int(m.group(1))
                info[fn]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                info[fn]["registers"] = int(m.group(1))
        for fn, d in info.items():
            emit({"phase": "ptxas", "library": name, "function": fn, **d,
                  "sass_instructions": sum(
                      1 for line in sass.split(f"Function : {fn}")[-1]
                      .split("Function : ")[0].splitlines()
                      if re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line)),
                  "loops": loops.get(fn, [])})
    return 0


# --------------------------------------------------------------------------
# the whitelist screens on the card against the CPU

def screen_tables(barcodes, spec):
    """(plan, SeedTable, ProductTable) of a whitelist at the chemistry's
    nominal barcode offset (ProductTable None for a list that is not a
    product or whose pair table is too large)."""
    from nanoranger_torch.io.encode import encode_batch
    from nanoranger_torch.ops import product_screen as ps
    from nanoranger_torch.ops import seed_screen as ss
    codes, _ = encode_batch(list(barcodes), max_len=spec.bc_len)
    plan = ss.plan_for(spec, spec.bc_query_offset)
    return (plan, ss.SeedTable(codes, plan),
            ps.ProductTable.build(codes, plan.half_bounds, plan.q_deltas))


def run_screens(dev, tables, q, ql, reps=1):
    """The bucket screen, the product screen and the joint product screen
    over the offsets a candidate of width q.shape[1] holds, on `dev`:
    {name: ((candidates, counts) as numpy, seconds a call)}; the first
    call of each on the card is a warm-up."""
    import torch

    from nanoranger_torch.ops import product_screen as ps
    from nanoranger_torch.ops import seed_screen as ss
    plan, seed, prod = tables
    tq, tql = (torch.from_numpy(a).to(dev) for a in (q, ql))
    arrs = [torch.from_numpy(a[h]).to(dev) for h in (0, 1)
            for a in (seed.starts, seed.counts, seed.entries,
                      seed.half_keys)]
    fns = {"seed_screen": lambda: ss.screen(tq, tql, *arrs, plan=plan,
                                            maxocc=seed.maxocc)}
    if prod is not None:
        pa = [torch.from_numpy(a).to(dev)
              for a in (prod.planes1, prod.planes2, prod.pair)]
        fns["product_screen"] = lambda: ps.product_screen(
            tq, tql, *pa, nominal=plan.nominal, jitter=plan.jitter,
            q_delta2=prod.q_delta2, l1=prod.l1, l2=prod.l2)
        fns["product_screen_joint"] = lambda: ps.product_screen_joint(
            tq, tql, *pa, lo=0, hi=q.shape[1] - prod.q_delta2 - prod.l2,
            q_delta2=prod.q_delta2, l1=prod.l1, l2=prod.l2)
    out = {}
    for name, fn in fns.items():
        if dev.type == "cuda":
            fn()
            torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(reps):
            r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[name] = (tuple(x.cpu().numpy() for x in r),
                     (time.time() - t0) / reps)
    return out


def screens_phase(card, dev, barcodes, spec, outdir, s):
    """The three screens on the card and on the CPU over the BC-UMI
    candidates of a run (outdir, sample s) at the match width, against
    the whole whitelist: the card's candidates and counts must equal the
    CPU's. Prints each screen's card and CPU time and its recall: the
    share of the run's ACCEPT rows (the exact matcher's) whose barcode is
    among the screen's candidates. Returns a failure or None."""
    import numpy as np
    import pandas as pd
    import torch

    from nanoranger_torch.io.encode import encode_batch
    from nanoranger_torch.io.fasta import iter_fasta
    from nanoranger_torch.pipeline import MATCH_LQ
    df = pd.read_csv(f"{outdir}/{s}_assignments.csv.gz",
                     keep_default_na=False, dtype={"name": str, "bc": str})
    seqs = [sq for _, sq in iter_fasta(f"{outdir}/{s}_BCUMI.fasta.gz")]
    q, ql = encode_batch(seqs, max_len=MATCH_LQ)
    row = {b: i for i, b in enumerate(barcodes)}
    acc = np.flatnonzero(df.status.to_numpy() == 0)
    want = np.array([row[b] for b in df.bc.to_numpy()[acc]])
    t0 = time.time()
    tables = screen_tables(barcodes, spec)
    tables_s = time.time() - t0
    gpu = run_screens(dev, tables, q, ql, reps=3)
    cpu = run_screens(torch.device("cpu"), tables, q, ql)
    out, bad = {}, []
    for name, ((cand, cnt), sec) in gpu.items():
        (c_cand, c_cnt), c_sec = cpu[name]
        same = np.array_equal(cand, c_cand) and np.array_equal(cnt, c_cnt)
        if not same:
            bad.append(name)
        out[name] = {"card_ms": round(sec * 1e3, 3),
                     "cpu_ms": round(c_sec * 1e3, 1), "card_equals_cpu": same,
                     "recall": round(float(np.mean(
                         (cand[acc] == want[:, None]).any(axis=1))), 4)}
    emit({"phase": "screens", "card": card, "candidates": int(len(q)),
          "width": MATCH_LQ, "accepted": int(len(acc)),
          "whitelist": len(barcodes), "tables_s": round(tables_s, 3),
          "screens": out})
    if bad or len(gpu) != 3:
        return f"the screens on the card differ from the CPU: {bad}"
    return None


# --------------------------------------------------------------------------
# the host libraries: the prewarm, zlib

def zlib_on_host() -> bool:
    """Whether g++ finds zlib's header and links -lz on this host (what
    the native fastq reader needs)."""
    src = "#include <zlib.h>\nint main() { return zlibVersion() == 0; }\n"
    with tempfile.TemporaryDirectory() as d:
        try:
            r = subprocess.run(["g++", "-x", "c++", "-", "-o",
                                os.path.join(d, "a.out"), "-lz"],
                               input=src, text=True, capture_output=True,
                               timeout=120)
        except OSError:
            return False
    return r.returncode == 0


# whether this host builds the native fastq reader; every run must take it
# then (set by the prewarm)
HOST = {"reader": True}


def prewarm_phase(card):
    """python -m nanoranger_torch.tools.prewarm, as a deployment runs it
    before its first run: every kernel and host library built. The reader
    may fail to build only on a host without zlib. Returns a failure or
    None."""
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m",
                        "nanoranger_torch.tools.prewarm"], cwd=HERE,
                       capture_output=True, text=True, timeout=900)
    libs = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]
    zlib = zlib_on_host()
    failed = sorted(d.get("library", "cuda") for d in libs
                    if "error" in d or "skipped" in d)
    HOST["reader"] = "nrfastq" not in failed
    emit({"phase": "prewarm", "card": card, "rc": r.returncode,
          "seconds": round(time.time() - t0, 2), "zlib_on_host": zlib,
          "libraries": libs})
    if (failed and failed != ["nrfastq"]) or (failed and zlib) or \
            len(libs) != 7:
        return f"the prewarm failed: {failed} ({r.stderr[-2000:]})"
    return None


# --------------------------------------------------------------------------
# phases 3 and 4: the main paths

def tile_fastq(src, n_reads, dst):
    """Write `src` repeated (read names prefixed t<k>_) until it holds
    n_reads reads, as bench.py's _cli_bench does; returns the read count."""
    with gzip.open(src, "rt") as f:
        lines = f.read().splitlines(keepends=True)
    n_src = len(lines) // 4
    reps = -(-n_reads // n_src)
    with gzip.open(dst, "wt", compresslevel=1) as g:
        for t in range(reps):
            for i in range(0, len(lines), 4):
                g.write(f"@t{t}_{lines[i][1:]}")
                g.writelines(lines[i + 1:i + 4])
    return reps * n_src


def count_fastq(path):
    n = tot = 0
    with gzip.open(path, "rt") as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                n += 1
                tot += len(line.strip())
    return n, tot


def collect(outdir, s, mode):
    """The golden counts of an outdir (tools/gen_real_goldens.py)."""
    import pandas as pd
    g = {}
    kind = "VDJ" if mode == "3pXCR_slideseq" else "deconcat"
    g["n_subreads"], g["subread_bases"] = count_fastq(
        f"{outdir}/{s}_{kind}.fastq.gz")
    if mode == "RTX":
        g["n_clone_rows"] = int(len(pd.read_csv(
            f"{outdir}/{s}_clones.txt.gz", sep="\t")))
        g["n_cloneID_rows"] = int(len(pd.read_csv(
            f"{outdir}/{s}_cloneID.txt.gz", sep="\t")))
        return g
    df = pd.read_csv(f"{outdir}/{s}_assignments.csv.gz",
                     keep_default_na=False)
    g["n_candidates"] = int(len(df))
    g["n_accepted"] = int((df.status == 0).sum())
    acc = df[df.status == 0]
    g["n_distinct_bc"] = int(acc.bc.nunique())
    g["umi_len_mode"] = (int(acc.umi.str.len().mode()[0]) if len(acc)
                         else 0)
    if mode == "5p10XGEX":
        from nanoranger_torch.io.bam import read_bam
        _, _, records = read_bam(f"{outdir}/{s}_genome_tagged.bam")
        g["n_tagged_bam"] = sum(1 for _ in records)
        g["n_dedup_rows"] = int(len(pd.read_csv(
            f"{outdir}/{s}_bcumi_dedup.csv")))
    if mode == "5p10XTCR":
        g["n_clones"] = int(len(pd.read_csv(
            f"{outdir}/{s}_clones_filtered.csv")))
        g["n_clone_bcumi"] = int(len(pd.read_csv(
            f"{outdir}/{s}_clone_bcumi.csv.gz")))
    if mode == "3pXCR_slideseq":
        g["n_eds_rows"] = int(len(pd.read_csv(
            f"{outdir}/{s}_eds_names.csv.gz")))
    with open(f"{outdir}/{s}_runstats.json") as f:
        g["runstats_stages"] = [r["stage"] for r in json.load(f)["stages"]]
    return g


class _NoNativeReader:
    """Stands in for the native fastq reader: every read-in takes the
    Python parser, as when the reader's library cannot be built."""

    def __init__(self, *a, **kw):
        raise OSError("the parser is forced")


def run_mode(name, mode, infile, panel, genome, wl, out, card, golden,
             expect, shards=None, fast=None, batch_size=2048, parser=False):
    """One run of run_pipeline on the card with the launch counts set to 0
    just before and read just after; `shards` is (wl_shards, data_shards),
    and a sharded run reports its match's spans from the run statistics;
    fast=False takes the unfused path;
    parser=True forces the Python fastq parser. The launches made inside
    the fused step's calls are counted apart (`step_launches`), and so are
    the files each reader opened (`reader`): a run that fell back to the
    parser on a host that builds the native reader fails. Returns
    (launches, failure or None); the run's line is kept in
    RUN_LINES[name]."""
    import torch

    from nanoranger_torch import kernels, pipeline
    from nanoranger_torch.io import fastq
    from nanoranger_torch.parallel import sharded
    from nanoranger_torch.runtime import native_lib
    from nanoranger_torch.stages import barcode
    verify_rows = []          # candidate rows (C) of each one-vs-all launch
    verify_all = barcode.verify_all
    build_cli_step = pipeline.build_cli_step
    in_step = dict.fromkeys(kernels.launches, 0)
    readers = {"native": 0, "parser": 0}
    native_reader, iter_fastq = native_lib.NativeFastqReader, fastq.iter_fastq

    class CountingReader(native_reader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            readers["native"] += 1

    def counting_iter_fastq(path):
        readers["parser"] += 1
        return iter_fastq(path)

    def recording_verify_all(qq, *a, **kw):
        verify_rows.append(int(qq.shape[0]))
        return verify_all(qq, *a, **kw)

    def counting_build(*a, **kw):
        step, tables = build_cli_step(*a, **kw)

        def counted(*sa):
            before = dict(kernels.launches)
            out = step(*sa)
            for k, v in kernels.launches.items():
                in_step[k] += v - before[k]
            return out
        return counted, tables

    barcode.verify_all = sharded.verify_all = recording_verify_all
    pipeline.build_cli_step = counting_build
    native_lib.NativeFastqReader = _NoNativeReader if parser else \
        CountingReader
    fastq.iter_fastq = counting_iter_fastq
    wl_shards, data_shards = shards or (1, 1)
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        pipeline.run_pipeline(mode, infile, out, "t", trns_ref=panel,
                              genome_ref=genome, barcodes=wl, device="cuda",
                              wl_shards=wl_shards, data_shards=data_shards,
                              fast=fast, batch_size=batch_size)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(kernels.launches)
    finally:
        barcode.verify_all = sharded.verify_all = verify_all
        pipeline.build_cli_step = build_cli_step
        native_lib.NativeFastqReader = native_reader
        fastq.iter_fastq = iter_fastq
    got = collect(out, "t", mode) if golden is not None else {}
    with open(os.path.join(out, "t_runstats.json")) as f:
        runstats = json.load(f)
    stages = runstats["stages"]
    n_reads = stages[0]["reads"]
    line = {"phase": "sharded" if shards else "main", "run": name,
            "mode": mode, "card": card, "wl_shards": wl_shards,
            "data_shards": data_shards,
            "path": "fused" if "phase_s" in stages[0] else "unfused",
            "wall_s": round(wall, 3), "reads": n_reads,
            "reads_per_s": round(n_reads / wall, 1),
            "deferred_reads": stages[0].get("deferred_reads", 0),
            "phase_s": stages[0].get("phase_s"), "launches": launches,
            "step_launches": in_step, "reader": readers}
    RUN_LINES[name] = line
    emit({**line,
          "verify_rows_per_launch": verify_rows, "counts": got,
          **({"tier_chunk": sharded.TIER_CHUNK,
              "match_spans_n_s": {
                  k: [v["n"], round(v["s"], 4)]
                  for k, v in runstats["span_totals"].items()
                  if k.startswith("match.")}}
             if shards else {}),
          "stages": [{k: s[k] for k in ("stage", "seconds", "whitelist_s",
                                        "shard_tables_s", "records",
                                        "index_s", "align_s", "cigar_s",
                                        "write_s")
                      if k in s} for s in stages]})
    if readers["parser"] and HOST["reader"] and not parser:
        return launches, (f"run {name} read {readers['parser']} file(s) "
                          f"with the Python parser: the native reader "
                          f"builds on this host")
    if golden is None:          # a run held only to its twin
        return launches, None
    bad = {k: (got.get(k), v) for k, v in golden.items() if got.get(k) != v}
    if bad:
        return launches, (f"run {name} differs from its golden "
                          f"(got, want): {bad}")
    if min(v for v in got.values() if isinstance(v, int)) <= 0:
        return launches, f"run {name} left an empty table: {got}"
    idle = [k for k in expect if launches[k] <= 0]
    if idle:
        return launches, f"run {name} never launched {idle}"
    return launches, None


RUN_LINES: dict = {}


def twin_check(name, fused_out, unfused_out, card, in_step=("chain",)):
    """The fused run against its unfused twin: every artifact's digest
    equal, and the kernels `in_step` launched from inside the fused step.
    Emits one line with both runs' walls, the fused run's
    phase_s and deferred reads, and the K1-K5 launches
    of both. Returns a failure or None."""
    f, u = RUN_LINES[name], RUN_LINES[name + "_unfused"]
    got, want = artifact_digests(fused_out), artifact_digests(unfused_out)
    differ = sorted(k for k in set(got) | set(want)
                    if got.get(k) != want.get(k))
    k15 = ("chain", "ed", "verify", "sw", "chain_splice")
    emit({"phase": "twins", "run": name, "card": card,
          "fused_wall_s": f["wall_s"], "unfused_wall_s": u["wall_s"],
          "fused_reads_per_s": f["reads_per_s"],
          "unfused_reads_per_s": u["reads_per_s"],
          "phase_s": f["phase_s"], "deferred_reads": f["deferred_reads"],
          "fused_launches": {k: f["launches"][k] for k in k15},
          "fused_step_launches": {k: f["step_launches"][k] for k in k15},
          "unfused_launches": {k: u["launches"][k] for k in k15},
          "artifacts": len(want), "differ": differ})
    if f["path"] != "fused" or u["path"] != "unfused":
        return f"run {name}: the twins took paths {f['path']}/{u['path']}"
    if differ:
        return f"run {name}: the fused artifacts differ from the unfused in "\
            f"{differ}"
    idle = [k for k in in_step if f["step_launches"][k] <= 0]
    if idle:
        return f"run {name}: the fused step never launched {idle}"
    return None


def aten_calls(fn) -> int:
    """The aten operator calls one call of fn dispatches, kernel launches
    and views alike (counted by a TorchDispatchMode)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def tier_call_counts(dev, swl, spec, seqs):
    """Aten calls of one call of each function of the sharded tier pass on
    one shard's tables, at a tier chunk's rows (256) and a k562 data
    block's (1,527): the host's share of the pass follows this count."""
    import torch

    from nanoranger_torch.io.encode import encode_batch
    from nanoranger_torch.parallel.sharded import make_mesh
    from nanoranger_torch.stages.barcode import boundary_flags, tier_hits
    a = swl.device_arrays(make_mesh(1, swl.n_wl, [dev]))[0][0]
    bl, pl, pr = spec.bc_len, spec.pad_left, spec.pad_right
    out = {}
    for n in (256, 1527):
        q, qlen = encode_batch([seqs[i % len(seqs)] for i in range(n)],
                               max_len=96)
        q, qlen = torch.from_numpy(q).to(dev), torch.from_numpy(qlen).to(dev)
        out[n] = {
            "tier_hits": aten_calls(lambda: tier_hits(
                q, qlen, a["ex_keys"], a["ex_idx"], bl, pl, pr)),
            "tier_hits_rc": aten_calls(lambda: tier_hits(
                q, qlen, a["rc_ex_keys"], a["rc_ex_idx"], bl, pr, pl,
                any_only=True)),
            "boundary_flags": aten_calls(lambda: boundary_flags(
                q, qlen, a["bnd"][:4], bl, pl, pr))}
    return out


def device_time(infile, out):
    """One fused 5p10XGEX run of `infile` (the cli_bench shape) under
    torch.profiler: the card's kernel time summed over the run (one
    stream, so kernels do not overlap), the profiled wall, and the ten
    kernels with the most time. The profiler adds host time to every op,
    so the profiled wall is longer than an unprofiled run's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nanoranger_torch.pipeline import run_pipeline
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_pipeline("5p10XGEX", infile, out, "t", trns_ref=PANEL,
                     genome_ref="/nonexistent", barcodes=WHITELIST,
                     device="cuda")
        torch.cuda.synchronize()
    wall = time.time() - t0
    return {"profiled_wall_s": round(wall, 3), **kernel_time(prof)}


def artifact_digests(outdir):
    """sha1 of each artifact's content: gunzipped, a BAM after BGZF
    decompression; pdfs (they embed timestamps) and the run statistics
    (timings) aside."""
    import hashlib

    from nanoranger_torch.io import bam
    out = {}
    for f in sorted(os.listdir(outdir)):
        p = os.path.join(outdir, f)
        if f.endswith((".pdf", "_runstats.json", ".tmp")):
            continue
        if f.endswith(".bam"):
            data = bam._bgzf_decompress(p)
        else:
            with (gzip.open if f.endswith(".gz") else open)(p, "rb") as fh:
                data = fh.read()
        out[f] = hashlib.sha1(data).hexdigest()
    return out


# --------------------------------------------------------------------------
# the scale phase: nanoranger_torch/tools/scale_bench.py at the full
# 1,000,000-row product list, the transcriptome and the reads cut

# the tool runs 160 Mb over 4,000 transcripts and 20,000 reads; the phase
# keeps the transcripts' length (40,000 bases) and the list whole
SCALE_CUT = {"mb": 32, "n_refs": 800, "n_wl": 1_000_000, "reads": 4_000}
SCALE_PREFIX = 100          # reads run on the card and on the CPU
SCALE_KERNELS = ("chain", "ed", "verify", "sw")


def cut_verify_args(args, rows=128):
    """A one-vs-all launch's arguments cut to at most `rows` candidate rows:
    the first rows/2 forward candidates and their reverse complements."""
    import torch
    qq, qql = args[:2]
    n = qq.shape[0] // 2
    k = min(n, rows // 2)

    def pick(x):
        return torch.cat([x[:k], x[n:n + k]]).contiguous()
    return (pick(qq), pick(qql), *args[2:])


def write_prefix(src, n_reads, dst):
    """The first n_reads records of a gzipped fastq."""
    with gzip.open(src, "rt") as f:
        lines = [line for _, line in zip(range(4 * n_reads), f)]
    with gzip.open(dst, "wt") as g:
        g.writelines(lines)


def scale_phase(card, d, out_card, out_cpu, prof_out):
    """The scale tool's run at SCALE_CUT on the card, through its own
    synthesize() and measure() (launch counts set to 0 inside, just before
    the pipeline, and read just after): K1, K2+K3, K4 and K5 must launch
    and some reads be accepted. Then K4 at the run's first launch (cut to
    128 rows) against its plain version on the 1M-row list, one profiled
    run of the same files (the card's kernel time and K4's), and the first
    SCALE_PREFIX reads through the pipeline on the card and on the CPU,
    every artifact equal. Returns (failure or None, the run's launches,
    the K4 row)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nanoranger_torch.pipeline import run_pipeline
    from nanoranger_torch.tools import scale_bench
    t0 = time.time()
    bcs, truth = scale_bench.synthesize(d, **SCALE_CUT)
    gen_s = time.time() - t0
    res = {}
    calls = recorded_verify_args(lambda: res.update(scale_bench.measure(
        d, truth, SCALE_CUT["mb"], SCALE_CUT["n_refs"], len(bcs), "cuda")))
    launches = res["launches"]
    emit({"phase": "scale", "card": card, "reduced": {
        k: [SCALE_CUT[k], v] for k, v in scale_bench.DEFAULTS.items()
        if SCALE_CUT[k] != v}, "synthesize_s": round(gen_s, 2),
        "verify_rows_per_launch": [int(a[0].shape[0]) for a in calls],
        "verify_bound_ms_per_launch": [verify_bound(a)[0] for a in calls],
        **res})
    idle = [k for k in SCALE_KERNELS if launches[k] <= 0]
    if idle or not calls:
        return f"the scale run never launched {idle or ['verify']}", \
            launches, None
    if res["accepted"] <= 0:
        return "the scale run accepted no read", launches, None
    k4 = check_verify(cut_verify_args(calls[0]))[0]

    kw = dict(trns_ref=f"{d}/txome.fa", genome_ref="/nonexistent",
              barcodes=f"{d}/wl.txt.gz", batch_size=512)
    torch.cuda.synchronize()
    t1 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_pipeline("5p10XGEX", f"{d}/reads.fastq.gz", prof_out, "t",
                     device="cuda", **kw)
        torch.cuda.synchronize()
    prof_wall = time.time() - t1
    kt = kernel_time(prof, of="verify_kernel")

    prefix = os.path.join(d, "prefix.fastq.gz")
    write_prefix(f"{d}/reads.fastq.gz", SCALE_PREFIX, prefix)
    walls = {}
    for out, device in ((out_card, "cuda"), (out_cpu, "cpu")):
        t2 = time.time()
        run_pipeline("5p10XGEX", prefix, out, "t", device=device, **kw)
        walls[device] = round(time.time() - t2, 2)
    got, want = artifact_digests(out_card), artifact_digests(out_cpu)
    differ = sorted(k for k in set(got) | set(want)
                    if got.get(k) != want.get(k))
    emit({"phase": "scale_check", "card": card,
          "profiled_wall_s": round(prof_wall, 3),
          "busy_share": round(kt["kernel_s"] / prof_wall, 4), **kt,
          "prefix_reads": SCALE_PREFIX, "prefix_wall_s": walls,
          "artifacts": len(want), "differ": differ})
    if differ or not want:
        return (f"the scale prefix on the card differs from the CPU in "
                f"{differ}"), launches, k4
    return None, launches, k4


# --------------------------------------------------------------------------
# phase 6: the full-row rescorer on a run's real pairs

def rescan_real_pairs(outdir, s, spec, device):
    """Every accepted row of {s}_assignments.csv.gz, candidate against the
    full padded row of its barcode: ops.sw.sw_end2end without pad_left (the
    full-row route) against with it (the banded route), and the UMI cut at
    the full-row position against the table's. Returns the pair count and
    the counts of disagreements."""
    import numpy as np
    import pandas as pd
    import torch

    from nanoranger_torch.io import whitelist
    from nanoranger_torch.io.encode import encode_batch
    from nanoranger_torch.io.fasta import iter_fasta
    from nanoranger_torch.ops.sw import sw_end2end
    df = pd.read_csv(f"{outdir}/{s}_assignments.csv.gz",
                     keep_default_na=False,
                     dtype={"name": str, "bc": str, "umi": str})
    cands = list(iter_fasta(f"{outdir}/{s}_BCUMI.fasta.gz"))
    if [n for n, _ in cands] != df.name.tolist():
        raise RuntimeError("assignments and BCUMI candidates differ in order")
    rows = np.where(df.status.to_numpy() == 0)[0]
    seqs = [cands[i][1][:96] for i in rows]
    bs = spec.barcode
    q_np, ql_np = encode_batch(seqs, max_len=96)
    refs_np, _ = whitelist.padded_refs(df.bc.to_numpy()[rows], bs)
    P, Lr = refs_np.shape
    dev = torch.device(device)
    q = torch.from_numpy(q_np).to(dev)
    ql = torch.from_numpy(ql_np).to(dev)
    refs = torch.from_numpy(np.ascontiguousarray(refs_np)).to(dev)
    rl = torch.full((P,), Lr, dtype=torch.int32, device=dev)
    c = bs.umi_ref_offset
    fs, fq, fv = (x.cpu().numpy() for x in sw_end2end(q, ql, refs, rl, c))
    bsc, bq, bv = (x.cpu().numpy() for x in sw_end2end(
        q, ql, refs, rl, c, pad_left=bs.pad_left))
    umis = [sq[p:p + bs.umi_len] if p >= 0 else ""
            for sq, p in zip(seqs, fq.tolist())]
    return {"pairs": int(P), "ref_len": int(Lr),
            "score_mismatches": int((fs != bsc).sum()),
            "valid_mismatches": int((fv != bv).sum()),
            "qpos_mismatches": int((fq[fv] != bq[fv]).sum()),
            "invalid": int((~fv).sum()),
            "umi_mismatches": int(sum(
                a != b for a, b in zip(umis, df.umi.to_numpy()[rows])))}


def rescan_failed(r) -> bool:
    return r["pairs"] == 0 or any(
        r[k] for k in ("score_mismatches", "valid_mismatches",
                       "qpos_mismatches", "invalid", "umi_mismatches"))


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "NVIDIA card.")
    ap.add_argument("--kernels", action="store_true",
                    help="phases 1 and 2 only: build the kernels and hold "
                    "each against its plain version")
    ap.add_argument("--ptxas", metavar="DIR",
                    help="only build every kernel library into DIR with "
                    "-Xptxas -v and print each kernel's registers, spills "
                    "and SASS loops (the SASS is kept in DIR)")
    opts = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "only on a card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "nanoranger_torch")) or \
            not os.path.isfile(SAMPLE):
        print("chip_smoke: run it from a checkout of the repository "
              "(nanoranger_torch/ and data/ beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if opts.ptxas:
        return ptxas_report(opts.ptxas)
    import numpy as np

    from nanoranger_torch import kernels
    from nanoranger_torch.align.aligner import MAX_INTRON
    from nanoranger_torch.align.index import PanelIndex
    from nanoranger_torch.chemistry import get as get_spec
    from nanoranger_torch.io import fastq, whitelist
    from nanoranger_torch.parallel import sharded
    from nanoranger_torch.parallel.sharded import ShardedWhitelist

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "card": card, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_s = {}
    t_phase = [time.time()]

    def phase_done(name):
        now = time.time()
        phase_s[name] = round(now - t_phase[0], 2)
        t_phase[0] = now

    # the prewarm first, as a deployment runs it: phase 1 then finds every
    # library built
    why = prewarm_phase(card)
    if why:
        print(f"chip_smoke: {why}", file=sys.stderr)
        return 1
    from nanoranger_torch.runtime import native_lib
    prebuilt = {n: os.path.isfile(kernels.lib_path(n))
                for n in kernels.SOURCES}
    prebuilt.update({n: os.path.isfile(native_lib._lib_path(n))
                     for n in native_lib.LIBS})
    t0 = time.time()
    kernels.build_all()
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "libraries": sorted(kernels.SOURCES),
          "dir": os.path.relpath(kernels.build_dir(), HERE),
          "found_prebuilt": prebuilt})
    if not all(v for n, v in prebuilt.items()
               if n != "nrfastq" or HOST["reader"]):
        print(f"chip_smoke: the prewarmed libraries are not all there: "
              f"{prebuilt}", file=sys.stderr)
        return 1

    phase_done("1_card_build")
    # the launch floor: one launch that does nothing, in the same timer
    one = torch.zeros(1, device=dev)
    emit({"phase": "launch_floor", "card": card, "what": "one-element fill_",
          "ms": cuda_ms(lambda: one.fill_(0), 200)})

    # ---- phase 2, the 5p10XGEX shapes of the K562 run
    index = PanelIndex.from_fasta(PANEL)
    batch = next(fastq.iter_batches(SAMPLE, 2048, max_len=4096))
    barcodes = whitelist.load(WHITELIST)
    spec = get_spec("5p10XGEX")
    rng = np.random.default_rng(20261016)
    res = {}
    res["chain"], ch = check_chain(dev, index, batch)
    window, wlen = flank_windows(dev, spec, index, batch, ch)
    res["ed"] = check_ed_mode(dev, spec, window, wlen)
    # no wildcard, first optimal end: the 14-mer partial read 1
    ed_first = check_ed_setting(dev, "CGCTCTTCCGATCT", window, wlen, 2,
                                False, False)
    seqs, _ = structured_candidates(rng, barcodes, 256, spec.barcode,
                                    edits=(2, 5))
    # K4 also at the K562 run's own launch: 118 candidate rows
    res["verify"], (v_k562,), res["sw"] = check_verify_sw(
        dev, barcodes, spec.barcode, seqs, (118,))
    rows = [("chain", res["chain"]), ("ed_wildcard_last", res["ed"]),
            ("ed_plain_first", ed_first), ("verify", res["verify"]),
            ("verify_C118_k562", v_k562), ("sw", res["sw"])]
    # the fused step's shapes (phase 3's default path): K1 at each length
    # bucket's anchor slots, on K562 reads of that bucket, and K2+K3 over
    # the B*S = 8192 record slots of a 1024-bucket batch, empty slots
    # included
    k562_all = fastq.read_all(SAMPLE, max_len=4096)
    for Lb in FUSED_BUCKETS:
        codes_b, lens_b = bucket_batch(k562_all, Lb)
        _, _, ch_b = fused_chain(dev, index, codes_b, lens_b)
        rows.append((f"chain_fused_L{Lb}", check_chain_rows(
            ch_b["t"], ch_b["q"], ch_b["seg"], ch_b["valid"], 0)))
    w_s, wl_s = fused_slot_windows(dev, spec, index,
                                   *bucket_batch(k562_all, 1024))
    rows.append(("ed_fused_slots_R8192", check_ed_mode(dev, spec, w_s,
                                                       wl_s)))
    # the device step's shapes (bench.py _setup): K1 at B = 1024, A = 2048
    # on K562 reads, and K4 at batch 0's in-step need_dp rows (forward and
    # reverse) against the 737K list, as one call of the step launches it
    step_b = step_batches()
    _, _, ch_s = fused_chain(dev, index, *step_b[0])
    rows.append(("chain_step_B1024_A2048", check_chain_rows(
        ch_s["t"], ch_s["q"], ch_s["seg"], ch_s["valid"], 0)))
    step_cuda = build_step(dev, barcodes, index, spec)
    for args in recorded_verify_args(lambda: step_cuda(*step_b[0])):
        rows.append((f"verify_step_C{args[0].shape[0]}_737k",
                     check_verify(args)[0]))
    # K4 as the sharded runs of phase 5 launch it: on one whitelist
    # shard's cores at its r_valid (k562: 74 candidate rows against the
    # last of 4 shards of the 737K list, 184,320 cores, all real)
    swl = ShardedWhitelist(barcodes, spec.barcode, 4)
    rows.append(("verify_C74_k562_shard", check_verify(verify_args(
        dev, torch.from_numpy(swl.coreT[3]).to(dev), spec.barcode,
        seqs[:37], int(swl.n_real[3])))[0]))
    k562_shards = (swl, spec.barcode, seqs)     # phase 5's tier counts

    # ---- phase 2, the splice class at the genome stage's shapes (B=512)
    mt_batch = next(fastq.iter_batches(S1026, 512, max_len=4096))
    res["chain_splice"], _ = check_chain(dev, PanelIndex.from_fasta(MT_GENOME),
                                         mt_batch, preset="splice")
    g_index, g_batch = synthetic_gene_reads(np.random.default_rng(20261017))
    r_syn, _ = check_chain(dev, g_index, g_batch, preset="splice")
    rows += [("chain_splice_MT_chr", res["chain_splice"]),
             ("chain_splice_3exon", r_syn)]
    if r_syn["splice_links"] == 0:
        print("chip_smoke: the splice class linked no anchor across an "
              "intron on the 3-exon reads", file=sys.stderr)
        return 1
    # K1 without data dependence: the walk's floor on reads with no valid
    # slot, and the per-step latency on reads valid in every slot
    dense_rng = np.random.default_rng(20261018)
    for cls, max_intron in (("", 0), ("_splice", MAX_INTRON)):
        z = torch.zeros((2048, 4096), dtype=torch.int32, device=dev)
        rows.append((f"chain_all_invalid{cls}", check_chain_rows(
            z, z, z, z.bool(), max_intron)))
        rows.append((f"chain_dense{cls}", check_chain_rows(
            *colinear_anchors(dev, dense_rng, 256, 4096, bool(max_intron)),
            max_intron)))

    # ---- phase 2, the other modes' shapes
    v_index = PanelIndex.from_fasta(V_PANEL)
    c_index = PanelIndex.from_fasta(C_PANEL)
    tcr_batch = next(fastq.iter_batches(TCR3, 2048, max_len=4096))
    ss_batch = next(fastq.iter_batches(SLIDESEQ, 2048, max_len=4096))
    ss_barcodes = whitelist.load(SLIDESEQ_WL)
    r, _ = check_chain(dev, v_index, tcr_batch)
    rows.append(("chain_TR_V_human", r))
    r, _ = check_chain(dev, c_index, ss_batch)
    rows.append(("chain_XR_C_mouse", r))
    w, wl_ = flank_windows(dev, get_spec("5p10XTCR"), v_index, tcr_batch)
    rows.append(("ed_5p10XTCR", check_ed_mode(dev, get_spec("5p10XTCR"),
                                              w, wl_)))
    for mode in ("3p10XTCR", "3pXCR_slideseq", "3p10XGEX", "3p10XTCR_nuc"):
        # slideseq reads stand in for the 3' modes without a bundled
        # sample: their flanks give the scan real windows of its width
        w, wl_ = flank_windows(dev, get_spec(mode), c_index, ss_batch)
        rows.append((f"ed_{mode}", check_ed_mode(dev, get_spec(mode),
                                                 w, wl_)))
    ss_spec = get_spec("3pXCR_slideseq").barcode
    seqs, _ = structured_candidates(rng, ss_barcodes, 256, ss_spec)
    # and at the slideseq run's last launch: 336 candidate rows
    r_v, (r_v336,), r_s = check_verify_sw(dev, ss_barcodes, ss_spec, seqs,
                                          (336,))
    rows += [("verify_m32_slideseq", r_v),
             ("verify_m32_C336_slideseq", r_v336), ("sw_band33", r_s)]
    # and on the second of 2 slideseq shards: 8,877 cores, 8,876 real
    swl = ShardedWhitelist(ss_barcodes, ss_spec, 2)
    rows.append(("verify_m32_slideseq_shard", check_verify(verify_args(
        dev, torch.from_numpy(swl.coreT[1]).to(dev), ss_spec, seqs,
        int(swl.n_real[1])))[0]))
    for mode, bcs in (("5p10XGEX", barcodes), ("3pXCR_slideseq", ss_barcodes),
                      ("3p10XTCR_nuc", barcodes), ("3p10XGEX", barcodes)):
        r = check_sw_full(dev, bcs, get_spec(mode).barcode, rng)
        rows.append((f"sw_full_Lr{r['shape'][2]}", r))
        res.setdefault("sw_full", r)            # the 86-wide 5' row
    rows.append(("sw_full_split_Lr86", check_sw_full_split(dev, rng)))

    failed = []
    for name, r in rows:
        emit({"phase": "kernel", "kernel": name, "card": card,
              "kernel_ms": r["ms"], "bound_ms": r["bound"][0],
              "bound_by": r["bound"][1],
              **{k: v for k, v in r.items() if k not in ("bound", "ms")}})
        if r["mismatches"]:
            failed.append(name)
    if failed:
        print(f"chip_smoke: kernels disagree with their plain versions: "
              f"{failed}", file=sys.stderr)
        return 1
    phase_done("2_kernels")
    if opts.kernels:
        emit({"phase": "phase_seconds", "card": card, **phase_s})
        print(card, flush=True)
        return 0

    # ---- the device step at the bench.py _setup shape, then the entry
    by_run = {}
    why, by_run["device_step"] = device_step_phase(card, step_cuda, step_b,
                                                   barcodes, index, spec)
    phase_done("device_step")
    why = why or entry_phase(card)
    if why:
        print(f"chip_smoke: {why}", file=sys.stderr)
        return 1
    phase_done("entry_dryrun")

    # ---- phases 3 to 6
    with contextlib.ExitStack() as stack:
        tmp = lambda: stack.enter_context(
            tempfile.TemporaryDirectory(prefix="nr_smoke_"))
        with open(GOLDENS) as f:
            goldens = {k: {g: v for g, v in d.items() if g != "mode"}
                       for k, d in json.load(f)["samples"].items()}
        four = ("chain", "ed", "verify", "sw")
        # the genome stage adds the splice instantiation of the chain DP
        five = (*four, "chain_splice")
        runs = [
            # (run, mode, sample, panel, genome, whitelist, golden, kernels)
            ("k562", "5p10XGEX", SAMPLE, PANEL, PANEL, WHITELIST,
             goldens["K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1"], five),
            ("1022", "5p10XGEX", S1022, MT_PANEL, MT_GENOME, WHITELIST,
             goldens["1022_DNMT3A_RUNX1_SF3B1"], five),
            ("1026", "5p10XGEX", S1026, MT_PANEL, MT_GENOME, WHITELIST,
             goldens["1026_mtDNA_ASXL1_NRAS_SF3B1"], five),
            ("car", "5p10XGEX", S_CAR, CAR_PANEL, CAR_PANEL, WHITELIST,
             goldens["97_6_CAR"], five),
            ("tcr3", "5p10XTCR", TCR3, V_PANEL, None, WHITELIST,
             goldens["TCR3"], four),
            ("slideseq", "3pXCR_slideseq", SLIDESEQ, C_PANEL, None,
             SLIDESEQ_WL, goldens["slideseq_XCR"], four),
            # RTX has no adapter scan and no match: the chain DP alone
            ("rtx", "RTX", TCR3, V_PANEL, None, None, {}, ("chain",)),
        ]
        outs = {run[0]: tmp() for run in runs}
        for name, mode, infile, panel, genome, wl, golden, expect in runs:
            # the default (fused) path to the golden, then its unfused twin,
            # every artifact of the two held equal
            by_run[name], why = run_mode(name, mode, infile, panel, genome,
                                         wl, outs[name], card, golden,
                                         expect)
            twin = tmp()
            if not why:
                by_run[name + "_unfused"], why = run_mode(
                    name + "_unfused", mode, infile, panel, genome, wl, twin,
                    card, None, expect, fast=False)
            why = why or twin_check(
                name, outs[name], twin, card,
                ("chain", "ed") if mode != "RTX" else ("chain",))
            if why:
                print(f"chip_smoke: {why}", file=sys.stderr)
                return 1
            if name == "k562":
                phase_done("3_main")
        phase_done("4_modes")

        # the whitelist screens on the K562 run's candidates, card = CPU
        why = screens_phase(card, dev, barcodes, spec.barcode, outs["k562"],
                            "t")
        if why:
            print(f"chip_smoke: {why}", file=sys.stderr)
            return 1
        phase_done("screens")

        # phase 5: the sharded runs, held to the unsharded outdirs
        sharded_runs = [
            # (run, unsharded run, (wl_shards, data_shards), least launches,
            #  rows a tier chunk: None keeps the default)
            ("k562_sharded", "k562", (4, 2), {"verify": 4, "sw": 1}, None),
            ("slideseq_sharded", "slideseq", (2, 1),
             {"verify": 2 * by_run["slideseq"]["verify"]}, None),
            # the tier pass over each data block in one chunk: how much of
            # the match is the host's issue of the chunk loop
            ("k562_sharded_whole_block", "k562", (4, 2),
             {"verify": 4, "sw": 1}, 1 << 20),
        ]
        default_chunk = sharded.TIER_CHUNK
        for name, base, shards, least, chunk in sharded_runs:
            spec_row = next(r for r in runs if r[0] == base)
            out = tmp()
            sharded.TIER_CHUNK = chunk or default_chunk
            try:
                by_run[name], why = run_mode(name, *spec_row[1:6], out,
                                             card, spec_row[6], spec_row[7],
                                             shards)
            finally:
                sharded.TIER_CHUNK = default_chunk
            if why:
                print(f"chip_smoke: {why}", file=sys.stderr)
                return 1
            got, want = artifact_digests(out), artifact_digests(outs[base])
            differ = sorted(k for k in set(got) | set(want)
                            if got.get(k) != want.get(k))
            short = {k: (by_run[name][k], v) for k, v in least.items()
                     if by_run[name][k] < v}
            emit({"phase": "sharded_check", "run": name, "card": card,
                  "artifacts": len(want), "differ": differ,
                  "launches_below_least": short})
            if differ or short:
                print(f"chip_smoke: sharded run {name} differs from {base} "
                      f"in {differ} or launched too few kernels {short}",
                      file=sys.stderr)
                return 1

        emit({"phase": "tier_calls", "card": card,
              "aten_calls_by_rows": tier_call_counts(dev, *k562_shards)})
        phase_done("5_sharded")

        # the bench.py _cli_bench shape: K562 tiled to 20,000 reads, the
        # RUNX1 panel, the full 737K list, no genome, batch 2048; the
        # fused and the unfused path in turns (fused, unfused, unfused,
        # fused), each pair's artifacts held equal
        tiled = os.path.join(tmp(), "k562_x5.fastq.gz")
        n_bench = tile_fastq(SAMPLE, 20_000, tiled)
        bench = []
        for k, fast in enumerate((None, False, False, None)):
            nm = f"cli_bench_{'fused' if fast is None else 'unfused'}_{k}"
            out = tmp()
            by_run[nm], why = run_mode(nm, "5p10XGEX", tiled, PANEL,
                                       "/nonexistent", WHITELIST, out, card,
                                       None, (), fast=fast)
            bench.append((nm, out))
            if why:
                print(f"chip_smoke: {why}", file=sys.stderr)
                return 1
        for (a, oa), (b, ob) in ((bench[0], bench[1]), (bench[3], bench[2])):
            RUN_LINES[a + "_unfused"] = RUN_LINES[b]
            why = twin_check(a, oa, ob, card, ("chain", "ed"))
            if why:
                print(f"chip_smoke: {why}", file=sys.stderr)
                return 1
        emit({"phase": "cli_bench", "card": card, "reads": n_bench,
              "batch_size": 2048, "runs": [
                  {k: RUN_LINES[nm][k] for k in (
                      "run", "path", "wall_s", "reads_per_s",
                      "deferred_reads", "phase_s")}
                  for nm, _ in bench]})
        emit({"phase": "cli_bench_device_time", "card": card,
              **device_time(tiled, tmp())})
        # the same shape fused once more with the Python parser forced:
        # its artifacts equal the first fused run's (the native reader's)
        nm, out = "cli_bench_parser", tmp()
        by_run[nm], why = run_mode(nm, "5p10XGEX", tiled, PANEL,
                                   "/nonexistent", WHITELIST, out, card,
                                   None, ("chain", "ed"), parser=True)
        if why:
            print(f"chip_smoke: {why}", file=sys.stderr)
            return 1
        got, first = artifact_digests(out), artifact_digests(bench[0][1])
        differ = sorted(k for k in set(got) | set(first)
                        if got.get(k) != first.get(k))
        emit({"phase": "cli_bench_reader", "card": card, "reads": n_bench,
              "runs": [{"run": r, "path": RUN_LINES[r]["path"],
                        "reader": RUN_LINES[r]["reader"],
                        "wall_s": RUN_LINES[r]["wall_s"],
                        "read_s": (RUN_LINES[r]["phase_s"] or {}).get(
                            "read")}
                       for r in (bench[0][0], bench[3][0], nm)],
              "differ": differ})
        if differ or RUN_LINES[nm]["path"] != "fused":
            print(f"chip_smoke: the parser's cli_bench run differs from "
                  f"the native reader's in {differ}", file=sys.stderr)
            return 1
        phase_done("cli_bench")

        # the scale regime: the 1M-row product list, the transcriptome and
        # the reads cut (SCALE_CUT); K4 at the run's first launch joins
        # phase 2's rows
        why, by_run["scale"], k4 = scale_phase(card, tmp(), tmp(), tmp(),
                                               tmp())
        if k4 is not None:
            name = f"verify_scale_C{k4['shape'][0]}_1m"
            emit({"phase": "kernel", "kernel": name, "card": card,
                  "kernel_ms": k4["ms"], "bound_ms": k4["bound"][0],
                  "bound_by": k4["bound"][1],
                  **{k: v for k, v in k4.items() if k not in ("bound",
                                                              "ms")}})
            if k4["mismatches"]:
                why = why or (f"kernel {name} disagrees with its plain "
                              f"version")
        if why:
            print(f"chip_smoke: {why}", file=sys.stderr)
            return 1
        phase_done("scale")

        kernels.reset_launches()
        for name, mode in (("tcr3", "5p10XTCR"),
                           ("slideseq", "3pXCR_slideseq")):
            r = rescan_real_pairs(outs[name], "t", get_spec(mode), "cuda")
            emit({"phase": "rescan", "run": name, "card": card, **r})
            if rescan_failed(r):
                print(f"chip_smoke: the full-row rescorer disagrees with "
                      f"the banded one or the table on run {name}: {r}",
                      file=sys.stderr)
                return 1
        torch.cuda.synchronize()
        by_run["rescan"] = dict(kernels.launches)
    if by_run["rescan"]["sw_full"] <= 0:
        print("chip_smoke: the rescan never launched sw_full",
              file=sys.stderr)
        return 1
    phase_done("6_rescan")
    emit({"phase": "phase_seconds", "card": card, **phase_s})

    summary = []
    for name, (src, replaces) in KERNELS.items():
        r = res[name]
        b_ms, b_by = r["bound"]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(v[name] for v in by_run.values()),
            "launches_by_run": {k: v[name] for k, v in by_run.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": r["shape"]})
    emit({"kernels": summary})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
