"""Pipeline CLI of the PyTorch/CUDA port: all seven modes, streamed.

Counterpart of the JAX package's pipeline.py, flag-compatible with it
(and with the reference pipeline.py) plus --device. Every mode runs fastq
-> minimizer sketch -> anchor lookup and sort -> chain DP -> record
extraction -> end extension -> adapter scan (whole flank or sliding
sub-windows) -> subread and BC-UMI slices, by default fused into one step
a length-bucketed batch (stages/cli_step.py; NANORANGER_NO_FAST=1 or
fast=False runs the unfused path, batch by batch); the
barcoded modes go on to the staged whitelist match (exact tiers where the
whitelist has them, one-vs-all DP, banded UMI rescore) and their
mode-specific tables; the clone modes run the native clonotyper over the
subreads; 5p10XGEX with a genome that exists goes on to the genome stage
(splice-preset alignment of the subreads, exon CIGARs, the CB/UB/XT-tagged
BAM with its index). wl_shards/data_shards > 1 run the match over a
(data x wl) mesh of devices (parallel/sharded.py) and stream read batches
round-robin over the data cells; their artifacts equal the unsharded run's.
The artifacts are byte-identical to the JAX package's (after gunzip, the
BAM after BGZF decompression; pdfs and run statistics aside):

  {sample}_deconcat.fastq.gz / _VDJ.fastq.gz     subreads
  {sample}_BCUMI.fasta.gz                        barcode candidates
  {sample}_eds.csv / _eds_names.csv.gz / _polyA.fasta.gz
  {sample}_assignments.csv.gz                    per-candidate match (+ .meta.json)
  {sample}_barcode_scores.csv/.pdf, _knee*.pdf
  {sample}_bcumi_dedup.csv
  {sample}_bc_read_count.csv, _bc_count.json, _quads.json.gz, _gex.mtx.gz (+sidecars)
  {sample}_genome_tagged.bam (+ .bai), _trns_ct.csv
  {sample}_clones.txt.gz, _cloneID.txt.gz, _clones_filtered.csv,
  {sample}_cloneID_filtered.csv.gz, _clone_bcumi.csv.gz

MiXCR stays an external boundary tool: when its exports
(_clones.txt.gz/_cloneID.txt.gz) are present in the outdir the clone joins
use them; otherwise the native clonotyper (vdj/) writes compatible ones.

Entry points run on CUDA unless the caller passes device="cpu"
(`--device cpu`); without a card the default raises.

    python -m nanoranger_torch.pipeline --mode 5p10XGEX \\
        --infile data/samples/K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1.fastq.gz \\
        --outdir out --expname k562 \\
        --trns_ref data/RUNX1_RUNX1T1_ABL1_BCR.fa \\
        --genome_ref data/RUNX1_RUNX1T1_ABL1_BCR.fa \\
        --barcodes data/737K-august-2016.txt.gz
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import heapq
import itertools
import json
import os
import pickle
import re
import tempfile
import time
from collections import deque

import numpy as np
import pandas as pd
import torch

from . import chemistry
from .align.aligner import PanelAligner, extract_records
from .align.index import PanelIndex
from .io import fastq, whitelist
from .io.bam import BAMWriter
from .io.candidate_store import CandidateStore
from .io.encode import COMPLEMENT, PAD, decode, encode_batch
from .io.fasta import FastaWriter, iter_fasta
from .ops.extend import extend_records_host
from .parallel.sharded import ShardedMatcher, mesh_devices
from .runtime.native_lib import banded_align_batch
from .stages import clones as clone_stage
from .stages import counting
from .stages.barcode import (ACCEPT, BAD_UMI, DP_PENDING, LOW_AS,
                             BarcodeMatcher)
from .stages.cli_step import assemble_batch, build_cli_step
from .stages.decon import run_decon

DATA_DIR = os.environ.get(
    "NANORANGER_DATA",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "data"))

# (trns_ref, genome_ref, barcodes) defaults — reference pipeline.py
MODE_DEFAULTS = {
    "5p10XGEX": ("panel_MT_trns.fa", "MT_chr.fa", "737K-august-2016.txt.gz"),
    "5p10XTCR": ("TR_V_human.fa", None, "737K-august-2016.txt.gz"),
    "RTX": ("TR_V_human.fa", None, None),
    "3pXCR_slideseq": ("XR_C_mouse.fa", None, "slideseq.matched.barcodes.tsv.gz"),
    "3p10XTCR": ("TRab_C_mouse.fa", None, "slideseq.matched.barcodes.tsv.gz"),
    "3p10XTCR_nuc": ("TR_V_human.fa", None, "3M-february-2018.txt.gz"),
    "3p10XGEX": ("panel_MT_trns.fa", None, "3M-february-2018.txt.gz"),
}

MATCH_LQ = 96      # candidate width of the barcode match


def _matcher_in_step(dev: torch.device) -> bool:
    """Whether the fused step runs the exact-class whitelist pass: on CUDA.
    On the CPU the matcher stays out of the step, as in the JAX package, and
    match_barcodes matches every candidate after the stream."""
    return dev.type == "cuda"


def _inflight() -> int:
    """Fused-path queue depth: batches dispatched beyond the one being
    drained (see dispatch() in DeconRun._run_fast)."""
    return int(os.environ.get("NANORANGER_INFLIGHT", "3"))


def log(msg: str):
    print(f"[nanoranger-torch] {msg}", flush=True)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} is not available: no CUDA device is "
            "visible. Pass device='cpu' (--device cpu) to run on the CPU.")
    return dev


class Telemetry:
    """Per-stage run telemetry, written atomically as
    {sample}_runstats.json at pipeline exit."""

    def __init__(self, mode: str, infile: str, device: torch.device):
        self.t0 = time.time()
        self.doc = {"mode": mode, "infile": infile, "device": str(device),
                    "stages": []}
        if device.type == "cuda":
            self.doc["device_name"] = torch.cuda.get_device_name(device)

    def stage(self, name: str, seconds: float, reads: int | None = None,
              **extra):
        row = {"stage": name, "seconds": round(seconds, 3)}
        if reads is not None and reads >= 0:
            row["reads"] = int(reads)
            if seconds > 0:
                row["reads_per_s"] = round(reads / seconds, 1)
        row.update({k: v for k, v in extra.items()
                    if v is not None and not (isinstance(v, int) and v < 0)})
        self.doc["stages"].append(row)

    def write(self, outdir: str, sample: str):
        self.doc["total_seconds"] = round(time.time() - self.t0, 3)
        path = f"{outdir}/{sample}_runstats.json"
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.doc, f, indent=1)
        os.replace(tmp, path)


class DeconRun:
    """Streamed align+decon over an input fastq, accumulating BC-UMI
    candidates and the per-mode statistics and writing the subread/BCUMI
    artifacts in input order.

    The default with data_shards <= 1 is the FUSED path
    (stages/cli_step.py, `_run_fast`): one call per length-bucketed batch
    covering seed -> chain DP -> record extraction -> extension -> flank
    scan -> BC-UMI slice -> the exact-class whitelist pass, whose artifacts
    are byte-identical to the unfused path's (reads with more kept chains
    than the step's slots are rerun through it). NANORANGER_NO_FAST=1 or
    fast=False takes the unfused path: batch by batch, records on the host
    between the device passes.

    data_shards > 1 runs the unfused path over the data cells of a mesh:
    batch i chains on cell i % data_shards (its flank scan runs where its
    codes are) while earlier batches are assembled, up to data_shards in
    flight, drained strictly in input order, so the artifacts are
    byte-identical to one shard.

    Resume: when the stage artifacts already exist (and force=False), the
    BC-UMI candidates are reloaded from _BCUMI.fasta.gz instead of
    recomputing (writers use tmp+rename, so an existing file is
    complete)."""

    def __init__(self, spec, infile, outdir, sample, trns_ref, device,
                 batch_size=2048, max_len=4096, force=False, data_shards=1,
                 matcher=None, fast=None):
        self.spec = spec
        self.prematch = None
        self.n_deferred = 0
        # the fused path's index: its tensors' bytes and the seconds to
        # build them (the unfused path leaves both None)
        self.index_bytes = None
        self.index_s = None
        t0 = time.time()
        sub_kind = "VDJ" if spec.name in (
            "3pXCR_slideseq", "3p10XTCR", "3p10XTCR_nuc") else "deconcat"
        self.sub_path = f"{outdir}/{sample}_{sub_kind}.fastq.gz"
        self.bcumi_path = f"{outdir}/{sample}_BCUMI.fasta.gz"
        # spill-backed candidate store: bounded resident memory however
        # many reads stream through
        self.cands = CandidateStore()
        self.eds_rows: list = []
        self.raw_counts: dict = {}
        self.polyA: list = []
        self.resumed = False
        # resume requires the stats artifacts too: a crash between the
        # decon writers closing and write_eds() would otherwise leave the
        # eds/polyA stats missing for good without --force
        need = [self.sub_path, self.bcumi_path] + \
            self.eds_artifacts(outdir, sample)
        rc_path = f"{outdir}/{sample}_bc_read_count.csv"
        if spec.name == "3p10XGEX":
            need.append(rc_path)
        if not force and all(os.path.isfile(p) for p in need):
            for nm, sq in iter_fasta(self.bcumi_path):
                self.cands.append(nm, sq)
            if spec.name == "3p10XGEX":
                rc = pd.read_csv(rc_path, index_col=0)
                self.raw_counts = dict(zip(rc.index, rc.iloc[:, 0]))
            self.resumed = True
            self.n_reads = self.n_sub = -1
            log(f"resume: decon artifacts present, loaded "
                f"{len(self.cands)} BC-UMI candidates "
                f"({time.time() - t0:.1f}s)")
            return

        t_index = time.time()
        self.index = PanelIndex.from_fasta(trns_ref)
        if fast is None:
            fast = (data_shards <= 1 and
                    os.environ.get("NANORANGER_NO_FAST", "") != "1")
        if fast:
            self._run_fast(spec, infile, sample, torch.device(device),
                           batch_size, max_len, matcher, t0, t_index)
            return
        # batch i chains on data cell i % data_shards, the cells laid over
        # the devices round-robin
        aligner = PanelAligner(
            self.index, device,
            devices=mesh_devices(device) if data_shards > 1 else None)
        n_reads = n_sub = 0
        pending: deque = deque()
        with fastq.FastqWriter(self.sub_path) as fsub, \
                FastaWriter(self.bcumi_path) as fbc:

            def drain():
                nonlocal n_reads, n_sub
                batch, ch = pending.popleft()
                dev = ch["dev_codes"].device
                rec = extract_records(ch, self.index)
                # base-level DP extension of chain ends: qstart/qend match
                # minimap2's extended spans, not terminal anchors
                extend_records_host(rec, self.index, batch.codes,
                                    np.asarray(batch.lengths), dev)
                out = run_decon(spec, batch.codes, np.asarray(batch.lengths),
                                batch.names, batch.quals, rec,
                                self.index.names, sample, device=dev,
                                dev_codes=ch["dev_codes"])
                for nm, sq, ql in zip(out.sub_names, out.sub_seqs,
                                      out.sub_quals):
                    fsub.write(nm, sq, ql)
                for nm, sq in zip(out.bcumi_names, out.bcumi_seqs):
                    fbc.write(nm, sq)
                    self.cands.append(nm, sq)
                self.eds_rows.extend(out.eds_rows)
                self.polyA.extend(out.polyA)
                for k, v in out.raw_bc_counts.items():
                    self.raw_counts[k] = self.raw_counts.get(k, 0) + v
                n_reads += len(batch)
                n_sub += len(out.sub_names)

            for i, batch in enumerate(fastq.iter_batches(
                    infile, batch_size, max_len=max_len)):
                # queue the batch's device work before draining older
                # batches, so up to data_shards cells chain at once
                pending.append((batch, aligner._chain(
                    batch.codes, batch.lengths, shard=i % data_shards)))
                if len(pending) > data_shards:
                    drain()
            while pending:
                drain()
        self.n_reads = n_reads
        self.n_sub = n_sub
        log(f"align+decon: {n_reads} reads → {n_sub} subreads, "
            f"{len(self.cands)} BC-UMI candidates "
            f"({time.time() - t0:.1f}s)")

    def _run_fast(self, spec, infile, sample, dev, batch_size, max_len,
                  matcher, t0, t_index):
        """Fused path: one step call per batch (stages/cli_step.py) on
        `dev`; the host assembles the artifacts from the downloaded slot
        arrays.

        Reads dispatch in length buckets Lb in {1024, 2048, max_len}, each
        batch up to batch_size reads of width Lb: ONT reads are mostly
        short, and the chain's anchor slots grow with the width. Each read
        carries its input ordinal and an order-restoring writer emits the
        artifacts strictly in input order, so bucketing changes nothing in
        the artifact byte streams. A batch goes to the step with its filled
        rows only: eager kernels take any row count, where the JAX step
        pads every batch to one compiled shape.

        Up to 1 + NANORANGER_INFLIGHT (default 3) batches are in flight:
        the card computes ahead while the host downloads and assembles.
        Reads the step defers (more kept chains than its slots, or an
        anchor overflow) are rerun through the unfused path in windows of
        at most FLUSH_BATCHES batches and DEFER_CAP reads, padded to
        max_len, and interleaved back in read order.

        On the CPU the matcher stays out of the step, as in the JAX
        package: match_barcodes then matches every candidate. On CUDA the
        step runs the exact-class pass and self.prematch carries its
        verdicts; rows it leaves DP_PENDING, and the candidates of deferred
        reads, are matched after the stream.

        The JAX package loads its compiled step per bucket ahead of time
        on a thread (NANORANGER_AOT), and on an accelerator runs the
        unfused fallback once on the first batch so that the fallback's
        compiles land before the steady-state marker. The port has neither:
        the kernels build at first use (kernels.py), eager torch compiles
        nothing, and the fallback runs the step's own kernels and torch
        ops, and its aligner takes the step's index tensors (a second copy
        of a whole-transcriptome index would cost seconds and gigabytes).
        The marker (steady_reads_per_s) re-arms whenever a bucket
        dispatches for the first time."""
        cli_matcher = matcher if _matcher_in_step(dev) else None
        step, tables = build_cli_step(spec, self.index, matcher=cli_matcher,
                                      device=dev)
        index_arrays = tuple(tables[k] for k in
                             ("prefix_start", "prefix_count", "windows"))
        self.index_bytes = sum(t.nbytes for t in index_arrays)
        self.index_s = time.time() - t_index
        self._fallback_aligner = None
        self._index_arrays = index_arrays
        self._dev = dev
        BUCKETS = sorted({max(256, min(1024, max_len)),
                          max(256, min(2048, max_len)), max(256, max_len)})
        BUCKETS_ARR = np.asarray(BUCKETS)
        do_match = cli_matcher is not None and spec.barcode is not None
        umi_len = spec.barcode.umi_len if do_match else 0
        # per-phase wall: read = fastq stream + encode, step = the step
        # calls (the host issues the card's work; eager torch waits only
        # at the extension's re-round test) and the wait at download,
        # assemble = host artifact assembly, slow = unfused reruns of
        # deferred reads
        ph = self.phase_s = {"read": 0.0, "step": 0.0, "assemble": 0.0,
                             "slow": 0.0}
        mbc, mscore, mstatus, mumi = [], [], [], []
        n_reads = n_sub = 0
        fsub = fastq.FastqWriter(self.sub_path)
        fbc = FastaWriter(self.bcumi_path)
        pending: deque = deque()
        # batches whose reads all fit the slots are written at once;
        # batches with deferred reads buffer until one windowed unfused
        # run covers them (bounded by FLUSH_BATCHES / DEFER_CAP)
        FLUSH_BATCHES, DEFER_CAP = 16, 448
        buffer: list = []
        buf_defers = 0

        # order-restoring emission: chunks[seq] holds one read's assembled
        # artifacts until the write cursor reaches it
        chunks: dict = {}
        cursor = 0

        def advance():
            nonlocal cursor, n_sub
            while cursor in chunks:
                asm, lo, hi = chunks.pop(cursor)
                for j in range(lo[0], hi[0]):
                    fsub.write(asm.sub_names[j], asm.sub_seqs[j],
                               asm.sub_quals[j])
                for j in range(lo[1], hi[1]):
                    fbc.write(asm.bcumi_names[j], asm.bcumi_seqs[j])
                    self.cands.append(asm.bcumi_names[j], asm.bcumi_seqs[j])
                    if do_match:
                        mbc.append(asm.match_bc[j])
                        mscore.append(asm.match_score[j])
                        mstatus.append(asm.match_status[j])
                        mumi.append(asm.match_umi[j])
                self.eds_rows.extend(asm.eds_rows[lo[2]:hi[2]])
                self.polyA.extend(asm.polyA[lo[3]:hi[3]])
                for key in asm.raw_keys[lo[4]:hi[4]]:
                    self.raw_counts[key] = self.raw_counts.get(key, 0) + 1
                n_sub += hi[0] - lo[0]
                cursor += 1

        def emit(asm, seqs):
            self.n_deferred += asm.n_deferred_reads
            prev = (0, 0, 0, 0, 0)
            for k, b in enumerate(asm.read_bounds):
                s = int(seqs[k])
                if s >= 0:
                    chunks[s] = (asm, prev, b)
                prev = b
            advance()

        def flush():
            nonlocal buf_defers
            if not buffer:
                return
            rows = []                       # (buffer slot, local read idx)
            for bi, (batch, _seqs, _n, out) in enumerate(buffer):
                for i in np.where(out["defer"])[0]:
                    rows.append((bi, int(i)))
            groups_all: dict = {}
            if rows:
                n = len(rows)
                # max_len width: deferred rows come from every bucket
                cr = np.full((n, max_len), PAD, np.int8)
                lr = np.zeros(n, np.int32)
                nr, qr = [], []
                for k, (bi, i) in enumerate(rows):
                    b = buffer[bi][0]
                    w = b.codes.shape[1]
                    cr[k, :w] = b.codes[i]
                    lr[k] = b.lengths[i]
                    nr.append(b.names[i])
                    qr.append(b.quals[i])
                tslow = time.time()
                g: dict = {}
                for base in range(0, n, DEFER_CAP):
                    e = min(base + DEFER_CAP, n)
                    gi = self._slow_groups(spec, sample, cr[base:e],
                                           lr[base:e], nr[base:e],
                                           qr[base:e])
                    for k, v in gi.items():
                        g[base + k] = v
                ph["slow"] += time.time() - tslow
                for k, (bi, i) in enumerate(rows):
                    groups_all[(bi, i)] = g.get(k, {})
            tasm = time.time()
            for bi, (batch, seqs, _n, out) in enumerate(buffer):
                asm = assemble_batch(
                    spec, out, batch.codes, batch.lengths, batch.names,
                    batch.quals, self.index.names, sample,
                    slow_fallback=lambda didx, bi=bi: {
                        int(i): groups_all.get((bi, int(i)), {})
                        for i in didx})
                emit(asm, seqs)
            ph["assemble"] += time.time() - tasm
            buffer.clear()
            buf_defers = 0

        self._t_steady0 = None
        self._reads_at_steady0 = 0
        self._steady_rearm = False

        def drain():
            nonlocal n_reads, buf_defers
            batch, seqs, n_real, out_dev = pending.popleft()
            tget = time.time()
            out = {k: v.cpu().numpy() for k, v in out_dev.items()}
            ph["step"] += time.time() - tget
            n_reads += n_real
            nd = int(out["defer"].sum())
            buffer.append((batch, seqs, n_real, out))
            buf_defers += nd
            if buf_defers == 0 or len(buffer) >= FLUSH_BATCHES or \
                    buf_defers >= DEFER_CAP:
                flush()
            if self._t_steady0 is None or self._steady_rearm:
                # (re)arm the steady marker: the one-time costs of every
                # bucket dispatched so far have now been paid
                self._t_steady0 = time.time()
                self._reads_at_steady0 = n_reads
                self._steady_rearm = False

        def _new_acc(Lb):
            return {"codes": np.full((batch_size, Lb), PAD, np.int8),
                    "lengths": np.zeros(batch_size, np.int32),
                    "names": [""] * batch_size,
                    "quals": [b""] * batch_size,
                    "seq": np.full(batch_size, -1, np.int64), "n": 0}

        acc = {Lb: _new_acc(Lb) for Lb in BUCKETS}
        buckets_seen: set = set()

        def dispatch(Lb):
            a = acc[Lb]
            n = a["n"]
            if n == 0:
                return
            if Lb not in buckets_seen:
                buckets_seen.add(Lb)
                self._steady_rearm = True   # a new bucket's first batch
            tstep = time.time()
            out_dev = step(a["codes"][:n], a["lengths"][:n], tables)
            ph["step"] += time.time() - tstep
            pending.append((fastq.ReadBatch(a["codes"][:n], a["lengths"][:n],
                                            a["names"][:n], a["quals"][:n]),
                            a["seq"][:n], n, out_dev))
            acc[Lb] = _new_acc(Lb)
            if len(pending) > _inflight():
                drain()

        it = fastq.iter_batches(infile, batch_size, max_len=max_len)
        in_batches = next_seq = 0
        while True:
            tread = time.time()
            batch = next(it, None)
            ph["read"] += time.time() - tread
            if batch is None:
                break
            w = batch.codes.shape[1]
            bl = np.minimum(np.asarray(batch.lengths), max_len)
            # vectorized bucket routing: one sliced copy per (bucket,
            # contiguous run)
            bidx = np.searchsorted(BUCKETS_ARR, bl)
            for b, Lb in enumerate(BUCKETS):
                rows = np.nonzero(bidx == b)[0]
                r0 = 0
                while r0 < len(rows):
                    a = acc[Lb]
                    k = a["n"]
                    take = min(batch_size - k, len(rows) - r0)
                    sel = rows[r0:r0 + take]
                    w2 = min(w, Lb)
                    a["codes"][k:k + take, :w2] = batch.codes[sel, :w2]
                    a["lengths"][k:k + take] = bl[sel]
                    for j, i in enumerate(sel):
                        a["names"][k + j] = batch.names[i]
                        a["quals"][k + j] = batch.quals[i]
                    a["seq"][k:k + take] = next_seq + sel
                    a["n"] = k + take
                    r0 += take
                    if a["n"] == batch_size:
                        dispatch(Lb)
            next_seq += len(batch)
            in_batches += 1
            if in_batches % FLUSH_BATCHES == 0:
                # anti-starvation: a rare bucket would otherwise hold the
                # write cursor (and the reorder buffer) until it fills
                for Lb in BUCKETS:
                    dispatch(Lb)
        for Lb in BUCKETS:
            dispatch(Lb)
        while pending:
            drain()
        flush()
        advance()
        if chunks:       # every dispatched read must have been emitted
            raise RuntimeError(
                f"order-restoring writer stalled at read {cursor} with "
                f"{len(chunks)} assembled reads pending")
        fsub.close()
        fbc.close()
        if do_match:
            n = len(mbc)
            umi = np.full((n, umi_len), PAD, np.int8)
            pend = np.zeros(n, bool)
            for i, u in enumerate(mumi):
                if u is None:
                    pend[i] = True              # deferred read: match later
                else:
                    umi[i] = u
            status_arr = np.asarray(mstatus, np.int32)
            # rows the step's exact-class pass left to the full match
            pend |= status_arr == DP_PENDING
            self.prematch = {
                "bc_idx": np.asarray(mbc, np.int32),
                "score": np.asarray(mscore, np.int32),
                "status": status_arr,
                "umi": umi, "pending": pend}
        self.n_reads = n_reads
        self.n_sub = n_sub
        self.steady_reads_per_s = None
        if self._t_steady0 and n_reads > self._reads_at_steady0:
            dt = time.time() - self._t_steady0
            if dt > 0:
                self.steady_reads_per_s = round(
                    (n_reads - self._reads_at_steady0) / dt, 1)
        log(f"align+decon (fused): {n_reads} reads → {n_sub} subreads, "
            f"{len(self.cands)} BC-UMI candidates"
            + (f", {self.n_deferred} reads via the unfused path"
               if self.n_deferred else "")
            + f" ({time.time() - t0:.1f}s)")

    def _slow_groups(self, spec, sample, codes, lengths, names, quals):
        """Unfused recompute of deferred reads (more kept chains than the
        fused step's slots), regrouped per input row for the in-order
        interleave of assemble_batch."""
        if self._fallback_aligner is None:
            self._fallback_aligner = PanelAligner(
                self.index, self._dev, index_arrays=self._index_arrays)
        sl = np.asarray(lengths, np.int32)
        ch = self._fallback_aligner._chain(codes, sl)
        rec = extract_records(ch, self.index)
        extend_records_host(rec, self.index, codes, sl, self._dev)
        out = run_decon(spec, codes, sl, list(names), list(quals), rec,
                        self.index.names, sample, device=self._dev,
                        dev_codes=ch["dev_codes"])
        groups: dict = {}

        def grp(gi):
            return groups.setdefault(int(gi), {"sub": [], "bc": [],
                                               "eds": [], "polyA": [],
                                               "raw": []})

        rd = rec.read_idx
        for k, ri in enumerate(out.sub_rec):
            grp(rd[ri])["sub"].append(
                (out.sub_names[k], out.sub_seqs[k], out.sub_quals[k]))
        for k, ri in enumerate(out.bcumi_rec):
            g = grp(rd[ri])
            g["bc"].append((out.bcumi_names[k], out.bcumi_seqs[k]))
            if spec.bcumi_rule == "rev_slideseq":
                g["polyA"].append(out.polyA[k])
        if out.eds_rec is not None:
            for k, ri in enumerate(out.eds_rec):
                grp(rd[ri])["eds"].append(out.eds_rows[k])
        for (ri, key) in (out.raw_rows or []):
            grp(rd[ri])["raw"].append(key)
        return groups

    def eds_artifacts(self, outdir, sample) -> list:
        """Mode-specific stats artifacts write_eds produces (resume set)."""
        n = self.spec.name
        if n in ("5p10XTCR", "3p10XTCR"):
            return [f"{outdir}/{sample}_eds.csv"]
        if n == "3pXCR_slideseq":
            return [f"{outdir}/{sample}_eds_names.csv.gz",
                    f"{outdir}/{sample}_polyA.fasta.gz"]
        return []

    def write_eds(self, outdir, sample):
        if self.resumed:
            return   # stats artifacts were written by the original run
        if self.spec.name == "5p10XTCR":
            _atomic_to_csv(pd.DataFrame(np.array(self.eds_rows, dtype=object)),
                           f"{outdir}/{sample}_eds.csv")
        elif self.spec.name == "3p10XTCR":
            v, c = np.unique(np.asarray(self.eds_rows), return_counts=True)
            df = pd.DataFrame({0: v, 1: c}).sort_values(1, ascending=False)
            _atomic_to_csv(df, f"{outdir}/{sample}_eds.csv")
        elif self.spec.name == "3pXCR_slideseq":
            # per-hit edit distances for ALL pre-filter adapter hits,
            # names with the fasta '>' prefix (utils.py:459-461; the
            # reference pigzes the csv, so the artifact is .csv.gz)
            _atomic_to_csv(pd.DataFrame(
                {0: [n for n, _ in self.eds_rows],
                 1: [d for _, d in self.eds_rows]}),
                f"{outdir}/{sample}_eds_names.csv.gz", index=None)
            with FastaWriter(f"{outdir}/{sample}_polyA.fasta.gz") as f:
                for n, s in self.polyA:
                    f.write(n, s)


def _atomic_to_csv(df, path, **kw):
    tmp = path + ".tmp"
    # infer compression from the FINAL name (pandas would see only .tmp)
    kw.setdefault("compression", "gzip" if path.endswith(".gz") else None)
    df.to_csv(tmp, **kw)
    os.replace(tmp, path)


def _match_fingerprint(spec, bcs_array, cands):
    """Identity of a barcode-match run: candidate set + whitelist +
    chemistry. A checkpoint from a different input/whitelist/mode must not
    be resumed."""
    h = hashlib.sha1()
    for n in cands.head(128) + cands.tail(128):
        h.update(n.encode())
    return {"spec": spec.name, "n_candidates": len(cands),
            "n_whitelist": int(len(bcs_array)),
            "names_sha1": h.hexdigest()}


def _matcher(bcs_array, spec, device, wl_shards=1, data_shards=1):
    """The whitelist matcher: over a (data x wl) mesh of the devices
    `device` names when sharded, else on `device` alone."""
    if wl_shards > 1 or data_shards > 1:
        return ShardedMatcher(bcs_array, spec.barcode, wl_shards,
                              data_shards, mesh_devices(device))
    return BarcodeMatcher(bcs_array, spec.barcode, device)


def _write_score_hist(res, outdir, sample):
    """{sample}_barcode_scores.csv/.pdf: the score histogram over reads
    that would appear with flag==0 in the STAR SAM."""
    status = res["status"]
    vis = (status == ACCEPT) | (status == LOW_AS) | (status == BAD_UMI)
    scores_df = counting.barcode_scores_table(res["score"][vis])
    scores_df.columns = ["score", "count"]
    scores_df.to_csv(f"{outdir}/{sample}_barcode_scores.csv", index=None)
    counting.save_score_plot(f"{outdir}/{sample}_barcode_scores.pdf",
                             scores_df, 8)


def match_barcodes(spec, bcs_array, cands, outdir, sample, device,
                   batch=4096, force=False, matcher=None, wl_shards=1,
                   data_shards=1, prematched=None):
    """Whitelist match of accumulated candidates -> per-read assignment df
    + score histogram artifacts. The full assignment table persists as
    {sample}_assignments.csv.gz and is reloaded on resume when the run
    fingerprint (input candidates + whitelist + chemistry) matches; a
    resumed outdir without the score histogram (a shard-merged one,
    tools/merge_shards.py) gets it rebuilt from the loaded table.

    wl_shards/data_shards > 1 match over a (data x wl) mesh
    (parallel/sharded.ShardedMatcher) unless `matcher` is given.

    prematched: the per-candidate verdicts of the fused step's exact-class
    pass (DeconRun.prematch); only the rows with pending=True (DP_PENDING
    rows and the candidates of deferred reads) are matched here, the others
    are taken as they are. The artifacts are the same either way.

    cands: a CandidateStore (consumed by sequential streaming)."""
    if not isinstance(cands, CandidateStore):
        raise TypeError("match_barcodes takes a CandidateStore "
                        "(CandidateStore.from_lists(names, seqs))")
    apath = f"{outdir}/{sample}_assignments.csv.gz"
    mpath = apath + ".meta.json"
    fp = _match_fingerprint(spec, bcs_array, cands)
    if not force and os.path.isfile(apath):
        meta = None
        if os.path.isfile(mpath):
            with open(mpath) as f:
                meta = json.load(f)
        if meta != fp:
            log("resume: assignments checkpoint fingerprint mismatch "
                "(different input/whitelist/chemistry) — recomputing")
        else:
            df = pd.read_csv(apath, keep_default_na=False,
                             dtype={"name": str, "bc": str, "umi": str})
            codes, _ = encode_batch(
                [u if u else "" for u in df.umi],
                max_len=spec.barcode.umi_len)
            bc_of = {b: i for i, b in enumerate(bcs_array)}
            res = {"umi": codes, "score": df.score.to_numpy(),
                   "status": df.status.to_numpy(),
                   "bc_idx": np.asarray([bc_of.get(b, -1) for b in df.bc],
                                        np.int32)}
            log(f"resume: {len(df)} barcode assignments loaded from "
                f"{os.path.basename(apath)}")
            if not os.path.isfile(f"{outdir}/{sample}_barcode_scores.csv"):
                _write_score_hist(res, outdir, sample)
            return df, res
    t0 = time.time()
    m = matcher or _matcher(bcs_array, spec, device, wl_shards, data_shards)
    if isinstance(m, ShardedMatcher):
        n_data, n_wl = m.mesh.shape
        log(f"whitelist match on a {n_data}x{n_wl} (data x wl) device mesh "
            f"over {len(m.mesh.devices)} device(s)")
    if prematched is not None and isinstance(m, BarcodeMatcher):
        res = {k: np.asarray(prematched[k]).copy()
               for k in ("bc_idx", "score", "status", "umi")}
        pend = np.where(prematched["pending"])[0]
        row_iter = cands.rows(pend)      # one sequential pass, ascending
        for s in range(0, len(pend), batch):
            rows = pend[s:s + batch]
            chunk = [sq for _, sq in itertools.islice(row_iter, len(rows))]
            q, qlen = encode_batch(chunk, max_len=MATCH_LQ)
            r = m.match(q, qlen)
            for k in res:
                res[k][rows] = r[k]
    else:
        all_res = {k: [] for k in ("bc_idx", "score", "status", "umi")}
        for _, bs in cands.iter_batches(batch):
            q, qlen = encode_batch(bs, max_len=MATCH_LQ)
            r = m.match(q, qlen)
            for k in all_res:
                all_res[k].append(r[k])
        res = {k: np.concatenate(v) if v else np.zeros(0, np.int32)
               for k, v in all_res.items()}
    status = res["status"]
    acc = status == ACCEPT
    _write_score_hist(res, outdir, sample)
    umi_strs = ["" if not a else decode(u)
                for a, u in zip(acc, res["umi"])]
    df = pd.DataFrame({
        "name": cands.names_list(),
        "bc": m.bc_strings(res["bc_idx"]),
        "umi": umi_strs,
        "score": res["score"],
        "status": status,
    })
    _atomic_to_csv(df, apath, index=False)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(fp, f)
    os.replace(tmp, mpath)
    log(f"barcode match: {acc.sum()}/{len(cands)} accepted vs "
        f"{len(bcs_array)} whitelist ({time.time() - t0:.1f}s)")
    return df, res


def dedup_outputs(spec, df, res, outdir, sample, knee_umi_name="knee"):
    """_bcumi_dedup.csv + knee plot(s)."""
    acc = df[df.status == ACCEPT]
    umi_codes = res["umi"][(df.status == ACCEPT).to_numpy()]
    table = counting.umi_dedup_table(acc.bc.to_numpy(), umi_codes)
    table.to_csv(f"{outdir}/{sample}_bcumi_dedup.csv")
    counting.save_knee_plot(f"{outdir}/{sample}_{knee_umi_name}.pdf",
                            table.umi_cnt.to_numpy(), "log10 UMI counts")
    if knee_umi_name != "knee":
        counting.save_knee_plot(f"{outdir}/{sample}_knee_reads.pdf",
                                table.read_cnt.to_numpy(), "log10 read counts")
    return table


def genome_stage(spec, outdir, sample, genome_ref, tag_map, device,
                 batch_size=512, force=False):
    """Align subreads to the genome with the splice preset and write the
    CB/UB/XT-tagged BAM with its .bai and the per-transcript counts
    (reference align_genome.sh `minimap2 -x splice` + utils.py:801-827).
    Intron-spanning chains are split into exon blocks
    (align/aligner.extract_exons); each exon is base-level aligned by the
    native banded DP and the gaps between exons become N CIGAR ops.

    Streamed external sort: each input batch becomes one coordinate-sorted
    spill of finished records (CIGARs included, so the merge is IO only),
    and a k-way heap merge writes the BAM. Peak memory is one batch of
    records plus the merge heads.

    Returns the record count and the seconds of its parts: index build,
    alignment (splice chain DP on the device, records, exon blocks), the
    banded DP and CIGARs of the exons, and the merge into the BAM."""
    done = [f"{outdir}/{sample}_genome_tagged.bam",
            f"{outdir}/{sample}_genome_tagged.bam.bai",
            f"{outdir}/{sample}_trns_ct.csv"]
    if not force and all(os.path.isfile(p) for p in done):
        log("resume: tagged genome BAM present, skipping genome stage")
        return -1, {}
    t0 = time.time()
    gindex = PanelIndex.from_fasta(genome_ref)
    galigner = PanelAligner(gindex, device, preset="splice")
    parts = {"index_s": time.time() - t0, "align_s": 0.0, "cigar_s": 0.0}
    sub_path = f"{outdir}/{sample}_deconcat.fastq.gz"
    cig_re = re.compile(r"(\d+)([=XIDN])")
    spills: list = []
    n_rows = 0
    all_trns: list = []
    tmpdir = tempfile.mkdtemp(prefix="nr_genome_", dir=outdir)

    def finish_rows(rows):
        """rows -> BAM-ready tuples with base-level CIGARs."""
        q_segs, t_segs, seg_of = [], [], []
        for (rid, ts, flag, name, blocks, codes, qual, _mq) in rows:
            stored = COMPLEMENT[codes][::-1] if flag & 16 else codes
            lo = len(q_segs)
            for (t_lo, t_hi, q_lo, q_hi) in blocks:
                q_segs.append(stored[q_lo:q_hi])
                t_segs.append(gindex.seq_codes[rid][t_lo:t_hi])
            seg_of.append(slice(lo, len(q_segs)))
        cigars, scores, nms = banded_align_batch(q_segs, t_segs, band=160)
        out = []
        for k, (rid, ts, flag, name, blocks, codes, qual, mq) in \
                enumerate(rows):
            cb, ub, xt = tag_map[name]
            if flag & 16:
                stored = COMPLEMENT[codes][::-1]
                squal = qual[::-1]
            else:
                stored, squal = codes, qual
            sl = seg_of[k]
            cig = []
            if blocks[0][2]:
                cig.append((blocks[0][2], "S"))
            as_sum = nm_sum = 0
            for e, si in enumerate(range(sl.start, sl.stop)):
                if e:
                    t_gap = blocks[e][0] - blocks[e - 1][1]
                    q_gap = blocks[e][2] - blocks[e - 1][3]
                    if t_gap > 0:
                        cig.append((t_gap, "N"))
                    if q_gap > 0:
                        cig.append((q_gap, "I"))
                cig += [(int(n), op) for n, op in
                        cig_re.findall(cigars[si])]
                as_sum += int(scores[si])
                nm_sum += int(nms[si])
            tail = len(stored) - blocks[-1][3]
            if tail:
                cig.append((tail, "S"))
            out.append((rid, ts, flag, name, cig, stored, squal, mq,
                        {"NM": nm_sum, "AS": as_sum,
                         "CB": cb, "UB": ub, "XT": xt}))
        return out

    for bi, batch in enumerate(
            fastq.iter_batches(sub_path, batch_size, max_len=4096)):
        ta = time.time()
        rec, exons = galigner.align_with_exons(batch.codes, batch.lengths)
        prim = rec.flag < 20                     # utils.py:812
        rows = []
        for r in np.where(prim)[0]:
            i = int(rec.read_idx[r])
            name = batch.names[i]
            if name not in tag_map:
                continue
            rows.append((int(rec.ref_id[r]), int(rec.tstart[r]),
                         int(rec.flag[r]), name, exons[r],
                         batch.codes[i, :batch.lengths[i]].copy(),
                         batch.quals[i], int(rec.mapq[r])))
        rows.sort(key=lambda x: (x[0], x[1]))
        tb = time.time()
        done_rows = finish_rows(rows)
        parts["align_s"] += tb - ta
        parts["cigar_s"] += time.time() - tb
        n_rows += len(done_rows)
        path = os.path.join(tmpdir, f"spill_{bi}.pkl")
        with open(path, "wb") as f:
            for row in done_rows:
                pickle.dump(row, f, protocol=4)
        spills.append(path)

    def read_spill(path):
        with open(path, "rb") as f:
            while True:
                try:
                    yield pickle.load(f)
                except EOFError:
                    return

    tw = time.time()
    bam_path = f"{outdir}/{sample}_genome_tagged.bam"
    with BAMWriter(bam_path, gindex.names,
                   [len(s) for s in gindex.seq_codes], index=True) as w:
        merged = heapq.merge(*[read_spill(p) for p in spills],
                             key=lambda row: (row[0], row[1]))
        for (rid, ts, flag, name, cig, stored, squal, mq, tags) in merged:
            w.write(name, flag, rid, ts, mq, cig, stored, squal, tags=tags)
            all_trns.append(tags["XT"])
    for p in spills:
        os.unlink(p)
    os.rmdir(tmpdir)
    counting.trans_counts_table(all_trns).to_csv(
        f"{outdir}/{sample}_trns_ct.csv", index=None)
    parts["write_s"] = time.time() - tw
    log(f"genome stage: {n_rows} tagged records → {bam_path} "
        f"(streamed {len(spills)}-spill merge, {time.time() - t0:.1f}s)")
    return n_rows, {k: round(v, 3) for k, v in parts.items()}


def _load_whitelist(path, spec_name):
    if not path or not os.path.isfile(path):
        raise SystemExit(
            f"[nanoranger-torch] whitelist not found: {path!r}. Mode "
            f"{spec_name} needs --barcodes pointing at a whitelist "
            "(.txt/.txt.gz/.tsv.gz) or a cell-called 10x .h5.")
    min_genes = 4 if spec_name == "3p10XTCR_nuc" else 20
    return whitelist.load(path, min_genes=min_genes)


def _tag_map_from_df(df):
    """name -> (CB, UB, XT) for accepted reads; XT parsed from the decon
    read name {qname}_{qstrt}_{qend}_{flag}_{trans}.

    Deliberate fix of a reference defect: the reference takes
    `name.split('_')[4]` (utils.py:745), which truncates transcript names
    containing '_' (the bundled panels have such names, e.g.
    `RUNX1T1-204|ENST00000422361.6_2450`). The transcript is the last
    field, so joining parts[4:] recovers it exactly."""
    out = {}
    for name, bc, umi, status in zip(df.name, df.bc, df.umi, df.status):
        if status != ACCEPT:
            continue
        parts = name.split("_")
        trns = "_".join(parts[4:]) if len(parts) > 4 else ""
        out[name] = (bc, umi, trns)
    return out


def _v_panel_paths(mode, xpecies, trns_ref):
    """V-gene panels for the native clonotyper. A V panel given as the
    transcriptome ref (5p10XTCR/RTX/3p10XTCR_nuc defaults) is reused
    directly; 3' modes align to C-gene panels, so the species' bundled V
    panels are used instead."""
    if trns_ref and "_V_" in os.path.basename(trns_ref):
        return [trns_ref]
    mouse = (xpecies == "mouse") or (not xpecies and mode in
                                     ("3pXCR_slideseq", "3p10XTCR"))
    names = (["TR_V_mouse.fa", "IG_V_mouse.fa"] if mouse
             else ["TR_V_human.fa"])
    return [os.path.join(DATA_DIR, n) for n in names
            if os.path.isfile(os.path.join(DATA_DIR, n))]


def _c_panel_paths(mode, xpecies, trns_ref):
    """Constant-region panels for J/C locus assignment. A C panel given as
    the transcriptome ref (3' modes) is reused; otherwise the species'
    bundled TR/XR C panels."""
    if trns_ref and "_C_" in os.path.basename(trns_ref):
        return [trns_ref]
    mouse = (xpecies == "mouse") or (not xpecies and mode in
                                     ("3pXCR_slideseq", "3p10XTCR"))
    names = (["XR_C_mouse.fa"] if mouse
             else ["TR_C_human.fa", "IG_C_human.fa"])
    return [os.path.join(DATA_DIR, n) for n in names
            if os.path.isfile(os.path.join(DATA_DIR, n))]


def _ensure_clonotypes(mode, sub_path, outdir, sample, trns_ref, xpecies,
                       device) -> bool:
    """Make clone exports available: MiXCR outputs win when present
    (external boundary preserved, reference scripts/mixcr.sh); otherwise
    the native clonotyper (vdj/) produces compatible tables. Returns True
    when clone tables exist afterwards."""
    if clone_stage.have_mixcr_outputs(sample, outdir):
        return True
    v_fastas = _v_panel_paths(mode, xpecies, trns_ref)
    if not v_fastas:
        log("no V-gene panel available for the native clonotyper; "
            f"run mixcr on {sub_path} then re-run for clone tables")
        return False
    from .vdj import call_clonotypes
    call_clonotypes(sub_path, v_fastas, outdir, sample,
                    c_fastas=_c_panel_paths(mode, xpecies, trns_ref),
                    log=log, device=device)
    return clone_stage.have_mixcr_outputs(sample, outdir)


def run_pipeline(mode, infile, outdir, sample, trns_ref=None, genome_ref=None,
                 barcodes=None, xpecies=None, batch_size=2048, force=False,
                 wl_shards=1, data_shards=1, scrub=False, device="cuda",
                 fast=None):
    """Run `mode` from the fastq to its artifacts on `device`. fast=None
    takes the fused per-batch step when data_shards <= 1 and
    NANORANGER_NO_FAST is not 1 (DeconRun); fast=False forces the unfused
    path."""
    dev = resolve_device(device)
    spec = chemistry.get(mode)
    dflt = MODE_DEFAULTS[mode]
    trns_ref = trns_ref or os.path.join(DATA_DIR, dflt[0])
    if dflt[1] and not genome_ref:
        genome_ref = os.path.join(DATA_DIR, dflt[1])
    if dflt[2] and not barcodes:
        barcodes = os.path.join(DATA_DIR, dflt[2])
    os.makedirs(outdir, exist_ok=True)

    tele = Telemetry(mode, infile, dev)
    ts = time.time()
    # modes whose whitelist is known up front (everything but the
    # data-driven 3p10XGEX) load it and build the matcher's tables first
    # (over the mesh when sharded); a missing file is reported after decon,
    # as the JAX package does
    bcs = None
    matcher = None
    shard_tables_s = None
    if mode not in ("RTX", "3p10XGEX"):
        try:
            bcs = _load_whitelist(barcodes, mode)
        except SystemExit:
            bcs = None
        if bcs is not None and len(bcs):
            matcher = _matcher(bcs, spec, dev, wl_shards, data_shards)
        if isinstance(matcher, ShardedMatcher):
            shard_tables_s = round(matcher.build_s, 3)
    # the stage keeps the JAX package's bounds (whitelist tables included);
    # their share rides along as whitelist_s
    whitelist_s = round(time.time() - ts, 3)
    # the fused step takes the unsharded matcher on its device (its
    # exact-class pass); a mesh's matcher runs only after the stream
    run = DeconRun(spec, infile, outdir, sample, trns_ref, dev, batch_size,
                   force=force, data_shards=data_shards,
                   matcher=matcher if isinstance(matcher, BarcodeMatcher)
                   else None, fast=fast)
    run.write_eds(outdir, sample)
    phase_s = getattr(run, "phase_s", None)
    tele.stage("align_decon", time.time() - ts, run.n_reads,
               subreads=run.n_sub, candidates=len(run.cands),
               resumed=run.resumed, whitelist_s=whitelist_s,
               shard_tables_s=shard_tables_s,
               deferred_reads=run.n_deferred or None,
               index_bytes=run.index_bytes,
               index_s=(round(run.index_s, 3) if run.index_s is not None
                        else None),
               steady_reads_per_s=getattr(run, "steady_reads_per_s", None),
               phase_s={k: round(v, 3) for k, v in phase_s.items()}
               if phase_s else None)

    if mode == "RTX":
        ts = time.time()
        _ensure_clonotypes(mode, run.sub_path, outdir, sample, trns_ref,
                           xpecies, dev)
        tele.stage("clonotypes", time.time() - ts)
        tele.write(outdir, sample)
        return

    # whitelist
    if mode == "3p10XGEX":
        _atomic_to_csv(pd.Series(run.raw_counts, name="read_count"),
                       f"{outdir}/{sample}_bc_read_count.csv")
        # reference artifact name parity: the raw 16-mer counter is
        # dumped as {sample}_bc_count.json too (utils.py:1403-1404)
        tmp = f"{outdir}/{sample}_bc_count.json.tmp"
        with open(tmp, "w") as f:
            json.dump({k: int(v) for k, v in run.raw_counts.items()}, f)
        os.replace(tmp, f"{outdir}/{sample}_bc_count.json")
        if barcodes and os.path.isfile(barcodes):
            bcs = whitelist.data_driven(run.raw_counts, barcodes)
        else:
            log("WARNING: master whitelist missing; using observed "
                "barcodes with count>20 (reference requires "
                "3M-february-2018.txt.gz)")
            bcs = np.asarray([b for b, c in run.raw_counts.items()
                              if c > 20 and len(b) == 16 and "N" not in b
                              and "." not in b])
    elif bcs is None:
        bcs = _load_whitelist(barcodes, mode)
    if len(bcs) == 0:
        log("no whitelist barcodes — stopping after decon")
        tele.write(outdir, sample)
        return

    ts = time.time()
    df, res = match_barcodes(spec, bcs, run.cands, outdir, sample, dev,
                             force=force, matcher=matcher,
                             wl_shards=wl_shards, data_shards=data_shards,
                             prematched=None if run.resumed else
                             run.prematch)
    tele.stage("barcode_match", time.time() - ts, len(run.cands),
               accepted=int((df.status == ACCEPT).sum()),
               whitelist=int(len(bcs)))

    ts = time.time()
    if mode == "5p10XGEX":
        dedup_outputs(spec, df, res, outdir, sample)
        tele.stage("dedup", time.time() - ts)
        if genome_ref and os.path.isfile(genome_ref):
            ts = time.time()
            n_bam, parts = genome_stage(spec, outdir, sample, genome_ref,
                                        _tag_map_from_df(df), dev,
                                        force=force)
            tele.stage("genome_tag", time.time() - ts, records=n_bam,
                       **parts)
    elif mode in ("5p10XTCR", "3p10XTCR_nuc"):
        dedup_outputs(spec, df, res, outdir, sample, knee_umi_name="knee_UMI")
        tele.stage("dedup", time.time() - ts)
        ts = time.time()
        if _ensure_clonotypes(mode, run.sub_path, outdir, sample, trns_ref,
                              xpecies, dev):
            _, cloneID = clone_stage.clone_filt_5p10X(sample, outdir)
            acc = df[df.status == ACCEPT]
            clone_stage.clone_bcumi_join(
                cloneID, acc.name.tolist(), acc.bc.to_numpy(),
                acc.umi.tolist(), f"{outdir}/{sample}_clone_bcumi.csv.gz")
        tele.stage("clonotypes", time.time() - ts)
    elif mode in ("3pXCR_slideseq", "3p10XTCR"):
        if _ensure_clonotypes(mode, run.sub_path, outdir, sample, trns_ref,
                              xpecies, dev):
            _, cloneID = clone_stage.clone_filt_slideseq(sample, outdir)
            acc = df[df.status == ACCEPT]
            clone_stage.clone_bcumi_join(
                cloneID, acc.name.tolist(), acc.bc.to_numpy(),
                acc.umi.tolist(), f"{outdir}/{sample}_clone_bcumi.csv.gz",
                clone_first=True)
        tele.stage("clonotypes", time.time() - ts)
    elif mode == "3p10XGEX":
        acc = df[df.status == ACCEPT]
        umi_codes = res["umi"][(df.status == ACCEPT).to_numpy()]
        trns = [n.split("/ccs_")[-1].split("_") for n in acc.name]
        trns = ["_".join(t[3:]) if len(t) > 3 else "" for t in trns]
        trns = [t.split("|")[-1].split("_")[0] if "|" in t else t
                for t in trns]                          # utils.py:1483-1486
        with gzip.open(f"{outdir}/{sample}_quads.json.gz", "wt") as f:
            json.dump(counting.quads_dict(acc.bc.to_numpy(), umi_codes,
                                          trns), f)
        genes, cells, cnts = counting.count_matrix(
            acc.bc.to_numpy(), umi_codes, np.asarray(trns, dtype=object))
        counting.write_mtx(f"{outdir}/{sample}", genes, cells, cnts)
        log(f"count matrix: {len(genes)} genes × {len(cells)} cells, "
            f"{len(cnts)} nonzeros")
        tele.stage("count_matrix", time.time() - ts,
                   genes=len(genes), cells=len(cells))
    if scrub:
        # the only stage checkpoint is the assignment table — removing it
        # trades the resume capability for the reference's footprint
        for p in (f"{outdir}/{sample}_assignments.csv.gz",
                  f"{outdir}/{sample}_assignments.csv.gz.meta.json"):
            if os.path.isfile(p):
                os.unlink(p)
        log("scrub: removed stage checkpoints (re-runs recompute)")
    tele.write(outdir, sample)


def main(argv=None):
    p = argparse.ArgumentParser(prog="nanoranger-torch")
    p.add_argument("--cores", type=str, default=None)   # accepted, unused
    p.add_argument("--trns_ref", type=str)
    p.add_argument("--genome_ref", type=str)
    p.add_argument("--infile", type=str, required=True)
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--expname", type=str, required=True)
    p.add_argument("--barcodes", type=str)
    p.add_argument("--split", default=False, action="store_true")
    p.add_argument("--mode", type=str, required=True,
                   choices=chemistry.names())
    p.add_argument("--xpecies", type=str)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--force", default=False, action="store_true",
                   help="recompute all stages, ignoring existing artifacts")
    p.add_argument("--scrub", default=False, action="store_true",
                   help="remove stage-checkpoint intermediates after a "
                        "successful run (disables resume)")
    p.add_argument("--wl_shards", type=int, default=1)
    p.add_argument("--data_shards", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the kernels' plain versions)")
    a = p.parse_args(argv)
    run_pipeline(a.mode, a.infile, a.outdir, a.expname, a.trns_ref,
                 a.genome_ref, a.barcodes, a.xpecies, a.batch_size,
                 force=a.force, wl_shards=a.wl_shards,
                 data_shards=a.data_shards, scrub=a.scrub, device=a.device)


if __name__ == "__main__":
    main()
