"""Pipeline CLI of the PyTorch/CUDA port: all seven modes, streamed.

Counterpart of the JAX package's pipeline.py, flag-compatible with it
(and with the reference pipeline.py) plus --device. Every mode runs fastq
-> minimizer sketch -> anchor lookup and sort -> chain DP -> record
extraction -> end extension -> adapter scan (whole flank or sliding
sub-windows) -> subread and BC-UMI slices, by default fused into one step
a length-bucketed batch (stages/cli_step.py; fast=False runs the unfused
path, batch by batch), written in input order by one sink; the
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
from array import array
from collections import deque

import numpy as np
import pandas as pd
import torch

from . import chemistry, trace
from .align.aligner import (PanelAligner, clip_exon_blocks, extract_exons,
                            extract_records)
from .align.index import PanelIndex
from .io import fastq, whitelist
from .io.bam import BAMWriter
from .io.candidate_store import CandidateStore
from .io.encode import COMPLEMENT, PAD, decode, encode_batch
from .io.fasta import FastaWriter, iter_fasta
from .ops.banded import banded_align
from .ops.extend import extend_records_host
from .parallel.sharded import ShardedMatcher, mesh_devices
from .stages import clones as clone_stage
from .stages import counting
from .stages.barcode import (ACCEPT, BAD_UMI, DP_PENDING, LOW_AS,
                             BarcodeMatcher)
from .stages.cli_step import BatchAssembly, assemble_batch, build_cli_step
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
    """The run statistics, a view of the run's trace (trace.py): one row
    per stage, made from the stage's span, then the trace's spans, their
    totals and the counters. Written atomically as {sample}_runstats.json
    at pipeline exit."""

    def __init__(self, mode: str, infile: str, device: torch.device,
                 run: trace.Run):
        self.run = run
        self.doc = {"mode": mode, "infile": infile, "device": str(device),
                    "stages": []}
        if device.type == "cuda":
            self.doc["device_name"] = torch.cuda.get_device_name(device)

    def stage(self, sp: trace.Span, reads: int | None = None, **extra):
        """The row of the stage whose span `sp` has closed."""
        seconds = sp.seconds
        row = {"stage": sp.name, "seconds": round(seconds, 3)}
        if reads is not None and reads >= 0:
            row["reads"] = int(reads)
            if seconds > 0:
                row["reads_per_s"] = round(reads / seconds, 1)
        row.update({k: v for k, v in extra.items()
                    if v is not None and not (isinstance(v, int) and v < 0)})
        self.doc["stages"].append(row)

    def write(self, outdir: str, sample: str):
        self.doc["total_seconds"] = round(
            (time.time_ns() - self.run.t0_ns) / 1e9, 3)
        self.doc.update(self.run.doc())
        path = f"{outdir}/{sample}_runstats.json"
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.doc, f, indent=1)
        os.replace(tmp, path)


class DeconSink:
    """The decon stream's outputs, written strictly in input order.

    Every producer hands in its products as a BatchAssembly
    (stages/cli_step.py) whose row k is one read: the slice of each list
    between read_bounds[k-1] and read_bounds[k]. put() takes such a part
    with each row's input ordinal and writes a read once every read before
    it is written. The sink is the only code that appends to the subread
    and BC-UMI writers, the candidate store, the transcript of each
    candidate (the panel reference of its decon record), the eds and polyA
    rows, the raw barcode counts and the match rows of the fused step's
    exact-class pass (umi_len given), which close() returns as
    DeconRun.prematch."""

    def __init__(self, sub_path: str, bcumi_path: str,
                 umi_len: int | None):
        self.fsub = fastq.FastqWriter(sub_path)
        self.fbc = FastaWriter(bcumi_path)
        # spill-backed candidate store: bounded resident memory however
        # many reads stream through
        self.cands = CandidateStore()
        self.cand_refs = array("i")
        self.eds_rows: list = []
        self.polyA: list = []
        self.raw_counts: dict = {}
        self.umi_len = umi_len
        # bc_idx, score, status, umi (None: matched after the stream)
        self.match = None if umi_len is None else ([], [], [], [])
        self.n_sub = 0
        self._held: dict = {}          # ordinal -> (part, refs, lo, hi)
        self._cursor = 0

    def put(self, part, refs, seqs):
        """Take the reads of `part`: row k has input ordinal seqs[k] (-1:
        nothing to write), refs the panel reference of each candidate."""
        if len(refs) != len(part.bcumi_names):
            raise RuntimeError(f"{len(refs)} transcripts for "
                               f"{len(part.bcumi_names)} candidates")
        lo = (0, 0, 0, 0, 0)
        for s, hi in zip(seqs, part.read_bounds):
            if s >= 0:
                self._held[int(s)] = (part, refs, lo, hi)
            lo = hi
        while self._cursor in self._held:
            self._write(*self._held.pop(self._cursor))
            self._cursor += 1

    def _write(self, part, refs, lo, hi):
        for j in range(lo[0], hi[0]):
            self.fsub.write(part.sub_names[j], part.sub_seqs[j],
                            part.sub_quals[j])
        for j in range(lo[1], hi[1]):
            self.fbc.write(part.bcumi_names[j], part.bcumi_seqs[j])
            self.cands.append(part.bcumi_names[j], part.bcumi_seqs[j])
            self.cand_refs.append(refs[j])
        if self.match is not None:
            for col, rows in zip(self.match, (
                    part.match_bc, part.match_score, part.match_status,
                    part.match_umi)):
                col.extend(rows[lo[1]:hi[1]])
        self.eds_rows.extend(part.eds_rows[lo[2]:hi[2]])
        self.polyA.extend(part.polyA[lo[3]:hi[3]])
        for key in part.raw_keys[lo[4]:hi[4]]:
            self.raw_counts[key] = self.raw_counts.get(key, 0) + 1
        self.n_sub += hi[0] - lo[0]

    def close(self):
        """Close the writers once every read is written; returns the match
        rows (None without them): per-candidate arrays bc_idx, score,
        status, umi, and pending, the rows match_barcodes matches (a
        deferred read's candidates and the DP_PENDING rows)."""
        if self._held:       # every read handed in must have been written
            raise RuntimeError(
                f"order-restoring writer stalled at read {self._cursor} "
                f"with {len(self._held)} assembled reads pending")
        self.fsub.close()
        self.fbc.close()
        if self.match is None:
            return None
        bc, score, status, umis = self.match
        umi = np.full((len(bc), self.umi_len), PAD, np.int8)
        pend = np.zeros(len(bc), bool)
        for i, u in enumerate(umis):
            if u is None:
                pend[i] = True
            else:
                umi[i] = u
        status = np.asarray(status, np.int32)
        pend |= status == DP_PENDING
        return {"bc_idx": np.asarray(bc, np.int32),
                "score": np.asarray(score, np.int32), "status": status,
                "umi": umi, "pending": pend}


def _decon_part(spec, index, sample, ch, batch):
    """The unfused decon of a read batch whose chains `ch` came from
    PanelAligner._chain: records, their extended ends and run_decon's
    products, as a BatchAssembly of the batch's reads in order (no match
    rows), and the panel reference of each candidate. Both the unfused
    stream and the fused stream's reruns of deferred reads make theirs
    here."""
    dev_codes = ch["dev_codes"]
    lengths = np.asarray(batch.lengths, np.int32)
    rec = extract_records(ch, index)
    # base-level DP extension of chain ends: qstart/qend match minimap2's
    # extended spans, not terminal anchors
    extend_records_host(rec, index, dev_codes, lengths, dev_codes.device)
    out = run_decon(spec, batch.codes, lengths, list(batch.names),
                    list(batch.quals), rec, index.names, sample,
                    device=dev_codes.device, dev_codes=dev_codes)
    part = BatchAssembly()
    part.sub_names, part.sub_seqs, part.sub_quals = \
        out.sub_names, out.sub_seqs, out.sub_quals
    part.bcumi_names, part.bcumi_seqs = out.bcumi_names, out.bcumi_seqs
    part.eds_rows, part.polyA = out.eds_rows, out.polyA
    raw = out.raw_rows or []
    part.raw_keys = [key for _, key in raw]
    # each output's records are in record order, and records in read
    # order: read k's outputs end where the next read's begin
    reads = np.arange(len(batch))
    ends = [np.searchsorted(rec.read_idx[np.asarray(r, np.int64)], reads,
                            side="right").tolist() for r in (
        out.sub_rec, out.bcumi_rec,
        out.eds_rec if out.eds_rec is not None else [],
        out.bcumi_rec if spec.bcumi_rule == "rev_slideseq" else [],
        [r for r, _ in raw])]
    part.read_bounds = list(zip(*ends))
    return part, rec.ref_id[out.bcumi_rec].tolist()


class DeconRun:
    """Streamed align+decon over an input fastq, accumulating BC-UMI
    candidates and the per-mode statistics and writing the subread/BCUMI
    artifacts in input order (DeconSink).

    The default with data_shards <= 1 is the FUSED stream (_FusedStream,
    stages/cli_step.py): one call per length-bucketed batch covering seed
    -> chain DP -> record extraction -> extension -> flank scan -> BC-UMI
    slice -> the exact-class whitelist pass, whose artifacts are
    byte-identical to the unfused stream's (reads with more kept chains
    than the step's slots are rerun through the unfused decon).
    fast=False takes the unfused stream: batch by batch, records on the
    host between the device passes.

    data_shards > 1 runs the unfused stream over the data cells of a mesh:
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
        self.sample = sample
        self.trns_ref = trns_ref
        self.prematch = None
        self.n_deferred = 0
        # the fused stream's index: its tensors' bytes and the seconds to
        # build them (the unfused stream leaves both None)
        self.index_bytes = None
        self.index_s = None
        self.eds_rows: list = []
        self.raw_counts: dict = {}
        self.polyA: list = []
        self.resumed = False
        t0 = time.time()
        sub_kind = "VDJ" if spec.name in (
            "3pXCR_slideseq", "3p10XTCR", "3p10XTCR_nuc") else "deconcat"
        self.sub_path = f"{outdir}/{sample}_{sub_kind}.fastq.gz"
        self.bcumi_path = f"{outdir}/{sample}_BCUMI.fasta.gz"
        # resume requires the stats artifacts too: a crash between the
        # decon writers closing and write_eds() would otherwise leave the
        # eds/polyA stats missing for good without --force
        need = [self.sub_path, self.bcumi_path] + \
            self.eds_artifacts(outdir, sample)
        rc_path = f"{outdir}/{sample}_bc_read_count.csv"
        if spec.name == "3p10XGEX":
            need.append(rc_path)
        if not force and all(os.path.isfile(p) for p in need):
            cands = CandidateStore()
            for nm, sq in iter_fasta(self.bcumi_path):
                cands.append(nm, sq)
            if spec.name == "3p10XGEX":
                rc = pd.read_csv(rc_path, index_col=0)
                self.raw_counts = dict(zip(rc.index, rc.iloc[:, 0]))
            self.cands = cands
            self.resumed = True
            # no decon records: transcripts() reads them from the names
            self.cand_refs = None
            self.n_reads = self.n_sub = -1
            log(f"resume: decon artifacts present, loaded "
                f"{len(self.cands)} BC-UMI candidates "
                f"({time.time() - t0:.1f}s)")
            return

        with trace.span("decon.index") as sp:
            self.index = PanelIndex.from_fasta(trns_ref)
        dev = torch.device(device)
        if fast is None:
            fast = data_shards <= 1
        step_match = fast and matcher is not None and spec.barcode is not None
        sink = DeconSink(self.sub_path, self.bcumi_path,
                         spec.barcode.umi_len if step_match else None)
        if fast:
            fs = _FusedStream(spec, self.index, sample, sink, dev,
                              batch_size, max_len, matcher)
            fs.run(infile)
            self.n_reads, self.n_deferred = fs.n_reads, fs.n_deferred
            self.index_bytes = fs.index_bytes
            self.index_s = sp.seconds + fs.index_s
        else:
            self.n_reads = self._run_unfused(sink, infile, dev, batch_size,
                                             max_len, data_shards)
        self.prematch = sink.close()
        self.cands, self.cand_refs = sink.cands, sink.cand_refs
        self.eds_rows, self.polyA = sink.eds_rows, sink.polyA
        self.raw_counts, self.n_sub = sink.raw_counts, sink.n_sub
        if fast:
            trace.count("decon.deferred_reads", self.n_deferred)
            tr = trace.active()
            if tr is not None:
                sec = tr.seconds
                self.phase_s = {
                    "read": sec("decon.read"),
                    "step": sec("decon.step.issue") +
                    sec("decon.step.download"),
                    "assemble": sec("decon.assemble"),
                    "slow": sec("decon.slow")}
        log(f"align+decon{' (fused)' if fast else ''}: {self.n_reads} "
            f"reads → {self.n_sub} subreads, {len(self.cands)} BC-UMI "
            "candidates"
            + (f", {self.n_deferred} reads via the unfused path"
               if self.n_deferred else "")
            + f" ({time.time() - t0:.1f}s)")

    def _run_unfused(self, sink, infile, device, batch_size, max_len,
                     data_shards) -> int:
        """The unfused stream; returns the number of reads. Batch i chains
        on data cell i % data_shards, the cells laid over the devices
        round-robin; its decon waits until data_shards later batches are
        queued."""
        aligner = PanelAligner(
            self.index, device,
            devices=mesh_devices(device) if data_shards > 1 else None)
        pending: deque = deque()
        n_reads = 0
        for i, batch in enumerate(fastq.iter_batches(
                infile, batch_size, max_len=max_len)):
            # queue the batch's device work before draining older
            # batches, so up to data_shards cells chain at once
            pending.append((n_reads, batch, aligner._chain(
                batch.codes, batch.lengths, shard=i % data_shards)))
            n_reads += len(batch)
            if len(pending) > data_shards:
                self._put_unfused(sink, *pending.popleft())
        while pending:
            self._put_unfused(sink, *pending.popleft())
        return n_reads

    def _put_unfused(self, sink, seq0, batch, ch):
        """Hand the unfused decon of one batch (input ordinals from seq0)
        to the sink."""
        sink.put(*_decon_part(self.spec, self.index, self.sample, ch, batch),
                 range(seq0, seq0 + len(batch)))

    def transcripts(self) -> list:
        """The transcript of each candidate, in the store's order: the
        panel reference of the decon record that made it, never a field
        parsed from its name (a read name may hold '_'). A run resumed
        from its decon artifacts has no records; each name then gives the
        longest panel name that ends it after an integer (flag) field."""
        if self.cand_refs is not None:
            names = self.index.names
            return [names[r] for r in self.cand_refs]
        panel = {n.split()[0] for n, _ in iter_fasta(self.trns_ref)}
        return [_transcript_in_name(n, panel)
                for n in self.cands.names_list()]

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


class _FusedStream:
    """The fused stream: one step call per batch (stages/cli_step.py) on
    `dev`; the host assembles the artifacts from the downloaded slot
    arrays and hands them to the sink.

    Reads dispatch in length buckets Lb in {1024, 2048, max_len}, each
    batch up to batch_size reads of width Lb: ONT reads are mostly short,
    and the chain's anchor slots grow with the width. Each read carries its
    input ordinal, and the sink writes strictly in input order, so
    bucketing changes nothing in the artifact byte streams. A batch goes
    to the step with its filled rows only: eager kernels take any row
    count, where the JAX step pads every batch to one compiled shape.

    Up to 1 + INFLIGHT batches are in flight: the card computes ahead while
    the host downloads and assembles. Reads the step defers (more kept
    chains than its slots, or an anchor overflow) are rerun through the
    unfused decon (_decon_part) in windows of at most FLUSH_BATCHES batches
    and DEFER_CAP reads, padded to max_len; the sink interleaves them back
    in read order.

    With a matcher the step runs the exact-class whitelist pass, and the
    sink's match rows carry its verdicts: rows it leaves DP_PENDING, and
    the candidates of deferred reads, are matched after the stream.

    The JAX package loads its compiled step per bucket ahead of time on a
    thread (NANORANGER_AOT), and on an accelerator runs the unfused
    fallback once on the first batch so that the fallback's compiles land
    early. The port has neither: the kernels build at first use
    (kernels.py), eager torch compiles nothing, and the fallback runs the
    step's own kernels and torch ops; its aligner takes the step's index
    tensors and its extension the step's reference tensors (a second copy
    of a whole-transcriptome index would cost seconds and gigabytes).

    Spans (trace.py): decon.index (the step's tensors of the index:
    index_s), decon.read (fastq stream + encode), decon.step.issue (the
    step calls: the host issues the card's work; eager torch waits only at
    the extension's re-round test), decon.step.download (the wait at
    download), decon.assemble (host artifact assembly and the ordered
    writes), decon.slow (unfused reruns of deferred reads)."""

    INFLIGHT = 3          # batches dispatched beyond the one being drained
    # batches whose reads all fit the slots are written at once; batches
    # with deferred reads buffer until one windowed unfused run covers them
    FLUSH_BATCHES = 16
    DEFER_CAP = 448

    def __init__(self, spec, index, sample, sink, dev, batch_size, max_len,
                 matcher):
        self.spec, self.index, self.sample, self.sink = \
            spec, index, sample, sink
        self.batch_size, self.max_len = batch_size, max_len
        with trace.span("decon.index") as sp:
            self.step, self.tables = build_cli_step(spec, index,
                                                    matcher=matcher,
                                                    device=dev)
        index_arrays = tuple(self.tables[k] for k in
                             ("prefix_start", "prefix_count", "windows"))
        self.index_bytes = sum(t.nbytes for t in index_arrays)
        self.index_s = sp.seconds
        self.fallback = PanelAligner(index, dev, index_arrays=index_arrays)
        self.buckets = sorted({max(256, min(1024, max_len)),
                               max(256, min(2048, max_len)),
                               max(256, max_len)})
        self.acc = {Lb: self._new_acc(Lb) for Lb in self.buckets}
        self.pending: deque = deque()
        self.buffer: list = []
        self.buf_defers = 0
        self.n_reads = self.n_deferred = 0

    def run(self, infile):
        it = fastq.iter_batches(infile, self.batch_size,
                                max_len=self.max_len)
        in_batches = next_seq = 0
        while True:
            with trace.span("decon.read"):
                batch = next(it, None)
            if batch is None:
                break
            self._route(batch, next_seq)
            next_seq += len(batch)
            in_batches += 1
            if in_batches % self.FLUSH_BATCHES == 0:
                # anti-starvation: a rare bucket would otherwise hold the
                # write cursor (and the sink's held reads) until it fills
                for Lb in self.buckets:
                    self._dispatch(Lb)
        for Lb in self.buckets:
            self._dispatch(Lb)
        while self.pending:
            self._drain()
        self._flush()

    def _new_acc(self, Lb):
        n = self.batch_size
        return {"codes": np.full((n, Lb), PAD, np.int8),
                "lengths": np.zeros(n, np.int32), "names": [""] * n,
                "quals": [b""] * n, "seq": np.full(n, -1, np.int64), "n": 0}

    def _route(self, batch, seq0):
        """Copy the reads of `batch` (input ordinals from seq0) into their
        buckets, one sliced copy per (bucket, contiguous run), and
        dispatch each bucket that fills."""
        w = batch.codes.shape[1]
        bl = np.minimum(np.asarray(batch.lengths), self.max_len)
        bidx = np.searchsorted(np.asarray(self.buckets), bl)
        for b, Lb in enumerate(self.buckets):
            rows = np.nonzero(bidx == b)[0]
            r0 = 0
            while r0 < len(rows):
                a = self.acc[Lb]
                k = a["n"]
                take = min(self.batch_size - k, len(rows) - r0)
                sel = rows[r0:r0 + take]
                w2 = min(w, Lb)
                a["codes"][k:k + take, :w2] = batch.codes[sel, :w2]
                a["lengths"][k:k + take] = bl[sel]
                for j, i in enumerate(sel):
                    a["names"][k + j] = batch.names[i]
                    a["quals"][k + j] = batch.quals[i]
                a["seq"][k:k + take] = seq0 + sel
                a["n"] = k + take
                r0 += take
                if a["n"] == self.batch_size:
                    self._dispatch(Lb)

    def _dispatch(self, Lb):
        a = self.acc[Lb]
        n = a["n"]
        if n == 0:
            return
        trace.count(f"decon.batches.L{Lb}")
        trace.count(f"decon.reads.L{Lb}", n)
        with trace.span("decon.step.issue"):
            out_dev = self.step(a["codes"][:n], a["lengths"][:n],
                                self.tables)
        self.pending.append((fastq.ReadBatch(
            a["codes"][:n], a["lengths"][:n], a["names"][:n],
            a["quals"][:n]), a["seq"][:n], out_dev))
        self.acc[Lb] = self._new_acc(Lb)
        if len(self.pending) > self.INFLIGHT:
            self._drain()

    def _drain(self):
        batch, seqs, out_dev = self.pending.popleft()
        with trace.span("decon.step.download"):
            out = {k: v.cpu().numpy() for k, v in out_dev.items()}
        self.n_reads += len(batch)
        self.buffer.append((batch, seqs, out))
        self.buf_defers += int(out["defer"].sum())
        if self.buf_defers == 0 or len(self.buffer) >= self.FLUSH_BATCHES \
                or self.buf_defers >= self.DEFER_CAP:
            self._flush()

    def _flush(self):
        """Rerun the buffered batches' deferred reads, then assemble every
        buffered batch and hand it and the reruns to the sink."""
        rows = [(seqs[i], batch, i) for batch, seqs, out in self.buffer
                for i in np.flatnonzero(out["defer"])]
        reruns = []
        if rows:
            with trace.span("decon.slow"):
                reruns = [self._rerun(rows[b:b + self.DEFER_CAP])
                          for b in range(0, len(rows), self.DEFER_CAP)]
        with trace.span("decon.assemble"):
            for batch, seqs, out in self.buffer:
                asm = assemble_batch(
                    self.spec, out, batch.codes, batch.lengths, batch.names,
                    batch.quals, self.index.names, self.sample,
                    slow_fallback=lambda didx: {})
                self.n_deferred += asm.n_deferred_reads
                # a deferred read's products come from its rerun
                defer = out["defer"]
                cand = (out["ok"] & out["accept_bc"]).reshape(
                    len(defer), -1) & ~defer[:, None]
                self.sink.put(asm, out["ref_id"].reshape(
                    len(defer), -1)[cand].tolist(),
                    np.where(defer, -1, seqs))
            for part, refs, seqs in reruns:
                self.sink.put(part, refs, seqs)
        self.buffer.clear()
        self.buf_defers = 0

    def _rerun(self, rows):
        """The unfused decon of deferred reads rows [(ordinal, batch, row)],
        at max_len width: deferred rows come from every bucket."""
        codes = np.full((len(rows), self.max_len), PAD, np.int8)
        for k, (_, b, i) in enumerate(rows):
            codes[k, :b.codes.shape[1]] = b.codes[i]
        batch = fastq.ReadBatch(
            codes, np.asarray([b.lengths[i] for _, b, i in rows], np.int32),
            [b.names[i] for _, b, i in rows],
            [b.quals[i] for _, b, i in rows])
        part, refs = _decon_part(
            self.spec, self.index, self.sample,
            self.fallback._chain(batch.codes, batch.lengths), batch)
        if self.sink.match is not None:
            # matched after the stream, as assemble_batch marks them
            n = len(part.bcumi_names)
            part.match_bc, part.match_score = [-2] * n, [0] * n
            part.match_status, part.match_umi = [0] * n, [None] * n
        return part, refs, [s for s, _, _ in rows]


def _transcript_in_name(name: str, panel: set) -> str:
    """The longest panel name that ends a decon name after an integer
    field: {qname}_{qstrt}_{qend}_{flag}_{trans}."""
    parts = name.split("_")
    for k in range(1, len(parts)):
        t = "_".join(parts[k:])
        if t in panel and parts[k - 1].isdigit():
            return t
    return ""


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
    m = matcher
    if m is None:
        with trace.span("whitelist.tables"):
            m = _matcher(bcs_array, spec, device, wl_shards, data_shards)
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
    banded DP (ops/banded.banded_align: the kernel csrc/banded_cigar.cu on
    a CUDA `device`, the host C++ routine elsewhere) and the gaps between
    exons become N CIGAR ops.

    Streamed external sort: each input batch becomes one coordinate-sorted
    spill of finished records (CIGARs included, so the merge is IO only),
    and a k-way heap merge writes the BAM. Peak memory is one batch of
    records plus the merge heads.

    Exon blocks that overlap are clipped first
    (align/aligner.clip_exon_blocks), so every record's CIGAR consumes
    exactly its SEQ; an insertion between two blocks that no N separates
    counts in NM, as an insertion inside a block does. Records without
    overlapping blocks are those of the reference implementation.

    Returns the record count and the seconds of its parts, the spans
    genome.index (index build), genome.align (splice chain DP on the
    device, records, and within it genome.exons: the exon blocks, clipped,
    on the host), genome.cigar (the banded DP and CIGARs of the exons) and
    genome.write (the merge into the BAM). Counters, host integers only:
    genome.records (records written), genome.blocks (their exon blocks
    before the clip), genome.blocks_trimmed and genome.blocks_dropped (by
    the clip), genome.spliced_records (records holding an N) and
    genome.partner_reads (written subreads whose records, supplementary
    ones included, lie on two or more references: fusion evidence); the
    exon segments count in banded.device_segments or banded.host_segments
    (ops/banded.py)."""
    done = [f"{outdir}/{sample}_genome_tagged.bam",
            f"{outdir}/{sample}_genome_tagged.bam.bai",
            f"{outdir}/{sample}_trns_ct.csv"]
    if not force and all(os.path.isfile(p) for p in done):
        log("resume: tagged genome BAM present, skipping genome stage")
        return -1, {}
    t0 = time.time()
    with trace.span("genome.index") as sp:
        gindex = PanelIndex.from_fasta(genome_ref)
        galigner = PanelAligner(gindex, device, preset="splice")
    parts = {"index_s": sp.seconds, "align_s": 0.0, "cigar_s": 0.0}
    sub_path = f"{outdir}/{sample}_deconcat.fastq.gz"
    cig_re = re.compile(r"(\d+)([=XIDN])")
    spills: list = []
    n_rows = n_spliced = 0
    all_trns: list = []
    tmpdir = tempfile.mkdtemp(prefix="nr_genome_", dir=outdir)

    def finish_rows(rows):
        """rows -> BAM-ready tuples with base-level CIGARs."""
        nonlocal n_spliced
        q_segs, t_segs, seg_of = [], [], []
        for (rid, ts, flag, name, blocks, codes, qual, _mq) in rows:
            stored = COMPLEMENT[codes][::-1] if flag & 16 else codes
            lo = len(q_segs)
            for (t_lo, t_hi, q_lo, q_hi) in blocks:
                q_segs.append(stored[q_lo:q_hi])
                t_segs.append(gindex.seq_codes[rid][t_lo:t_hi])
            seg_of.append(slice(lo, len(q_segs)))
        cigars, scores, nms = banded_align(q_segs, t_segs, 160, device)
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
                        if not t_gap:
                            nm_sum += q_gap
                cig += [(int(n), op) for n, op in
                        cig_re.findall(cigars[si])]
                as_sum += int(scores[si])
                nm_sum += int(nms[si])
            tail = len(stored) - blocks[-1][3]
            if tail:
                cig.append((tail, "S"))
            n_spliced += any(op == "N" for _, op in cig)
            out.append((rid, ts, flag, name, cig, stored, squal, mq,
                        {"NM": nm_sum, "AS": as_sum,
                         "CB": cb, "UB": ub, "XT": xt}))
        return out

    for bi, batch in enumerate(
            fastq.iter_batches(sub_path, batch_size, max_len=4096)):
        with trace.span("genome.align") as sp:
            ch = galigner._chain(batch.codes, batch.lengths)
            rec = extract_records(ch, gindex)
            with trace.span("genome.exons"):
                exons = extract_exons(ch, rec)
                tagged = np.asarray([n in tag_map for n in batch.names],
                                    bool)
                prim = rec.flag < 20                 # utils.py:812
                rows = []
                n_blocks = n_trimmed = n_dropped = 0
                for r in np.where(prim & tagged[rec.read_idx])[0]:
                    i = int(rec.read_idx[r])
                    blocks, nt, nd = clip_exon_blocks(exons[r])
                    n_blocks += len(exons[r])
                    n_trimmed += nt
                    n_dropped += nd
                    rows.append((int(rec.ref_id[r]), int(rec.tstart[r]),
                                 int(rec.flag[r]), batch.names[i], blocks,
                                 batch.codes[i, :batch.lengths[i]].copy(),
                                 batch.quals[i], int(rec.mapq[r])))
                rows.sort(key=lambda x: (x[0], x[1]))
                on = tagged[rec.read_idx]
                pairs = np.unique(np.stack([rec.read_idx[on],
                                            rec.ref_id[on]]), axis=1)
                _, per_read = np.unique(pairs[0], return_counts=True)
            trace.count("genome.blocks", n_blocks)
            trace.count("genome.blocks_trimmed", n_trimmed)
            trace.count("genome.blocks_dropped", n_dropped)
            trace.count("genome.partner_reads", int((per_read > 1).sum()))
        parts["align_s"] += sp.seconds
        with trace.span("genome.cigar") as sp:
            done_rows = finish_rows(rows)
        parts["cigar_s"] += sp.seconds
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

    bam_path = f"{outdir}/{sample}_genome_tagged.bam"
    with trace.span("genome.write") as sp:
        with BAMWriter(bam_path, gindex.names,
                       [len(s) for s in gindex.seq_codes], index=True) as w:
            merged = heapq.merge(*[read_spill(p) for p in spills],
                                 key=lambda row: (row[0], row[1]))
            for (rid, ts, flag, name, cig, stored, squal, mq, tags) in \
                    merged:
                w.write(name, flag, rid, ts, mq, cig, stored, squal,
                        tags=tags)
                all_trns.append(tags["XT"])
        for p in spills:
            os.unlink(p)
        os.rmdir(tmpdir)
        counting.trans_counts_table(all_trns).to_csv(
            f"{outdir}/{sample}_trns_ct.csv", index=None)
    parts["write_s"] = sp.seconds
    trace.count("genome.records", n_rows)
    trace.count("genome.spliced_records", n_spliced)
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


def _tag_map_from_df(df, trns):
    """name -> (CB, UB, XT) for accepted reads; trns holds each row's
    transcript (DeconRun.transcripts), XT.

    Deliberate fix of two reference defects, both of which parse XT from
    the decon read name {qname}_{qstrt}_{qend}_{flag}_{trans}: the
    reference takes `name.split('_')[4]` (utils.py:745), which truncates
    transcript names containing '_' (the bundled panels have such names,
    e.g. `RUNX1T1-204|ENST00000422361.6_2450`), and a qname holding '_'
    (PacBio's m64012_190920_173625/.../ccs) shifts every field. The
    transcript comes from the decon record instead."""
    out = {}
    for name, bc, umi, status, t in zip(df.name, df.bc, df.umi, df.status,
                                        trns):
        if status != ACCEPT:
            continue
        out[name] = (bc, umi, t)
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
    takes the fused per-batch step when data_shards <= 1 (DeconRun);
    fast=False forces the unfused path. The run is traced (trace.py) into
    {sample}_runstats.json."""
    with trace.run():
        _run_pipeline(mode, infile, outdir, sample, trns_ref, genome_ref,
                      barcodes, xpecies, batch_size, force, wl_shards,
                      data_shards, scrub, device, fast)


def _run_pipeline(mode, infile, outdir, sample, trns_ref, genome_ref,
                  barcodes, xpecies, batch_size, force, wl_shards,
                  data_shards, scrub, device, fast):
    dev = resolve_device(device)
    spec = chemistry.get(mode)
    dflt = MODE_DEFAULTS[mode]
    trns_ref = trns_ref or os.path.join(DATA_DIR, dflt[0])
    if dflt[1] and not genome_ref:
        genome_ref = os.path.join(DATA_DIR, dflt[1])
    if dflt[2] and not barcodes:
        barcodes = os.path.join(DATA_DIR, dflt[2])
    os.makedirs(outdir, exist_ok=True)

    tele = Telemetry(mode, infile, dev, trace.active())
    with trace.span("align_decon") as st:
        # modes whose whitelist is known up front (everything but the
        # data-driven 3p10XGEX) load it and build the matcher's tables
        # first (over the mesh when sharded); a missing file is reported
        # after decon, as the JAX package does
        bcs = None
        matcher = None
        shard_tables_s = None
        wl_spans = []
        if mode not in ("RTX", "3p10XGEX"):
            with trace.span("whitelist.load") as sp:
                try:
                    bcs = _load_whitelist(barcodes, mode)
                except SystemExit:
                    bcs = None
            wl_spans.append(sp)
            if bcs is not None and len(bcs):
                with trace.span("whitelist.tables") as sp:
                    matcher = _matcher(bcs, spec, dev, wl_shards,
                                       data_shards)
                wl_spans.append(sp)
            if isinstance(matcher, ShardedMatcher):
                shard_tables_s = round(matcher.build_s, 3)
        # the stage keeps the JAX package's bounds (whitelist tables
        # included); their share rides along as whitelist_s
        whitelist_s = round(sum(sp.seconds for sp in wl_spans), 3)
        # the fused step takes the unsharded matcher on its device (its
        # exact-class pass); a mesh's matcher runs only after the stream
        run = DeconRun(spec, infile, outdir, sample, trns_ref, dev,
                       batch_size, force=force, data_shards=data_shards,
                       matcher=matcher if isinstance(matcher, BarcodeMatcher)
                       else None, fast=fast)
        run.write_eds(outdir, sample)
    phase_s = getattr(run, "phase_s", None)
    tele.stage(st, run.n_reads,
               subreads=run.n_sub, candidates=len(run.cands),
               resumed=run.resumed, whitelist_s=whitelist_s,
               shard_tables_s=shard_tables_s,
               deferred_reads=run.n_deferred or None,
               index_bytes=run.index_bytes,
               index_s=(round(run.index_s, 3) if run.index_s is not None
                        else None),
               phase_s={k: round(v, 3) for k, v in phase_s.items()}
               if phase_s else None)

    if mode == "RTX":
        with trace.span("clonotypes") as st:
            _ensure_clonotypes(mode, run.sub_path, outdir, sample, trns_ref,
                               xpecies, dev)
        tele.stage(st)
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
        with trace.span("whitelist.load"):
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
        with trace.span("whitelist.load"):
            bcs = _load_whitelist(barcodes, mode)
    if len(bcs) == 0:
        log("no whitelist barcodes — stopping after decon")
        tele.write(outdir, sample)
        return

    with trace.span("barcode_match") as st:
        df, res = match_barcodes(spec, bcs, run.cands, outdir, sample, dev,
                                 force=force, matcher=matcher,
                                 wl_shards=wl_shards,
                                 data_shards=data_shards,
                                 prematched=None if run.resumed else
                                 run.prematch)
    tele.stage(st, len(run.cands),
               accepted=int((df.status == ACCEPT).sum()),
               whitelist=int(len(bcs)))

    if mode == "5p10XGEX":
        with trace.span("dedup") as st:
            dedup_outputs(spec, df, res, outdir, sample)
        tele.stage(st)
        if genome_ref and os.path.isfile(genome_ref):
            with trace.span("genome_tag") as st:
                n_bam, parts = genome_stage(
                    spec, outdir, sample, genome_ref,
                    _tag_map_from_df(df, run.transcripts()), dev,
                    force=force)
            tele.stage(st, records=n_bam, **parts)
    elif mode in ("5p10XTCR", "3p10XTCR_nuc"):
        with trace.span("dedup") as st:
            dedup_outputs(spec, df, res, outdir, sample,
                          knee_umi_name="knee_UMI")
        tele.stage(st)
        with trace.span("clonotypes") as st:
            if _ensure_clonotypes(mode, run.sub_path, outdir, sample,
                                  trns_ref, xpecies, dev):
                with trace.span("vdj.exports"):
                    _, cloneID = clone_stage.clone_filt_5p10X(sample, outdir)
                    acc = df[df.status == ACCEPT]
                    clone_stage.clone_bcumi_join(
                        cloneID, acc.name.tolist(), acc.bc.to_numpy(),
                        acc.umi.tolist(),
                        f"{outdir}/{sample}_clone_bcumi.csv.gz")
        tele.stage(st)
    elif mode in ("3pXCR_slideseq", "3p10XTCR"):
        with trace.span("clonotypes") as st:
            if _ensure_clonotypes(mode, run.sub_path, outdir, sample,
                                  trns_ref, xpecies, dev):
                with trace.span("vdj.exports"):
                    _, cloneID = clone_stage.clone_filt_slideseq(sample,
                                                                 outdir)
                    acc = df[df.status == ACCEPT]
                    clone_stage.clone_bcumi_join(
                        cloneID, acc.name.tolist(), acc.bc.to_numpy(),
                        acc.umi.tolist(),
                        f"{outdir}/{sample}_clone_bcumi.csv.gz",
                        clone_first=True)
        tele.stage(st)
    elif mode == "3p10XGEX":
        with trace.span("count_matrix") as st:
            acc = df[df.status == ACCEPT]
            umi_codes = res["umi"][(df.status == ACCEPT).to_numpy()]
            # the transcript of each accepted candidate's decon record:
            # the reference parses it from the name after '/ccs_'
            # (utils.py:1483-1486), which a qname holding '_' there shifts
            all_trns = run.transcripts()
            trns = [all_trns[i] for i in
                    np.flatnonzero((df.status == ACCEPT).to_numpy())]
            trns = [t.split("|")[-1].split("_")[0] if "|" in t else t
                    for t in trns]                      # utils.py:1485-1486
            with gzip.open(f"{outdir}/{sample}_quads.json.gz", "wt") as f:
                json.dump(counting.quads_dict(acc.bc.to_numpy(), umi_codes,
                                              trns), f)
            genes, cells, cnts = counting.count_matrix(
                acc.bc.to_numpy(), umi_codes, np.asarray(trns, dtype=object))
            counting.write_mtx(f"{outdir}/{sample}", genes, cells, cnts)
            log(f"count matrix: {len(genes)} genes × {len(cells)} cells, "
                f"{len(cnts)} nonzeros")
        tele.stage(st, genes=len(genes), cells=len(cells))
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
