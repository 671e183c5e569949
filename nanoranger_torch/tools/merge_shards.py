"""Merge per-shard pipeline outputs into one sample's artifact set.

The multi-host recipe runs one pipeline process per host on one fastq
shard (tools/split_fastq.py), each writing into its own outdir. This tool
is the reduce step — the analogue of the reference's shard merges: `cat`
of shard text outputs (reference pipeline.py:183-190) and JSON dict-sum
(reference utils.py:1419-1431).

Strategy: merge the STREAMED artifacts (subread fastq, BCUMI fasta,
assignment table, per-shard counters, eds stats, tagged BAM) in task
order, then re-run the pipeline tail on the merged outdir through its
tested resume path — every derived artifact (dedup table, knee plots,
score histograms, clone tables, count matrix) is recomputed by the same
code that produces it in an unsharded run, so merged == unsharded by
construction (tested in tests/test_torch_sharded.py).

Clone tables are global (clonotype clustering sees all reads), so TCR
modes re-call clonotypes on the merged subreads rather than merging
per-shard clone tables — per-shard cluster numbering has no global
meaning. The genome-tagged BAM IS merged (coordinate k-way merge with
shard-order tie-break, reproducing the unsharded spill-merge order)
so the per-host alignment work is preserved.

Usage:
  python -m nanoranger_torch.tools.merge_shards --mode M --outdir OUT \
      --expname S [--barcodes WL] [--trns_ref T] [--genome_ref G] \
      [--device cuda|cpu] SHARD_OUTDIR1 SHARD_OUTDIR2 ...

The pipeline tail runs on --device (default cuda; it reads the merged
checkpoints, so it matches no barcode but builds the matcher's tables).

Shard outdirs must be given in task order (shard k of split_fastq.py
k-th) and each must contain a completed run of the SAME sample name.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import shutil
import sys

import numpy as np
import pandas as pd


def _log(msg):
    print(f"[nanoranger-torch merge] {msg}", flush=True)


def _cat_gz(srcs: list, dst: str):
    """Byte-concatenate gzip members (a valid gzip stream; the reference
    does the same with `cat` of pigz outputs, pipeline.py:183-190)."""
    tmp = dst + ".tmp"
    with open(tmp, "wb") as out:
        for s in srcs:
            with open(s, "rb") as f:
                shutil.copyfileobj(f, out)
    os.replace(tmp, dst)


def _concat_csv(srcs: list, dst: str, **read_kw):
    frames = [pd.read_csv(s, **read_kw) for s in srcs]
    df = pd.concat(frames, ignore_index=True)
    tmp = dst + ".tmp"
    df.to_csv(tmp, index=False,
              compression="gzip" if dst.endswith(".gz") else None)
    os.replace(tmp, dst)
    return df


def _sum_json_counts(srcs: list, dst: str):
    """Dict-sum merge of count JSONs (reference utils.py:1419-1431)."""
    total: dict = {}
    for s in srcs:
        with open(s) as f:
            for k, v in json.load(f).items():
                total[k] = total.get(k, 0) + int(v)
    tmp = dst + ".tmp"
    with open(tmp, "w") as f:
        json.dump(total, f)
    os.replace(tmp, dst)
    return total


def _merge_bams(srcs: list, dst: str):
    """Coordinate k-way merge of per-shard tagged BAMs. Tie-break by shard
    order: the unsharded genome stage's heap merge is stable on equal
    (ref_id, pos), resolving ties in input order — which IS shard order
    after split_fastq's contiguous dealing."""
    import heapq

    from ..io.bam import BAMWriter, read_bam
    from ..io.encode import encode

    streams = []
    names0 = lens0 = None

    def keyed(recs, k):
        for i, r in enumerate(recs):
            yield (r.ref_id, r.pos, k, i, r)

    for k, s in enumerate(srcs):
        names, lens, recs = read_bam(s)
        if names0 is None:
            names0, lens0 = names, lens
        elif names != names0:
            raise SystemExit(f"shard BAM {s} has a different reference set")
        streams.append(keyed(recs, k))
    n = 0
    with BAMWriter(dst, names0, lens0, index=True) as w:
        for (rid, pos, _k, _i, r) in heapq.merge(*streams):
            qual = bytes(min(93, q) + 33 for q in r.qual)
            w.write(r.name, r.flag, rid, pos, r.mapq, r.cigar,
                    encode(r.seq), qual, tags=r.tags)
            n += 1
    return n


def merge_shards(mode: str, shard_dirs: list, outdir: str, sample: str,
                 trns_ref=None, genome_ref=None, barcodes=None,
                 xpecies=None, device="cuda") -> None:
    from .. import chemistry
    from ..pipeline import run_pipeline

    spec = chemistry.get(mode)
    os.makedirs(outdir, exist_ok=True)
    sub_kind = "VDJ" if mode in ("3pXCR_slideseq", "3p10XTCR",
                                 "3p10XTCR_nuc") else "deconcat"

    def shard_paths(suffix):
        ps = [os.path.join(d, f"{sample}{suffix}") for d in shard_dirs]
        missing = [p for p in ps if not os.path.isfile(p)]
        if missing:
            raise SystemExit(f"missing shard artifact(s): {missing}")
        return ps

    def have_all(suffix):
        return all(os.path.isfile(os.path.join(d, f"{sample}{suffix}"))
                   for d in shard_dirs)

    # --- streamed primary artifacts: concat in task order
    _cat_gz(shard_paths(f"_{sub_kind}.fastq.gz"),
            f"{outdir}/{sample}_{sub_kind}.fastq.gz")
    _cat_gz(shard_paths("_BCUMI.fasta.gz"),
            f"{outdir}/{sample}_BCUMI.fasta.gz")
    _log(f"subreads + BC-UMI candidates concatenated from "
         f"{len(shard_dirs)} shards")

    # --- per-mode decon stats artifacts (DeconRun.write_eds shapes)
    if mode == "5p10XTCR":
        df = pd.concat([pd.read_csv(p, index_col=0) for p in
                        shard_paths("_eds.csv")], ignore_index=True)
        df.to_csv(f"{outdir}/{sample}_eds.csv")
    elif mode == "3p10XTCR":
        tot: dict = {}
        for p in shard_paths("_eds.csv"):
            d = pd.read_csv(p, index_col=0)
            for v, c in zip(d.iloc[:, 0], d.iloc[:, 1]):
                tot[v] = tot.get(v, 0) + int(c)
        pd.DataFrame({0: list(tot), 1: list(tot.values())}).sort_values(
            1, ascending=False).to_csv(f"{outdir}/{sample}_eds.csv")
    elif mode == "3pXCR_slideseq":
        _concat_csv(shard_paths("_eds_names.csv.gz"),
                    f"{outdir}/{sample}_eds_names.csv.gz")
        _cat_gz(shard_paths("_polyA.fasta.gz"),
                f"{outdir}/{sample}_polyA.fasta.gz")

    # --- 3p10XGEX raw barcode counters (dict-sum, utils.py:1419-1431)
    if mode == "3p10XGEX":
        total = _sum_json_counts(shard_paths("_bc_count.json"),
                                 f"{outdir}/{sample}_bc_count.json")
        s = pd.Series(total, name="read_count")
        tmp = f"{outdir}/{sample}_bc_read_count.csv.tmp"
        s.to_csv(tmp)
        os.replace(tmp, f"{outdir}/{sample}_bc_read_count.csv")

    # --- assignment tables: concat + fresh fingerprint so the pipeline
    # tail resumes from them instead of re-matching
    if have_all("_assignments.csv.gz"):
        df = _concat_csv(shard_paths("_assignments.csv.gz"),
                         f"{outdir}/{sample}_assignments.csv.gz",
                         keep_default_na=False,
                         dtype={"name": str, "bc": str, "umi": str})
        metas = []
        for d in shard_dirs:
            mp = os.path.join(d, f"{sample}_assignments.csv.gz.meta.json")
            if os.path.isfile(mp):
                with open(mp) as f:
                    metas.append(json.load(f))
        if metas and all(m["spec"] == metas[0]["spec"] and
                         m["n_whitelist"] == metas[0]["n_whitelist"]
                         for m in metas):
            from ..io.candidate_store import CandidateStore
            from ..pipeline import _match_fingerprint
            names = df.name.tolist()
            fp = _match_fingerprint(
                spec, np.zeros(metas[0]["n_whitelist"]),
                CandidateStore.from_lists(names, names))
            tmp = f"{outdir}/{sample}_assignments.csv.gz.meta.json.tmp"
            with open(tmp, "w") as f:
                json.dump(fp, f)
            os.replace(tmp,
                       f"{outdir}/{sample}_assignments.csv.gz.meta.json")
            _log(f"assignments merged: {len(df)} rows")

    # --- genome-tagged BAM: preserve per-host alignment work
    if have_all("_genome_tagged.bam"):
        n = _merge_bams(shard_paths("_genome_tagged.bam"),
                        f"{outdir}/{sample}_genome_tagged.bam")
        _log(f"tagged BAM merged: {n} records")
        # trns_ct: sum counts, then apply the exact construction of
        # counting.trans_counts_table (values ascending, then the same
        # sort_values call) so the merged csv is byte-identical
        tot2: dict = {}
        for p in shard_paths("_trns_ct.csv"):
            d = pd.read_csv(p)
            for t, c in zip(d.iloc[:, 0], d.iloc[:, 1]):
                tot2[t] = tot2.get(t, 0) + int(c)
        ks = sorted(tot2)
        df2 = pd.DataFrame({0: np.asarray(ks, dtype=object),
                            1: np.asarray([tot2[k] for k in ks], int)})
        df2 = df2.sort_values(1, ascending=False).reset_index(drop=True)
        df2.to_csv(f"{outdir}/{sample}_trns_ct.csv", index=None)

    # --- derived artifacts: run the pipeline tail through its resume path
    # (decon + match checkpoints above are picked up; dedup/knee/scores/
    # clones/count-matrix are recomputed by the production code)
    _log("running pipeline tail on merged artifacts")
    run_pipeline(mode, os.devnull, outdir, sample, trns_ref=trns_ref,
                 genome_ref=genome_ref, barcodes=barcodes, xpecies=xpecies,
                 device=device)
    _log("merge complete")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="nanoranger-torch merge_shards",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--expname", required=True)
    p.add_argument("--trns_ref")
    p.add_argument("--genome_ref")
    p.add_argument("--barcodes")
    p.add_argument("--xpecies")
    p.add_argument("--device", default="cuda")
    p.add_argument("shards", nargs="+",
                   help="per-shard outdirs in task order (glob ok)")
    a = p.parse_args(argv)
    dirs: list = []
    for s in a.shards:
        hit = sorted(glob.glob(s)) if any(c in s for c in "*?[") else [s]
        dirs.extend(hit)
    if len(dirs) < 2:
        raise SystemExit("need at least two shard outdirs")
    merge_shards(a.mode, dirs, a.outdir, a.expname, a.trns_ref,
                 a.genome_ref, a.barcodes, a.xpecies, a.device)


if __name__ == "__main__":
    main()
