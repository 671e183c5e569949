"""Per-mutation single-base pileup from the tagged BAM:
[bc, umi, base, Q, indel] rows per covering read.

Port of reference scripts/downstream/perform_pileup.py (pysam pileup
replaced by CIGAR walking; the reference's hg19→hg38 LiftOver import was
unused in the emission path). Mutations file: CSV with index = sample and
columns gene, chr, pos (1-based, like the reference's muts.pos).

Usage:
    python -m nanoranger_torch.downstream.pileup --outdir O --mutations M.csv \
        --bam X.bam --sample S

A copy of the JAX package's downstream/pileup.py (host code).
"""

import argparse
import csv
import gzip
import os

import pandas as pd

from ..io.bam import read_bam


def pileup_at(bam_path: str, chrom: str, pos0: int):
    """Rows [bc, umi, base, Q, indel] for reads with a non-deleted base
    aligned at 0-based position pos0 of chrom."""
    ref_names, _, records = read_bam(bam_path)
    try:
        rid = ref_names.index(chrom)
    except ValueError:
        return []
    rows = []
    for r in records:
        if r.ref_id != rid or r.flag & 0x904:
            continue
        if not (r.pos <= pos0 < r.reference_end):
            continue
        q, indel = r.query_pos_at(pos0)
        if q is None:                       # deletion/refskip at the column
            continue
        rows.append([r.tags.get("CB", ""), r.tags.get("UB", ""),
                     r.seq[q], r.qual[q], indel])
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--mutations", type=str, required=True)
    p.add_argument("--bam", type=str, required=True)
    p.add_argument("--sample", type=str, required=True)
    a = p.parse_args(argv)

    muts = pd.read_csv(a.mutations, index_col=0)
    muts = muts.loc[a.sample]
    if isinstance(muts, pd.Series):
        muts = pd.DataFrame(muts).T
    os.makedirs(a.outdir, exist_ok=True)
    for _, m in muts.iterrows():
        rows = pileup_at(a.bam, str(m["chr"]), int(m["pos"]) - 1)
        out = f"{a.outdir}/{a.sample}_pileup_{m['gene']}.csv.gz"
        with gzip.open(out, "wt", newline="") as f:
            w = csv.writer(f)
            w.writerow(["bc", "umi", "base", "Q", "indel"])
            w.writerows(rows)
        print(f"{m['gene']}: coverage {len(rows)} → {out}")


if __name__ == "__main__":
    main()
