"""Fusion/WT classification dump: per tagged-BAM read emit
[ref_start, ref_end, ref_name, query_length, read_length, BC, UMI] → CSV.

Port of reference scripts/downstream/fusion_gene.py (pysam-free; reads our
BAM via io/bam.py). Usage:
    python -m nanoranger_torch.downstream.fusion_gene --bam X.bam --output Y.csv

A copy of the JAX package's downstream/fusion_gene.py (host code).
"""

import argparse

import pandas as pd

from ..io.bam import read_bam


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--bam", type=str, required=True)
    p.add_argument("--output", type=str, required=True)
    a = p.parse_args(argv)

    ref_names, _, records = read_bam(a.bam)
    rows = []
    for r in records:
        rows.append([r.pos, r.reference_end, ref_names[r.ref_id],
                     r.query_alignment_length, len(r.seq),
                     r.tags.get("CB", ""), r.tags.get("UB", "")])
    df = pd.DataFrame(rows, columns=["ref_start", "ref_end", "ref_name",
                                     "query_length", "read_length",
                                     "BC", "UMI"])
    df.to_csv(a.output, index=None)
    print(f"{len(df)} tagged alignments → {a.output}")


if __name__ == "__main__":
    main()
