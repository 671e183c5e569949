"""Exon-overlap extraction: reads overlapping listed exons →
[sample, gene, exon, ref_start, ref_end, query_length, bc, umi, overlap,
length] CSV.

Port of reference scripts/downstream/isoforms.py. Exon file rows:
GENE,exonN,chrom,start,end  (1-based inclusive like the reference).

Usage:
    python -m nanoranger_torch.downstream.isoforms --bam X.bam --sample S \
        --exons exons.csv [--output out.csv]

A copy of the JAX package's downstream/isoforms.py (host code).
"""

import argparse
import csv

import pandas as pd

from ..io.bam import read_bam


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--bam", type=str, required=True)
    p.add_argument("--sample", type=str, required=True)
    p.add_argument("--exons", type=str, required=True)
    p.add_argument("--output", type=str, default="none")
    a = p.parse_args(argv)

    exons = []
    with open(a.exons, newline="") as f:
        for line in csv.reader(f):
            if len(line) >= 5:
                exons.append((line[0], line[1], line[2],
                              int(line[3]), int(line[4])))

    rows = []
    for gene, exon, chrom, start, end in exons:
        ref_names, _, records = read_bam(a.bam)
        try:
            rid = ref_names.index(chrom)
        except ValueError:
            continue
        for r in records:
            if r.ref_id != rid or r.flag & 0x904:
                continue
            if r.reference_end <= start or r.pos >= end:
                continue
            rows.append([a.sample, gene, exon, r.pos, r.reference_end,
                         r.query_alignment_length, len(r.seq),
                         r.tags.get("CB", ""), r.tags.get("UB", ""),
                         r.overlap(start, end), end - start])

    df = pd.DataFrame(rows, columns=["sample", "gene", "exon", "ref_start",
                                     "ref_end", "query_length",
                                     "read_length", "bc", "umi", "overlap",
                                     "length"])
    if a.output != "none":
        df[["sample", "gene", "exon", "ref_start", "ref_end",
            "query_length", "bc", "umi", "overlap", "length"]].to_csv(
            a.output, index=None)
    else:
        print(df.to_string())


if __name__ == "__main__":
    main()
