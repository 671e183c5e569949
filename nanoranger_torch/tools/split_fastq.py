"""Record-count fastq sharding for multi-host launches.

Replaces the reference's `seqkit split2 -p N` (reference
pipeline.py:76-151) for multi-host data parallelism: host k processes
part k of H. Records are dealt in contiguous runs (part k gets records
[k*ceil(N/H), (k+1)*ceil(N/H))), so `cat part_1 .. part_H` reproduces the
input order — the deterministic merge property the reference gets from
sorted() shard lists (pipeline.py:164-170).

Usage: python -m nanoranger_torch.tools.split_fastq reads.fastq.gz H [outdir]
Writes <stem>.part_<k>.fastq.gz for k in 1..H.
"""

from __future__ import annotations

import os
import sys

from ..io.fastq import FastqWriter, iter_fastq


def split_fastq(path: str, n_parts: int, outdir: str | None = None) -> list:
    records = list(iter_fastq(path))
    n = len(records)
    per = -(-n // n_parts) if n else 0
    stem = os.path.basename(path)
    for suf in (".fastq.gz", ".fq.gz", ".fastq", ".fq"):
        if stem.endswith(suf):
            stem = stem[: -len(suf)]
            break
    outdir = outdir or (os.path.dirname(os.path.abspath(path)))
    outs = []
    for k in range(n_parts):
        dst = os.path.join(outdir, f"{stem}.part_{k + 1}.fastq.gz")
        with FastqWriter(dst) as w:
            for r in records[k * per:(k + 1) * per]:
                w.write(r.name, r.seq, r.qual)
        outs.append(dst)
    return outs


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) not in (2, 3):
        raise SystemExit("usage: split_fastq <reads.fastq[.gz]> <n_parts> "
                         "[outdir]")
    outs = split_fastq(argv[0], int(argv[1]),
                       argv[2] if len(argv) == 3 else None)
    for p in outs:
        print(p)


if __name__ == "__main__":
    main()
