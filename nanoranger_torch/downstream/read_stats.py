"""Run-QC stats collector: per-read [len, meanQ, read#, channel, Δt] CSV
from a directory of ONT fastq.gz files.

Port of reference scripts/store_nanopore_stats.py (pysam FastxFile and the
ProcessPoolExecutor+cat shard merge replaced by a streamed scan; both
header layouts supported via --dev_basecall).

Usage:
    python -m nanoranger_torch.downstream.read_stats --indir DIR \
        --start_time "2024-05-20 22:09:00" --out_file stats.csv \
        [--dev_basecall] [--total_reads 50000]

A copy of the JAX package's downstream/read_stats.py (host code).
"""

import argparse
import csv
import glob
import gzip
from datetime import datetime

import numpy as np


def _iter_fastq_with_comment(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        while True:
            h = f.readline()
            if not h:
                return
            seq = f.readline().rstrip("\n")
            f.readline()
            qual = f.readline().rstrip("\n")
            parts = h.rstrip("\n").split(" ")
            yield seq, qual, parts[1:]


def process_fastq(path, t_ref, dev_basecall, total_reads, writer):
    n = 0
    for seq, qual, comms in _iter_fastq_with_comment(path):
        n += 1
        try:
            if dev_basecall:
                r_num = int(comms[1].split("=")[1])
                ch_num = int(comms[2].split("=")[1])
                t_read = datetime.strptime(
                    comms[3].split("=")[1].split(".")[0],
                    "%Y-%m-%dT%H:%M:%S")
            else:
                r_num = int(comms[2].split("=")[1])
                ch_num = int(comms[3].split("=")[1])
                t_read = datetime.strptime(
                    comms[4].split("=")[1], "%Y-%m-%dT%H:%M:%SZ")
        except (IndexError, ValueError):
            continue
        dt = (t_read - t_ref).total_seconds()
        mean_q = float(np.mean(np.frombuffer(qual.encode(), np.uint8))) - 33
        writer.writerow([len(seq), mean_q, r_num, ch_num, dt])
        if n > total_reads:
            break
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--indir", type=str, required=True)
    p.add_argument("--start_time", type=str, required=True,
                   help='run start, e.g. "2024-05-20 22:09:00"')
    p.add_argument("--out_file", type=str, required=True)
    p.add_argument("--dev_basecall", action="store_true")
    p.add_argument("--total_reads", type=int, default=10**9)
    a = p.parse_args(argv)

    t_ref = datetime.strptime(a.start_time, "%Y-%m-%d %H:%M:%S")
    files = sorted(glob.glob(f"{a.indir}/*.fastq.gz") +
                   glob.glob(f"{a.indir}/*.fastq"))
    total = 0
    with open(a.out_file, "w", newline="") as f:
        w = csv.writer(f)
        for path in files:
            total += process_fastq(path, t_ref, a.dev_basecall,
                                   a.total_reads, w)
    print(f"{total} reads from {len(files)} files → {a.out_file}")


if __name__ == "__main__":
    main()
