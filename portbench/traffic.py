"""The one traffic generator: seeded samples tiled from a bundled fastq.

A cell's traffic file (`portbench/workloads/<cell>.json`) names a source
fastq and how many reads a sample holds. Every sample of a run is built
the same way: the source reads are repeated until the sample holds
`reads_per_sample` reads, each copy's name prefixed `t<k>_` where a sample
holds more than one copy of the source (a sample of at most the source's
reads keeps its names), and the seed sets the order of the reads and
which of them are reverse-complemented (sequence reverse-complemented,
quality reversed). Every seed therefore gives the same multiset of read
lengths and the same work, in another order and orientation.

The warm-up sample takes reads of every length bucket of the fused step
(at most 1024, 2048 and 4096 bases, and longer ones, which the reader cuts
to 4096), so that every shape the window uses is built before it.

Plain Python and NumPy: nothing of the program is imported here.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

_RC = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")

# the fused step's read-length buckets (reads longer than the last are cut
# to it by the reader)
BUCKET_EDGES = (1024, 2048, 4096)


def read_fastq(path: str) -> list:
    """[(name, seq, qual)] of a fastq(.gz), name without '@' and without
    anything after the first whitespace."""
    opener = gzip.open if path.endswith(".gz") else open
    out = []
    with opener(path, "rb") as f:
        lines = f.read().split(b"\n")
    for i in range(0, len(lines) - 3, 4):
        if not lines[i].startswith(b"@"):
            continue
        name = lines[i][1:].split()[0]
        out.append((name.decode(), lines[i + 1].strip(),
                    lines[i + 3].strip()))
    return out


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_RC)[::-1]


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for (seed, stream); any whole seed, however
    large, maps to its own stream."""
    return np.random.default_rng([int(seed) % (1 << 64), int(stream)])


def tiled_reads(src: list, n_reads: int, rng: np.random.Generator) -> list:
    """n_reads reads tiled from src (t<k>_ names where src is repeated):
    the first n_reads of src repeated, the same reads for every seed,
    shuffled, each reverse-complemented with probability one half."""
    n_src = len(src)
    reps = -(-n_reads // n_src)
    order = rng.permutation(n_reads)
    flip = rng.random(n_reads) < 0.5
    out = []
    for j, o in enumerate(order):
        k, i = divmod(int(o), n_src)
        name, seq, qual = src[i]
        if flip[j]:
            seq, qual = revcomp(seq), qual[::-1]
        out.append((f"t{k}_{name}" if reps > 1 else name, seq, qual))
    return out


def warmup_reads(src: list, per_bucket: list, rng: np.random.Generator
                 ) -> list:
    """per_bucket[b] reads of each length bucket, (0, 1024], (1024, 2048],
    (2048, 4096] and longer, drawn from src without replacement,
    shuffled."""
    lens = np.asarray([len(s) for _, s, _ in src])
    edges = (0,) + BUCKET_EDGES + (1 << 62,)
    picked = []
    for b, n in enumerate(per_bucket):
        pool = np.where((lens > edges[b]) & (lens <= edges[b + 1]))[0]
        take = rng.permutation(pool)[:n]
        picked.extend(int(i) for i in take)
    picked = [picked[i] for i in rng.permutation(len(picked))]
    return [(f"w_{src[i][0]}", src[i][1], src[i][2]) for i in picked]


def write_fastq(reads: list, path: str) -> None:
    tmp = path + ".tmp"
    with gzip.open(tmp, "wb", compresslevel=1) as g:
        g.write(b"".join(b"@%s\n%s\n+\n%s\n" % (n.encode(), s, q)
                         for n, s, q in reads))
    os.replace(tmp, path)


def make_samples(root: str, workload: dict, seed: int, out_dir: str) -> dict:
    """Write the run's warm-up sample and its pool of samples under
    out_dir. Returns ({"warmup": path, "pool": [path, ...]}, {path: the
    sample's reads}), the reads kept for the check after the window."""
    src = read_fastq(os.path.join(root, workload["sample"]))
    os.makedirs(out_dir, exist_ok=True)
    wpath = os.path.join(out_dir, "warmup.fastq.gz")
    write_fastq(warmup_reads(src, workload["warmup_per_bucket"],
                             seed_rng(seed, 0)), wpath)
    pool, reads = [], {}
    for j in range(workload["pool"]):
        path = os.path.join(out_dir, f"sample{j}.fastq.gz")
        rs = tiled_reads(src, workload["reads_per_sample"],
                         seed_rng(seed, 1 + j))
        write_fastq(rs, path)
        pool.append(path)
        reads[path] = rs
    return {"warmup": wpath, "pool": pool}, reads
