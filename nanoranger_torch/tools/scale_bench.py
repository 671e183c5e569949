"""Transcriptome-scale run of the port on one card.

Counterpart of the JAX package's tools/scale_bench.py, with its flags,
defaults and generators: the same seed (11) draws the same synthetic
whole-transcriptome reference (--mb megabases over --n-refs transcripts),
the same product-structured whitelist of --n-wl rows (n1 x n2 distinct
8-base halves, like 10x's 737K and 3M lists) and the same --reads reads
with known barcodes at 5% error, byte for byte. It times the minimizer
index build (align/index.PanelIndex.from_fasta), runs the 5p10XGEX
pipeline on the default fused path (decon, the whitelist match, dedup; no
genome), and reports the accuracy of the accepted barcodes against the
truth, with the JAX tool's result keys.

Beside them it reports what the card holds and does: its name and power
limit (nvidia-smi), its peak allocated memory over the pipeline run, the
bytes of the index tables the run put on it (prepare_index_arrays' prefix
tables and occurrence windows), the seconds of the whitelist tables and
the kernel launches of the run (kernels.launches).

Usage:
  python -m nanoranger_torch.tools.scale_bench [--mb 160] [--n-refs 4000] \
      [--n-wl 1000000] [--reads 20000] [--device cuda|cpu] [--out R.json] \
      [--keep]

Prints the result as one line `[scale] {json}` and writes it to --out when
given. The temporary work directory is removed afterwards unless --keep.
"""

from __future__ import annotations

import argparse
import gzip
import json
import resource
import shutil
import subprocess
import tempfile
import time

import numpy as np
import pandas as pd
import torch

from .. import kernels
from ..align.index import PanelIndex
from ..io import fasta
from ..pipeline import resolve_device, run_pipeline

BASES = np.frombuffer(b"ACGT", np.uint8)
SEED = 11
SAMPLE = "sc"
# the JAX tool's defaults: 160 Mb over 4,000 transcripts, 1M rows, 20,000
# reads
DEFAULTS = {"mb": 160, "n_refs": 4_000, "n_wl": 1_000_000, "reads": 20_000}


def gen_transcriptome(path: str, total_mb: int, n_refs: int, rng):
    per = (total_mb * 1_000_000) // n_refs
    with open(path, "w") as f:
        for i in range(n_refs):
            seq = BASES[rng.integers(0, 4, per)].tobytes().decode()
            f.write(f">tx{i}\n")
            for j in range(0, len(seq), 120):
                f.write(seq[j:j + 120] + "\n")
    return per


def gen_whitelist(path: str, n: int, rng):
    """Product-structured list: the first n of n1 x n2 distinct 8-base
    halves, sorted, n1 = ceil(sqrt(n))."""
    n1 = int(np.ceil(np.sqrt(n)))
    n2 = -(-n // n1)
    h1 = set()
    while len(h1) < n1:
        h1.add(BASES[rng.integers(0, 4, 8)].tobytes().decode())
    h2 = set()
    while len(h2) < n2:
        h2.add(BASES[rng.integers(0, 4, 8)].tobytes().decode())
    h1, h2 = sorted(h1), sorted(h2)
    bcs = [a + b for a in h1 for b in h2][:n]
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write("\n".join(bcs) + "\n")
    return np.asarray(bcs)


def noisy(seq: str, rng, err=0.05):
    out = []
    for ch in seq:
        r = rng.random()
        if r < err * 0.35:
            continue                                   # deletion
        if r < err * 0.7:
            out.append("ACGT"[rng.integers(0, 4)])     # substitution
            continue
        out.append(ch)
        if r < err:
            out.append("ACGT"[rng.integers(0, 4)])     # insertion
    return "".join(out)


def gen_reads(path: str, tx_path: str, bcs, n_reads: int, rng):
    """5' reads (adapter, barcode, UMI, TSO, then a transcript span of
    600-2000 bases) with 5% error; returns each read's true barcode."""
    names, seqs = fasta.read_fasta_encoded(tx_path)
    truth = []
    with gzip.open(path, "wt", compresslevel=1) as f:
        for i in range(n_reads):
            tx = rng.integers(0, len(seqs))
            L = int(rng.integers(600, 2000))
            lo = int(rng.integers(0, max(1, len(seqs[tx]) - L)))
            body = BASES[np.asarray(seqs[tx][lo:lo + L]) % 4] \
                .tobytes().decode()
            bc = bcs[rng.integers(0, len(bcs))]
            umi = BASES[rng.integers(0, 4, 10)].tobytes().decode()
            read = noisy("CGCTCTTCCGATCT" + bc + umi + "TTTCTTATATG"
                         + body, rng)
            truth.append(bc)
            f.write(f"@sr{i}\n{read}\n+\n{'I' * len(read)}\n")
    return truth


def synthesize(d: str, mb: int, n_refs: int, n_wl: int, reads: int,
               seed: int = SEED):
    """txome.fa, wl.txt.gz and reads.fastq.gz in `d`, drawn from one
    generator in the JAX tool's order. Returns (barcodes, truth)."""
    rng = np.random.default_rng(seed)
    gen_transcriptome(f"{d}/txome.fa", mb, n_refs, rng)
    bcs = gen_whitelist(f"{d}/wl.txt.gz", n_wl, rng)
    truth = gen_reads(f"{d}/reads.fastq.gz", f"{d}/txome.fa", bcs, reads,
                      rng)
    return bcs, truth


def truth_counts(outdir: str, truth) -> tuple[int, int, int]:
    """(assignment rows, accepted rows, accepted rows whose barcode is the
    read's true one), counted as the JAX tool counts them."""
    df = pd.read_csv(f"{outdir}/{SAMPLE}_assignments.csv.gz",
                     keep_default_na=False)
    acc = df[df.status == 0]
    idx_of = {f"sr{i}": t for i, t in enumerate(truth)}
    n_ok = sum(1 for nm, bc in zip(acc.name, acc.bc)
               if idx_of.get(nm.split("_")[0]) == bc)
    return len(df), len(acc), n_ok


def card_line() -> str | None:
    """`name, power.limit` of the first card as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0].strip() if out.strip() else None


def measure(d: str, truth, mb: int, n_refs: int, n_wl: int,
            device="cuda", batch_size: int = 512) -> dict:
    """Index build, then the 5p10XGEX pipeline on `device` over the files
    synthesize() wrote in `d`, into d/out. Returns the result dict."""
    dev = resolve_device(device)
    t0 = time.time()
    index = PanelIndex.from_fasta(f"{d}/txome.fa")
    t_index = time.time() - t0
    n_anchors = len(index.hashes)
    del index

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.time()
    run_pipeline("5p10XGEX", f"{d}/reads.fastq.gz", f"{d}/out", SAMPLE,
                 trns_ref=f"{d}/txome.fa", genome_ref="/nonexistent",
                 barcodes=f"{d}/wl.txt.gz", batch_size=batch_size,
                 device=dev)
    wall = time.time() - t0
    launches = dict(kernels.launches)
    peak_card = (torch.cuda.max_memory_allocated(dev)
                 if dev.type == "cuda" else None)
    with open(f"{d}/out/{SAMPLE}_runstats.json") as f:
        rs = json.load(f)
    n_rows, n_acc, n_ok = truth_counts(f"{d}/out", truth)
    n_reads = len(truth)
    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    s0 = rs["stages"][0]
    return {
        "transcriptome_mb": mb, "n_refs": n_refs,
        "n_minimizers": int(n_anchors), "index_build_s": round(t_index, 1),
        "whitelist": int(n_wl), "reads": n_reads,
        "wall_s": round(wall, 1),
        "reads_per_s": round(n_reads / wall, 1),
        "steady_reads_per_s": s0.get("steady_reads_per_s"),
        "accepted": int(n_acc),
        "accept_rate": round(n_acc / max(n_rows, 1), 3),
        "bc_accuracy_of_accepted": round(n_ok / max(n_acc, 1), 4),
        "peak_rss_gb": round(peak_rss_gb, 2),
        "stages": rs["stages"],
        "device": str(dev),
        "card": card_line() if dev.type == "cuda" else None,
        "card_peak_gb": (round(peak_card / 1e9, 3)
                         if peak_card is not None else None),
        "index_table_gb": round(s0["index_bytes"] / 1e9, 3),
        "whitelist_tables_s": s0.get("whitelist_s"),
        "launches": launches,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nanoranger-torch scale_bench",
                                 description=__doc__.split("\n\n")[0])
    for k, v in DEFAULTS.items():
        ap.add_argument(f"--{k.replace('_', '-')}", type=int, default=v)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="write the result JSON here")
    a = ap.parse_args(argv)
    resolve_device(a.device)          # fail before the synthesis, not after
    d = tempfile.mkdtemp(prefix="nr_scale_")
    print(f"[scale] workdir {d}", flush=True)
    try:
        t0 = time.time()
        bcs, truth = synthesize(d, a.mb, a.n_refs, a.n_wl, a.reads)
        t_gen = time.time() - t0
        print(f"[scale] synthesized {a.mb} Mb / {len(bcs)} barcodes / "
              f"{a.reads} reads in {t_gen:.0f}s", flush=True)
        out = measure(d, truth, a.mb, a.n_refs, len(bcs), a.device)
        out["synthesize_s"] = round(t_gen, 1)
        print(f"[scale] index: {out['n_minimizers'] / 1e6:.1f}M minimizers "
              f"in {out['index_build_s']:.0f}s", flush=True)
        print("[scale] " + json.dumps(out), flush=True)
        if a.out:
            with open(a.out, "w") as f:
                json.dump(out, f, indent=1)
    finally:
        if not a.keep:
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
