"""The other modes of the PyTorch port end to end on the CPU.

nanoranger_torch.pipeline.run_pipeline(device="cpu") against the JAX
package's streamed (unfused) run on the same input: every artifact must be
byte-identical after gunzip (pdfs and run statistics aside). Inputs are
short prefixes of the bundled samples with reduced whitelists written here
(seeded rows of the bundled list plus every barcode the prefix carries: the
plain one-vs-all DP against a full list is too heavy for a CPU test), and
the synthetic 3' reads of tests/test_3pgex_e2e.py. The accepted pairs of the two
barcoded sample runs are then rescored over the full padded row, as
chip_smoke.py does on the card with the full-row kernel: banded == full,
and the UMI cut at the full-row position is the table's."""

import gzip
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from nanoranger_tpu.pipeline import run_pipeline as jax_run_pipeline

import chip_smoke
from nanoranger_torch import chemistry, pipeline
from nanoranger_torch.chemistry import SLIDESEQ_LINKER, TRUSEQ
from nanoranger_torch.io import whitelist

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
TCR3 = os.path.join(DATA, "samples", "TCR3.fastq.gz")
SLIDESEQ = os.path.join(DATA, "samples", "slideseq_XCR.fastq.gz")
COMP = str.maketrans("ACGT", "TGCA")


def _hash_artifacts(outdir):
    out = {}
    for f in sorted(os.listdir(outdir)):
        p = os.path.join(outdir, f)
        if f.endswith((".pdf", "_runstats.json", ".tmp")):
            continue  # pdfs embed timestamps; runstats is timings
        opener = gzip.open if f.endswith(".gz") else open
        with opener(p, "rb") as fh:
            out[f] = hashlib.sha1(fh.read()).hexdigest()
    return out


def _prefix(src, n_reads, path):
    with gzip.open(src, "rt") as f:
        lines = [next(f) for _ in range(4 * n_reads)]
    with gzip.open(path, "wt") as g:
        g.writelines(lines)
    return [ln.strip() for ln in lines[1::4]]


def _write_whitelist(path, full, carried, n_random, suffix=""):
    rng = np.random.default_rng(20261016)
    rows = set(full[rng.choice(len(full), n_random, replace=False)].tolist())
    rows |= carried
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write("".join(f"{b}{suffix}\n" for b in sorted(rows)))
    return len(rows)


def _both(mode, tmp_path, monkeypatch, fq, differ=(), **kw):
    """Both packages' artifacts, byte-identical but those named in
    `differ`, which each test compares itself."""
    monkeypatch.setenv("NANORANGER_NO_FAST", "1")   # the JAX streamed path
    jax_run_pipeline(mode, fq, str(tmp_path / "jax"), "t", **kw)
    pipeline.run_pipeline(mode, fq, str(tmp_path / "torch"), "t",
                          device="cpu", fast=False, **kw)
    want = _hash_artifacts(str(tmp_path / "jax"))
    got = _hash_artifacts(str(tmp_path / "torch"))
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in differ} == \
        {k: v for k, v in want.items() if k not in differ}
    return got


def _rescan(tmp_path, mode, ref_len):
    r = chip_smoke.rescan_real_pairs(str(tmp_path / "torch"), "t",
                                     chemistry.get(mode), "cpu")
    assert r["pairs"] >= 10 and r["ref_len"] == ref_len
    assert not chip_smoke.rescan_failed(r), r


def _count(path):
    with gzip.open(path, "rt") as f:
        return sum(1 for _ in f)


def test_5p10xtcr_artifacts_byte_identical_to_jax(tmp_path, monkeypatch):
    fq = str(tmp_path / "tcr3_prefix.fastq.gz")
    seqs = _prefix(TCR3, 150, fq)
    full = whitelist.load(os.path.join(DATA, "737K-august-2016.txt.gz"))
    known = set(full.tolist())
    carried = set()
    for seq in seqs:
        for s in (seq, seq[::-1].translate(COMP)):
            carried.update(s[i:i + 16] for i in range(len(s) - 15)
                           if s[i:i + 16] in known)
    wl = str(tmp_path / "wl.txt")
    assert len(carried) > 50
    assert _write_whitelist(wl, full, carried, 3000) <= 8192
    got = _both("5p10XTCR", tmp_path, monkeypatch, fq,
                trns_ref=os.path.join(DATA, "TR_V_human.fa"), barcodes=wl)
    assert set(got) >= {
        "t_deconcat.fastq.gz", "t_BCUMI.fasta.gz", "t_eds.csv",
        "t_assignments.csv.gz", "t_barcode_scores.csv", "t_bcumi_dedup.csv",
        "t_clones.txt.gz", "t_cloneID.txt.gz", "t_clones_filtered.csv",
        "t_cloneID_filtered.csv.gz", "t_clone_bcumi.csv.gz"}
    assert _count(str(tmp_path / "torch" / "t_clone_bcumi.csv.gz")) > 3
    _rescan(tmp_path, "5p10XTCR", 86)


def test_slideseq_artifacts_byte_identical_to_jax(tmp_path, monkeypatch):
    fq = str(tmp_path / "slideseq_prefix.fastq.gz")
    seqs = _prefix(SLIDESEQ, 140, fq)
    full = whitelist.load(os.path.join(DATA,
                                       "slideseq.matched.barcodes.tsv.gz"))
    known = set(full.tolist())
    carried = set()
    for seq in seqs:
        for s in (seq, seq[::-1].translate(COMP)):
            at = s.find(SLIDESEQ_LINKER)
            while at >= 8:
                bc = s[at - 8:at] + s[at + 18:at + 24]
                if bc in known:
                    carried.add(bc)
                at = s.find(SLIDESEQ_LINKER, at + 1)
    assert len(carried) > 10
    # the name carries 'matched', which selects the slideseq loader
    wl = str(tmp_path / "prefix.matched.barcodes.tsv.gz")
    _write_whitelist(wl, full, carried, 1000, suffix="-1")
    got = _both("3pXCR_slideseq", tmp_path, monkeypatch, fq,
                trns_ref=os.path.join(DATA, "XR_C_mouse.fa"), barcodes=wl)
    assert set(got) >= {
        "t_VDJ.fastq.gz", "t_BCUMI.fasta.gz", "t_eds_names.csv.gz",
        "t_polyA.fasta.gz", "t_assignments.csv.gz", "t_barcode_scores.csv"}
    with gzip.open(str(tmp_path / "torch" / "t_assignments.csv.gz"),
                   "rt") as f:
        rows = f.read().splitlines()[1:]
    assert sum(r.endswith(",0") for r in rows) >= 10      # accepted rows
    _rescan(tmp_path, "3pXCR_slideseq", 71)


def test_rtx_artifacts_byte_identical_to_jax(tmp_path, monkeypatch):
    fq = str(tmp_path / "tcr3_prefix.fastq.gz")
    _prefix(TCR3, 100, fq)
    got = _both("RTX", tmp_path, monkeypatch, fq,
                trns_ref=os.path.join(DATA, "TR_V_human.fa"))
    assert set(got) == {"t_deconcat.fastq.gz", "t_BCUMI.fasta.gz",
                        "t_clones.txt.gz", "t_cloneID.txt.gz"}
    assert _count(str(tmp_path / "torch" / "t_deconcat.fastq.gz")) > 100


def _synthetic_3pgex(tmp_path, n_reads=120):
    """Reads built as tests/test_3pgex_e2e.py builds them: transcript +
    4 nt + rc(umi) + rc(bc) + TruSeq + junk, over a two-gene panel."""
    rng = np.random.default_rng(31016)
    genes = {"GENEA": 900, "GENEB": 700}
    seqs = {g: "".join(rng.choice(list("ACGT"), n)) for g, n in genes.items()}
    panel = str(tmp_path / "panel.fa")
    with open(panel, "w") as f:
        for g, s in seqs.items():
            f.write(f">{g}\n{s}\n")
    bcs = ["".join(rng.choice(list("ACGT"), 16)) for _ in range(4)]
    fq = str(tmp_path / "reads.fastq.gz")
    with gzip.open(fq, "wt") as f:
        for i in range(n_reads):
            umi = "".join(rng.choice(list("ACGT"), 12))
            tr = seqs["GENEA" if i % 2 == 0 else "GENEB"][50:650]
            bc = bcs[i % 4]
            read = (tr + "ACGC" + umi[::-1].translate(COMP)
                    + bc[::-1].translate(COMP) + TRUSEQ
                    + "".join(rng.choice(list("ACGT"), 25)))
            if i % 3 == 0:
                read = read[::-1].translate(COMP)
            f.write(f"@m{i}/ccs_{i}\n{read}\n+\n{'I' * len(read)}\n")
    master = str(tmp_path / "master.txt")
    with open(master, "w") as f:
        f.writelines(b + "\n" for b in bcs + ["AAAACCCCGGGGTTTT"])
    return fq, panel, master


def _quads(outdir):
    with gzip.open(os.path.join(outdir, "t_quads.json.gz"), "rt") as f:
        return json.load(f)


def _matrix(outdir):
    """{(gene, barcode): count} of the count matrix."""
    def lines(name):
        with open(os.path.join(outdir, name)) as f:
            return f.read().split()
    genes, cells = lines("t_genes.tsv"), lines("t_barcodes.tsv")
    with gzip.open(os.path.join(outdir, "t_gex.mtx.gz"), "rt") as f:
        rows = f.read().splitlines()[2:]
    return {(genes[int(g) - 1], cells[int(c) - 1]): int(n)
            for g, c, n in (r.split() for r in rows)}


@pytest.mark.parametrize("with_master", [True, False])
def test_3p10xgex_artifacts_byte_identical_to_jax(tmp_path, monkeypatch,
                                                  with_master):
    """The data-driven whitelist from a master list, and the fallback to
    the observed barcodes when the master list is missing.

    The count matrix and the quads take each candidate's gene from its
    decon record in the port; the JAX package parses it from the name
    after '/ccs_', and these reads' names (m<i>/ccs_<i>) hold one more '_'
    there, which puts the alignment's flag in front of every JAX label
    (0_GENEA, 16_GENEA). Those artifacts must equal the JAX package's with
    the flag taken off the labels; every other artifact is byte-identical."""
    fq, panel, master = _synthetic_3pgex(tmp_path)
    barcodes = master if with_master else str(tmp_path / "no_master.txt")
    got = _both("3p10XGEX", tmp_path, monkeypatch, fq, trns_ref=panel,
                barcodes=barcodes,
                differ={"t_quads.json.gz", "t_gex.mtx.gz", "t_genes.tsv"})
    jq = _quads(str(tmp_path / "jax"))
    assert {t.split("_", 1)[0] for rows in jq.values()
            for _, t in rows} == {"0", "16"}
    fixed = {bc: [[u, t.split("_", 1)[1]] for u, t in rows]
             for bc, rows in jq.items()}
    assert _quads(str(tmp_path / "torch")) == fixed
    want: dict = {}
    for bc, rows in fixed.items():
        for _, gene in {(u, t) for u, t in rows}:
            want[(gene, bc)] = want.get((gene, bc), 0) + 1
    assert _matrix(str(tmp_path / "torch")) == want
    assert set(got) >= {
        "t_deconcat.fastq.gz", "t_BCUMI.fasta.gz", "t_bc_read_count.csv",
        "t_bc_count.json", "t_assignments.csv.gz", "t_quads.json.gz",
        "t_gex.mtx.gz"}
    assert _count(str(tmp_path / "torch" / "t_gex.mtx.gz")) > 4


def test_missing_whitelist_exits_after_decon(tmp_path):
    """A barcoded mode without its whitelist writes the decon artifacts and
    then ends in SystemExit, as the JAX package does; it asks for no file
    up front."""
    fq = str(tmp_path / "tcr3_prefix.fastq.gz")
    _prefix(TCR3, 40, fq)
    out = tmp_path / "o"
    with pytest.raises(SystemExit, match="whitelist not found"):
        pipeline.run_pipeline(
            "3p10XTCR_nuc", fq, str(out), "t", device="cpu",
            trns_ref=os.path.join(DATA, "TR_V_human.fa"),
            barcodes=str(tmp_path / "3M-february-2018.txt.gz"))
    assert os.path.isfile(out / "t_VDJ.fastq.gz")
    assert os.path.isfile(out / "t_BCUMI.fasta.gz")
