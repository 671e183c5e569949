"""The 5p10XGEX genome stage of the PyTorch port end to end on the CPU.

nanoranger_torch.pipeline.run_pipeline("5p10XGEX", device="cpu") with the
mode's default panel and genome (panel_MT_trns.fa, MT_chr.fa) on a 200-read
prefix of 1026_mtDNA_ASXL1_NRAS_SF3B1, against the JAX package's streamed
run with the same files named: every artifact must be byte-identical (after
gunzip, the tagged BAM after BGZF decompression, its .bai and _trns_ct.csv
raw; pdfs and run statistics aside). The whitelist is reduced by
tests/test_torch_pipeline.py's helper, with fewer seeded rows to keep the
plain one-vs-all DP short: 1,000 rows of the 737K list plus every barcode
the prefix carries. Then the port's downstream readers of the tagged BAM
(pileup, fusion_gene, isoforms) must give the JAX ones' output."""

import json
import os

import pytest
import torch

from nanoranger_tpu.downstream import fusion_gene as jax_fusion_gene
from nanoranger_tpu.downstream import isoforms as jax_isoforms
from nanoranger_tpu.downstream import pileup as jax_pileup
from nanoranger_tpu.pipeline import run_pipeline as jax_run_pipeline

from test_torch_pipeline import _hash_artifacts, _prefix_and_whitelist

from nanoranger_torch import pipeline
from nanoranger_torch.downstream import fusion_gene, isoforms, pileup
from nanoranger_torch.io import bam

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
SAMPLE = os.path.join(DATA, "samples", "1026_mtDNA_ASXL1_NRAS_SF3B1.fastq.gz")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("genome")
    fq, wl = _prefix_and_whitelist(tmp, SAMPLE, n_random=1000)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NANORANGER_NO_FAST", "1")         # the streamed path
        jax_run_pipeline("5p10XGEX", fq, str(tmp / "jax"), "t",
                         trns_ref=os.path.join(DATA, "panel_MT_trns.fa"),
                         genome_ref=os.path.join(DATA, "MT_chr.fa"),
                         barcodes=wl)
    # the port with the mode's defaults: the same panel and genome
    pipeline.run_pipeline("5p10XGEX", fq, str(tmp / "torch"), "t",
                          barcodes=wl, device="cpu")
    return str(tmp / "jax"), str(tmp / "torch")


def test_pipeline_with_genome_artifacts_equal_jax(runs):
    jax_dir, torch_dir = runs
    want = _hash_artifacts(jax_dir)
    got = _hash_artifacts(torch_dir)
    assert {"t_genome_tagged.bam", "t_genome_tagged.bam.bai",
            "t_trns_ct.csv", "t_deconcat.fastq.gz",
            "t_assignments.csv.gz", "t_bcumi_dedup.csv"} <= set(want)
    assert got == want
    _, _, it = bam.read_bam(os.path.join(torch_dir, "t_genome_tagged.bam"))
    recs = list(it)
    assert len(recs) > 50
    assert all(r.tags["CB"] and r.tags["UB"] for r in recs)
    with open(os.path.join(torch_dir, "t_runstats.json")) as f:
        rs = json.load(f)
    stages = [s["stage"] for s in rs["stages"]]
    assert stages == ["align_decon", "barcode_match", "dedup", "genome_tag"]
    # the genome stage's row keeps its keys, each its span's seconds
    row = rs["stages"][-1]
    tot = rs["span_totals"]
    for key, name in (("index_s", "genome.index"), ("align_s", "genome.align"),
                      ("cigar_s", "genome.cigar"), ("write_s", "genome.write")):
        assert abs(row[key] - tot[name]["s"]) <= 5e-4 + 1e-9, key
    assert row["records"] == len(recs)
    assert row["seconds"] == round(tot["genome_tag"]["s"], 3)


def test_downstream_readers_equal_jax(runs, tmp_path):
    _, torch_dir = runs
    path = os.path.join(torch_dir, "t_genome_tagged.bam")
    names, _, it = bam.read_bam(path)
    starts = sorted({r.pos for r in it})
    cols = [starts[0] + 5, starts[len(starts) // 2] + 40, 3_000, 16_000]
    n_rows = 0
    for pos0 in cols:
        got = pileup.pileup_at(path, names[0], pos0)
        assert got == jax_pileup.pileup_at(path, names[0], pos0)
        n_rows += len(got)
    assert n_rows > 0
    assert pileup.pileup_at(path, "no_such_chrom", 10) == []

    outs = {}
    for side, fg, iso in (("torch", fusion_gene, isoforms),
                          ("jax", jax_fusion_gene, jax_isoforms)):
        fg.main(["--bam", path, "--output", str(tmp_path / f"fg_{side}.csv")])
        exons = tmp_path / "exons.csv"
        exons.write_text(f"MT-CO1,exon1,{names[0]},5904,7445\n"
                         f"MT-ND1,exon1,{names[0]},3307,4262\n")
        iso.main(["--bam", path, "--sample", "t", "--exons", str(exons),
                  "--output", str(tmp_path / f"iso_{side}.csv")])
        outs[side] = [(tmp_path / f"{k}_{side}.csv").read_bytes()
                      for k in ("fg", "iso")]
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0].count(b"\n") > 50
