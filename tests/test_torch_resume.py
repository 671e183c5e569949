"""Stage resume of the PyTorch port on the CPU, as tests/test_resume.py and
tests/test_round2_fixes.py::test_match_resume_fingerprint hold the JAX
package's: a rerun skips completed stages and reproduces identical
outputs, --force recomputes, a deleted checkpoint recomputes just its
stage, the assignment checkpoint is fingerprint-guarded, and a checkpoint
without its score histogram (as merge_shards leaves it) gets the histogram
rebuilt byte-equal to the JAX package's rebuild."""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.io.candidate_store import CandidateStore as JaxStore
from nanoranger_tpu.pipeline import match_barcodes as jax_match_barcodes

from nanoranger_torch import chemistry
from nanoranger_torch.io import whitelist
from nanoranger_torch.io.candidate_store import CandidateStore
from nanoranger_torch.io.encode import decode
from nanoranger_torch.io.fasta import iter_fasta
from nanoranger_torch.io.fastq import FastqWriter
from nanoranger_torch.pipeline import match_barcodes, run_pipeline

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, module_rng):
    d = tmp_path_factory.mktemp("resume")
    refs = [module_rng.integers(0, 4, size=n).astype(np.int8)
            for n in (900, 700)]
    with open(d / "panel.fa", "w") as f:
        for i, r in enumerate(refs):
            f.write(f">G{i}\n{decode(r)}\n")
    wl = sorted({"".join(module_rng.choice(list("ACGT"), 16))
                 for _ in range(40)})
    with open(d / "wl.txt", "w") as f:
        f.write("\n".join(wl) + "\n")
    with FastqWriter(str(d / "reads.fastq.gz")) as w:
        for i in range(40):
            bc = wl[i % len(wl)]
            umi = "".join(module_rng.choice(list("ACGT"), 10))
            pre = "".join(module_rng.choice(list("ACGT"), 25))
            seq = (pre + "CGCTCTTCCGATCT" + bc + umi + "TTTCTTATATG"
                   + decode(refs[i % 2][50:500]))
            w.write(f"r{i}", seq, "I" * len(seq))
    return d


def _run(d, out, **kw):
    run_pipeline("5p10XGEX", str(d / "reads.fastq.gz"), str(out), "syn",
                 trns_ref=str(d / "panel.fa"), genome_ref=str(d / "panel.fa"),
                 barcodes=str(d / "wl.txt"), batch_size=64, device="cpu", **kw)


def test_resume_skips_and_matches(workdir, tmp_path):
    out = tmp_path / "o"
    _run(workdir, out)
    dedup1 = pd.read_csv(out / "syn_bcumi_dedup.csv", index_col=0)
    asg = out / "syn_assignments.csv.gz"
    bam = out / "syn_genome_tagged.bam"
    assert asg.is_file() and bam.is_file()
    m_asg = os.path.getmtime(asg)
    m_bam = os.path.getmtime(bam)

    # a stray half-written tmp file must never be treated as an artifact
    (out / "syn_BCUMI.fasta.gz.tmp").write_bytes(b"garbage")

    _run(workdir, out)                       # resumes every stage
    assert os.path.getmtime(asg) == m_asg    # match stage not recomputed
    assert os.path.getmtime(bam) == m_bam    # genome stage skipped
    dedup2 = pd.read_csv(out / "syn_bcumi_dedup.csv", index_col=0)
    pd.testing.assert_frame_equal(dedup1, dedup2)

    _run(workdir, out, force=True)           # --force recomputes
    assert os.path.getmtime(asg) > m_asg
    dedup3 = pd.read_csv(out / "syn_bcumi_dedup.csv", index_col=0)
    pd.testing.assert_frame_equal(dedup1, dedup3)


def test_resume_decon_only(workdir, tmp_path):
    """Deleting a downstream checkpoint recomputes just that stage from the
    decon artifacts (the reference's delete-a-file-and-rerun workflow)."""
    out = tmp_path / "o2"
    _run(workdir, out)
    asg = out / "syn_assignments.csv.gz"
    before = pd.read_csv(asg, keep_default_na=False)
    os.remove(asg)
    _run(workdir, out)
    after = pd.read_csv(asg, keep_default_na=False)
    pd.testing.assert_frame_equal(before, after)


def test_resume_rebuilds_score_histogram_as_jax(workdir, tmp_path):
    """A resumed outdir whose assignment checkpoint has no score histogram
    beside it gets _barcode_scores.csv (and .pdf) rebuilt from the loaded
    table, byte-equal to the first run's and to the JAX package's rebuild
    of the same checkpoint."""
    out = tmp_path / "o3"
    _run(workdir, out)
    csv = "syn_barcode_scores.csv"
    pdf = "syn_barcode_scores.pdf"
    first = (out / csv).read_bytes()
    jax_out = tmp_path / "jax"
    shutil.copytree(out, jax_out)
    asg = "syn_assignments.csv.gz"
    m_asg = os.path.getmtime(out / asg)
    for d in (out, jax_out):
        os.remove(d / csv)
        os.remove(d / pdf)

    _run(workdir, out)
    cands = list(iter_fasta(str(jax_out / "syn_BCUMI.fasta.gz")))
    bcs = whitelist.load(str(workdir / "wl.txt"))
    jax_match_barcodes(jax_chemistry.get("5p10XGEX"), bcs,
                       JaxStore.from_lists([n for n, _ in cands],
                                           [s for _, s in cands]),
                       str(jax_out), "syn")
    # both resumed from the checkpoint: the table was not rewritten
    assert os.path.getmtime(out / asg) == m_asg
    assert os.path.getmtime(jax_out / asg) == m_asg
    assert (out / csv).read_bytes() == first
    assert (jax_out / csv).read_bytes() == first
    assert (out / pdf).is_file() and (jax_out / pdf).is_file()


def test_match_resume_fingerprint(tmp_path, rng):
    spec = chemistry.get("5p10XGEX")
    wl_a = np.asarray(sorted({"".join(rng.choice(list("ACGT"), 16))
                              for _ in range(30)}))
    wl_b = np.asarray(sorted({"".join(rng.choice(list("ACGT"), 16))
                              for _ in range(31)}))
    names, seqs = [], []
    for i in range(6):
        bc = wl_a[i % len(wl_a)]
        umi = "".join(rng.choice(list("ACGT"), 10))
        names.append(f"c{i}_0_10_0_G")
        seqs.append("CGCTCTTCCGATCT" + bc + umi + "TTTCTTATATG")
    d = str(tmp_path)
    cands = CandidateStore.from_lists(names, seqs)
    df1, res1 = match_barcodes(spec, wl_a, cands, d, "s", "cpu")
    assert "bc_idx" in res1
    # same fingerprint -> resumed, and the resumed dict carries bc_idx
    df2, res2 = match_barcodes(spec, wl_a, cands, d, "s", "cpu")
    assert "bc_idx" in res2
    np.testing.assert_array_equal(res1["bc_idx"], res2["bc_idx"])
    pd.testing.assert_frame_equal(
        df1.reset_index(drop=True), df2.reset_index(drop=True),
        check_dtype=False)
    m1 = os.path.getmtime(tmp_path / "s_assignments.csv.gz")
    # different whitelist -> fingerprint mismatch -> recomputed checkpoint
    match_barcodes(spec, wl_b, cands, d, "s", "cpu")
    assert os.path.getmtime(tmp_path / "s_assignments.csv.gz") > m1
