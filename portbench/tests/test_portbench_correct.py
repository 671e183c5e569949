"""The check that decides `correct`, driven through a whole run on the CPU
at a size a test can hold: a sound run comes out correct, and the control
and each planted fault come out not correct (portbench/faults.py).

The run skips the harness's look for a card (`run_cell(device="cpu")`, the
kernels' plain versions) and uses a checkout whose 10x list is cut to the
rows that the sample's reads can hit and 3,000 others, so that the plain
one-vs-all DP of the check fits a test's time."""

import gzip
import json
import os

import numpy as np
import pytest

import harness
from conftest import checkout

ROOT = harness.ROOT
GEX = "gex5p_737k.k562_fusion_4k"
SS = "xcr3p_slideseq_beads.slideseq_xcr"


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A checkout whose cells hold 120 (K562) and 160 (slideseq) reads a
    sample, and whose 10x list, data/wl_small.txt.gz, is the 737K rows
    found in the K562 reads (either strand) and 3,000 more."""
    root = tmp_path_factory.mktemp("checkout")
    checkout(root, ["samples", "RUNX1_RUNX1T1_ABL1_BCR.fa", "XR_C_mouse.fa",
                    "TR_V_mouse.fa", "IG_V_mouse.fa",
                    "slideseq.matched.barcodes.tsv.gz"], {
        f"workloads/{GEX}": {"reads_per_sample": 120,
                             "warmup_per_bucket": [6, 3, 2, 1]},
        f"workloads/{SS}": {"reads_per_sample": 160,
                            "warmup_per_bucket": [6, 3, 2, 1]},
        "configs/gex5p_737k": {"whitelist": "data/wl_small.txt.gz",
                               "check": {"verdicts_uniform": 8,
                                         "verdicts_hard": 8,
                                         "reads_drawn": 60}},
        "configs/xcr3p_slideseq_beads": {"check": {"verdicts_uniform": 12,
                                                   "reads_drawn": 60,
                                                   "subreads_drawn": 24}}})
    with gzip.open(os.path.join(ROOT, "data", "samples", "K562_Kasumi1_"
                                "BCRABL1_RUNX1_RUNX1T1.fastq.gz"), "rt") as f:
        seqs = f.read().split("\n")[1::4]
    comp = str.maketrans("ACGT", "TGCA")
    kmers = set()
    for s in seqs:
        for t in (s, s.translate(comp)[::-1]):
            kmers.update(t[i:i + 16] for i in range(len(t) - 15))
    with gzip.open(os.path.join(ROOT, "data", "737K-august-2016.txt.gz"),
                   "rt") as f:
        wl = f.read().split()
    rng = np.random.default_rng(0)
    keep = [b for b in wl if b in kmers]
    keep += [wl[i] for i in rng.choice(len(wl), 3000, replace=False)]
    with gzip.open(root / "data" / "wl_small.txt.gz", "wt") as f:
        f.write("\n".join(dict.fromkeys(keep)) + "\n")
    return str(root)


READS = {GEX: 120, SS: 160}


@pytest.mark.parametrize("cell", [GEX, SS])
@pytest.mark.parametrize("fault", [None, "control", "half_batch",
                                   "alter_answer"])
def test_correct_only_when_sound(small_root, cell, fault, tmp_path,
                                 monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    res = harness.run_cell(cell, 2 ** 31 + 99, 0.01, False, device="cpu",
                           fault=fault, root=small_root)
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"] is (fault is None), checks
    assert res["attempted"] == READS[cell]
    if fault is None:
        assert set(checks.values()) == {0}
    if fault == "control":
        assert checks["verdict_mismatch"] > 0
    if fault == "half_batch":
        # the reads count as read; the drawn reads miss their subreads
        assert checks["reads_missing"] == 0
        assert checks["drawn_read_mismatch"] > 0
        if cell == SS:
            assert checks["cdr3_call_mismatch"] > 0
    if fault == "alter_answer":
        # every number the cell compares reads the altered answers
        altered = {"subread_mismatch", "candidate_mismatch",
                   "verdict_mismatch"}
        altered |= {"dedup_mismatch", "bam_mismatch"} if cell == GEX else \
            {"clone_mismatch"}
        assert all(checks[k] > 0 for k in altered), checks
    assert not res["forbidden_modules"]
    assert not os.path.exists(os.path.join(str(tmp_path), "portbench_run"))
    json.dumps(res)
