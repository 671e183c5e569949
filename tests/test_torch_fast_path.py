"""The fused path of the PyTorch port (DeconRun._run_fast, the default with
data_shards <= 1) against its unfused path on the CPU: every artifact of
run_pipeline(fast=None) and run_pipeline(fast=False) (or
NANORANGER_NO_FAST=1) is byte-identical after gunzip (pdfs and run
statistics aside). The cases of tests/test_cli_fast_path.py: synthetic
concatemers with more kept chains than the step's slots (the deferred reads
rerun through the unfused path and interleaved in read order, here also
with the step's exact-class whitelist pass and the prematched match that
the card runs), 300-read prefixes of slideseq_XCR and TCR3 with reduced
whitelists (the plain one-vs-all DP against a full list is too heavy for a
CPU test), and a 3p10XGEX prefix (data-driven whitelist, no match in the
step). match_barcodes(prematched=) gives what a match of every candidate
gives."""

import gzip
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_modes import _hash_artifacts, _prefix, _write_whitelist

from nanoranger_torch import chemistry, pipeline
from nanoranger_torch.chemistry import SLIDESEQ_LINKER
from nanoranger_torch.io import fasta, whitelist
from nanoranger_torch.io.candidate_store import CandidateStore
from nanoranger_torch.io.encode import PAD, encode_batch
from nanoranger_torch.stages.barcode import DP_PENDING, BarcodeMatcher

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
PANEL = os.path.join(DATA, "RUNX1_RUNX1T1_ABL1_BCR.fa")
WL = os.path.join(DATA, "737K-august-2016.txt.gz")
COMP = str.maketrans("ACGT", "TGCA")


def _run_both(mode, infile, tmp_path, **kw):
    dirs = {}
    for tag, fast in (("slow", False), ("fast", None)):
        dirs[tag] = str(tmp_path / tag)
        pipeline.run_pipeline(mode, infile, dirs[tag], "t", device="cpu",
                              fast=fast, **kw)
    return dirs


def _runstats(outdir):
    with open(os.path.join(outdir, "t_runstats.json")) as f:
        return json.load(f)


def _align_decon(outdir):
    return _runstats(outdir)["stages"][0]


def _carried_10x(seqs, full):
    known = set(full.tolist())
    carried = set()
    for seq in seqs:
        for s in (seq, seq[::-1].translate(COMP)):
            carried.update(s[i:i + 16] for i in range(len(s) - 15)
                           if s[i:i + 16] in known)
    return carried


@pytest.fixture(scope="module")
def concatemers(tmp_path_factory, module_rng):
    """8 reads: every third a 6-unit concatemer (more kept chains than the
    S=4 slots), the others one unit, all with a whitelisted barcode; and a
    whitelist of those barcodes and 200 seeded rows of the 737K list."""
    rng = module_rng
    d = tmp_path_factory.mktemp("concat")
    _, seqs = fasta.read_fasta_encoded(PANEL)
    alpha = "ACGT"

    def seg(rid, lo, n):
        return "".join(alpha[c] for c in np.asarray(seqs[rid][lo:lo + n]))

    def noisy(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < 0.02:
                continue
            out.append(alpha[rng.integers(4)] if r < 0.06 else ch)
        return "".join(out)

    full = whitelist.load(WL)
    bcs = [str(b) for b in full[rng.choice(len(full), 8, replace=False)]]
    adapter, tso = "CGCTCTTCCGATCT", "TTTCTTATATG"
    reads = []
    for i in range(8):
        unit = adapter + bcs[i] + "ACGTACGTAC" + tso
        if i % 3 == 1:
            reads.append((f"concat{i}", "".join(
                unit + noisy(seg(k % len(seqs), 50, 400)) for k in range(6))))
        else:
            reads.append((f"norm{i}", unit + noisy(seg(i % len(seqs), 100,
                                                       600))))
    infile = str(d / "in.fastq.gz")
    with gzip.open(infile, "wt") as g:
        for name, seq in reads:
            g.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    wl = str(d / "wl.txt")
    _write_whitelist(wl, full, set(bcs), 200)
    return infile, wl


KW = dict(trns_ref=PANEL, genome_ref="/nonexistent", batch_size=8)


@pytest.fixture(scope="module")
def concat_slow(concatemers, tmp_path_factory):
    """The unfused run of the concatemers, taken by NANORANGER_NO_FAST=1."""
    infile, wl = concatemers
    out = str(tmp_path_factory.mktemp("concat_slow") / "o")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NANORANGER_NO_FAST", "1")
        pipeline.run_pipeline("5p10XGEX", infile, out, "t", device="cpu",
                              barcodes=wl, **KW)
    return out


def test_concatemer_defer_interleave(concatemers, concat_slow, tmp_path):
    """Deferred concatemers rerun through the unfused path and interleave
    in read order."""
    infile, wl = concatemers
    out = str(tmp_path / "fast")
    pipeline.run_pipeline("5p10XGEX", infile, out, "t", device="cpu",
                          barcodes=wl, **KW)
    a = _hash_artifacts(concat_slow)
    assert a == _hash_artifacts(out)
    assert {"t_deconcat.fastq.gz", "t_BCUMI.fasta.gz",
            "t_assignments.csv.gz", "t_bcumi_dedup.csv"} <= set(a)
    rs = _runstats(out)
    fast = rs["stages"][0]
    assert fast.get("deferred_reads", 0) >= 2
    assert {"seconds", "reads", "whitelist_s", "index_s"} <= set(fast)
    assert set(fast["phase_s"]) == {"read", "step", "assemble", "slow"}
    # phase_s is made of the decon.* spans, its step of issue + download
    tot = rs["span_totals"]
    assert {"decon.read", "decon.step.issue", "decon.step.download",
            "decon.assemble", "decon.slow", "step.upload", "step.chain",
            "step.records", "step.extend", "step.scan",
            "step.slice"} <= set(tot)
    ph = fast["phase_s"]
    assert ph["step"] == round(tot["decon.step.issue"]["s"] +
                               tot["decon.step.download"]["s"], 3)
    for k in ("read", "assemble", "slow"):
        assert ph[k] == round(tot[f"decon.{k}"]["s"], 3)
    assert rs["counters"]["decon.deferred_reads"] == fast["deferred_reads"]
    assert sum(v for k, v in rs["counters"].items()
               if k.startswith("decon.reads.L")) == fast["reads"]
    assert "phase_s" not in _align_decon(concat_slow)


def test_concatemers_with_the_step_matcher(concatemers, concat_slow,
                                           tmp_path, monkeypatch):
    """The card's route on the CPU: the step runs the exact-class pass,
    DeconRun.prematch carries its verdicts (the deferred reads' candidates
    and DP_PENDING rows pending) and match_barcodes matches only those;
    the artifacts equal the unfused run's."""
    infile, wl = concatemers
    seen = []
    match_barcodes = pipeline.match_barcodes

    def recording(*a, prematched=None, **k):
        seen.append(prematched)
        return match_barcodes(*a, prematched=prematched, **k)

    monkeypatch.setattr(pipeline, "_matcher_in_step", lambda dev: True)
    monkeypatch.setattr(pipeline, "match_barcodes", recording)
    out = str(tmp_path / "fast")
    pipeline.run_pipeline("5p10XGEX", infile, out, "t", device="cpu",
                          barcodes=wl, **KW)
    assert _hash_artifacts(concat_slow) == _hash_artifacts(out)
    pre = seen[0]
    df = pd.read_csv(os.path.join(out, "t_assignments.csv.gz"),
                     keep_default_na=False)
    assert len(pre["status"]) == len(df)
    pend = pre["pending"]
    assert pend.any() and not pend.all()
    assert (pre["bc_idx"][pend] == -2).any()          # deferred reads' rows
    np.testing.assert_array_equal(pre["status"][~pend],
                                  df.status.to_numpy()[~pend])


def test_prematched_match_equals_a_full_match(concatemers, concat_slow,
                                             tmp_path):
    """match_barcodes with the exact-class verdicts of every candidate
    (some marked pending as a deferred read's are) against a match of every
    candidate: the same table, arrays and artifacts."""
    wl = concatemers[1]
    cands = CandidateStore()
    for k, (nm, sq) in enumerate(fasta.iter_fasta(
            os.path.join(concat_slow, "t_BCUMI.fasta.gz"))):
        cands.append(nm, sq)
        if k % 3 == 0:         # a barcode base changed: no exact hit
            sub = "C" if sq[20] != "C" else "G"
            cands.append(nm + "_m", sq[:20] + sub + sq[21:])
    spec = chemistry.get("5p10XGEX")
    bcs = whitelist.load(wl)
    m = BarcodeMatcher(bcs, spec.barcode, "cpu")
    q, ql = encode_batch([s for _, ss in cands.iter_batches(1 << 20)
                          for s in ss], max_len=pipeline.MATCH_LQ)
    bc, score, status, umi, _ = (x.numpy() for x in m.match_device_with(
        torch.from_numpy(q), torch.from_numpy(ql), m.device_tables(),
        dp=False))
    pend = status == DP_PENDING
    deferred = np.arange(len(status)) % 5 == 2
    umi[deferred] = PAD
    pre = {"bc_idx": bc, "score": score, "status": status, "umi": umi,
           "pending": pend | deferred}
    assert pend.any() and (~pre["pending"]).sum() >= 3
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    got = pipeline.match_barcodes(spec, bcs, cands, str(tmp_path / "a"),
                                  "t", "cpu", matcher=m, prematched=pre)
    want = pipeline.match_barcodes(spec, bcs, cands, str(tmp_path / "b"),
                                   "t", "cpu", matcher=m)
    assert got[0].equals(want[0])
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=k)
    assert _hash_artifacts(str(tmp_path / "a")) == \
        _hash_artifacts(str(tmp_path / "b"))


def test_fast_slow_equal_slideseq(tmp_path):
    fq = str(tmp_path / "slideseq_prefix.fastq.gz")
    seqs = _prefix(os.path.join(DATA, "samples", "slideseq_XCR.fastq.gz"),
                   300, fq)
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
    wl = str(tmp_path / "prefix.matched.barcodes.tsv.gz")
    _write_whitelist(wl, full, carried, 100, suffix="-1")
    dirs = _run_both("3pXCR_slideseq", fq, tmp_path,
                     trns_ref=os.path.join(DATA, "XR_C_mouse.fa"),
                     barcodes=wl, batch_size=512)
    a = _hash_artifacts(dirs["slow"])
    assert a == _hash_artifacts(dirs["fast"])
    assert {"t_VDJ.fastq.gz", "t_BCUMI.fasta.gz", "t_eds_names.csv.gz",
            "t_polyA.fasta.gz", "t_assignments.csv.gz"} <= set(a)
    # the clonotyper's and the match's spans: no tier tables, so every
    # candidate goes to the DP
    rs = _runstats(dirs["fast"])
    spans = rs["spans"]
    names = {s[0] for s in spans}
    assert {"vdj.index", "vdj.align", "vdj.banded", "vdj.cdr3",
            "vdj.assemble", "vdj.exports", "match.dp",
            "match.verdicts"} <= names
    assert "match.tiers" not in names
    c = rs["counters"]
    assert c["match.rows_dp"] == c["match.rows"] > 0
    row = {r["stage"]: r for r in rs["stages"]}["clonotypes"]
    (ci, clo), = [(i, s) for i, s in enumerate(spans)
                  if s[0] == "clonotypes"]
    kids = [s for s in spans if s[3] == ci]
    assert {s[0] for s in kids} == {"vdj.index", "vdj.align", "vdj.banded",
                                    "vdj.cdr3", "vdj.assemble",
                                    "vdj.exports"}
    assert all(clo[1] <= s[1] <= s[2] <= clo[2] for s in kids)
    covered = sum(s[2] - s[1] for s in kids) / (clo[2] - clo[1])
    assert covered >= 0.8
    tot = rs["span_totals"]["clonotypes"]
    assert row["seconds"] == round(tot["s"], 3)
    assert abs(tot["self_s"] - (1 - covered) * tot["s"]) < 1e-6


def test_fast_slow_equal_tcr3(tmp_path):
    fq = str(tmp_path / "tcr3_prefix.fastq.gz")
    seqs = _prefix(os.path.join(DATA, "samples", "TCR3.fastq.gz"), 300, fq)
    full = whitelist.load(WL)
    wl = str(tmp_path / "wl.txt")
    _write_whitelist(wl, full, _carried_10x(seqs, full), 300)
    dirs = _run_both("5p10XTCR", fq, tmp_path,
                     trns_ref=os.path.join(DATA, "TR_V_human.fa"),
                     barcodes=wl, batch_size=512)
    a = _hash_artifacts(dirs["slow"])
    assert a == _hash_artifacts(dirs["fast"])
    assert {"t_deconcat.fastq.gz", "t_eds.csv", "t_assignments.csv.gz",
            "t_clones.txt.gz"} <= set(a)


def test_fast_slow_equal_3pgex(tmp_path):
    """3p10XGEX: fused decon without a match in the step (data-driven
    whitelist): raw counts, quads and the count matrix equal."""
    fq = str(tmp_path / "in.fastq.gz")
    _prefix(os.path.join(DATA, "samples",
                         "1026_mtDNA_ASXL1_NRAS_SF3B1.fastq.gz"), 300, fq)
    dirs = _run_both("3p10XGEX", fq, tmp_path,
                     trns_ref=os.path.join(DATA, "panel_MT_trns.fa"),
                     batch_size=512)
    a = _hash_artifacts(dirs["slow"])
    assert a == _hash_artifacts(dirs["fast"])
    assert {"t_deconcat.fastq.gz", "t_BCUMI.fasta.gz",
            "t_bc_read_count.csv"} <= set(a)
