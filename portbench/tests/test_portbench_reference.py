"""The plain reference against the port on a few reads on the CPU, and
the reference's imports.

The port (`nanoranger_torch`) is imported here only to compare; the
reference under portbench/reference/ never imports it."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from reference import align, judge, plain, vdj

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _reads(path, n):
    with gzip.open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return [lines[i + 1] for i in range(0, 4 * n, 4)]


def test_adapter_scan_equals_the_port():
    """Flanks of real reads, and synthetic flanks holding the motif with
    a few edits, scanned by both."""
    from nanoranger_torch.ops.edit_distance import hw_locate_plain
    rng = np.random.default_rng(3)
    seqs = _reads(os.path.join(ROOT, "data/samples/K562_Kasumi1_BCRABL1_"
                               "RUNX1_RUNX1T1.fastq.gz"), 100)
    for motif, wildcard, last, k in (
            (b"CGCTCTTCCGATCT" + b"N" * 26 + b"TTTCTTATATG", True, True, 6),
            (b"TCTCGGGAACGCTGAAGA", False, False, 2)):
        pat = plain.encode(motif)
        texts = []
        for i, s in enumerate(seqs):
            a = int(rng.integers(0, max(1, len(s) - 100)))
            texts.append(s[a:a + int(rng.integers(20, 101))])
            m = bytearray(motif)
            for j in range(len(m)):
                if m[j] == ord("N"):
                    m[j] = int(rng.choice(list(b"ACGT")))
            for _ in range(int(rng.integers(0, 4))):
                m[int(rng.integers(0, len(m)))] = int(rng.choice(
                    list(b"ACGTN")))
            pre = bytes(rng.choice(list(b"ACGT"), int(rng.integers(0, 30))))
            post = bytes(rng.choice(list(b"ACGT"), int(rng.integers(0, 20))))
            texts.append((pre + bytes(m) + post)[:100])
        q, ql = plain.encode_rows(texts, 100)
        ours = plain.hw_locate(pat, q, ql, k, wildcard, last)
        theirs = hw_locate_plain(torch.from_numpy(pat), torch.from_numpy(q),
                                 torch.from_numpy(ql), k, wildcard, last)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b.numpy())
        assert (ours[0] >= 0).sum() > 20


def test_whitelist_scores_and_umi_equal_the_port():
    from nanoranger_torch.ops.sw import sw_banded_plain
    from nanoranger_torch.ops.whitelist_verify import verify_all_plain
    rng = np.random.default_rng(5)
    bcs = ["".join(rng.choice(list("ACGT"), 16)) for _ in range(300)]
    spec = {"slideseq_linker": False}
    core = judge.core_columns(np.asarray(bcs), spec)
    seqs = []
    for i in range(12):
        bc = bcs[int(rng.integers(0, 300))]
        bc = bc[:5] + ("A" if i % 3 else "") + bc[6 + i % 2:]   # edits
        s = "".join(rng.choice(list("ACGTN"), 14)) + bc + \
            "".join(rng.choice(list("ACGT"), int(rng.integers(0, 40))))
        seqs.append(s.encode())
    seqs.append(b"")
    q, ql = plain.encode_rows(seqs, 96)
    ours = plain.best_rows(torch.from_numpy(q), torch.from_numpy(ql),
                           torch.from_numpy(core), 30, 40, r_chunk=128)
    theirs = verify_all_plain(torch.from_numpy(q), torch.from_numpy(ql),
                              torch.from_numpy(core), 300, 30, 40,
                              r_chunk=128)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b.numpy())
    # the UMI position against the winner's row, over the whole row, equals
    # the port's banded locator
    live = ql > 0
    idx = ours[1][live]
    rows = np.concatenate([np.full((len(idx), 30), plain.N, np.int8),
                           core[:, idx].T,
                           np.full((len(idx), 40), plain.N, np.int8)], 1)
    band = torch.from_numpy(np.ascontiguousarray(rows[:, 30:47]))
    sc, qp, _ = sw_banded_plain(torch.from_numpy(q[live]),
                                torch.from_numpy(ql[live]), band, 86, 30, 46)
    s, p = plain.umi_positions(q[live], ql[live], rows, 46, chunk=5)
    np.testing.assert_array_equal(s, sc.numpy())
    np.testing.assert_array_equal(p, qp.numpy())


def test_bam_reader_reads_the_ports_writer(tmp_path):
    from nanoranger_torch.io.bam import BAMWriter
    path = str(tmp_path / "t.bam")
    with BAMWriter(path, ["g1", "g2"], [1000, 2000], index=True) as w:
        w.write("r1", 0, 0, 5, 60, [(2, "S"), (3, "="), (1, "X"), (4, "N"),
                                    (2, "=")], plain.encode(b"ACGTACGT"),
                b"IIIIIIII",
                tags={"NM": 1, "AS": 7, "CB": "AAAC", "UB": "TTG",
                      "XT": "g1"})
        w.write("r2", 16, 1, 9, 3, [(4, "=")], plain.encode(b"GGCC"), b"####",
                tags={"NM": 0, "CB": "C", "UB": "G", "XT": "x_y"})
    refs, recs = plain.read_bam(path)
    assert refs == ["g1", "g2"]
    assert [(r["name"], r["flag"], r["ref_id"], r["pos"], r["seq"])
            for r in recs] == [("r1", 0, 0, 5, "ACGTACGT"),
                               ("r2", 16, 1, 9, "GGCC")]
    assert recs[0]["cigar"] == [(2, "S"), (3, "="), (1, "X"), (4, "N"),
                                (2, "=")]
    assert recs[0]["tags"] == {"NM": 1, "AS": 7, "CB": "AAAC", "UB": "TTG",
                               "XT": "g1"}
    assert recs[1]["tags"]["XT"] == "x_y"


def test_cigar_check():
    ref = b"NNNNNACGTTCCCCAG"
    rec = {"pos": 5, "cigar": [(2, "S"), (3, "="), (1, "X"), (5, "N"),
                               (1, "I"), (2, "=")], "tags": {"NM": 1}}
    seq = b"GGACGAGAG"
    assert judge.Judge._cigar_fault(rec, seq, ref) == ""
    assert "NM 2" in judge.Judge._cigar_fault({**rec, "tags": {"NM": 2}},
                                               seq, ref)
    assert "equals" in judge.Judge._cigar_fault(rec, b"GGACGTGAG", ref)
    assert "differs" in judge.Judge._cigar_fault(rec, b"GGACCAGAG", ref)
    # a last block that claims one query base more than SEQ holds (blocks
    # overlapping on the query)
    assert judge.Judge._cigar_fault(
        {**rec, "cigar": rec["cigar"][:-1] + [(3, "=")]}, seq, ref + b"T")


def test_split_name_and_translate():
    reads = {"t0_ab-c": 1, "xy": 2}
    assert judge.split_name("t0_ab-c_3_9_16_G_1|E_5", reads) == \
        ("t0_ab-c", "3_9_16_G_1|E_5")
    assert judge.split_name("zz_1", reads) == (None, None)
    assert judge.translate("TGTGCCTGG") == "CAW"


def _port_records(panel, seqs, width):
    """The port's records of reads at a batch width, extended."""
    from nanoranger_torch.align.aligner import PanelAligner, extract_records
    from nanoranger_torch.align.index import PanelIndex
    from nanoranger_torch.ops.extend import extend_records_host
    idx = PanelIndex.from_fasta(panel)
    codes = np.full((len(seqs), width), plain.PAD, np.int8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = plain.encode(s)
        lens[i] = len(s)
    rec = extract_records(PanelAligner(idx, "cpu")._chain(codes, lens), idx)
    extend_records_host(rec, idx, codes, lens, "cpu")
    out = [[] for _ in seqs]
    for r in range(len(rec)):
        out[rec.read_idx[r]].append({
            "ref": int(rec.ref_id[r]), "strand": int(rec.strand[r]),
            "score": float(rec.score[r]), "qstart": int(rec.qstart[r]),
            "qend": int(rec.qend[r]), "tstart": int(rec.tstart[r]),
            "tend": int(rec.tend[r]), "flag": int(rec.flag[r])})
    return out


@pytest.mark.parametrize("sample,panel,width", [
    ("K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1", "RUNX1_RUNX1T1_ABL1_BCR.fa", 4096),
    ("K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1", "RUNX1_RUNX1T1_ABL1_BCR.fa", 1024),
    ("1022_DNMT3A_RUNX1_SF3B1", "panel_MT_trns.fa", 4096),
    ("slideseq_XCR", "XR_C_mouse.fa", 4096)])
def test_plain_aligner_equals_the_port(sample, panel, width):
    """Records, flags and extended spans of real reads; at width 1024 the
    long reads' minimizers and anchors are cut as the batch cuts them."""
    seqs = [s[:width] for s in _reads(os.path.join(
        ROOT, f"data/samples/{sample}.fastq.gz"), 48)]
    path = os.path.join(ROOT, "data", panel)
    ours = align.records(align.Index.from_fastas([path]),
                         [plain.encode(s) for s in seqs], width)
    theirs = _port_records(path, seqs, width)
    assert ours == theirs
    assert sum(map(len, ours)) > 20


def test_banded_alignment_equals_the_native_aligner():
    from nanoranger_torch.runtime.native_lib import banded_align_batch
    rng = np.random.default_rng(11)
    qs, ts = [], []
    for _ in range(40):
        t = rng.integers(0, 4, int(rng.integers(0, 160))).astype(np.int8)
        q = list(t)
        for _ in range(int(rng.integers(0, 12))):
            k = int(rng.integers(0, len(q) + 1))
            op = int(rng.integers(0, 3))
            if op == 0 and k < len(q):
                q[k] = (q[k] + 1) % 4
            elif op == 1:
                q.insert(k, int(rng.integers(0, 5)))
            elif k < len(q):
                del q[k]
        qs.append(np.asarray(q, np.int8))
        ts.append(t)
    qs.append(np.zeros(90, np.int8))         # beyond the band
    ts.append(np.zeros(3, np.int8))
    cig, sc, nm = banded_align_batch(qs, ts, band=48)
    for k, (q, t) in enumerate(zip(qs, ts)):
        c, s, n = vdj.banded_global(q, t)
        assert (c, n) == (cig[k], nm[k]), k
        if n >= 0:
            assert s == sc[k], k


def test_plain_cdr3_caller_equals_the_port(tmp_path):
    """The call of every subread of a 300-read slideseq sample: none,
    clean, rescued or partial, with its chain and junction."""
    from nanoranger_torch import pipeline
    from nanoranger_torch.vdj import caller
    with gzip.open(os.path.join(ROOT, "data/samples/slideseq_XCR.fastq.gz"),
                   "rb") as f:
        lines = f.read().split(b"\n")
    src = str(tmp_path / "in.fastq.gz")
    with gzip.open(src, "wb") as g:
        g.write(b"\n".join(lines[:4 * 300]) + b"\n")
    got, orig = {}, caller.assemble

    def capture(calls, **kw):
        for c in calls:
            got[c.name] = ("partial" if c.partial else "clean" if c.clean
                           else "rescued", c.chain, c.cdr3_nt)
        return orig(calls, **kw)

    caller.assemble = capture
    try:
        pipeline.run_pipeline(
            "3pXCR_slideseq", src, str(tmp_path / "out"), "s",
            trns_ref=os.path.join(ROOT, "data/XR_C_mouse.fa"),
            barcodes=os.path.join(ROOT, "data/slideseq.matched.barcodes."
                                  "tsv.gz"), device="cpu")
    finally:
        caller.assemble = orig
    subs = judge.read_fastq_records(str(tmp_path / "out/s_VDJ.fastq.gz"))
    width = 128
    while width < max(len(q) for _, q, _ in subs):
        width *= 2
    c = vdj.Caller([os.path.join(ROOT, "data", p)
                    for p in ("TR_V_mouse.fa", "IG_V_mouse.fa")])
    ours = c.calls([(n, q) for n, q, _ in subs], [width] * len(subs))
    theirs = [got.get(n, (None, "", "")) for n, _, _ in subs]
    assert ours == theirs
    kinds = {k for k, _, _ in ours}
    assert {"clean", "rescued", None} <= kinds


def test_clone_fits():
    nt = "TGTGCCAGCAGTTTAGGGACAGGGGCGAGCAGTACTTC"
    assert vdj.clone_fits("clean", nt, nt)
    assert vdj.clone_fits("clean", nt, nt[:5] + "A" + nt[6:])
    assert not vdj.clone_fits("clean", nt, nt[:5] + "AAA" + nt[8:])
    assert vdj.clone_fits("clean", "AAA" + nt, nt)          # nested
    assert vdj.clone_fits("rescued", nt[:-2], nt)
    assert not vdj.clone_fits("rescued", nt[:20], nt)
    assert vdj.clone_fits("partial", nt[:20], nt)
    assert vdj.clone_fits("clean", nt.replace("GGG", "NGG", 1), nt)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, 'portbench'); "
            "import reference.judge, reference.plain, reference.align, "
            "reference.vdj, traffic; "
            "import roofline.kernels, readers; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'nanoranger_torch', 'nanoranger_tpu', 'jax', 'jaxlib'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
