"""The PyTorch port's 5p10XGEX slice end to end on the CPU.

Every artifact of nanoranger_torch.pipeline.run_pipeline(device="cpu") on
a K562 prefix is byte-identical (after gunzip) to the JAX package's
streamed run on the same input, against a reduced whitelist written here:
seeded rows of the 737K list plus every barcode the prefix carries. Also:
the port never imports JAX or the JAX package, and its entry points refuse
to fall back to the CPU when no card is there."""

import gzip
import hashlib
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import nanoranger_torch
from nanoranger_torch import pipeline
from nanoranger_torch.io import bam, whitelist
from nanoranger_torch.stages import barcode

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
SAMPLE = os.path.join(DATA, "samples",
                      "K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1.fastq.gz")
PANEL = os.path.join(DATA, "RUNX1_RUNX1T1_ABL1_BCR.fa")
WL = os.path.join(DATA, "737K-august-2016.txt.gz")
PKG = os.path.dirname(os.path.abspath(nanoranger_torch.__file__))
N_READS = 200


def _hash_artifacts(outdir):
    """sha1 of each artifact's content: gunzipped, a BAM after BGZF
    decompression."""
    out = {}
    for f in sorted(os.listdir(outdir)):
        p = os.path.join(outdir, f)
        if f.endswith((".pdf", "_runstats.json")) or f.endswith(".tmp"):
            continue  # pdfs embed timestamps; runstats is timings
        if f.endswith(".bam"):
            data = bam._bgzf_decompress(p)
        else:
            with (gzip.open if f.endswith(".gz") else open)(p, "rb") as fh:
                data = fh.read()
        out[f] = hashlib.sha1(data).hexdigest()
    return out


def _prefix_and_whitelist(tmp_path, sample=SAMPLE, n_random=6000):
    """An N_READS prefix of `sample` and a whitelist of n_random seeded
    rows of the 737K list plus every barcode the prefix carries."""
    with gzip.open(sample, "rt") as f:
        lines = [next(f) for _ in range(4 * N_READS)]
    fq = str(tmp_path / "prefix.fastq.gz")
    with gzip.open(fq, "wt") as g:
        g.writelines(lines)
    bcs = whitelist.load(WL)
    known = set(bcs.tolist())
    comp = str.maketrans("ACGT", "TGCA")
    carried = set()
    for seq in lines[1::4]:
        seq = seq.strip()
        for s in (seq[:200], seq[::-1].translate(comp)[:200]):
            carried.update(s[i:i + 16] for i in range(len(s) - 15)
                           if s[i:i + 16] in known)
    rng = np.random.default_rng(20261016)
    rows = set(bcs[rng.choice(len(bcs), n_random, replace=False)].tolist())
    rows |= carried
    assert 100 < len(carried) and len(rows) <= 8192
    wl_path = str(tmp_path / "wl.txt")
    with open(wl_path, "w") as f:
        f.write("\n".join(sorted(rows)) + "\n")
    return fq, wl_path


def test_artifacts_byte_identical_to_jax(tmp_path, monkeypatch):
    from nanoranger_tpu.pipeline import run_pipeline as jax_run_pipeline
    fq, wl_path = _prefix_and_whitelist(tmp_path)
    kw = dict(trns_ref=PANEL, genome_ref=str(tmp_path / "no_genome.fa"),
              barcodes=wl_path)
    monkeypatch.setenv("NANORANGER_NO_FAST", "1")   # the JAX streamed path
    jax_run_pipeline("5p10XGEX", fq, str(tmp_path / "jax"), "t", **kw)

    dp_rows = []
    verify_all = barcode.verify_all

    def counting_verify_all(qq, *a, **k):
        dp_rows.append(qq.shape[0] // 2)
        return verify_all(qq, *a, **k)

    monkeypatch.setattr(barcode, "verify_all", counting_verify_all)
    pipeline.run_pipeline("5p10XGEX", fq, str(tmp_path / "torch"), "t",
                          device="cpu", fast=False, **kw)
    want = _hash_artifacts(str(tmp_path / "jax"))
    got = _hash_artifacts(str(tmp_path / "torch"))
    assert set(want) >= {"t_deconcat.fastq.gz", "t_BCUMI.fasta.gz",
                         "t_assignments.csv.gz", "t_bcumi_dedup.csv",
                         "t_barcode_scores.csv"}
    assert got == want
    assert sum(dp_rows) > 0          # some rows went through the DP stage


def test_import_leaves_jax_out():
    code = ("import importlib, pkgutil, sys\n"
            "import nanoranger_torch\n"
            "for m in pkgutil.walk_packages(nanoranger_torch.__path__,"
            " 'nanoranger_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax'"
            " or m.startswith(('jax.', 'jaxlib', 'nanoranger_tpu'))]\n"
            "assert not bad, bad\n"
            "for m in ('vdj.caller', 'vdj.cdr3', 'vdj.clonotype',"
            " 'runtime.native_lib', 'stages.clones', 'io.bam',"
            " 'downstream.pileup', 'downstream.fusion_gene',"
            " 'parallel.sharded', 'tools.split_fastq',"
            " 'tools.merge_shards'):\n"
            "    assert 'nanoranger_torch.' + m in sys.modules, m\n"
            "print(len([m for m in sys.modules"
            " if m.startswith('nanoranger_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 28


IMPORT_RE = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|nanoranger_tpu|tools)\b"
    r"|__import__|importlib\.import_module\(\s*['\"](jax|nanoranger_tpu)",
    re.M)


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)


def test_source_scan_finds_no_jax():
    n = 0
    for path in _sources():
        with open(path) as fh:
            text = fh.read()
        assert not IMPORT_RE.search(text), path
        # the package does not even name the JAX package
        assert "nanoranger_tpu" not in text, path
        n += 1
    assert n >= 25
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        smoke = fh.read()
    # chip_smoke.py names the JAX package only as the location of the TPU
    # kernels it replaces, and imports nothing of it
    assert not IMPORT_RE.search(smoke)


def test_entry_points_refuse_the_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.run_pipeline("5p10XGEX", SAMPLE, str(tmp_path / "o"), "t",
                              trns_ref=PANEL, genome_ref="/nonexistent",
                              barcodes=WL)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.main(["--mode", "5p10XGEX", "--infile", SAMPLE,
                       "--outdir", str(tmp_path / "o"), "--expname", "t"])
    assert not os.path.exists(tmp_path / "o")


def test_later_slices_raise_not_implemented():
    """No slice is left to raise: the entry points that named the device
    step's slice (build_sharded_align, match_device_with(dp=True),
    match_device) run, and no module of the package raises
    NotImplementedError any more."""
    from nanoranger_torch import chemistry
    from nanoranger_torch.align.index import PanelIndex
    from nanoranger_torch.parallel import sharded
    from nanoranger_torch.io.encode import encode_batch
    from nanoranger_torch.stages.barcode import BarcodeMatcher
    rng = np.random.default_rng(9)
    spec = chemistry.get("5p10XGEX")
    index = PanelIndex.build(["G"], [rng.integers(0, 4, 500).astype(np.int8)])
    fn = sharded.build_sharded_align(
        spec, index, sharded.make_mesh(2, 2, devices=["cpu"]))
    codes = np.full((4, 256), 5, np.int8)
    cand, blen, hit = fn(codes, np.zeros(4, np.int32))
    assert cand.shape == (8, 96) and not hit.any() and not blen.any()
    bcs = np.asarray(["ACCGTTAGCATGCAAT", "TTTTCCCCGGGGAAAA"])
    m = BarcodeMatcher(bcs, spec.barcode, "cpu")
    q, ql = encode_batch(["G" * spec.barcode.bc_query_offset + bcs[0]
                          + "ACGTACGTAC" + "TTTCTT", ""], max_len=96)
    bc, _, status, _, _ = m.match_device(torch.from_numpy(q),
                                         torch.from_numpy(ql))
    assert bc.tolist() == [0, -1] and status[0] == 0
    for path in _sources():
        with open(path) as fh:
            assert "NotImplementedError" not in fh.read(), path


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_kernels_mode_fails_without_card_or_repo(tmp_path):
    """`--kernels` (phases 1 and 2 only) refuses, as the full run does, in a
    directory that holds only the script, and rejects an unknown flag."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for args in (["--kernels"], ["--verify"]):
        out = subprocess.run([sys.executable, "chip_smoke.py", *args],
                             cwd=tmp_path, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert out.stdout == ""
