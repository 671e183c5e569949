"""nanoranger_torch/tools/scale_bench.py against the JAX package's
tools/scale_bench.py on the CPU, and the port's repairs for the scale
regime.

Both tools' generators, from the seed they share, at mb=1 and n_refs=3
(refs of 333,333 bases: past SMALL_REF_LIMIT, so the index sketches them in
chunks), 20,000 product rows and 40 reads, write byte-identical files. On
those files the port tool's run (run_pipeline(device="cpu",
batch_size=512), the fused path) gives artifacts byte-identical to the JAX
run_pipeline's (its streamed path, whose artifacts the JAX package's tests
hold equal to its fused path's), and its result keys equal what the JAX
tool computes from the JAX outdir. The occurrence windows, now built in
row blocks on the index's device, equal the former host layout across
block seams and the JAX prepare_index_arrays through convert.py. The fused
step's fallback aligner takes the step's index tensors, and the step
refuses a reference its int32 offsets cannot address."""

import gzip
import importlib.util
import os

import numpy as np
import pandas as pd
import pytest
import torch

from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.align.aligner import prepare_index_arrays as jax_prepare
from nanoranger_tpu.align.index import PanelIndex as JaxIndex
from nanoranger_tpu.pipeline import run_pipeline as jax_run_pipeline
from nanoranger_tpu.stages.barcode import BarcodeMatcher as JaxMatcher

from test_torch_pipeline import _hash_artifacts

from nanoranger_torch import chemistry
from nanoranger_torch.align import aligner, index as port_index
from nanoranger_torch.align.index import SMALL_REF_LIMIT, PanelIndex
from nanoranger_torch.convert import state_from_jax_numpy
from nanoranger_torch.ops import mxu_lookup
from nanoranger_torch.stages.cli_step import build_cli_step
from nanoranger_torch.tools import scale_bench

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = {"mb": 1, "n_refs": 3, "n_wl": 20_000, "reads": 40}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_scale_bench", os.path.join(REPO, "tools", "scale_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JAX tool's files in jd, the port tool's in td, and each side's
    (barcodes, truth)."""
    jd = tmp_path_factory.mktemp("jax")
    td = tmp_path_factory.mktemp("torch")
    jt = _jax_tool()
    rng = np.random.default_rng(11)
    jt.gen_transcriptome(f"{jd}/txome.fa", SIZE["mb"], SIZE["n_refs"], rng)
    jbcs = jt.gen_whitelist(f"{jd}/wl.txt.gz", SIZE["n_wl"], rng)
    jtruth = jt.gen_reads(f"{jd}/reads.fastq.gz", f"{jd}/txome.fa", jbcs,
                          SIZE["reads"], rng)
    bcs, truth = scale_bench.synthesize(str(td), **SIZE)
    return str(jd), str(td), (jbcs, jtruth), (bcs, truth)


@pytest.fixture(scope="module")
def runs(files):
    """The port tool's result over td (the chunked sketch's calls counted)
    and the JAX run_pipeline over jd."""
    jd, td, _, (bcs, truth) = files
    chunked = []
    sketch = port_index._sketch_chunked
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_index, "_sketch_chunked",
                   lambda *a, **k: chunked.append(1) or sketch(*a, **k))
        res = scale_bench.measure(td, truth, SIZE["mb"], SIZE["n_refs"],
                                  len(bcs), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NANORANGER_NO_FAST", "1")
        jax_run_pipeline("5p10XGEX", f"{jd}/reads.fastq.gz", f"{jd}/out",
                         "sc", trns_ref=f"{jd}/txome.fa",
                         genome_ref="/nonexistent",
                         barcodes=f"{jd}/wl.txt.gz", batch_size=512)
    return res, len(chunked)


def test_generated_files_equal_the_jax_tools(files):
    jd, td, (jbcs, jtruth), (bcs, truth) = files
    with open(f"{jd}/txome.fa", "rb") as a, open(f"{td}/txome.fa", "rb") as b:
        fa = a.read()
        assert fa == b.read()
    for name in ("wl.txt.gz", "reads.fastq.gz"):
        with gzip.open(f"{jd}/{name}") as a, gzip.open(f"{td}/{name}") as b:
            assert a.read() == b.read(), name
    assert truth == jtruth and len(truth) == SIZE["reads"]
    assert np.array_equal(bcs, jbcs) and len(bcs) == SIZE["n_wl"]
    # every transcript takes the chunked sketch
    lens = PanelIndex.from_fasta(f"{td}/txome.fa").ref_lens
    assert fa.count(b">") == 3 and (lens > SMALL_REF_LIMIT).all()


def test_artifacts_equal_the_jax_pipeline(files, runs):
    jd, td, _, _ = files
    res, n_chunked = runs
    want = _hash_artifacts(f"{jd}/out")
    assert {"sc_deconcat.fastq.gz", "sc_BCUMI.fasta.gz",
            "sc_assignments.csv.gz", "sc_bcumi_dedup.csv"} <= set(want)
    assert _hash_artifacts(f"{td}/out") == want
    # the tool's index and the pipeline's: three chunked refs each
    assert n_chunked == 2 * SIZE["n_refs"]
    assert res["accepted"] > 0


def test_result_keys_equal_the_jax_tools_way(files, runs):
    jd, _, (_, jtruth), _ = files
    res, _ = runs
    # the JAX tool's own computation (tools/scale_bench.py main)
    df = pd.read_csv(f"{jd}/out/sc_assignments.csv.gz",
                     keep_default_na=False)
    acc_rows = df[df.status == 0]
    idx_of = {f"sr{i}": t for i, t in enumerate(jtruth)}
    n_ok = sum(1 for nm, bc in zip(acc_rows.name, acc_rows.bc)
               if idx_of.get(nm.split("_")[0]) == bc)
    want = {
        "n_minimizers": len(JaxIndex.from_fasta(f"{jd}/txome.fa").hashes),
        "accepted": int(len(acc_rows)),
        "accept_rate": round(len(acc_rows) / max(len(df), 1), 3),
        "bc_accuracy_of_accepted": round(n_ok / max(len(acc_rows), 1), 4)}
    assert {k: res[k] for k in want} == want
    assert res["whitelist"] == SIZE["n_wl"] and res["reads"] == SIZE["reads"]
    # on the CPU: no card line, no card memory, no kernel launched
    assert res["device"] == "cpu" and res["card"] is None
    assert res["card_peak_gb"] is None
    assert not any(res["launches"].values())
    assert res["index_table_gb"] > 0 and res["whitelist_tables_s"] >= 0
    assert res["stages"][0]["index_s"] > 0


def _host_windows(arrays, occ):
    """The former host build of the windows: one (E, occ) slot array, one
    gather an array."""
    E = len(arrays[0])
    out = np.zeros((-(-E // 128) * 128, occ, len(arrays)), np.int32)
    slot = (np.arange(E)[:, None] + np.arange(occ)[None, :]) % E
    for k, a in enumerate(arrays):
        out[:E, :, k] = np.asarray(a).astype(np.uint32).view(np.int32)[slot]
    return out


def test_windows_in_blocks_equal_the_host_layout_and_jax(files,
                                                         monkeypatch):
    jd, td, (jbcs, _), _ = files
    index = PanelIndex.from_fasta(f"{td}/txome.fa")
    t = index.tpos.astype(np.int32)
    seg = (index.ref_id.astype(np.int32) << 1) | index.strand.astype(np.int32)
    arrays = [t, index.hashes.astype(np.int32), seg]
    want = _host_windows(arrays, aligner.OCC_CAP)
    E = len(t)
    assert E > mxu_lookup.WINDOW_BLOCK // 8
    # seams inside the table and at its wrap-around end
    for block in (4099, E - 5, E, mxu_lookup.WINDOW_BLOCK):
        monkeypatch.setattr(mxu_lookup, "WINDOW_BLOCK", block)
        got = mxu_lookup.build_windows(arrays, aligner.OCC_CAP, "cpu")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), block
    monkeypatch.undo()

    own = aligner.prepare_index_arrays(index, "cpu")
    jspec = jax_chemistry.get("5p10XGEX").barcode
    jm = JaxMatcher(jbcs, jspec)
    tables = {"refs": np.asarray(jm.refs), "coreT": jm._coreT_np,
              "ex": jm._ex_np, "bnd": jm._bnd_np,
              "pad_left": jspec.pad_left,
              "umi_ref_offset": jspec.umi_ref_offset}
    conv, _ = state_from_jax_numpy(
        [np.asarray(a) for a in jax_prepare(JaxIndex.from_fasta(
            f"{jd}/txome.fa"))], tables, "cpu")
    for a, b in zip(own, conv):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_fallback_aligner_takes_the_step_tensors_and_offsets_are_guarded(
        files):
    _, td, _, _ = files
    index = PanelIndex.from_fasta(f"{td}/txome.fa")
    arrays = aligner.prepare_index_arrays(index, "cpu")
    al = aligner.PanelAligner(index, "cpu", index_arrays=arrays)
    assert all(a is b for a, b in zip(al._idx[torch.device("cpu")], arrays))
    with pytest.raises(ValueError, match="one device"):
        aligner.PanelAligner(index, "cpu", devices=["cpu", "meta"],
                             index_arrays=arrays)
    # 2^31 bases: the step's int32 offsets cannot reach the last ones
    big = PanelIndex(["a", "b"], [], np.array([1 << 30, 1 << 30], np.int32),
                     np.array([0, 1 << 30], np.int64),
                     np.zeros(0, np.uint32), *[np.zeros(0, np.int32)] * 3)
    with pytest.raises(ValueError, match="int32 offsets"):
        build_cli_step(chemistry.get("5p10XGEX"), big, device="cpu")
