"""Port-side twins of tests/test_scale_paths.py: the scale-regime code
paths through the port, each held to the JAX package's output on the same
inputs as well as to the JAX test's assertions. A random 64-row list and
a 100,000-row product list (340 x 340 halves) through BarcodeMatcher.match
(the port's CPU matcher, the host C++ twin of the one-vs-all DP for the
rows with no tier hit); a 1,300-transcript PanelIndex.build and
PanelAligner reads hitting its first, middle and last entries; the
CandidateStore spilling at chunk=100; match_barcodes over a spilled store
equal to an in-memory one and to the JAX one."""

import os

import numpy as np
import pandas as pd
import torch

from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.align.aligner import PanelAligner as JaxPanelAligner
from nanoranger_tpu.align.index import PanelIndex as JaxPanelIndex
from nanoranger_tpu.io.candidate_store import CandidateStore as JaxStore
from nanoranger_tpu.pipeline import match_barcodes as jax_match_barcodes
from nanoranger_tpu.stages.barcode import BarcodeMatcher as JaxMatcher

from nanoranger_torch import chemistry
from nanoranger_torch.align.aligner import PanelAligner
from nanoranger_torch.align.index import PanelIndex
from nanoranger_torch.io.candidate_store import CandidateStore
from nanoranger_torch.io.encode import PAD, decode, encode, encode_batch
from nanoranger_torch.pipeline import match_barcodes
from nanoranger_torch.stages.barcode import (ACCEPT, MULTIMAP,
                                             BarcodeMatcher)

torch.set_num_threads(1)


def _mk_bcs(rng, n, k=16):
    seen = set()
    while len(seen) < n:
        seen.add("".join(rng.choice(list("ACGT"), k)))
    return np.asarray(sorted(seen))


def _match_both(wl, mode, seqs):
    q, qlen = encode_batch(seqs, max_len=96)
    got = BarcodeMatcher(wl, chemistry.get(mode).barcode, "cpu").match(
        q, qlen)
    want = JaxMatcher(wl, jax_chemistry.get(mode).barcode).match(q, qlen)
    for k in ("bc_idx", "score", "status", "umi"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    return got


def test_random_whitelist_structure_independent(rng):
    wl = _mk_bcs(rng, 64)
    r = _match_both(wl, "5p10XGEX",
                    ["CGCTCTTCCGATCT" + wl[17] + "ACGTACGTAC" + "TTTCT"])
    assert r["status"][0] == ACCEPT and r["bc_idx"][0] == 17


def test_product_whitelist_100k(rng):
    h1 = sorted({"".join(rng.choice(list("ACGT"), 8)) for _ in range(340)})
    h2 = sorted({"".join(rng.choice(list("ACGT"), 8)) for _ in range(340)})
    wl = np.asarray([a + b for a in h1 for b in h2][:100_000])
    picks = rng.integers(0, len(wl), 8)
    seqs = []
    for i, p in enumerate(picks):
        bc = list(wl[p])
        if i % 2:
            bc[rng.integers(0, 16)] = "ACGT"[rng.integers(0, 4)]  # 1 sub
        seqs.append("CGCTCTTCCGATCT" + "".join(bc) + "ACGTACGTAC" + "TTTCT")
    # and two rows with no tier structure: the exhaustive DP over 100K
    seqs += ["CGCTCTTCCGATCT" + "ACGTACGTACGTACGTACGT",
             "".join(rng.choice(list("ACGT"), 40))]
    r = _match_both(wl, "5p10XGEX", seqs)
    for i, p in enumerate(picks):
        if i % 2 == 0:   # exact plant: unique best at 16 -> ACCEPT
            assert r["status"][i] == ACCEPT and r["bc_idx"][i] == p
        else:            # 1-sub: ACCEPT(true bc at 14) or a real tie
            assert r["status"][i] in (ACCEPT, MULTIMAP)
            if r["status"][i] == ACCEPT and r["score"][i] == 14:
                assert r["bc_idx"][i] == p


def test_many_transcript_index_build(rng):
    n = 1300
    seqs = [rng.integers(0, 4, int(rng.integers(250, 900))).astype(np.int8)
            for _ in range(n)]
    names = [f"t{i}" for i in range(n)]
    index = PanelIndex.build(names, seqs)
    jindex = JaxPanelIndex.build(names, seqs)
    assert len(index.hashes) > 50_000
    for f in ("hashes", "tpos", "ref_id", "strand", "ref_lens"):
        np.testing.assert_array_equal(np.asarray(getattr(index, f)),
                                      np.asarray(getattr(jindex, f)), f)
    targets = [0, n // 2, n - 1]
    codes = np.full((4, 1024), PAD, np.int8)
    lens = np.zeros(4, np.int32)
    for row, t in enumerate(targets):
        e = encode(decode(seqs[t][:240]))
        codes[row, :len(e)] = e
        lens[row] = len(e)
    rec = PanelAligner(index, "cpu").align(codes, lens)
    jrec = JaxPanelAligner(jindex).align(codes, lens)
    for f in ("read_idx", "ref_id", "strand", "flag", "qstart", "qend",
              "tstart", "tend", "score", "n_anchors", "mapq"):
        np.testing.assert_array_equal(np.asarray(getattr(rec, f)),
                                      np.asarray(getattr(jrec, f)), f)
    got = {int(rec.read_idx[k]): int(rec.ref_id[k])
           for k in range(len(rec)) if rec.flag[k] < 2048}
    for row, t in enumerate(targets):
        assert got.get(row) == t, (row, t, got)


def test_candidate_store_spills_and_streams(tmp_path):
    names = [f"read{i}_0_50_0_GENE{i % 7}" for i in range(1037)]
    seqs = [f"ACGT{i:04d}" for i in range(1037)]
    st = CandidateStore(chunk=100, tmpdir=str(tmp_path / "port"))
    jst = JaxStore(chunk=100, tmpdir=str(tmp_path / "jax"))
    os.makedirs(tmp_path / "port"), os.makedirs(tmp_path / "jax")
    for nm, sq in zip(names, seqs):
        st.append(nm, sq)
        jst.append(nm, sq)
        assert st.buffered <= 100          # resident set bounded
        assert st.buffered == jst.buffered
    assert len(st) == 1037
    assert st.spilled_chunks == jst.spilled_chunks == 10
    got_n, got_s = [], []
    for bn, bs in st.iter_batches(64):
        got_n.extend(bn)
        got_s.extend(bs)
    assert got_n == names and got_s == seqs
    assert list(st.iter_batches(64)) == list(jst.iter_batches(64))
    assert st.head(3) == names[:3] == jst.head(3)
    assert st.tail(5) == names[-5:] == jst.tail(5)
    idx = [0, 99, 100, 512, 1036]
    assert [nm for nm, _ in st.rows(idx)] == [names[i] for i in idx]
    assert list(st.rows(idx)) == list(jst.rows(idx))
    assert st.names_list() == names
    st.close()
    jst.close()
    assert st.spilled_chunks == 0


def test_match_barcodes_streams_from_store(tmp_path, rng):
    spec = chemistry.get("5p10XGEX")
    wl = _mk_bcs(rng, 40)
    names, seqs = [], []
    for i in range(57):
        umi = "".join(rng.choice(list("ACGT"), 10))
        names.append(f"c{i}_0_10_0_G")
        seqs.append("CGCTCTTCCGATCT" + wl[i % len(wl)] + umi + "TTTCTTATATG")
    small = CandidateStore(chunk=16, tmpdir=str(tmp_path))   # forces spills
    small.extend(names, seqs)
    assert small.spilled_chunks >= 3
    dirs = [str(tmp_path / d) for d in ("a", "b", "c")]
    for d in dirs:
        os.makedirs(d)
    df1, res1 = match_barcodes(spec, wl, small, dirs[0], "s", "cpu",
                               batch=16)
    df2, res2 = match_barcodes(spec, wl,
                               CandidateStore.from_lists(names, seqs),
                               dirs[1], "s", "cpu", batch=16)
    df3, res3 = jax_match_barcodes(jax_chemistry.get("5p10XGEX"), wl,
                                   JaxStore.from_lists(names, seqs),
                                   dirs[2], "s", batch=16)
    pd.testing.assert_frame_equal(df1, df2)
    pd.testing.assert_frame_equal(df1, df3)
    np.testing.assert_array_equal(res1["bc_idx"], res2["bc_idx"])
    np.testing.assert_array_equal(res1["bc_idx"], res3["bc_idx"])
    assert (res1["status"] == ACCEPT).sum() >= 50
