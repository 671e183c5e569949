"""Port-side twins of tests/test_whitelist_h5.py: a 10x .h5 cell list
loaded by the port's io/whitelist (min_genes filter, the `load` dispatch)
and fed to its matcher, each result held to the JAX package's on the same
file as well as to the JAX test's assertions."""

import numpy as np
import pytest
import torch

from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.io import whitelist as jax_whitelist
from nanoranger_tpu.stages.barcode import BarcodeMatcher as JaxMatcher

from nanoranger_torch import chemistry
from nanoranger_torch.io import whitelist
from nanoranger_torch.io.encode import encode_batch
from nanoranger_torch.stages.barcode import ACCEPT, BarcodeMatcher

h5py = pytest.importorskip("h5py")
sp = pytest.importorskip("scipy.sparse")

torch.set_num_threads(1)


def _write_10x_h5(path, barcodes, genes_per_cell, n_genes=50):
    """Synthetic cellranger-style h5: CSC matrix, cells as columns, each
    cell expressing its requested number of genes."""
    cols = []
    for g in genes_per_cell:
        col = np.zeros(n_genes, np.int32)
        col[:g] = 1
        cols.append(col)
    mat = sp.csc_matrix(np.stack(cols, axis=1))
    with h5py.File(path, "w") as f:
        grp = f.create_group("matrix")
        grp.create_dataset("barcodes",
                           data=np.asarray([b.encode() for b in barcodes]))
        grp.create_dataset("data", data=mat.data)
        grp.create_dataset("indices", data=mat.indices)
        grp.create_dataset("indptr", data=mat.indptr)
        grp.create_dataset("shape", data=np.asarray(mat.shape))


def test_load_h5_min_genes(tmp_path):
    bcs = ["ACGTACGTACGTACGT-1", "CCCCACGTACGTACGT-1",
           "GGGGACGTACGTACGT-1", "TTTTACGTACGTACGT-1"]
    path = str(tmp_path / "cells.h5")
    _write_10x_h5(path, bcs, genes_per_cell=[25, 20, 4, 1])
    for min_genes, want in ((20, bcs[:2]), (4, bcs[:3])):
        got = whitelist.load_h5(path, min_genes=min_genes)
        assert list(got) == [b[:-2] for b in want]
        np.testing.assert_array_equal(
            got, jax_whitelist.load_h5(path, min_genes=min_genes))


def test_load_dispatches_h5(tmp_path):
    path = str(tmp_path / "cells.h5")
    _write_10x_h5(path, ["AAAACCCCGGGGTTTT-1"], genes_per_cell=[30])
    got = whitelist.load(path, min_genes=4)
    assert list(got) == ["AAAACCCCGGGGTTTT"]
    np.testing.assert_array_equal(got, jax_whitelist.load(path, min_genes=4))


def test_h5_whitelist_through_matcher(tmp_path):
    rng = np.random.default_rng(3)
    bcs = ["".join(rng.choice(list("ACGT"), 16)) + "-1" for _ in range(32)]
    path = str(tmp_path / "cells.h5")
    _write_10x_h5(path, bcs, genes_per_cell=[10] * 32)
    wl = whitelist.load(path, min_genes=4)
    m = BarcodeMatcher(wl, chemistry.get("3p10XTCR_nuc").barcode, "cpu")
    jm = JaxMatcher(jax_whitelist.load(path, min_genes=4),
                    jax_chemistry.get("3p10XTCR_nuc").barcode)
    # candidate: 7nt truseq-rc prefix + bc + 12nt umi; and two others
    umi = "".join(rng.choice(list("ACGT"), 12))
    seqs = ["GATCGGA" + wl[5] + umi + "AAAA",
            "GATCGGA" + wl[9][:10] + "T" + wl[9][11:] + umi + "AAAA",
            "".join(rng.choice(list("ACGT"), 40))]
    q, qlen = encode_batch(seqs, max_len=96)
    r = m.match(q, qlen)
    want = jm.match(q, qlen)
    for k in ("bc_idx", "score", "status", "umi"):
        np.testing.assert_array_equal(r[k], np.asarray(want[k]), err_msg=k)
    assert r["status"][0] == ACCEPT and r["bc_idx"][0] == 5
