"""Staged whitelist match of the PyTorch port (exact tiers, then the
one-vs-all DP, then the banded UMI rescore) against the JAX package's
BarcodeMatcher on candidates that resolve in the tiers and candidates that
need the DP, over a seeded slice of the 737K whitelist; and on the other
chemistries' geometries (slideseq linker rows without tier tables, the
nuc and 3' GEX pads). Every output is an integer array and must be equal."""

import os

import numpy as np
import pytest
import torch

from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.stages.barcode import BarcodeMatcher as JaxMatcher
from nanoranger_tpu.stages.barcode import revcomp_rows as jax_revcomp_rows

from nanoranger_torch import chemistry
from nanoranger_torch.chemistry import SLIDESEQ_LINKER
from nanoranger_torch.io import whitelist
from nanoranger_torch.io.encode import encode_batch
from nanoranger_torch.stages import barcode
from nanoranger_torch.stages.barcode import ACCEPT, BarcodeMatcher

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WL = os.path.join(REPO, "data", "737K-august-2016.txt.gz")
ADAPTER = "CGCTCTTCCGATCT"
TAIL = "TTTCTTATATGGG"
COMP = str.maketrans("ACGT", "TGCA")


@pytest.fixture(scope="module")
def barcodes():
    bcs = whitelist.load(WL)
    rng = np.random.default_rng(1016)
    return np.sort(bcs[rng.choice(len(bcs), 3000, replace=False)])


def _edit(rng, bc, n_edits):
    bc = list(bc)
    for _ in range(n_edits):
        i = int(rng.integers(len(bc)))
        op = int(rng.integers(3))
        if op == 0:
            bc[i] = "ACGT"[(("ACGT".index(bc[i])) + 1 + int(rng.integers(3)))
                           % 4]
        elif op == 1:
            del bc[i]
        else:
            bc.insert(i, "ACGT"[int(rng.integers(4))])
    return "".join(bc)


def _candidates(barcodes, n=120, seed=7):
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(n):
        bc = barcodes[int(rng.integers(len(barcodes)))]
        umi = "".join(rng.choice(list("ACGT"), 10))
        kind = i % 6
        if kind in (0, 1):
            core = bc                              # exact: tier m
        elif kind == 2:
            core = _edit(rng, bc, 1)               # tiers m-1, m-2
        elif kind == 3:
            core = _edit(rng, bc, int(rng.integers(3, 5)))   # the DP
        elif kind == 4:
            core = bc[:3] + "N" + bc[4:]
        else:
            s = ADAPTER + bc + umi + TAIL
            seqs.append(s[::-1].translate(COMP))   # reverse strand
            continue
        seqs.append(ADAPTER[int(rng.integers(4)):] + core + umi
                    + TAIL[:int(rng.integers(len(TAIL)))])
    seqs += ["", "ACGT", ADAPTER + barcodes[0][:9]]
    return seqs


def test_revcomp_rows_equal(barcodes):
    q, qlen = encode_batch(_candidates(barcodes, 12), max_len=96)
    want = np.asarray(jax_revcomp_rows(q, qlen))
    got = barcode.revcomp_rows(torch.from_numpy(q), torch.from_numpy(qlen))
    np.testing.assert_array_equal(got.numpy(), want)


def test_staged_match_equals_jax(barcodes, monkeypatch):
    spec = chemistry.get("5p10XGEX").barcode
    q, qlen = encode_batch(_candidates(barcodes), max_len=96)
    dp_rows = []
    verify_all = barcode.verify_all

    def counting_verify_all(qq, *a, **kw):
        dp_rows.append(qq.shape[0] // 2)
        return verify_all(qq, *a, **kw)

    monkeypatch.setattr(barcode, "verify_all", counting_verify_all)
    got = BarcodeMatcher(barcodes, spec, "cpu").match(q, qlen)
    want = JaxMatcher(barcodes, jax_chemistry.get("5p10XGEX").barcode
                      ).match(q, qlen)
    for k in ("bc_idx", "score", "status", "umi", "qpos"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    # both stages were exercised: tier verdicts and DP rows
    assert sum(dp_rows) >= 10
    assert (got["status"] == ACCEPT).sum() >= 40
    assert len(set(got["status"].tolist())) >= 4


def _structured(rng, spec, barcodes, n):
    """Candidates laid out as the mode's BC-UMI slice: lead-in, barcode
    (around the linker for slideseq rows), UMI, tail; exact, lightly
    edited, heavily edited, with an N, reverse strand, and truncated."""
    seqs = []
    for i in range(n):
        bc = barcodes[int(rng.integers(len(barcodes)))]
        kind = i % 6
        if kind == 2:
            bc = _edit(rng, bc, 1)
        elif kind == 3:
            bc = _edit(rng, bc, int(rng.integers(2, 4)))
        elif kind == 4:
            bc = bc[:3] + "N" + bc[4:]
        core = (bc[:8] + SLIDESEQ_LINKER + bc[8:] if spec.slideseq_linker
                else bc)
        lead = "".join(rng.choice(list("ACGT"),
                                  spec.bc_query_offset + int(rng.integers(3))))
        umi = "".join(rng.choice(list("ACGT"), spec.umi_len))
        s = lead + core + umi + "".join(rng.choice(list("ACGT"),
                                                   int(rng.integers(0, 6))))
        if kind == 5:
            s = s[::-1].translate(COMP)
        if i % 11 == 10:
            s = s[:len(lead) + len(core) + 3]          # UMI cut short
        seqs.append(s)
    return seqs + ["", "ACGT"]


@pytest.mark.parametrize("mode", ["3pXCR_slideseq", "3p10XTCR",
                                  "3p10XTCR_nuc", "3p10XGEX"])
def test_staged_match_equals_jax_on_every_geometry(barcodes, mode):
    spec = chemistry.get(mode).barcode
    if spec.slideseq_linker:
        full = whitelist.load(os.path.join(
            REPO, "data", "slideseq.matched.barcodes.tsv.gz"))
        assert len(full) == 17753 and len(full[0]) == 14
        rng = np.random.default_rng(1016)
        bcs = np.sort(full[rng.choice(len(full), 600, replace=False)])
    else:
        bcs = barcodes
    rng = np.random.default_rng(len(mode) * 31 + spec.pad_left)
    q, qlen = encode_batch(_structured(rng, spec, bcs, 36), max_len=96)
    m = BarcodeMatcher(bcs, spec, "cpu")
    assert ("ex_keys" in m.tables) == (not spec.slideseq_linker)
    got = m.match(q, qlen)
    want = JaxMatcher(bcs, jax_chemistry.get(mode).barcode).match(q, qlen)
    for k in ("bc_idx", "score", "status", "umi", "qpos"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    assert (got["status"] == ACCEPT).sum() >= 10
    assert len(set(got["status"].tolist())) >= 4
