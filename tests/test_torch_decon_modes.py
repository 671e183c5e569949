"""Decon stage of the PyTorch port (stages/decon.py::run_decon) against the
JAX package's, for every mode, on synthetic reads built as
tests/test_decon.py and tests/test_3pgex_e2e.py build them: the mode's
adapter structure beside a panel transcript, on both strands, as
concatemers, at varying distances (so the sliding sub-window scan hits in
its later windows too) and without an adapter. Both sides get the same
alignment records, so every field of the result must be equal."""

import numpy as np
import pytest
import torch

from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.align.aligner import PanelAligner as JaxPanelAligner
from nanoranger_tpu.align.index import PanelIndex as JaxPanelIndex
from nanoranger_tpu.io.encode import PAD, decode, encode, revcomp_str
from nanoranger_tpu.stages.decon import run_decon as jax_run_decon

from nanoranger_torch import chemistry
from nanoranger_torch.chemistry import SLIDESEQ_LINKER, TRUSEQ
from nanoranger_torch.stages.decon import run_decon

torch.set_num_threads(1)

MODES = ["5p10XGEX", "5p10XTCR", "RTX", "3pXCR_slideseq", "3p10XTCR",
         "3p10XTCR_nuc", "3p10XGEX"]


def _rand(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _mutate(rng, s, n):
    s = list(s)
    for _ in range(n):
        s[int(rng.integers(len(s)))] = "ACGT"[int(rng.integers(4))]
    return "".join(s)


def _unit(rng, mode, transcript, i):
    """One subread of `mode`: the transcript with its adapter structure."""
    tr = decode(transcript)
    if mode in ("5p10XGEX", "5p10XTCR"):
        umi = 10 if mode == "5p10XGEX" else 12
        adapter = _mutate(rng, "CGCTCTTCCGATCT", i % 3)
        return (_rand(rng, 25 + 30 * (i % 4)) + adapter + _rand(rng, 16 + umi)
                + "TTTCTTATATG" + tr)
    if mode == "RTX":
        return _rand(rng, 20) + tr + _rand(rng, 30 * (i % 6))
    if mode == "3pXCR_slideseq":
        linker = _mutate(rng, revcomp_str(SLIDESEQ_LINKER), i % 3)
        polya = "A" * (10 + 35 * (i % 3))
        return (_rand(rng, 120) + tr + polya + _rand(rng, 22) + linker
                + _rand(rng, 30))
    if mode == "3p10XTCR":
        return (_rand(rng, 360) + tr + _rand(rng, 10 * (i % 5)) + "AAAAAA"
                + _rand(rng, 28) + _mutate(rng, TRUSEQ, i % 3)
                + _rand(rng, 25))
    if mode == "3p10XTCR_nuc":
        return (tr + _rand(rng, 40 + 130 * (i % 5))
                + _mutate(rng, TRUSEQ, i % 3) + _rand(rng, 25))
    # 3p10XGEX: transcript + 4nt + rc(umi) + rc(bc) + TruSeq + junk
    return (tr + _rand(rng, 4 + 150 * (i % 3)) + _rand(rng, 28)
            + _mutate(rng, TRUSEQ, i % 4) + _rand(rng, 25))


def _reads(rng, mode, seqs):
    reads = []
    for i in range(14):
        lo = int(rng.integers(20, 120))
        tr = seqs[i % 2][lo:lo + 520]
        read = _unit(rng, mode, tr, i)
        if i % 5 == 4:                       # a concatemer of two subreads
            read += _unit(rng, mode, seqs[(i + 1) % 2][60:560], i + 1)
        if i % 3 == 1:
            read = revcomp_str(read)
        reads.append(read)
    reads.append(_rand(rng, 30) + decode(seqs[0][100:650]))   # no adapter
    reads.append(decode(seqs[1][40:600]))                     # no flank
    return reads


@pytest.fixture(scope="module")
def panel(module_rng):
    seqs = [module_rng.integers(0, 4, size=n).astype(np.int8)
            for n in (900, 800)]
    # names with the separators the modes' name rules split on
    return JaxPanelIndex.build(["TRBV1-1|x_1", "GENE2"], seqs), seqs


@pytest.mark.parametrize("mode", MODES)
def test_run_decon_equals_jax(panel, rng, mode):
    index, seqs = panel
    reads = _reads(rng, mode, seqs)
    L = ((max(len(r) for r in reads) + 127) // 128) * 128
    codes = np.full((len(reads), L), PAD, np.int8)
    lens = np.zeros(len(reads), np.int32)
    quals = []
    for i, r in enumerate(reads):
        codes[i, :len(r)] = encode(r)
        lens[i] = len(r)
        quals.append(bytes(33 + (j * 7 + i) % 40 for j in range(len(r))))
    names = [f"m{i}/ccs_{i}" for i in range(len(reads))]
    rec = JaxPanelAligner(index, extend_ends=True).align(codes, lens)
    assert len(rec) >= len(reads)

    want = jax_run_decon(jax_chemistry.get(mode), codes, lens, names, quals,
                         rec, index.names, sample="s")
    got = run_decon(chemistry.get(mode), codes, lens, names, quals, rec,
                    index.names, sample="s", device="cpu")
    for f in ("sub_names", "sub_seqs", "sub_quals", "bcumi_names",
              "bcumi_seqs", "eds_rows", "raw_bc_counts", "polyA",
              "raw_rows"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("sub_rec", "bcumi_rec", "eds_rec"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert len(got.sub_seqs) >= 8
    if mode != "RTX":
        assert len(got.bcumi_seqs) >= 8
        assert len(got.bcumi_seqs) < len(rec)      # and some were refused
