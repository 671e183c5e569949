"""The fused per-batch step of the PyTorch port (stages/cli_step.py)
against the JAX package's on the CPU.

The same numpy batch (B=32 reads at the 1024 bucket's width) goes through
the JAX `build_cli_step(spec, index, matcher=...)`, which runs on the CPU
through its XLA twins, and through the port's `build_cli_step(...,
device="cpu")`, which runs the kernels' plain versions: every output key
must be bit-equal. One case for each BC-UMI rule (slice, rev_slice14,
rev_slideseq, rev_nuc with the exact-class whitelist pass, rev_3pgex
without a matcher) and RTX with no scan; the slice rule on real K562 reads
(a batch whose accepted slots fit the B matched rows: no spill) and on
synthetic concatemers (reads with more than S=4 kept chains, a spill
batch, chains of one read in two segs); RTX on a panel holding one
transcript eight times (anchor overflow, equal-score chains whose order is
decided by root). `_records_exact` and `_extend_slots` are held on their
own too, against the JAX functions and against the port's own unfused
extract_records and extend_records_host on real reads. Chain scores are
floats: equal ordering is required, and the score itself within 1e-5
relative where a slot is emitted."""

import os

import jax
import numpy as np
import pytest
import torch

from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.align.index import PanelIndex as JaxIndex
from nanoranger_tpu.stages import cli_step as jax_cli_step
from nanoranger_tpu.stages.barcode import BarcodeMatcher as JaxMatcher

from test_torch_kernels_cuda import B, CLI_CASES as CASES, L, S, cli_world

from nanoranger_torch import chemistry
from nanoranger_torch.align import aligner
from nanoranger_torch.align.index import PanelIndex
from nanoranger_torch.io import fastq
from nanoranger_torch.io.encode import PAD
from nanoranger_torch.ops.extend import extend_records_host
from nanoranger_torch.stages import cli_step
from nanoranger_torch.stages.barcode import (ACCEPT, DP_PENDING,
                                             BarcodeMatcher)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
SAMPLE = os.path.join(DATA, "samples",
                      "K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1.fastq.gz")
PANEL = os.path.join(DATA, "RUNX1_RUNX1T1_ABL1_BCR.fa")


@pytest.fixture(scope="module")
def world(module_rng):
    """Panels, whitelists and the batches of every case."""
    return cli_world(module_rng)


def _steps(world, mode, panel_key, with_matcher):
    """The JAX step and the port's for one case, on the same panel and
    whitelist."""
    names, seqs = world[panel_key]
    spec, jspec = chemistry.get(mode), jax_chemistry.get(mode)
    m = jm = None
    if with_matcher:
        bcs = (world["wl_slideseq"] if spec.barcode.slideseq_linker
               else world["wl10"])
        m = BarcodeMatcher(bcs, spec.barcode, "cpu")
        jm = JaxMatcher(bcs, jspec.barcode)
    return (jax_cli_step.build_cli_step(jspec, JaxIndex.build(names, seqs),
                                        matcher=jm),
            cli_step.build_cli_step(spec, PanelIndex.build(names, seqs),
                                    matcher=m, device="cpu"))


@pytest.fixture(scope="module")
def steps(world):
    """Steps by (mode, panel, matcher), built once: a JAX step compiles
    at its first call, and the two slice cases share one."""
    cache = {}

    def get(*key):
        if key not in cache:
            cache[key] = _steps(world, *key)
        return cache[key]
    return get


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_step_equals_jax(world, steps, case):
    name, mode, bkey, panel_key, with_matcher = case
    codes, lens = world["batches"][bkey]
    (jstep, jtables), (step, tables) = steps(mode, panel_key, with_matcher)
    want = {k: np.asarray(v)
            for k, v in jax.device_get(jstep(codes, lens, jtables)).items()}
    got = {k: v.numpy() for k, v in step(codes, lens, tables).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    ok = got["ok"].reshape(B, S)
    acc = int(got["accept_bc"].sum())
    if with_matcher:
        assert "bc_idx" in got and got["umi"].dtype == np.int8
    if name == "slice-k562":
        # no spill: every accepted slot is among the B matched rows, the
        # rest carry the unmatched rows' values; tier hits and pending rows
        assert 0 < acc <= B
        st = got["status"]
        assert (st == ACCEPT).any() and (st == DP_PENDING).any()
        assert (st == 5).sum() == S * B - B
    if name == "slice-concatemers":
        assert acc > B                               # a spill batch
        assert got["defer"][:8].all() and (got["n_chains"][:8] > S).all()
        seg = (got["ref_id"] * 2 + got["strand"]).reshape(B, S)
        assert any(len(set(seg[i][ok[i]])) >= 2 for i in range(8, B))
        assert (got["status"] != 5).all()
        assert (got["status"][got["accept_bc"]] != DP_PENDING).any()
    if name == "rev_nuc":
        assert (got["status"][got["accept_bc"]] == ACCEPT).any()
    if name in ("rev_slice14", "rev_slideseq"):
        # bead-barcode structure: no tier tables, every candidate pending
        assert acc > 0
        assert (got["status"][got["accept_bc"]] == DP_PENDING).all()
    if name.startswith("rev_"):
        assert acc > 0 and got["hit"].any()
    if name == "rtx-overflow-ties":
        assert not got["hit"].any()
        assert got["defer"][0::3].all()                # X: 8 chains
        assert (got["n_chains"][1::3] == 3).all()      # Y: 3 equal chains
        assert not got["defer"][1::3].any()
        # the anchor overflow itself: X's anchors exceed the 4*256 slots
        names, seqs = world["overflow_panel"]
        ch = aligner.seed_and_chain(
            torch.from_numpy(codes), torch.from_numpy(lens),
            *aligner.prepare_index_arrays(PanelIndex.build(names, seqs),
                                          "cpu"), max_minimizers=256)
        assert ch["overflow"].numpy()[0::3].all()


def test_records_and_extension_equal_jax(world):
    """_records_exact and _extend_slots alone, on the concatemer batch: the
    JAX functions (jitted) and the port's take the same chain output, the
    port's seed_and_chain's (held against the JAX one in
    tests/test_torch_align.py)."""
    names, seqs = world["panel"]
    codes, lens = world["batches"]["concat"]
    idx = PanelIndex.build(names, seqs)
    tl = torch.from_numpy(lens)
    out = aligner.seed_and_chain(
        torch.from_numpy(codes), tl,
        *aligner.prepare_index_arrays(idx, "cpu"), max_minimizers=256)
    ref_lens = idx.ref_lens.astype(np.int32)
    jrec = jax.jit(jax_cli_step._records_exact, static_argnums=3)(
        {k: v.numpy() for k, v in out.items()}, lens, ref_lens, S)
    rec = cli_step._records_exact(out, tl, torch.from_numpy(ref_lens), S)
    ok = rec["ok"].numpy()
    assert ok.sum() > B and (rec["n_chains"].numpy() > S).any()
    for k, v in jrec.items():
        if k == "score":
            np.testing.assert_allclose(rec[k].numpy()[ok],
                                       np.asarray(v)[ok], rtol=1e-5)
        else:
            np.testing.assert_array_equal(rec[k].numpy(), np.asarray(v),
                                          err_msg=k)

    ref_flat = np.concatenate([np.asarray(s, np.int8) for s in seqs])
    ref_off = idx.ref_offset.astype(np.int32)
    jext = jax.jit(jax_cli_step._extend_slots, static_argnums=6)(
        codes, lens, jrec, ref_flat, ref_off, ref_lens, S)
    ext = cli_step._extend_slots(
        torch.from_numpy(codes), tl, rec, torch.from_numpy(ref_flat),
        torch.from_numpy(ref_off), torch.from_numpy(ref_lens), S)
    for k, v in jext.items():
        np.testing.assert_array_equal(ext[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_fused_records_equal_unfused_on_k562():
    """The fused records of 256 K562 reads of the 1024 bucket against the
    port's own unfused path (extract_records + extend_records_host): for
    every read the step keeps (not deferred), the same records in the same
    order, score ties decided by root as extract_records decides them."""
    batch = next(fastq.iter_batches(SAMPLE, 320, max_len=4096))
    sel = np.where(batch.lengths <= L)[0][:256]
    codes = np.full((len(sel), L), PAD, np.int8)
    codes[:, :batch.codes.shape[1]] = batch.codes[sel, :L]
    lens = np.asarray(batch.lengths, np.int32)[sel]
    idx = PanelIndex.from_fasta(PANEL)
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lens)
    ch = aligner.seed_and_chain(tc, tl, *aligner.prepare_index_arrays(
        idx, "cpu"), max_minimizers=256)
    ref_lens = torch.from_numpy(idx.ref_lens.astype(np.int32))
    rec = cli_step._records_exact(ch, tl, ref_lens, S)
    ext = cli_step._extend_slots(
        tc, tl, rec, torch.from_numpy(np.concatenate(idx.seq_codes)),
        torch.from_numpy(idx.ref_offset.astype(np.int32)), ref_lens, S)
    want = aligner.extract_records(ch, idx)
    score = rec["score"].numpy()
    extend_records_host(want, idx, codes, lens, "cpu")
    ok = rec["ok"].numpy()
    defer = rec["defer"].numpy()
    fused = {k: rec[k].numpy() for k in ("flag", "strand", "ref_id")}
    fused.update({k: v.numpy() for k, v in ext.items()})
    n_multi = 0
    for i in np.where(~defer)[0]:
        rows = np.where(want.read_idx == i)[0]
        slots = np.where(ok[i])[0]
        assert len(rows) == len(slots)
        n_multi += len(rows) > 1
        for k in ("flag", "strand", "ref_id", "qstart", "qend", "tstart",
                  "tend"):
            np.testing.assert_array_equal(fused[k][i, slots],
                                          getattr(want, k)[rows], err_msg=k)
        # fmax of each chain: the same float as _chain_summaries'
        np.testing.assert_array_equal(score[i, slots], want.score[rows])
    assert n_multi >= 10


def test_extension_re_rounds_equal_jax(world):
    """Slots whose spans sit 100 bases inside an exact match: each end
    takes three capped rounds of the F=48 extension DP, the rounds the
    JAX step runs under lax.cond and the port while a slot is active."""
    names, seqs = world["panel"]
    idx = PanelIndex.build(names, seqs)
    rng = np.random.default_rng(7)
    codes = np.full((B, L), PAD, np.int8)
    lens = np.zeros(B, np.int32)
    rec = {k: np.zeros((B, S), np.int32) for k in (
        "strand", "ref_id", "qstart", "qend", "tstart", "tend")}
    rec["ok"] = np.zeros((B, S), bool)
    long = [r for r in range(len(seqs)) if len(seqs[r]) >= 800]
    for i in range(B):
        rid = long[i % len(long)]
        lo = int(rng.integers(0, len(seqs[rid]) - 700))
        seg = np.asarray(seqs[rid][lo:lo + 600], np.int8)
        flank = rng.integers(0, 4, 200).astype(np.int8)
        read = np.concatenate([flank[:100], seg, flank[100:]])
        strand = i % 2
        if strand:
            read = np.asarray([3, 2, 1, 0, 4, 5], np.int8)[read][::-1]
        codes[i, :len(read)] = read
        lens[i] = len(read)
        n = len(read)
        q0, q1 = 100 + 100, 100 + 500          # stored coords, 100 inside
        rec["ok"][i, 0] = True
        rec["strand"][i, 0] = strand
        rec["ref_id"][i, 0] = rid
        rec["qstart"][i, 0] = n - q1 if strand else q0
        rec["qend"][i, 0] = n - q0 if strand else q1
        rec["tstart"][i, 0] = lo + 100
        rec["tend"][i, 0] = lo + 500
    ref_lens = idx.ref_lens.astype(np.int32)
    ref_flat = np.concatenate([np.asarray(x, np.int8) for x in seqs])
    ref_off = idx.ref_offset.astype(np.int32)
    want = jax.jit(jax_cli_step._extend_slots, static_argnums=6)(
        codes, lens, rec, ref_flat, ref_off, ref_lens, S)
    got = cli_step._extend_slots(
        torch.from_numpy(codes), torch.from_numpy(lens),
        {k: torch.from_numpy(v) for k, v in rec.items()},
        torch.from_numpy(ref_flat), torch.from_numpy(ref_off),
        torch.from_numpy(ref_lens), S)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    # the ends moved more than one round's flank of 48 bases
    moved = rec["tstart"][:, 0] - got["tstart"].numpy()[:, 0]
    assert (moved > 48).sum() >= B // 2


def test_exact_class_pass_equals_jax_and_the_full_match(world):
    """match_device_with(dp=False) against the JAX one on structured
    candidates, and its non-pending verdicts against the port's full
    staged match; dp=True and match_device name the slice that brings
    them."""
    import chip_smoke
    from nanoranger_tpu.io.encode import encode_batch as jax_encode_batch

    spec = chemistry.get("5p10XGEX").barcode
    bcs = world["wl10"]
    rng = np.random.default_rng(20261017)
    seqs, _ = chip_smoke.structured_candidates(rng, bcs, 160, spec,
                                               edits=(0, 3))
    seqs += ["", "ACGT" * 3]
    q, ql = jax_encode_batch(seqs, max_len=96)
    jm = JaxMatcher(bcs, jax_chemistry.get("5p10XGEX").barcode)
    want = [np.asarray(x) for x in jax.jit(
        lambda q, ql, t: jm.match_device_with(q, ql, t, dp=False))(
            q, ql, jm.device_tables())]
    m = BarcodeMatcher(bcs, spec, "cpu")
    got = [x.numpy() for x in m.match_device_with(
        torch.from_numpy(q), torch.from_numpy(ql), m.device_tables(),
        dp=False)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    status = got[2]
    done = status != DP_PENDING
    assert done.sum() > 40 and (~done).sum() > 20
    full = m.match(q, ql)
    for k, g in zip(("bc_idx", "score", "status", "umi"), got):
        np.testing.assert_array_equal(g[done], full[k][done], err_msg=k)
    with pytest.raises(NotImplementedError, match="device_step"):
        m.match_device_with(torch.from_numpy(q), torch.from_numpy(ql),
                            m.device_tables(), dp=True)
    with pytest.raises(NotImplementedError, match="device_step"):
        m.match_device(torch.from_numpy(q), torch.from_numpy(ql))
