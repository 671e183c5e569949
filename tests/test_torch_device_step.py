"""The single-dispatch device step of the PyTorch port
(stages/device_step.py) and what comes with it, against the JAX package on
the CPU.

The same numpy batches (B=16 reads of 640 bases, on the graft entry's
synthetic two-gene panel) go through the JAX `build_device_step`, jitted
on the CPU, and through the port's `build_device_step(..., device="cpu")`,
which runs the kernels' plain versions and the host twin of the one-vs-all
DP: every output key must be bit-equal. Cases: the entry's own batch (one
chain a read, 1 in 8 barcodes mutated: the in-step DP, no spill),
synthetic 5' concatemers (two chains a read: a spill batch), 3p10XGEX,
3p10XTCR (rev_slice14 and the qlen-100 gate, no tier tables) and
3p10XTCR_nuc (rev_nuc with its gs < 35 reject). The port's step also gives
the accepted (read, barcode, UMI, gene) rows of the port's streamed path.
`_device_records` is held alone on chains with tied f;
`match_device_with(dp=True)` and `match_device` on structured candidates
(boundary-truncated rows, three DP chunks, a whitelist without tier
tables); `entry(device="cpu")` against the graft entry's step; and
`build_sharded_align` on a 2 x 2 CPU mesh against the JAX one on the
conftest's virtual devices and the port's 1 x 1 mesh.

The module fixture builds each JAX program once; a program is lowered and
compiled when a test first runs it (an XLA compile of a step takes 10-20 s
on a CPU), so no test waits for the compiles of the others."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.align import aligner as jax_aligner
from nanoranger_tpu.align.index import PanelIndex as JaxIndex
from nanoranger_tpu.parallel import sharded as jax_sharded
from nanoranger_tpu.stages import device_step as jax_device_step
from nanoranger_tpu.stages.barcode import BarcodeMatcher as JaxMatcher

from test_torch_barcode import _edit, _structured

from nanoranger_torch import chemistry, entry
from nanoranger_torch.align.aligner import PanelAligner
from nanoranger_torch.align.index import PanelIndex
from nanoranger_torch.chemistry import TRUSEQ
from nanoranger_torch.io.encode import (PAD, decode, encode, encode_batch,
                                        revcomp_str)
from nanoranger_torch.parallel.sharded import build_sharded_align, make_mesh
from nanoranger_torch.stages import barcode
from nanoranger_torch.stages.barcode import ACCEPT, BarcodeMatcher
from nanoranger_torch.stages.decon import run_decon
from nanoranger_torch.stages.device_step import (_device_records,
                                                 build_device_step)

torch.set_num_threads(1)

B, L, S = 16, 640, 2
NO_ADAPTER = 5


def _rand(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _batch(reads):
    assert len(reads) == B and max(map(len, reads)) <= L
    codes = np.full((B, L), PAD, np.int8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = encode(r)
        lens[i] = len(r)
    return codes, lens


def _reads(rng, mode, genes, wl):
    """B reads of `mode`'s layout on the two genes, barcodes from `wl` (every
    fourth with one substitution), every third read reverse-complemented."""
    out = []
    for i in range(B):
        g = genes[i % 2]
        bc = str(wl[int(rng.integers(len(wl)))])
        if i % 4 == 3:
            p = int(rng.integers(len(bc)))
            bc = bc[:p] + "ACGT".replace(bc[p], "")[int(rng.integers(3))] \
                + bc[p + 1:]
        if mode == "concat":          # two 5' units on the two genes
            r = "".join(_rand(rng, 25) + "CGCTCTTCCGATCT" + bc
                        + _rand(rng, 10) + "TTTCTTATATG"
                        + genes[(i + k) % 2][60 + 40 * k:300 + 40 * k]
                        for k in range(2))
        elif mode == "3p10XGEX":
            r = (g[40:490] + _rand(rng, 4 + 30 * (i % 3)) + "ACGC"
                 + revcomp_str(_rand(rng, 12)) + revcomp_str(bc) + TRUSEQ
                 + _rand(rng, 25))
        elif mode == "3p10XTCR":
            # the mapped span decides the qlen > 100 gate
            n = 90 if i % 5 == 4 else 350
            r = (_rand(rng, 100) + g[50:50 + n] + "AAAAAA" + _rand(rng, 28)
                 + TRUSEQ + _rand(rng, 20))
        else:                                       # 3p10XTCR_nuc
            flank = ("AA" if i % 8 == 7 else
                     "A" * 10 + revcomp_str(_rand(rng, 12))
                     + revcomp_str(bc))             # gs < 35: rejected
            r = g[40:490] + flank + TRUSEQ + _rand(rng, 25)
        out.append(revcomp_str(r) if i % 3 == 1 else r)
    return _batch(out)


# case -> (mode of the spec, batch)
CASES = {
    "5p-entry-no-spill": ("5p10XGEX", "entry"),
    "5p-concatemers-spill": ("5p10XGEX", "concat"),
    "3p10XGEX": ("3p10XGEX", "3p10XGEX"),
    "3p10XTCR": ("3p10XTCR", "3p10XTCR"),
    "3p10XTCR_nuc": ("3p10XTCR_nuc", "3p10XTCR_nuc"),
}


def _whitelist(world, mode):
    """The entry's 64 barcodes, or their first 14 bases as the bead list of
    the linker geometry (3p10XTCR)."""
    wl = world["wl"]
    if chemistry.get(mode).barcode.slideseq_linker:
        return np.asarray(sorted({b[:14] for b in wl}))
    return wl


def _match_candidates(rng, mode, wl):
    """Structured candidates (exact, edited, with an N, reverse strand, UMI
    cut short). With tier tables, 96 rows, most of which the DP takes: rows
    the boundary flags send there (the barcode cut at the query's start or
    end, rows of <= bc_len + 1 bases) and rows of 3-4 edits. Without tier
    tables every non-empty row goes to the DP: 602 rows."""
    bspec = chemistry.get(mode).barcode
    if bspec.slideseq_linker:
        return _structured(rng, bspec, wl, 600)
    seqs = _structured(rng, bspec, wl, 30)
    for bc in wl[:8]:
        seqs += [bc[2:] + _rand(rng, 10), bc[1:] + _rand(rng, 12),
                 _rand(rng, 4) + bc[:-1], _rand(rng, 6) + bc[:-2],
                 bc[:16], bc[3:] + "A"]
    while len(seqs) < 96:
        bc = str(wl[int(rng.integers(len(wl)))])
        seqs.append(_rand(rng, bspec.bc_query_offset) +
                    _edit(rng, bc, int(rng.integers(3, 5))) +
                    _rand(rng, bspec.umi_len + 3))
    return seqs


def _tied_chains(rng):
    """A chain_out of 8 reads x 64 slots whose f takes 4 values, so equal f
    meets across roots and slots; every slot is its own root or points at
    an earlier slot; some slots invalid."""
    n, A = 8, 64
    root = np.arange(A, dtype=np.int32)[None].repeat(n, 0)
    for b in range(n):
        for i in range(A):
            if rng.random() < 0.6 and i:
                root[b, i] = root[b, int(rng.integers(i))]
    valid = rng.random((n, A)) < 0.9
    root[rng.random((n, A)) < 0.05] = -1
    seg = np.sort(rng.integers(0, 4, (n, A)), axis=1).astype(np.int32)
    return {"t": rng.integers(0, 900, (n, A)).astype(np.int32),
            "q": rng.integers(0, 600, (n, A)).astype(np.int32),
            "qpos": rng.integers(0, 600, (n, A)).astype(np.int32),
            "seg": seg, "valid": valid, "strand": seg & 1,
            "f": rng.choice([30.0, 41.5, 55.0, 80.25], (n, A))
            .astype(np.float32),
            "root": root}, np.full(n, 640, np.int32)


class _Compiled(dict):
    """{name: callable} over the JAX programs {name: (jitted fn, args)}:
    each program is lowered and compiled at its first use, so a test waits
    only for the programs it runs."""

    def __init__(self, programs):
        super().__init__()
        self.programs = programs

    def __missing__(self, name):
        fn, args = self.programs[name]
        self[name] = fn.lower(*args).compile()
        return self[name]


@pytest.fixture(scope="module")
def world(module_rng):
    rng = module_rng
    jstep, (codes, lens) = jax_entry.entry()
    spec, index, wl, e_codes, e_lens = entry._synthetic_setup()
    assert np.array_equal(codes, e_codes) and np.array_equal(lens, e_lens)
    genes = [decode(s) for s in index.seq_codes]
    w = {"index": index, "wl": wl, "genes": genes,
         "jindex": JaxIndex.build(index.names, index.seq_codes),
         "batches": {"entry": (codes, lens)}}
    for mode in ("concat", "3p10XGEX", "3p10XTCR", "3p10XTCR_nuc"):
        w["batches"][mode] = _reads(rng, mode, genes, wl)

    # the JAX programs: the entry's step serves the 5' cases
    programs = {"5p10XGEX": (jstep, (codes, lens))}
    for mode in ("3p10XGEX", "3p10XTCR", "3p10XTCR_nuc"):
        jspec = jax_chemistry.get(mode)
        programs[mode] = (jax_device_step.build_device_step(
            jspec, w["jindex"], JaxMatcher(_whitelist(w, mode), jspec.barcode),
            S=S, max_minimizers=128), w["batches"][mode])

    # in-step matches against the jitted JAX one, at DP chunks of 16 (tier
    # tables, 96 rows) and of 4 (no tier tables, 12 rows): its CPU scan
    # pads the list to 16,384 rows, so chunks of 256 would take minutes.
    # Without tier tables also 602 rows (three DP launches of 256) against
    # the JAX package's CPU match, which its in-step match equals.
    for mode, chunk, n in (("5p10XGEX", 16, 96), ("3p10XTCR", 4, 12)):
        wl_m = _whitelist(w, mode)
        q, qlen = encode_batch(_match_candidates(rng, mode, wl_m),
                               max_len=96)
        jspec = jax_chemistry.get(mode).barcode
        if n < len(q):
            w["cand_full"] = (q, qlen, JaxMatcher(wl_m, jspec).match(q, qlen))
        jm = JaxMatcher(wl_m, jspec, dp_chunk=chunk)
        w[f"cand_{mode}"] = (q[:n], qlen[:n], jm.device_tables())
        programs[f"match_{mode}"] = (jax.jit(jm.match_device_with),
                                     w[f"cand_{mode}"])

    # _device_records alone: random chains with tied f, and real chains of
    # a panel that holds one transcript twice (two roots of equal f a read)
    tied = _tied_chains(rng)
    dup_idx = JaxIndex.build(["X1", "X2"], [index.seq_codes[0]] * 2)
    dup = _batch([genes[0][30:520] if i % 2 else
                  revcomp_str(genes[0][100:600]) for i in range(B)])
    dup_chain = jax_aligner.seed_and_chain(
        *map(jax.numpy.asarray, dup),
        *jax_aligner.prepare_index_arrays(dup_idx), max_minimizers=128)
    dup_chain = {k: np.asarray(v) for k, v in dup_chain.items()}
    w["records"] = {"tied": tied, "duplicated": (dup_chain, dup[1])}
    recs = jax.jit(lambda co, ln: jax_device_step._device_records(co, ln, S))
    for k, args in w["records"].items():
        programs[f"records_{k}"] = (recs, args)

    # the data-parallel candidate extraction on a 2 x 2 mesh
    programs["sharded_align"] = (jax_sharded.build_sharded_align(
        jax_chemistry.get("5p10XGEX"), w["jindex"],
        jax_sharded.make_mesh(2, 2)), (codes, lens))

    w["jax"] = _Compiled(programs)
    return w


def _np(out):
    return {k: np.asarray(v) for k, v in out.items()}


def _port_step(world, mode):
    spec = chemistry.get(mode)
    m = BarcodeMatcher(_whitelist(world, mode), spec.barcode, "cpu")
    return build_device_step(spec, world["index"], m, S=S,
                             max_minimizers=128, device="cpu"), m


@pytest.mark.parametrize("case", CASES)
def test_step_equals_jax(world, case):
    mode, bkey = CASES[case]
    codes, lens = world["batches"][bkey]
    want = _np(world["jax"][mode](codes, lens))
    if mode == "5p10XGEX":
        step, _ = entry.entry(device="cpu")
    else:
        step, _ = _port_step(world, mode)
    got = {k: v.numpy() for k, v in step(codes, lens).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    ok, st = got["rec_ok"], got["status"]
    assert int(got["n_deferred"]) == 0
    assert int(got["counts"].sum()) == int((st == ACCEPT).sum())
    if case == "5p-entry-no-spill":
        # every chain within the B compacted rows: the rest carry the
        # no-spill values; the mutated barcodes went through the DP
        assert 0 < ok.sum() <= B and (st[~ok] == NO_ADAPTER).all()
        assert (got["score"][~ok] == -(1 << 20)).all()
        assert (got["bc_idx"][~ok] == -1).all()
        assert (st == ACCEPT).sum() >= 12
    if case == "5p-concatemers-spill":
        assert ok.sum() > B                         # the spill pass ran
        assert (st != NO_ADAPTER).sum() == ok.sum() == 2 * B
        assert (st == ACCEPT).sum() > B
    if case == "3p10XGEX":
        assert (st == ACCEPT).sum() >= 8
    if case == "3p10XTCR":
        # the qlen gate drops the short spans' candidates; the others reach
        # the linker-geometry matcher (no tier tables: the DP)
        short = np.arange(B) % 5 == 4
        assert ok[short].any() and (st[short] == NO_ADAPTER).all()
        assert (st[~short] != NO_ADAPTER).any()
    if case == "3p10XTCR_nuc":
        wrap = np.arange(B) % 8 == 7
        assert ok[wrap].any() and (st[wrap] == NO_ADAPTER).all()
        assert (st[~wrap] == ACCEPT).sum() >= 8


def _streamed(spec, world, codes, lens, matcher):
    """(read, status, bc_idx, UMI, gene) of every candidate of the port's
    streamed path: PanelAligner, run_decon, BarcodeMatcher.match."""
    index = world["index"]
    rec = PanelAligner(index, "cpu").align(codes, lens)
    names = [f"r{i}" for i in range(B)]
    quals = [b"I" * int(n) for n in lens]
    out = run_decon(spec, codes, lens, names, quals, rec, index.names, "t",
                    device="cpu")
    q, qlen = encode_batch(out.bcumi_seqs, max_len=96)
    r = matcher.match(q, qlen)
    return {(int(rec.read_idx[out.bcumi_rec[k]]), int(r["status"][k]),
             int(r["bc_idx"][k]), decode(r["umi"][k]),
             index.names[int(rec.ref_id[out.bcumi_rec[k]])])
            for k in range(len(out.bcumi_rec))}


@pytest.mark.parametrize("case", CASES)
def test_step_equals_streamed(world, case):
    mode, bkey = CASES[case]
    codes, lens = world["batches"][bkey]
    step, m = _port_step(world, mode)
    r = {k: v.numpy() for k, v in step(codes, lens).items()}
    fused = {(i, int(r["status"][i, s]), int(r["bc_idx"][i, s]),
              decode(r["umi"][i, s]),
              world["index"].names[int(r["ref_id"][i, s])])
             for i in range(B) for s in range(S)
             if r["status"][i, s] != NO_ADAPTER}
    streamed = _streamed(chemistry.get(mode), world, codes, lens, m)
    assert len(streamed) >= 12
    assert fused == streamed


@pytest.mark.parametrize("kind", ["tied", "duplicated"])
def test_device_records_equal_jax_on_tied_f(world, kind):
    chain_np, lens = world["records"][kind]
    want = _np(world["jax"][f"records_{kind}"](chain_np, lens))
    got = _device_records({k: torch.from_numpy(np.array(v))
                           for k, v in chain_np.items()},
                          torch.from_numpy(lens), S)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    f, root = chain_np["f"], chain_np["root"]
    live = chain_np["valid"] & (root >= 0)
    # equal f across two roots of one read: the order of equal keys decides
    assert any(len(set(root[b][live[b] & (f[b] == v)])) > 1
               for b in range(len(f)) for v in np.unique(f[b][live[b]]))
    if kind == "duplicated":
        # both copies of the transcript chained with the same best f; the
        # tie decides which copy is the kept slot 0 (the other overlaps it)
        sc = got["score"].numpy()
        assert np.isfinite(sc).all() and (sc[:, 0] == sc[:, 1]).all()
        assert got["ok"].numpy()[:, 0].all()


MATCH_KEYS = ("bc_idx", "score", "status", "umi", "qpos")


@pytest.fixture()
def dp_launches(monkeypatch):
    """Candidate rows of each one-vs-all DP launch of the port's matcher."""
    rows = []
    verify_all = barcode.verify_all

    def counting(qq, *a, **kw):
        rows.append(qq.shape[0] // 2)
        return verify_all(qq, *a, **kw)

    monkeypatch.setattr(barcode, "verify_all", counting)
    return rows


@pytest.mark.parametrize("mode,chunk", [("5p10XGEX", 16), ("3p10XTCR", 4)],
                         ids=["tier-tables", "no-tier-tables"])
def test_match_device_with_dp_equals_jax(world, mode, chunk, dp_launches):
    """The in-step full match and match_device against the jitted JAX
    in-step match, at the same DP chunk (three launches or more)."""
    q, qlen, jtables = world[f"cand_{mode}"]
    want = [np.asarray(x) for x in world["jax"][f"match_{mode}"](
        q, qlen, jtables)]
    m = BarcodeMatcher(_whitelist(world, mode), chemistry.get(mode).barcode,
                       "cpu")
    m.DP_CHUNK = chunk
    qt, qlt = torch.from_numpy(q), torch.from_numpy(qlen)
    got = m.match_device_with(qt, qlt, m.device_tables())
    assert len(dp_launches) >= 3 and set(dp_launches[:-1]) == {chunk}
    via = m.match_device(qt, qlt)
    for k, name in enumerate(MATCH_KEYS):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=name)
        np.testing.assert_array_equal(via[k].numpy(), want[k], err_msg=name)
    if mode == "5p10XGEX":
        spec = m.spec
        bt = m.tables["bnd"]
        flagged = barcode.boundary_flags(qt, qlt, bt[0:4], spec.bc_len,
                                         spec.pad_left, spec.pad_right)
        # boundary-flagged rows went to the DP and were accepted there
        assert (flagged.numpy() & (want[2] == ACCEPT)).sum() >= 8


def test_match_device_with_dp_three_launches_of_256(world, dp_launches):
    """602 candidates against the bead list (no tier tables: every
    non-empty row to the DP) in three launches of 256, 256 and 89 rows:
    equal to the JAX package's CPU match."""
    q, qlen, want = world["cand_full"]
    m = BarcodeMatcher(_whitelist(world, "3p10XTCR"),
                       chemistry.get("3p10XTCR").barcode, "cpu")
    got = m.match_device_with(torch.from_numpy(q), torch.from_numpy(qlen),
                              m.device_tables())
    assert dp_launches == [256, 256, int((qlen > 0).sum()) - 512]
    for k, name in enumerate(MATCH_KEYS):
        np.testing.assert_array_equal(got[k].numpy(), want[name],
                                      err_msg=name)
    assert (want["status"] == ACCEPT).sum() > 100


def test_entry_equals_the_graft_entry(world):
    step, (codes, lens) = entry.entry(device="cpu")
    jcodes, jlens = world["batches"]["entry"]
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(lens, jlens)
    want = _np(world["jax"]["5p10XGEX"](jcodes, jlens))
    got = step(codes, lens)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the mutated barcodes: the in-step DP resolved them
    assert (want["status"][7::8, 0] == ACCEPT).any()


def test_step_refuses_the_slideseq_rule(world):
    """slideseq stays on the streamed path (its polyA filter is on the
    host), as in the JAX package."""
    spec = chemistry.get("3pXCR_slideseq")
    m = BarcodeMatcher(_whitelist(world, "3p10XTCR"), spec.barcode, "cpu")
    with pytest.raises(ValueError, match="rev_slideseq"):
        build_device_step(spec, world["index"], m, device="cpu")


def test_entry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        entry.entry()


@pytest.mark.parametrize("shape", [(2, 2), (1, 1)])
def test_sharded_align_equals_jax(world, shape):
    codes, lens = world["batches"]["entry"]
    want = [np.asarray(x) for x in world["jax"]["sharded_align"](codes,
                                                                 lens)]
    fn = build_sharded_align(chemistry.get("5p10XGEX"), world["index"],
                             make_mesh(*shape, ["cpu"]))
    got = [x.numpy() for x in fn(codes, lens)]
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_)
    assert got[2].sum() >= 12 and got[0].shape == (B * S, 96)
    if shape == (2, 2):
        with pytest.raises(ValueError, match="data blocks"):
            fn(codes[:15], lens[:15])
