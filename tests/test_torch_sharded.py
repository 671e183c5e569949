"""Data x whitelist sharding of the PyTorch port on the CPU.

The port's build_sharded_match, on a mesh whose cells all lie on the CPU,
equals the JAX package's on the conftest's virtual 8-device mesh and the
port's single-device BarcodeMatcher, bit for bit in every output: at mesh
shapes (4, 2), (2, 4) and (8, 1), on the slideseq geometry (no tier tables,
the DP alone) and with a shard that holds no barcode. A run_pipeline with
data_shards=4, wl_shards=2 writes the artifacts of the unsharded run; so
does split_fastq -> one run a part -> merge_shards, whose pipeline tail
rebuilds the score histogram from the merged checkpoint."""

import contextlib
import gzip
import os
import types
from unittest import mock

import numpy as np
import pytest
import torch

from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.parallel.sharded import ShardedWhitelist as JaxWhitelist
from nanoranger_tpu.parallel.sharded import \
    build_sharded_match as jax_build_sharded_match
from nanoranger_tpu.parallel.sharded import make_mesh as jax_make_mesh
from nanoranger_tpu.tools.split_fastq import split_fastq as jax_split_fastq

from test_sharded import _mk_candidates, _mk_whitelist
from test_torch_barcode import _candidates, _structured
from test_torch_pipeline import _hash_artifacts

from nanoranger_torch import chemistry, kernels, pipeline
from nanoranger_torch.align import aligner
from nanoranger_torch.io import bam, whitelist
from nanoranger_torch.io.encode import decode, encode_batch
from nanoranger_torch.io.fastq import iter_fastq
from nanoranger_torch.parallel import sharded
from nanoranger_torch.parallel.sharded import (ShardedWhitelist,
                                               build_sharded_match, make_mesh)
from nanoranger_torch.stages.barcode import ACCEPT, BarcodeMatcher
from nanoranger_torch.tools import merge_shards
from nanoranger_torch.tools.split_fastq import split_fastq

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLIDESEQ_WL = os.path.join(REPO, "data", "slideseq.matched.barcodes.tsv.gz")

# case -> (mode, whitelist rows, candidates, (n_data, n_wl))
CASES = {
    "4x2": ("5p10XGEX", 300, 64, (4, 2)),
    "2x4": ("5p10XGEX", 300, 64, (2, 4)),
    "8x1": ("5p10XGEX", 300, 64, (8, 1)),
    "slideseq_2x2": ("3pXCR_slideseq", 300, 16, (2, 2)),
    "empty_shard_2x4": ("5p10XGEX", 5, 32, (2, 4)),   # shards of 2, 2, 1, 0
}


def _inputs(rng, mode, n_bc, n):
    """(spec, whitelist, q, qlen). 300 5' rows: tests/test_sharded.py's
    candidates (exact, one substitution, one deletion); 5 rows: candidates
    that also need the DP (heavy edits, an N, the reverse strand, cut
    short, a core cut at either end); slideseq: such rows laid out around
    the linker."""
    spec = chemistry.get(mode).barcode
    if spec.slideseq_linker:
        full = whitelist.load(SLIDESEQ_WL)
        wl = np.sort(full[rng.choice(len(full), n_bc, replace=False)])
        q, qlen = encode_batch(_structured(rng, spec, wl, n - 2), max_len=96)
        return spec, wl, q, qlen
    if n_bc >= 64:
        wl = _mk_whitelist(rng, n_bc)
        q, qlen = _mk_candidates(rng, wl, n, spec)
        return spec, wl, q, qlen
    # two rows one substitution apart at their first base sort into
    # different shards: a candidate one substitution from both is a
    # cross-shard multimap at tier m-2
    twin = "".join(rng.choice(list("ACGT"), 15))
    wl = np.asarray(sorted(set(_mk_whitelist(rng, n_bc - 2)) |
                           {"A" + twin, "T" + twin}))
    edge = []
    for i in range(10):
        bc = wl[i % len(wl)]
        umi = "".join(rng.choice(list("ACGT"), spec.umi_len))
        lead = "".join(rng.choice(list("ACGT"), spec.bc_query_offset))
        # cores cut at a query edge (boundary-truncated alignments, which
        # the tier summaries leave to the DP), and the twins' neighbour
        edge.append([bc[1:] + umi, bc[2:] + umi + "TTTCT", lead + bc[:-1],
                     lead + bc[:-2], lead + "CG"[i % 2] + twin + umi][i % 5])
    q, qlen = encode_batch(_candidates(wl, n - 13, seed=n_bc) + edge,
                           max_len=96)
    return spec, wl, q, qlen


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_match_equals_jax_and_single_device(case, rng, monkeypatch):
    mode, n_bc, n, (n_data, n_wl) = CASES[case]
    spec, wl, q, qlen = _inputs(rng, mode, n_bc, n)
    r_valid = []
    verify_all = sharded.verify_all

    def recording_verify_all(qq, qql, coreT, rv, *a):
        r_valid.append(rv)
        return verify_all(qq, qql, coreT, rv, *a)

    monkeypatch.setattr(sharded, "verify_all", recording_verify_all)
    mesh = make_mesh(n_data, n_wl, devices=["cpu"])
    assert mesh.shape == (n_data, n_wl) and mesh.devices == [
        torch.device("cpu")]
    swl = ShardedWhitelist(wl, spec, n_wl)
    got = [x.numpy() for x in build_sharded_match(swl, mesh)(
        q, qlen, swl.device_arrays(mesh))]
    bc, score, status, umi, counts = got

    # the port's single-device matcher
    ref = BarcodeMatcher(wl, spec, "cpu").match(q, qlen)
    for k, v in (("status", status), ("bc_idx", bc), ("score", score),
                 ("umi", umi)):
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    acc = status == ACCEPT
    np.testing.assert_array_equal(
        counts.reshape(-1), np.bincount(bc[acc], minlength=counts.size))

    # the JAX package's sharded matcher and its shard tables
    jspec = jax_chemistry.get(mode).barcode
    jmesh = jax_make_mesh(n_data, n_wl)
    jswl = JaxWhitelist(wl, jspec, n_wl)
    want = jax_build_sharded_match(jswl, jmesh)(
        q, qlen, jswl.device_arrays(jmesh))
    for k, v, w in zip(("bc", "score", "status", "umi", "counts"), got,
                       want):
        np.testing.assert_array_equal(v, np.asarray(w), err_msg=k)
    for k in ("refs", "coreT", "n_real"):
        np.testing.assert_array_equal(getattr(swl, k), getattr(jswl, k))
    assert (swl.exact is None) == (jswl.exact is None) == \
        bool(spec.slideseq_linker)
    for k, v in (swl.exact or {}).items():
        np.testing.assert_array_equal(v, jswl.exact[k], err_msg=k)

    assert acc.sum() >= n // 4
    if n_bc < 64 or spec.slideseq_linker:
        # the one-vs-all DP ran on every shard at its own r_valid, and
        # more than accepted rows came out
        assert len(r_valid) % n_wl == 0 and len(r_valid) >= n_wl
        assert set(r_valid) == set(swl.n_real.tolist())
        assert len(set(status.tolist())) >= 3
    if case == "empty_shard_2x4":
        assert swl.n_real.tolist() == [2, 2, 1, 0]


def test_make_mesh_lays_cells_round_robin(capsys):
    devs = [torch.device("cpu"), torch.device("meta")]
    mesh = make_mesh(2, 3, devices=devs)
    assert [[c.type for c in row] for row in mesh.cells] == [
        ["cpu", "meta", "cpu"], ["meta", "cpu", "meta"]]
    assert "round-robin" in capsys.readouterr().out
    assert make_mesh(1, 1, devices=devs).cells == [[devs[0]]]
    with pytest.raises(ValueError):
        make_mesh(0, 2, devices=devs)


def test_launch_runs_on_the_card_of_its_tensors(monkeypatch):
    """A kernel whose tensors lie on cuda:1 launches with cuda:1 current
    and on cuda:1's stream, whatever card was current before; tensors on
    two cards are refused before any launch."""
    current = [torch.device("cuda", 0)]

    @contextlib.contextmanager
    def device(d):
        current.append(torch.device(d))
        yield
        current.pop()

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: (
        types.SimpleNamespace(cuda_stream=f"stream of {d}")))

    def tensor(dev, ptr):
        t = mock.MagicMock(spec=torch.Tensor)
        t.device = torch.device(dev)
        t.data_ptr.return_value = ptr
        return t

    calls = []

    def entry(*args):
        calls.append((current[-1], args))
        return 0

    before = kernels.launches["verify"]
    kernels.launch("verify", entry, tensor("cuda:1", 16), 7,
                   tensor("cuda:1", 32))
    assert calls == [(torch.device("cuda", 1),
                      (16, 7, 32, "stream of cuda:1"))]
    assert current == [torch.device("cuda", 0)]
    assert kernels.launches["verify"] == before + 1
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels.launch("verify", entry, tensor("cuda:0", 16),
                       tensor("cuda:1", 32))
    assert len(calls) == 1 and kernels.launches["verify"] == before + 1


def test_step_timers_cover_the_sharded_match(rng, monkeypatch):
    """With step_s set, each step of the sharded match is timed and the
    outputs are those of the untimed run."""
    spec, wl, q, qlen = _inputs(rng, "5p10XGEX", 5, 32)
    mesh = make_mesh(2, 4, devices=["cpu"])
    swl = ShardedWhitelist(wl, spec, 4)
    fn = build_sharded_match(swl, mesh)
    arrs = swl.device_arrays(mesh)
    want = fn(q, qlen, arrs)
    monkeypatch.setattr(sharded, "step_s", {})
    got = fn(q, qlen, arrs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(sharded.step_s) == {"tier_hits", "tier_merge", "dp",
                                   "dp_merge", "rescore", "verdicts",
                                   "gather"}
    assert all(h >= 0 and w >= 0 for h, w in sharded.step_s.values())


@pytest.fixture(scope="module")
def synthetic_sample(module_rng, tmp_path_factory):
    """tests/test_data_parallel.py's sample: 333 reads over two genes and
    64 barcodes (an odd count: partial batches, unequal split parts)."""
    d = tmp_path_factory.mktemp("dp")
    refs = [module_rng.integers(0, 4, size=n).astype(np.int8)
            for n in (900, 700)]
    trns = d / "panel.fa"
    with open(trns, "w") as f:
        for i, r in enumerate(refs):
            f.write(f">G{i}\n{decode(r)}\n")
    bcs = sorted({"".join(module_rng.choice(list("ACGT"), 16))
                  for _ in range(64)})
    wl = d / "wl.txt.gz"
    with gzip.open(wl, "wt") as f:
        f.write("\n".join(bcs) + "\n")
    fq = d / "reads.fastq.gz"
    with gzip.open(fq, "wt") as f:
        for i in range(333):
            bc = bcs[i % len(bcs)]
            umi = "".join(module_rng.choice(list("ACGT"), 10))
            pre = "".join(module_rng.choice(list("ACGT"), 25))
            gene = decode(refs[i % 2][40:640])
            r = pre + "CGCTCTTCCGATCT" + bc + umi + "TTTCTTATATG" + gene
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(fq), str(trns), str(wl)


@pytest.fixture(scope="module")
def unsharded(synthetic_sample, tmp_path_factory):
    """The unsharded CPU run of the sample, genome stage included."""
    fq, trns, wl = synthetic_sample
    out = tmp_path_factory.mktemp("one")
    pipeline.run_pipeline("5p10XGEX", fq, str(out), "t", trns_ref=trns,
                          genome_ref=trns, barcodes=wl, batch_size=64,
                          device="cpu")
    return out


def test_sharded_pipeline_byte_identical(synthetic_sample, unsharded,
                                         tmp_path, monkeypatch):
    fq, trns, wl = synthetic_sample
    shards = []
    chain = aligner.PanelAligner._chain

    def recording_chain(self, codes, lengths, shard=0):
        if not self.max_intron:       # the genome stage's splice run aside
            shards.append(shard)
        return chain(self, codes, lengths, shard)

    monkeypatch.setattr(aligner.PanelAligner, "_chain", recording_chain)
    many = tmp_path / "many"
    pipeline.main(["--mode", "5p10XGEX", "--infile", fq, "--outdir",
                   str(many), "--expname", "t", "--trns_ref", trns,
                   "--genome_ref", trns, "--barcodes", wl, "--batch_size",
                   "64", "--data_shards", "4", "--wl_shards", "2",
                   "--device", "cpu"])
    got = _hash_artifacts(str(many))
    want = _hash_artifacts(str(unsharded))
    # the genome stage's tagged BAM, its index and the gene counts too
    assert {"t_genome_tagged.bam", "t_genome_tagged.bam.bai",
            "t_trns_ct.csv"} <= set(want)
    assert got == want
    # the 6 read batches went round-robin over 4 data cells
    assert shards == [i % 4 for i in range(6)]


def test_split_fastq_cat_roundtrip(synthetic_sample, tmp_path):
    fq = synthetic_sample[0]
    parts = split_fastq(fq, 3, str(tmp_path / "torch"))
    jparts = jax_split_fastq(fq, 3, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in parts] == \
        [os.path.basename(p) for p in jparts] == \
        [f"reads.part_{k}.fastq.gz" for k in (1, 2, 3)]
    merged = []
    for p, jp in zip(parts, jparts):
        with gzip.open(p, "rb") as a, gzip.open(jp, "rb") as b:
            assert a.read() == b.read()
        merged.extend((r.name, r.seq, r.qual) for r in iter_fastq(p))
    assert merged == [(r.name, r.seq, r.qual) for r in iter_fastq(fq)]


def test_merge_shards_equals_unsharded(synthetic_sample, unsharded,
                                       tmp_path):
    fq, trns, wl = synthetic_sample
    dirs = []
    for k, p in enumerate(split_fastq(fq, 2, str(tmp_path))):
        d = tmp_path / f"shard{k}"
        pipeline.run_pipeline("5p10XGEX", p, str(d), "t", trns_ref=trns,
                              genome_ref=trns, barcodes=wl, batch_size=64,
                              device="cpu")
        dirs.append(str(d))
    merged = tmp_path / "merged"
    merge_shards.main(["--mode", "5p10XGEX", "--outdir", str(merged),
                       "--expname", "t", "--trns_ref", trns, "--genome_ref",
                       trns, "--barcodes", wl, "--device", "cpu", *dirs])

    def gunzip(path):
        with gzip.open(path, "rb") as f:
            return f.read()

    def raw(path):
        with open(path, "rb") as f:
            return f.read()

    # record streams identical (the merge concatenates gzip members)
    for art in ("t_deconcat.fastq.gz", "t_BCUMI.fasta.gz",
                "t_assignments.csv.gz"):
        assert gunzip(unsharded / art) == gunzip(merged / art), art
    # tables byte-identical, the score histogram rebuilt by the tail's
    # resume from the merged checkpoint
    for art in ("t_bcumi_dedup.csv", "t_trns_ct.csv",
                "t_barcode_scores.csv"):
        assert raw(unsharded / art) == raw(merged / art), art

    def bam_rows(path):
        names, lens, recs = bam.read_bam(str(path))
        return names, lens, [(r.name, r.flag, r.ref_id, r.pos, r.mapq,
                              tuple(r.cigar), r.seq, tuple(r.tags.items()))
                             for r in recs]

    assert bam_rows(unsharded / "t_genome_tagged.bam") == \
        bam_rows(merged / "t_genome_tagged.bam")
    for art in ("t_genome_tagged.bam.bai", "t_knee.pdf",
                "t_barcode_scores.pdf"):
        assert os.path.isfile(merged / art), art
