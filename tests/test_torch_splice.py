"""The splice preset of the PyTorch port against the JAX package.

The chain DP's intron class (ops/chain.py with max_intron > 0, the plain
version of csrc/chain.cu's splice instantiation) against the JAX package's
XLA scan and its Pallas kernel in interpret mode; the port's exon
extraction and align_with_exons against the JAX ones on a synthetic 3-exon
gene with introns of 3,000 and 12,000; and the port's genome_stage, whose
tagged BAM (after BGZF decompression), .bai and _trns_ct.csv must equal
the JAX package's byte for byte, with the two introns as N ops.

Tolerance: f within 1e-5 relative (float32 gap costs), parents, roots,
records and exon blocks exactly equal."""

import os

import numpy as np
import pytest
import torch

from nanoranger_tpu.align.aligner import PanelAligner as JaxAligner
from nanoranger_tpu.align.aligner import _chain_dp_xla
from nanoranger_tpu.align.index import PanelIndex as JaxIndex
from nanoranger_tpu.ops.pallas_chain import chain_dp_pallas
from nanoranger_tpu.pipeline import genome_stage as jax_genome_stage

from nanoranger_torch import chemistry
from nanoranger_torch.align.aligner import (BANDWIDTH, MAX_GAP, MAX_INTRON,
                                            SPLICE_PEN, PanelAligner)
from nanoranger_torch.align.index import PanelIndex
from nanoranger_torch.align.minimizers import K
from nanoranger_torch.io import bam, fastq
from nanoranger_torch.io.encode import PAD, decode, revcomp
from nanoranger_torch.ops.chain import NEGF, chain_dp, chain_dp_plain
from nanoranger_torch.pipeline import genome_stage
from test_torch_chain import MASKS, mask_rows

torch.set_num_threads(1)

EXON_LENS = (400, 350, 500)
INTRON_LENS = (3_000, 12_000)
GENE_START = 120_000
GENOME_LEN = 300_000        # above the index's chunked-sketch limit


def _intron_anchors(rng, B=12, A=96, n_segs=3, full=False):
    """(seg, t, q)-sorted anchors whose second half of each seg jumps by an
    intron-sized target gap (tests/test_pallas_chain.py builds the same);
    with `full` in every slot."""
    t = np.zeros((B, A), np.int32)
    q = np.zeros((B, A), np.int32)
    seg = np.full((B, A), 1 << 30, np.int32)
    valid = np.zeros((B, A), bool)
    for b in range(B):
        n = A if full else int(rng.integers(20, A))
        sg = np.sort(rng.integers(0, n_segs, n)).astype(np.int32)
        tt = np.zeros(n, np.int64)
        for s in np.unique(sg):
            m = sg == s
            base = np.sort(rng.integers(0, 3000, m.sum()))
            if m.sum() > 4:
                half = m.sum() // 2
                base[half:] += int(rng.integers(MAX_GAP + 1000, 60_000))
            tt[m] = base
        qq = np.maximum(tt % 3000 + rng.integers(-40, 40, n), 0)
        order = np.lexsort((qq, tt, sg))
        t[b, :n] = tt[order]
        q[b, :n] = qq[order]
        seg[b, :n] = sg[order]
        valid[b, :n] = True
    return t, q, seg, valid


def _port_splice(t, q, seg, valid, splice_pen=SPLICE_PEN):
    out = chain_dp_plain(*(torch.from_numpy(a) for a in (t, q, seg, valid)),
                         K, MAX_GAP, BANDWIDTH, MAX_INTRON, splice_pen)
    return [x.numpy() for x in out]


def _n_splice_links(t, q, parent):
    b, i = np.nonzero(parent >= 0)
    p = parent[b, i]
    return int(((t[b, i] - t[b, p]) - (q[b, i] - q[b, p]) > BANDWIDTH).sum())


@pytest.mark.parametrize("trial", range(3))
def test_splice_plain_matches_xla(rng, trial):
    t, q, seg, valid = _intron_anchors(rng)
    f0, p0, r0 = (np.asarray(x) for x in _chain_dp_xla(
        t, q, seg, valid, MAX_GAP, BANDWIDTH, MAX_INTRON))
    f1, p1, r1 = _port_splice(t, q, seg, valid)
    np.testing.assert_allclose(f1[valid], f0[valid], rtol=1e-5)
    np.testing.assert_array_equal(p1, p0)
    np.testing.assert_array_equal(r1, r0)
    assert _n_splice_links(t, q, p1) > 0      # the intron arm was taken


@pytest.mark.parametrize("kind", MASKS)
def test_splice_plain_matches_xla_on_masks(rng, kind):
    """The splice class on anchors in every slot under masks with holes,
    all-invalid rows, all-valid rows and only a last chunk valid."""
    t, q, seg, _ = _intron_anchors(rng, full=True)
    valid = mask_rows(rng, *t.shape, kind)
    f0, p0, r0 = (np.asarray(x) for x in _chain_dp_xla(
        t, q, seg, valid, MAX_GAP, BANDWIDTH, MAX_INTRON))
    f1, p1, r1 = _port_splice(t, q, seg, valid)
    np.testing.assert_allclose(f1, f0, rtol=1e-5)     # every slot
    np.testing.assert_array_equal(p1, p0)
    np.testing.assert_array_equal(r1, r0)
    assert (f1[~valid] == NEGF).all()


def test_splice_plain_matches_pallas_interpret(rng):
    t, q, seg, valid = _intron_anchors(rng, B=6, A=80)
    f0, p0, r0 = (np.asarray(x) for x in chain_dp_pallas(
        t, q, seg, valid, K, MAX_GAP, BANDWIDTH, max_intron=MAX_INTRON,
        splice_pen=SPLICE_PEN, interpret=True))
    f1, p1, r1 = _port_splice(t, q, seg, valid)
    np.testing.assert_allclose(f1[valid], f0[valid], rtol=1e-5)
    np.testing.assert_array_equal(p1[valid], p0[valid])
    np.testing.assert_array_equal(r1[valid], r0[valid])
    assert _n_splice_links(t, q, p1) > 0


def test_splice_pen_and_class_switch(rng):
    """The wrapper hands max_intron and a float splice_pen to the plain
    version on CPU tensors; on a diagonal chain broken by one 5,000 intron
    the penalty moves f after the intron by its difference, and
    max_intron=0 (the map-ont class) does not cross the intron."""
    t, q, seg, valid = _intron_anchors(rng, B=4, A=64)
    args = [torch.from_numpy(a) for a in (t, q, seg, valid)]
    for x, y in zip(chain_dp(*args, K, MAX_GAP, BANDWIDTH, MAX_INTRON, 6.5),
                    chain_dp_plain(*args, K, MAX_GAP, BANDWIDTH, MAX_INTRON,
                                   6.5)):
        assert torch.equal(x, y)
    q2 = (10 + 15 * np.arange(20)).astype(np.int32)[None]
    t2 = (100 + q2 + np.where(np.arange(20) >= 10, 5_000, 0)).astype(np.int32)
    seg2, valid2 = np.zeros_like(t2), np.ones(t2.shape, bool)
    f6, p6, _ = _port_splice(t2, q2, seg2, valid2, 6.0)
    f65, p65, _ = _port_splice(t2, q2, seg2, valid2, 6.5)
    assert p6[0, 10] == p65[0, 10] == 9
    np.testing.assert_allclose(f6[0, 10:] - f65[0, 10:], 0.5, rtol=1e-4)
    np.testing.assert_array_equal(f6[0, :10], f65[0, :10])
    _, p_ont, _ = (x.numpy() for x in chain_dp(
        *(torch.from_numpy(a) for a in (t2, q2, seg2, valid2)),
        K, MAX_GAP, BANDWIDTH))
    assert p_ont[0, 10] == -1 and p_ont[0, 11] == 10


@pytest.fixture(scope="module")
def gene(module_rng):
    """A 300 kb genome with a 3-exon gene, and four reads: the exons with
    random flanks, their reverse complement, the bare exons, and one
    single-exon read elsewhere."""
    genome = module_rng.integers(0, 4, size=GENOME_LEN).astype(np.int8)
    exons, pos = [], GENE_START
    for i, el in enumerate(EXON_LENS):
        exons.append((pos, pos + el))
        pos += el + (INTRON_LENS[i] if i < len(INTRON_LENS) else 0)
    spliced = np.concatenate([genome[a:b] for a, b in exons])
    r0 = np.concatenate([module_rng.integers(0, 4, 60).astype(np.int8),
                         spliced,
                         module_rng.integers(0, 4, 50).astype(np.int8)])
    reads = [r0, revcomp(r0), spliced, genome[40_000:41_100].copy()]
    return genome, exons, reads


def _batch(reads):
    L = -(-max(len(r) for r in reads) // 128) * 128
    codes = np.full((len(reads), L), PAD, np.int8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = r
    return codes, np.asarray([len(r) for r in reads], np.int32)


def test_align_with_exons_equal_jax(gene):
    genome, exons, reads = gene
    codes, lens = _batch(reads)
    rec, blocks = PanelAligner(PanelIndex.build(["chr_syn"], [genome]),
                               "cpu", preset="splice").align_with_exons(
        codes, lens)
    jrec, jblocks = JaxAligner(JaxIndex.build(["chr_syn"], [genome]),
                               preset="splice").align_with_exons(codes, lens)
    for fld in ("read_idx", "ref_id", "strand", "flag", "qstart", "qend",
                "tstart", "tend", "score", "n_anchors", "root", "mapq"):
        np.testing.assert_array_equal(getattr(rec, fld), getattr(jrec, fld),
                                      err_msg=fld)
    assert blocks == jblocks
    assert sorted(rec.read_idx.tolist()) == [0, 1, 2, 3]
    for r in range(len(rec)):
        bl = blocks[r]
        if rec.read_idx[r] == 3:
            assert len(bl) == 1
            continue
        assert len(bl) == 3
        for (t_lo, t_hi, _, _), (a, b) in zip(bl, exons):
            assert abs(t_lo - a) <= 25 and abs(t_hi - b) <= 25
        assert abs(bl[1][0] - bl[0][1] - INTRON_LENS[0]) <= 50
        assert abs(bl[2][0] - bl[1][1] - INTRON_LENS[1]) <= 50


def test_genome_stage_bytes_equal_jax_with_two_introns(gene, tmp_path):
    from nanoranger_tpu import chemistry as jax_chemistry
    genome, exons, reads = gene
    gfa = str(tmp_path / "syn.fa")
    with open(gfa, "w") as f:
        f.write(">chr_syn\n" + decode(genome) + "\n")
    names = [f"read{i}_10_1200_{16 * (i == 1)}_GENE_{i}"
             for i in range(len(reads))]
    tag_map = {n: ("ACGT" * 4, "ACGTACGTAC", n.split("_", 4)[4])
               for n in names}
    outs = {}
    for side in ("jax", "torch"):
        out = tmp_path / side
        out.mkdir()
        with fastq.FastqWriter(str(out / "s_deconcat.fastq.gz")) as w:
            for n, r in zip(names, reads):
                w.write(n, decode(r), "".join(
                    chr(33 + (7 * i) % 40) for i in range(len(r))))
        outs[side] = str(out)
    jax_genome_stage(jax_chemistry.get("5p10XGEX"), outs["jax"], "s", gfa,
                     tag_map)
    genome_stage(chemistry.get("5p10XGEX"), outs["torch"], "s", gfa,
                 tag_map, "cpu")
    path = lambda side, suffix: os.path.join(outs[side], f"s_{suffix}")
    assert bam._bgzf_decompress(path("torch", "genome_tagged.bam")) == \
        bam._bgzf_decompress(path("jax", "genome_tagged.bam"))
    for suffix in ("genome_tagged.bam.bai", "trns_ct.csv"):
        with open(path("torch", suffix), "rb") as a, \
                open(path("jax", suffix), "rb") as b:
            assert a.read() == b.read(), suffix
    assert sorted(os.listdir(outs["torch"])) == sorted(os.listdir(outs["jax"]))

    _, _, it = bam.read_bam(path("torch", "genome_tagged.bam"))
    recs = {r.name: r for r in it}
    assert sorted(recs) == sorted(names)
    for n in names[:3]:                       # the spliced reads
        r = recs[n]
        n_ops = [k for (k, op) in r.cigar if op == "N"]
        assert len(n_ops) == 2
        assert abs(n_ops[0] - INTRON_LENS[0]) <= 50
        assert abs(n_ops[1] - INTRON_LENS[1]) <= 50
        span = sum(k for k, op in r.cigar if op in "=XDN")
        assert abs(span - (exons[-1][1] - exons[0][0])) <= 50
        assert r.tags["CB"] == "ACGT" * 4 and r.tags["XT"] == tag_map[n][2]
    assert not any(op == "N" for _, op in recs[names[3]].cigar)
