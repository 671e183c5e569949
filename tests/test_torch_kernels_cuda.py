"""The port's six Hopper kernel libraries against their plain versions on
the card, at ragged shapes and edges the main paths do not
exercise (chip_smoke.py holds them at the main-path shapes); the chain DP
in both of its gap classes, the adapter scan at the word boundaries of its
bit vectors, the banded rescore at the pipeline's pair counts, the full-row
rescore's split at the UMI column on rows whose optima lie left of it,
right of it and across it (held also by a torch model of the split,
`split_model`), the one-vs-all DP at the r_valid of whitelist shard tails;
and the sharded matcher with every mesh cell on the card against the card's
single-device matcher; the fused per-batch step on the card against the
same step on the CPU, and K1 and K2+K3 at the step's shapes; the
single-dispatch device step (the in-step K4 and K5 included) on the card
against the CPU for each BC-UMI rule, and K1 at its bench shape; the
three whitelist screens on the card against the CPU; the banded CIGAR
DP against the host C++ routine on random, empty, N-bearing, widened,
band-edge and 4,096-base segments, on a K562 genome-stage batch, and the
genome stage and the clonotyper with it against their host route. Every
test
is marked `cuda` and skips without a card. The file imports neither JAX nor
the JAX package, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import run_screens, screen_tables, split_rows
from nanoranger_torch import chemistry, kernels
from nanoranger_torch.chemistry import SLIDESEQ_LINKER, TRUSEQ
from nanoranger_torch.io import fasta, fastq, whitelist
from nanoranger_torch.io.encode import (N, PAD, decode, encode, encode_batch,
                                        revcomp_str)
from nanoranger_torch.ops.chain import chain_dp, chain_dp_plain
from nanoranger_torch.ops.edit_distance import hw_locate, hw_locate_plain
from nanoranger_torch.ops.sw import (sw_banded_plain, sw_end2end,
                                     sw_end2end_banded, sw_end2end_plain)
from nanoranger_torch.ops.whitelist_verify import verify_all, verify_all_plain
from nanoranger_torch.parallel.sharded import (ShardedWhitelist,
                                               build_sharded_match, make_mesh)
from nanoranger_torch.stages.barcode import BarcodeMatcher, revcomp_rows

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
WL_737K = os.path.join(DATA, "737K-august-2016.txt.gz")
WL_SLIDESEQ = os.path.join(DATA, "slideseq.matched.barcodes.tsv.gz")

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


def _anchors(rng, B, A, n=None):
    """(seg, t, q)-sorted anchors in a valid prefix of each read, of random
    length unless `n` is given."""
    t = np.zeros((B, A), np.int32)
    q = np.zeros((B, A), np.int32)
    seg = np.full((B, A), 1 << 30, np.int32)
    valid = np.zeros((B, A), bool)
    for b in range(B):
        nb = int(rng.integers(1, A)) if n is None else n
        sg = np.sort(rng.integers(0, 4, nb)).astype(np.int32)
        tt = rng.integers(0, 20000, nb)
        qq = np.maximum(tt % 5000 + rng.integers(-60, 60, nb), 0)
        order = np.lexsort((qq, tt, sg))
        t[b, :nb], q[b, :nb], seg[b, :nb] = tt[order], qq[order], sg[order]
        valid[b, :nb] = True
    return t, q, seg, valid


@pytest.mark.parametrize("B,A", [(37, 300), (5, 4096)])
def test_chain_kernel(dev, B, A):
    t, q, seg, valid = _anchors(np.random.default_rng(B * A), B, A)
    args = [torch.from_numpy(a).to(dev) for a in (t, q, seg, valid)]
    before = kernels.launches["chain"]
    f, p, r = chain_dp(*args, 15, 5000, 500)
    assert kernels.launches["chain"] == before + 1
    fp, pp, rp = chain_dp_plain(*args, 15, 5000, 500)
    _equal((p, r), (pp, rp))
    v = args[3]
    torch.testing.assert_close(f[v], fp[v], rtol=1e-5, atol=0)


def _intron_anchors(rng, B, A, n_segs=4, n=None):
    """(seg, t, q)-sorted anchors in a valid prefix of each read, of random
    length unless `n` is given; within each seg the later anchors jump by
    an intron-sized target gap, so the splice class links across it."""
    t = np.zeros((B, A), np.int32)
    q = np.zeros((B, A), np.int32)
    seg = np.full((B, A), 1 << 30, np.int32)
    valid = np.zeros((B, A), bool)
    for b in range(B):
        nb = int(rng.integers(1, A)) if n is None else n
        sg = np.sort(rng.integers(0, n_segs, nb)).astype(np.int32)
        qq = rng.integers(0, 3000, nb)
        tt = qq + rng.integers(-30, 30, nb)
        for s in np.unique(sg):
            m = np.flatnonzero(sg == s)
            for cut in np.sort(rng.choice(3000, 2, replace=False)):
                tt[m[qq[m] > cut]] += int(rng.integers(600, 150_000))
        tt = np.maximum(tt, 0)
        order = np.lexsort((qq, tt, sg))
        t[b, :nb], q[b, :nb], seg[b, :nb] = tt[order], qq[order], sg[order]
        valid[b, :nb] = True
    return t, q, seg, valid


@pytest.mark.parametrize("B,A", [(37, 300), (5, 4096), (512, 4096)])
def test_chain_kernel_splice(dev, B, A):
    t, q, seg, valid = _intron_anchors(np.random.default_rng(B + A), B, A)
    args = [torch.from_numpy(a).to(dev) for a in (t, q, seg, valid)]
    before = dict(kernels.launches)
    f, p, r = chain_dp(*args, 15, 5000, 500, 200_000, 6.0)
    assert kernels.launches["chain_splice"] == before["chain_splice"] + 1
    assert kernels.launches["chain"] == before["chain"]
    fp, pp, rp = chain_dp_plain(*args, 15, 5000, 500, 200_000, 6.0)
    _equal((p, r), (pp, rp))
    v = args[3]
    torch.testing.assert_close(f[v], fp[v], rtol=1e-5, atol=0)
    pn = p.cpu().numpy()
    b, i = np.nonzero(pn >= 0)
    j = pn[b, i]
    splice = (t[b, i] - t[b, j]) - (q[b, i] - q[b, j]) > 500
    assert splice.sum() > 0                   # the intron arm was taken


def test_chain_kernel_takes_a_float_splice_pen(dev):
    """A float splice_pen reaches the kernel whole: cut to an int on the way
    (a c_int argument), 6.5 would score as 6."""
    t, q, seg, valid = _intron_anchors(np.random.default_rng(7), 64, 512)
    args = [torch.from_numpy(a).to(dev) for a in (t, q, seg, valid)]
    f65, p65, _ = chain_dp(*args, 15, 5000, 500, 200_000, 6.5)
    fp65, pp65, _ = chain_dp_plain(*args, 15, 5000, 500, 200_000, 6.5)
    f6, _, _ = chain_dp(*args, 15, 5000, 500, 200_000, 6.0)
    _equal((p65,), (pp65,))
    v = args[3]
    torch.testing.assert_close(f65[v], fp65[v], rtol=1e-5, atol=0)
    assert bool((f65[v] < f6[v]).any())


def _masked_rows(rng, B, A, splice, kind):
    """Anchors in every slot of B reads, under a valid mask the kernel may
    not assume away: holes inside a valid prefix, every other row all
    invalid, every slot valid, valid slots only in the last 32-slot chunk,
    or ("ties") every slot valid on a diagonal whose points repeat three
    times, so equal scores meet in each window and the LAST argmax must
    win; the diagonal jumps by an intron halfway, which only the splice
    class links across."""
    if kind == "ties":
        pts = np.cumsum(rng.integers(20, 200, (B, A // 3 + 1)), axis=1)
        q = np.repeat(pts, 3, axis=1)[:, :A]
        t = q + np.where(np.arange(A) >= A // 2, 50_000, 0)
        return (t.astype(np.int32), q.astype(np.int32),
                np.zeros((B, A), np.int32), np.ones((B, A), bool))
    t, q, seg, _ = _intron_anchors(rng, B, A, n=A) if splice else \
        _anchors(rng, B, A, n=A)
    valid = np.zeros((B, A), bool)
    for b in range(B):
        if kind == "holes":
            n = int(rng.integers(A // 2, A + 1))
            valid[b, :n] = rng.random(n) < 0.7
        elif kind == "all_invalid":
            valid[b, :int(rng.integers(1, A + 1))] = b % 2 == 1
        elif kind == "all_valid":
            valid[b] = True
        else:
            valid[b, (A - 1) // 32 * 32:] = True
    return t, q, seg, valid


@pytest.mark.parametrize("splice", [False, True])
@pytest.mark.parametrize("kind,A", [
    ("holes", 33), ("holes", 300), ("holes", 4096), ("all_invalid", 300),
    ("all_invalid", 4096), ("all_valid", 33), ("all_valid", 4096),
    ("last_chunk", 33), ("last_chunk", 300), ("last_chunk", 4096),
    ("ties", 300), ("ties", 4096)])
def test_chain_kernel_masks(dev, splice, kind, A):
    """f at every slot (NEGF included), parents and roots equal to the
    plain version's, bit for bit, in both gap classes."""
    rng = np.random.default_rng(A + 7 * splice + len(kind))
    t, q, seg, valid = _masked_rows(rng, 19, A, splice, kind)
    args = [torch.from_numpy(a).to(dev) for a in (t, q, seg, valid)]
    cls = (200_000, 6.0) if splice else (0,)
    got = chain_dp(*args, 15, 5000, 500, *cls)
    want = chain_dp_plain(*args, 15, 5000, 500, *cls)
    _equal(got, want)
    if kind == "ties":
        p = got[1].cpu().numpy()
        assert (p[:, 3:A // 2] % 3 == 2).all()    # the last copy of a point
        assert (p[:, A // 2] >= 0).all() == splice   # across the intron


@pytest.mark.parametrize("W,m", [(100, 51), (37, 14), (128, 64), (129, 30),
                                 (150, 54), (220, 53), (270, 20), (40, 18),
                                 (512, 64)])
@pytest.mark.parametrize("wildcard,pick_last", [(True, True), (False, False),
                                                (True, False), (False, True)])
def test_ed_kernel(dev, W, m, wildcard, pick_last):
    rng = np.random.default_rng(W * m + 2 * wildcard + pick_last)
    R = 301
    p = [0.24, 0.24, 0.24, 0.24, 0.04]
    pattern = rng.choice(5, size=m, p=p).astype(np.int8)
    texts = rng.choice(5, size=(R, W), p=p).astype(np.int8)
    lengths = rng.integers(0, W + 1, size=R).astype(np.int32)
    for b in range(R):
        texts[b, lengths[b]:] = PAD
        if b % 3 == 0 and lengths[b] >= m:
            p0 = int(rng.integers(0, lengths[b] - m + 1))
            texts[b, p0:p0 + m] = pattern
            texts[b, p0 + int(rng.integers(0, m))] = int(rng.integers(0, 4))
    args = [torch.from_numpy(a).to(dev) for a in (pattern, texts, lengths)]
    got = hw_locate(*args, 6, wildcard, pick_last)
    want = hw_locate_plain(*args, 6, wildcard, pick_last)
    _equal(got, want)
    assert int((want[0] >= 0).sum()) > 20


def test_ed_kernel_takes_many_rows(dev):
    """The windowed scan flattens records x sub-windows: tens of thousands
    of 270-wide rows in one launch."""
    rng = np.random.default_rng(270)
    R, W, m = 11 * 4099, 270, 20
    pattern = rng.integers(0, 4, size=m).astype(np.int8)
    texts = rng.integers(0, 4, size=(R, W)).astype(np.int8)
    lengths = rng.integers(0, W + 1, size=R).astype(np.int32)
    for b in range(0, R, 7):
        if lengths[b] >= m:
            p0 = int(rng.integers(0, lengths[b] - m + 1))
            texts[b, p0:p0 + m] = pattern
    texts[np.arange(W)[None] >= lengths[:, None]] = PAD
    args = [torch.from_numpy(a).to(dev) for a in (pattern, texts, lengths)]
    got = hw_locate(*args, 2, False, False)
    want = hw_locate_plain(*args, 2, False, False)
    _equal(got, want)
    assert int((want[0] >= 0).sum()) > 4000


def test_ed_wrapper_states_its_limit(dev):
    z = torch.zeros((2, 513), dtype=torch.int8, device=dev)
    n = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="W <= 512"):
        hw_locate(torch.zeros(20, dtype=torch.int8, device=dev), z, n, 2)


def _ed_edges(rng, R, W, m, k, hits="some"):
    """R rows of W against a pattern of m with N in both: lengths 0, 1,
    m - 1 and W first, then random; with hits="some" every third row holds
    the pattern, with "all" every row (a length of at least m), with "none"
    no row can reach k (texts of one base, a pattern without it). Odd
    planted rows carry one substitution; row 4 ends its planted hit before
    column m + k."""
    if hits == "none":
        pattern = rng.integers(1, 4, size=m).astype(np.int8)
        texts = np.zeros((R, W), np.int8)
    else:
        p = [0.23, 0.23, 0.23, 0.23, 0.08]
        pattern = rng.choice(5, size=m, p=p).astype(np.int8)
        texts = rng.choice(5, size=(R, W), p=p).astype(np.int8)
    lo = m if hits == "all" else 0
    lengths = rng.integers(min(lo, W), W + 1, size=R).astype(np.int32)
    if hits != "all":
        lengths[:4] = (0, 1, min(max(m - 1, 0), W), W)
    for b in range(R):
        plant = hits == "all" or (hits == "some" and b % 3 == 0)
        if plant and lengths[b] >= m:
            p0 = 0 if b == 4 else int(rng.integers(0, lengths[b] - m + 1))
            texts[b, p0:p0 + m] = pattern
            if m > 1 and b % 2:
                texts[b, p0 + int(rng.integers(0, m))] = int(
                    rng.integers(0, 4))
        texts[b, lengths[b]:] = PAD
    return pattern, texts, lengths


@pytest.mark.parametrize("m", [1, 31, 32, 33, 63, 64])
@pytest.mark.parametrize("k,wildcard,pick_last", [
    (0, False, False), (0, True, True), (3, True, False), (3, False, True)])
def test_ed_kernel_word_edges(dev, m, k, wildcard, pick_last):
    """K2+K3 at the word boundaries of its bit vectors, k = 0, lengths 0,
    1, below m and W, N in pattern and text, R not a multiple of 32."""
    rng = np.random.default_rng(m * 8 + k * 2 + wildcard)
    pattern, texts, lengths = _ed_edges(rng, 333, 150, m, k)
    args = [torch.from_numpy(a).to(dev) for a in (pattern, texts, lengths)]
    before = kernels.launches["ed"]
    got = hw_locate(*args, k, wildcard, pick_last)
    assert kernels.launches["ed"] == before + 1
    want = hw_locate_plain(*args, k, wildcard, pick_last)
    _equal(got, want)
    assert int((want[0] >= 0).sum()) > 20


@pytest.mark.parametrize("hits", ["all", "none"])
@pytest.mark.parametrize("W,m,k", [(40, 18, 2), (270, 20, 3), (220, 53, 6),
                                   (100, 32, 2), (100, 33, 2)])
def test_ed_kernel_all_or_no_rows_hit(dev, hits, W, m, k):
    rng = np.random.default_rng(W + m + len(hits))
    pattern, texts, lengths = _ed_edges(rng, 1000, W, m, k, hits)
    args = [torch.from_numpy(a).to(dev) for a in (pattern, texts, lengths)]
    got = hw_locate(*args, k, True, hits == "all")
    want = hw_locate_plain(*args, k, True, hits == "all")
    _equal(got, want)
    n_hit = int((want[0] >= 0).sum())
    assert n_hit == (1000 if hits == "all" else 0)


@pytest.mark.parametrize("R,empty", [(100, 0.0), (3000, 0.75),
                                     (20000, 0.9), (20000, 0.0)])
@pytest.mark.parametrize("W,m,k", [(270, 20, 2), (220, 53, 6), (40, 18, 0)])
def test_ed_kernel_hits_across_chunks(dev, R, empty, W, m, k):
    """A block cuts its non-empty rows into chunks of C columns, C from a
    few columns (few rows a block) to W (every row non-empty); row b holds
    the pattern at offset b mod (W - m + 1), so every chunk boundary lies
    inside some row's hit, and the empty rows change C."""
    rng = np.random.default_rng(R + W + m)
    pattern = rng.integers(0, 4, size=m).astype(np.int8)
    texts = rng.integers(0, 4, size=(R, W)).astype(np.int8)
    lengths = np.full(R, W, np.int32)
    lengths[rng.random(R) < empty] = 0
    for b in range(R):
        p0 = b % (W - m + 1)
        texts[b, p0:p0 + m] = pattern
        if k and b % 2:
            texts[b, p0 + int(rng.integers(0, m))] ^= 1
    texts[np.arange(W)[None] >= lengths[:, None]] = PAD
    args = [torch.from_numpy(a).to(dev) for a in (pattern, texts, lengths)]
    for wildcard, pick_last in ((False, False), (True, True)):
        got = hw_locate(*args, k, wildcard, pick_last)
        want = hw_locate_plain(*args, k, wildcard, pick_last)
        _equal(got, want)
        assert int((want[0] >= 0).sum()) >= int((lengths > 0).sum()) // 2


def test_ed_kernel_any_text_code_and_odd_base_address(dev):
    """Text codes outside 0..5 score as the plain version scores them, and
    texts at an odd address (a view) stage byte by byte."""
    rng = np.random.default_rng(5)
    pattern, texts, lengths = _ed_edges(rng, 301, 129, 30, 4)
    odd = rng.random(texts.shape) < 0.05
    texts[odd] = rng.choice(np.array([6, 7, 127, -1, -128], np.int8),
                            int(odd.sum()))
    flat = torch.zeros(texts.size + 1, dtype=torch.int8, device=dev)
    flat[1:] = torch.from_numpy(texts.ravel()).to(dev)
    view = flat[1:].view(texts.shape)
    assert view.data_ptr() % 16 != 0
    p, n = (torch.from_numpy(a).to(dev) for a in (pattern, lengths))
    for wildcard in (False, True):
        want = hw_locate_plain(p, view, n, 4, wildcard, False)
        _equal(hw_locate(p, view, n, 4, wildcard, False), want)
        _equal(hw_locate(p, view.contiguous(), n, 4, wildcard, False), want)


def _verify_inputs(rng, m, Lq, R, C, edges):
    """Candidates against R random cores of m. Rows 5, 261, 517 and 777
    share a core (ties across row blocks of 256), every fourth candidate
    carries it (ties across candidate groups of 16). With `edges`: N and PAD
    in the cores and PAD in the queries, rows 10 and 11 equal (a tie inside
    one thread's row pair, carried by candidates 2, 6, ...), the first
    candidate Lq long and the last empty."""
    cores = rng.integers(0, 4, size=(R, m)).astype(np.int8)
    if edges:
        u = rng.random((R, m))
        cores[u < 0.03] = N
        cores[(u >= 0.03) & (u < 0.05)] = PAD
        cores[11] = cores[10]
    for r in (261, 517, 777):
        if r < R:
            cores[r] = cores[5]
    q = np.full((C, Lq), PAD, np.int8)
    qlen = rng.integers(0, Lq + 1, size=C).astype(np.int32)
    if edges:
        qlen[::4] = np.clip(qlen[::4], m + 10, Lq)
        qlen[0] = Lq
        qlen[-1] = 0 if C > 1 else Lq
    for i in range(C):
        q[i, :qlen[i]] = rng.integers(0, 5, qlen[i])       # N included
        if edges:
            q[i, :qlen[i]][rng.random(qlen[i]) < 0.03] = PAD
        if qlen[i] >= m + 10 and i % 2 == 0:
            r = 5 if i % 4 == 0 else 10 if edges else int(rng.integers(R))
            q[i, 10:10 + m] = cores[r]
    return q, qlen, np.ascontiguousarray(cores.T)


@pytest.mark.parametrize("m,Lq,R,C,r_valid,pads,edges", [
    (16, 96, 1000, 70, 997, (30, 40), False),
    (32, 128, 1000, 70, 997, (30, 40), False),
    (32, 96, 17753, 70, 17750, (30, 40), False),
    # odd R, r_valid between the two rows of one thread, C = group + 1
    (16, 128, 1001, 17, 999, (0, 40), True),
    (32, 128, 1025, 1, 1023, (30, 0), True),           # C = 1
    (16, 128, 1537, 33, 1535, (0, 0), True),
    (32, 96, 513, 16, 513, (15, 24), True),
    (16, 96, 1001, 40, 300, (30, 40), True),           # dead row blocks
    (16, 20, 300, 20, 257, (200, 300), True),          # pads past Lq
    (32, 128, 700, 5, 0, (3, 3), False),               # no live row
])
def test_verify_kernel(dev, m, Lq, R, C, r_valid, pads, edges):
    """K4 equals its plain version bit for bit: best, smallest index and
    ties."""
    rng = np.random.default_rng(m * Lq + R + C)
    q, qlen, coreT = _verify_inputs(rng, m, Lq, R, C, edges)
    args = (torch.from_numpy(q).to(dev), torch.from_numpy(qlen).to(dev),
            torch.from_numpy(coreT).to(dev), r_valid, *pads)
    before = kernels.launches["verify"]
    got = verify_all(*args)
    assert kernels.launches["verify"] == before + 1
    want = verify_all_plain(*args)
    _equal(got, want)
    if C > 1 and r_valid > 777:
        assert int((want[2] > 1).sum()) > 0


def test_verify_kernel_any_query_code_and_negative_length(dev):
    """Query codes outside 0..5 score as the plain version scores them (0
    against an N core, -1 elsewhere), and a negative length as 0 does."""
    rng = np.random.default_rng(11)
    q, qlen, coreT = _verify_inputs(rng, 16, 96, 1000, 20, True)
    odd = rng.random(q.shape) < 0.05
    q[odd] = rng.choice(np.array([6, 7, 127, -1, -128], np.int8),
                        int(odd.sum()))
    qlen[1], qlen[3] = -3, -100
    args = (torch.from_numpy(q).to(dev), torch.from_numpy(qlen).to(dev),
            torch.from_numpy(coreT).to(dev), 998, 30, 40)
    _equal(verify_all(*args), verify_all_plain(*args))


def test_verify_kernel_odd_base_address(dev):
    """coreT at an odd address: the row pairs load byte by byte."""
    rng = np.random.default_rng(7)
    q, qlen, coreT = _verify_inputs(rng, 16, 96, 1000, 20, True)
    flat = torch.zeros(coreT.size + 1, dtype=torch.int8, device=dev)
    flat[1:] = torch.from_numpy(coreT.ravel()).to(dev)
    odd = flat[1:].view(coreT.shape)
    assert odd.data_ptr() % 2 == 1
    args = (torch.from_numpy(q).to(dev), torch.from_numpy(qlen).to(dev),
            odd, 998, 30, 40)
    _equal(verify_all(*args), verify_all_plain(*args))


@pytest.mark.parametrize("pad_left,core,pad_right", [(30, 16, 40),
                                                     (15, 32, 24)])
def test_sw_banded_kernel(dev, pad_left, core, pad_right):
    rng = np.random.default_rng(pad_left * core)
    P, Lq = 300, 96
    Lr = pad_left + core + pad_right
    c = pad_left + core
    q = np.full((P, Lq), PAD, np.int8)
    qlen = rng.integers(0, Lq + 1, size=P).astype(np.int32)
    band = rng.integers(0, 4, size=(P, core + 1)).astype(np.int8)
    band[:, -1] = 4                              # the first right-pad N
    for i in range(P):
        q[i, :qlen[i]] = rng.integers(0, 5, qlen[i])
        at = int(rng.integers(0, 20))
        n = max(0, min(core, int(qlen[i]) - at))
        q[i, at:at + n] = band[i, :n]
    args = (torch.from_numpy(q).to(dev), torch.from_numpy(qlen).to(dev),
            torch.from_numpy(band).to(dev), Lr, pad_left, c)
    got = sw_end2end_banded(*args)
    want = sw_banded_plain(*args)
    _equal(got, want)


def _sw_edges(rng, P, Lq, nb):
    """P candidates against bands of nb columns, edges first: qlen 0, 1
    and Lq, an all-N band, an all-PAD band, an all-N query, and a
    homopolymer query against a homopolymer band (many query positions tie
    on the UMI column); the rest hold the band's core with noise."""
    q = np.full((P, Lq), PAD, np.int8)
    qlen = rng.integers(0, Lq + 1, size=P).astype(np.int32)
    band = rng.integers(0, 4, size=(P, nb)).astype(np.int8)
    band[:, -1] = N                              # the first right-pad N
    qlen[:7] = (0, 1, Lq, 60, 60, 60, 70)[:min(P, 7)]
    for i in range(P):
        q[i, :qlen[i]] = rng.integers(0, 5, qlen[i])
        at = int(rng.integers(0, 20))
        n = max(0, min(nb - 1, int(qlen[i]) - at))
        q[i, at:at + n] = band[i, :n]
    edges = [(3, N, None), (4, PAD, None), (5, None, N), (6, 0, 0)]
    for i, b, c in edges[:max(0, P - 3)]:
        if b is not None:
            band[i, :nb - 1 if b == 0 else nb] = b
        if c is not None:
            q[i, :qlen[i]] = c
    return q, qlen, band


@pytest.mark.parametrize("P", [1, 59, 256, 1000])
@pytest.mark.parametrize("pad_left,nb", [(30, 17), (15, 33), (4, 5),
                                         (2, 64)])
def test_sw_banded_kernel_edges(dev, P, pad_left, nb):
    """K5 equals its plain version at the pipeline's pair counts and the
    edges, at both chemistry bands and two run-time widths."""
    rng = np.random.default_rng(P + nb)
    Lq = 96
    q, qlen, band = _sw_edges(rng, P, Lq, nb)
    c = pad_left + nb - 1
    args = (torch.from_numpy(q).to(dev), torch.from_numpy(qlen).to(dev),
            torch.from_numpy(band).to(dev), c + 40, pad_left, c)
    before = kernels.launches["sw"]
    got = sw_end2end_banded(*args)
    assert kernels.launches["sw"] == before + 1
    want = sw_banded_plain(*args)
    _equal(got, want)
    if P >= 59 and nb in (17, 33):
        assert int(want[2].sum()) > P // 3


def test_sw_banded_kernel_longest_query(dev):
    """Lq = 127, the most rows the warp holds (128 with row 0)."""
    rng = np.random.default_rng(127)
    q, qlen, band = _sw_edges(rng, 300, 127, 17)
    args = (torch.from_numpy(q).to(dev), torch.from_numpy(qlen).to(dev),
            torch.from_numpy(band).to(dev), 86, 30, 46)
    _equal(sw_end2end_banded(*args), sw_banded_plain(*args))


def test_sw_banded_wrapper_states_its_limit(dev):
    q = torch.zeros((2, 128), dtype=torch.int8, device=dev)
    n = torch.zeros(2, dtype=torch.int32, device=dev)
    b = torch.zeros((2, 17), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="Lq <= 127"):
        sw_end2end_banded(q, n, b, 86, 30, 46)
    with pytest.raises(ValueError, match="band columns <= 64"):
        sw_end2end_banded(q[:, :96].contiguous(), n,
                          torch.zeros((2, 65), dtype=torch.int8, device=dev),
                          200, 30, 94)


def _full_rows(rng, pad_left, core, pad_right, P, Lq):
    Lr = pad_left + core + pad_right
    q = np.full((P, Lq), PAD, np.int8)
    qlen = rng.integers(0, Lq + 1, size=P).astype(np.int32)
    qlen[:2] = (0, Lq)
    refs = np.full((P, Lr), 4, np.int8)
    refs[:, pad_left:pad_left + core] = rng.integers(0, 4, size=(P, core))
    for i in range(P):
        q[i, :qlen[i]] = rng.integers(0, 5, qlen[i])
        at = int(rng.integers(0, 20))
        n = max(0, min(core, int(qlen[i]) - at))
        q[i, at:at + n] = refs[i, pad_left:pad_left + n]
        if i % 4 == 0 and n > 8:                     # a deletion
            q[i, at + 5:at + n - 1] = q[i, at + 6:at + n]
    return q, qlen, refs, Lr


@pytest.mark.parametrize("pad_left,core,pad_right", [
    (30, 16, 40), (15, 32, 24), (16, 16, 28), (4, 16, 17)])
def test_sw_full_kernel(dev, pad_left, core, pad_right):
    """K6 == its plain version == the banded kernel on padded rows."""
    rng = np.random.default_rng(pad_left * core + 1)
    P, Lq = 300, 96
    q, qlen, refs, Lr = _full_rows(rng, pad_left, core, pad_right, P, Lq)
    c = pad_left + core
    args = [torch.from_numpy(a).to(dev) for a in
            (q, qlen, refs, np.full(P, Lr, np.int32))]
    before = kernels.launches["sw_full"]
    got = sw_end2end(*args, c)
    assert kernels.launches["sw_full"] == before + 1
    _equal(got, sw_end2end_plain(*args, c))
    _equal(got, sw_end2end(*args, c, pad_left=pad_left))
    assert int(got[2].sum()) > P // 2


@pytest.mark.parametrize("Lq,Lr,c", [(127, 128, 127), (48, 60, 0),
                                     (33, 37, 20)])
def test_sw_full_kernel_ragged(dev, Lq, Lr, c):
    """Random references of differing lengths, the widest shapes the kernel
    takes, and the UMI column at either end of the row."""
    rng = np.random.default_rng(Lq * Lr + c)
    P = 257
    q = rng.integers(0, 5, size=(P, Lq)).astype(np.int8)
    qlen = rng.integers(0, Lq + 1, size=P).astype(np.int32)
    refs = rng.integers(0, 5, size=(P, Lr)).astype(np.int8)
    rlen = rng.integers(1, Lr + 1, size=P).astype(np.int32)
    rlen[:P // 2] = Lr
    for i in range(P):
        n = min(int(qlen[i]), int(rlen[i]) - 3)
        if n > 0:
            q[i, :n] = refs[i, 3:3 + n]
        q[i, qlen[i]:] = PAD
        refs[i, rlen[i]:] = PAD
    args = [torch.from_numpy(a).to(dev) for a in (q, qlen, refs, rlen)]
    got = sw_end2end(*args, c)
    _equal(got, sw_end2end_plain(*args, c))
    assert int(got[2].sum()) > 0


# (Lq, Lr, c) of the split's card test and of the CPU model test of
# test_torch_sw_full.py, on chip_smoke.split_rows: the 5' row (chip_smoke.py
# phase 2's split shape), the widest shape, c at both ends of the row, and a
# one-base query
SPLIT_CASES = [(96, 86, 46), (127, 128, 70), (48, 60, 0), (48, 60, 59),
               (1, 37, 20)]


def split_model(q, qlen, refs, rlen, c):
    """A torch model of K6's split on the CPU: F over columns 0..k-1 and
    B over columns lr-1..k, k = min(c + 1, lr) per pair, combined as
    csrc/sw_full.cu combines them. Returns score, qpos, valid and the
    three terms: max F[qlen][0..k], max B[0][k..lr] and
    max_i F[i][k] + B[i][k]."""
    q, qlen, refs, rlen = (torch.as_tensor(a).long()
                           for a in (q, qlen, refs, rlen))
    P, Lq = q.shape
    Lr = refs.shape[1]
    lane = torch.arange(Lq + 1)[None]
    n = qlen[:, None]
    lr = rlen.clamp(0, Lr)[:, None]
    k = lr.clamp(max=c + 1)
    row_ok = lane <= n
    neg = torch.tensor(-(1 << 20))
    qprev = torch.full((P, Lq + 1), PAD, dtype=torch.long)
    qprev[:, 1:] = q
    qcur = torch.roll(qprev, -1, dims=1)
    qcur[:, -1] = PAD

    def sub(qc, rj):
        s = torch.where(qc == rj, 1, -1)
        s = torch.where((qc == N) | (rj == N), 0, s)
        return torch.where((qc == PAD) | (rj == PAD), -1, s)

    def row(col, i):
        return torch.gather(col, 1, i)[:, 0]

    col = torch.where(row_ok, -lane, neg)                  # F[:, 0]
    fside = row(col, n)
    fc = col
    for j in range(Lr):
        if j == c:
            fc = col                                       # F[:, c]
        diag = torch.roll(col, 1, dims=1) + sub(qprev, refs[:, j:j + 1])
        diag[:, 0] = neg
        t = torch.maximum(diag, col - 1)
        t[:, 0] = 0
        new = torch.where(row_ok, torch.cummax(t + lane, 1).values - lane, neg)
        col = torch.where(j < k, new, col)
        fside = torch.where(j < k[:, 0], torch.maximum(fside, row(col, n)),
                            fside)
    bcol = torch.where(row_ok, lane - n, neg)               # B[:, lr]
    bside = row(bcol, torch.zeros_like(n))
    for j in range(Lr - 1, -1, -1):
        diag = torch.roll(bcol, -1, dims=1) + sub(qcur, refs[:, j:j + 1])
        t = torch.where(lane == n, 0, torch.maximum(diag, bcol - 1))
        t = torch.where(lane > n, neg, t)              # the roll wraps
        suf = torch.flip(torch.cummax(torch.flip(t - lane, [1]), 1).values,
                         [1])
        new = torch.where(row_ok, suf + lane, neg)
        live = (j >= k) & (j < lr)
        bcol = torch.where(live, new, bcol)
        bside = torch.where(live[:, 0], torch.maximum(bside, bcol[:, 0]),
                            bside)
    cross = torch.where(row_ok, col + bcol, 2 * neg).max(1).values
    score = torch.maximum(torch.maximum(fside, bside), cross)
    tot = torch.roll(fc, 1, dims=1) + sub(qprev, refs[:, c:c + 1]) + bcol
    ok = (lane >= 1) & row_ok & (tot == score[:, None]) & (c < lr)
    qpos = torch.where(ok, lane - 1, -1).max(1).values
    return (score.int(), qpos.int(), qpos >= 0,
            (fside.int(), bside.int(), cross.int()))


def side_decided(terms):
    """Pairs whose optimum only the forward side term reaches, and pairs
    only the backward side term reaches: a kernel that dropped either term
    would score them lower."""
    fside, bside, cross = terms
    return (int((fside > torch.maximum(bside, cross)).sum()),
            int((bside > torch.maximum(fside, cross)).sum()))


@pytest.mark.parametrize("Lq,Lr,c", SPLIT_CASES)
def test_sw_full_kernel_split(dev, Lq, Lr, c):
    """K6 == its plain version on rows with no N pads, where the optimum
    lies left of the split column, right of it or across it; and the rows
    hold pairs that only a side term decides."""
    rng = np.random.default_rng(Lq * Lr + c)
    P = 300
    arrs = split_rows(rng, P, Lq, Lr, c)
    args = [torch.from_numpy(a).to(dev) for a in arrs]
    before = kernels.launches["sw_full"]
    got = sw_end2end(*args, c)
    assert kernels.launches["sw_full"] == before + 1
    want = sw_end2end_plain(*args, c)
    _equal(got, want)
    *model, terms = split_model(*arrs, c)
    _equal(model, want)
    if 8 <= c <= Lr - 8 and Lq > 1:
        f_only, b_only = side_decided(terms)
        assert f_only > 0 and b_only > 0
        assert int(got[2].sum()) > P // 4


def test_sw_full_wrapper_states_its_limit(dev):
    q = torch.zeros((2, 128), dtype=torch.int8, device=dev)
    n = torch.zeros(2, dtype=torch.int32, device=dev)
    r = torch.zeros((2, 86), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="Lq <= 127"):
        sw_end2end(q, n, r, n, 46)


def test_wrappers_refuse_bad_tensors(dev):
    t = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    valid = torch.zeros((4, 64), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="int32"):
        chain_dp(t.float(), t, t, valid, 15, 5000, 500)
    with pytest.raises(ValueError, match="contiguous"):
        chain_dp(t.t().contiguous().t(), t, t, valid, 15, 5000, 500)
    with pytest.raises(ValueError, match="CUDA"):
        chain_dp(t, t.cpu(), t, valid, 15, 5000, 500)
    with pytest.raises(ValueError, match="bandwidth"):
        chain_dp(t, t, t, valid, 15, 5000, 10240)


COMP = str.maketrans("ACGT", "TGCA")


def _edit(rng, bc, n_edits):
    bc = list(bc)
    for _ in range(n_edits):
        i = int(rng.integers(len(bc)))
        op = int(rng.integers(3))
        if op == 0:
            bc[i] = "ACGT"[int(rng.integers(4))]
        elif op == 1:
            del bc[i]
        else:
            bc.insert(i, "ACGT"[int(rng.integers(4))])
    return "".join(bc)


def _match_candidates(rng, spec, barcodes, n):
    """BC-UMI candidates laid out as the mode's slice: lead-in, barcode
    (around the linker for slideseq rows), UMI, tail; exact, with one edit,
    with 2-4 edits (the DP), with an N, on the reverse strand, cut short,
    empty."""
    seqs = []
    for i in range(n - 2):
        bc = barcodes[int(rng.integers(len(barcodes)))]
        kind = i % 6
        if kind == 2:
            bc = _edit(rng, bc, 1)
        elif kind == 3:
            bc = _edit(rng, bc, int(rng.integers(2, 5)))
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
    return encode_batch(seqs + ["", "ACGT"], max_len=96)


@pytest.fixture(scope="module")
def wl_737k():
    return whitelist.load(WL_737K)


@pytest.mark.parametrize("source,mode,n_wl,shard", [
    ("737K", "5p10XGEX", 3, 2),       # 245,760 rows, all real
    ("737K", "5p10XGEX", 4, 3),       # 184,320 rows, all real
    ("slideseq", "3pXCR_slideseq", 3, 2),   # 5,918 rows, 5,917 real (odd)
    ("slideseq", "3pXCR_slideseq", 4, 3),   # 4,439 rows, 4,436 real
    ("five", "5p10XGEX", 4, 2),       # 2 rows, 1 real (odd)
    ("five", "5p10XGEX", 4, 3),       # 2 rows, none real
])
def test_verify_kernel_at_shard_tails(dev, wl_737k, source, mode, n_wl,
                                      shard):
    """K4 on a whitelist shard's own core table at its r_valid = n_real,
    the padding rows past it included, equals its plain version."""
    spec = chemistry.get(mode).barcode
    rng = np.random.default_rng(n_wl * 10 + shard)
    if source == "737K":
        bcs = wl_737k
    elif source == "slideseq":
        bcs = whitelist.load(WL_SLIDESEQ)
    else:
        bcs = wl_737k[rng.choice(len(wl_737k), 5, replace=False)]
    swl = ShardedWhitelist(bcs, spec, n_wl)
    per, r_valid = swl.per_shard, int(swl.n_real[shard])
    real = swl.barcodes[shard * per:shard * per + max(r_valid, 1)]
    q, qlen = (torch.from_numpy(a).to(dev)
               for a in _match_candidates(rng, spec, real, 40))
    # forward and reverse-complement rows in one launch, as the matcher
    args = (torch.cat([q, revcomp_rows(q, qlen)]).contiguous(),
            torch.cat([qlen, qlen]),
            torch.from_numpy(np.ascontiguousarray(swl.coreT[shard])).to(dev),
            r_valid, spec.pad_left, spec.pad_right)
    before = kernels.launches["verify"]
    got = verify_all(*args)
    assert kernels.launches["verify"] == before + 1
    want = verify_all_plain(*args)
    _equal(got, want)
    if r_valid == 0:
        assert int(want[1].max()) == -1
    else:
        assert int((want[0] == swl.core_len).sum()) > 0   # exact cores won


@pytest.mark.parametrize("mode,shape", [
    ("5p10XGEX", (2, 4)), ("5p10XGEX", (1, 4)), ("3pXCR_slideseq", (2, 4))])
def test_sharded_match_on_one_card(dev, wl_737k, mode, shape):
    """build_sharded_match with every mesh cell on the card (K4 once per
    shard and chunk, K5 on the owning shard) equals the card's
    single-device BarcodeMatcher and the sharded matcher on the CPU."""
    spec = chemistry.get(mode).barcode
    rng = np.random.default_rng(sum(shape) + len(mode))
    src = wl_737k if mode == "5p10XGEX" else whitelist.load(WL_SLIDESEQ)
    wl = np.sort(src[rng.choice(len(src), 2001, replace=False)])
    n = 256 if mode == "5p10XGEX" else 128
    q, qlen = _match_candidates(rng, spec, wl, n)
    n_data, n_wl = shape

    def sharded(device):
        mesh = make_mesh(n_data, n_wl, devices=[device])
        swl = ShardedWhitelist(wl, spec, n_wl)
        out = build_sharded_match(swl, mesh)(q, qlen,
                                             swl.device_arrays(mesh))
        return [x.cpu().numpy() for x in out]

    before = dict(kernels.launches)
    bc, score, status, umi, counts = sharded(torch.device("cuda", 0))
    torch.cuda.synchronize()
    assert kernels.launches["verify"] - before["verify"] >= n_wl
    assert (kernels.launches["verify"] - before["verify"]) % n_wl == 0
    assert kernels.launches["sw"] > before["sw"]
    ref = BarcodeMatcher(wl, spec, dev).match(q, qlen)
    for k, v in (("status", status), ("bc_idx", bc), ("score", score),
                 ("umi", umi)):
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    acc = status == 0
    np.testing.assert_array_equal(
        counts.reshape(-1), np.bincount(bc[acc], minlength=counts.size))
    assert acc.sum() >= n // 4 and len(set(status.tolist())) >= 4
    for v, w in zip((bc, score, status, umi, counts),
                    sharded(torch.device("cpu"))):
        np.testing.assert_array_equal(v, w)


# ---------------------------------------------------------------------------
# the fused per-batch step (stages/cli_step.py): cases shared with
# tests/test_torch_cli_step.py, which holds them against the JAX step

B, L, S = 32, 1024, 4
TSO = "TTTCTTATATG"
SAMPLE = os.path.join(DATA, "samples",
                      "K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1.fastq.gz")
PANEL = os.path.join(DATA, "RUNX1_RUNX1T1_ABL1_BCR.fa")


def _rand(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _sub1(rng, s):
    i = int(rng.integers(len(s)))
    return s[:i] + "ACGT".replace(s[i], "")[int(rng.integers(3))] + s[i + 1:]


def _batch(reads):
    """(codes (B, L) int8, lengths (B,) int32); rows past the reads are
    empty, as in a bucket's last batch."""
    assert len(reads) <= B and max(map(len, reads)) <= L
    codes = np.full((B, L), PAD, np.int8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = encode(r)
        lens[i] = len(r)
    return codes, lens


def cli_world(rng):
    """Panels, whitelists and the B-read batches of the fused step's cases
    (CLI_CASES), made from `rng`: real K562 reads of the 1024 bucket,
    synthetic 5' concatemers and 3' reads with whitelisted barcodes (every
    fourth with one substitution), and RTX reads on a panel holding one
    transcript eight times."""
    names, seqs = fasta.read_fasta_encoded(PANEL)
    tx = [decode(s) for s in seqs]
    wl10 = whitelist.load(WL_737K)
    pick = wl10[rng.choice(len(wl10), 300, replace=False)]
    used = list(pick[:120])

    def bc_of(i):
        bc = str(used[i % len(used)])
        return _sub1(rng, bc) if i % 4 == 3 else bc   # no exact hit: pending

    def seg(i, n):
        t = tx[i % len(tx)]
        lo = int(rng.integers(0, max(1, len(t) - n)))
        return t[lo:lo + n]

    # the slice rule on real K562 reads of the 1024 bucket
    k562 = next(fastq.iter_batches(SAMPLE, 80, max_len=4096))
    keep = [i for i in range(len(k562.lengths)) if k562.lengths[i] <= L][:B]
    k562_reads = [decode(k562.codes[i], int(k562.lengths[i])) for i in keep]
    carried = set()
    known = set(wl10.tolist())
    for r in k562_reads:
        for s in (r[:200], revcomp_str(r)[:200]):
            carried.update(s[i:i + 16] for i in range(len(s) - 15)
                           if s[i:i + 16] in known)

    def unit5p(i, tr):
        return (_rand(rng, 10 + 5 * (i % 3)) + "CGCTCTTCCGATCT" + bc_of(i)
                + _rand(rng, 10) + TSO + tr)

    # synthetic 5' concatemers: 6 units (more kept chains than S slots),
    # and two units on two transcripts and strands (two segs; with 24 such
    # reads the accepted slots exceed the B matched rows: a spill batch)
    concat = []
    for i in range(8):
        concat.append("".join(unit5p(6 * i + k, seg(i + k, 90))
                              for k in range(6)))
    for i in range(8, B):
        concat.append(unit5p(i, seg(i, 330))
                      + revcomp_str(unit5p(i + 1, seg(i + 1, 330))))

    def reads_3p(mode):
        out = []
        for i in range(B - 2):
            tr = seg(i, 450)
            if mode == "3pXCR_slideseq":
                r = (_rand(rng, 120) + tr + "A" * (10 + 35 * (i % 3))
                     + _rand(rng, 22) + revcomp_str(SLIDESEQ_LINKER)
                     + _rand(rng, 30))
            elif mode == "3p10XTCR":
                r = (_rand(rng, 200) + tr + _rand(rng, 10 * (i % 5))
                     + "AAAAAA" + _rand(rng, 28) + TRUSEQ + _rand(rng, 25))
            elif mode == "3p10XTCR_nuc":
                r = (tr + _rand(rng, 40 + 100 * (i % 5))
                     + revcomp_str(bc_of(i) + _rand(rng, 19)) + TRUSEQ
                     + _rand(rng, 25))
            else:                                          # 3p10XGEX
                r = (tr + _rand(rng, 4 + 150 * (i % 3))
                     + revcomp_str(bc_of(i) + _rand(rng, 16)) + TRUSEQ
                     + _rand(rng, 25))
            out.append(revcomp_str(r) if i % 3 == 1 else r)
        return out + [tr, ""]          # one read without adapter, one empty

    # RTX on a panel holding X eight times, Y three times and Z once:
    # reads of X overflow the bucket's anchor slots and have 8 chains;
    # reads of Y have three chains of equal score
    px = [rng.integers(0, 4, 1000).astype(np.int8) for _ in range(3)]
    o_seqs = [px[0]] * 8 + [px[1]] * 3 + [px[2]]
    o_names = [f"TRBV{k}-1|x_{k}" for k in range(len(o_seqs))]
    rtx = []
    for i in range(B):
        src = decode(px[i % 3])
        n = 950 if i % 3 == 0 else 400
        lo = int(rng.integers(0, 1000 - n))
        r = src[lo:lo + n] + (_rand(rng, 60) if n < 950 else "")
        rtx.append(revcomp_str(r) if i % 2 else r)

    return {
        "panel": (names, seqs), "overflow_panel": (o_names, o_seqs),
        "wl10": np.asarray(sorted(set(pick.tolist()) | carried)),
        "wl_slideseq": whitelist.load(WL_SLIDESEQ)[:300],
        "batches": {"k562": _batch(k562_reads), "concat": _batch(concat),
                    "rtx": _batch(rtx),
                    **{m: _batch(reads_3p(m)) for m in (
                        "3p10XTCR", "3pXCR_slideseq", "3p10XTCR_nuc",
                        "3p10XGEX")}},
    }


CLI_CASES = [
    # (id, mode, batch, panel, with a matcher)
    ("slice-k562", "5p10XGEX", "k562", "panel", True),
    ("slice-concatemers", "5p10XGEX", "concat", "panel", True),
    ("rev_slice14", "3p10XTCR", "3p10XTCR", "panel", True),
    ("rev_slideseq", "3pXCR_slideseq", "3pXCR_slideseq", "panel", True),
    ("rev_nuc", "3p10XTCR_nuc", "3p10XTCR_nuc", "panel", True),
    ("rev_3pgex-no-matcher", "3p10XGEX", "3p10XGEX", "panel", False),
    ("rtx-overflow-ties", "RTX", "rtx", "overflow_panel", False),
]




@pytest.fixture(scope="module")
def cli_cases():
    return cli_world(np.random.default_rng(20261017))


@pytest.mark.parametrize("case", CLI_CASES, ids=[c[0] for c in CLI_CASES])
def test_fused_step_on_the_card_equals_the_cpu(dev, cli_cases, case):
    """build_cli_step on the card (K1 and K2+K3 launched once each inside
    the step) gives every output of the step on the CPU bit for bit."""
    from nanoranger_torch.align.index import PanelIndex
    from nanoranger_torch.stages.cli_step import build_cli_step
    _, mode, bkey, panel_key, with_matcher = case
    names, seqs = cli_cases[panel_key]
    spec = chemistry.get(mode)
    codes, lens = cli_cases["batches"][bkey]
    outs = {}
    for d in (dev, torch.device("cpu")):
        m = None
        if with_matcher:
            m = BarcodeMatcher(
                cli_cases["wl_slideseq" if spec.barcode.slideseq_linker
                          else "wl10"], spec.barcode, d)
        step, tables = build_cli_step(spec, PanelIndex.build(names, seqs),
                                      matcher=m, device=d)
        before = dict(kernels.launches)
        outs[d.type] = {k: v.cpu() for k, v in
                        step(codes, lens, tables).items()}
        if d.type == "cuda":
            assert kernels.launches["chain"] == before["chain"] + 1
            assert kernels.launches["ed"] == before["ed"] + (
                spec.scan is not None)
    assert outs["cuda"].keys() == outs["cpu"].keys()
    for k, v in outs["cpu"].items():
        assert torch.equal(outs["cuda"][k], v), k


@pytest.fixture(scope="module")
def k562_reads():
    return fastq.read_all(SAMPLE, max_len=4096)


@pytest.mark.parametrize("Lb", [1024, 2048, 4096])
def test_chain_kernel_at_the_fused_buckets(dev, k562_reads, Lb):
    """K1 at the fused step's anchor slots of each length bucket (A = 1024,
    2048, 4096 from max_minimizers 256, 512, 1024) on K562 reads of that
    bucket."""
    import chip_smoke
    from nanoranger_torch.align.aligner import BANDWIDTH, MAX_GAP
    from nanoranger_torch.align.index import PanelIndex
    from nanoranger_torch.align.minimizers import K
    codes, lens = chip_smoke.bucket_batch(k562_reads, Lb, B=256)
    _, _, ch = chip_smoke.fused_chain(dev, PanelIndex.from_fasta(PANEL),
                                      codes, lens)
    assert ch["t"].shape == (256, Lb) and int(ch["valid"].sum()) > 0
    args = (ch["t"], ch["q"], ch["seg"], ch["valid"], K, MAX_GAP, BANDWIDTH)
    _equal(chain_dp(*args), chain_dp_plain(*args))


def test_ed_kernel_at_the_fused_slots(dev, k562_reads):
    """K2+K3 over the B*S = 8192 record slots of a 1024-bucket batch of
    2048 K562 reads, as the fused step scans them: the slots no chain
    fills (most of them) scan the flank of an empty span at the read's
    start."""
    import chip_smoke
    from nanoranger_torch.align.index import PanelIndex
    spec = chemistry.get("5p10XGEX")
    window, wlen = chip_smoke.fused_slot_windows(
        dev, spec, PanelIndex.from_fasta(PANEL),
        *chip_smoke.bucket_batch(k562_reads, 1024))
    assert window.shape[0] == 8192
    sc = spec.scan
    args = (torch.from_numpy(encode(sc.pattern)).to(dev), window, wlen,
            sc.k, sc.n_wildcard, sc.pick_last)
    got = hw_locate(*args)
    _equal(got, hw_locate_plain(*args))
    assert int((got[0] >= 0).sum()) > 500


# the device step (stages/device_step.py): one rule a case, on cli_world's
# batches (B=32 reads of the 1024 bucket), against every other row of the
# case's whitelist: reads whose barcode was left out have no tier structure
# and go to the in-step DP
STEP_CASES = [
    # (id, mode, batch)
    ("slice", "5p10XGEX", "k562"),
    ("rev_slice14", "3p10XTCR", "3p10XTCR"),
    ("rev_nuc", "3p10XTCR_nuc", "3p10XTCR_nuc"),
    ("rev_3pgex", "3p10XGEX", "3p10XGEX"),
]


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_device_step_on_the_card_equals_the_cpu(dev, cli_cases, case):
    """build_device_step on the card (the full in-step match: K1, K2+K3 and,
    where rows reach the DP, K4 and K5 inside the call) gives every output
    of the step on the CPU bit for bit."""
    from nanoranger_torch.align.index import PanelIndex
    from nanoranger_torch.stages.device_step import build_device_step
    _, mode, bkey = case
    names, seqs = cli_cases["panel"]
    spec = chemistry.get(mode)
    codes, lens = cli_cases["batches"][bkey]
    bcs = cli_cases["wl_slideseq" if spec.barcode.slideseq_linker
                    else "wl10"][::2]
    outs = {}
    for d in (dev, torch.device("cpu")):
        step = build_device_step(spec, PanelIndex.build(names, seqs),
                                 BarcodeMatcher(bcs, spec.barcode, d), S=2,
                                 max_minimizers=256, device=d)
        before = dict(kernels.launches)
        outs[d.type] = {k: v.cpu() for k, v in step(codes, lens).items()}
        if d.type == "cuda":
            assert kernels.launches["chain"] > before["chain"]
            assert kernels.launches["ed"] > before["ed"]
            assert kernels.launches["verify"] > before["verify"]
            assert kernels.launches["sw"] > before["sw"]
    assert outs["cuda"].keys() == outs["cpu"].keys()
    for k, v in outs["cpu"].items():
        assert torch.equal(outs["cuda"][k], v), k
    assert (outs["cpu"]["status"] != 5).any()


def test_chain_kernel_at_the_device_step_shape(dev):
    """K1 at the device step's bench shape: B = 1024 K562 reads at L = 2048,
    max_minimizers 512, so A = 2048 anchor slots."""
    import chip_smoke
    from nanoranger_torch.align.aligner import BANDWIDTH, MAX_GAP
    from nanoranger_torch.align.index import PanelIndex
    from nanoranger_torch.align.minimizers import K
    codes, lens = chip_smoke.step_batches()[0]
    _, _, ch = chip_smoke.fused_chain(dev, PanelIndex.from_fasta(PANEL),
                                      codes, lens)
    assert ch["t"].shape == (1024, 2048) and int(ch["valid"].sum()) > 0
    args = (ch["t"], ch["q"], ch["seg"], ch["valid"], K, MAX_GAP, BANDWIDTH)
    _equal(chain_dp(*args), chain_dp_plain(*args))


@pytest.mark.parametrize("mode", ["5p10XGEX", "3pXCR_slideseq"])
def test_screens_on_the_card_equal_the_cpu(dev, wl_737k, mode):
    """seed_screen.screen, product_screen.product_screen and
    product_screen_joint (a product list only) give on the card what they
    give on the CPU, against the whole list."""
    spec = chemistry.get(mode).barcode
    rng = np.random.default_rng(7 + len(mode))
    bcs = wl_737k if mode == "5p10XGEX" else whitelist.load(WL_SLIDESEQ)
    tables = screen_tables(bcs, spec)
    q, qlen = _match_candidates(rng, spec, bcs, 600)
    got = run_screens(dev, tables, q, qlen)
    want = run_screens(torch.device("cpu"), tables, q, qlen)
    assert sorted(got) == sorted(want) and len(got) == (
        3 if mode == "5p10XGEX" else 1)
    for name in want:
        for g, w in zip(got[name][0], want[name][0]):
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert (got[name][0][0][:, 0] >= 0).sum() > 100


# --------------------------------------------------------------------------
# the banded CIGAR DP (csrc/banded_cigar.cu) against the host C++ routine

def _ont_pair(rng, L, err=0.09):
    """A random query of L bases and its target with ONT-like edits
    (substitutions, deletions and insertions, err / 3 each)."""
    q = rng.integers(0, 4, L).astype(np.int8)
    t = []
    for b in q:
        r = rng.random()
        if r < err / 3:
            t.append((b + 1) % 4)
        elif r < 2 * err / 3:
            continue
        elif r < err:
            t += [b, int(rng.integers(0, 4))]
        else:
            t.append(b)
    return q, np.asarray(t, np.int8)


def _banded_case(kind, seed):
    """(q_segs, t_segs) of one case kind."""
    rng = np.random.default_rng(seed)
    e = np.zeros(0, np.int8)
    rand = lambda n, hi=4: rng.integers(0, hi, n).astype(np.int8)  # noqa
    if kind == "ont":
        return [list(x) for x in zip(*(
            _ont_pair(rng, int(rng.integers(1, 900))) for _ in range(300)))]
    if kind == "empty":
        # empty query, empty target, both empty, beside ordinary pairs
        return ([e, rand(37), e, rand(1), rand(200), e],
                [rand(52), e, e, e, rand(190), rand(1)])
    if kind == "n_bases":
        pairs = [_ont_pair(rng, int(rng.integers(20, 400)))
                 for _ in range(60)]
        qs = [np.where(rng.random(len(q)) < 0.1, 4, q).astype(np.int8)
              for q, _ in pairs]
        ts = [np.where(rng.random(len(t)) < 0.1, 4, t).astype(np.int8)
              for _, t in pairs]
        return qs + [np.full(30, 4, np.int8)], ts + [np.full(30, 4, np.int8)]
    if kind == "beyond_band":
        # |lq - lt| past the band: the band widens to |lq - lt| + 16, to
        # 2,353 columns a row at (1200, 40)
        lens = [(300, 20), (20, 300), (700, 100), (100, 700), (1200, 40)]
        return ([rand(a) for a, _ in lens], [rand(b) for _, b in lens])
    if kind == "band_edge":
        # unrelated sequences: paths that run along the band's edges; and
        # the most oblique diagonals (lq = 1, lt = 4,096 and back). The
        # widened band always holds the end cell (centre(lq) = lt), so no
        # input reaches the host routine's outside-the-band exit
        lens = [(int(rng.integers(1, 500)), int(rng.integers(1, 500)))
                for _ in range(60)] + [(1, 4096), (4096, 1)]
        return ([rand(a, 5) for a, _ in lens], [rand(b, 5) for _, b in lens])
    if kind == "long":
        pairs = [_ont_pair(rng, n) for n in (4096, 4000, 3000, 2048)]
        pairs.append((rand(4096), rand(3900)))
        return [list(x) for x in zip(*pairs)]
    raise ValueError(kind)


BANDED_CASES = ["ont", "empty", "n_bases", "beyond_band", "band_edge", "long"]


def _assert_banded_equal(dev, qs, ts, band):
    from nanoranger_torch.ops.banded import banded_align
    from nanoranger_torch.runtime.native_lib import banded_align_batch
    before = kernels.launches["banded"]
    got = banded_align(qs, ts, band, dev)
    assert kernels.launches["banded"] > before
    want = banded_align_batch(qs, ts, band=band)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("band", [48, 160])
@pytest.mark.parametrize("kind", BANDED_CASES)
def test_banded_kernel_equals_the_host_routine(dev, kind, band):
    qs, ts = _banded_case(kind, BANDED_CASES.index(kind) * 1000 + band)
    _assert_banded_equal(dev, qs, ts, band)


def test_banded_kernel_across_launches(dev, monkeypatch):
    """A traceback cap that holds a few segments a launch: many launches
    over one reused buffer, bands of 321 to 2,353 columns, the same
    outputs."""
    from nanoranger_torch.ops import banded
    qs, ts = _banded_case("ont", 7)
    q2, t2 = _banded_case("beyond_band", 8)
    monkeypatch.setattr(banded, "TB_CAP", 1 << 20)
    before = kernels.launches["banded"]
    _assert_banded_equal(dev, qs + q2, ts + t2, 160)
    assert kernels.launches["banded"] - before > 10


@pytest.fixture(scope="module")
def k562_genome(tmp_path_factory):
    """The genome stage on the card on K562 subreads: (outdir, tag map, its
    banded_align calls)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from chip_smoke import k562_genome_stage
    out = str(tmp_path_factory.mktemp("k562_card"))
    calls = []
    tag_map = k562_genome_stage(torch.device("cuda"), out, calls)
    return out, tag_map, calls


def test_banded_kernel_on_a_genome_stage_batch(dev, k562_genome):
    """Every exon segment of the first K562 genome-stage batch."""
    _, _, calls = k562_genome
    qs, ts, band = calls[0]
    assert band == 160 and len(qs) > 300
    _assert_banded_equal(dev, qs, ts, band)


def test_genome_stage_on_the_card_equals_the_host_route(dev, k562_genome,
                                                        tmp_path,
                                                        monkeypatch):
    """The tagged BAM, its .bai and _trns_ct.csv byte for byte, with the
    banded DP on the card and on the host."""
    from nanoranger_torch import chemistry, pipeline, trace
    from nanoranger_torch.ops.banded import banded_align
    out, tag_map, _ = k562_genome
    host = str(tmp_path)
    os.symlink(os.path.join(out, "s_deconcat.fastq.gz"),
               os.path.join(host, "s_deconcat.fastq.gz"))
    monkeypatch.setattr(pipeline, "banded_align",
                        lambda q, t, band, device: banded_align(
                            q, t, band, "cpu"))
    with trace.run() as tr:
        pipeline.genome_stage(chemistry.get("5p10XGEX"), host, "s",
                              os.path.join(DATA, "RUNX1_RUNX1T1_ABL1_BCR.fa"),
                              tag_map, dev, force=True)
    assert tr.counters["banded.host_segments"] > 1000
    assert tr.counters.get("banded.device_segments", 0) == 0
    for f in ("s_genome_tagged.bam", "s_genome_tagged.bam.bai",
              "s_trns_ct.csv"):
        with open(os.path.join(out, f), "rb") as a, \
                open(os.path.join(host, f), "rb") as b:
            assert a.read() == b.read(), f


def test_call_clonotypes_on_the_card_equals_the_host_route(dev, tmp_path,
                                                           monkeypatch):
    """The clone exports of the bundled slideseq reads, with the banded DP
    on the card and on the host."""
    import gzip

    from chip_smoke import C_PANEL, SLIDESEQ, decon_subreads, \
        slideseq_clonotypes
    from nanoranger_torch import trace
    from nanoranger_torch.ops.banded import banded_align
    from nanoranger_torch.vdj import caller
    sub_path, _ = decon_subreads(dev, "3pXCR_slideseq", SLIDESEQ, C_PANEL,
                                 str(tmp_path))
    (tmp_path / "card").mkdir()
    (tmp_path / "host").mkdir()
    with trace.run() as tr_card:
        got = slideseq_clonotypes(dev, sub_path, str(tmp_path / "card"))
    monkeypatch.setattr(caller, "banded_align",
                        lambda q, t, band, device: banded_align(
                            q, t, band, "cpu"))
    with trace.run() as tr_host:
        want = slideseq_clonotypes(dev, sub_path, str(tmp_path / "host"))
    assert tr_card.counters["banded.device_segments"] == \
        tr_host.counters["banded.host_segments"] > 500
    assert tr_card.counters.get("banded.host_segments", 0) == 0
    assert len(want[0]) >= 3
    for g, w in zip(got, want):
        assert g.equals(w)
    for name in ("s_clones.txt.gz", "s_cloneID.txt.gz"):
        with gzip.open(tmp_path / "card" / name, "rb") as a, \
                gzip.open(tmp_path / "host" / name, "rb") as b:
            assert a.read() == b.read(), name
