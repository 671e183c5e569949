"""Chain DP of the PyTorch port (ops/chain.py, plain version of the Hopper
kernel csrc/chain.cu) against the JAX package's XLA scan and its Pallas
kernel in interpret mode.

Tolerance: f within 1e-5 relative (float32 gap costs; the two sides may
round log2 differently), parents and roots exactly equal."""

import numpy as np
import pytest
import torch

from nanoranger_tpu.align.aligner import BANDWIDTH, MAX_GAP, _chain_dp_xla
from nanoranger_tpu.align.minimizers import K
from nanoranger_tpu.ops.pallas_chain import chain_dp_pallas

from nanoranger_torch.ops.chain import NEGF, chain_dp, chain_dp_plain

torch.set_num_threads(1)


def _synthetic_anchors(rng, B=12, A=96, n_segs=3, full=False):
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
            tt[m] = np.sort(rng.integers(0, 3000, m.sum()))
        qq = np.maximum(tt % 3000 + rng.integers(-40, 40, n), 0)
        order = np.lexsort((qq, tt, sg))
        t[b, :n] = tt[order]
        q[b, :n] = qq[order]
        seg[b, :n] = sg[order]
        valid[b, :n] = True
    return t, q, seg, valid


MASKS = ("holes", "all_invalid", "all_valid", "last_chunk")


def mask_rows(rng, B, A, kind):
    """(B, A) valid masks that the kernel may not assume away: holes inside
    a valid prefix, every other row all invalid, every slot valid, or valid
    slots only in the last 32-slot chunk."""
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
    return valid


def _port(t, q, seg, valid):
    out = chain_dp(*(torch.from_numpy(a) for a in (t, q, seg, valid)),
                   K, MAX_GAP, BANDWIDTH)
    return [x.numpy() for x in out]


def _assert_chain_equal(got, want, valid):
    f1, p1, r1 = got
    f0, p0, r0 = want
    np.testing.assert_allclose(f1[valid], f0[valid], rtol=1e-5)
    np.testing.assert_array_equal(p1, p0)
    np.testing.assert_array_equal(r1, r0)


@pytest.mark.parametrize("trial", range(3))
def test_plain_matches_xla(rng, trial):
    t, q, seg, valid = _synthetic_anchors(rng)
    want = [np.asarray(x) for x in _chain_dp_xla(t, q, seg, valid,
                                                 MAX_GAP, BANDWIDTH, 0)]
    _assert_chain_equal(_port(t, q, seg, valid), want, valid)


@pytest.mark.parametrize("kind", MASKS)
def test_plain_matches_xla_on_masks(rng, kind):
    """Anchors in every slot, valid or not: an invalid slot holds data that
    would chain, and must still give NEGF, -1, -1 and be no predecessor."""
    t, q, seg, _ = _synthetic_anchors(rng, full=True)
    valid = mask_rows(rng, *t.shape, kind)
    f0, p0, r0 = (np.asarray(x) for x in _chain_dp_xla(
        t, q, seg, valid, MAX_GAP, BANDWIDTH, 0))
    f1, p1, r1 = _port(t, q, seg, valid)
    np.testing.assert_allclose(f1, f0, rtol=1e-5)     # every slot
    np.testing.assert_array_equal(p1, p0)
    np.testing.assert_array_equal(r1, r0)
    assert (f1[~valid] == NEGF).all()


def test_plain_matches_pallas_interpret(rng):
    t, q, seg, valid = _synthetic_anchors(rng, B=6, A=80)
    want = [np.asarray(x) for x in chain_dp_pallas(
        t, q, seg, valid, K, MAX_GAP, BANDWIDTH, interpret=True)]
    f1, p1, r1 = _port(t, q, seg, valid)
    np.testing.assert_allclose(f1[valid], want[0][valid], rtol=1e-5)
    np.testing.assert_array_equal(p1[valid], want[1][valid])
    np.testing.assert_array_equal(r1[valid], want[2][valid])


def test_parent_is_last_argmax_and_roots_close(rng):
    # equal-score predecessors: anchors on one diagonal at equal spacing
    # give ties, and the LAST one in the window must win
    B, A = 1, 40
    t = np.zeros((B, A), np.int32)
    q = np.zeros((B, A), np.int32)
    seg = np.zeros((B, A), np.int32)
    valid = np.ones((B, A), bool)
    t[0] = np.repeat(np.arange(A // 2) * 100, 2)
    q[0] = np.repeat(np.arange(A // 2) * 100, 2)
    f, p, r = _port(t, q, seg, valid)
    want = [np.asarray(x) for x in _chain_dp_xla(t, q, seg, valid,
                                                 MAX_GAP, BANDWIDTH, 0)]
    _assert_chain_equal((f, p, r), want, valid)
    # anchors 2a and 2a+1 sit on the same point; the later copy of the
    # previous point is the parent
    assert (p[0, 2:][::2] == np.arange(1, A - 2, 2)).all()
    for a in range(A):          # root = transitive closure of parents
        x = a
        while p[0, x] >= 0:
            x = p[0, x]
        assert r[0, a] == x


def test_seg_gating_blocks_cross_ref_chains():
    B, A, n = 2, 64, 40
    t = np.zeros((B, A), np.int32)
    q = np.zeros((B, A), np.int32)
    seg = np.full((B, A), 1 << 30, np.int32)
    valid = np.zeros((B, A), bool)
    tt = np.arange(n) * 50
    t[0, :n] = tt
    q[0, :n] = tt
    seg[0, :n] = np.where(np.arange(n) < n // 2, 0, 2)
    valid[0, :n] = True
    f, p, r = _port(t, q, seg, valid)
    roots = r[0, :n]
    assert len(np.unique(roots[: n // 2])) == 1
    assert len(np.unique(roots[n // 2:])) == 1
    assert roots[0] != roots[-1]
    assert (r[~valid] == -1).all() and (p[~valid] == -1).all()


def test_wrapper_takes_plain_version_on_cpu(rng):
    t, q, seg, valid = _synthetic_anchors(rng, B=3, A=40)
    args = [torch.from_numpy(a) for a in (t, q, seg, valid)]
    a = chain_dp(*args, K, MAX_GAP, BANDWIDTH)
    b = chain_dp_plain(*args, K, MAX_GAP, BANDWIDTH)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
