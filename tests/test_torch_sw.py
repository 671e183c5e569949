"""Banded UMI rescore of the PyTorch port (ops/sw.py, plain version of the
Hopper kernel csrc/sw_banded.cu) against the JAX package's XLA scorer on
the full padded rows. Score, validity and UMI position must be equal."""

import numpy as np
import pytest
import torch

from nanoranger_tpu.io.encode import PAD
from nanoranger_tpu.ops.sw import sw_end2end_reference, sw_end2end_xla

from nanoranger_torch.ops.sw import sw_banded_plain, sw_end2end_banded

torch.set_num_threads(1)


def _case(rng, pad_left, pad_right, core, P=24, Lq=64):
    Lr = pad_left + core + pad_right
    q = rng.integers(0, 4, size=(P, Lq)).astype(np.int8)
    qlen = rng.integers(25, Lq + 1, size=P).astype(np.int32)
    qlen[0] = 0
    refs = np.full((P, Lr), 4, np.int8)           # N pads
    for p in range(P):
        q[p, qlen[p]:] = PAD
        bc = rng.integers(0, 4, core).astype(np.int8)
        refs[p, pad_left:pad_left + core] = bc
        at = int(rng.integers(0, 8))
        ln = max(0, min(core, int(qlen[p]) - at))
        q[p, at:at + ln] = bc[:ln]
        if p % 3 == 0 and ln > 6:                 # a substitution
            q[p, at + 4] = (q[p, at + 4] + 1) % 4
        if p % 5 == 0 and ln > 8:                 # a deletion
            q[p, at + 6:at + ln - 1] = q[p, at + 7:at + ln]
        if p % 7 == 0 and ln > 3:                 # an N in the query
            q[p, at + 2] = 4
    return q, qlen, refs, Lr


@pytest.mark.parametrize("pads", [(30, 40, 16), (15, 24, 32), (16, 28, 16),
                                  (4, 17, 16)])
def test_banded_plain_matches_full_rows(rng, pads):
    pad_left, pad_right, core = pads
    q, qlen, refs, Lr = _case(rng, pad_left, pad_right, core)
    c = pad_left + core
    s0, qp0, v0 = map(np.asarray, sw_end2end_xla(
        q, qlen, refs, np.full(len(q), Lr, np.int32), c))
    band = np.ascontiguousarray(refs[:, pad_left:c + 1])
    s1, qp1, v1 = (x.numpy() for x in sw_end2end_banded(
        torch.from_numpy(q), torch.from_numpy(qlen), torch.from_numpy(band),
        Lr, pad_left, c))
    np.testing.assert_array_equal(s1, s0)
    np.testing.assert_array_equal(v1, v0)
    np.testing.assert_array_equal(qp1, np.where(v0, qp0, -1))


def test_banded_plain_matches_oracle(rng):
    q, qlen, refs, Lr = _case(rng, 30, 40, 16, P=6, Lq=40)
    c = 46
    s1, qp1, v1 = sw_banded_plain(
        torch.from_numpy(q), torch.from_numpy(qlen),
        torch.from_numpy(np.ascontiguousarray(refs[:, 30:c + 1])), Lr, 30, c)
    for p in range(len(q)):
        want = sw_end2end_reference(q[p, :qlen[p]], refs[p], c)
        assert (int(s1[p]), int(qp1[p]), bool(v1[p])) == want


def _edge_rows(rng, pad_left, pad_right, core, Lq=96, P=12):
    """Full padded rows with edges first: qlen 0, 1 and Lq, a band all N,
    a band all PAD but for its last column (the first N of the right pad,
    which the banded route assumes), a query all N, and a homopolymer query against a
    homopolymer core (many query positions tie on the UMI column); the
    rest hold the core with a substitution."""
    q, qlen, refs, Lr = _case(rng, pad_left, pad_right, core, P=P, Lq=Lq)
    c = pad_left + core
    qlen[:7] = (0, 1, Lq, 60, 60, 60, 70)
    q[:7] = PAD
    for i in range(1, 7):
        q[i, :qlen[i]] = rng.integers(0, 4, qlen[i])
    q[1, 0] = refs[1, pad_left]
    q[2, 10:10 + core] = refs[2, pad_left:c]
    refs[3, pad_left:c + 1] = 4                   # the band all N
    refs[4, pad_left:c] = PAD                     # the core all PAD (column
                                                  # c is the row's first N)
    q[5, :qlen[5]] = 4                            # the query all N
    refs[6, pad_left:c] = 0                       # A core, A query
    q[6, :qlen[6]] = 0
    return q, qlen, refs, Lr


@pytest.mark.parametrize("pads", [(30, 40, 16), (15, 24, 32)])
def test_banded_plain_matches_full_rows_at_edges(rng, pads):
    pad_left, pad_right, core = pads
    q, qlen, refs, Lr = _edge_rows(rng, pad_left, pad_right, core)
    c = pad_left + core
    s0, qp0, v0 = map(np.asarray, sw_end2end_xla(
        q, qlen, refs, np.full(len(q), Lr, np.int32), c))
    band = np.ascontiguousarray(refs[:, pad_left:c + 1])
    s1, qp1, v1 = (x.numpy() for x in sw_banded_plain(
        torch.from_numpy(q), torch.from_numpy(qlen), torch.from_numpy(band),
        Lr, pad_left, c))
    np.testing.assert_array_equal(s1, s0)
    np.testing.assert_array_equal(v1, v0)
    np.testing.assert_array_equal(qp1, np.where(v0, qp0, -1))
    # the homopolymer row: the UMI column lies on an optimal path at more
    # than one query position (each shift of the core's A run), and the
    # largest is taken
    want = sw_end2end_reference(q[6, :qlen[6]], refs[6], c)
    assert (int(s1[6]), int(qp1[6]), bool(v1[6])) == want
    assert v1[6] and qp1[6] > core
