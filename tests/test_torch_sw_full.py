"""Full-row rescorer of the PyTorch port (ops/sw.py::sw_end2end_plain, the
plain version of the Hopper kernel csrc/sw_full.cu) against the JAX
package's XLA scorer, its Pallas kernel in interpret mode and the numpy
oracle; the banded route against the full-row route on every
chemistry's pad geometry; and a torch model of the kernel's split at the UMI
column (test_torch_kernels_cuda.split_model) against the XLA scorer on the
card test's own rows. Score, validity and UMI position are integers and
must be equal bit for bit."""

import numpy as np
import pytest
import torch

from nanoranger_tpu.io.encode import PAD
from nanoranger_tpu.ops.pallas_sw import sw_end2end_pallas
from nanoranger_tpu.ops.sw import sw_end2end_reference, sw_end2end_xla

from nanoranger_torch.ops import sw
from test_torch_kernels_cuda import (SPLIT_CASES, side_decided, split_model,
                                     split_rows)

torch.set_num_threads(1)

GEOMETRIES = [(30, 40, 16), (15, 24, 32), (16, 28, 16), (4, 17, 16)]


def _case(rng, pad_left, pad_right, core, P=24, Lq=64):
    """Padded-whitelist rows with the core planted in the query, damaged by
    a substitution, a deletion or an N on some rows."""
    Lr = pad_left + core + pad_right
    q = rng.integers(0, 4, size=(P, Lq)).astype(np.int8)
    qlen = rng.integers(25, Lq + 1, size=P).astype(np.int32)
    qlen[0] = 0
    qlen[1] = Lq
    refs = np.full((P, Lr), 4, np.int8)           # N pads
    for p in range(P):
        q[p, qlen[p]:] = PAD
        bc = rng.integers(0, 4, core).astype(np.int8)
        refs[p, pad_left:pad_left + core] = bc
        at = int(rng.integers(0, 8))
        ln = max(0, min(core, int(qlen[p]) - at))
        q[p, at:at + ln] = bc[:ln]
        if p % 3 == 0 and ln > 6:
            q[p, at + 4] = (q[p, at + 4] + 1) % 4
        if p % 5 == 0 and ln > 8:
            q[p, at + 6:at + ln - 1] = q[p, at + 7:at + ln]
        if p % 7 == 0 and ln > 3:
            q[p, at + 2] = 4
    return q, qlen, refs, Lr


def _plain(q, qlen, refs, rlen, c, **kw):
    out = sw.sw_end2end(torch.from_numpy(q), torch.from_numpy(qlen),
                        torch.from_numpy(refs), torch.from_numpy(rlen), c,
                        **kw)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("pads", GEOMETRIES)
def test_plain_matches_xla(rng, pads):
    pad_left, pad_right, core = pads
    q, qlen, refs, Lr = _case(rng, *pads)
    rlen = np.full(len(q), Lr, np.int32)
    c = pad_left + core
    s0, qp0, v0 = map(np.asarray, sw_end2end_xla(q, qlen, refs, rlen, c))
    s1, qp1, v1 = _plain(q, qlen, refs, rlen, c)
    np.testing.assert_array_equal(s1, s0)
    np.testing.assert_array_equal(v1, v0)
    np.testing.assert_array_equal(qp1, qp0)
    assert v0.sum() > len(q) // 2


@pytest.mark.parametrize("c", [0, 20, 59])
def test_plain_matches_xla_ragged_refs(rng, c):
    """Random (unpadded) references of differing lengths, PAD beyond each,
    and the UMI column at both ends of the row."""
    P, Lq, Lr = 20, 48, 60
    q = rng.integers(0, 5, size=(P, Lq)).astype(np.int8)
    qlen = rng.integers(0, Lq + 1, size=P).astype(np.int32)
    refs = rng.integers(0, 5, size=(P, Lr)).astype(np.int8)
    rlen = rng.integers(1, Lr + 1, size=P).astype(np.int32)
    rlen[:4] = Lr
    for p in range(P):
        q[p, qlen[p]:] = PAD
        refs[p, rlen[p]:] = PAD
        n = min(int(qlen[p]), int(rlen[p]) - 3)
        if n > 0:
            q[p, :n] = refs[p, 3:3 + n]
    s0, qp0, v0 = map(np.asarray, sw_end2end_xla(q, qlen, refs, rlen, c))
    s1, qp1, v1 = _plain(q, qlen, refs, rlen, c)
    np.testing.assert_array_equal(s1, s0)
    np.testing.assert_array_equal(v1, v0)
    np.testing.assert_array_equal(qp1, qp0)


@pytest.mark.parametrize("trial", range(2))
def test_plain_matches_pallas_interpret(rng, trial):
    q, qlen, refs, Lr = _case(rng, 30, 40, 16, P=20)
    rlen = np.full(len(q), Lr, np.int32)
    s0, qp0, v0 = map(np.asarray, sw_end2end_pallas(q, qlen, refs, rlen, 46,
                                                    interpret=True))
    s1, qp1, v1 = _plain(q, qlen, refs, rlen, 46)
    np.testing.assert_array_equal(s1, s0)
    np.testing.assert_array_equal(v1, v0)
    np.testing.assert_array_equal(qp1, qp0)


@pytest.mark.parametrize("pads", GEOMETRIES)
def test_plain_matches_oracle(rng, pads):
    pad_left, pad_right, core = pads
    q, qlen, refs, Lr = _case(rng, *pads, P=6, Lq=40)
    c = pad_left + core
    s1, qp1, v1 = _plain(q, qlen, refs, np.full(len(q), Lr, np.int32), c)
    for p in range(len(q)):
        want = sw_end2end_reference(q[p, :qlen[p]], refs[p], c)
        assert (int(s1[p]), int(qp1[p]), bool(v1[p])) == want


@pytest.mark.parametrize("pads", GEOMETRIES)
def test_banded_matches_full(rng, pads):
    """sw_end2end with pad_left (the banded route) == without it (the
    full-row route), from full rows and from pre-sliced bands."""
    pad_left, pad_right, core = pads
    q, qlen, refs, Lr = _case(rng, *pads)
    rlen = np.full(len(q), Lr, np.int32)
    c = pad_left + core
    full = _plain(q, qlen, refs, rlen, c)
    banded = _plain(q, qlen, refs, rlen, c, pad_left=pad_left)
    band = np.ascontiguousarray(refs[:, pad_left:c + 1])
    sliced = _plain(q, qlen, band, rlen, c, pad_left=pad_left, full_len=Lr)
    for a, b, d in zip(full, banded, sliced):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(d, a)


def test_plain_refuses_a_column_outside_the_row(rng):
    q, qlen, refs, Lr = _case(rng, 4, 17, 16, P=3)
    with pytest.raises(ValueError, match="umi_ref_offset"):
        _plain(q, qlen, refs, np.full(3, Lr, np.int32), Lr)


@pytest.mark.parametrize("Lq,Lr,c", SPLIT_CASES)
def test_split_model_matches_xla(Lq, Lr, c):
    """The identity csrc/sw_full.cu rests on: the forward half over columns
    0..k-1, the backward half over lr-1..k, k = min(c + 1, lr), and the
    three terms combined give the XLA scorer's score, UMI position and
    validity, on the card test's rows (ragged rlen, some at or below c,
    queries planted left of c, right of it and across it, qlen 0 and 1);
    and on those rows each side term alone decides some pairs."""
    rng = np.random.default_rng(Lq * Lr + c)
    q, qlen, refs, rlen = split_rows(rng, 300, Lq, Lr, c)
    s0, qp0, v0 = map(np.asarray, sw_end2end_xla(q, qlen, refs, rlen, c))
    s1, qp1, v1, terms = split_model(q, qlen, refs, rlen, c)
    np.testing.assert_array_equal(s1.numpy(), s0)
    np.testing.assert_array_equal(v1.numpy(), v0)
    np.testing.assert_array_equal(qp1.numpy(), qp0)
    if 8 <= c <= Lr - 8 and Lq > 1:
        f_only, b_only = side_decided(terms)
        assert f_only > 0 and b_only > 0
