"""One-vs-all whitelist DP of the PyTorch port (ops/whitelist_verify.py,
plain version of the Hopper kernel csrc/verify.cu) against the JAX
package's XLA version and its brute-force per-row oracle. Scores, best
indices and tie counts must be equal."""

import numpy as np
import pytest
import torch

from nanoranger_tpu.io.encode import N, PAD
from nanoranger_tpu.ops.whitelist_verify import verify_all_xla, verify_reference

from nanoranger_torch.ops.whitelist_verify import verify_all, verify_all_plain

torch.set_num_threads(1)


def _case(rng, C, R, m, Lq, with_n=False):
    cores = rng.integers(0, 4, size=(R, m)).astype(np.int8)
    cores[R // 2] = cores[0]                  # a duplicated core: ties
    q = np.full((C, Lq), PAD, np.int8)
    qlen = np.zeros(C, np.int32)
    seqs = []
    for i in range(C):
        n = int(rng.integers(0, Lq + 1))
        s = rng.integers(0, 4, size=n).astype(np.int8)
        if n >= m and rng.random() < 0.6:
            r = 0 if i % 4 == 0 else int(rng.integers(0, R))
            pos = int(rng.integers(0, n - m + 1))
            s[pos:pos + m] = cores[r]
            if rng.random() < 0.5:
                s[pos + int(rng.integers(0, m))] = int(rng.integers(0, 4))
        if with_n and n:
            s[int(rng.integers(0, n))] = N
        q[i, :n] = s
        qlen[i] = n
        seqs.append(s)
    return cores, q, qlen, seqs


def _port(q, qlen, coreT, r_valid, pad_left, pad_right, **kw):
    fn = verify_all_plain if kw else verify_all
    out = fn(torch.from_numpy(q), torch.from_numpy(qlen),
             torch.from_numpy(np.ascontiguousarray(coreT)), r_valid,
             pad_left, pad_right, **kw)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("geom", [
    # (C, R, m, pad_left, pad_right, Lq, with_n)
    (6, 13, 8, 6, 9, 24, False),
    (8, 9, 6, 2, 3, 18, False),      # pads overflow: forced insertions
    (6, 7, 8, 5, 5, 20, True),       # N chars score 0
    (10, 40, 16, 30, 40, 60, False),  # the 5p10X geometry
])
def test_plain_matches_xla_and_oracle(rng, geom):
    C, R, m, pl, pr, Lq, with_n = geom
    cores, q, qlen, seqs = _case(rng, C, R, m, Lq, with_n)
    want = [np.asarray(x) for x in verify_all_xla(
        q, qlen, cores.T.copy(), R, pl, pr, r_chunk=8)]
    got = _port(q, qlen, cores.T, R, pl, pr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i in range(C):
        assert tuple(int(x[i]) for x in got) == \
            verify_reference(seqs[i], cores, pl, pr)


def test_plain_scores_n_and_pad_in_cores_and_queries(rng):
    """N and PAD inside the cores and PAD inside the queries, which the
    Hopper kernel scores through a PAD bitmask and uniform branches: the
    plain version equals the XLA version (PAD before N, as the Pallas
    kernel scores too) and, on the queries without a PAD, the oracle,
    which scores a query PAD against a core N as 0."""
    C, R, m, pl, pr, Lq = 8, 12, 8, 4, 5, 20
    cores, q, qlen, seqs = _case(rng, C, R, m, Lq, with_n=True)
    u = rng.random((R, m))
    cores[u < 0.15] = N
    cores[(u >= 0.15) & (u < 0.3)] = PAD
    with_pad = np.arange(C) % 2 == 1
    for i in np.where(with_pad & (qlen > 2))[0]:
        q[i, 1] = PAD
    want = [np.asarray(x) for x in verify_all_xla(
        q, qlen, cores.T.copy(), R, pl, pr, r_chunk=8)]
    got = _port(q, qlen, cores.T, R, pl, pr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i in np.where(~with_pad)[0]:
        assert tuple(int(x[i]) for x in got) == \
            verify_reference(seqs[i], cores, pl, pr)


def test_rows_past_r_valid_never_win(rng):
    R, m = 5, 8
    cores = rng.integers(0, 4, size=(R, m)).astype(np.int8)
    q = np.full((2, 20), PAD, np.int8)
    q[0, :m] = cores[2]
    qlen = np.array([m, 0], np.int32)
    coreT = np.pad(cores.T, ((0, 0), (0, 3)), constant_values=PAD)
    coreT[:, R] = cores[2]                    # a padding row equal to row 2
    want = [np.asarray(x) for x in verify_all_xla(q, qlen, coreT, R, 4, 4,
                                                  r_chunk=8)]
    best, idx, ties = _port(q, qlen, coreT, R, 4, 4)
    for g, w in zip((best, idx, ties), want):
        np.testing.assert_array_equal(g, w)
    assert best[0] == m and idx[0] == 2 and ties[0] == 1
    assert best[1] == 0 and ties[1] == R      # empty candidate


def test_row_chunks_merge_like_one_pass(rng):
    cores, q, qlen, _ = _case(rng, 8, 50, 8, 24)
    whole = _port(q, qlen, cores.T, 50, 6, 9)
    chunked = _port(q, qlen, cores.T, 50, 6, 9, r_chunk=7)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)
