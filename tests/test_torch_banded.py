"""The banded CIGAR DP's wrapper (nanoranger_torch/ops/banded.py) on the
CPU: the route follows the device it is given, and the kernel's launch
layout (the bases, meta rows, traceback offsets, CIGAR slots and the
launches the traceback cap splits a batch into) gives back the host
routine's outputs when each launch is stood in for by the host routine.
The kernel itself is held on the card (tests/test_torch_kernels_cuda.py)."""

import numpy as np
import torch

from nanoranger_torch import kernels, trace
from nanoranger_torch.ops import banded
from nanoranger_torch.ops.banded import banded_align
from nanoranger_torch.runtime.native_lib import banded_align_batch


def _segments(seed, n):
    """n (query, target) pairs of 0-300 bases, N included, some empty, a
    few far apart in length (bands widened to over 1,000 columns)."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(n):
        q = rng.integers(0, 5, int(rng.integers(0, 300))).astype(np.int8)
        t = q.copy()
        t[rng.random(len(t)) < 0.08] = rng.integers(0, 4)
        if k % 7 == 3:
            t = rng.integers(0, 4, int(rng.integers(0, 300))).astype(np.int8)
        qs.append(q)
        ts.append(t)
    qs += [np.zeros(0, np.int8), rng.integers(0, 4, 700).astype(np.int8)]
    ts += [np.zeros(0, np.int8), rng.integers(0, 4, 30).astype(np.int8)]
    return qs, ts


def _assert_equal(got, want):
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_banded_align_on_the_cpu_is_the_host_routine():
    qs, ts = _segments(1, 40)
    with trace.run() as tr:
        got = banded_align(qs, ts, 160, "cpu")
        empty = banded_align([], [], 48, torch.device("cpu"))
    _assert_equal(got, banded_align_batch(qs, ts, band=160))
    _assert_equal(empty, banded_align_batch([], [], band=48))
    assert tr.counters["banded.host_segments"] == len(qs)
    assert tr.counters.get("banded.device_segments", 0) == 0


def _host_launch(lib, fn, seq, meta, tb, rows, text, out, n, band, warps):
    """One launch stood in for by the host routine, segment by segment,
    after checking each segment's traceback and row room."""
    kernels.launches[lib] += 1
    s = seq.numpy()
    for r, (q0, lq, t0, lt, tb_off, slot, row_off) in enumerate(
            meta.tolist()):
        bw = 2 * max(band, abs(lq - lt) + 16) + 1
        if lq or lt:
            assert tb_off + (lq + 1) * bw <= tb.numel()
            assert row_off + 3 * bw <= rows.numel()
        (cig,), (sc,), (nm,) = banded_align_batch(
            [s[q0:q0 + lq]], [s[t0:t0 + lt]], band=band)
        end = slot + 2 * (lq + lt)
        text[end - len(cig):end] = torch.tensor(list(cig.encode()),
                                                dtype=torch.uint8)
        out[r] = torch.tensor([sc, nm, end - len(cig), len(cig)])


def test_banded_launch_layout_gives_the_host_routines_outputs(monkeypatch):
    qs, ts = _segments(2, 60)
    monkeypatch.setattr(kernels, "entry", lambda *a: None)
    monkeypatch.setattr(kernels, "launch", _host_launch)
    for band, cap in ((48, banded.TB_CAP), (160, 200_000)):
        monkeypatch.setattr(banded, "TB_CAP", cap)
        before = kernels.launches["banded"]
        got = banded._banded_cuda(qs, ts, band, torch.device("cpu"))
        _assert_equal(got, banded_align_batch(qs, ts, band=band))
        # one launch under the default cap; the small cap splits the batch
        n_launches = kernels.launches["banded"] - before
        assert n_launches == 1 if cap > 1e6 else n_launches >= 10
