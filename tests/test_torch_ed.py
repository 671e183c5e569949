"""Adapter scan of the PyTorch port (ops/edit_distance.py, plain version of
the Hopper kernel csrc/ed.cu) against the JAX package's XLA version and
its edlib oracle, with the N wildcard on and off and both choices of the
optimal end, at the window widths and pattern lengths of all seven modes;
and the flank scan of stages/decon.py (whole flank and sliding
sub-windows) against the JAX package's. Integer outputs must be equal."""

import numpy as np
import pytest
import torch

from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.io.encode import PAD, encode
from nanoranger_tpu.ops.edit_distance import edlib_hw_reference, hw_locate_xla
from nanoranger_tpu.stages.decon import _scan_flanks as jax_scan_flanks

from nanoranger_torch import chemistry
from nanoranger_torch.ops.edit_distance import hw_locate, hw_locate_plain
from nanoranger_torch.stages.decon import _scan_flanks

torch.set_num_threads(1)


def _case(rng, B=24, W=100, m=51):
    alph = np.array([0, 1, 2, 3, 4], dtype=np.int8)
    p = [0.24, 0.24, 0.24, 0.24, 0.04]
    pattern = rng.choice(alph, size=m, p=p).astype(np.int8)
    texts = rng.choice(alph, size=(B, W), p=p).astype(np.int8)
    lengths = rng.integers(m // 2, W + 1, size=B).astype(np.int32)
    lengths[0] = 0
    for b in range(B):
        texts[b, lengths[b]:] = PAD
    for b in range(1, B, 3):         # planted, lightly mutated hits
        if lengths[b] < m:
            continue
        p0 = int(rng.integers(0, lengths[b] - m + 1))
        texts[b, p0:p0 + m] = pattern
        for _ in range(int(rng.integers(0, 4))):
            texts[b, p0 + int(rng.integers(0, m))] = int(rng.integers(0, 4))
    return pattern, texts, lengths


def _port(pattern, texts, lengths, k, wildcard, pick_last):
    out = hw_locate(torch.from_numpy(pattern), torch.from_numpy(texts),
                    torch.from_numpy(lengths), k, wildcard=wildcard,
                    pick_last=pick_last)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("pick_last", [False, True])
@pytest.mark.parametrize("m,k", [(51, 6), (14, 2)])
def test_plain_matches_xla(rng, wildcard, pick_last, m, k):
    pattern, texts, lengths = _case(rng, m=m)
    d0, s0, e0 = map(np.asarray, hw_locate_xla(
        pattern, texts, lengths, k, wildcard=wildcard, pick_last=pick_last))
    d1, s1, e1 = _port(pattern, texts, lengths, k, wildcard, pick_last)
    np.testing.assert_array_equal(d1, d0)
    hit = d0 >= 0
    assert hit.any()
    np.testing.assert_array_equal(s1[hit], s0[hit])
    np.testing.assert_array_equal(e1[hit], e0[hit])
    assert (s1[~hit] == -1).all() and (e1[~hit] == -1).all()


@pytest.mark.parametrize("wildcard", [False, True])
@pytest.mark.parametrize("pick_last", [False, True])
def test_plain_matches_edlib_oracle(rng, wildcard, pick_last):
    pattern, texts, lengths = _case(rng, B=8, W=40, m=12)
    d1, s1, e1 = _port(pattern, texts, lengths, 3, wildcard, pick_last)
    for b in range(len(texts)):
        ref = edlib_hw_reference(pattern, texts[b, :lengths[b]], 3,
                                 wildcard=wildcard)
        assert d1[b] == ref["editDistance"]
        if ref["editDistance"] >= 0:
            loc = ref["locations"][-1 if pick_last else 0]
            assert (s1[b], e1[b]) == loc


def test_wrapper_takes_plain_version_on_cpu(rng):
    pattern, texts, lengths = _case(rng, B=6)
    args = [torch.from_numpy(a) for a in (pattern, texts, lengths)]
    for x, y in zip(hw_locate(*args, 6, True, True),
                    hw_locate_plain(*args, 6, True, True)):
        assert torch.equal(x, y)


# (W, m, k, wildcard, pick_last) of the other modes' scans: 5p10XTCR,
# 3p10XTCR, the 270-wide sub-windows of 3p10XTCR_nuc / 3p10XGEX, slideseq
WIDE = [(220, 53, 6, True, True), (150, 54, 5, True, False),
        (270, 20, 2, False, False), (270, 20, 3, False, False),
        (40, 18, 2, False, False)]


@pytest.mark.parametrize("W,m,k,wildcard,pick_last", WIDE)
def test_plain_matches_xla_at_every_modes_shape(rng, W, m, k, wildcard,
                                                pick_last):
    pattern, texts, lengths = _case(rng, B=16, W=W, m=m)
    d0, s0, e0 = map(np.asarray, hw_locate_xla(
        pattern, texts, lengths, k, wildcard=wildcard, pick_last=pick_last))
    d1, s1, e1 = _port(pattern, texts, lengths, k, wildcard, pick_last)
    np.testing.assert_array_equal(d1, d0)
    hit = d0 >= 0
    assert hit.any()
    np.testing.assert_array_equal(s1[hit], s0[hit])
    np.testing.assert_array_equal(e1[hit], e0[hit])
    assert (s1[~hit] == -1).all() and (e1[~hit] == -1).all()


def _flank_case(rng, spec, B=6, L=2560, R=14):
    """Reads with the mode's adapter planted at varying distances after (or
    before) a record's span, on both strands, plus records whose flank is
    cut short by the read's end."""
    pat = encode(spec.scan.pattern)
    real = np.where(pat == 4, 0, pat)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    lengths = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    lengths[0] = L
    read_idx = rng.integers(0, B, size=R).astype(np.int32)
    strand = rng.integers(0, 2, size=R).astype(np.int32)
    qstart = np.zeros(R, np.int32)
    qend = np.zeros(R, np.int32)
    f = spec.flank
    span = f.hi - f.lo
    for r in range(R):
        n = int(lengths[read_idx[r]])
        qstart[r] = int(rng.integers(0, n // 3))
        qend[r] = int(rng.integers(n // 3, n))
        if r % 5 == 4:
            # the span reaches both read ends: a flank of a few bases
            qstart[r], qend[r] = 3, n - 5
            continue
        # stored-orientation anchor of the flank
        s_qstart = n - qend[r] if strand[r] else qstart[r]
        s_qend = n - qstart[r] if strand[r] else qend[r]
        a = s_qstart if f.anchor == "qstart" else s_qend
        at = a + f.lo + int(rng.integers(0, max(span - len(pat), 1)))
        at = max(0, min(at, n - len(pat)))
        motif = real.copy()
        if r % 3 == 0:
            motif[int(rng.integers(len(pat)))] ^= 1    # one substitution
        if strand[r]:
            lo = n - at - len(pat)
            codes[read_idx[r], lo:lo + len(pat)] = (3 - motif)[::-1]
        else:
            codes[read_idx[r], at:at + len(pat)] = motif
    for b in range(B):
        codes[b, lengths[b]:] = PAD
    return codes, lengths, read_idx, strand, qstart, qend


@pytest.mark.parametrize("mode", ["3pXCR_slideseq", "3p10XTCR_nuc",
                                  "3p10XGEX", "3p10XTCR", "5p10XTCR"])
def test_scan_flanks_equals_jax(rng, mode):
    spec = chemistry.get(mode)
    jspec = jax_chemistry.get(mode)
    arrs = _flank_case(rng, spec)
    f, sc = spec.flank, spec.scan
    anchor = 0 if f.anchor == "qstart" else 1
    want = jax_scan_flanks(
        *arrs, anchor=anchor, lo=f.lo, hi=f.hi,
        pattern=encode(jspec.scan.pattern).tobytes(), k=sc.k,
        wildcard=sc.n_wildcard, pick_last=sc.pick_last,
        wsize=sc.window_size, stride=sc.window_stride,
        plus_one=sc.windows_plus_one)
    got = _scan_flanks(
        *[torch.from_numpy(a) for a in arrs], anchor, f.lo, f.hi,
        torch.from_numpy(encode(sc.pattern)), sc.k, sc.n_wildcard,
        sc.pick_last, sc.window_size, sc.window_stride, sc.windows_plus_one)
    names = ("window", "wlen", "wstart", "ed", "gstart", "gend")
    for nm, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=nm)
    ed = got[3].numpy()
    assert (ed >= 0).sum() >= 4 and (ed < 0).any()
    if sc.window_size is not None:
        # hits beyond the first sub-window: the offset was added
        assert (got[4].numpy() >= sc.window_stride).any()


def _edge_case(rng, m, W=80, B=24):
    """B rows of W against a pattern of m with N in both: lengths 0, 1,
    m - 1 and W first, then random; every other row from row 4 on holds
    the pattern (every second one of them with one substitution), row 4 at
    the start of its text."""
    p = [0.22, 0.22, 0.22, 0.22, 0.12]
    pattern = rng.choice(5, size=m, p=p).astype(np.int8)
    texts = rng.choice(5, size=(B, W), p=p).astype(np.int8)
    lengths = rng.integers(0, W + 1, size=B).astype(np.int32)
    lengths[:4] = (0, 1, min(max(m - 1, 0), W), W)
    for b in range(4, B, 2):
        lengths[b] = rng.integers(m, W + 1)
        p0 = 0 if b == 4 else int(rng.integers(0, lengths[b] - m + 1))
        texts[b, p0:p0 + m] = pattern
        if b % 4 == 2 and m > 1:
            texts[b, p0 + int(rng.integers(0, m))] = int(rng.integers(0, 4))
    for b in range(B):
        texts[b, lengths[b]:] = PAD
    return pattern, texts, lengths


# m at the word boundaries of csrc/ed.cu's bit vectors (one 32-bit word up
# to 32, two up to 64); pick_last flips with the word count, so each
# (wildcard, pick_last) pair meets one and two words
@pytest.mark.parametrize("m", [1, 31, 32, 33, 63, 64])
@pytest.mark.parametrize("wildcard", [False, True])
def test_plain_matches_xla_and_oracle_at_word_edges(rng, m, wildcard):
    pick_last = wildcard != (m > 32)
    pattern, texts, lengths = _edge_case(rng, m)
    for k in (0, 3):
        d0, s0, e0 = map(np.asarray, hw_locate_xla(
            pattern, texts, lengths, k, wildcard=wildcard,
            pick_last=pick_last))
        d1, s1, e1 = _port(pattern, texts, lengths, k, wildcard, pick_last)
        np.testing.assert_array_equal(d1, d0)
        hit = d0 >= 0
        assert hit.sum() >= 3
        np.testing.assert_array_equal(s1[hit], s0[hit])
        np.testing.assert_array_equal(e1[hit], e0[hit])
        assert (s1[~hit] == -1).all() and (e1[~hit] == -1).all()
    # the oracle gives an empty text distance m and no location where
    # m <= k; the XLA version, whose semantics the port keeps, no hit
    for b in np.flatnonzero(lengths > 0):
        ref = edlib_hw_reference(pattern, texts[b, :lengths[b]], 3,
                                 wildcard=wildcard)
        assert d1[b] == ref["editDistance"]
        if ref["editDistance"] >= 0:
            loc = ref["locations"][-1 if pick_last else 0]
            assert (s1[b], e1[b]) == loc


@pytest.mark.parametrize("m", [1, 31, 32, 33, 63, 64])
def test_hit_spans_at_most_m_plus_dist(rng, m):
    """Every hit has end - start + 1 <= m + dist (an alignment of m bases
    to a longer text costs at least the difference): the kernel's reverse
    walk stops at m + dist columns from the end on this."""
    pattern, texts, lengths = _edge_case(rng, m)
    for wildcard in (False, True):
        for pick_last in (False, True):
            d, s, e = _port(pattern, texts, lengths, m, wildcard, pick_last)
            hit = d >= 0
            assert (hit == (lengths > 0)).all()
            assert (e[hit] - s[hit] + 1 <= m + d[hit]).all()
            assert (s[hit] >= 0).all() and (e[hit] < lengths[hit]).all()
