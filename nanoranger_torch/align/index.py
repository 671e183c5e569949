"""Reference minimizer index (host build).

Counterpart of the JAX package's align/index.py: the same arrays, built with
this package's own minimizer sketch on the CPU. Each indexed minimizer
carries a segment id `seg = ref_id*2 + strand` and an int32 position local
to its reference; chains only join anchors of equal seg, so the
addressable reference size is unbounded.

Long references are sketched in overlapping chunks that carry W-1 k-mers
of context on both sides, which keeps the chunked minimizer selection
identical to whole-sequence sketching (the window rule only looks W-1
k-mers away).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io import fasta
from ..io.encode import PAD
from .minimizers import K, W, sketch_batch

SMALL_REF_LIMIT = 1 << 18    # longer refs sketch in streaming chunks
CHUNK_KMERS = 1 << 17        # k-mer positions accepted per chunk
_CTX = W - 1                 # k-mers of boundary context per side
_CELLS = 1 << 22             # rows x padded length per sketch call


@dataclasses.dataclass
class PanelIndex:
    names: list
    seq_codes: list           # list of np int8 arrays (for extension)
    ref_lens: np.ndarray      # (R,)
    ref_offset: np.ndarray    # (R,) concatenated-layout offsets
    # sorted-by-hash flat minimizer arrays:
    hashes: np.ndarray        # (A,) uint32 sorted
    tpos: np.ndarray          # (A,) int32 position within its ref
    ref_id: np.ndarray        # (A,) int32
    strand: np.ndarray        # (A,) int32
    # ref_tensors' copies, one a device
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @classmethod
    def build(cls, names: list, seqs: list) -> "PanelIndex":
        ref_lens = np.array([len(s) for s in seqs], dtype=np.int32)
        ref_offset = np.zeros(len(seqs), dtype=np.int64)
        if len(seqs) > 1:
            ref_offset[1:] = np.cumsum(ref_lens[:-1].astype(np.int64))
        R = len(seqs)
        if R == 0:
            z32 = np.zeros(0, np.int32)
            return cls([], [], ref_lens, ref_offset,
                       np.zeros(0, np.uint32), z32, z32.copy(), z32.copy())
        hs, ps, rs, ss = [], [], [], []
        small = [rid for rid in range(R) if ref_lens[rid] <= SMALL_REF_LIMIT]
        large = [rid for rid in range(R) if ref_lens[rid] > SMALL_REF_LIMIT]
        if small:
            h_s, p_s, s_s = _sketch_small_batch([seqs[r] for r in small],
                                                ref_lens[small])
            for j, rid in enumerate(small):
                hs.append(h_s[j])
                ps.append(p_s[j])
                rs.append(np.full(len(h_s[j]), rid, np.int32))
                ss.append(s_s[j])
        for rid in large:
            h_l, p_l, s_l = _sketch_chunked(np.asarray(seqs[rid], np.int8))
            hs.append(h_l)
            ps.append(p_l)
            rs.append(np.full(len(h_l), rid, np.int32))
            ss.append(s_l)
        h = np.concatenate(hs).astype(np.uint32)
        p = np.concatenate(ps).astype(np.int32)
        r = np.concatenate(rs)
        s = np.concatenate(ss).astype(np.int32)
        order = np.argsort(h, kind="stable")
        return cls(list(names), [np.asarray(x, np.int8) for x in seqs],
                   ref_lens, ref_offset,
                   h[order], p[order], r[order], s[order])

    @classmethod
    def from_fasta(cls, path: str) -> "PanelIndex":
        names, seqs = fasta.read_fasta_encoded(path)
        return cls.build(names, seqs)

    @property
    def n_refs(self) -> int:
        return len(self.names)

    def ref_tensors(self, device) -> tuple:
        """(ref_flat, ref_off, ref_lens) on `device`: every reference's
        bases in one int8 tensor, the int32 offset of each reference in it
        and its int32 length. The one device form of the reference, which
        the fused step's tables and every extension of chain ends
        (ops/extend.extend_spans) take; built at the first call for a
        device and kept for the index's life."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev not in self._on_device:
            n_bases = int(self.ref_lens.astype(np.int64).sum())
            if n_bases >= 1 << 31:
                raise ValueError(
                    f"the reference holds {n_bases} bases; its device form "
                    "addresses them with int32 offsets, which reach "
                    "2^31 - 1")
            flat = (np.concatenate([np.asarray(s, np.int8)
                                    for s in self.seq_codes])
                    if self.n_refs else np.zeros(1, np.int8))
            self._on_device[dev] = tuple(
                torch.from_numpy(a).to(dev) for a in (
                    flat, self.ref_offset.astype(np.int32),
                    self.ref_lens.astype(np.int32)))
        return self._on_device[dev]


def _sketch(codes: np.ndarray, lens: np.ndarray, m: int):
    h, p, s, cnt = sketch_batch(torch.from_numpy(codes),
                                torch.from_numpy(lens), m)
    return h.numpy(), p.numpy(), s.numpy(), cnt.numpy()


def _sketch_small_batch(seqs, lens):
    """Padded sketches of the small refs, grouped by power-of-two length
    under a cell budget (a row's minimizers do not depend on its padding)."""
    R = len(seqs)
    order = sorted(range(R), key=lambda r: int(lens[r]))
    hs: list = [None] * R
    ps: list = [None] * R
    ss: list = [None] * R

    def pow2ceil(x, lo=128):
        v = lo
        while v < x:
            v *= 2
        return v

    i = 0
    while i < R:
        L = pow2ceil(int(lens[order[i]]))
        grp = [order[i]]
        j = i + 1
        while j < R and (len(grp) + 1) * pow2ceil(int(lens[order[j]])) \
                <= _CELLS:
            L = pow2ceil(int(lens[order[j]]))     # >= L (sorted)
            grp.append(order[j])
            j += 1
        codes = np.full((len(grp), L), PAD, np.int8)
        ln = np.zeros(len(grp), np.int32)
        for k, rid in enumerate(grp):
            codes[k, :len(seqs[rid])] = np.asarray(seqs[rid], np.int8)
            ln[k] = lens[rid]
        h_b, p_b, s_b, cnt = _sketch(codes, ln, L)
        for k, rid in enumerate(grp):
            c = int(cnt[k])
            hs[rid] = h_b[k, :c]
            ps[rid] = p_b[k, :c]
            ss[rid] = s_b[k, :c]
        i = j
    return hs, ps, ss


def _sketch_chunked(code: np.ndarray, chunk: int = CHUNK_KMERS):
    """Streaming sketch of one long reference, identical to whole-seq:
    each chunk row carries W-1 k-mers of context per side and keeps only
    the positions of its own span."""
    n_k = len(code) - K + 1
    if n_k <= 0:
        z = np.zeros(0, np.int32)
        return np.zeros(0, np.int64), z, z.copy()
    L_row = -(-(chunk + 2 * _CTX + K - 1) // 128) * 128
    hs, ps, ss = [], [], []
    for c0 in range(0, n_k, chunk):
        c1 = min(c0 + chunk, n_k)
        a0 = max(0, c0 - _CTX)
        a1 = min(n_k - 1, c0 + chunk - 1 + _CTX)
        seg = code[a0:a1 + K]
        codes = np.full((1, L_row), PAD, np.int8)
        codes[0, :len(seg)] = seg
        h, p, s, cnt = _sketch(codes, np.array([len(seg)], np.int32), L_row)
        c = int(cnt[0])
        gpos = p[0, :c].astype(np.int64) + a0
        m = (gpos >= c0) & (gpos < c1)
        hs.append(h[0, :c][m])
        ps.append(gpos[m].astype(np.int32))
        ss.append(s[0, :c][m])
    return np.concatenate(hs), np.concatenate(ps), np.concatenate(ss)
