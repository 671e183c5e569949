"""Streamed fastq(.gz) reading into fixed-shape device-ready batches.

Replaces the reference's seqkit-split + per-shard pysam fastq handling
(reference pipeline.py:76-151): instead of materializing N shard files, we
stream records and emit padded (B, L) int8 batches with length/ID sidecars.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
from typing import Iterator

import numpy as np

from .encode import encode_batch


@dataclasses.dataclass
class FastqRecord:
    name: str        # full header line sans '@' (first token; reference uses qname)
    seq: bytes
    qual: bytes


@dataclasses.dataclass
class ReadBatch:
    """Columnar batch of reads: the engine's unit of work.

    codes:   (B, L) int8 base codes, PAD-padded
    lengths: (B,)   int32
    names:   list[str] read names (host-side join key, replaces the
             reference's read-name string metadata, SURVEY.md §1)
    quals:   list[bytes] raw quality strings (host-side; only needed at
             output boundaries, never shipped to device)
    """
    codes: np.ndarray
    lengths: np.ndarray
    names: list
    quals: list

    def __len__(self):
        return len(self.names)


def _open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(
            io.BufferedReader(gzip.open(path, "rb"), buffer_size=1 << 20),
            encoding="ascii", errors="replace")
    return open(path, "rt", buffering=1 << 20)


def iter_fastq(path: str) -> Iterator[FastqRecord]:
    """Yield records from a fastq or fastq.gz file."""
    with _open_text(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            header = header.rstrip("\n")
            if not header:
                continue
            if not header.startswith("@"):
                raise ValueError(f"malformed fastq header: {header[:60]!r}")
            seq = f.readline().rstrip("\n")
            plus = f.readline()
            if not plus.startswith("+"):
                raise ValueError("malformed fastq: missing '+' line")
            qual = f.readline().rstrip("\n")
            # reference uses pysam qname == first whitespace token
            name = header[1:].split()[0] if header[1:] else ""
            yield FastqRecord(name, seq.encode("ascii"), qual.encode("ascii"))


def _bucket_len(L: int, max_len, pad_to_multiple) -> int:
    """Batch width policy. With pad_to_multiple set: round up to that
    multiple (exact control for benches/tests). Default (None): round up
    to a power of two >= 128 — few distinct widths means few XLA compile
    buckets, which dominates cold-start time on remote-compile backends."""
    if pad_to_multiple:
        w = max(pad_to_multiple,
                ((L + pad_to_multiple - 1) // pad_to_multiple)
                * pad_to_multiple)
    else:
        w = 128
        while w < L:
            w *= 2
    if max_len is not None:
        w = min(w, max(max_len, 1))
    return w


def iter_batches(path: str, batch_size: int = 4096,
                 max_len: int | None = None,
                 pad_to_multiple: int | None = None) -> Iterator[ReadBatch]:
    """Stream fixed-shape batches; width per _bucket_len, `max_len`
    truncates pathological ultra-long reads. Uses the native (C++) reader
    when `max_len` is given and its library is available
    (runtime/native/fastq_reader.cpp), the Python parser otherwise —
    identical batches either way."""
    if max_len is not None:
        try:
            from ..runtime.native_lib import NativeFastqReader
            rdr = NativeFastqReader(path, batch_size, max_len)
        except OSError:
            rdr = None
        if rdr is not None:
            try:
                while True:
                    out = rdr.next_batch()
                    if out is None:
                        return
                    codes, lengths, names, quals = out
                    L = _bucket_len(int(lengths.max(initial=0)), max_len,
                                    pad_to_multiple)
                    yield ReadBatch(np.ascontiguousarray(codes[:, :L]),
                                    lengths, names, quals)
            finally:
                rdr.close()

    buf: list[FastqRecord] = []
    for rec in iter_fastq(path):
        buf.append(rec)
        if len(buf) == batch_size:
            yield _make_batch(buf, max_len, pad_to_multiple)
            buf = []
    if buf:
        yield _make_batch(buf, max_len, pad_to_multiple)


def _make_batch(records: list[FastqRecord], max_len, pad_to_multiple) -> ReadBatch:
    L = max((len(r.seq) for r in records), default=0)
    if max_len is not None:
        L = min(L, max_len)
    L = _bucket_len(L, max_len, pad_to_multiple)
    codes, lengths = encode_batch([r.seq for r in records], max_len=L)
    # qual truncated with the sequence: emitted records' seq/qual lengths
    # must match (BAM requires it), and no stage reads qual beyond length
    return ReadBatch(codes, lengths,
                     [r.name for r in records], [r.qual[:L] for r in records])


def read_all(path: str, max_len: int | None = None,
             pad_to_multiple: int | None = None) -> ReadBatch:
    """Load an entire (small) fastq as one batch — used for tests/golden runs."""
    records = list(iter_fastq(path))
    return _make_batch(records, max_len, pad_to_multiple)


class FastqWriter:
    """Write fastq(.gz); gz output uses a single deflate stream (pigz-free).

    Writes to `<path>.tmp` and renames on close: an existing artifact is
    therefore always COMPLETE, making the resume-on-existence idiom safe
    (the reference resumes from half-written files after a crashed tool,
    SURVEY.md §5 — a hazard fixed here, not replicated)."""

    def __init__(self, path: str, compresslevel: int = 1):
        # level 1: artifact writes sit on the streamed pipeline's critical
        # path; deflate level is a ~2.5x time / ~15% size trade (the
        # reference shells out to parallel pigz instead)
        self.path = path
        self._tmp = path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if path.endswith(".gz"):
            self._f = gzip.open(self._tmp, "wb", compresslevel=compresslevel)
        else:
            self._f = open(self._tmp, "wb")

    def write(self, name: str, seq: str | bytes, qual: str | bytes):
        if isinstance(seq, str):
            seq = seq.encode("ascii")
        if isinstance(qual, str):
            qual = qual.encode("ascii")
        self._f.write(b"@" + name.encode("ascii") + b"\n" + seq + b"\n+\n" + qual + b"\n")

    def close(self):
        self._f.close()
        os.replace(self._tmp, self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
