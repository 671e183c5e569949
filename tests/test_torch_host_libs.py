"""The port's host C++ libraries: the native fastq reader gives the
Python parser's batches (and the JAX package's) byte for byte, plain and
gzipped, truncation included, and iter_batches falls back to the parser
when the reader cannot run; the reader builds into a library of its own,
so the aligner and DP twin's library keeps its digest and builds without
zlib; and the prewarm tool leaves a build directory that later runs use
as it is, with no second g++ call."""

import gzip
import hashlib
import json
import os
import subprocess

import numpy as np
import pytest
import torch

from nanoranger_tpu.io import fastq as jax_fastq

from nanoranger_torch import kernels
from nanoranger_torch.io import fastq
from nanoranger_torch.runtime import native_lib
from nanoranger_torch.tools import prewarm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "data", "samples",
                      "K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1.fastq.gz")


class _Boom:
    def __init__(self, *a, **k):
        raise OSError("forced python path")


def _parser_batches(monkeypatch, path, *a, **kw):
    with monkeypatch.context() as m:
        m.setattr(native_lib, "NativeFastqReader", _Boom)
        return list(fastq.iter_batches(path, *a, **kw))


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.names == b.names
        assert a.quals == b.quals
        assert a.lengths.dtype == b.lengths.dtype
        np.testing.assert_array_equal(a.lengths, b.lengths)
        assert a.codes.dtype == b.codes.dtype
        assert a.codes.shape == b.codes.shape
        np.testing.assert_array_equal(a.codes, b.codes)


@pytest.fixture(scope="module")
def synthetic_fastq(tmp_path_factory):
    """300 reads of 5-900 bases over ACGTN with a comment after the name,
    written plain and gzipped."""
    rng = np.random.default_rng(11)
    recs = []
    for i in range(300):
        n = int(rng.integers(5, 900))
        seq = "".join(rng.choice(list("ACGTN"), n))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 40, n))
        recs.append((f"read-{i} extra info", seq, qual))
    body = "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in recs)
    d = tmp_path_factory.mktemp("fq")
    plain = d / "a.fastq"
    plain.write_text(body)
    gz = d / "a.fastq.gz"
    with gzip.open(gz, "wt") as f:
        f.write(body)
    return {"plain": str(plain), "gz": str(gz)}


@pytest.mark.parametrize("kind", ["plain", "gz"])
def test_native_reader_matches_parser(synthetic_fastq, monkeypatch, kind):
    assert native_lib.load("nrfastq") is not None, "g++ -lz build failed"
    path = synthetic_fastq[kind]
    seen = []

    class Recording(native_lib.NativeFastqReader):
        def __init__(self, *a):
            seen.append(a)
            super().__init__(*a)

    monkeypatch.setattr(native_lib, "NativeFastqReader", Recording)
    nat = list(fastq.iter_batches(path, 128, max_len=512))
    assert seen == [(path, 128, 512)]            # the reader ran
    py = _parser_batches(monkeypatch, path, 128, max_len=512)
    assert len(nat) == 3
    assert max(len(q) for b in nat for q in b.quals) == 512   # truncated
    _assert_same(nat, py)
    _assert_same(nat, list(jax_fastq.iter_batches(path, 128, max_len=512)))
    # names keep only the first whitespace token (pysam qname semantics)
    assert nat[0].names[0] == "read-0"


def test_native_reader_on_a_sample_equals_parser_and_jax(monkeypatch):
    nat = list(fastq.iter_batches(SAMPLE, 1500, max_len=4096))
    py = _parser_batches(monkeypatch, SAMPLE, 1500, max_len=4096)
    _assert_same(nat, py)
    _assert_same(nat, list(jax_fastq.iter_batches(SAMPLE, 1500,
                                                  max_len=4096)))
    # with pad_to_multiple the widths follow the same policy
    _assert_same(list(fastq.iter_batches(SAMPLE, 1500, max_len=4096,
                                         pad_to_multiple=96)),
                 _parser_batches(monkeypatch, SAMPLE, 1500, max_len=4096,
                                 pad_to_multiple=96))


def test_reader_errors_and_fallback(tmp_path, monkeypatch,
                                    synthetic_fastq):
    with pytest.raises(OSError, match="cannot open"):
        native_lib.NativeFastqReader(str(tmp_path / "none.fastq"), 8, 64)
    bad = tmp_path / "bad.fastq"
    bad.write_text("@r1\nACGT\n+\nIIII\nno header here\nACGT\n+\nIIII\n")
    rdr = native_lib.NativeFastqReader(str(bad), 8, 64)
    with pytest.raises(ValueError, match="rc=-2"):
        rdr.next_batch()
    rdr.close()
    # without the library the reader raises OSError and iter_batches
    # takes the parser, with the same batches
    path = synthetic_fastq["gz"]
    want = list(fastq.iter_batches(path, 100, max_len=300))
    monkeypatch.setitem(native_lib._loaded, "nrfastq", None)
    with pytest.raises(OSError, match="unavailable"):
        native_lib.NativeFastqReader(path, 100, 300)
    _assert_same(list(fastq.iter_batches(path, 100, max_len=300)), want)
    # without max_len the parser runs, as in the JAX package
    calls = []
    monkeypatch.setattr(native_lib, "NativeFastqReader",
                        lambda *a: calls.append(a))
    assert len(list(fastq.iter_batches(path, 100))) == 3 and not calls


def test_aligner_library_keeps_its_digest_and_builds_without_zlib(
        tmp_path, monkeypatch):
    # the digest of the aligner and DP twin's library covers its two
    # sources and the flags, as before the reader was carried
    h = hashlib.sha256(" ".join(["-O3", "-shared", "-fPIC",
                                 "-pthread"]).encode())
    for f in ("banded_align.cpp", "whitelist_verify.cpp"):
        with open(os.path.join(REPO, "nanoranger_torch", "runtime",
                               "native", f), "rb") as fh:
            h.update(fh.read())
    assert native_lib._lib_path() == os.path.join(
        native_lib.BUILD_ROOT, f"host_{h.hexdigest()[:16]}",
        "libnrnative.so")
    assert os.path.dirname(native_lib._lib_path("nrfastq")) != \
        os.path.dirname(native_lib._lib_path())
    # a host where the reader cannot link (here: a missing library in
    # place of zlib) still builds the other one
    monkeypatch.setattr(native_lib, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setitem(native_lib.LIBS, "nrfastq",
                        (("fastq_reader.cpp",), ("-lnr_no_such_zlib",)))
    monkeypatch.setattr(native_lib, "_loaded", {})
    assert "nr_no_such_zlib" in native_lib.build("nrfastq")
    assert native_lib.load("nrfastq") is None
    assert native_lib.get_lib() is not None
    assert native_lib._lib_path().startswith(str(tmp_path))


def test_prewarmed_build_dir_is_used_as_is(tmp_path, monkeypatch):
    monkeypatch.setattr(native_lib, "BUILD_ROOT", str(tmp_path / "_build"))
    monkeypatch.setattr(kernels, "BUILD_ROOT", str(tmp_path / "_build"))
    monkeypatch.setattr(native_lib, "_loaded", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "nvcc_path", no_nvcc)
    compiles = []
    run = subprocess.run

    def counting_run(cmd, *a, **kw):
        compiles.append(cmd[0])
        return run(cmd, *a, **kw)

    monkeypatch.setattr(native_lib.subprocess, "run", counting_run)
    lines = []
    assert prewarm.prewarm(log=lines.append)
    first = [json.loads(x) for x in lines]
    assert first[0]["kind"] == "cuda" and "nvcc" in first[0]["skipped"]
    host = {d["library"]: d for d in first[1:]}
    assert set(host) == {"nrnative", "nrfastq"}
    assert all(d["built"] for d in host.values())
    assert compiles == ["g++", "g++"]
    paths = {n: native_lib._lib_path(n) for n in host}
    assert all(os.path.isfile(p) for p in paths.values())

    # a second prewarm and the first use of both libraries find them built
    lines.clear()
    assert prewarm.prewarm(log=lines.append)
    again = {d["library"]: d for d in map(json.loads, lines[1:])}
    assert not any(d["built"] for d in again.values())
    assert {n: d["path"] for n, d in again.items()} == \
        {n: d["path"] for n, d in host.items()}
    assert native_lib.get_lib() is not None
    assert native_lib.load("nrfastq") is not None
    assert compiles == ["g++", "g++"]
    assert {n: native_lib._lib_path(n) for n in host} == paths
