"""The clonotyper of the PyTorch port.

The JAX-free modules it carries as copies (vdj/cdr3.py, vdj/clonotype.py,
stages/clones.py) hold the same code as the JAX package's and give the
same results; the host banded aligner (runtime/native_lib.py) equals the
JAX package's build of the same source and its own numpy twin; and
vdj/caller.call_clonotypes, which aligns to the V panel on the port's
device, writes the same clone exports as the JAX caller on the subreads of
a TCR3 prefix. Tables and strings must be equal; nothing here is a
float."""

import ast
import gzip
import os
import re

import numpy as np
import pytest
import torch

from nanoranger_tpu.io.encode import encode
from nanoranger_tpu.runtime import native_lib as jax_native
from nanoranger_tpu.stages import clones as jax_clones
from nanoranger_tpu.vdj import call_clonotypes as jax_call_clonotypes
from nanoranger_tpu.vdj import cdr3 as jax_cdr3
from nanoranger_tpu.vdj import clonotype as jax_clonotype

from nanoranger_torch import chemistry, trace
from nanoranger_torch.io.fasta import read_fasta_encoded
from nanoranger_torch.pipeline import DeconRun
from nanoranger_torch.runtime import native_lib
from nanoranger_torch.stages import clones
from nanoranger_torch.vdj import call_clonotypes, cdr3, clonotype

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
V_PANEL = os.path.join(DATA, "TR_V_human.fa")


def _code_of(module):
    """The module's syntax tree without its docstrings and comments."""
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body.pop(0)
    return ast.dump(tree)


@pytest.mark.parametrize("port,ref", [(cdr3, jax_cdr3),
                                      (clonotype, jax_clonotype),
                                      (clones, jax_clones)],
                         ids=["cdr3", "clonotype", "clones"])
def test_copies_hold_the_same_code(port, ref):
    assert _code_of(port) == _code_of(ref)


def test_cdr3_primitives_equal(rng):
    _, seqs = read_fasta_encoded(V_PANEL)
    for v in seqs[:40]:
        assert cdr3.v_cys_position(v) == jax_cdr3.v_cys_position(v)
    for _ in range(30):
        read = rng.integers(0, 5, int(rng.integers(60, 300))).astype(np.int8)
        assert cdr3.translate(read) == jax_cdr3.translate(read)
        at = int(rng.integers(0, 40))
        assert cdr3.extract_cdr3(read, at) == jax_cdr3.extract_cdr3(read, at)
    for cig, t in (("10=", 4), ("3=2I5=", 6), ("3=2D5=", 6), ("5=", 9)):
        assert cdr3.cigar_map_t_to_q(cig, t) == \
            jax_cdr3.cigar_map_t_to_q(cig, t)
    for nm in ("TRBV1-1|x", "TRAV3", "IGHV1", "IGKV2", "junk"):
        assert cdr3.chain_of(nm) == jax_cdr3.chain_of(nm)


def test_assemble_and_lev_batch_equal(rng):
    a = ["".join(rng.choice(list("ACGT"), int(rng.integers(0, 30))))
         for _ in range(40)]
    b = ["".join(rng.choice(list("ACGT"), int(rng.integers(1, 30))))
         for _ in range(40)]
    np.testing.assert_array_equal(clonotype.lev_batch(a, b),
                                  jax_clonotype.lev_batch(a, b))
    parents = ["TGT" + "".join(rng.choice(list("ACGT"), 30)) + "TTT"
               for _ in range(4)]

    def calls_of(mod):
        out = []
        for i in range(60):
            nt = parents[i % 4]
            clean = i % 7 != 0
            if i % 5 == 0:
                nt = nt[:7] + "A" + nt[8:]
            if not clean:
                nt = nt[:10] + nt[11:]
            out.append(mod.ReadCall(
                f"r{i}", ["TRBV1-1|x", "TRAV2|y"][i % 2], 90 + i % 5,
                ["TRB", "TRA"][i % 2], nt, "CXXF" + ("" if clean else "_"),
                clean))
        return out

    got = clonotype.assemble(calls_of(clonotype))
    want = jax_clonotype.assemble(calls_of(jax_clonotype))
    assert len(want[0]) >= 2
    for g, w in zip(got, want):
        assert g.equals(w)


def _segments(rng, n):
    qs, ts = [], []
    for _ in range(n):
        q = rng.integers(0, 4, int(rng.integers(20, 120))).astype(np.int8)
        t = list(q)
        for _ in range(int(rng.integers(0, 6))):
            op = rng.integers(0, 3)
            p = int(rng.integers(0, len(t)))
            if op == 0:
                t[p] = (t[p] + 1) % 4
            elif op == 1 and len(t) > 10:
                del t[p]
            else:
                t.insert(p, int(rng.integers(0, 4)))
        qs.append(q)
        ts.append(np.asarray(t, np.int8))
    return qs, ts


def test_banded_align_builds_and_equals_the_jax_packages(rng):
    assert native_lib.get_lib() is not None, "g++ build failed"
    assert os.sep + "_build" + os.sep in native_lib._lib_path()
    qs, ts = _segments(rng, 24)
    got = native_lib.banded_align_batch(qs, ts, band=48)
    want = jax_native.banded_align_batch(qs, ts, band=48)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert native_lib.banded_align_batch([], [])[0] == []
    q = encode("ACGTTCGTAC")
    assert native_lib.banded_align_batch([q], [encode("ACGTACGTAC")])[0] == \
        ["4=1X5="]


def test_banded_align_cpp_equals_numpy_twin(rng):
    qs, ts = _segments(rng, 6)
    cig_c, sc_c, nm_c = native_lib.banded_align_batch(qs, ts, band=32)
    cig_n, sc_n, nm_n = native_lib._banded_align_numpy(qs, ts, 32)
    np.testing.assert_array_equal(sc_c, sc_n)

    def consume(cig):
        ql = rl = 0
        for n, op in re.findall(r"(\d+)([=XID])", cig):
            ql += int(n) if op in "=XI" else 0
            rl += int(n) if op in "=XD" else 0
        return ql, rl

    for q, t, c, n in zip(qs, ts, cig_c, cig_n):
        assert consume(c) == consume(n) == (len(q), len(t))


def test_call_clonotypes_equals_jax_on_tcr3_subreads(tmp_path):
    """Subreads of a TCR3 prefix (the port's own decon): V-aligned and
    name-hinted reads, partial junctions, C-region assignment."""
    with gzip.open(os.path.join(DATA, "samples", "TCR3.fastq.gz"), "rt") as f:
        lines = [next(f) for _ in range(4 * 150)]
    fq = str(tmp_path / "prefix.fastq.gz")
    with gzip.open(fq, "wt") as g:
        g.writelines(lines)
    run = DeconRun(chemistry.get("5p10XTCR"), fq, str(tmp_path), "s",
                   V_PANEL, "cpu")
    assert run.n_sub > 100
    c_fastas = [os.path.join(DATA, "TR_C_human.fa"),
                os.path.join(DATA, "IG_C_human.fa")]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = jax_call_clonotypes(run.sub_path, [V_PANEL], str(tmp_path / "jax"),
                               "s", c_fastas=c_fastas, log=lambda *_: None)
    logs = []
    with trace.run() as tr:
        got = call_clonotypes(run.sub_path, [V_PANEL],
                              str(tmp_path / "torch"), "s",
                              c_fastas=c_fastas, log=logs.append,
                              device="cpu")
    assert len(want[0]) >= 3 and len(want[1]) >= 10
    for g, w in zip(got, want):
        assert g.equals(w)
    for name in ("s_clones.txt.gz", "s_cloneID.txt.gz"):
        with gzip.open(tmp_path / "torch" / name, "rb") as a, \
                gzip.open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read()
    assert "V-aligned" in logs[0]
    # the counters are the tallies the call's log line prints
    tallies = re.match(r"native clonotyper: (\d+) subreads → (\d+) "
                       r"V-aligned \+ (\d+) name-hinted, (\d+) CDR3 calls "
                       r"\(\+(\d+) partial junctions, \d+ merged into "
                       r"clones\), (\d+) clones", logs[0])
    keys = ("vdj.subreads", "vdj.v_aligned", "vdj.name_hinted", "vdj.calls",
            "vdj.partial", "vdj.clones")
    assert {k: tr.counters[k] for k in keys} == \
        dict(zip(keys, map(int, tallies.groups())))
    assert tr.counters["vdj.subreads"] == run.n_sub
    assert tr.counters["vdj.clones"] == len(got[0])
    assert tr.counters["vdj.name_hinted"] > 0
