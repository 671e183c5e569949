"""The JAX-free host modules the PyTorch port carries as its own copies
(chemistry, io, stages/counting) give what the JAX package's give; the
tagged-BAM writer and reader (io/bam.py) and the downstream readers of the
BAM (downstream/*) hold the same code as the JAX package's, and so do the
multi-host tools (tools/split_fastq.py, tools/merge_shards.py) but for
their import lines and the device the merge's pipeline tail runs on; the
fused step's host assembly (stages/cli_step.py: BatchAssembly,
assemble_batch and their tables) is the JAX package's code; the host twin
of the one-vs-all DP (runtime/native/whitelist_verify.cpp) is the JAX
package's source less its comments, and so is the native fastq reader
(runtime/native/fastq_reader.cpp); the host builds of the two whitelist
screens (ops/seed_screen.py, ops/product_screen.py) are the JAX package's
code."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.io import encode as jax_encode
from nanoranger_tpu.io import fasta as jax_fasta
from nanoranger_tpu.io import fastq as jax_fastq
from nanoranger_tpu.io import whitelist as jax_whitelist
from nanoranger_tpu.downstream import fusion_gene as jax_fusion_gene
from nanoranger_tpu.downstream import isoforms as jax_isoforms
from nanoranger_tpu.downstream import pileup as jax_pileup
from nanoranger_tpu.downstream import read_stats as jax_read_stats
from nanoranger_tpu.io import bam as jax_bam
from nanoranger_tpu.ops import product_screen as jax_product_screen
from nanoranger_tpu.ops import seed_screen as jax_seed_screen
from nanoranger_tpu.stages import cli_step as jax_cli_step
from nanoranger_tpu.stages import counting as jax_counting
from nanoranger_tpu.tools import merge_shards as jax_merge_shards
from nanoranger_tpu.tools import split_fastq as jax_split_fastq

from test_torch_vdj import _code_of

from nanoranger_torch import chemistry
from nanoranger_torch.downstream import (fusion_gene, isoforms, pileup,
                                         read_stats)
from nanoranger_torch.io import bam, encode, fasta, fastq, whitelist
from nanoranger_torch.io.candidate_store import CandidateStore
from nanoranger_torch.ops import product_screen, seed_screen
from nanoranger_torch.stages import cli_step, counting
from nanoranger_torch.tools import merge_shards, split_fastq

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
SAMPLE = os.path.join(DATA, "samples",
                      "K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1.fastq.gz")


@pytest.mark.parametrize("mode", jax_chemistry.names())
def test_chemistry_spec_equal_field_by_field(mode):
    assert chemistry.names() == jax_chemistry.names()
    got = dataclasses.asdict(chemistry.get(mode))
    want = dataclasses.asdict(jax_chemistry.get(mode))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def test_encode_batch_and_revcomp_equal(rng):
    seqs = ["".join(rng.choice(list("ACGTN"), int(rng.integers(0, 40))))
            for _ in range(30)]
    q, ql = encode.encode_batch(seqs, max_len=32)
    jq, jql = jax_encode.encode_batch(seqs, max_len=32)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(ql, jql)
    np.testing.assert_array_equal(encode.revcomp_batch_padded(q, ql),
                                  jax_encode.revcomp_batch_padded(jq, jql))
    assert [encode.decode(r) for r in q] == [jax_encode.decode(r) for r in jq]


def test_fasta_read_equal():
    path = os.path.join(DATA, "RUNX1_RUNX1T1_ABL1_BCR.fa")
    names, seqs = fasta.read_fasta_encoded(path)
    jnames, jseqs = jax_fasta.read_fasta_encoded(path)
    assert names == jnames
    for a, b in zip(seqs, jseqs):
        np.testing.assert_array_equal(a, b)


def test_fastq_batches_equal():
    got = list(fastq.iter_batches(SAMPLE, 700, max_len=4096))
    want = list(jax_fastq.iter_batches(SAMPLE, 700, max_len=4096))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.lengths, b.lengths)
        assert list(a.names) == list(b.names)
        assert list(a.quals) == list(b.quals)


def test_whitelist_load_and_padded_refs_equal():
    path = os.path.join(DATA, "737K-august-2016.txt.gz")
    bcs = whitelist.load(path)
    np.testing.assert_array_equal(bcs, jax_whitelist.load(path))
    assert len(bcs) == 737280
    spec = chemistry.get("5p10XGEX").barcode
    refs, ref_len = whitelist.padded_refs(bcs[:500], spec)
    jrefs, jref_len = jax_whitelist.padded_refs(
        bcs[:500], jax_chemistry.get("5p10XGEX").barcode)
    np.testing.assert_array_equal(refs, jrefs)
    assert ref_len == jref_len


def test_candidate_store_streams_in_order(tmp_path):
    names = [f"r{i}" for i in range(2500)]
    seqs = ["ACGT" * (i % 7) for i in range(2500)]
    store = CandidateStore.from_lists(names, seqs)
    got = [s for _, batch in store.iter_batches(1000) for s in batch]
    assert got == seqs
    assert store.names_list() == names
    assert store.head(3) == names[:3] and store.tail(2) == names[-2:]


def test_umi_dedup_table_equal(rng):
    bcs = np.array(["".join(rng.choice(list("ACGT"), 16)) for _ in range(5)])
    bc_rows = bcs[rng.integers(0, 5, 200)]
    umis = rng.integers(0, 4, size=(200, 10)).astype(np.int8)
    umis[::3] = umis[0]
    got = counting.umi_dedup_table(bc_rows, umis)
    want = jax_counting.umi_dedup_table(bc_rows, umis)
    assert got.equals(want)
    assert counting.barcode_scores_table(np.arange(30) % 17).equals(
        jax_counting.barcode_scores_table(np.arange(30) % 17))


@pytest.mark.parametrize("port,ref", [
    (bam, jax_bam), (fusion_gene, jax_fusion_gene), (isoforms, jax_isoforms),
    (pileup, jax_pileup), (read_stats, jax_read_stats)],
    ids=["bam", "fusion_gene", "isoforms", "pileup", "read_stats"])
def test_bam_and_downstream_copies_hold_the_same_code(port, ref):
    assert _code_of(port) == _code_of(ref)


class _ToolPlumbing(ast.NodeTransformer):
    """Takes out of a tool's syntax tree its import lines, and what the
    port adds to run the merge's pipeline tail on a chosen device: the
    `device` parameter, the `device=` keyword, the trailing `a.device`
    argument and the --device flag; the program's name reads as the JAX
    package's."""

    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import

    def visit_arguments(self, node):
        keep = [a for a in node.args if a.arg != "device"]
        node.defaults = node.defaults[:len(node.defaults)
                                      - (len(node.args) - len(keep))]
        node.args = keep
        return self.generic_visit(node)

    def visit_Call(self, node):
        node.keywords = [k for k in node.keywords if k.arg != "device"]
        node.args = [a for a in node.args
                     if not (isinstance(a, ast.Attribute)
                             and a.attr == "device")]
        return self.generic_visit(node)

    def visit_Expr(self, node):
        c = node.value
        if (isinstance(c, ast.Call) and c.args
                and isinstance(c.args[0], ast.Constant)
                and c.args[0].value == "--device"):
            return None
        return self.generic_visit(node)

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = node.value.replace("nanoranger-torch",
                                            "nanoranger-tpu")
        return node


def _tool_code(module):
    """The tool's syntax tree without docstrings, comments and plumbing."""
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body.pop(0)
    return ast.dump(_ToolPlumbing().visit(tree))


@pytest.mark.parametrize("port,ref", [
    (split_fastq, jax_split_fastq), (merge_shards, jax_merge_shards)],
    ids=["split_fastq", "merge_shards"])
def test_tools_copies_hold_the_same_code(port, ref):
    assert _tool_code(port) == _tool_code(ref)


def _top_level_code(module, name):
    """The syntax tree of one top-level class, function or assignment of
    `module`, without docstrings."""
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body
                if getattr(n, "name", None) == name
                or (isinstance(n, ast.Assign)
                    and any(getattr(t, "id", None) == name
                            for t in n.targets)))
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body.pop(0)
    return ast.dump(node)


@pytest.mark.parametrize("name", ["BatchAssembly", "assemble_batch",
                                  "_CODE_TO_ASCII", "_RC_TABLE"])
def test_fused_step_assembly_is_the_jax_code(name):
    assert _top_level_code(cli_step, name) == \
        _top_level_code(jax_cli_step, name)


def _cpp_code(path):
    """The C++ source without its comments and blank lines."""
    import re
    with open(path) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    return [ln.rstrip() for ln in text.splitlines() if ln.strip()]


def test_host_twin_of_the_verify_kernel_is_the_jax_source():
    rel = os.path.join("runtime", "native", "whitelist_verify.cpp")
    assert _cpp_code(os.path.join(REPO, "nanoranger_torch", rel)) == \
        _cpp_code(os.path.join(REPO, "nanoranger_tpu", rel))


def test_native_fastq_reader_is_the_jax_source():
    rel = os.path.join("runtime", "native", "fastq_reader.cpp")
    assert _cpp_code(os.path.join(REPO, "nanoranger_torch", rel)) == \
        _cpp_code(os.path.join(REPO, "nanoranger_tpu", rel))


@pytest.mark.parametrize("pair,name", [
    ((seed_screen, jax_seed_screen), n) for n in (
        "BUCKET_LIMIT", "SeedPlan", "plan_for", "_next_pow2", "SeedTable",
        "_pack_np")
] + [((product_screen, jax_product_screen), n) for n in (
    "PAIR_LIMIT", "ProductTable", "_pack", "_onehot_planes")],
    ids=lambda v: v if isinstance(v, str) else v[0].__name__.split(".")[-1])
def test_host_builds_of_the_screens_are_the_jax_code(pair, name):
    port, jax_mod = pair
    assert _top_level_code(port, name) == _top_level_code(jax_mod, name)
