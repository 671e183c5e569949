"""The tier lookups of the port's stages/barcode.py against the JAX
package's on accelerators: the port binary-searches the sorted core keys
where the JAX package probes cuckoo hash tables (built by its
build_cuckoo); the tier passes and the match give the same answers as the
probe and as the JAX search, on the full 737K list and on keys near
2^32 - 1 (the top bit of a uint32 key set)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.stages import barcode as jax_barcode

from nanoranger_torch import chemistry
from nanoranger_torch.io import whitelist
from nanoranger_torch.io.encode import encode_batch
from nanoranger_torch.stages import barcode
from nanoranger_torch.stages.barcode import N_TIERS, BarcodeMatcher, tier_hits

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WL = os.path.join(REPO, "data", "737K-august-2016.txt.gz")
ADAPTER = "CGCTCTTCCGATCT"
MODE = "5p10XGEX"


@pytest.fixture(scope="module")
def matcher():
    return BarcodeMatcher(whitelist.load(WL), chemistry.get(MODE).barcode,
                          "cpu")


def _queries(barcodes, rng, n=64):
    """Exact, 1-sub and 1-ins plants of whitelist rows (the queries of
    the JAX package's cuckoo test), rows with no structure, and empty and
    short rows."""
    seqs = []
    for i in range(n):
        bc = barcodes[rng.integers(0, len(barcodes))]
        u = "".join(rng.choice(list("ACGT"), 10))
        b = list(bc)
        if i % 3 == 1:
            b[5] = "A" if b[5] != "A" else "C"          # 1-sub
        if i % 3 == 2:
            b.insert(7, "G")                            # 1-ins
        seqs.append(ADAPTER + "".join(b) + u + "TTTCT")
    seqs += ["".join(rng.choice(list("ACGTN"), 50)) for _ in range(8)]
    seqs += ["", "ACGT", ADAPTER]
    return encode_batch(seqs, max_len=64)


def _jax_tables(t):
    """The JAX package's tier tables from the port's: the sorted keys as
    uint32 and the cuckoo tables its build_cuckoo makes of them."""
    ks = t["ex_keys"].numpy().astype(np.uint32)
    idx = t["ex_idx"].numpy().astype(np.int32)
    rks = t["rc_ex_keys"].numpy().astype(np.uint32)
    ck = jax_barcode.build_cuckoo(ks, idx)
    rck = jax_barcode.build_cuckoo(rks, np.zeros(len(rks), np.int32))
    return ks, idx, rks, ck, rck


def _equal_to_the_jax_probe(m, q_np, ql_np, classes):
    """The port's tier passes (both strands) equal the JAX ones through
    the probe and through the search. Returns the forward tier-m `any`."""
    s = m.spec
    t = m.tables
    ks, idx, rks, ck, rck = _jax_tables(t)
    q, ql = torch.from_numpy(q_np), torch.from_numpy(ql_np)
    jq, jql = jnp.asarray(q_np), jnp.asarray(ql_np)
    fwd = tier_hits(q, ql, t["ex_keys"], t["ex_idx"], s.bc_len, s.pad_left,
                    s.pad_right, classes=classes)
    for cuckoo in (tuple(jnp.asarray(a) for a in ck[:2]) + (ck[2],), None):
        want = jax_barcode.tier_hits(jq, jql, jnp.asarray(ks),
                                     jnp.asarray(idx), s.bc_len, s.pad_left,
                                     s.pad_right, classes=classes,
                                     cuckoo=cuckoo)
        for k in range(N_TIERS):
            for x, y in zip(fwd[k], want[k]):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    rc = tier_hits(q, ql, t["rc_ex_keys"], None, s.bc_len, s.pad_right,
                   s.pad_left, any_only=True, classes=classes)
    for cuckoo in (tuple(jnp.asarray(a) for a in rck[:2]) + (rck[2],), None):
        want = jax_barcode.tier_hits(
            jq, jql, jnp.asarray(rks), jnp.zeros(len(rks), jnp.int32),
            s.bc_len, s.pad_right, s.pad_left, any_only=True,
            classes=classes, cuckoo=cuckoo)
        for x, y in zip(rc, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    return fwd[0][0]


@pytest.mark.parametrize("classes", ["full", "exact"])
def test_search_equals_the_jax_probe_on_the_737k_list(matcher, rng,
                                                      classes):
    q, ql = _queries(matcher.barcodes, rng)
    hit = _equal_to_the_jax_probe(matcher, q, ql, classes)
    assert hit.any() and (~hit).any()


def test_search_equals_the_jax_probe_near_the_top_of_uint32(rng):
    """Barcodes whose 2-bit keys lie at or just below 2^32 - 1 (leading
    T's, the all-T row included): the port's int64 keys and its search
    give what the JAX package's uint32 keys and probe give, and its key
    tables are the JAX matcher's."""
    tail = ["".join(rng.choice(list("ACGT"), 10)) for _ in range(3000)]
    bcs = sorted({"TTTTTT" + t for t in tail} | {
        "T" * 16, "T" * 15 + "G", "T" * 15 + "C", "T" * 14 + "GT",
        "G" + "T" * 15})
    m = BarcodeMatcher(bcs, chemistry.get(MODE).barcode, "cpu")
    assert int(m.tables["ex_keys"][-1]) == (1 << 32) - 1
    jm = jax_barcode.BarcodeMatcher(bcs, jax_chemistry.get(MODE).barcode)
    for got, want in zip((m.tables["ex_keys"], m.tables["ex_idx"],
                          m.tables["rc_ex_keys"]), jm._ex_np):
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    q, ql = _queries(bcs[-40:] + bcs[:40], rng, n=96)
    for classes in ("full", "exact"):
        hit = _equal_to_the_jax_probe(m, q, ql, classes)
        assert int(hit.sum()) >= 30


@pytest.mark.parametrize("dp", [True, False])
def test_match_equals_the_jax_match_through_the_probe(rng, dp):
    """match_device_with (the in-step match and the fused step's
    exact-class pass) on the port's sorted tables against the jitted JAX
    one on tables that carry the cuckoo keys, as JAX's device_tables()
    gives them on an accelerator; reverse-complemented plants reach the
    rc tables. (20,000 rows of the list keep the exhaustive DP of the
    unstructured rows short.)"""
    bcs = whitelist.load(WL)[:20000]
    m = BarcodeMatcher(bcs, chemistry.get(MODE).barcode, "cpu")
    jm = jax_barcode.BarcodeMatcher(bcs, jax_chemistry.get(MODE).barcode)
    q_np, ql_np = _queries(bcs, rng)
    rc = barcode.revcomp_rows(torch.from_numpy(q_np[:8]),
                              torch.from_numpy(ql_np[:8])).numpy()
    q_np = np.concatenate([q_np, rc])
    ql_np = np.concatenate([ql_np, ql_np[:8]])
    t = jm.device_tables()
    assert "ck_tk" not in t
    _, _, _, ck, rck = _jax_tables(m.tables)
    t["ck_tk"], t["ck_tv"], jm._ck_log2 = (jnp.asarray(ck[0]),
                                           jnp.asarray(ck[1]), ck[2])
    t["rc_ck_tk"], t["rc_ck_tv"], jm._rc_ck_log2 = (
        jnp.asarray(rck[0]), jnp.asarray(rck[1]), rck[2])
    want = jax.jit(lambda q, ql, t: jm.match_device_with(q, ql, t, dp=dp))(
        jnp.asarray(q_np), jnp.asarray(ql_np), t)
    got = m.match_device_with(torch.from_numpy(q_np), torch.from_numpy(ql_np),
                              m.device_tables(), dp=dp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    status = got[2].numpy()
    assert (status == barcode.ACCEPT).sum() >= (40 if dp else 20)
    if dp:
        assert (status == barcode.RC_BEST).sum() >= 1
