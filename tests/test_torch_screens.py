"""The port's whitelist screens (ops/seed_screen.py, ops/product_screen.py)
against the JAX package's jitted ones on the same inputs: the bucket
screen, the product screen and its wide-offset joint form give the same
candidates and counts in the same order (the JAX sort among equal joint
counts keeps the visit order, as the port's stable sort does), on a
synthetic 64 x 64 product list, on a sample of the 737K list and, for the
bucket screen, on the slideseq bead list; the SWAR bit count equals
lax.population_count, and plan_for equals the JAX one for every
chemistry with a barcode."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanoranger_tpu import chemistry as jax_chemistry
from nanoranger_tpu.ops import product_screen as jax_ps
from nanoranger_tpu.ops import seed_screen as jax_ss

from nanoranger_torch import chemistry
from nanoranger_torch.io import whitelist
from nanoranger_torch.io.encode import encode_batch
from nanoranger_torch.ops import product_screen as ps
from nanoranger_torch.ops import seed_screen as ss

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WL = os.path.join(REPO, "data", "737K-august-2016.txt.gz")
SS_WL = os.path.join(REPO, "data", "slideseq.matched.barcodes.tsv.gz")
ADAPTER = "CGCTCTTCCGATCT"


def test_popcount_equals_lax_population_count(rng):
    x = np.concatenate([
        np.array([0, 1, -1, 2**31 - 1, -2**31, 0x55555555, -0x55555556,
                  0x0F0F0F0F, 0x7FFF0000], np.int64),
        rng.integers(-2**31, 2**31, 5000)]).astype(np.int32)
    got = ss.popcount32(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.population_count(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    # the cheap verify's count, poisoned (-1) half keys included
    a = rng.integers(0, 4**8, 3000).astype(np.int32)
    b = np.where(rng.random(3000) < 0.2, -1,
                 rng.integers(0, 4**8, 3000)).astype(np.int32)
    for l in (6, 8):
        np.testing.assert_array_equal(
            ss._mm_count(torch.from_numpy(a), torch.from_numpy(b), l)
            .numpy(),
            np.asarray(jax_ss._mm_count(jnp.asarray(a), jnp.asarray(b), l)))


@pytest.mark.parametrize("mode", [m for m in jax_chemistry.names()
                                  if jax_chemistry.get(m).barcode])
def test_plan_for_equals_jax(mode):
    s, js = chemistry.get(mode).barcode, jax_chemistry.get(mode).barcode
    for jitter in (6, 2):
        got = ss.plan_for(s, s.bc_query_offset, jitter)
        want = jax_ss.plan_for(js, js.bc_query_offset, jitter)
        assert (got.bc_len, got.half_bounds, got.q_deltas, got.nominal,
                got.jitter) == (want.bc_len, want.half_bounds,
                                want.q_deltas, want.nominal, want.jitter)


def _product_list(rng, n1, n2):
    h1 = set()
    while len(h1) < n1:
        h1.add("".join(rng.choice(list("ACGT"), 8)))
    h2 = set()
    while len(h2) < n2:
        h2.add("".join(rng.choice(list("ACGT"), 8)))
    return np.asarray([a + b for a in sorted(h1) for b in sorted(h2)])


def _lists(rng, name):
    if name == "product64x64":
        return _product_list(rng, 64, 64), "5p10XGEX"
    if name == "737k_sample":
        bcs = whitelist.load(WL)
        return bcs[np.sort(rng.choice(len(bcs), 40000, replace=False))], \
            "5p10XGEX"
    return whitelist.load(SS_WL), "3pXCR_slideseq"


def _queries(rng, bcs, spec, n=160):
    """Candidates with the barcode at its nominal offset: exact, one
    substitution, deletion or insertion, with a random UMI; and random
    rows. Returns (q, qlen, the planted row of each exact plant of a
    barcode without N)."""
    seqs, exact = [], {}
    for i in range(n):
        pick = int(rng.integers(len(bcs)))
        b = list(bcs[pick])
        r = i % 5
        if r == 0 and "N" not in b:       # an N half seeds nothing
            exact[i] = pick
        elif r == 1:
            b[rng.integers(len(b))] = "ACGT"[rng.integers(4)]
        elif r == 2:
            del b[rng.integers(len(b))]
        elif r == 3:
            b.insert(rng.integers(len(b)), "ACGT"[rng.integers(4)])
        b = "".join(b)
        if spec.slideseq_linker:
            s = ("".join(rng.choice(list("ACGT"), spec.bc_query_offset))
                 + b[:8] + chemistry.SLIDESEQ_LINKER + b[8:])
        else:
            s = ADAPTER[:spec.bc_query_offset] + b
        s += "".join(rng.choice(list("ACGT"), 12)) + "TTTCTTATAT"
        seqs.append(s if r != 4 else "".join(rng.choice(list("ACGTN"),
                                                        len(s))))
    seqs += ["", "ACGT"]
    return (*encode_batch(seqs, max_len=96), exact)


def _recall(cand, exact):
    return np.mean([p in cand[i] for i, p in exact.items()])


def _bc_codes(bcs, spec):
    codes, _ = encode_batch(list(bcs), max_len=spec.bc_len)
    return codes


@pytest.mark.parametrize("name", ["product64x64", "737k_sample",
                                  "slideseq"])
def test_seed_screen_equals_jax(rng, name):
    bcs, mode = _lists(rng, name)
    spec = chemistry.get(mode).barcode
    plan = ss.plan_for(spec, spec.bc_query_offset)
    tab = ss.SeedTable(_bc_codes(bcs, spec), plan)
    arrs = [a[h] for h in (0, 1) for a in (tab.starts, tab.counts,
                                           tab.entries, tab.half_keys)]
    q, ql, exact = _queries(rng, bcs, spec)
    got = ss.screen(torch.from_numpy(q), torch.from_numpy(ql),
                    *map(torch.from_numpy, arrs), plan=plan,
                    maxocc=tab.maxocc)
    want = jax_ss.screen(jnp.asarray(q), jnp.asarray(ql),
                         *map(jnp.asarray, arrs),
                         plan=jax_ss.plan_for(jax_chemistry.get(mode).barcode,
                                              spec.bc_query_offset),
                         maxocc=tab.maxocc)
    for x, y in zip(got, want):
        assert x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # every exact plant is among its candidates
    assert _recall(got[0].numpy(), exact) == 1.0


@pytest.mark.parametrize("name", ["product64x64", "737k_sample"])
def test_product_screens_equal_jax(rng, name):
    bcs, mode = _lists(rng, name)
    spec = chemistry.get(mode).barcode
    plan = ss.plan_for(spec, spec.bc_query_offset)
    pt = ps.ProductTable.build(_bc_codes(bcs, spec), plan.half_bounds,
                               plan.q_deltas)
    q, ql, exact = _queries(rng, bcs, spec)
    tq, tql = torch.from_numpy(q), torch.from_numpy(ql)
    tarr = [torch.from_numpy(a) for a in (pt.planes1, pt.planes2, pt.pair)]
    jarr = [jnp.asarray(a) for a in (pt.planes1, pt.planes2, pt.pair)]
    kw = dict(nominal=plan.nominal, jitter=plan.jitter,
              q_delta2=pt.q_delta2, l1=pt.l1, l2=pt.l2)
    got = ps.product_screen(tq, tql, *tarr, **kw)
    want = jax_ps.product_screen(jnp.asarray(q), jnp.asarray(ql), *jarr,
                                 **kw)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert _recall(got[0].numpy(), exact) == 1.0
    kw = dict(lo=0, hi=96 - 16, q_delta2=pt.q_delta2, l1=pt.l1, l2=pt.l2)
    got = ps.product_screen_joint(tq, tql, *tarr, **kw)
    want = jax_ps.product_screen_joint(jnp.asarray(q), jnp.asarray(ql),
                                       *jarr, **kw)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    v = got[1].numpy()
    # equal joint counts inside the kept columns: the order among them is
    # the one both sorts keep
    assert (v[:, 1:] == v[:, :-1])[v[:, 1:] >= 0].any()
