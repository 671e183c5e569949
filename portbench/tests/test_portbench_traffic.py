"""The seeded sample files of the one traffic generator."""

import collections
import gzip

import traffic

SRC = [(f"r{i}", b"ACGT" * (i % 7 + 1) + b"A" * (300 * (i % 5)),
        b"I" * (4 * (i % 7 + 1) + 300 * (i % 5))) for i in range(40)]


def _read(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def test_same_seed_same_samples_other_seed_same_work(tmp_path):
    wl = {"sample": "x", "reads_per_sample": 100, "pool": 2,
          "warmup_per_bucket": [3, 2, 1, 1]}
    seed = 2 ** 31 + 17                     # larger than 32 signed bits
    a = traffic.tiled_reads(SRC, 100, traffic.seed_rng(seed, 1))
    b = traffic.tiled_reads(SRC, 100, traffic.seed_rng(seed, 1))
    c = traffic.tiled_reads(SRC, 100, traffic.seed_rng(seed + 1, 1))
    assert a == b and a != c
    # the same reads and lengths in another order and orientation
    strip = lambda rs: collections.Counter((n, len(s)) for n, s, _ in rs)
    assert strip(a) == strip(c)
    assert {n.split("_")[0] for n, _, _ in a} == {"t0", "t1", "t2"}
    flipped = sum(s != dict((f"t{k}_{n}", q) for k in range(3)
                            for n, q, _ in SRC)[nm] for nm, s, _ in a)
    assert 20 < flipped < 80
    # files: the same bytes once inflated, whatever gzip's header says
    src = tmp_path / "src.fastq.gz"
    traffic.write_fastq(SRC, str(src))
    wl["sample"] = "src.fastq.gz"
    p1, r1 = traffic.make_samples(str(tmp_path), wl, seed,
                                  str(tmp_path / "a"))
    p2, r2 = traffic.make_samples(str(tmp_path), wl, seed,
                                  str(tmp_path / "b"))
    assert [_read(p) for p in p1["pool"]] == [_read(p) for p in p2["pool"]]
    assert _read(p1["warmup"]) == _read(p2["warmup"])
    assert len(traffic.read_fastq(p1["pool"][0])) == 100
    assert r1[p1["pool"][1]] == traffic.read_fastq(p1["pool"][1])


def test_a_sample_of_the_source_keeps_its_names():
    a = traffic.tiled_reads(SRC, 40, traffic.seed_rng(5, 1))
    assert sorted(n for n, _, _ in a) == sorted(n for n, _, _ in SRC)


def test_warmup_reaches_every_bucket():
    src = [(f"r{i}", b"A" * L, b"I" * L)
           for i, L in enumerate([500] * 9 + [1500] * 5 + [3000] * 4 +
                                 [6000] * 3)]
    w = traffic.warmup_reads(src, [4, 3, 2, 1], traffic.seed_rng(9, 0))
    lens = sorted(len(s) for _, s, _ in w)
    assert lens == [500] * 4 + [1500] * 3 + [3000] * 2 + [6000]
    assert all(n.startswith("w_") for n, _, _ in w)


def test_reverse_complement():
    assert traffic.revcomp(b"AACGTN") == b"NACGTT"
