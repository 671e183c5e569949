"""The plain genome stage (reference/splice.py) equals the program's genome
stage on real K562 subreads, on the CPU, and is the copy of
tests/plain_genome.py that the program's own tests hold.

The subreads are those the program's decon cuts from a K562 prefix (until
300), aligned by pipeline.genome_stage to the fusion partners'
transcripts; every record must be the plain one, field for field, and
consistent with the genome."""

import os

import numpy as np
import pytest
import torch

import harness
from reference import splice

ROOT = harness.ROOT
DATA = os.path.join(ROOT, "data")
FUSION = os.path.join(DATA, "RUNX1_RUNX1T1_ABL1_BCR.fa")
K562 = os.path.join(DATA, "samples",
                    "K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1.fastq.gz")


def test_the_copy_is_the_tests_reference():
    with open(os.path.join(ROOT, "tests", "plain_genome.py")) as f:
        theirs = f.read()
    with open(splice.__file__) as f:
        assert f.read() == theirs


@pytest.fixture(scope="module")
def k562_subreads(tmp_path_factory):
    """A directory holding s_deconcat.fastq.gz: the first 300 subreads the
    program's decon cuts from the K562 sample, and their transcripts."""
    import gzip

    from nanoranger_torch import chemistry, pipeline
    from nanoranger_torch.io import fastq
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("k562")
    with gzip.open(K562, "rt") as f:
        lines = f.read().split("\n")[:4 * 440]
    fq = str(tmp / "in.fastq.gz")
    with gzip.open(fq, "wt") as g:
        g.write("\n".join(lines) + "\n")
    run = pipeline.DeconRun(chemistry.get("5p10XGEX"), fq, str(tmp / "d"),
                            "s", FUSION, "cpu", 512)
    trns = dict(zip(run.cands.names_list(), run.transcripts()))
    out = tmp / "g"
    out.mkdir()
    keep = []
    for b in fastq.iter_batches(run.sub_path, 512):
        for i, n in enumerate(b.names):
            if n in trns and len(keep) < 300:
                keep.append((n, b.codes[i, :b.lengths[i]]))
    assert len(keep) == 300
    with gzip.open(out / "s_deconcat.fastq.gz", "wt") as g:
        for n, c in keep:
            s = "".join("ACGTN"[x] for x in c)
            g.write(f"@{n}\n{s}\n+\n{'I' * len(s)}\n")
    return str(out), {n: trns[n] for n, _ in keep}


def test_plain_genome_stage_equals_the_program(k562_subreads):
    from nanoranger_torch import chemistry, pipeline, trace
    from nanoranger_torch.io import bam, fastq
    out, trns = k562_subreads
    tag_map = {n: (f"CB{i}", f"UB{i}", t)
               for i, (n, t) in enumerate(trns.items())}
    with trace.run() as tr:
        pipeline.genome_stage(chemistry.get("5p10XGEX"), out, "s", FUSION,
                              tag_map, "cpu", force=True)
    _, _, it = bam.read_bam(os.path.join(out, "s_genome_tagged.bam"))
    got = {r.name: r for r in it}

    reads, widths, names = [], [], []
    for b in fastq.iter_batches(os.path.join(out, "s_deconcat.fastq.gz"),
                                512, max_len=4096):
        for i, n in enumerate(b.names):
            reads.append(b.codes[i, :b.lengths[i]].astype(np.int8))
            widths.append(b.codes.shape[1])
            names.append(n)
    genome = splice.Genome.from_fasta(FUSION)
    tags = [dict(zip(("CB", "UB", "XT"), tag_map[n])) for n in names]
    want = {n: r for n, r in zip(names, splice.genome_records(
        genome, reads, widths, tags)) if r is not None}
    assert sorted(got) == sorted(want) and len(got) > 250
    for name, r in got.items():
        w = want[name]
        seq = splice.encode(r.seq.encode())
        assert (r.ref_id, r.pos, r.flag, r.cigar, r.tags) == \
            (w["ref"], w["pos"], w["flag"], w["cigar"], w["tags"]), name
        assert np.array_equal(seq, w["seq"]), name
        assert splice.cigar_fault({"pos": r.pos, "cigar": r.cigar,
                                   "tags": r.tags}, seq,
                                  genome.codes[r.ref_id]) == "", name
    c = tr.counters
    assert c["genome.records"] == len(got), c
    assert c["genome.spliced_records"] > 0, c
