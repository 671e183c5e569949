"""The genome stage of the PyTorch port on fusion genotyping (5p10XGEX with
the fusion partners' transcripts as the genome), against the plain genome
stage of tests/plain_genome.py, on the CPU; no JAX.

- genome_stage on seeded synthetic spliced reads (short exons, junctions
  with microhomology, so that exon blocks overlap) and on reads fused
  across two references gives, record for record, the plain reference's
  position, flag, CIGAR, NM, AS and tags, and every record is consistent
  (its CIGAR spans its SEQ, = and X agree with the genome, NM counts its
  edits);
- the two subreads whose records overlapping blocks once broke (1026 on
  MT_chr.fa, K562 on the fusion transcripts) give consistent records;
- reads renamed with '_' in their names (PacBio's m64012_190920_173625/
  <n>/ccs) give the artifacts of the same reads under their own names,
  names aside: XT and the 3p10XGEX count matrix come from the decon
  records, not from the names;
- the genome stage's span genome.exons and its counters are in the run
  statistics.
"""

import gzip
import json
import os
import sys

import numpy as np
import pytest
import torch

from nanoranger_torch import chemistry, pipeline, trace
from nanoranger_torch.io import bam, fastq, whitelist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import plain_genome  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
FUSION = os.path.join(DATA, "RUNX1_RUNX1T1_ABL1_BCR.fa")
K562 = os.path.join(DATA, "samples",
                    "K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1.fastq.gz")
COMP = str.maketrans("ACGT", "TGCA")
SPEC = chemistry.get("5p10XGEX")


def _rc(s: str) -> str:
    return s.translate(COMP)[::-1]


def _write_fastq(path, reads):
    with gzip.open(path, "wt") as g:
        g.writelines(f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads)


def _genome_stage(outdir, genome, names_trns):
    """genome_stage over {outdir}/s_deconcat.fastq.gz inside a traced run:
    (records by name, the run's counters)."""
    tag_map = {n: (f"CB{i:04d}", f"UB{i:04d}", t)
               for i, (n, t) in enumerate(names_trns.items())}
    with trace.run() as tr:
        pipeline.genome_stage(SPEC, outdir, "s", genome, tag_map, "cpu",
                              force=True)
    _, _, it = bam.read_bam(os.path.join(outdir, "s_genome_tagged.bam"))
    return {r.name: r for r in it}, tr.counters, tag_map


def _plain_records(outdir, genome, tag_map):
    """The plain reference's record of every subread of the deconcat
    fastq, at the batch width the stage's reader gives it."""
    reads, widths, names = [], [], []
    for b in fastq.iter_batches(os.path.join(outdir, "s_deconcat.fastq.gz"),
                                512, max_len=4096):
        for i, n in enumerate(b.names):
            reads.append(b.codes[i, :b.lengths[i]].astype(np.int8))
            widths.append(b.codes.shape[1])
            names.append(n)
    tags = [dict(zip(("CB", "UB", "XT"), tag_map[n])) for n in names]
    recs = plain_genome.genome_records(genome, reads, widths, tags)
    return {n: r for n, r in zip(names, recs) if r is not None}


def _assert_equal_and_consistent(got, want, genome):
    assert sorted(got) == sorted(want)
    for name, r in got.items():
        w = want[name]
        seq = plain_genome.encode(r.seq.encode())
        assert (r.ref_id, r.pos, r.flag, r.cigar, r.tags) == \
            (w["ref"], w["pos"], w["flag"], w["cigar"], w["tags"]), name
        assert np.array_equal(seq, w["seq"]), name
        rec = {"pos": r.pos, "cigar": r.cigar, "tags": r.tags}
        assert plain_genome.cigar_fault(
            rec, seq, genome.codes[r.ref_id]) == "", name


# --------------------------------------------------------------------------
# synthetic spliced and fused reads

def _synthetic(tmp_path, n_reads=36):
    """A 3-reference genome of one gene each (exons of 40-200 bases,
    introns of 600-1,500 whose last 12 bases repeat the exon before them),
    and reads spliced from one gene or fused across two, with a few
    substitutions and indels, written as {tmp_path}/s_deconcat.fastq.gz.
    Returns (genome path, {name: transcript})."""
    rng = np.random.default_rng(20261018)
    bases = np.array(list("ACGT"))
    genes = []
    fa = []
    for g in range(3):
        parts, exons = [], []
        parts.append("".join(rng.choice(bases, 200)))
        for e in range(6):
            ex = "".join(rng.choice(bases, int(rng.choice(
                [40, 48, 55, 62, 80, 120, 200]))))
            exons.append(ex)
            parts.append(ex)
            intr = "".join(rng.choice(bases, int(rng.integers(600, 1500))))
            intr = intr[:-12] + ex[-12:]              # junction microhomology
            parts.append(intr)
        fa.append((f"gene{g}_ref", "".join(parts)))
        genes.append(exons)
    genome = str(tmp_path / "genome.fa")
    with open(genome, "w") as f:
        f.writelines(f">{n} synthetic\n{s}\n" for n, s in fa)

    def noisy(s):
        s = list(s)
        for _ in range(int(rng.integers(0, 4))):
            k = int(rng.integers(1, len(s) - 1))
            op = int(rng.integers(0, 3))
            if op == 0:
                s[k] = str(rng.choice(bases))
            elif op == 1:
                s.insert(k, str(rng.choice(bases)))
            else:
                del s[k]
        return "".join(s)

    reads, trns = [], {}
    for i in range(n_reads):
        g = i % 3
        if i % 4 == 3:                               # fused: g then g + 1
            h = (g + 1) % 3
            seq = "".join(genes[g][:3]) + "".join(genes[h][3:])
        else:
            keep = sorted(rng.choice(6, int(rng.integers(3, 7)),
                                     replace=False))
            seq = "".join(genes[g][k] for k in keep)
        seq = noisy(seq)
        if i % 2:
            seq = _rc(seq)
        name = f"m64012_190920_173625/{i}/ccs_0_{len(seq)}_0_gene{g}_tx"
        reads.append((name, seq))
        trns[name] = f"gene{g}_tx"
    _write_fastq(str(tmp_path / "s_deconcat.fastq.gz"), reads)
    return genome, trns


def test_genome_stage_equals_the_plain_reference(tmp_path):
    genome_path, trns = _synthetic(tmp_path)
    got, counters, tag_map = _genome_stage(str(tmp_path), genome_path, trns)
    genome = plain_genome.Genome.from_fasta(genome_path)
    want = _plain_records(str(tmp_path), genome, tag_map)
    _assert_equal_and_consistent(got, want, genome)
    assert counters["genome.records"] == len(got) >= 30
    assert counters["genome.blocks_trimmed"] > 0
    assert counters["genome.blocks"] > counters["genome.records"]
    assert counters["genome.spliced_records"] == sum(
        any(op == "N" for _, op in r.cigar) for r in got.values()) > 20
    assert counters["genome.partner_reads"] > 0


# --------------------------------------------------------------------------
# the two records overlapping blocks once broke

@pytest.mark.parametrize("sample,read,span,strand,genome,xt", [
    ("1026_mtDNA_ASXL1_NRAS_SF3B1", "e44a9610-f308-44e0-ab5c-fb7ade78f9e8",
     (110, 334), 0, "MT_chr.fa", "MT-CO3"),
    ("K562_Kasumi1_BCRABL1_RUNX1_RUNX1T1",
     "ee821b7a-430c-4073-aa32-0a2db9f3306d", (3482, 4006), 1,
     "RUNX1_RUNX1T1_ABL1_BCR.fa", "RUNX1-216|ENST00000482318.5_1710")],
    ids=["1026", "K562"])
def test_named_records_are_consistent(tmp_path, sample, read, span, strand,
                                      genome, xt):
    with gzip.open(os.path.join(DATA, "samples", f"{sample}.fastq.gz"),
                   "rt") as f:
        lines = f.read().split("\n")
    seq = next(lines[k + 1] for k in range(0, len(lines) - 3, 4)
               if lines[k][1:].split()[0] == read)
    sub = seq[span[0]:span[1]]
    name = f"{read}_{span[0]}_{span[1]}_{2064 if strand else 0}_{xt}"
    _write_fastq(str(tmp_path / "s_deconcat.fastq.gz"),
                 [(name, _rc(sub) if strand else sub)])
    gpath = os.path.join(DATA, genome)
    got, counters, tag_map = _genome_stage(str(tmp_path), gpath, {name: xt})
    g = plain_genome.Genome.from_fasta(gpath)
    _assert_equal_and_consistent(got, _plain_records(str(tmp_path), g,
                                                     tag_map), g)
    assert counters["genome.blocks_trimmed"] + \
        counters["genome.blocks_dropped"] > 0


# --------------------------------------------------------------------------
# renamed reads

def _small_whitelist(path, seqs, n_random=200):
    full = whitelist.load(os.path.join(DATA, "737K-august-2016.txt.gz"))
    known = set(full.tolist())
    rows = {s[i:i + 16] for seq in seqs for s in (seq[:200], _rc(seq)[:200])
            for i in range(len(s) - 15) if s[i:i + 16] in known}
    rng = np.random.default_rng(7)
    rows |= set(full[rng.choice(len(full), n_random, replace=False)].tolist())
    with open(path, "w") as f:
        f.write("\n".join(sorted(rows)) + "\n")


def _renamed_pair(tmp_path, mode, reads, pacbio_name, **kw):
    """Run the same reads under their own names and under PacBio names
    holding '_'; returns both outdirs and {renamed name + '_': own name +
    '_'}, the prefix of every output name."""
    rename = {n: pacbio_name(i) for i, (n, _) in enumerate(reads)}
    out = {}
    for tag, rd in (("own", reads),
                    ("renamed", [(rename[n], s) for n, s in reads])):
        fq = str(tmp_path / f"{tag}.fastq.gz")
        _write_fastq(fq, rd)
        out[tag] = str(tmp_path / tag)
        pipeline.run_pipeline(mode, fq, out[tag], "t", device="cpu", **kw)
    return out, {f"{new}_": f"{old}_" for old, new in rename.items()}


def _own_name(name, back):
    head = next(n for n in back if name.startswith(n))
    return back[head] + name[len(head):]


def _text(path, rename=None):
    with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
        s = f.read()
    for new, old in (rename or {}).items():
        s = s.replace(new, old)
    return s


@pytest.fixture(scope="module")
def gex5p(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("renamed5p")
    with gzip.open(K562, "rt") as f:
        lines = f.read().split("\n")[:4 * 40]
    reads = [(lines[k][1:].split()[0], lines[k + 1])
             for k in range(0, len(lines), 4)]
    wl = str(tmp / "wl.txt")
    _small_whitelist(wl, [s for _, s in reads])
    return _renamed_pair(
        tmp, "5p10XGEX", reads, lambda i: f"m64012_190920_173625/{i}/ccs",
        trns_ref=FUSION, genome_ref=FUSION, barcodes=wl)


def test_renamed_reads_give_the_same_5p_artifacts(gex5p):
    out, back = gex5p
    for f in ("t_deconcat.fastq.gz", "t_BCUMI.fasta.gz",
              "t_assignments.csv.gz", "t_bcumi_dedup.csv", "t_trns_ct.csv"):
        assert _text(os.path.join(out["renamed"], f), back) == \
            _text(os.path.join(out["own"], f)), f
    recs = {}
    for tag in out:
        _, _, it = bam.read_bam(os.path.join(out[tag],
                                             "t_genome_tagged.bam"))
        recs[tag] = [(r.name, r.flag, r.ref_id, r.pos, r.cigar, r.seq,
                      r.tags) for r in it]
    own = recs["own"]
    assert [(_own_name(r[0], back), *r[1:]) for r in recs["renamed"]] == \
        own and len(own) >= 20
    for name, *_, tags in own:
        assert name.endswith("_" + tags["XT"]), name


def test_genome_stage_spans_and_counters_in_runstats(gex5p):
    out, _ = gex5p
    with open(os.path.join(out["renamed"], "t_runstats.json")) as f:
        rs = json.load(f)
    c, tot, spans = rs["counters"], rs["span_totals"], rs["spans"]
    row = rs["stages"][-1]
    assert row["stage"] == "genome_tag"
    assert c["genome.records"] == row["records"] > 0
    assert c["genome.blocks"] >= c["genome.records"]
    for k in ("genome.blocks_trimmed", "genome.blocks_dropped",
              "genome.spliced_records", "genome.partner_reads"):
        assert 0 <= c[k] <= c["genome.blocks"], k
    assert tot["genome.exons"]["n"] == tot["genome.align"]["n"] >= 1
    for name, _, _, parent in spans:
        if name == "genome.exons":
            assert spans[parent][0] == "genome.align"


def test_a_resumed_genome_stage_finds_xt_in_the_names(gex5p, tmp_path):
    """Resumed from its decon artifacts a run has no decon records: XT is
    then the longest panel name that ends each name after its flag."""
    import shutil
    out, _ = gex5p
    d = str(tmp_path / "resumed")
    shutil.copytree(out["renamed"], d)
    for f in ("t_genome_tagged.bam", "t_genome_tagged.bam.bai",
              "t_trns_ct.csv"):
        os.remove(os.path.join(d, f))
    pipeline.run_pipeline("5p10XGEX", str(tmp_path / "none.fastq.gz"), d,
                          "t", trns_ref=FUSION, genome_ref=FUSION,
                          barcodes=os.path.join(out["renamed"], "..",
                                                "wl.txt"), device="cpu")
    for f in ("t_genome_tagged.bam", "t_trns_ct.csv"):
        with open(os.path.join(d, f), "rb") as a, \
                open(os.path.join(out["renamed"], f), "rb") as b:
            assert a.read() == b.read(), f


def _synthetic_3pgex(n_reads=60):
    """3' reads: transcript + 4 nt + rc(UMI) + rc(barcode) + TruSeq + junk,
    over a two-gene panel whose names hold '|' and '_', 30 reads a barcode
    (the data-driven whitelist keeps barcodes seen more than 20 times)."""
    rng = np.random.default_rng(3)
    seqs = {g: "".join(rng.choice(list("ACGT"), n))
            for g, n in (("GENE1_x", 900), ("ENSG2|ENST2|GENE2_y", 700))}
    bcs = ["".join(rng.choice(list("ACGT"), 16)) for _ in range(2)]
    reads = []
    for i in range(n_reads):
        umi = "".join(rng.choice(list("ACGT"), 12))
        tr = list(seqs.values())[i % 2][50:650]
        read = (tr + "ACGC" + _rc(umi) + _rc(bcs[i // 2 % 2])
                + chemistry.TRUSEQ
                + "".join(rng.choice(list("ACGT"), 25)))
        reads.append((f"m64012/{i}/ccs", _rc(read) if i % 3 == 0 else read))
    return seqs, bcs, reads


def test_renamed_reads_give_the_same_3pgex_count_matrix(tmp_path):
    seqs, bcs, reads = _synthetic_3pgex()
    panel = str(tmp_path / "panel.fa")
    with open(panel, "w") as f:
        f.writelines(f">{g}\n{s}\n" for g, s in seqs.items())
    master = str(tmp_path / "master.txt")
    with open(master, "w") as f:
        f.writelines(b + "\n" for b in bcs)
    out, _ = _renamed_pair(
        tmp_path, "3p10XGEX", reads,
        lambda i: f"m64012_190920_173625/{i}/ccs_{i}", trns_ref=panel,
        barcodes=master)
    for f in ("t_quads.json.gz", "t_gex.mtx.gz", "t_genes.tsv",
              "t_barcodes.tsv"):
        assert _text(os.path.join(out["renamed"], f)) == \
            _text(os.path.join(out["own"], f)), f
    assert _text(os.path.join(out["own"], "t_genes.tsv")).split() == \
        ["GENE1_x", "GENE2"]
