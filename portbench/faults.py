"""The control and the planted faults that the check must catch.

`run.py --fault <name>` applies one before the run; a measured run never
does. Each patch wraps a name the port's modules look up at call time and
is undone after the run.

- control: the configuration's "exact verdict for every candidate" broken:
  the staged match skips its one-vs-all DP (K4) and the UMI rescore (K5),
  so the candidates with no tier structure get no exact verdict.
- half_batch: the subreads and candidates of the second half of every
  batch's reads are left out where the fused step's batch is assembled
  (the reads still count as read), and the clonotyper assembles its clones
  from the first half of its CDR3 calls.
- alter_answer: one answer altered where it is produced, in every layer
  the check reads: a base of the first subread and of the first candidate
  of each assembled batch, the UMI of the first accepted candidate, the
  read count of the first dedup row, the CB tag of each BAM's first record,
  and the barcode of the first clone-barcode-UMI row.
"""

from __future__ import annotations

NAMES = ("control", "half_batch", "alter_answer")


def _flip(s: str) -> str:
    if not s:
        return s
    return ("C" if s[0] != "C" else "G") + s[1:]


def _control() -> list:
    import torch
    from nanoranger_torch.stages import barcode

    orig = barcode.BarcodeMatcher._dp_pass

    def no_dp(self, q, qlen, t, need):
        B = q.shape[0]
        dev = q.device
        i32 = torch.int32
        return (torch.full((B,), barcode.NEG, dtype=i32, device=dev),
                torch.full((B,), -1, dtype=i32, device=dev),
                torch.zeros(B, dtype=i32, device=dev),
                torch.full((B,), barcode.NEG, dtype=i32, device=dev),
                torch.full((B,), -1, dtype=i32, device=dev),
                torch.zeros(B, dtype=torch.bool, device=dev))

    barcode.BarcodeMatcher._dp_pass = no_dp
    return [(barcode.BarcodeMatcher, "_dp_pass", orig)]


def _half_batch() -> list:
    from nanoranger_torch import pipeline
    from nanoranger_torch.vdj import caller

    orig = pipeline.assemble_batch
    assemble_orig = caller.assemble

    def halved(*a, **kw):
        asm = orig(*a, **kw)
        b = asm.read_bounds
        h = len(b) // 2
        if h:
            # the second half's ranges of subreads and candidates empty
            asm.read_bounds = b[:h] + [b[h - 1][:2] + x[2:] for x in b[h:]]
        return asm

    def half_calls(calls, **kw):
        return assemble_orig(calls[:len(calls) // 2], **kw)

    pipeline.assemble_batch = halved
    caller.assemble = half_calls
    return [(pipeline, "assemble_batch", orig),
            (caller, "assemble", assemble_orig)]


def _alter_answer() -> list:
    from nanoranger_torch import pipeline
    from nanoranger_torch.io.bam import BAMWriter
    from nanoranger_torch.stages import clones, counting

    undo = []
    asm_orig = pipeline.assemble_batch

    def assemble(*a, **kw):
        asm = asm_orig(*a, **kw)
        if asm.sub_seqs:
            asm.sub_seqs[0] = _flip(asm.sub_seqs[0])
        if asm.bcumi_seqs:
            asm.bcumi_seqs[0] = _flip(asm.bcumi_seqs[0])
        return asm

    match_orig = pipeline.match_barcodes

    def match(*a, **kw):
        df, res = match_orig(*a, **kw)
        hit = (df.status == 0).to_numpy().nonzero()[0]
        if len(hit):
            df.loc[df.index[hit[0]], "umi"] = _flip(df.umi.iloc[hit[0]])
            path = f"{a[3]}/{a[4]}_assignments.csv.gz"
            df.to_csv(path, index=False)
        return df, res

    dedup_orig = counting.umi_dedup_table

    def dedup(*a, **kw):
        t = dedup_orig(*a, **kw)
        if len(t):
            t.iloc[0, t.columns.get_loc("read_cnt")] += 1
        return t

    write_orig = BAMWriter.write

    def write(self, name, *a, tags=None, **kw):
        first = not getattr(self, "_fault_seen", False)
        self._fault_seen = True
        if first and tags is not None and "CB" in tags:
            tags = {**tags, "CB": _flip(tags["CB"])}
        return write_orig(self, name, *a, tags=tags, **kw)

    join_orig = clones.clone_bcumi_join

    def join(cloneID, names, bcs, umis, out_path, **kw):
        bcs = bcs.copy()
        if len(bcs):
            bcs[0] = _flip(str(bcs[0]))
        return join_orig(cloneID, names, bcs, umis, out_path, **kw)

    for obj, attr, new in ((pipeline, "assemble_batch", assemble),
                           (pipeline, "match_barcodes", match),
                           (counting, "umi_dedup_table", dedup),
                           (BAMWriter, "write", write),
                           (clones, "clone_bcumi_join", join)):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)
    return undo


def apply(name: str) -> list:
    """Apply fault `name`; returns the (object, attribute, original)
    triples that undo it."""
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
    return {"control": _control, "half_batch": _half_batch,
            "alter_answer": _alter_answer}[name]()
