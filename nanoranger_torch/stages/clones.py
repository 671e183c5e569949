"""Clonotype boundary: MiXCR-output filtering and clone–barcode–UMI joins.

MiXCR (a separate Java product) remains an external boundary tool exactly
as in the reference (scripts/mixcr.sh; SURVEY.md §2.2): the engine emits
its input fastq (_deconcat/_VDJ.fastq.gz) and consumes its exports
(_clones.txt.gz, _cloneID.txt.gz) when present. These functions replicate
clone_filt_5p10X / clone_filt_slideseq (utils.py:489-581) and the
clone ⋈ (read → bc, umi) joins of process_matching_{5p10XTCR,
slideseq_XCR, 3p10XTCR_nuc} (utils.py:965-979,672-682,1267-1280).

A copy of the JAX package's stages/clones.py (host code).
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

CLONE_COLS = ["chains", "aaSeqImputedCDR3", "cloneCount", "cloneId",
              "nSeqImputedCDR3", "allVHitsWithScore", "allDHitsWithScore",
              "allJHitsWithScore"]


def clone_filt_5p10X(sample: str, outdir: str):
    """cloneCount>1 filter + merge clones sharing aaSeqImputedCDR3 into the
    dominant cloneId (utils.py:536-581)."""
    clones = pd.read_table(f"{outdir}/{sample}_clones.txt.gz")
    clones = clones[clones.cloneCount > 1].copy()
    clones = clones[CLONE_COLS]
    cloneID = pd.read_table(f"{outdir}/{sample}_cloneID.txt.gz")
    cloneID = cloneID[cloneID.cloneId.isin(clones.cloneId)].copy()

    cnt = clones.aaSeqImputedCDR3.value_counts()
    repeated = cnt[cnt > 1].index.tolist()
    reclone = clones[clones.aaSeqImputedCDR3.isin(repeated)].sort_values(
        by=["aaSeqImputedCDR3", "cloneCount"], ascending=False)
    maps: dict = {}
    for rep in repeated:
        dd = reclone[reclone.aaSeqImputedCDR3 == rep].index.tolist()
        for idx in dd[1:]:
            maps[idx] = dd[0]
    cloneID.cloneId = cloneID.cloneId.map(lambda x: maps.get(x, x))
    clones = clones.drop_duplicates(subset="aaSeqImputedCDR3", keep="first")
    cloneID = cloneID.set_index("descrsR1")[["chains", "cloneId"]]
    clones.to_csv(f"{outdir}/{sample}_clones_filtered.csv")
    cloneID.to_csv(f"{outdir}/{sample}_cloneID_filtered.csv.gz")
    return clones, cloneID


def clone_filt_slideseq(sample: str, outdir: str):
    """Lighter variant: no count filter, no CDR3 merge (utils.py:489-533)."""
    clones = pd.read_table(f"{outdir}/{sample}_clones.txt.gz")
    clones = clones[CLONE_COLS]
    cloneID = pd.read_table(f"{outdir}/{sample}_cloneID.txt.gz")
    cloneID = cloneID[cloneID.cloneId.isin(clones.cloneId)].copy()
    cloneID = cloneID.set_index("descrsR1")[["chains", "cloneId"]]
    cloneID.to_csv(f"{outdir}/{sample}_cloneID_filtered.csv.gz")
    return clones, cloneID


def clone_bcumi_join(cloneID: pd.DataFrame, names: list, bcs: np.ndarray,
                     umis: list, out_path: str, clone_first: bool = False):
    """Inner-join read→(bc, umi) with read→cloneId on the read name and
    write the clonotype table (utils.py:965-979 / 672-682)."""
    bcumi = pd.DataFrame({"ID": names, "bc": bcs, "umi": umis}).set_index("ID")
    if clone_first:   # slideseq column order (utils.py:676-680)
        merged = pd.merge(cloneID, bcumi, how="inner",
                          left_index=True, right_index=True)
    else:
        merged = pd.merge(bcumi, cloneID, how="inner",
                          left_index=True, right_index=True)
    merged = merged.sort_values(by=["cloneId", "bc", "umi"])
    merged.to_csv(out_path, index=None)
    return merged


def have_mixcr_outputs(sample: str, outdir: str) -> bool:
    return (os.path.isfile(f"{outdir}/{sample}_clones.txt.gz")
            and os.path.isfile(f"{outdir}/{sample}_cloneID.txt.gz"))
