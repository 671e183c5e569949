"""Native VDJ clonotyping.

The reference delegates clonotype assembly to MiXCR, an external Java
product invoked through scripts/mixcr.sh. This subsystem is the built-in
clonotyper, so the clone modes (5p10XTCR, RTX, 3pXCR_slideseq, 3p10XTCR,
3p10XTCR_nuc) produce clone tables standalone: V-gene assignment with the
panel aligner (seed and chain on the device), frame-pinned CDR3 extraction
(conserved V-Cys -> [FW]GxG J motif), abundance-weighted clonotype
clustering, and MiXCR-compatible `_clones.txt.gz` / `_cloneID.txt.gz`
exports consumed by stages/clones.py unchanged. MiXCR exports, when
present, still take precedence.
"""

from .caller import call_clonotypes  # noqa: F401
