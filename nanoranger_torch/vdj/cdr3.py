"""CDR3 extraction primitives: translation, conserved-Cys anchoring,
J-side [FW]GxG motif scan.

The CDR3 junction spans from the conserved V-region cysteine (IMGT
position 104) to the conserved J-region phenylalanine/tryptophan (IMGT
118), which sits in the canonical J motif [FW]-G-X-G. The bundled V
panels (data/TR_V_human.fa etc.) are in-frame transcripts starting at the
initiator ATG, so frame 0 translation locates the conserved Cys directly;
no external IMGT gap annotation is needed.

A copy of the JAX package's vdj/cdr3.py (host code, no device work).
"""

from __future__ import annotations

import numpy as np

from ..io.encode import decode

# codon index = 16*b0 + 4*b1 + b2 with A=0 C=1 G=2 T=3 (io/encode order).
# Table laid out in that base order (NOT the textbook TCAG order).
_BASES = "ACGT"
_CODON_TABLE = {}
_STANDARD = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}
AA_X = "X"  # any codon containing N / PAD

_AA_BY_IDX = np.full(64, ord(AA_X), np.uint8)
for _codon, _aa in _STANDARD.items():
    _i = 16 * _BASES.index(_codon[0]) + 4 * _BASES.index(_codon[1]) \
        + _BASES.index(_codon[2])
    _AA_BY_IDX[_i] = ord(_aa)


def translate(codes: np.ndarray) -> str:
    """Translate int8 base codes (frame 0); trailing partial codon dropped.
    Codons containing N/PAD translate to 'X'."""
    codes = np.asarray(codes, np.int8)
    n = (len(codes) // 3) * 3
    if n == 0:
        return ""
    c = codes[:n].reshape(-1, 3).astype(np.int32)
    ok = (c >= 0).all(axis=1) & (c < 4).all(axis=1)
    idx = 16 * np.clip(c[:, 0], 0, 3) + 4 * np.clip(c[:, 1], 0, 3) \
        + np.clip(c[:, 2], 0, 3)
    aa = np.where(ok, _AA_BY_IDX[idx], ord(AA_X)).astype(np.uint8)
    return aa.tobytes().decode("ascii")


def v_cys_position(v_codes: np.ndarray, tail_codons: int = 15) -> int:
    """Nucleotide index of the conserved CDR3-start cysteine codon in an
    in-frame V transcript: the LAST Cys within the final `tail_codons`
    codons (IMGT Cys104 is the 3'-most cysteine of the V region).
    Returns -1 when absent."""
    aa = translate(v_codes)
    if not aa:
        return -1
    lo = max(0, len(aa) - tail_codons)
    pos = aa.rfind("C", lo)
    return -1 if pos < 0 else 3 * pos


_FW = frozenset("FW")


def find_motif(aa: str, min_cdr3: int = 5, max_cdr3: int = 35) -> int:
    """Index of the J-anchor residue ([FW] of [FW]-G-X-G) in an aa string
    that starts at the conserved Cys. Returns -1 if absent. The CDR3 is
    aa[0 : i+1] (Cys and Phe/Trp inclusive, MiXCR convention)."""
    hi = min(len(aa) - 3, max_cdr3)
    for i in range(min_cdr3 - 1, hi):
        if aa[i] in _FW and aa[i + 1] == "G" and aa[i + 3] == "G":
            return i
    return -1


def extract_cdr3(read_codes: np.ndarray, cys_pos: int,
                 min_cdr3: int = 5, max_cdr3: int = 35,
                 require_cys: bool = True, frame_rescue: bool = True):
    """CDR3 call from a transcript-forward read given the read-coordinate
    nucleotide position of the conserved Cys codon.

    Returns (nt_str, aa_str) or None. The happy path needs an in-frame,
    stop-free junction from the Cys to the J motif. Two ONT-error rescue
    modes (both still motif- and stop-gated):
      require_cys=False — tolerate a substitution inside the Cys codon
        when the caller pinned the anchor position base-exactly (CIGAR);
      frame_rescue — a single indel inside the junction shifts the J
        motif's frame; scan frames +1/+2 and emit the nt junction (the
        erroneous nt folds into its parent clone during clustering;
        MiXCR's analogue is rescuing such reads via the J alignment).
    """
    if cys_pos < 0 or cys_pos + 3 * min_cdr3 > len(read_codes):
        return None
    tail = np.asarray(read_codes[cys_pos: cys_pos + 3 * (max_cdr3 + 4) + 2])
    aa0 = translate(tail)
    if not aa0 or (require_cys and aa0[0] != "C"):
        return None
    for f in (0, 1, 2) if frame_rescue else (0,):
        aa = aa0 if f == 0 else translate(tail[f:])
        if not aa:
            continue
        i = find_motif(aa, min_cdr3, max_cdr3)
        if i < 0:
            continue
        # stop-gate only the true (Cys) frame: an indel inside the junction
        # legitimately shows stops when the V tail is read in frame f≠0;
        # rescued junctions can only JOIN clones (clonotype.assemble), so
        # clustering distance is their real quality gate
        if f == 0 and "*" in aa[: i + 1]:
            continue
        nt = tail[: 3 * (i + 1) + f]
        # report the Cys-frame translation; '_' marks a frame-shifted
        # (indel-containing) junction, as in MiXCR's aa output for
        # out-of-frame sequences
        aa_out = aa0[: i + 1] + ("" if f == 0 else "_")
        return decode(np.asarray(nt, np.int8), len(nt)), aa_out
    return None


def cigar_map_t_to_q(cigar: str, t_target: int) -> int:
    """Walk an =XID CIGAR (query vs target, both starting at 0) and return
    the query offset aligned to target offset `t_target`; -1 if the CIGAR
    ends first. Insertions (I) consume query, deletions (D/N) consume
    target."""
    q = t = 0
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
            continue
        if ch in "=XM":
            if t + num > t_target:
                return q + (t_target - t)
            q += num
            t += num
        elif ch == "I":
            q += num
        elif ch in "DN":
            if t + num > t_target:
                return q  # target pos falls in a deletion: nearest query pos
            t += num
        num = 0
    return -1


def chain_of(v_name: str) -> str:
    """Chain label from a V/C gene name ('TRBV12-3|ENST…' → 'TRB')."""
    return v_name[:3].upper()
