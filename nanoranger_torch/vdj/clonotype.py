"""Clonotype assembly: group CDR3 calls into clones, cluster sequencing-
error satellites into their parent clones, export MiXCR-shaped tables.

Mirrors the role of `mixcr assemble` with
`-OclusteringFilter.specificMutationProbability=5E-2
 -OaddReadsCountOnClustering=true` (reference scripts/mixcr.sh:12-14):
small clones whose CDR3 is within a length-proportional edit distance of
a larger clone are folded into it and their read counts added.

Two-tier assembly: clones are FOUNDED only by clean calls (in-frame,
Cys-anchored junctions). Rescued calls (frame-shifted or Cys-mutated —
vdj/cdr3.extract_cdr3 rescue modes) can only JOIN an existing clone
within an edit-distance cap; unmatched rescues are dropped. This keeps
ONT indel artifacts from founding phantom clones while still counting
their reads (MiXCR's analogue: low-quality reads map onto assembled
cores during `assemble`, never seed clones).

Exports reproduce the columns the reference's clone_filt_* stages consume
(utils.py:489-581): `_clones.txt.gz` with CLONE_COLS and `_cloneID.txt.gz`
with (descrsR1, cloneId, chains), both tab-separated like MiXCR's
exportClones/exportAlignments output.

A copy of the JAX package's vdj/clonotype.py (host code, no device work).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pandas as pd

CLONE_COLUMNS = ["cloneId", "cloneCount", "chains", "targetSequences",
                 "aaSeqImputedCDR3", "nSeqImputedCDR3",
                 "allVHitsWithScore", "allDHitsWithScore",
                 "allJHitsWithScore", "allCHitsWithScore"]


class DPanel:
    """Diversity-segment caller over the junction interior.

    Germline D sequences from data/TR_D_human.fa (IMGT/GENE-DB human
    TRBD/TRDD germline alleles; D genes exist only for TRB/TRD/IGH — the
    bundled reference panels carry none, and MiXCR's own exports leave D
    empty whenever the short segment is untraceable). A D call needs an
    ungapped window of >= MIN_D_MATCH matching bases with at most one
    mismatch inside the junction between the V-templated first codon and
    the J anchor codon."""

    MIN_D_MATCH = 7

    def __init__(self, fasta_path: str):
        from ..io.fasta import read_fasta_encoded
        from ..io.encode import decode as _dec
        names, seqs = read_fasta_encoded(fasta_path)
        self.entries = [(nm, _dec(np.asarray(s, np.int8), len(s)))
                        for nm, s in zip(names, seqs)]

    def call(self, junction_nt: str, chain: str):
        """Best D hit inside the junction interior → (name, matched_bases)
        or ("", 0). D segments appear as exonuclease-TRIMMED germline
        substrings flanked by untemplated N nucleotides, so per alignment
        offset we score the longest window containing at most one
        mismatch (two-pointer run scan), not the full overlap."""
        if len(junction_nt) < 6 + self.MIN_D_MATCH:
            return "", 0
        interior = junction_nt[3:-3]          # V codon / J anchor trimmed
        best, best_n = "", 0
        for nm, d in self.entries:
            if not nm.upper().startswith(chain.upper()[:3]):
                continue
            ld = len(d)
            for off in range(-ld + self.MIN_D_MATCH,
                             len(interior) - self.MIN_D_MATCH + 1):
                a = max(0, off)
                b = min(len(interior), off + ld)
                if b - a < self.MIN_D_MATCH:
                    continue
                eq = [interior[i] == d[i - off] for i in range(a, b)]
                # longest window with <= 1 mismatch
                lo = mm = 0
                for hi in range(len(eq)):
                    mm += not eq[hi]
                    while mm > 1:
                        mm -= not eq[lo]
                        lo += 1
                    match = (hi - lo + 1) - mm
                    if match >= self.MIN_D_MATCH and match > best_n:
                        best, best_n = nm, match
        return best, best_n


def impute_cdr3(nt: str, v_tail_nt: str | None):
    """Germline imputation of the V-templated junction prefix (MiXCR's
    `exportClones -p fullImputed` analogue, reference scripts/mixcr.sh:15):
    N bases in the CDR3 prefix that the assigned V's germline tail (from
    the conserved Cys) covers are replaced by the germline base, as long
    as the read and germline agree on the surrounding prefix (>= 2/3 of
    the non-N overlap). Returns the (possibly) imputed nt string."""
    if v_tail_nt is None or "N" not in nt:
        return nt
    k = min(len(nt), len(v_tail_nt))
    pairs = [(a, b) for a, b in zip(nt[:k], v_tail_nt[:k]) if a != "N"]
    if pairs:
        agree = sum(1 for a, b in pairs if a == b)
        if agree * 3 < len(pairs) * 2:
            return nt
    out = list(nt)
    for i in range(k):
        if out[i] == "N":
            out[i] = v_tail_nt[i]
    return "".join(out)


@dataclasses.dataclass
class ReadCall:
    """One successful CDR3 call for one subread."""
    name: str          # subread name (joins _cloneID.descrsR1)
    v_name: str
    v_score: int
    chain: str
    cdr3_nt: str
    cdr3_aa: str
    clean: bool = True  # in-frame + Cys-anchored (may found a clone)
    c_name: str = ""    # constant-region gene (vdj/caller._CPanel)
    c_score: int = 0    # shared-kmer evidence count
    partial: bool = False  # junction truncated at the read end (no J
    #                        motif): cdr3_nt holds only the PREFIX. Such
    #                        reads never found clones; they overlap-merge
    #                        onto an assembled clone's junction prefix —
    #                        the role of MiXCR v4's assemblePartial +
    #                        extend (reference scripts/mixcr4.sh:10-14)
    seq: str = ""       # full subread (stored orientation) — consensus
    #                     contig assembly (assembleContigs analogue)


def lev_batch(a_strs: list, b_strs: list) -> np.ndarray:
    """Batched Levenshtein over string pairs (a_strs[p] vs b_strs[p]).

    Vectorized numpy DP using the prefix-min distance-transform identity
    (same recurrence as ops/edit_distance._rows_scan; this host-side copy
    serves the tiny clone-pair workload — the read-scale distances run on
    the device)."""
    P = len(a_strs)
    if P == 0:
        return np.zeros(0, np.int32)
    la = np.asarray([len(s) for s in a_strs], np.int32)
    lb = np.asarray([len(s) for s in b_strs], np.int32)
    M = max(1, int(la.max()))
    Mb = max(1, int(lb.max()))
    A = np.zeros((P, M), np.uint8)
    B = np.zeros((P, Mb), np.uint8)
    for p, s in enumerate(a_strs):
        A[p, :len(s)] = np.frombuffer(s.encode(), np.uint8)
    for p, s in enumerate(b_strs):
        B[p, :len(s)] = np.frombuffer(s.encode(), np.uint8) + 1  # ≠ pad(0)
    iota = np.arange(Mb + 1, dtype=np.int32)[None, :]
    row = np.broadcast_to(iota, (P, Mb + 1)).copy()
    out = np.where(la == 0, lb, 10 ** 6).astype(np.int32)
    for i in range(1, M + 1):
        c = (A[:, i - 1][:, None] + 1 != B).astype(np.int32)
        t = np.minimum(row[:, :-1] + c, row[:, 1:] + 1)
        t = np.concatenate([np.full((P, 1), i, np.int32), t], axis=1)
        row = np.minimum.accumulate(t - iota, axis=1) + iota
        hit = la == i
        if hit.any():
            out[hit] = row[hit, lb[hit]]
    return out


def _cluster_cap(nt_len: int) -> int:
    """Max CDR3 edit distance for satellite→parent merging: ~5% of the
    junction length (the 5e-2 mutation-probability knob), at least 1."""
    return max(1, nt_len // 20)


def _rescue_cap(nt_len: int) -> int:
    """Looser cap for joining rescued (indel-bearing) reads to a clone."""
    return max(2, nt_len // 10)


RESCUE_LEN_DIFF = 6
NESTED_MIN_NT = 24   # min exact-suffix overlap for nested-junction merge


def _empty():
    return (pd.DataFrame(columns=CLONE_COLUMNS),
            pd.DataFrame(columns=["descrsR1", "cloneId", "chains"]))


def assemble(calls: list, v_tails: dict | None = None,
             d_panel: "DPanel | None" = None,
             stats: dict | None = None
             ) -> tuple[pd.DataFrame, pd.DataFrame]:
    """Two-tier clone assembly; cloneId = rank by read count (like MiXCR).

    v_tails: optional {v_name: germline nt from the conserved Cys} for
    CDR3 N-base imputation (fullImputed analogue). d_panel: optional
    DPanel for junction D-segment calls.

    Returns (clones_df, cloneID_df):
      clones_df columns: CLONE_COLUMNS
      cloneID_df columns: descrsR1, cloneId, chains
    """
    clean = [c for c in calls if c.clean and not c.partial]
    rescued = [c for c in calls if not c.clean and not c.partial]
    partials = [c for c in calls if c.partial]
    if not clean:
        return _empty()

    df = pd.DataFrame({
        "name": [c.name for c in clean],
        "v_name": [c.v_name for c in clean],
        "v_score": [c.v_score for c in clean],
        "chain": [c.chain for c in clean],
        "cdr3_nt": [c.cdr3_nt for c in clean],
        "cdr3_aa": [c.cdr3_aa for c in clean],
        "c_name": [c.c_name for c in clean],
        "c_score": [c.c_score for c in clean],
    })
    raw = df.groupby(["chain", "cdr3_nt"], sort=False).agg(
        count=("name", "size"),
        cdr3_aa=("cdr3_aa", "first"),
        v_name=("v_name", lambda s: s.mode().iloc[0]),
        v_score=("v_score", "max"),
        c_name=("c_name", lambda s: (s[s != ""].mode().iloc[0]
                                     if (s != "").any() else "")),
        c_score=("c_score", "max"),
    ).reset_index()
    raw = raw.sort_values("count", ascending=False, kind="stable")
    raw = raw.reset_index(drop=True)
    nts = raw.cdr3_nt.tolist()
    chains = raw.chain.tolist()
    counts = raw["count"].to_numpy().copy()
    sizes = raw["count"].to_numpy()

    # --- satellite clustering among clean clones --------------------------
    # candidate pairs (i bigger-ranked ← j smaller), batched distances
    pi, pj = [], []
    for i in range(len(raw)):
        cap = _cluster_cap(len(nts[i]))
        for j in range(i):
            if chains[j] == chains[i] and \
                    abs(len(nts[i]) - len(nts[j])) <= cap and \
                    sizes[j] >= 2 * sizes[i]:
                pi.append(i)
                pj.append(j)
    dists = lev_batch([nts[i] for i in pi], [nts[j] for j in pj])
    dist_of = {(i, j): int(d) for i, j, d in zip(pi, pj, dists)}

    parent = np.arange(len(raw))
    for i in range(len(raw)):
        cap = _cluster_cap(len(nts[i]))
        for j in range(i):
            if parent[j] != j:
                continue
            d = dist_of.get((i, j))
            # nested-junction merge: a V mis-assignment can anchor an
            # earlier in-frame Cys, extending the true junction 5' — an
            # exact long suffix relationship is the same clone
            nested = (chains[i] == chains[j]
                      and min(len(nts[i]), len(nts[j])) >= NESTED_MIN_NT
                      and (nts[i].endswith(nts[j])
                           or nts[j].endswith(nts[i])))
            if nested or (d is not None and d <= cap):
                parent[i] = j
                counts[j] += counts[i]
                counts[i] = 0
                break

    keep = np.where(parent == np.arange(len(raw)))[0]

    # --- assign rescued reads to surviving clones -------------------------
    # unique rescued junctions vs candidate clones, batched
    res_groups: dict = {}
    for c in rescued:
        res_groups.setdefault((c.chain, c.cdr3_nt), []).append(c)
    rkeys = list(res_groups)
    qi, qk = [], []   # rescued-key index, clone (raw) index
    for r, (ch, nt) in enumerate(rkeys):
        for k in keep:
            if chains[k] == ch and abs(len(nts[k]) - len(nt)) <= RESCUE_LEN_DIFF:
                qi.append(r)
                qk.append(int(k))
    rdists = lev_batch([rkeys[r][1] for r in qi], [nts[k] for k in qk])
    best_for = {}
    for r, k, d in zip(qi, qk, rdists):
        cap = _rescue_cap(len(rkeys[r][1]))
        if d > cap:
            continue
        cur = best_for.get(r)
        # min distance, ties to the bigger clone (counts desc = rank asc)
        if cur is None or d < cur[0] or (d == cur[0] and k < cur[1]):
            best_for[r] = (int(d), k)
    rescued_assigned: list = []   # (call, raw clone index)
    for r, (_, k) in best_for.items():
        for call in res_groups[rkeys[r]]:
            counts[k] += 1
            rescued_assigned.append((call, k))

    # --- partial-junction overlap-merge (assemblePartial/extend role) -----
    # A partial read carries only a junction PREFIX (truncated before the
    # J motif). It joins a surviving clone iff its prefix matches that
    # clone's junction prefix within the rescue edit cap AND the match is
    # UNIQUE — an ambiguous overlap (distance tie across clones) is
    # dropped, like assemblePartial's unique-overlap requirement.
    par_groups: dict = {}
    for c in partials:
        par_groups.setdefault((c.chain, c.cdr3_nt), []).append(c)
    pkeys = list(par_groups)
    ppi, ppk = [], []          # partial-key index, clone (raw) index
    for r, (ch, nt) in enumerate(pkeys):
        for k in keep:
            if chains[k] == ch and len(nts[k]) >= len(nt):
                ppi.append(r)
                ppk.append(int(k))
    pdists = lev_batch([pkeys[r][1] for r in ppi],
                       [nts[k][:len(pkeys[r][1])]
                        for r, k in zip(ppi, ppk)])
    pbest: dict = {}
    for r, k, d in zip(ppi, ppk, pdists):
        cap = _rescue_cap(len(pkeys[r][1]))
        if d > cap:
            continue
        cur = pbest.get(r)
        if cur is None or d < cur[0]:
            pbest[r] = (int(d), k, False)
        elif d == cur[0] and k != cur[1]:
            pbest[r] = (int(d), cur[1], True)       # ambiguous → drop
    n_partial_assigned = 0
    for r, (_, k, ambiguous) in pbest.items():
        if ambiguous:
            continue
        for call in par_groups[pkeys[r]]:
            counts[k] += 1
            rescued_assigned.append((call, k))
            n_partial_assigned += 1
    if stats is not None:
        stats["n_partial_reads"] = len(partials)
        stats["n_partial_assigned"] = n_partial_assigned

    # --- final numbering ---------------------------------------------------
    clones = raw.loc[keep].copy()
    clones["cloneCount"] = counts[keep]
    clones["_rawidx"] = keep
    clones = clones.sort_values("cloneCount", ascending=False, kind="stable")
    clones = clones.reset_index(drop=True)
    clones["cloneId"] = np.arange(len(clones))
    rawidx_to_id = {int(rw): int(cid) for rw, cid in
                    zip(clones._rawidx, clones.cloneId)}

    key_to_raw = {(ch, nt): i for i, (ch, nt) in
                  enumerate(zip(chains, nts))}
    id_rows = {"descrsR1": [], "cloneId": [], "chains": []}
    for nm, ch, nt in zip(df.name, df.chain, df.cdr3_nt):
        p = int(parent[key_to_raw[(ch, nt)]])
        id_rows["descrsR1"].append(nm)
        id_rows["cloneId"].append(rawidx_to_id[p])
        id_rows["chains"].append(ch)
    for call, k in rescued_assigned:
        id_rows["descrsR1"].append(call.name)
        id_rows["cloneId"].append(rawidx_to_id[int(k)])
        id_rows["chains"].append(call.chain)

    # --- clone-consensus contigs (assembleContigs analogue,
    # reference scripts/mixcr4.sh:18-20): member reads anchor on their
    # own junction occurrence inside their subread; columns are
    # junction-relative, per-column base majority vote (ties by base
    # order) over every member covering the column. The contig spans the
    # union of member coverage — the full-length V..C consensus MiXCR's
    # assembleContigs reports as targetSequences.
    id_of = dict(zip(id_rows["descrsR1"], id_rows["cloneId"]))
    members: dict = {}
    for call in clean + rescued + partials:
        cid = id_of.get(call.name)
        if cid is None or not call.seq:
            continue
        pos = call.seq.find(call.cdr3_nt) if call.cdr3_nt else -1
        if pos >= 0:
            members.setdefault(cid, []).append((call.seq, pos))
    contigs = []
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    for cid, nt in zip(clones.cloneId, clones.cdr3_nt):
        mem = members.get(int(cid))
        if not mem:
            contigs.append(nt)
            continue
        lo = -max(p for _, p in mem)
        hi = max(len(s) - p for s, p in mem)
        votes = np.zeros((hi - lo, 4), np.int32)
        for s, p in mem:
            enc = np.frombuffer(s.encode(), np.uint8)
            col = np.array([code.get(chr(c), -1) for c in enc], np.int8)
            ok = col >= 0
            idx = np.arange(len(s)) - p - lo
            np.add.at(votes, (idx[ok], col[ok]), 1)
        cov = votes.sum(axis=1) > 0
        best = votes.argmax(axis=1)
        arr = np.frombuffer(b"ACGT", np.uint8)[best]
        contigs.append(arr[cov].tobytes().decode())

    # J/C hits: locus-level J (the J-motif anchor exists by construction of
    # the CDR3 call; its locus comes from the constant-region identity) plus
    # the real C-gene hit with its shared-kmer evidence count. No J-allele
    # panel ships with the reference either — MiXCR uses its own built-in
    # library (scripts/mixcr.sh:15-22); allele-level J naming would be
    # fabrication, locus-level is what the data supports.
    j_hits, c_hits = [], []
    for cn, cs, ch in zip(clones.c_name, clones.c_score, clones.chain):
        if cn:
            locus = cn[:3].upper()
            j_hits.append(f"{locus}J*00({int(cs)})")
            c_hits.append(f"{cn}*00({int(cs)})")
        else:
            j_hits.append("")
            c_hits.append("")

    # D-segment hits inside the junction (data/TR_D_human.fa; only loci
    # with germline D genes can carry one — elsewhere empty, as MiXCR's
    # own exports are when the segment is untraceable)
    d_hits = []
    for nt, ch in zip(clones.cdr3_nt, clones.chain):
        nm, sc = d_panel.call(nt, ch) if d_panel is not None else ("", 0)
        d_hits.append(f"{nm}({int(sc)})" if nm else "")

    # fullImputed analogue: impute N bases in the V-templated prefix from
    # the assigned V's germline tail, then re-translate
    nt_out, aa_out = [], []
    from .cdr3 import translate
    from ..io.encode import encode as _enc
    for nt, aa, vn in zip(clones.cdr3_nt, clones.cdr3_aa, clones.v_name):
        nt2 = impute_cdr3(nt, (v_tails or {}).get(vn))
        if nt2 != nt:
            shifted = aa.endswith("_")
            aa2 = translate(_enc(nt2)) + ("_" if shifted else "")
            nt_out.append(nt2)
            aa_out.append(aa2 if not shifted else aa)
        else:
            nt_out.append(nt)
            aa_out.append(aa)
    out_clones = pd.DataFrame({
        "cloneId": clones.cloneId,
        "cloneCount": clones.cloneCount.astype(float),
        "chains": clones.chain,
        "targetSequences": contigs,
        "aaSeqImputedCDR3": aa_out,
        "nSeqImputedCDR3": nt_out,
        "allVHitsWithScore": [f"{v.split('|')[0]}*00({int(s)})"
                              for v, s in zip(clones.v_name, clones.v_score)],
        "allDHitsWithScore": d_hits,
        "allJHitsWithScore": j_hits,
        "allCHitsWithScore": c_hits,
    })
    return out_clones, pd.DataFrame(id_rows)


def write_exports(clones: pd.DataFrame, cloneID: pd.DataFrame,
                  outdir: str, sample: str):
    """MiXCR-shaped tab-separated gzip exports, consumed by
    stages/clones.clone_filt_* unchanged.

    Atomic (tmp + rename, both files written before either rename):
    these exact files are the clone-stage resume sentinel
    (stages/clones.have_mixcr_outputs), so a crash mid-write must never
    leave a truncated gzip that later runs treat as complete."""
    import os
    paths = [f"{outdir}/{sample}_clones.txt.gz",
             f"{outdir}/{sample}_cloneID.txt.gz"]
    for df, path in zip((clones, cloneID), paths):
        df.to_csv(path + ".tmp", sep="\t", index=False, compression="gzip")
    for path in paths:
        os.replace(path + ".tmp", path)
