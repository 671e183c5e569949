"""The comparison that decides `correct`: what the timed samples produced,
judged against the plain reference after the window has closed.

Each number is a count of answers that disagree with the reference, summed
over the window's samples; its limit (in the configuration's `limits`)
is 0. Every answer of every sample is judged, except where a drawn sample
is named.

- reads_missing: reads of a sample that the run does not report as
  processed (align_decon's read count against the sample's reads).
- subread_mismatch: every subread, cut again from its read at the span
  its name states, compared base for base and quality for quality.
- candidate_mismatch: 5p10XGEX: every subread's BC-UMI candidate found
  again by the plain adapter scan of its flank and sliced, and every
  candidate name paired with a subread name; 3pXCR_slideseq (whose names
  do not state the flank's anchor): every candidate, reverse complemented,
  lies in its read after the aligned span's start, holds the linker
  within the scan's distance, is longer than 45 bases and names a subread.
- verdict_mismatch: every accepted (and bad-UMI) candidate against the
  padded row of the barcode it was given: the score, and the UMI at the
  query position that an optimal alignment puts at the UMI column; then a
  drawn sample of candidates (uniform, and for a list with tier tables
  more among candidates with no window within one substitution of a
  barcode on either strand, most of which the staged match sends to its
  one-vs-all DP) matched again against every row on both strands: status,
  and the score, barcode and UMI where the status shows them.
- drawn_read_mismatch: a drawn sample of the window's reads aligned
  again by the plain aligner (reference/align.py: minimizers, chain,
  primary and supplementary records, end extension), their flanks scanned
  and cut by the chemistry's rules: every subread and candidate the
  reference finds for them and the program lacks, or the program has and
  the reference does not, counts.
- dedup_mismatch: the whole UMI dedup table, recomputed from the
  assignments, rows by UMI count descending.
- bam_mismatch (genome stage): every record of the tagged BAM: its read is
  accepted with the CB and UB it carries, XT is the transcript its name
  states, its sequence is its subread (or the reverse complement), its
  CIGAR spans the sequence, its = and X operations agree with the genome,
  NM counts the edits inside the exon blocks, and records are sorted.
- clone_mismatch (clonotyper): every clone's CDR3 protein is the
  translation of its nucleotides, its count is its reads, each of its
  reads is a subread, and the clone-barcode-UMI table equals the join of
  the clone reads with the accepted assignments.
- cdr3_call_mismatch (clonotyper): a drawn sample of the window's VDJ
  subreads called again by the plain CDR3 caller (reference/vdj.py): a
  subread with a clean call must be in the clone table under a clone of
  its chain whose CDR3 lies within its folding distance, a rescued or
  partial call may only sit under a clone within its cap, and a subread
  with no call must not be there.
"""

from __future__ import annotations

import gzip
import itertools
import json
import os
from collections import Counter

import numpy as np
import pandas as pd
import torch

from . import align, plain, vdj

ACCEPT, LOW_AS, MULTIMAP, NO_CAND, BAD_UMI, RC_BEST = 0, 1, 2, 3, 4, 6

_ASCII = np.frombuffer(b"ACGTN.", np.uint8)   # base codes to letters
_BASES = "TCAG"
_AAS = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
CODONS = {"".join(c): a for c, a in zip(itertools.product(_BASES, repeat=3),
                                        _AAS)}


def translate(nt: str) -> str:
    return "".join(CODONS.get(nt[i:i + 3], "X")
                   for i in range(0, len(nt) - len(nt) % 3, 3))


def _rc(s: bytes) -> bytes:
    return s.translate(bytes.maketrans(b"ACGTN", b"TGCAN"))[::-1]


def read_fastq_records(path: str) -> list:
    with gzip.open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return [(lines[i][1:].decode(), lines[i + 1], lines[i + 3])
            for i in range(0, len(lines) - 3, 4)]


def split_name(name: str, reads: dict) -> tuple:
    """(read name, the fields after it) of an output record name that
    starts with a read name and an underscore."""
    parts = name.split("_")
    for k in range(1, len(parts)):
        head = "_".join(parts[:k])
        if head in reads:
            return head, "_".join(parts[k:])
    return None, None


def load_whitelist(path: str, slideseq: bool) -> np.ndarray:
    with gzip.open(path, "rt") as f:
        bcs = [ln.strip().split("\t")[0].split("-")[0] for ln in f
               if ln.strip()]
    return np.unique(np.asarray(bcs)) if slideseq else np.asarray(bcs)


def core_columns(bcs: np.ndarray, bspec: dict) -> np.ndarray:
    """(m, R) int8: the core of every padded row (the linker inside for
    bead barcodes)."""
    rows = [(b[:8] + bspec["linker"] + b[8:]) if bspec["slideseq_linker"]
            else b for b in bcs]
    blob = "".join(rows).encode()
    m = len(rows[0])
    return np.ascontiguousarray(plain.encode(blob).reshape(len(rows), m).T)


class Judge:
    """The plain reference of one configuration: its whitelist, panel and
    genome, read from the checkout's data files."""

    def __init__(self, root: str, cfg: dict, workload: dict, device: str):
        self.examples: dict = {}       # number -> a few failing answers
        self.cfg = cfg
        self.ch = cfg["chemistry"]
        self.bs = cfg["barcode"]
        self.device = torch.device(device)
        self.max_len = cfg["max_len"]
        self.bcs = load_whitelist(os.path.join(root, cfg["whitelist"]),
                                  self.bs["slideseq_linker"])
        self.core = core_columns(self.bcs, self.bs)
        L = self.bs["bc_len"]
        self.bc_keys = None if self.bs["slideseq_linker"] else np.sort(
            plain.encode("".join(self.bcs.tolist()).encode()).reshape(
                -1, L).astype(np.int64) @ (4 ** np.arange(L - 1, -1, -1)))
        self.genome = (plain.read_fasta(os.path.join(
            root, workload["genome_ref"])) if workload.get("genome_ref")
            else None)
        self.panel = align.Index.from_fastas(
            [os.path.join(root, workload["trns_ref"])])
        ct = cfg.get("clonotyper")
        self.caller = (vdj.Caller([os.path.join(root, p)
                                   for p in ct["v_panels"]]) if ct else None)

    def _bad(self, number: str, what: str) -> int:
        ex = self.examples.setdefault(number, [])
        if len(ex) < 3:
            ex.append(what[:300])
        return 1

    # ---- subreads and candidates ------------------------------------------

    def _stored(self, seq: bytes, qual: bytes, strand: int):
        seq, qual = seq[:self.max_len], qual[:self.max_len]
        return (_rc(seq), qual[::-1]) if strand else (seq, qual)

    def _scan(self, texts: list, pick_last: bool):
        """The plain adapter scan of every text at once: (dist, start,
        end) arrays, end inclusive, -1 where the motif is not within k."""
        if not texts:
            z = np.zeros(0, np.int64)
            return z, z, z
        width = max(1, max(len(t) for t in texts))
        codes, lens = plain.encode_rows(texts, width)
        return plain.hw_locate(plain.encode(self.ch["pattern"].encode()),
                               codes, lens, self.ch["k"],
                               self.ch["wildcard"], pick_last)

    def _gex_spans(self, seq, qual, fields):
        """The stored subread, its quality and the adapter flank of one
        record of a 5p10XGEX name (qstart, qend in the read's own
        orientation)."""
        qstart, qend, flag, _trans = fields.split("_", 3)
        qstart, qend, strand = int(qstart), int(qend), int(flag) & 16 != 0
        rlen = min(len(seq), self.max_len)
        sq, sql = self._stored(seq, qual, strand)
        s0 = rlen - qend if strand else qstart
        s1 = rlen - qstart if strand else qend
        fl = self.ch["flank"]
        window = sq[max(0, s0 + fl["lo"]):min(s0 + fl["hi"], rlen)]
        return sq[s0:s1], sql[s0:s1], window

    def _slideseq_spans(self, seq, qual, fields):
        """The stored subread and its quality of a 3pXCR_slideseq name
        (the subread's own span), the stored read, and where the aligned
        span starts."""
        _sample, s0, s1, flag, _trans = fields.split("_", 4)
        s0, s1, strand = int(s0), int(s1), int(flag) & 16 != 0
        sq, sql = self._stored(seq, qual, strand)
        return sq[s0:s1], sql[s0:s1], sq, s1 - self.ch["subread"]["end_ofs"]

    def subreads(self, samples) -> tuple:
        """(subread mismatches, candidate mismatches) over every record of
        the samples."""
        gex = self.ch["name_format"] == "qstart_qend"
        sub_bad = cand_bad = 0
        windows, wnames, cand_of = [], [], {}
        fwds, fnames = [], []
        for s in samples:
            reads = s["reads"]
            subs = read_fastq_records(s["subreads"])
            cands = plain.read_fasta_records(s["bcumi"])
            sub_names = {n for n, _, _ in subs}
            by = s["by_read"] = {"sub": {}, "cand": {}}
            for n, sq, q in subs:
                by["sub"].setdefault(split_name(n, reads)[0], []).append(
                    (n, sq, q))
            for n, c in cands:
                by["cand"].setdefault(split_name(n, reads)[0], []).append(
                    (n, c))
            for n, c in cands:
                cand_of.setdefault(n, []).append(c)
            if gex:
                for n in sub_names.symmetric_difference(n for n, _ in cands):
                    cand_bad += self._bad("candidate_mismatch",
                                          f"unpaired name {n}")
            for name, sseq, squal in subs:
                rname, fields = split_name(name, reads)
                if rname is None:
                    sub_bad += self._bad("subread_mismatch",
                                         f"no read {name}")
                    continue
                if gex:
                    e_sub, e_qual, window = self._gex_spans(*reads[rname],
                                                            fields)
                    windows.append(window)
                    wnames.append(name)
                else:
                    e_sub, e_qual, _, _ = self._slideseq_spans(*reads[rname],
                                                               fields)
                if (e_sub, e_qual) != (sseq, squal):
                    sub_bad += self._bad(
                        "subread_mismatch",
                        f"{name}: {sseq[:40]} != {e_sub[:40]}")
            if not gex:
                for name, cand in cands:
                    rname, fields = split_name(name, reads)
                    ok = rname is not None and name in sub_names
                    if ok:
                        _, _, sq, a = self._slideseq_spans(*reads[rname],
                                                           fields)
                        fwd = _rc(cand)
                        ok = len(cand) > 45 and sq.find(fwd, max(0, a)) >= 0
                    if ok:
                        fwds.append(fwd)
                        fnames.append(name)
                    else:
                        cand_bad += self._bad("candidate_mismatch",
                                              f"{name}: {cand}")
        if gex:
            ed, gs, ge = self._scan(windows, self.ch["pick_last"])
            for k, (w, name) in enumerate(zip(windows, wnames)):
                hit = 0 <= ed[k] < self.ch["max_ed_exclusive"]
                e_cand = w[gs[k]:min(ge[k], len(w))] if hit else None
                got = cand_of.get(name, [])
                if e_cand is None or e_cand not in got:
                    cand_bad += self._bad("candidate_mismatch",
                                          f"{name}: {got} != {e_cand}")
        else:
            ed, _, _ = self._scan(fwds, False)
            for k, name in enumerate(fnames):
                if not 0 <= ed[k] < self.ch["max_ed_exclusive"]:
                    cand_bad += self._bad("candidate_mismatch",
                                          f"{name}: no linker")
        return sub_bad, cand_bad


    # ---- the drawn reads, aligned and cut again ---------------------------

    def _flank_scan(self, windows: list) -> tuple:
        """(dist, start, end) of the adapter in each flank window (codes),
        over sub-windows where the chemistry scans them, the first that
        hits winning."""
        win = self.ch["windows"]
        texts = [_ASCII[w].tobytes() for w in windows]
        if not win:
            return self._scan(texts, self.ch["pick_last"])
        size, stride = win["size"], win["stride"]
        n_win = (self.ch["flank"]["hi"] - self.ch["flank"]["lo"]) // stride
        subs = [t[i * stride:i * stride + size] if i < len(t) // stride
                else b"" for t in texts for i in range(n_win)]
        ed, gs, ge = (x.reshape(len(texts), n_win) for x in self._scan(
            subs, self.ch["pick_last"]))
        out = np.full((3, len(texts)), -1, np.int64)
        for r in range(len(texts)):
            hit = np.flatnonzero(ed[r] >= 0)
            if len(hit):
                i = hit[0]
                out[:, r] = ed[r, i], gs[r, i] + i * stride, \
                    ge[r, i] + i * stride
        return out[0], out[1], out[2]

    def _expected(self, rname, seq, qual, recs, sample) -> tuple:
        """The subreads [(name, seq, qual)] and candidates [(name, seq)]
        that the chemistry's rules cut from one read's records."""
        ch, sub, fl = self.ch, self.ch["subread"], self.ch["flank"]
        codes = plain.encode(seq[:self.max_len])
        n = len(codes)
        quals = np.frombuffer(qual[:n], np.uint8)
        rows = []
        for r in recs:
            st = r["strand"]
            sc = plain.revcomp_codes(codes) if st else codes
            sqs = n - r["qend"] if st else r["qstart"]
            sqe = n - r["qstart"] if st else r["qend"]
            a = sqs if fl["anchor"] == "qstart" else sqe
            w0, w1 = max(a + fl["lo"], 0), min(a + fl["hi"], n)
            rows.append((r, st, sc, sqs, sqe, sc[w0:max(w0, w1)]))
        ed, gs, ge = self._flank_scan([x[5] for x in rows])
        subs, cands = [], []
        for k, (r, st, sc, sqs, sqe, win) in enumerate(rows):
            hit = 0 <= ed[k] < ch["max_ed_exclusive"]
            trans = self.panel.names[r["ref"]]
            lo = (sqs if sub["start"] == "qstart" else sqe) + sub["start_ofs"]
            hi = (sqs if sub["end"] == "qstart" else sqe) + sub["end_ofs"]
            if sub["start_clamp0"]:
                lo = max(lo, 0)
            ok = max(hi - lo, 0) > sub["min_len"] if sub["min_len"] else True
            if sub["requires"] == "adapter":
                ok &= hit
            elif sub["requires"] == "span400":
                ok &= r["tend"] - r["tstart"] > 400
            if ch["name_format"] == "qstart_qend":
                name = f"{rname}_{r['qstart']}_{r['qend']}_{r['flag']}_{trans}"
            else:
                name = f"{rname}_{sample}_{lo}_{hi}_{r['flag']}_{trans}"
            if ok:
                c0, c1 = max(lo, 0), min(hi, n)
                q = quals[::-1] if st else quals
                subs.append((name, _ASCII[sc[c0:c1]].tobytes()
                             if c1 > c0 else b"",
                             q[c0:c1].tobytes() if c1 > c0 else b""))
            take = hit and (ok or not ch["bcumi_in_subread"])
            if not take:
                continue
            b0, b1 = int(gs[k]), int(ge[k])
            if ch["bcumi_rule"] == "slice":
                cand = _ASCII[win[b0:min(b1, len(win))]].tobytes()
            else:                                   # rev_slideseq
                b0, b1 = max(b0 - 22, 0), min(b1 + 16, len(win))
                cand = _rc(_ASCII[win[b0:max(b0, b1)]].tobytes())
                pa = min(max(b0 + 5, 0), len(win))
                a_frac = (win[:pa] == plain.A).sum() / pa if pa else 0.0
                take = len(cand) > 45 and (pa < 70 or (pa > 70 and
                                                       a_frac > 0.5))
            if take:
                cands.append((name, cand))
        return subs, cands

    def drawn_reads(self, samples, rng) -> int:
        """Subreads and candidates of the drawn reads that the program and
        the reference do not share."""
        pool = [(k, nm) for k, s in enumerate(samples) for nm in s["reads"]]
        pick = rng.permutation(len(pool))[:self.cfg["check"]["reads_drawn"]]
        pick = [pool[i] for i in sorted(pick)]
        codes = [plain.encode(samples[k]["reads"][nm][0][:self.max_len])
                 for k, nm in pick]
        recs = align.records(self.panel, codes, self.max_len)
        bad = 0
        for (k, nm), rr in zip(pick, recs):
            s = samples[k]
            seq, qual = s["reads"][nm]
            e_sub, e_cand = self._expected(nm, seq, qual, rr, s["sample"])
            got_sub = s["by_read"]["sub"].get(nm, [])
            got_cand = s["by_read"]["cand"].get(nm, [])
            for what, e, g in (("subread", e_sub, got_sub),
                               ("candidate", e_cand, got_cand)):
                miss = Counter(e) - Counter(g)
                extra = Counter(g) - Counter(e)
                for x in list(miss.elements()) + list(extra.elements()):
                    bad += self._bad("drawn_read_mismatch", (
                        f"{what} {x[0]} "
                        f"{'missing' if x in miss else 'not expected'}"))
        return bad

    # ---- the drawn VDJ subreads, called again ---------------------------

    def cdr3_calls(self, samples, rng) -> int:
        ct = self.cfg["clonotyper"]
        pool, width = [], {}
        for k, s in enumerate(samples):
            subs = read_fastq_records(s["subreads"])
            s["_subs"] = subs
            for b0 in range(0, len(subs), ct["batch_size"]):
                blk = subs[b0:b0 + ct["batch_size"]]
                L = min(max(len(q) for _, q, _ in blk), ct["max_len"])
                w = 128
                while w < L:
                    w *= 2
                for j in range(b0, b0 + len(blk)):
                    width[(k, j)] = min(w, ct["max_len"])
            pool += [(k, j) for j in range(len(subs))]
        pick = rng.permutation(len(pool))[:self.cfg["check"]["subreads_drawn"]]
        pick = [pool[i] for i in sorted(pick)]
        calls = self.caller.calls(
            [(samples[k]["_subs"][j][0],
              samples[k]["_subs"][j][1][:ct["max_len"]]) for k, j in pick],
            [width[p] for p in pick])
        bad, tables = 0, {}
        for (k, j), (kind, chain, nt) in zip(pick, calls):
            s = samples[k]
            if k not in tables:
                out, sm = s["outdir"], s["sample"]
                cl = pd.read_table(f"{out}/{sm}_clones.txt.gz",
                                   keep_default_na=False)
                cid = pd.read_table(f"{out}/{sm}_cloneID.txt.gz",
                                    keep_default_na=False)
                tables[k] = (
                    dict(zip(cid.descrsR1, zip(cid.cloneId.astype(int),
                                               cid.chains))),
                    dict(zip(cl.cloneId.astype(int),
                             zip(cl.chains, cl.nSeqImputedCDR3))))
            ids, clones = tables[k]
            name = s["_subs"][j][0]
            got = ids.get(name)
            clone = clones.get(got[0]) if got else None
            if got is None:
                wrong = kind == "clean"
            else:
                wrong = (kind is None or clone is None or got[1] != chain
                         or clone[0] != chain
                         or not vdj.clone_fits(kind, nt, clone[1]))
            if wrong:
                bad += self._bad("cdr3_call_mismatch", (
                    f"{name}: reference {kind} {chain} {nt}, program "
                    f"{got} {clone}"))
        return bad

    # ---- verdicts -----------------------------------------------------------

    def _padded(self, idx) -> np.ndarray:
        """The padded whitelist rows N^pad_left + core + N^pad_right."""
        bs = self.bs
        core = self.core[:, idx].T
        n = core.shape[0]
        return np.concatenate(
            [np.full((n, bs["pad_left"]), plain.N, np.int8), core,
             np.full((n, bs["pad_right"]), plain.N, np.int8)], axis=1)

    def _near_list(self, seqs: list, dist: int) -> np.ndarray:
        """Whether each candidate holds, on either strand, a window within
        `dist` (0 or 1) substitutions of a barcode of the list."""
        L = self.bs["bc_len"]
        n = len(seqs)
        codes, lens = plain.encode_rows(seqs, max(L, self.bs["match_lq"]))
        j = np.arange(codes.shape[1])[None]
        src = np.clip(lens[:, None] - 1 - j, 0, codes.shape[1] - 1)
        rc = np.where(j < lens[:, None],
                      plain.COMP[np.take_along_axis(codes, src, 1)], plain.PAD)
        w = np.lib.stride_tricks.sliding_window_view(
            np.concatenate([codes, rc]), L, axis=1)
        ok = (w < 4).all(axis=2)
        keys = (w.astype(np.int64) * 4 ** np.arange(L - 1, -1, -1)).sum(2)
        if dist:
            flips = (np.arange(1, 4)[:, None] << (2 * np.arange(L))[None])
            keys = keys[..., None] ^ flips.reshape(-1)
            ok = np.broadcast_to(ok[..., None], keys.shape)
        at = np.searchsorted(self.bc_keys, keys).clip(0, len(self.bc_keys) - 1)
        near = ((self.bc_keys[at] == keys) & ok).reshape(2 * n, -1).any(1)
        return near[:n] | near[n:]

    def verdicts(self, samples, rng) -> int:
        """Every accepted (and bad-UMI) candidate against the row of the
        barcode it was given: the score, and the UMI at the position the
        row's alignment puts at the UMI column. Then a drawn sample of
        candidates matched again against every row on both strands:
        uniform, and, for a list the staged match enumerates (no linker),
        as many again among the candidates with no window within one
        substitution of a barcode on either strand, which its tiers cannot
        settle and which go to its one-vs-all DP."""
        bs = self.bs
        rows = []                      # (candidate bytes, program row)
        bad = 0
        for s in samples:
            cands = plain.read_fasta_records(s["bcumi"])
            df = pd.read_csv(s["assignments"], keep_default_na=False,
                             dtype={"name": str, "bc": str, "umi": str})
            if len(df) != len(cands) or any(
                    a != n for a, (n, _) in zip(df.name, cands)):
                bad += self._bad("verdict_mismatch",
                                 "assignments and candidates differ")
                continue
            for (n, c), r in zip(cands, df.itertuples(index=False)):
                rows.append((c[:bs["match_lq"]], r))
        bad += self._given_rows(rows)
        chk = self.cfg["check"]
        pick = list(rng.permutation(len(rows))[:chk["verdicts_uniform"]])
        if chk["verdicts_hard"] and not bs["slideseq_linker"]:
            order, hard = rng.permutation(len(rows)), []
            for b0 in range(0, len(order), 512):
                blk = order[b0:b0 + 512]
                seqs = [rows[i][0] for i in blk]
                far = ~self._near_list(seqs, 0)
                far[far] = ~self._near_list(
                    [q for q, f in zip(seqs, far) if f], 1)
                hard += list(blk[far])
                if len(hard) >= chk["verdicts_hard"]:
                    break
            pick += hard[:chk["verdicts_hard"]]
        if pick:
            bad += self._best_rows(rows, pick)
        return bad

    def _given_rows(self, rows) -> int:
        bs = self.bs
        at = {b: i for i, b in enumerate(self.bcs.tolist())}
        given = [k for k, (_, r) in enumerate(rows)
                 if int(r.status) in (ACCEPT, BAD_UMI)]
        bad = 0
        known = []
        for k in given:
            if rows[k][1].bc in at:
                known.append(k)
            else:
                bad += self._bad("verdict_mismatch",
                                 f"{rows[k][1].name}: barcode "
                                 f"{rows[k][1].bc} not in the list")
        if not known:
            return bad
        q, ql = plain.encode_rows([rows[k][0] for k in known],
                                  bs["match_lq"])
        prow = self._padded(np.asarray([at[rows[k][1].bc] for k in known]))
        score, qpos = plain.umi_positions(q, ql, prow, bs["umi_ref_offset"],
                                          device=self.device)
        L = bs["umi_len"]
        for j, k in enumerate(known):
            seq, r = rows[k]
            ok = 0 <= qpos[j] and qpos[j] + L <= ql[j]
            umi = seq[qpos[j]:qpos[j] + L].decode() if ok else ""
            st = int(r.status)
            if int(r.score) != score[j] or (st == ACCEPT) != ok or (
                    st == ACCEPT and r.umi != umi):
                bad += self._bad("verdict_mismatch", (
                    f"{r.name}: {st}/{r.score}/{r.bc}/{r.umi}, its row "
                    f"scores {score[j]} with UMI {umi!r}"))
        return bad

    def _best_rows(self, rows, pick) -> int:
        bs = self.bs
        seqs = [rows[i][0] for i in pick]
        q, ql = plain.encode_rows(seqs, bs["match_lq"])
        qr = np.full_like(q, plain.PAD)
        for i, n in enumerate(ql):
            qr[i, :n] = plain.revcomp_codes(q[i, :n])
        dev = self.device
        core = torch.from_numpy(self.core).to(dev)
        qq = torch.from_numpy(np.concatenate([q, qr])).to(dev)
        qql = torch.from_numpy(np.concatenate([ql, ql])).to(dev)
        best, idx, ties = plain.best_rows(qq, qql, core, bs["pad_left"],
                                          bs["pad_right"])
        del core, qq, qql
        n = len(pick)
        fb, rb = best[:n], best[n:]
        uniq = (ql > 0) & (rb < fb) & (ties[:n] == 1) & (fb >= bs["as_min"])
        u = np.flatnonzero(uniq)
        _, qps = plain.umi_positions(q[u], ql[u], self._padded(idx[u]),
                                     bs["umi_ref_offset"],
                                     device=self.device)
        qpos_of = dict(zip(u.tolist(), qps.tolist()))
        bad = 0
        for k, i in enumerate(pick):
            got = rows[i][1]
            e_bc = e_umi = ""
            e_score = fb[k]
            if ql[k] == 0:
                st = NO_CAND
            elif rb[k] > fb[k]:
                st = RC_BEST
            elif rb[k] == fb[k] or ties[k] > 1:
                st = MULTIMAP
            elif fb[k] < bs["as_min"]:
                st = LOW_AS
            else:
                qpos = qpos_of[k]
                ok = qpos >= 0 and qpos + bs["umi_len"] <= ql[k]
                st = ACCEPT if ok else BAD_UMI
                e_bc = str(self.bcs[idx[k]])
                if ok:
                    e_umi = seqs[k][qpos:qpos + bs["umi_len"]].decode()
            wrong = int(got.status) != st
            if st in (ACCEPT, LOW_AS, BAD_UMI):
                wrong |= int(got.score) != int(e_score)
            if st in (ACCEPT, BAD_UMI):
                wrong |= got.bc != e_bc
            if st == ACCEPT:
                wrong |= got.umi != e_umi
            if wrong:
                bad += self._bad("verdict_mismatch", (
                    f"{got.name}: got {got.status}/{got.score}/{got.bc}/"
                    f"{got.umi}, reference {st}/{e_score}/{e_bc}/{e_umi}"))
        return bad

    # ---- dedup, BAM, clones -----------------------------------------------

    @staticmethod
    def _accepted(path):
        df = pd.read_csv(path, keep_default_na=False,
                         dtype={"name": str, "bc": str, "umi": str})
        return df[df.status == ACCEPT]

    def dedup(self, samples) -> int:
        bad = 0
        for s in samples:
            acc = self._accepted(s["assignments"])
            exp = {}
            for bc, g in acc.groupby("bc"):
                exp[bc] = (g.umi.nunique(), len(g))
            got_df = pd.read_csv(s["dedup"], keep_default_na=False,
                                 dtype={"bc": str})
            got = {r.bc: (int(r.umi_cnt), int(r.read_cnt))
                   for r in got_df.itertuples(index=False)}
            for k in set(exp) | set(got):
                if exp.get(k) != got.get(k):
                    bad += self._bad("dedup_mismatch",
                                     f"{k}: {got.get(k)} != {exp.get(k)}")
            cnt = got_df.umi_cnt.to_numpy()
            for _ in range(int((np.diff(cnt) > 0).sum())):  # descending
                bad += self._bad("dedup_mismatch", "rows out of order")
        return bad

    def bam(self, samples) -> int:
        bad = 0
        gnames = list(self.genome)
        for s in samples:
            reads = s["reads"]
            acc = self._accepted(s["assignments"])
            tag = {n: (b, u) for n, b, u in zip(acc.name, acc.bc, acc.umi)}
            subs = {n: q for n, q, _ in read_fastq_records(s["subreads"])}
            refs, recs = plain.read_bam(s["bam"])
            last = (-1, -1)
            for r in recs:
                why = []
                if (r["ref_id"], r["pos"]) < last:
                    why.append("unsorted")
                last = (r["ref_id"], r["pos"])
                name, seq, tags = r["name"], r["seq"].encode(), r["tags"]
                _, fields = split_name(name, reads)
                if fields is None or name not in tag or name not in subs:
                    why.append("not an accepted subread")
                else:
                    if (tags.get("CB"), tags.get("UB")) != tag[name]:
                        why.append(f"CB/UB {tags.get('CB')}/{tags.get('UB')}"
                                   f" != {tag[name]}")
                    if tags.get("XT") != fields.split("_", 3)[3]:
                        why.append(f"XT {tags.get('XT')}")
                    if seq not in (subs[name], _rc(subs[name])):
                        why.append("SEQ is not the subread")
                    if refs[r["ref_id"]] != gnames[r["ref_id"]]:
                        why.append("reference name")
                    else:
                        f = self._cigar_fault(r, seq,
                                              self.genome[refs[r["ref_id"]]])
                        if f:
                            why.append(f"CIGAR {f}: {r['cigar'][:12]} at "
                                       f"{r['pos']}")
                if why:
                    bad += self._bad("bam_mismatch",
                                     f"{name}: {'; '.join(why)}")
        return bad

    @staticmethod
    def _cigar_fault(r, seq: bytes, ref: bytes) -> str:
        """Why the CIGAR is wrong, or "": it must span the sequence, its =
        and X operations must agree with the reference, and NM must count
        the edits inside the exon blocks (an insertion right after an N is
        the query between two blocks, which the genome stage leaves out of
        NM)."""
        qi, ti, nm = 0, r["pos"], 0
        prev = None
        for k, (n, op) in enumerate(r["cigar"]):
            if op in "=X" and ti + n > len(ref):
                return f"op {k} {n}{op} runs past the reference"
            if op == "=" and seq[qi:qi + n] != ref[ti:ti + n]:
                return f"op {k} {n}= differs from the reference at {ti}"
            if op == "X" and any(a == b for a, b in zip(seq[qi:qi + n],
                                                        ref[ti:ti + n])):
                return f"op {k} {n}X equals the reference at {ti}"
            if op in "=XMIS":
                qi += n
            if op in "=XMDN":
                ti += n
            if op in "XD" or (op == "I" and prev != "N"):
                nm += n
            prev = op
        if qi != len(seq):
            return f"spans {qi} of {len(seq)} bases"
        if ti > len(ref):
            return "ends past the reference"
        if nm != r["tags"].get("NM"):
            return f"NM {r['tags'].get('NM')}, edits {nm}"
        return ""

    def clones(self, samples) -> int:
        bad = 0
        for s in samples:
            out, sm = s["outdir"], s["sample"]
            cl = pd.read_table(f"{out}/{sm}_clones.txt.gz",
                               keep_default_na=False)
            cid = pd.read_table(f"{out}/{sm}_cloneID.txt.gz",
                                keep_default_na=False)
            for c, n, a in zip(cl.cloneId, cl.nSeqImputedCDR3,
                               cl.aaSeqImputedCDR3):
                if translate(n) != a:
                    bad += self._bad("clone_mismatch",
                                     f"clone {c}: {a} != translate({n})")
            members = cid.cloneId.value_counts()
            for c, n in zip(cl.cloneId, cl.cloneCount):
                if int(members.get(c, 0)) != int(round(float(n))):
                    bad += self._bad("clone_mismatch",
                                     f"clone {c}: count {n}, "
                                     f"{members.get(c, 0)} reads")
            subs = {n for n, _, _ in read_fastq_records(s["subreads"])}
            for r in cid.descrsR1[~cid.descrsR1.isin(subs)]:
                bad += self._bad("clone_mismatch", f"no subread {r}")
            keep = cid[cid.cloneId.isin(cl.cloneId)]
            acc = self._accepted(s["assignments"])
            exp = keep.merge(acc, left_on="descrsR1", right_on="name")
            exp = sorted(zip(exp.chains, exp.cloneId.astype(int), exp.bc,
                             exp.umi))
            got = pd.read_csv(f"{out}/{sm}_clone_bcumi.csv.gz",
                              keep_default_na=False,
                              dtype={"bc": str, "umi": str})
            got = sorted(zip(got.chains, got.cloneId.astype(int), got.bc,
                             got.umi))
            for a, b in itertools.zip_longest(exp, got):
                if a != b:
                    bad += self._bad("clone_mismatch", f"join {b} != {a}")
        return bad

    # ---- all of it ----------------------------------------------------------

    def check(self, samples, seed: int) -> dict:
        """The numbers compared, by name, over the window's samples."""
        rng = np.random.default_rng([int(seed) % (1 << 64), 99])
        out = {"reads_missing": 0}
        for s in samples:
            try:
                with open(s["runstats"]) as f:
                    st = json.load(f)
                n = next(x["reads"] for x in st["stages"]
                         if x["stage"] == "align_decon")
            except (OSError, StopIteration, KeyError, ValueError):
                n = 0
            out["reads_missing"] += abs(len(s["reads"]) - n)
        out["subread_mismatch"], out["candidate_mismatch"] = \
            self.subreads(samples)
        out["drawn_read_mismatch"] = self.drawn_reads(samples, rng)
        out["verdict_mismatch"] = self.verdicts(samples, rng)
        if "dedup_mismatch" in self.cfg["limits"]:
            out["dedup_mismatch"] = self.dedup(samples)
        if "bam_mismatch" in self.cfg["limits"]:
            out["bam_mismatch"] = self.bam(samples)
        if "clone_mismatch" in self.cfg["limits"]:
            out["clone_mismatch"] = self.clones(samples)
        if "cdr3_call_mismatch" in self.cfg["limits"]:
            out["cdr3_call_mismatch"] = self.cdr3_calls(samples, rng)
        return out
