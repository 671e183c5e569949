"""Data x whitelist sharding: candidates over a 'data' axis, the whitelist
over a 'wl' axis, on a mesh of torch devices driven by one process.

Counterpart of the JAX package's parallel/sharded.py. A mesh is an
(n_data, n_wl) grid of torch.device cells:

  axis 'data' — candidate batches split into n_data contiguous blocks; the
                per-barcode accepted counts sum over this axis
  axis 'wl'   — the whitelist partitioned into n_wl equal shards; each shard
                resolves its local barcodes exactly (tier hash passes +
                exhaustive one-vs-all DP, stages/barcode semantics) and the
                per-read summaries are gathered to the block's first cell
                for the global unique-best decision

The merge is exact because every shard-local quantity merges losslessly:
tier hits OR over disjoint shards, DP bests MAX with tie counts summed at
the global best and the smallest global index winning, and the
reverse-strand best MAXes. A sharded run is bit-identical to the
single-device BarcodeMatcher (tests/test_torch_sharded.py).

Cells are laid over the devices given (by default every visible card); with
fewer devices than cells they are laid round-robin, so several cells may
share one device. Placement changes no output. On a CUDA cell the shard
runs the one-vs-all DP kernel (csrc/verify.cu) once per chunk and the
winner's banded UMI rescore (csrc/sw_banded.cu) on its owning shard; on a
CPU cell the DP's host twin (or its plain version) and the rescore over the
full padded row. The match's steps are spans under the single-device
matcher's names (trace.py): match.tiers, match.dp (the rescore included)
and match.verdicts (the gather included).

build_sharded_align is the data-parallel front of the entry's dry
run (entry.dryrun_multichip): each data block is seeded, chained and
adapter-scanned on its own cell, and the candidates gathered in read order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import trace
from ..align.aligner import prepare_index_arrays, seed_and_chain
from ..chemistry import BarcodeMatchSpec
from ..io import whitelist as wl
from ..io.encode import COMPLEMENT, PAD, encode, encode_batch
from ..ops.edit_distance import hw_locate
from ..ops.sw import sw_end2end
from ..ops.whitelist_verify import NEG, verify_all
from ..stages.barcode import (ACCEPT, N_TIERS, BarcodeMatcher,
                              boundary_flags, combine_verdicts, revcomp_rows,
                              tier_hits)
from ..stages.decon import _gather_flanks
from ..stages.device_step import _device_records

BIGI = 1 << 30
# candidate rows per tier pass: the full tier classes hold thousands of
# int64 window keys a row, so a chunk bounds the pass's memory, as in
# BarcodeMatcher's second pass
TIER_CHUNK = BarcodeMatcher.PASS2_CHUNK

def log(msg: str):
    print(f"[nanoranger-torch] {msg}", flush=True)


class Mesh:
    """An (n_data, n_wl) grid of torch devices."""

    def __init__(self, cells):
        self.cells = [list(row) for row in cells]

    @property
    def shape(self) -> tuple:
        return len(self.cells), len(self.cells[0])

    def cell(self, d: int, w: int) -> torch.device:
        return self.cells[d][w]

    @property
    def devices(self) -> list:
        """The distinct devices of the mesh, in cell order."""
        return list(dict.fromkeys(c for row in self.cells for c in row))


def mesh_devices(device=None) -> list:
    """The devices a mesh is laid over: every visible card for None or an
    unnumbered CUDA device, else the one device given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device is visible for the mesh; pass "
                "devices=[torch.device('cpu')] (device='cpu') to lay it "
                "on the CPU")
        return [torch.device("cuda", i) for i in range(n)]
    return [dev]


def make_mesh(n_data: int, n_wl: int, devices=None) -> Mesh:
    """(n_data, n_wl) mesh over `devices` (default: every visible card);
    with fewer devices than cells the cells are laid round-robin."""
    if n_data < 1 or n_wl < 1:
        raise ValueError(f"mesh axes must be >= 1, got {n_data}x{n_wl}")
    devs = ([torch.device(d) for d in devices] if devices is not None
            else mesh_devices())
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    n = n_data * n_wl
    if len(devs) < n:
        log(f"{n_data}x{n_wl} mesh: {n} cells laid round-robin over "
            f"{len(devs)} device(s)")
    flat = [devs[i % len(devs)] for i in range(n)]
    return Mesh([flat[d * n_wl:(d + 1) * n_wl] for d in range(n_data)])


class ShardedWhitelist:
    """Whitelist partitioned over the 'wl' axis: per-shard padded refs
    (winner UMI rescore), core columns (exhaustive DP), and sorted
    exact/ins1 key tables (tier passes).  Shards pad to equal size;
    padding rows are masked by n_real / idx<0 sentinels."""

    def __init__(self, barcodes: np.ndarray, spec: BarcodeMatchSpec,
                 n_wl: int, dp_chunk: int = 256):
        self.spec = spec
        self.n_wl = n_wl
        self.dp_chunk = dp_chunk
        n = len(barcodes)
        per = -(-n // n_wl)
        pad_bc = "A" * spec.bc_len
        padded = list(barcodes) + [pad_bc] * (per * n_wl - n)
        self.n_total = n
        self.per_shard = per
        self.barcodes = np.asarray(padded)
        self.core_len = spec.umi_ref_offset - spec.pad_left
        refs_list, core_list = [], []
        for s in range(n_wl):
            shard = self.barcodes[s * per:(s + 1) * per]
            refs_np, ref_len = wl.padded_refs(shard, spec)
            refs_list.append(refs_np)
            core_list.append(np.ascontiguousarray(
                refs_np[:, spec.pad_left:spec.umi_ref_offset].T))
            self.ref_len = int(ref_len)
        self.refs = np.stack(refs_list)                   # (n_wl, per, Lr)
        self.coreT = np.stack(core_list)                  # (n_wl, m, per)
        # number of real (non-pad) barcodes per shard
        self.n_real = np.minimum(
            np.maximum(n - per * np.arange(n_wl), 0), per).astype(np.int32)

        # per-shard sorted key tables (tier passes). Padding rows get
        # sentinel key 0xFFFFFFFF with idx -1 (never counted); stable
        # real-first ordering keeps searchsorted-left correct even if a
        # real barcode shares the sentinel key value.
        self.exact = None
        if not spec.slideseq_linker and spec.bc_len <= 16:
            ek = np.full((n_wl, per), 0xFFFFFFFF, np.uint32)
            ei = np.full((n_wl, per), -1, np.int32)
            rk = np.full((n_wl, per), 0xFFFFFFFF, np.uint32)
            ri = np.full((n_wl, per), -1, np.int32)
            # boundary-truncation tables (stages/barcode.boundary_flags):
            # per-shard sorted keys of the 1-/2-truncated cores; the
            # 0xFFFFFFFF sentinel exceeds every (m-1)/(m-2)-char key, so
            # pad rows never match
            bnd_names = ("b_suf1", "b_suf2", "b_pre1", "b_pre2",
                         "b_rc_suf1", "b_rc_suf2", "b_rc_pre1",
                         "b_rc_pre2")
            bnd = {k: np.full((n_wl, per), 0xFFFFFFFF, np.uint32)
                   for k in bnd_names}

            def pk(cds):
                k = np.zeros(cds.shape[0], np.uint32)
                for t in range(cds.shape[1]):
                    k = (k << np.uint32(2)) | cds[:, t].astype(np.uint32)
                return np.sort(k)

            for s in range(n_wl):
                nr = int(self.n_real[s])
                shard = self.barcodes[s * per: s * per + nr]
                codes, _ = encode_batch([b for b in shard],
                                        max_len=spec.bc_len)
                rc_codes = COMPLEMENT[codes][:, ::-1]
                keys = np.zeros(nr, np.uint32)
                rkeys = np.zeros(nr, np.uint32)
                for t in range(spec.bc_len):
                    keys = (keys << np.uint32(2)) | codes[:, t].astype(np.uint32)
                    rkeys = (rkeys << np.uint32(2)) | \
                        rc_codes[:, t].astype(np.uint32)
                order = np.argsort(keys, kind="stable")
                ek[s, :nr] = keys[order]
                ei[s, :nr] = order
                rk[s, :nr] = np.sort(rkeys)
                ri[s, :nr] = 0
                for name, cds in (("b_suf1", codes[:, 1:]),
                                  ("b_suf2", codes[:, 2:]),
                                  ("b_pre1", codes[:, :-1]),
                                  ("b_pre2", codes[:, :-2]),
                                  ("b_rc_suf1", rc_codes[:, 1:]),
                                  ("b_rc_suf2", rc_codes[:, 2:]),
                                  ("b_rc_pre1", rc_codes[:, :-1]),
                                  ("b_rc_pre2", rc_codes[:, :-2])):
                    bnd[name][s, :nr] = pk(cds)
            self.exact = {"ex_keys": ek, "ex_idx": ei, "rc_ex_keys": rk,
                          "rc_ex_idx": ri, **bnd}

    def device_arrays(self, mesh: Mesh) -> list:
        """arrs[d][w]: shard w's tensors on cell (d, w); cells on one device
        share one copy. Key tables and ids are int64 (torch.searchsorted
        takes no uint32); `bnd` holds the 8 boundary tables in
        boundary_flags' order, forward strand first."""
        if mesh.shape[1] != self.n_wl:
            raise ValueError(f"the mesh has {mesh.shape[1]} wl cells, the "
                             f"whitelist {self.n_wl} shards")
        cache: dict = {}

        def shard_on(w, dev):
            if (w, dev) not in cache:
                put = lambda a: torch.from_numpy(
                    np.ascontiguousarray(a)).to(dev)
                s = {"refs": put(self.refs[w]), "coreT": put(self.coreT[w])}
                if self.exact is not None:
                    e = {k: put(v[w].astype(np.int64))
                         for k, v in self.exact.items()}
                    s.update({k: v for k, v in e.items()
                              if not k.startswith("b_")})
                    s["bnd"] = tuple(v for k, v in e.items()
                                     if k.startswith("b_"))
                cache[(w, dev)] = s
            return cache[(w, dev)]

        return [[shard_on(w, mesh.cell(d, w)) for w in range(self.n_wl)]
                for d in range(mesh.shape[0])]


def build_sharded_match(swl: ShardedWhitelist, mesh: Mesh):
    """Whitelist matcher over the mesh: candidates split over 'data' in
    contiguous blocks, the whitelist over 'wl'. Returns fn(q, qlen, arrs)
    -> (bc, score, status, umi, counts) on cell (0, 0): q (B, Lq) int8 and
    qlen (B,) with B a multiple of n_data, arrs from swl.device_arrays(mesh),
    counts (n_wl, per) the accepted reads per local barcode summed over the
    blocks."""
    spec = swl.spec
    per = swl.per_shard
    m = swl.core_len
    rlen_s = swl.ref_len
    bl = spec.bc_len
    n_data, n_wl = mesh.shape
    n_real = [int(x) for x in swl.n_real]

    def gather(xs, home):
        """(n_wl, n) stack of the shards' values on the block's home cell."""
        return torch.stack([x.to(home) for x in xs])

    def tier_pass(d, on, arrs, home):
        """Global tier summaries of one row chunk (its copies per device in
        `on`): each shard's tier hits and boundary flags, merged."""
        fwd_l, rc_l, fl_l = [], [], []
        for w in range(n_wl):
            q, qlen = on[mesh.cell(d, w)]
            a = arrs[d][w]
            fwd_l.append(tier_hits(q, qlen, a["ex_keys"], a["ex_idx"],
                                   bl, spec.pad_left, spec.pad_right))
            rc_l.append(tier_hits(q, qlen, a["rc_ex_keys"],
                                  a["rc_ex_idx"], bl, spec.pad_right,
                                  spec.pad_left, any_only=True))
            # boundary-truncated structures bypass the tier summaries
            # and resolve through the DP (free core entry/exit at the
            # query edges, stages/barcode.boundary_flags)
            fl = boundary_flags(q, qlen, a["bnd"][:4], bl,
                                spec.pad_left, spec.pad_right)
            fl_l.append(fl | boundary_flags(q, qlen, a["bnd"][4:], bl,
                                            spec.pad_right,
                                            spec.pad_left))
        return merge_tiers(fwd_l, rc_l, fl_l, on[home][1], home)

    def merge_tiers(fwd_l, rc_l, fl_l, qlen, home):
        """any = OR over shards; multi = any shard multi OR hits in >= 2
        shards (shard ids are disjoint, so cross-shard hits are distinct);
        the smallest global id wins and its eqpos rides along."""
        keep = ~(gather(fl_l, home).any(dim=0) |
                 ((qlen > 0) & (qlen <= bl + 1)))
        fwd_g, rc_g = [], []
        hit = torch.zeros_like(keep)
        for t in range(N_TIERS):
            anys = gather([f[t][0] for f in fwd_l], home)
            any_t = anys.any(dim=0) & keep
            multi_t = gather([f[t][1] for f in fwd_l], home).any(dim=0) | \
                (anys.sum(dim=0) >= 2)
            ids = gather([torch.where(f[t][2] >= 0, f[t][2] + w * per, BIGI)
                          for w, f in enumerate(fwd_l)], home)
            win = ids.argmin(dim=0, keepdim=True)
            ebc_t = ids.gather(0, win)[0]
            eq_t = gather([f[t][3] for f in fwd_l], home).gather(0, win)[0]
            fwd_g.append((any_t, multi_t, torch.where(any_t, ebc_t, -1),
                          eq_t))
            r_t = gather([r[t] for r in rc_l], home).any(dim=0) & keep
            rc_g.append(r_t)
            hit = hit | any_t | r_t
        return fwd_g, rc_g, hit

    def dp_chunk(d, rows_on, on, arrs, home):
        """Exhaustive DP of one chunk of flagged rows on every shard, merged:
        best fwd/rc MAX, ties SUM at the global best, smallest global index
        among the best shards; the winner's UMI rescored on its owner."""
        fbs, rbs, fis, fts, qs_w = [], [], [], [], []
        for w in range(n_wl):
            c = mesh.cell(d, w)
            q, qlen = on[c]
            rows = rows_on[c]
            qs = q[rows].contiguous()
            qls = qlen[rows]
            n = qs.shape[0]
            best, idx, ties = verify_all(
                torch.cat([qs, revcomp_rows(qs, qls)]).contiguous(),
                torch.cat([qls, qls]), arrs[d][w]["coreT"], n_real[w],
                spec.pad_left, spec.pad_right)
            fbs.append(best[:n])
            rbs.append(best[n:])
            fis.append(torch.where(idx[:n] >= 0, idx[:n] + w * per,
                                   BIGI))
            fts.append(ties[:n])
            qs_w.append((qs, qls))
        fbg = gather(fbs, home)
        fb = fbg.max(dim=0).values
        at_best = fbg == fb[None]
        ties = torch.where(at_best, gather(fts, home), 0).sum(dim=0)
        fi = torch.where(at_best, gather(fis, home),
                         BIGI).min(dim=0).values
        rb = gather(rbs, home).max(dim=0).values
        qpos, uval = rescore(d, qs_w, fi, arrs, home)
        return (fb, torch.where(fi < BIGI, fi, -1), ties.to(torch.int32), rb,
                qpos, uval)

    def rescore(d, qs_w, fi, arrs, home):
        """The winner's UMI position, rescored on the shard owning it."""
        qpos = torch.full_like(fi, -1)
        uval = torch.zeros(fi.shape, dtype=torch.bool, device=home)
        for w in range(n_wl):
            li = fi - w * per
            own = torch.nonzero((li >= 0) & (li < per))[:, 0]
            if own.numel() == 0:
                continue
            c = mesh.cell(d, w)
            qs, qls = qs_w[w]
            sel = own.to(c)
            ref_rows = arrs[d][w]["refs"][li[own].to(c).long()]
            rlen = torch.full((own.numel(),), rlen_s, dtype=torch.int32,
                              device=c)
            # the banded kernel on a card; the full padded row on the CPU
            band = dict(pad_left=spec.pad_left, full_len=rlen_s) \
                if c.type == "cuda" else {}
            _, qp, uv = sw_end2end(qs[sel], qls[sel], ref_rows, rlen,
                                   spec.umi_ref_offset, **band)
            qpos[own] = qp.to(home)
            uval[own] = uv.to(home)
        return qpos, uval

    def block(d, q, qlen, arrs):
        """Block d on the cells (d, *); results on cell (d, 0)."""
        home = mesh.cell(d, 0)
        on = {}
        for w in range(n_wl):
            c = mesh.cell(d, w)
            if c not in on:
                on[c] = (q.to(c), qlen.to(c))
        qh, qlh = on[home]
        B = qh.shape[0]
        i32 = torch.int32

        tiers = None
        tier_hit = torch.zeros(B, dtype=torch.bool, device=home)
        if swl.exact is not None and B:
            trace.count("match.rows_full_class", B)
            with trace.span("match.tiers"):
                parts = []
                for lo in range(0, B, TIER_CHUNK):
                    sub = {c: (x[lo:lo + TIER_CHUNK], y[lo:lo + TIER_CHUNK])
                           for c, (x, y) in on.items()}
                    parts.append(tier_pass(d, sub, arrs, home))
                fwd = [tuple(torch.cat([p[0][t][k] for p in parts])
                             for k in range(4)) for t in range(N_TIERS)]
                rc = [torch.cat([p[1][t] for p in parts])
                      for t in range(N_TIERS)]
                tier_hit = torch.cat([p[2] for p in parts])
            tiers = (fwd, rc)

        # exhaustive DP tail over the rows with no tier structure, chunked
        need = (qlh > 0) & ~tier_hit
        with trace.span("match.dp"):
            flagged = torch.nonzero(need)[:, 0]
            trace.count("match.rows_dp", flagged.numel())
            fb = torch.full((B,), NEG, dtype=i32, device=home)
            fidx = torch.full((B,), -1, dtype=i32, device=home)
            fties = torch.zeros(B, dtype=i32, device=home)
            rb = torch.full((B,), NEG, dtype=i32, device=home)
            fqpos = torch.full((B,), -1, dtype=i32, device=home)
            fuval = torch.zeros(B, dtype=torch.bool, device=home)
            flagged_on = {c: flagged.to(c) for c in on}
            for lo in range(0, flagged.numel(), swl.dp_chunk):
                rows = flagged[lo:lo + swl.dp_chunk]
                rows_on = {c: f[lo:lo + swl.dp_chunk]
                           for c, f in flagged_on.items()}
                (fb[rows], fidx[rows], fties[rows], rb[rows], fqpos[rows],
                 fuval[rows]) = dp_chunk(d, rows_on, on, arrs, home)

        with trace.span("match.verdicts"):
            bc, score, status, umi, _ = combine_verdicts(
                qh, qlh, spec, m, tiers,
                (need, fb, fidx, fties, rb, fqpos, fuval))
            acc = bc[status == ACCEPT].long()
            counts = torch.bincount(acc, minlength=n_wl * per).to(i32)
        return bc, score, status, umi, counts.reshape(n_wl, per)

    def fn(q, qlen, arrs):
        q = torch.as_tensor(np.ascontiguousarray(q, np.int8)) \
            if isinstance(q, np.ndarray) else q
        qlen = torch.as_tensor(np.asarray(qlen, np.int32)) \
            if isinstance(qlen, np.ndarray) else qlen.to(torch.int32)
        B = q.shape[0]
        if B % n_data:
            raise ValueError(f"{B} candidates do not split into {n_data} "
                             "equal data blocks")
        nb = B // n_data
        out = [block(d, q[d * nb:(d + 1) * nb], qlen[d * nb:(d + 1) * nb],
                     arrs) for d in range(n_data)]
        root = mesh.cell(0, 0)
        with trace.span("match.verdicts"):
            cat = lambda k: torch.cat([o[k].to(root) for o in out])
            counts = sum(o[4].to(root) for o in out)
            return cat(0), cat(1), cat(2), cat(3), counts

    return fn


class ShardedMatcher:
    """BarcodeMatcher's match over a (data x wl) mesh laid on `devices`
    (the JAX package's pipeline._sharded_match_fn): each batch is padded to
    a multiple of n_data and the pad rows dropped. build_s is the seconds
    of the whitelist's shard tables and their upload."""

    bc_strings = BarcodeMatcher.bc_strings

    def __init__(self, barcodes: np.ndarray, spec: BarcodeMatchSpec,
                 wl_shards: int, data_shards: int, devices):
        t0 = time.time()
        self.mesh = make_mesh(data_shards, wl_shards, devices)
        self.swl = ShardedWhitelist(barcodes, spec, wl_shards)
        self.arrs = self.swl.device_arrays(self.mesh)
        self.fn = build_sharded_match(self.swl, self.mesh)
        self.barcodes = self.swl.barcodes
        self.build_s = time.time() - t0
        log(f"sharded whitelist: {self.swl.n_total} rows in {wl_shards} "
            f"shards of {self.swl.per_shard} ({self.build_s:.1f}s)")

    def match(self, q: np.ndarray, qlen: np.ndarray) -> dict:
        n = q.shape[0]
        trace.count("match.rows", n)
        n_pad = -(-n // self.mesh.shape[0]) * self.mesh.shape[0] - n
        if n_pad:
            q = np.pad(q, ((0, n_pad), (0, 0)))
            qlen = np.pad(qlen, (0, n_pad))
        bc, score, status, umi, _ = self.fn(q, qlen, self.arrs)
        return {"bc_idx": bc.cpu().numpy()[:n],
                "score": score.cpu().numpy()[:n],
                "status": status.cpu().numpy()[:n],
                "umi": umi.cpu().numpy()[:n]}


def build_sharded_align(spec, index, mesh, max_minimizers=128, S=2):
    """Data-parallel candidate extraction: the reads split into n_data
    contiguous blocks, block d aligned on the mesh's cell (d, 0) (seed ->
    chain DP -> the device step's top-S chain slots -> the adapter scan of
    each slot's flank window, hw_locate over the whole window), the
    candidates gathered to cell (0, 0) in read order. Returns fn(codes,
    lengths) -> (cand (B*S, 96) int8, blen (B*S,) int32, hit (B*S,) bool);
    B must be a multiple of n_data."""
    n_data = mesh.shape[0]
    homes = [mesh.cell(d, 0) for d in range(n_data)]
    on = {c: (prepare_index_arrays(index, c),
              torch.from_numpy(np.ascontiguousarray(
                  encode(spec.scan.pattern))).to(c))
          for c in dict.fromkeys(homes)}
    f = spec.flank
    sc = spec.scan
    Lc = 96
    Wmax = f.hi - f.lo
    i32 = torch.int32

    def block(codes, lengths, dev):
        idx_arrays, pat = on[dev]
        B = codes.shape[0]
        chain_out = seed_and_chain(codes, lengths, *idx_arrays,
                                   max_minimizers=max_minimizers)
        rec = _device_records(chain_out, lengths, S)
        R = B * S
        ok = rec["ok"].reshape(R)
        window, wlen, _ = _gather_flanks(
            codes, lengths,
            torch.arange(B, dtype=i32, device=dev).repeat_interleave(S),
            rec["strand"].reshape(R), rec["qstart"].reshape(R),
            rec["qend"].reshape(R), 0 if f.anchor == "qstart" else 1, f.lo,
            f.hi)
        pad = torch.tensor(PAD, dtype=torch.int8, device=dev)
        window = torch.where(ok[:, None], window, pad).contiguous()
        ed, gs, ge = hw_locate(pat, window, wlen, sc.k,
                               wildcard=sc.n_wildcard,
                               pick_last=sc.pick_last)
        hit = (ed >= 0) & (ed < sc.max_ed_exclusive) & ok
        jj = torch.arange(Lc, dtype=i32, device=dev)[None]
        bidx = (gs[:, None] + jj).clamp(0, Wmax - 1)
        blen = torch.where(hit, (ge - gs).clamp(0, Lc), 0).to(i32)
        cand = torch.where(jj < blen[:, None],
                           window.gather(1, bidx.long()), pad)
        return cand, blen, hit

    def fn(codes, lengths):
        codes = (codes if isinstance(codes, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(codes, np.int8)))
        lengths = (lengths if isinstance(lengths, torch.Tensor)
                   else torch.from_numpy(np.asarray(lengths, np.int32)))
        B = codes.shape[0]
        if B % n_data:
            raise ValueError(f"{B} reads do not split into {n_data} equal "
                             "data blocks")
        nb = B // n_data
        out = [block(codes[d * nb:(d + 1) * nb].to(homes[d]).contiguous(),
                     lengths[d * nb:(d + 1) * nb].to(homes[d], i32),
                     homes[d]) for d in range(n_data)]
        root = mesh.cell(0, 0)
        return tuple(torch.cat([o[k].to(root) for o in out])
                     for k in range(3))

    return fn
