"""The benchmark of nanoranger_torch: whole samples through the CLI's body.

One run of a cell:

1. Set-up (timed as setup_s, from the process's start): imports, CUDA,
   the kernel and host libraries (built into nanoranger_torch/_build/
   inside the checkout by the first run there), the run's seeded samples
   written under TMPDIR, and one warm-up sample that reaches every length
   bucket and every stage of the cell.
2. The window: `nanoranger_torch.pipeline.run_pipeline` on one whole sample
   at a time, back to back, each into a fresh outdir, the pool's samples in
   turn, until the sample running at `seconds` completes. Every sample
   builds its own whitelist tables and indexes, as a CLI invocation does.
   reads_per_s is the reads of all samples over the window's wall.
3. With trace=1, the second sample of the window runs under
   torch.profiler; the per-layer metrics are read from the other samples'
   run statistics and from that sample's device trace.
4. The check: the window's outputs against the plain reference
   (reference/judge.py), after the card's peak has been read and the
   program's state freed; each outdir is deleted after it.

Configurations, traffic and per-layer metrics are files found by name:
configs/<config>.json, workloads/<cell>.json, metrics/<metric>.py.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nanoranger_tpu")
SAMPLE = "s"                 # the expname of every sample run


class SetupError(Exception):
    """The checkout cannot run the cell (a file or the program missing)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell `name`: its traffic file, its configuration file, and the
    metrics of BENCHMARK.json that it reports."""
    here = os.path.join(root, "portbench")
    wpath = os.path.join(here, "workloads", f"{name}.json")
    if not os.path.isfile(wpath):
        raise SetupError(f"no traffic file for cell {name!r}: {wpath}")
    workload = load_json(wpath)
    cfg = load_json(os.path.join(here, "configs",
                                 f"{workload['config']}.json"))
    bench = load_json(os.path.join(root, "BENCHMARK.json"))

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"name": name, "workload": workload, "config": cfg,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def load_metric(name: str, root: str = ROOT):
    """The reader module metrics/<name>.py (its `read(run)`)."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    if spec is None or not os.path.isfile(path):
        raise SetupError(f"no reader for metric {name!r}: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# --------------------------------------------------------------------------
# spans and launch records, from the benchmark's own wrappers

class Recorder:
    """Host spans around the pipeline's stage calls, and the launch shapes
    of K1 (ops/chain.chain_dp) and K4 (ops/whitelist_verify.verify_all)
    while `launches_on` is set. Installed by wrapping the names that the
    port's modules look up at call time."""

    STAGES = {"DeconRun": "align_decon", "_matcher": "whitelist_tables",
              "match_barcodes": "barcode_match", "dedup_outputs": "dedup",
              "genome_stage": "genome_tag",
              "_ensure_clonotypes": "clonotypes"}

    def __init__(self):
        self.spans: list = []          # (stage, t0_ns, t1_ns)
        self.launches = {"k1": [], "k4": []}
        self.launches_on = False

    def install(self) -> list:
        """Wrap the stage calls and the two kernels' entry points; returns
        the (object, attribute, original) triples that undo it."""
        import torch
        from nanoranger_torch import pipeline
        from nanoranger_torch.ops import chain, whitelist_verify

        undo = []
        for attr, stage in self.STAGES.items():
            fn = getattr(pipeline, attr)
            undo.append((pipeline, attr, fn))
            setattr(pipeline, attr, self._span(stage, fn, torch))
        undo += self._wrap_everywhere(chain.chain_dp, self._k1)
        undo += self._wrap_everywhere(whitelist_verify.verify_all, self._k4)
        return undo

    def _span(self, stage, fn, torch):
        def wrapped(*a, **kw):
            t0 = time.time_ns()
            try:
                with torch.profiler.record_function(f"portbench.{stage}"):
                    return fn(*a, **kw)
            finally:
                self.spans.append((stage, t0, time.time_ns()))
        return wrapped

    @staticmethod
    def _wrap_everywhere(fn, make) -> list:
        wrapped = make(fn)
        undo = []
        for mod in list(sys.modules.values()):
            name = getattr(mod, "__name__", "") or ""
            if name.split(".")[0] != "nanoranger_torch":
                continue
            for k, v in list(vars(mod).items()):
                if v is fn:
                    undo.append((mod, k, fn))
                    setattr(mod, k, wrapped)
        return undo

    def _k1(self, fn):
        def wrapped(*a, **kw):
            t, valid = a[0], a[3]
            max_intron = a[7] if len(a) > 7 else kw.get("max_intron", 0)
            if self.launches_on and valid.is_cuda:
                self.launches["k1"].append((tuple(t.shape), valid,
                                            bool(max_intron)))
            return fn(*a, **kw)
        return wrapped

    def _k4(self, fn):
        def wrapped(*a, **kw):
            q, qlen, coreT = a[:3]
            if self.launches_on and q.is_cuda:
                self.launches["k4"].append((tuple(q.shape), qlen,
                                            tuple(coreT.shape)))
            return fn(*a, **kw)
        return wrapped


def undo_patches(undo: list) -> None:
    for obj, attr, orig in reversed(undo):
        setattr(obj, attr, orig)


# --------------------------------------------------------------------------
# the device trace of one sample

def device_trace(prof, t0_ns: int, t1_ns: int, spans: list) -> dict:
    """Busy time, kernel time by name, and the idle gaps of the card over
    [t0_ns, t1_ns], from the profiler's raw device events (kernels, copies
    and sets). Each gap is labelled by the stage span the host was in."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    iv, by_name, counts = [], {}, {}
    for e in prof.profiler.kineto_results.events():
        # kernels, copies and sets; not the ranges of record_function
        if e.device_type() != cuda or e.is_user_annotation() or \
                e.name().startswith("portbench."):
            continue
        s, d = e.start_ns(), e.duration_ns()
        iv.append((s, s + d))
        nm = e.name()
        by_name[nm] = by_name.get(nm, 0) + d
        counts[nm] = counts.get(nm, 0) + 1
    iv.sort()
    merged = []
    for s, e in iv:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps, prev = [], t0_ns
    for s, e in merged + [[t1_ns, t1_ns]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)

    # cut each gap at the stage spans' edges and label each piece by the
    # stage the host was in
    edges = sorted({t for _, s0, s1 in spans for t in (s0, s1)})
    pieces = []
    for a, b in gaps:
        cuts = [a] + [t for t in edges if a < t < b] + [b]
        for x, y in zip(cuts, cuts[1:]):
            mid = (x + y) // 2
            where = [st for st, s0, s1 in spans if s0 <= mid < s1]
            pieces.append((y - x, where[-1] if where else "between stages"))
    pieces.sort(key=lambda p: -p[0])
    return {"busy_s": busy / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
            "kernel_ns": by_name, "kernel_n": counts,
            "idle_gaps": [[nm, d / 1e9] for d, nm in pieces[:10]],
            "device_ops": [[k, v / 1e9] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]]}


# --------------------------------------------------------------------------
# one run

def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault: str | None = None,
             t_start: float | None = None, root: str = ROOT) -> dict:
    """One run of cell `name` from the checkout at `root`; returns the
    result object (without the process-level checks of run.py).
    device='cpu' runs the kernels' plain versions, for tests on a machine
    with no card."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root)
    cfg, wl = cell["config"], cell["workload"]
    for rel in (wl["sample"], wl["trns_ref"], cfg["whitelist"],
                wl.get("genome_ref"),
                *cfg.get("clonotyper", {}).get("v_panels", [])):
        if rel and not os.path.isfile(os.path.join(root, rel)):
            raise SetupError(f"missing input {rel!r} under {root}")
    if root not in sys.path:
        sys.path.insert(1, root)
    try:
        import torch

        from nanoranger_torch import pipeline
    except ImportError as e:
        raise SetupError(f"the program cannot be imported: {e}") from e
    from reference.judge import Judge

    import faults

    rec = Recorder()
    undo = rec.install()
    try:
        if fault:
            undo += faults.apply(fault)
        return _run(cell, cfg, wl, seed, seconds, trace, device, root, rec,
                    t_start, torch, pipeline, Judge)
    finally:
        undo_patches(undo)


def _run(cell, cfg, wl, seed, seconds, trace, device, root, rec, t_start,
         torch, pipeline, Judge) -> dict:
    # under the run's TMPDIR, or inside the checkout where none is set
    work = os.path.join(os.environ.get("TMPDIR") or
                        os.path.join(root, ".portbench_cache"),
                        "portbench_run")
    if os.path.isdir(work):
        shutil.rmtree(work)
    os.makedirs(work)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    paths, reads = traffic.make_samples(root, wl, seed,
                                        os.path.join(work, "in"))

    def run_sample(path, outdir):
        with contextlib.redirect_stdout(sys.stderr):
            pipeline.run_pipeline(
                cfg["mode"], path, outdir, SAMPLE,
                trns_ref=os.path.join(root, wl["trns_ref"]),
                genome_ref=(os.path.join(root, wl["genome_ref"])
                            if wl.get("genome_ref") else None),
                barcodes=os.path.join(root, cfg["whitelist"]),
                batch_size=cfg["batch_size"], device=device,
                fast=None if cfg["fused"] else False)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    run_sample(paths["warmup"], os.path.join(work, "warmup"))
    shutil.rmtree(os.path.join(work, "warmup"))
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")

    done, failed_reads, prof_sample = [], 0, None
    t_win = time.perf_counter()
    i = 0
    while True:
        path = paths["pool"][i % len(paths["pool"])]
        outdir = os.path.join(work, f"out{i}")
        profiled = trace and i == 1
        n_spans = len(rec.spans)
        t0 = time.perf_counter()
        try:
            if profiled:
                from torch.profiler import ProfilerActivity, profile
                rec.launches_on = True
                acts = ([ProfilerActivity.CUDA] if dev.type == "cuda" else
                        [ProfilerActivity.CPU])
                with profile(activities=acts) as prof:
                    # the traced window: the sample alone, without the
                    # profiler's start and the gathering of its buffers
                    t0_ns = time.time_ns()
                    run_sample(path, outdir)
                    t1_ns = time.time_ns()
                rec.launches_on = False
                prof_sample = {"prof": prof, "t0_ns": t0_ns,
                               "t1_ns": t1_ns,
                               "spans": rec.spans[n_spans:]}
            else:
                run_sample(path, outdir)
            ok = True
        except Exception:                      # a sample that fails counts
            traceback.print_exc()
            rec.launches_on = False
            ok = False
        t1 = time.perf_counter()
        done.append({"path": path, "outdir": outdir, "ok": ok,
                     "profiled": profiled, "seconds": t1 - t0,
                     "reads": len(reads[path])})
        if not ok:
            failed_reads += len(reads[path])
        i += 1
        if t1 - t_win >= seconds and (not trace or i >= 3):
            break
    window_s = time.perf_counter() - t_win
    n_reads = sum(d["reads"] for d in done)
    log(f"window {window_s:.3f} s, {len(done)} samples, {n_reads} reads")

    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
    found = forbidden_modules()
    metrics, dev_out, breakdown = {}, {}, None
    if not trace:
        vals = {"reads_per_s": n_reads / window_s, "setup_s": setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    else:
        stats = []
        for d in done:
            if d["ok"] and not d["profiled"]:
                stats.append(load_json(os.path.join(
                    d["outdir"], f"{SAMPLE}_runstats.json")))
        dtrace = None
        if prof_sample is not None:
            dtrace = device_trace(prof_sample["prof"], prof_sample["t0_ns"],
                                  prof_sample["t1_ns"], prof_sample["spans"])
            dtrace["launches"] = {
                "k1": [(s, int(v.sum()), sp) for s, v, sp in
                       rec.launches["k1"]],
                "k4": [(s, int(ql.sum()), c) for s, ql, c in
                       rec.launches["k4"]]}
            del prof_sample["prof"]
            dev_out = {"busy_s": dtrace["busy_s"],
                       "window_s": dtrace["window_s"]}
            breakdown = {"device_ops": dtrace["device_ops"],
                         "idle_gaps": dtrace["idle_gaps"]}
        run = {"stats": stats,
               "reads": sum(d["reads"] for d in done
                            if d["ok"] and not d["profiled"]),
               "device": dtrace}
        for m in cell["per_layer"]:
            v = load_metric(m["name"], root).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    rec.launches = {"k1": [], "k4": []}
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check, once the window has closed and the card's peak is read
    t_chk = time.perf_counter()
    judge = Judge(root, cfg, wl, device)
    sub_kind = cfg["chemistry"]["subread_file"]
    samples = []
    for d in done:
        o = d["outdir"]
        samples.append({
            "reads": {n: (s, q) for n, s, q in reads[d["path"]]},
            "outdir": o, "sample": SAMPLE,
            "runstats": f"{o}/{SAMPLE}_runstats.json",
            "subreads": f"{o}/{SAMPLE}_{sub_kind}.fastq.gz",
            "bcumi": f"{o}/{SAMPLE}_BCUMI.fasta.gz",
            "assignments": f"{o}/{SAMPLE}_assignments.csv.gz",
            "dedup": f"{o}/{SAMPLE}_bcumi_dedup.csv",
            "bam": f"{o}/{SAMPLE}_genome_tagged.bam"})
    try:
        numbers = judge.check(samples, seed)
    except Exception:              # an output the check cannot read
        traceback.print_exc()
        numbers = {k: None for k in cfg["limits"]}
    for k, ex in judge.examples.items():
        for e in ex:
            log(f"{k}: {e}")
    log(f"check {time.perf_counter() - t_chk:.3f} s")
    written = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, fs in os.walk(work) for f in fs)
    shutil.rmtree(work, ignore_errors=True)

    checks = {k: {"value": numbers.get(k), "limit": lim}
              for k, lim in cfg["limits"].items()}
    correct = (failed_reads == 0 and not found and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    return {
        "correct": correct, "attempted": n_reads,
        "failed": failed_reads + int(numbers.get("reads_missing") or 0),
        "metrics": metrics,
        "device": ({"platform": "gpu", "kind": torch.cuda.get_device_name(),
                    "count": 1, "memory_peak_bytes": int(peak), **dev_out}
                   if dev.type == "cuda" else
                   {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0, **dev_out}),
        **({"breakdown": breakdown} if breakdown else {}),
        "forbidden_modules": found,
        "samples": [d["seconds"] for d in done],
        "window_bytes_on_disk": written,
        "card": _card_line() if dev.type == "cuda" else "cpu",
        "checks": checks}
