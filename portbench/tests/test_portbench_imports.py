"""What the harness's process loads, and how run.py refuses to run."""

import json
import os
import subprocess
import sys

import pytest

import harness
from conftest import checkout

ROOT = harness.ROOT


@pytest.fixture()
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: run.py would run the cell")


def test_run_refuses_without_a_card(no_card):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "xcr3p_slideseq_beads.slideseq_xcr", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_refuses_a_checkout_of_the_benchmark_alone(tmp_path):
    checkout(tmp_path, [], {})
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "gex5p_737k.k562_fusion_4k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    with pytest.raises(harness.SetupError):
        harness.run_cell("gex5p_737k.k562_fusion_4k", 1, 1, False,
                         device="cpu", root=str(tmp_path))


def test_a_dry_run_loads_no_jax(tmp_path):
    """After a whole run on the CPU no loaded module's top-level name is
    jax, jaxlib, flax or nanoranger_tpu (compared whole: the port's name
    begins with the JAX package's)."""
    root = checkout(tmp_path / "checkout", [
        "samples", "XR_C_mouse.fa", "TR_V_mouse.fa", "IG_V_mouse.fa",
        "slideseq.matched.barcodes.tsv.gz"], {
        "workloads/xcr3p_slideseq_beads.slideseq_xcr": {
            "reads_per_sample": 40, "warmup_per_bucket": [2, 1, 1, 1]},
        "configs/xcr3p_slideseq_beads": {"check": {"verdicts_uniform": 2}}})
    code = f"""
import json, os, sys
sys.path.insert(0, {os.path.join(ROOT, 'portbench')!r})
os.environ["TMPDIR"] = {str(tmp_path)!r}
import harness
res = harness.run_cell("xcr3p_slideseq_beads.slideseq_xcr", 3, 0.01, False,
                       device="cpu", root={root!r})
tops = {{m.split(".")[0] for m in sys.modules}}
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                  "port": "nanoranger_torch" in tops,
                  "correct": res["correct"]}}))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == {"forbidden": [], "port": True, "correct": True}


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    """One short run of the slideseq cell on the card: a result line with
    the card's name and correct true."""
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "xcr3p_slideseq_beads.slideseq_xcr", "--seed",
                        str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
