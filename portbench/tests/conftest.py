"""Tests of the benchmark (portbench/). They import no JAX. Run from the
repository's root:

    python -m pytest portbench/tests -q

Tests marked `cuda` need an NVIDIA card and skip without one (decided in
the `card` fixture, never while a module is imported)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


def checkout(root, data: list, edits: dict) -> str:
    """A checkout at `root` for a run on the CPU: BENCHMARK.json, a copy of
    portbench/ with `edits` ({"configs/<name>" or "workloads/<name>":
    {key: value}}) merged into its JSON files, and data/ holding links to
    the files named in `data`."""
    import json
    import shutil
    os.makedirs(root, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH_DIR, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for rel, changes in edits.items():
        path = os.path.join(root, "portbench", rel + ".json")
        with open(path) as f:
            doc = json.load(f)
        for k, v in changes.items():
            doc[k] = {**doc[k], **v} if isinstance(v, dict) else v
        with open(path, "w") as f:
            json.dump(doc, f)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    for rel in data:
        os.symlink(os.path.join(ROOT, "data", rel),
                   os.path.join(root, "data", rel))
    return str(root)


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")
