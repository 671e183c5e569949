"""Build every library a run of the port loads, ahead of the run.

Counterpart of the JAX package's AOT executable cache (runtime/aot_cache.py
and the prewarm tool that fills it). Eager torch compiles no program per
shape, so the port's only cold-start build is its libraries: the Hopper
kernels (kernels.py, nvcc) and the host C++ (runtime/native_lib.py, g++),
each cached under a digest of its sources and flags in
nanoranger_torch/_build/. This tool builds whichever are missing, so the
first run finds them built, and leaves a _build/ that a deployment can ship
(the host libraries are built without -march=native).

Usage: python -m nanoranger_torch.tools.prewarm

Prints one JSON line per library: its path, whether this call built it or
found it built, and the seconds its build took (the kernels build side by
side, one nvcc each, so they share one wall time). On a host without nvcc
the kernels are skipped and said so. Exits non-zero when a build failed.
"""

from __future__ import annotations

import json
import os
import sys
import time

from .. import kernels
from ..runtime import native_lib


def prewarm(log=print) -> bool:
    """Build every missing library, logging one JSON line each. Returns
    False when a build failed."""
    root = os.path.dirname(os.path.dirname(kernels.BUILD_ROOT))
    ok = True
    try:
        nvcc = kernels.nvcc_path()
    except RuntimeError as e:
        nvcc = None
        log(json.dumps({"libraries": sorted(kernels.SOURCES),
                        "kind": "cuda", "skipped": str(e)}))
    if nvcc is not None:
        found = {n: os.path.isfile(kernels.lib_path(n))
                 for n in kernels.SOURCES}
        t0 = time.time()
        try:
            paths = kernels.build_all()
            error = None
        except RuntimeError as e:
            paths, error, ok = {}, str(e), False
        secs = round(time.time() - t0, 3)
        for name in kernels.SOURCES:
            log(json.dumps({
                "library": name, "kind": "cuda",
                "path": os.path.relpath(kernels.lib_path(name), root),
                "built": not found[name] and name in paths,
                "seconds": 0.0 if found[name] else secs,
                **({"error": error} if error else {})}))
    for name in native_lib.LIBS:
        path = native_lib._lib_path(name)
        had = os.path.isfile(path)
        t0 = time.time()
        error = native_lib.build(name)
        ok = ok and error is None
        log(json.dumps({
            "library": name, "kind": "host",
            "path": os.path.relpath(path, root),
            "built": not had and error is None,
            "seconds": round(time.time() - t0, 3),
            **({"error": error} if error else {})}))
    return ok


def main() -> int:
    return 0 if prewarm() else 1


if __name__ == "__main__":
    sys.exit(main())
