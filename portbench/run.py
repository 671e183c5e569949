"""Run one cell of the benchmark of nanoranger_torch on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--fault control|half_batch|alter_answer]

Prints the run's result as the last line of standard output (one JSON
object) and, as the last lines of standard error, each number that the
check compared beside its limit. Exits non-zero, printing no result, when
there is no CUDA card (or fewer than the cell asks for), when the checkout
lacks the program or its data, or when a JAX module was loaded.

--fault applies the control or a planted fault (portbench/faults.py): the
check must then come out false. A measured run never passes it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# a kernel cache at a fixed path inside the checkout, should the program
# ever compile through Triton
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, ".portbench_cache", "triton"))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    a = p.parse_args(argv)

    import harness
    try:
        cell = harness.load_cell(a.workload)
    except (harness.SetupError, OSError, KeyError, ValueError) as e:
        print(f"[portbench] cannot load cell {a.workload!r}: {e}",
              file=sys.stderr)
        return 3
    import torch
    need = cell["config"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"[portbench] needs {need} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        res = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                               fault=a.fault, t_start=T_START)
    except harness.SetupError as e:
        print(f"[portbench] {e}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"[portbench] JAX modules loaded in the measured process: "
              f"{found}", file=sys.stderr)
        return 4
    for m in cell["per_layer"]:
        if m["unit"] == "%" and m["name"] in res["metrics"]:
            print(f"[portbench] {m['name']} = "
                  f"{res['metrics'][m['name']]['value']} % "
                  f"(card: {res['card']})", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"[portbench] check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"[portbench] correct = {res['correct']}", file=sys.stderr,
          flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
