#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload census-rejection-x10 --seed 7 \
        --seconds 10 --trace 0

Prints the result as one JSON object on the last line of standard output,
and each number the check compared beside its limit as the last lines of
standard error.  With ``--trace 0`` the metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from a profiled window.
Exits with a code other than 0, and prints no result, where the machine
lacks the cards the cell needs, where the port cannot be imported, or
where JAX or the JAX package was loaded.

``--control`` runs the port's own bfloat16 path for its gathers and costs
(the precision below the configuration's float32), and ``--fault NAME``
plants a fault of `portbench/faults.py` under the window's requests: the
check must find either run not correct.  The benchmark's own runs pass
neither.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _fail(msg: str, code: int) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    from portbench import harness
    from portbench.isolation import forbidden_modules

    cell, _ = harness.find_cell(harness.load_manifest(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device: the benchmark measures the card only", 3)
    if torch.cuda.device_count() < int(cell["chips"]):
        _fail(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", 3)
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), control=args.control,
                              fault=args.fault, t_start=T_START)
    found = forbidden_modules()
    if found:
        _fail(f"forbidden modules loaded: {', '.join(found)}", 4)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
