#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload fig8-surveil --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. The last line of standard output is the result (JSON);
standard error carries set-up's phases, the clock samples, the window's first- and
last-quarter times and, last, each number that decides ``correct`` beside its limit.
With ``--trace 1`` the window runs under ``torch.profiler`` and the result holds the
cell's per-layer metrics in place of its end-to-end ones.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(HERE / "_cache" / sub))
    sys.path[:0] = [str(REPO / "src"), str(REPO)]

    import torch

    from portbench import harness, stats

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); {n} available", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    run = harness.run(cell, args.seed, args.seconds, bool(args.trace), t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process, and not allowed: {found}", file=sys.stderr)
        return 3
    result = harness.result(run, torch.cuda.get_device_name(0), cell.chips)
    log = sys.stderr
    print(f"phases: {json.dumps(run.phases)}", file=log)
    print(f"card: {json.dumps(run.card)} clocks: {json.dumps(run.clocks)}", file=log)
    first, last = stats.quarter_means(run.intervals_ms or [float("nan")])
    print(f"units {run.units}, window {run.window_s:.4f} s; mean ms a unit, first quarter "
          f"{first:.4f}, last quarter {last:.4f}", file=log)
    print(f"memory peak: window {run.memory_peak_bytes} B, check {run.check_peak_bytes} B",
          file=log)
    if run.trace is not None:
        print(f"trace: {len(run.trace.ops)} device ops, {len(run.trace.host)} host events",
              file=log)
    shown = {k: v for k, v in run.checks.items() if k not in result["checks"]}
    print(f"not compared: {json.dumps(shown)}", file=log)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=log)
    log.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
