#!/usr/bin/env python3
"""Readings for the limits that decide ``correct``: the port on many seeds and the
control (the reference in the precision below the configuration's, in the port's
place) on a few, each taken from the cell's own system, through the same loop and the
same check as a run, each with a short window at the cell's own load.
One process, so set-up's imports and builds are paid once.

    python3 portbench/calibrate.py --workload fig8-surveil --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 4 [--reg 1e-2] [--out portbench/_out/cal.jsonl]

Each reading is a JSON line: the system, the seed, the numbers compared and, as
witnesses (``--witness``), the count of repeated memory vectors, and the largest
residual gaps to the float64 reference of the port's ``train`` and ``estimate`` and of
the reference in float32 over the distinct memory vectors alone.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--reg", type=float, default=None)
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--out", default=str(HERE / "_out" / "calibrate.jsonl"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    from portbench import harness, reference, telemetry

    cell = harness.load_cell(args.workload)
    systems = harness.systems(cell)
    if args.reg is not None:
        cell.config = dict(cell.config, reg=args.reg)
    cfg = cell.config
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    plan = [("port", int(s)) for s in args.seeds.split(",") if s]
    plan += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    with open(args.out, "a") as out:
        for system, seed in plan:
            t = time.perf_counter()
            run = harness.run(cell, seed, args.seconds, False, sut=systems[system]())
            rec = {"workload": cell.name, "reg": cfg["reg"], "system": system, "seed": seed,
                   "units": run.units, "checks": run.checks, "phases": run.phases,
                   "memory_peak_bytes": run.memory_peak_bytes,
                   "check_peak_bytes": run.check_peak_bytes,
                   "seconds": time.perf_counter() - t}
            if args.witness:
                rec["witness"] = witness(cell, seed, torch, reference, telemetry)
            line = json.dumps(rec)
            print(line, flush=True)
            out.write(line + "\n")
            del run
            torch.cuda.empty_cache()
    return 0


def witness(cell, seed, torch, reference, telemetry) -> dict:
    """Repeated memory vectors in the cell's first training set, and the largest gap,
    in reference residual sigmas, of the float32 reference over the distinct memory
    vectors against the float64 reference, on the first batch of observations."""
    cfg, dev = cell.config, torch.device("cuda")
    n_tr = cfg["n_train"]
    b = cfg.get("surveil_batch", 8192)
    X = telemetry.series(seed, n_tr + 2 * b, cfg["n_signals"], cfg["telemetry"], dev)
    mean, std = reference.standardization(X[:n_tr])
    idx = reference.memory_indices((X[:n_tr] - mean) / std, cfg["n_memvec"])
    repeated = int(idx.numel() - torch.unique(idx).numel())
    x = X[n_tr + b :].clone()
    r64 = reference.estimate(reference.train(X[:n_tr], cfg["n_memvec"], cfg["kind"], cfg["reg"]), x)
    m32 = reference.train(X[:n_tr], cfg["n_memvec"], cfg["kind"], cfg["reg"],
                          dtype=torch.float32, distinct=True)
    r32 = reference.estimate(m32, x)
    del m32
    from repro_torch.mset import mset2

    port = mset2.estimate(mset2.train(X[:n_tr], cfg["n_memvec"], kind=cfg["kind"], reg=cfg["reg"]), x)[1]
    sigma = torch.std(r64, dim=0, correction=0)
    return {"repeated_memory_vectors": repeated,
            "distinct_f32_gap": float(((r32.double() - r64).abs() / sigma).max()),
            "port_gap": float(((port.double() - r64).abs() / sigma).max()),
            "port_sigma_over_reference": float(port.std() / r64.std())}


if __name__ == "__main__":
    sys.exit(main())
