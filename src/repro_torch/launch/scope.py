"""ContainerStress CLI on the card — the paper's workflow end to end.

Measured MSET2 scoping (paper Figs. 4-5, wall-clock Monte Carlo):

    PYTHONPATH=src python -m repro_torch.launch.scope --mset --grid small
    PYTHONPATH=src python -m repro_torch.launch.scope --mset --grid small --device cpu

Analytic LM scoping (``run_lm``) walks the catalog from 64 chips up, so it waits for
the port's ``distributed/``; one chip's analytic rows come from
``launch.dryrun`` and ``ContainerStress.run_analytic``.
"""

from __future__ import annotations

import argparse
import json
import os
import zlib

from repro_torch._device import f32_matmul_highest, resolve_device
from repro_torch.core import (
    ContainerStress,
    fit_response_surface,
    grid_to_matrix,
    render_ascii_surface,
)
from repro_torch.configs.mset_paper import SURVEILLANCE_GRID_1024
from repro_torch.mset import estimate, train
from repro_torch.tpss import TPSSParams, synthesize

GRIDS = {
    "small": {"n_signals": [8, 16, 32], "n_memvec": [64, 128, 256], "n_observations": [1024]},
    "paper": {
        "n_signals": [32, 64, 128, 256],
        "n_memvec": [128, 256, 512, 1024],
        "n_observations": [4096],
    },
}

# The widest cell of paper Fig. 8 (SURVEILLANCE_GRID_1024): 1024 signals, 8192 memory
# vectors, 65,536 surveilled observations.
FULL_WIDTH_CELL = {k: max(v) for k, v in SURVEILLANCE_GRID_1024.items()}


def cell_seed(params: dict) -> int:
    """A seed for a grid cell that is the same in every process (``hash`` of a str is not)."""
    return zlib.crc32(repr(sorted(params.items())).encode())


def scoping_split(params: dict) -> tuple[int, int]:
    """Scoping figures (paper Figs. 4-5): train on the first 75% of ``n_observations``
    and surveil the rest."""
    n_tr = int(params["n_observations"] * 0.75)
    return n_tr, params["n_observations"] - n_tr


def surveillance_split(params: dict) -> tuple[int, int]:
    """Surveillance figures (paper Figs. 7-8): train on 2 * n_memvec observations (as the
    JAX package's benchmarks size training) and surveil the next ``n_observations``."""
    return 2 * params["n_memvec"], params["n_observations"]


def mset_workload(device=None, split=scoping_split):
    """workload_fn for ``ContainerStress.run_measured``: each cell synthesizes one asset's
    telemetry on ``device``; one run trains MSET2 on the first ``n_train`` observations and
    surveils the next ``n_surveil``, returning the residuals, where
    ``(n_train, n_surveil) = split(params)``."""
    dev = resolve_device(device)

    def workload(params):
        n_tr, n_surv = split(params)
        X = synthesize(
            cell_seed(params),
            TPSSParams(n_signals=params["n_signals"], n_obs=n_tr + n_surv),
            device=dev,
        )

        def run():
            m = train(X[:n_tr], n_memvec=params["n_memvec"])
            _, r = estimate(m, X[n_tr:])
            return r

        return run

    return workload


def run_mset(grid, reps: int = 3, out: str = "", device=None, verbose: bool = True):
    """Scope ``grid`` (a name in GRIDS or a dict) and fit its response surface."""
    dev = resolve_device(device)
    f32_matmul_highest()
    grid = GRIDS[grid] if isinstance(grid, str) else grid
    cs = ContainerStress()
    res = cs.run_measured(
        mset_workload(dev),
        grid,
        reps=reps,
        verbose=verbose,
        constraint=lambda p: p["n_memvec"] >= 2 * p["n_signals"],
    )
    names, X, y = res.to_arrays()
    surf = fit_response_surface(names, X, y)
    if verbose:
        print(f"\nresponse surface fit: r^2 = {surf.r2:.4f}")
        xs, ys, Z = grid_to_matrix(res.rows, "n_memvec", "n_signals")
        print(
            render_ascii_surface(
                xs, ys, Z, "n_memvec", "n_signals", f"MSET2 train+surveil compute cost ({dev})"
            )
        )
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        rows = [
            {**r.params, "mean_s": r.mean_s, "std_s": r.std_s, "device": str(dev)}
            for r in res.rows
        ]
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"saved {out}")
    return res, surf


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mset", action="store_true")
    ap.add_argument("--grid", default="small", choices=sorted(GRIDS))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not args.mset:
        ap.error(
            "pick --mset (analytic LM scoping over the catalog waits for the port's "
            "distributed/, ROADMAP item 9)"
        )
    run_mset(args.grid, args.reps, args.out, device=args.device)


if __name__ == "__main__":
    main()
