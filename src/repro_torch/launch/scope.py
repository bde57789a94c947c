"""ContainerStress CLI on the card — the paper's workflow end to end.

Measured MSET2 scoping (paper Figs. 4-5, wall-clock Monte Carlo):

    PYTHONPATH=src python -m repro_torch.launch.scope --mset --grid small
    PYTHONPATH=src python -m repro_torch.launch.scope --mset --grid small --device cpu

Analytic LM scoping across the catalog (``run_lm``): each shape from 64 chips up, its
step counted per device on meta tensors in a ``fake_world`` of its chips
(``launch.dryrun.probe_cost``), then roofline, dollars and a recommendation. The v5e
rows are the reference's cost model applied to the port's count (analytic):

    PYTHONPATH=src python -m repro_torch.launch.scope --lm minitron-4b --shape train_4k
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


def run_lm(arch: str, shape_name: str, out: str = "", n_microbatches: int = 8):
    """Scope ``arch`` at ``shape_name`` across the catalog's shapes of 64 chips and up:
    each shape's step counted per device on meta tensors (no card), its roofline at the
    shape's hardware, the dollars of 1000 steps, and the cheapest shape whose step fits
    60 s. A shape whose count fails is printed infeasible, as the reference's. Returns
    (rows, recommendation), or None when the shape does not apply."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.core import CATALOG, CellResult, Constraint, dollar_cost, recommend, roofline
    from repro_torch.launch.dryrun import probe_cost
    from repro_torch.launch.mesh import fake_world

    ok, why = shape_applicable(get_config(arch), SHAPES[shape_name])
    if not ok:
        print(f"skip: {why}")
        return None
    rows = []
    for cshape in CATALOG:
        if cshape.chips < 64:
            continue  # big-model scoping starts at v5e-64
        try:
            with fake_world(cshape.chips):
                mesh = cshape.make_mesh("cpu")
                cost = probe_cost(arch, shape_name, mesh, n_microbatches=n_microbatches)
        except Exception as e:
            print(f"{cshape.name}: infeasible ({type(e).__name__}: {e})")
            continue
        terms = roofline(
            cost.flops, cost.bytes_accessed, cost.collective_bytes, cshape.chips, cshape.hw
        )
        usd = dollar_cost(terms.t_step, 1000, cshape.chips, cshape.hw)
        rows.append(
            CellResult(
                params={"shape": cshape.chips},
                shape_name=cshape.name,
                terms=terms,
                analysis=cost.as_dict(),
                usd_per_1k_steps=usd,
            )
        )
        print(
            f"{cshape.name:12s} t_step={terms.t_step * 1e3:9.2f}ms "
            f"dom={terms.dominant:10s} ${usd:8.2f}/1k-steps (analytic)"
        )
    rec = recommend(rows, Constraint(max_step_latency_s=60.0))
    print(f"\nrecommendation: {rec.shape.name if rec.shape else None} — {rec.reason}")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            rows_out = [
                {
                    **r.params,
                    "shape_name": r.shape_name,
                    "t_step": r.terms.t_step,
                    "usd": r.usd_per_1k_steps,
                }
                for r in rows
            ]
            json.dump(rows_out, f, indent=1)
    return rows, rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mset", action="store_true")
    ap.add_argument("--grid", default="small", choices=sorted(GRIDS))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--lm", help="an arch to scope analytically across the catalog")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument(
        "--device", default=None, help="cuda (default) or cpu; --lm runs on meta tensors"
    )
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.mset:
        run_mset(args.grid, args.reps, args.out, device=args.device)
    elif args.lm:
        run_lm(args.lm, args.shape, args.out)
    else:
        ap.error("pick --mset or --lm <arch>")


if __name__ == "__main__":
    main()
