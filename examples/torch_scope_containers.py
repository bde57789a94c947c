"""The paper's headline workflow on the PyTorch/CUDA port: autonomously scope a
cloud container for a customer's ML use case, from tiny (customer A) to
fleet-scale (customer B).

Nested-loop Monte Carlo scoping (measured on the card) -> response surface ->
cost of the MSET2 surveillance service on each catalog shape (analytic roofline,
TPU v5e slices and H100 nodes, each rated on its own hardware) -> cheapest
feasible shape.

    PYTHONPATH=src python examples/torch_scope_containers.py               # on the card
    PYTHONPATH=src python examples/torch_scope_containers.py --device cpu

The counterpart of ``examples/scope_containers.py``; it imports only
``repro_torch`` and numpy.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch._device import f32_matmul_highest, resolve_device
from repro_torch.configs.mset_paper import CUSTOMER_A, CUSTOMER_B
from repro_torch.core import (
    CATALOG,
    CellResult,
    Constraint,
    ContainerStress,
    RooflineTerms,
    fit_response_surface,
    grid_to_matrix,
    recommend,
    render_ascii_surface,
)
from repro_torch.launch.scope import mset_workload

# The reference example's grid (n_memvec >= 2 * n_signals keeps 10 of its 16 cells),
# 2048 observations a cell, of which the first 1536 train the model.
SCOPING_GRID = {"n_signals": [8, 16, 32, 64], "n_memvec": [64, 128, 256, 512]}
N_OBS, N_TRAIN = 2048, 1536


def mset_surveil_flops_bytes(n_sig: int, n_mv: int, n_obs: int):
    """Analytic FLOPs/bytes of streaming surveillance over n_obs observations
    (the JAX package's ``benchmarks/common.py``, kept here so that the port
    imports nothing of it)."""
    f_sim = 2.0 * n_mv * n_obs * n_sig
    f_w = 2.0 * n_mv * n_mv * n_obs
    f_rec = 2.0 * n_mv * n_obs * n_sig
    flops = f_sim + f_w + f_rec
    bytes_ = 4.0 * (n_obs * n_sig * 3 + n_mv * n_sig + n_mv * n_mv + n_mv * n_obs)
    return flops, bytes_


def roofline_time(flops: float, bytes_: float, shape) -> float:
    """Roofline time of the work on ``shape``, rated on its own hardware: a v5e
    slice on ``V5E``, exactly as the reference's ``tpu_roofline_time``, an H100
    node on ``H100``. ``H100.peak_flops`` is the bf16 dense rate while MSET2 runs
    in float32, so the h100 rows are optimistic, as the v5e rows are."""
    hw = shape.hw
    return max(flops / (shape.chips * hw.peak_flops), bytes_ / (shape.chips * hw.hbm_bw))


def _device_label(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def measured_scoping(device=None, grid=SCOPING_GRID, reps: int = 2):
    """Time MSET2 train + surveil over ``grid`` on ``device`` (the card unless
    ``"cpu"``) and fit the response surface; returns it."""
    dev = resolve_device(device)
    f32_matmul_highest()
    print(f"=== 1. nested-loop Monte Carlo scoping (measured, {_device_label(dev)}) ===")
    res = ContainerStress().run_measured(
        mset_workload(dev, split=lambda params: (N_TRAIN, N_OBS - N_TRAIN)),
        grid,
        reps=reps,
        constraint=lambda p: p["n_memvec"] >= 2 * p["n_signals"],
        verbose=False,
    )
    names, X, y = res.to_arrays()
    surf = fit_response_surface(names, X, y)
    print(f"fitted response surface over (n_signals, n_memvec): r^2={surf.r2:.3f}")
    xs, ys, Z = grid_to_matrix(res.rows, "n_memvec", "n_signals")
    print(
        render_ascii_surface(
            xs, ys, Z, "n_memvec", "n_signals", "measured train+surveil cost ('·' = infeasible)"
        )
    )
    return surf


def analytic_recommendation(
    use_case, sample_rate_hz: float, fleet: int = 1, window_s: float = 60.0, shapes=CATALOG
):
    """Roofline cost of the MSET surveillance service on each of ``shapes``.

    fleet assets, each with its own (D, Ginv) model; one surveillance window of
    `window_s` seconds of observations per asset must finish within the window
    (real-time constraint) and all models must fit aggregate device memory.
    """
    print(
        f"\n=== scoping '{use_case.name}': {use_case.n_signals} signals x "
        f"{fleet} assets, memvec={use_case.n_memvec} @ {sample_rate_hz} Hz ==="
    )
    rows = []
    n_obs = max(int(sample_rate_hz * window_s), 1)
    model_bytes = 4.0 * (use_case.n_memvec**2 + 2 * use_case.n_memvec * use_case.n_signals)
    for shape in shapes:
        f, b = mset_surveil_flops_bytes(use_case.n_signals, use_case.n_memvec, n_obs)
        f, b = f * fleet, b * fleet
        t = roofline_time(f, b, shape)
        rows.append(
            CellResult(
                params={"chips": shape.chips},
                shape_name=shape.name,
                terms=RooflineTerms(t, t * 0.8, 0.0),
                analysis={"peak_memory_per_device": fleet * model_bytes / shape.chips},
            )
        )
    cons = Constraint(max_step_latency_s=window_s)
    rec = recommend(rows, cons)
    for name, t, price, ok in rec.ranking:
        print(
            f"  {name:12s} t_window={t * 1e3:10.2f}ms  ${price:8.2f}/hr  "
            f"{'OK' if ok else 'infeasible (latency or HBM)'}"
        )
    print(f"--> {rec.shape.name if rec.shape else 'NO SHAPE'} ({rec.reason})")
    return rec


def main(device=None) -> dict:
    """Scoping on ``device``, then both customers over the whole catalog. Returns the
    response surface's r^2 and each customer's shape, reason and ranking."""
    surf = measured_scoping(device)
    # Customer A: 20 signals @ 1/hr (paper §I) — anything works; cheapest wins.
    rec_a = analytic_recommendation(CUSTOMER_A, sample_rate_hz=1 / 3600)
    # Customer B: fleet of 200 Airbus A320s, 75k sensors @ 1 Hz each — per-plane
    # MSET models must fit aggregate device memory; scoping finds the smallest slice.
    rec_b = analytic_recommendation(CUSTOMER_B, sample_rate_hz=1.0, fleet=200)
    out = {"surface_r2": surf.r2}
    for label, rec in (("customer_a", rec_a), ("customer_b", rec_b)):
        shape = rec.shape.name if rec.shape else None
        out[label] = {"shape": shape, "reason": rec.reason, "ranking": rec.ranking}
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
