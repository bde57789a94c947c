"""Closing the loop on the PyTorch/CUDA port: drift-triggered re-scope + warm re-tune +
hot-swap.

A PI autoscaler is tuned for the nominal MSET serving fleet, then serves a fresh diurnal
trace on which every node silently slows down by 2x mid-trace. The
``ClosedLoopController`` sees only telemetry; when its MSET+SPRT probe (the similarity
and SPRT kernels on the card) alarms it estimates the degradation, re-checks the shape
recommendation under the degraded service model, warm re-tunes the PI on the remaining
workload, and hot-swaps the winner into the running simulation: one continuous trace,
no restart.

    PYTHONPATH=src python examples/torch_closed_loop.py                   # on the card
    PYTHONPATH=src python examples/torch_closed_loop.py --device cpu

The counterpart of ``examples/closed_loop.py``; it imports only ``repro_torch``.
``backend`` picks the simulator as ``tuning_scenario`` does; ``shapes`` may leave out
the catalog's H100 nodes.
"""

from __future__ import annotations

import argparse

from repro_torch.core.recommender import recommend
from repro_torch.fleet import (
    ClosedLoopController,
    FleetConfig,
    Objective,
    PIPolicy,
    SegmentedSimulation,
    TuningBudget,
    diurnal_trace,
    mset_scenario,
    tune,
    tuning_scenario,
    window_metrics,
)
from repro_torch.fleet.control import service_degradation_case
from repro_torch.fleet.telemetry.drift import degrade_fleet
from repro_torch.fleet.workload import Workload

DRIFT_FACTOR = 2.0
DT_S = 10.0


def main(
    device=None,
    backend: str = "auto",
    shapes=None,
    duration_s: float = 3600.0,
    mc_seeds: int = 4,
    live_seeds: int = 3,
    n_candidates: int = 10,
) -> dict:
    """The incumbent tune, the ride-through and the closed loop on ``device`` (the card
    unless ``"cpu"``). Returns the incumbent's params, both post-drift attainments and
    costs, the degradation estimate and the active config."""
    engine = dict(backend=backend, device=device)
    scenario = mset_scenario(n_signals=1024, n_memvec=4096, fleet=8, slo_s=2.0, shapes=shapes)
    shape = recommend(scenario.rows_at(), scenario.constraint()).shape.name
    svc = scenario.service_for(shape)
    mean_rate = 3.0 * svc.max_throughput
    diurnal = dict(dt_s=DT_S, amplitude=0.4, period_s=3600.0)
    mc = diurnal_trace(mean_rate, duration_s, n_seeds=mc_seeds, seed=1, **diurnal)
    live = diurnal_trace(mean_rate, duration_s, n_seeds=live_seeds, seed=101, **diurnal)
    fleet = FleetConfig(
        (scenario.pool_for(shape, cold_start_s=60.0, max_replicas=24),),
        max_queue=2.0 * mean_rate * DT_S,
    )

    # --- scope the incumbent on the nominal world --------------------------
    ts = tuning_scenario(
        scenario, mc, PIPolicy, fleet=fleet, cold_start_s=60.0, name="mset-diurnal/pi", **engine
    )
    objective = Objective(min_attainment=0.96, penalty_usd_per_hour=2000.0)
    budget = TuningBudget(n_candidates=n_candidates, init_seeds=2)
    incumbent = tune(ts, PIPolicy.param_space(), objective, budget, seed=0)
    print(f"incumbent PI config: {incumbent.winner.params}\n")

    # --- the world drifts: every node silently 2x slower at the peak -------
    case = service_degradation_case(
        Workload.from_trace(live, scenario.slo_s), fleet, factor=DRIFT_FACTOR, t_drift_frac=0.25
    )
    td = case.drift_bins()[0]
    T = case.n_bins

    # counterfactual: the incumbent rides through unchanged
    ride = SegmentedSimulation(
        case.workload,
        fleet,
        ts.make_policy(incumbent.winner.params),
        cold_start_seed=ts.cold_start_seed,
    )
    ride.run_until(td).swap(fleet=degrade_fleet(fleet, DRIFT_FACTOR))
    ride_post = window_metrics(ride.run_until(T).result(), td, T)

    # --- the closed loop observes, decides, acts ---------------------------
    ctl = ClosedLoopController(
        ts, incumbent, segment_bins=15, retune_budget=budget, objective=objective
    )
    res = ctl.run(case)
    print(res.timeline())

    post = window_metrics(res.sim, td, T)
    print(
        f"\npost-drift worst-class attainment: incumbent ride-through "
        f"{ride_post.worst_class_attainment:.4f} at "
        f"${ride_post.usd_per_hour:.2f}/hr -> closed loop "
        f"{post.worst_class_attainment:.4f} at ${post.usd_per_hour:.2f}/hr"
    )
    print(
        f"degradation estimate {res.est_factor:.2f} (true {DRIFT_FACTOR}); "
        f"active config {res.active_params}"
    )
    if res.rescopes:
        rec = res.rescopes[0]
        print(
            "re-scope under degraded service model: "
            f"{'shape ' + rec.shape.name if rec.shape else 'infeasible'}"
        )
    return {
        "incumbent": incumbent.winner.params,
        "ride_through": (ride_post.worst_class_attainment, ride_post.usd_per_hour),
        "closed_loop": (post.worst_class_attainment, post.usd_per_hour),
        "est_factor": res.est_factor,
        "active_params": res.active_params,
        "events": [(e.t_bin, e.kind) for e in res.events],
        "swaps": res.n_swaps,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
