"""Autonomously scope the autoscaler on the PyTorch/CUDA port: ``tune()`` quickstart.

The scoping stack picks a cloud shape; the fleet simulator says what a policy costs on
it; ``tune()`` picks the policy's own knobs: here the predictive autoscaler's
(horizon_s, window_bins, headroom) on a flash-crowd MSET scenario, then the reactive
autoscaler's rule thresholds on the same traffic for comparison. Candidates are raced on
paired Monte Carlo replicates in the compiled bin loop on the card, dominated configs
culled early (successive halving + SPRT), and the surviving region gets a fitted
response surface.

    PYTHONPATH=src python examples/torch_tune_autoscaler.py               # on the card
    PYTHONPATH=src python examples/torch_tune_autoscaler.py --device cpu

The counterpart of ``examples/tune_autoscaler.py``; it imports only ``repro_torch``.
``backend`` picks the simulator as ``tuning_scenario`` does; ``shapes`` may leave out
the catalog's H100 nodes.
"""

from __future__ import annotations

import argparse

from repro_torch.fleet import (
    Objective,
    PredictivePolicy,
    ReactivePolicy,
    TuningBudget,
    flash_crowd_trace,
    mset_scenario,
    simulate_fleet,
    summarize,
    tune,
    tuning_scenario,
)

PREDICTIVE_DEFAULT = {"horizon_s": 120.0, "window_bins": 12, "headroom": 0.85}
REACTIVE_DEFAULT = {
    "upper": 0.8,
    "lower_frac": 0.375,
    "scale_up_frac": 0.5,
    "scale_down_frac": 0.25,
    "cooldown_s": 120.0,
}


def main(
    device=None,
    backend: str = "auto",
    shapes=None,
    duration_s: float = 3600.0,
    n_seeds: int = 12,
    n_candidates: int = 24,
) -> dict:
    """Both tunes on ``device`` (the card unless ``"cpu"``). Returns each winner's params,
    cost and attainment, and the tuned predictive policy re-simulated."""
    engine = dict(backend=backend, device=device)
    scenario = mset_scenario(n_signals=1024, n_memvec=4096, fleet=8, slo_s=1.0, shapes=shapes)
    svc = scenario.service_for(scenario.cheapest_shape())
    trace = flash_crowd_trace(
        3.5 * svc.max_throughput,
        duration_s,
        dt_s=5.0,
        peak_mult=4.0,
        burst_width_s=120.0,
        n_seeds=n_seeds,
        seed=2,
    )
    objective = Objective(min_attainment=1.0, penalty_usd_per_hour=1e5)

    # --- tune the predictive policy, compare against the hand-set default --
    ts = tuning_scenario(scenario, trace, PredictivePolicy, cold_start_s=60.0, **engine)
    report = tune(
        ts,
        PredictivePolicy.param_space(),
        objective,
        TuningBudget(n_candidates=n_candidates),
        seed=0,
        baseline=PREDICTIVE_DEFAULT,
    )
    print(report.summary())

    # the tuned policy is one call away from serving traffic
    policy = report.build_policy()
    rep = summarize(simulate_fleet(trace, ts.fleet, policy, slo_s=scenario.slo_s, **engine))
    print(
        f"\ntuned policy re-simulated: {rep.slo_attainment * 100:.2f}% SLO "
        f"at ${rep.usd_per_hour:.2f}/hr\n"
    )

    # --- same machinery, different policy family: reactive rule thresholds --
    ts_r = tuning_scenario(scenario, trace, ReactivePolicy, cold_start_s=60.0, **engine)
    rep_r = tune(
        ts_r,
        ReactivePolicy.param_space(),
        objective,
        TuningBudget(n_candidates=n_candidates),
        seed=0,
        baseline=REACTIVE_DEFAULT,
    )
    print(rep_r.summary())

    def figures(r):
        w = r.winner
        cost, att = float(w.cost_usd_hr.mean()), float(w.attainment.mean())
        return {"params": w.params, "cost_usd_hr": cost, "attainment": att}

    return {
        "predictive": figures(report),
        "reactive": figures(rep_r),
        "resimulated": (rep.slo_attainment, rep.usd_per_hour),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
