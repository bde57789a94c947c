"""Capacity planning for live traffic on the PyTorch/CUDA port: run the autoscaling
policies over synthetic traces for both serving scenarios and compare SLO vs dollar
cost.

The scoping stack picks the shape (the predictive policy calls ``recommend()`` over
roofline rows); the fleet simulator then answers what that choice costs under steady,
diurnal, flash-crowd, and ramp arrivals. A mixed-shape fleet (fine-grained baseline pool
+ coarse burst pool, driven by the heterogeneous predictive policy) rides along in the
same table. The last section serves a tiered-SLA multi-class workload (gold/silver/
bronze SLOs) under FIFO, strict priority and EDF at the same capacity.

    PYTHONPATH=src python examples/torch_simulate_fleet.py                # on the card
    PYTHONPATH=src python examples/torch_simulate_fleet.py --device cpu

``backend="auto"`` (the default) runs each simulation on the port's compiled bin loop
(``backend="torch"``) where the policy family has a kernel and on the numpy loop
otherwise; ``backend="numpy"`` is the reference's loop throughout. The counterpart of
``examples/simulate_fleet.py``; it imports only ``repro_torch``. The port's catalog
also lists H100 nodes; ``shapes`` restricts it (the reference's is the v5e slices).
"""

from __future__ import annotations

import argparse
import math

from repro_torch.fleet import (
    HeterogeneousPredictivePolicy,
    StaticPolicy,
    class_table,
    comparison_table,
    default_policies,
    lm_decode_scenario,
    mset_scenario,
    simulate,
    simulate_fleet,
    standard_traces,
    summarize,
    tiered_sla_workload,
)


def run_scenario(
    scenario,
    mean_rate: float,
    duration_s: float = 3600.0,
    dt_s: float = 5.0,
    cold_start_s: float = 60.0,
    n_seeds: int = 8,
    backend: str = "auto",
    device=None,
):
    print(
        f"\n=== {scenario.name}: {scenario.description} "
        f"(SLO {scenario.slo_s * 1e3:.0f} ms) ==="
    )
    rows = scenario.rows
    constraint = scenario.constraint()
    policies = default_policies(
        rows, constraint, scenario.units_per_step, static_replicas=0, cold_start_s=cold_start_s
    )
    predictive = policies[-1]
    shape_name = predictive.recommendation.shape.name
    service = scenario.service_for(shape_name)
    print(
        f"recommend() picked {shape_name} "
        f"({predictive.recommendation.reason}); one replica serves "
        f"{service.max_throughput:.0f} req/s at batch {service.max_batch}"
    )

    # size the static fleet for the mean rate at 85% target utilization — the
    # one-shot scoping answer, blind to bursts
    policies[0].n = max(math.ceil(mean_rate / (service.max_throughput * 0.85)), 1)

    # mixed fleet: baseline pool of the cheapest shape, burst pool two rungs up
    shapes = sorted(
        {r.shape_name for r in scenario.rows_at()},
        key=lambda s: scenario.service_for(s).shape.chips,
    )
    mixed_names = [shapes[0], shapes[min(2, len(shapes) - 1)]]
    fleet = scenario.fleet_for(mixed_names, cold_start_s=cold_start_s)
    hetero = HeterogeneousPredictivePolicy(
        rows, constraint, scenario.units_per_step, fleet, horizon_s=2 * cold_start_s
    )
    print(
        f"mixed fleet: {fleet.shape_label()} (drain order "
        f"{[fleet.pools[i].label for i in fleet.drain_order()]})"
    )

    engine = dict(backend=backend, device=device)
    reports = []
    for trace in standard_traces(mean_rate, duration_s, dt_s, n_seeds=n_seeds):
        for policy in policies:
            sim = simulate(
                trace, service, policy, slo_s=scenario.slo_s, cold_start_s=cold_start_s, **engine
            )
            reports.append(summarize(sim))
        sim = simulate_fleet(trace, fleet, hetero, slo_s=scenario.slo_s, **engine)
        reports.append(summarize(sim))
    print(comparison_table(reports))
    return reports


def run_disciplines(
    scenario,
    n_replicas: int = 10,
    duration_s: float = 3600.0,
    n_seeds: int = 4,
    backend: str = "auto",
    device=None,
):
    """Same fleet, same trace, three scheduling disciplines: the per-class table shows
    FIFO leaking bronze's queueing delay into gold's latency."""
    service = scenario.service_for(scenario.cheapest_shape())
    wl = tiered_sla_workload(
        6.0 * service.max_throughput, duration_s, dt_s=5.0, n_seeds=n_seeds, seed=3
    )
    print(
        f"\n=== {wl.name}: {n_replicas} x {service.shape.name}, classes "
        + ", ".join(f"{c.name}({c.slo_s:g}s)" for c in wl.classes)
        + " ==="
    )
    reports = [
        summarize(
            simulate(
                wl,
                service,
                StaticPolicy(n_replicas),
                discipline=d,
                initial_replicas=n_replicas,
                backend=backend,
                device=device,
            )
        )
        for d in ("fifo", "priority", "edf")
    ]
    print(class_table(reports))
    return reports


def main(device=None, backend: str = "auto", shapes=None) -> dict:
    """Both scenarios and the discipline sweep on ``device`` (the card unless
    ``"cpu"``). Returns each table's rows as (policy, SLO attainment, $/hr)."""
    # drive each scenario at ~70% of an 8-replica fleet of the smallest shape,
    # so bursts genuinely outrun the cold start
    engine = dict(backend=backend, device=device)
    mset = mset_scenario(n_signals=1024, n_memvec=4096, fleet=8, slo_s=1.0, shapes=shapes)
    svc = mset.service_for(mset.rows_at()[0].shape_name)
    out = {"mset": run_scenario(mset, mean_rate=5.6 * svc.max_throughput, **engine)}

    lm = lm_decode_scenario("minitron-4b", ctx=512, slo_s=0.25, shapes=shapes)
    svc = lm.service_for(lm.rows_at()[0].shape_name)
    out["lm"] = run_scenario(lm, mean_rate=5.6 * svc.max_throughput, **engine)

    out["disciplines"] = run_disciplines(mset, **engine)
    return {
        name: [(r.policy, r.slo_attainment, r.usd_per_hour) for r in reports]
        for name, reports in out.items()
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
