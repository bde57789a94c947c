"""Fleet observability end to end on the PyTorch/CUDA port: metrics dashboard, tuner
span tracing, exporters, and the MSET+SPRT drift probe.

Everything runs inside one ``telemetry.session()``: the simulator records per-bin
metric streams, ``tune()`` wraps its phases in wall-clock spans (with the compiled
backend's dispatches nested inside), and the session exports to an ASCII sparkline
dashboard, Prometheus text, and a JSONL event log. The finale is the paper's prognostic
loop in miniature: a DriftProbe learns the healthy fleet's telemetry envelope (MSET2 and
the SPRT on the card), stays quiet on a fresh replicate, and alarms on a fleet whose
service times silently degraded 30%.

    PYTHONPATH=src python examples/torch_observe_fleet.py                 # on the card
    PYTHONPATH=src python examples/torch_observe_fleet.py --device cpu

The counterpart of ``examples/observe_fleet.py``; it imports only ``repro_torch``.
``backend`` picks the simulator as ``tuning_scenario`` does ("auto": the compiled bin
loop where the policy has a kernel); the port's catalog also lists H100 nodes, which
``shapes`` may leave out.
"""

from __future__ import annotations

import argparse

from repro_torch.fleet import (
    FleetConfig,
    Objective,
    PredictivePolicy,
    QueueProportionalPolicy,
    TuningBudget,
    diurnal_trace,
    flash_crowd_trace,
    mset_scenario,
    simulate_fleet,
    telemetry,
    tune,
    tuning_scenario,
)


def main(
    device=None,
    backend: str = "auto",
    shapes=None,
    duration_s: float = 1800.0,
    n_seeds: int = 8,
    n_candidates: int = 12,
    events_path: str = "observe_fleet_events.jsonl",
) -> dict:
    """The tuner's session and the drift probe on ``device`` (the card unless
    ``"cpu"``). Returns the tuned winner's params, cost and attainment, and the probe's
    verdicts on the fresh and the degraded fleet."""
    engine = dict(backend=backend, device=device)
    scenario = mset_scenario(n_signals=1024, n_memvec=4096, fleet=8, slo_s=1.0, shapes=shapes)
    svc = scenario.service_for(scenario.cheapest_shape())
    trace = flash_crowd_trace(
        3.5 * svc.max_throughput,
        duration_s,
        dt_s=5.0,
        peak_mult=4.0,
        burst_width_s=60.0,
        n_seeds=n_seeds,
        seed=2,
    )

    with telemetry.session() as tel:
        ts = tuning_scenario(scenario, trace, PredictivePolicy, cold_start_s=60.0, **engine)
        report = tune(
            ts,
            PredictivePolicy.param_space(),
            Objective(min_attainment=1.0, penalty_usd_per_hour=1e5),
            TuningBudget(n_candidates=n_candidates),
            seed=0,
        )

    print("=== metric streams (sparkline dashboard) ===")
    print(tel.dashboard())

    print("\n=== tuner timing breakdown (span tree) ===")
    print(report.timing_breakdown())

    print("\n=== Prometheus exposition (first 12 lines) ===")
    print("\n".join(tel.prometheus().splitlines()[:12]))

    n = tel.export_jsonl(events_path)
    print(f"\nwrote {events_path} ({n} records)")

    # --- drift probe: learn the healthy envelope, catch silent degradation --
    fleet = FleetConfig((scenario.pool_for(scenario.cheapest_shape(), cold_start_s=30.0),))
    day = diurnal_trace(2.0 * svc.max_throughput, 3600.0, dt_s=10.0, n_seeds=6, seed=0)
    probe = telemetry.DriftProbe(device=device).fit(
        simulate_fleet(day, fleet, QueueProportionalPolicy(), slo_s=2.0, **engine)
    )

    day2 = diurnal_trace(2.0 * svc.max_throughput, 3600.0, dt_s=10.0, n_seeds=6, seed=7)
    sim = simulate_fleet(day2, fleet, QueueProportionalPolicy(), slo_s=2.0, **engine)
    fresh = probe.check(sim)
    print("\n=== drift probe ===")
    print(f"fresh replicate:  {fresh.summary()}")

    degraded = telemetry.degrade_fleet(fleet, 1.3)  # 30% slower service
    sim = simulate_fleet(day2, degraded, QueueProportionalPolicy(), slo_s=2.0, **engine)
    bad = probe.check(sim)
    print(f"degraded fleet:   {bad.summary()}")
    w = report.winner
    return {
        "winner": w.params,
        "cost_usd_hr": float(w.cost_usd_hr.mean()),
        "attainment": float(w.attainment.mean()),
        "fresh_drifted": fresh.drifted,
        "degraded_drifted": bad.drifted,
        "records": n,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
