"""Scoping as a service on the PyTorch/CUDA port: build an oracle table offline, answer
online.

The tuner (``tune()``) scopes one workload in seconds of simulation; the oracle
amortizes that cost across every future workload: sweep the tuner once over a
declarative (mean rate x burstiness x SLO) grid of canonical traces (each column's
candidates raced in the compiled bin loop on the card), compile the winners + Pareto
frontiers into a versioned JSON table, and answer each new customer's "what shape +
controller config, and what will it cost?" by featurizing their trace and interpolating
the table, in microseconds, without touching the simulator. Queries outside the gridded
region are refused with a reason instead of extrapolated.

    PYTHONPATH=src python examples/torch_oracle_query.py                  # on the card
    PYTHONPATH=src python examples/torch_oracle_query.py --device cpu

The counterpart of ``examples/oracle_query.py``; it imports only ``repro_torch``.
``backend`` picks the simulator as ``build_oracle`` does; ``shapes`` may leave out the
catalog's H100 nodes.
"""

from __future__ import annotations

import argparse

from repro_torch.fleet import (
    Objective,
    OracleGrid,
    OracleTable,
    PIPolicy,
    ScopingOracle,
    TuningBudget,
    build_oracle,
    flash_crowd_trace,
    mset_scenario,
    tuning_scenario,
    verify_oracle,
)


def main(
    device=None,
    backend: str = "auto",
    shapes=None,
    rate_mults=(1.5, 3.0, 6.0),
    burstiness=(1.0, 1.6, 2.2),
    slos=(1.0, 2.0, 4.0),
    n_seeds: int = 3,
    n_candidates: int = 10,
    verify_samples: int = 3,
    table_path: str = "oracle_table.json",
) -> dict:
    """Build, query and verify the oracle on ``device`` (the card unless ``"cpu"``).
    Returns the in-grid answer's params, predicted cost and attainment, the refused
    query's reason and the verification's figures."""
    engine = dict(backend=backend, device=device)
    scenario = mset_scenario(n_signals=1024, n_memvec=4096, fleet=8, slo_s=2.0, shapes=shapes)
    svc = scenario.service_for(scenario.cheapest_shape())
    mt = svc.max_throughput
    probe = flash_crowd_trace(3.0 * mt, 900.0, dt_s=10.0, n_seeds=2, seed=0)
    ts = tuning_scenario(scenario, probe, PIPolicy, cold_start_s=60.0, **engine)
    objective = Objective(min_attainment=0.95, penalty_usd_per_hour=2000.0)

    # --- offline: sweep the tuner over the grid, once ----------------------
    grid = OracleGrid(
        mean_rates=tuple(m * mt for m in rate_mults),
        burstiness=tuple(burstiness),
        slos=tuple(slos),
        duration_s=900.0,
        dt_s=10.0,
        n_seeds=n_seeds,
        seed=0,
    )
    table = build_oracle(
        grid,
        ts.fleet,
        PIPolicy,
        PIPolicy.param_space(),
        objective=objective,
        budget=TuningBudget(n_candidates=n_candidates, init_seeds=2),
        context=ts.context,
        max_queue=ts.max_queue,
        **engine,
    )
    print(table.summary())
    table.save(table_path)

    # --- online: microsecond answers from the reloaded artifact ------------
    oracle = ScopingOracle(OracleTable.load(table_path))
    customer = flash_crowd_trace(
        2.4 * mt, 1800.0, dt_s=10.0, peak_mult=2.5, burst_width_s=150.0, n_seeds=4, seed=99
    )
    ans = oracle.query(customer, slo_s=2.0)
    print(f"\nanswer in {ans.latency_us:.0f}us: {ans.params}")
    print(
        f"  predicted ${ans.cost_usd_hr:.2f}/hr "
        f"(bound ${ans.cost_bound_usd_hr:.2f}/hr) "
        f"at {ans.attainment * 100:.1f}% attainment "
        f"[cell {ans.cell_idx}, exact={ans.exact}]"
    )

    # a query beyond the sweep is refused, never guessed
    wild = oracle.query(customer, slo_s=0.05)
    print(f"\nout-of-grid query refused: {wild.reason}")

    # --- trust, then verify: spot-check answers against fresh simulation ---
    report = verify_oracle(
        table,
        ts.fleet,
        PIPolicy,
        n_samples=verify_samples,
        context=ts.context,
        max_queue=ts.max_queue,
        **engine,
    )
    print(f"\n{report.summary()}")
    verified = {k: v for k, v in report.to_json().items() if k != "checks"}
    return {
        "params": ans.params,
        "cost_usd_hr": ans.cost_usd_hr,
        "attainment": ans.attainment,
        "refused": wild.reason,
        "verify": verified,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
