# Autonomous controller scoping: the paper's nested-loop Monte Carlo
# methodology applied to the fleet controller itself. The fleet simulator is
# the inner loop (vectorized over workload draws); `tune()` wraps the outer
# search over autoscaler/fleet parameters — declarative ParamSpaces
# (`space`), paired candidate evaluation (`evaluate`), successive-halving +
# SPRT racing (`racing`), and the response-surface/Pareto report (`result`).
from repro_torch.fleet.tuning.evaluate import (
    CandidateEval,
    Objective,
    TuningScenario,
    evaluate_candidates,
    evaluate_candidates_column,
    per_seed_metrics,
    robust_m,
    robust_weights,
)
from repro_torch.fleet.tuning.racing import RaceResult, exhaustive, race, race_column
from repro_torch.fleet.tuning.result import TuningReport, frontier_table, pareto_frontier
from repro_torch.fleet.tuning.space import (
    Categorical,
    Continuous,
    Dim,
    Integer,
    ParamSpace,
    discipline_dim,
    quota_dims,
)
from repro_torch.fleet.tuning.tuner import (
    TuningBudget,
    tune,
    tuning_scenario,
    warm_start_candidates,
)

__all__ = [
    "CandidateEval", "Objective", "TuningScenario", "evaluate_candidates",
    "evaluate_candidates_column", "per_seed_metrics", "robust_m",
    "robust_weights", "RaceResult", "exhaustive", "race", "race_column",
    "TuningReport", "frontier_table", "pareto_frontier", "Categorical",
    "Continuous", "Dim", "Integer", "ParamSpace", "discipline_dim",
    "quota_dims", "TuningBudget", "tune", "tuning_scenario",
    "warm_start_candidates",
]
