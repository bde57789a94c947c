# ContainerStress — the paper's primary contribution: autonomous cloud-node
# scoping via nested-loop Monte Carlo + op-by-op roofline analysis on meta tensors.
from repro_torch.core.catalog import CATALOG, CloudShape, get_shape, register_shape
from repro_torch.core.cost_model import (
    H100,
    V5E,
    HardwareSpec,
    RooflineTerms,
    dollar_cost,
    mfu,
    roofline,
)
from repro_torch.core.hlo_analysis import CompiledCost, analyze, parse_collectives
from repro_torch.core.recommender import (
    Constraint,
    Recommendation,
    elasticity_plan,
    feasible_ranking,
    recommend,
)
from repro_torch.core.scoping import CellResult, ContainerStress, ScopingResult
from repro_torch.core.surfaces import (
    ResponseSurface,
    fit_response_surface,
    grid_to_matrix,
    render_ascii_surface,
)

__all__ = [
    "CATALOG",
    "CloudShape",
    "get_shape",
    "register_shape",
    "HardwareSpec",
    "RooflineTerms",
    "V5E",
    "H100",
    "dollar_cost",
    "mfu",
    "roofline",
    "CompiledCost",
    "analyze",
    "parse_collectives",
    "Constraint",
    "Recommendation",
    "elasticity_plan",
    "feasible_ranking",
    "recommend",
    "CellResult",
    "ContainerStress",
    "ScopingResult",
    "ResponseSurface",
    "fit_response_surface",
    "grid_to_matrix",
    "render_ascii_surface",
]
