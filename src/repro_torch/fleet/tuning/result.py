"""Tuning outputs: the Pareto frontier and the ``TuningReport``.

The report is the controller-scoping analogue of the paper's per-use-case
deliverable: the recommended (winner) configuration, the cost-vs-attainment
frontier a deployer can trade along, the fitted response surface over the
controller knobs (Figs. 4-8 methodology with autoscaler parameters as the
design variables, rendered as the same ASCII contour), and the simulation
budget the racing loop actually spent getting there.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.report import fmt_time, markdown_table
from repro_torch.core.surfaces import ResponseSurface, render_ascii_surface

_ATT_EPS = 1e-9


def pareto_frontier(evals: list) -> tuple:
    """Non-dominated (mean cost, mean worst-class attainment) subset of
    ``evals``, sorted cheapest-first with strictly increasing attainment —
    every member is the cheapest way to buy at least its attainment."""
    pts = sorted(evals, key=lambda e: (e.mean_cost(), -e.mean_attainment()))
    out, best_att = [], -np.inf
    for e in pts:
        if e.mean_attainment() > best_att + _ATT_EPS:
            out.append(e)
            best_att = e.mean_attainment()
    return tuple(out)


def _fmt_param(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def frontier_table(frontier) -> str:
    rows = [[", ".join(f"{k}={_fmt_param(v)}"
                       for k, v in sorted(e.params.items())),
             f"${e.mean_cost():.2f}/hr ± {e.cost_ci():.2f}",
             f"{e.mean_attainment() * 100:.2f}% ± "
             f"{e.attainment_ci() * 100:.2f}",
             fmt_time(e.p99_s()),
             f"{e.mean_drop_rate() * 100:.2f}%",
             str(e.n_seeds)]
            for e in frontier]
    return markdown_table(
        ["config", "cost", "worst-class SLO", "p99", "drop", "seeds"], rows)


@dataclass
class TuningReport:
    """What ``tune()`` hands back: the winner and how much to trust it."""
    scenario_name: str
    policy_family: str
    objective: object                # evaluate.Objective
    winner: object                   # CandidateEval at full replicate budget
    frontier: tuple                  # Pareto CandidateEvals, cheapest first
    surface: Optional[ResponseSurface]
    surface_names: tuple = ()
    sims_used: int = 0
    full_budget: int = 0
    baseline: object = None          # CandidateEval of the hand-set config
    evals: list = field(default_factory=list, repr=False)
    space: object = None
    spans: object = None             # telemetry Span tree (None when off)
    robust: Optional[str] = None     # portfolio reduction ("worst_case", ...)
    n_traces: int = 1                # portfolio size candidates were scored on
    _scenario: object = field(default=None, repr=False)

    @property
    def budget_frac(self) -> float:
        return self.sims_used / max(self.full_budget, 1)

    @property
    def surface_r2(self) -> float:
        return float(self.surface.r2) if self.surface is not None else float("nan")

    def build_policy(self):
        """Instantiate the tuned policy (ready for ``simulate_fleet``)."""
        return self._scenario.make_policy(self.winner.params)

    def dominates_baseline(self) -> bool:
        """Tuned >= baseline attainment AND <= baseline cost, at least one
        strict (on the paired replicate means). False without a baseline."""
        if self.baseline is None:
            return False
        att_t, att_b = self.winner.mean_attainment(), \
            self.baseline.mean_attainment()
        c_t, c_b = self.winner.mean_cost(), self.baseline.mean_cost()
        return (att_t >= att_b - _ATT_EPS and c_t <= c_b + 1e-9
                and (att_t > att_b + _ATT_EPS or c_t < c_b - 1e-9))

    def ascii_surface(self, n_x: int = 16, n_y: int = 10) -> str:
        """ASCII contour of the fitted objective surface over the two leading
        numeric dims (others pinned at the winner), via the same renderer the
        scoping reports use. Empty string when no surface was fitted."""
        if self.surface is None or len(self.surface_names) < 2 \
                or self.space is None:
            return ""
        dims = {d.name: d for d in self.space.dims}
        dx, dy = (dims[n] for n in self.surface_names[:2])
        xs = np.array(dx.grid(n_x), float)
        ys = np.array(dy.grid(n_y), float)
        base = {n: float(self.winner.params[n]) for n in self.surface_names}
        Z = np.empty((len(ys), len(xs)))
        for i, y in enumerate(ys):
            for j, x in enumerate(xs):
                Z[i, j] = self.surface.predict(
                    dict(base, **{dx.name: float(x), dy.name: float(y)}))
        return render_ascii_surface(
            xs, ys, Z, dx.name, dy.name,
            title=f"objective surface (r2={self.surface.r2:.3f}), "
                  f"other dims at winner")

    def summary(self) -> str:
        lines = [f"# tuned {self.policy_family} on {self.scenario_name}",
                 "",
                 "winner: " + ", ".join(
                     f"{k}={_fmt_param(v)}"
                     for k, v in sorted(self.winner.params.items())),
                 f"  ${self.winner.mean_cost():.2f}/hr, worst-class SLO "
                 f"{self.winner.mean_attainment() * 100:.2f}%, p99 "
                 f"{fmt_time(self.winner.p99_s())} "
                 f"({self.winner.n_seeds} replicates)"]
        if self.baseline is not None:
            verdict = ("dominates" if self.dominates_baseline()
                       else "does not dominate")
            lines += [f"default: ${self.baseline.mean_cost():.2f}/hr, "
                      f"worst-class SLO "
                      f"{self.baseline.mean_attainment() * 100:.2f}% "
                      f"— tuned {verdict} the hand-set default"]
        if self.n_traces > 1:
            lines += [f"portfolio: {self.n_traces} traces reduced by "
                      f"{self.robust or 'worst_case'}; winner's worst-trace "
                      f"score ${self.winner.worst_trace_score():.2f}, "
                      f"worst-trace attainment "
                      f"{self.winner.worst_trace_attainment() * 100:.2f}%"]
        lines += ["", f"simulation budget: {self.sims_used} of "
                  f"{self.full_budget} candidate-seed-trace sims "
                  f"({self.budget_frac * 100:.0f}% of the naive sweep)"]
        if self.surface is not None:
            lines += [f"response surface over "
                      f"({', '.join(self.surface_names)}): "
                      f"r2 = {self.surface.r2:.3f}"]
        lines += ["", "cost-vs-attainment Pareto frontier:",
                  frontier_table(self.frontier)]
        timing = self.timing_breakdown()
        if timing:
            lines += ["", "timing breakdown (telemetry spans):", timing]
        art = self.ascii_surface()
        if art:
            lines += ["", art]
        return "\n".join(lines)

    def timing_breakdown(self) -> str:
        """Rendered span tree of this tune (sample -> racing rounds ->
        culls -> refine, with the compiled backend's ``torchsim.dispatch``
        spans nested where they ran: cold or warm, and eager, capture or
        replay). Empty string when telemetry was off."""
        if self.spans is None:
            return ""
        from repro_torch.fleet.telemetry import render_spans
        return render_spans([self.spans])

    # ---- serialization -----------------------------------------------------

    FORMAT = "tuning-report"
    VERSION = 1

    def to_json(self, *, include_evals: bool = True,
                include_spans: bool = False,
                include_sojourns: bool = False) -> dict:
        """Plain-JSON form of the report: winner, frontier, the surviving
        region (``evals`` with their racing-round counts — what
        ``warm_start_candidates`` and the oracle builder consume), surface,
        objective and budget. ``_scenario`` is a live object and is never
        serialized: a loaded report can seed a warm re-tune or an oracle
        cell but cannot ``build_policy()`` (re-attach a scenario for that).
        """
        d = {
            "format": self.FORMAT,
            "version": self.VERSION,
            "scenario_name": self.scenario_name,
            "policy_family": self.policy_family,
            "objective": self.objective.to_json(),
            "winner": self.winner.to_json(include_sojourns=include_sojourns),
            "frontier": [e.to_json(include_sojourns=include_sojourns)
                         for e in self.frontier],
            "baseline": (None if self.baseline is None else
                         self.baseline.to_json(
                             include_sojourns=include_sojourns)),
            "surface": (None if self.surface is None
                        else self.surface.to_json()),
            "surface_names": list(self.surface_names),
            "sims_used": int(self.sims_used),
            "full_budget": int(self.full_budget),
            "robust": self.robust,
            "n_traces": int(self.n_traces),
            "space": None if self.space is None else self.space.to_json(),
        }
        if include_evals:
            d["evals"] = [e.to_json(include_sojourns=include_sojourns)
                          for e in self.evals]
        if include_spans and self.spans is not None:
            d["spans"] = _span_to_json(self.spans)
        return d

    @staticmethod
    def from_json(d: dict) -> "TuningReport":
        from repro_torch.fleet.tuning.evaluate import CandidateEval, Objective
        from repro_torch.fleet.tuning.space import ParamSpace

        if d.get("format") != TuningReport.FORMAT:
            raise ValueError(f"not a tuning report (format="
                             f"{d.get('format')!r})")
        if int(d.get("version", -1)) > TuningReport.VERSION:
            raise ValueError(f"tuning report version {d.get('version')} is "
                             f"newer than this reader "
                             f"(<= {TuningReport.VERSION})")
        surface = (None if d.get("surface") is None
                   else ResponseSurface.from_json(d["surface"]))
        return TuningReport(
            scenario_name=d["scenario_name"],
            policy_family=d["policy_family"],
            objective=Objective.from_json(d["objective"]),
            winner=CandidateEval.from_json(d["winner"]),
            frontier=tuple(CandidateEval.from_json(e)
                           for e in d.get("frontier", [])),
            surface=surface,
            surface_names=tuple(d.get("surface_names", ())),
            sims_used=int(d.get("sims_used", 0)),
            full_budget=int(d.get("full_budget", 0)),
            baseline=(None if d.get("baseline") is None
                      else CandidateEval.from_json(d["baseline"])),
            evals=[CandidateEval.from_json(e) for e in d.get("evals", [])],
            space=(None if d.get("space") is None
                   else ParamSpace.from_json(d["space"])),
            robust=d.get("robust"),
            n_traces=int(d.get("n_traces", 1)),
            spans=(None if d.get("spans") is None
                   else _span_from_json(d["spans"])))


def _span_to_json(span) -> dict:
    return {"name": span.name, "attrs": dict(span.attrs),
            "duration_s": span.duration_s,
            "children": [_span_to_json(c) for c in span.children]}


def _span_from_json(d: dict):
    from repro_torch.fleet.telemetry.spans import Span
    return Span(name=d["name"], attrs=dict(d.get("attrs", {})),
                duration_s=d.get("duration_s"),
                children=[_span_from_json(c) for c in d.get("children", [])])
