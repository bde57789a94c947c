"""3-D response-surface methodology (paper Figs. 4-8): fit compute cost as a
parametric function of the ML design parameters, in log-log space (costs scale
polynomially, so log-log quadratic captures them well), and render ASCII contour
surfaces for terminal reports.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ResponseSurface:
    """Fitted log-log polynomial surface.

    ``box_lo``/``box_hi`` (log-space, per dim) bound the sample the fit saw.
    A quadratic extrapolated outside its design region grows without bound —
    silently returning those values poisons anything downstream (a tuner
    chasing a fictitious minimum, an oracle interpolating a fantasy cost).
    Queries outside the box are clamped to its hull and flag
    ``extrapolated`` instead; surfaces built without a box (hand-constructed)
    keep the old unclamped behaviour.
    """
    names: list
    coef: np.ndarray
    r2: float
    degree: int
    box_lo: np.ndarray = None       # (k,) log-space fitted sample min
    box_hi: np.ndarray = None       # (k,) log-space fitted sample max
    extrapolated: bool = False      # last predict* clamped at least one query

    def _clamp(self, L: np.ndarray) -> np.ndarray:
        if self.box_lo is None or self.box_hi is None:
            self.extrapolated = False
            return L
        C = np.clip(L, self.box_lo, self.box_hi)
        self.extrapolated = bool(np.any(C != L))
        return C

    def predict(self, params: dict) -> float:
        x = np.array([[float(params[n]) for n in self.names]])
        L = self._clamp(np.log(x))
        return float(np.exp(_design(L, self.degree) @ self.coef)[0])

    def predict_many(self, X: np.ndarray) -> np.ndarray:
        L = self._clamp(np.log(np.asarray(X, float)))
        return np.exp(_design(L, self.degree) @ self.coef)

    def to_json(self) -> dict:
        return {
            "names": list(self.names),
            "coef": [float(c) for c in np.asarray(self.coef).ravel()],
            "r2": float(self.r2),
            "degree": int(self.degree),
            "box_lo": (None if self.box_lo is None
                       else [float(v) for v in self.box_lo]),
            "box_hi": (None if self.box_hi is None
                       else [float(v) for v in self.box_hi]),
        }

    @staticmethod
    def from_json(d: dict) -> "ResponseSurface":
        return ResponseSurface(
            names=list(d["names"]), coef=np.asarray(d["coef"], float),
            r2=float(d["r2"]), degree=int(d["degree"]),
            box_lo=(None if d.get("box_lo") is None
                    else np.asarray(d["box_lo"], float)),
            box_hi=(None if d.get("box_hi") is None
                    else np.asarray(d["box_hi"], float)))


def _design(L: np.ndarray, degree: int) -> np.ndarray:
    """Design matrix for log-space polynomial: 1 + linear + (quadratic+cross)."""
    cols = [np.ones(len(L))]
    k = L.shape[1]
    cols += [L[:, i] for i in range(k)]
    if degree >= 2:
        for i in range(k):
            for j in range(i, k):
                cols.append(L[:, i] * L[:, j])
    return np.stack(cols, axis=1)


def _n_cols(k: int, degree: int) -> int:
    return 1 + k + (k * (k + 1) // 2 if degree >= 2 else 0)


def fit_response_surface(names, X, y, degree: int = 2) -> ResponseSurface:
    """X: (n, k) raw params; y: (n,) positive costs.

    A fit with fewer usable points than design-matrix columns is
    underdetermined — lstsq would happily return one of infinitely many
    interpolants (r2 == 1, garbage everywhere off the data). Rather than hand
    back a surface nothing downstream can trust, degrade to ``degree=1`` when
    the quadratic is underdetermined, and raise when even the linear fit is.
    """
    X = np.asarray(X, float)
    y = np.asarray(y, float)
    keep = (y > 0) & np.all(X > 0, axis=1)
    L, ly = np.log(X[keep]), np.log(y[keep])
    k = L.shape[1]
    while degree > 1 and len(ly) < _n_cols(k, degree):
        degree -= 1
    if len(ly) < _n_cols(k, degree):
        raise ValueError(
            f"fit_response_surface: {len(ly)} usable point(s) cannot "
            f"determine even a degree-1 surface in {k} dim(s) "
            f"(need >= {_n_cols(k, 1)}); widen the design or drop dims")
    A = _design(L, degree)
    coef, *_ = np.linalg.lstsq(A, ly, rcond=None)
    pred = A @ coef
    ss_res = float(np.sum((ly - pred) ** 2))
    ss_tot = float(np.sum((ly - ly.mean()) ** 2)) or 1.0
    return ResponseSurface(list(names), coef, 1.0 - ss_res / ss_tot, degree,
                           box_lo=L.min(axis=0), box_hi=L.max(axis=0))


_RAMP = " .:-=+*#%@"


def render_ascii_surface(xs, ys, Z, x_name: str = "x", y_name: str = "y",
                         title: str = "") -> str:
    """Z[i, j] = cost at (ys[i], xs[j]). Log-scaled density ramp, blue->red in the
    paper; here ' ' (cheap) -> '@' (expensive)."""
    Z = np.asarray(Z, float)
    lz = np.log(np.where(Z > 0, Z, np.nan))
    lo, hi = np.nanmin(lz), np.nanmax(lz)
    span = (hi - lo) or 1.0
    lines = []
    if title:
        lines.append(title)
    lines.append(f"rows: {y_name} (bottom=min) / cols: {x_name} (left=min)  "
                 f"ramp '{_RAMP}' = log cost min->max")
    for i in range(Z.shape[0] - 1, -1, -1):
        row = []
        for j in range(Z.shape[1]):
            v = lz[i, j]
            if np.isnan(v):
                row.append("·")   # infeasible cell (paper: missing surface region)
            else:
                row.append(_RAMP[min(int((v - lo) / span * (len(_RAMP) - 1e-9)), len(_RAMP) - 1)])
        lines.append(f"{ys[i]:>10g} |" + "".join(row))
    lines.append(" " * 11 + "+" + "-" * Z.shape[1])
    lines.append(" " * 12 + " ".join(f"{x:g}" for x in xs))
    return "\n".join(lines)


def grid_to_matrix(rows, x_name: str, y_name: str, cost_key=None):
    """Pivot CellResult rows into (xs, ys, Z) for rendering."""
    xs = sorted({r.params[x_name] for r in rows})
    ys = sorted({r.params[y_name] for r in rows})
    Z = np.full((len(ys), len(xs)), np.nan)
    for r in rows:
        i = ys.index(r.params[y_name])
        j = xs.index(r.params[x_name])
        Z[i, j] = r.cost() if cost_key is None else cost_key(r)
    return xs, ys, Z
