"""Markdown/CSV rendering of scoping results (EXPERIMENTS.md feedstock)."""
from __future__ import annotations

from typing import Optional


def markdown_table(headers: list, rows: list) -> str:
    out = ["| " + " | ".join(str(h) for h in headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(c) for c in r) + " |")
    return "\n".join(out)


def fmt_si(v: Optional[float], unit: str = "") -> str:
    if v is None:
        return "—"
    for thr, suf in [(1e15, "P"), (1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")]:
        if abs(v) >= thr:
            return f"{v / thr:.2f}{suf}{unit}"
    return f"{v:.3g}{unit}"


def fmt_time(s: Optional[float]) -> str:
    if s is None:
        return "—"
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.1f}us"


def csv_rows(result) -> str:
    names = result.param_names()
    lines = [",".join(names + ["cost_s"])]
    for r in result.rows:
        lines.append(",".join(str(r.params[n]) for n in names) + f",{r.cost():.6e}")
    return "\n".join(lines)
