"""The card's SM clock, power draw and temperature, sampled beside the window.

``nvidia-smi`` runs as one child process that samples every ``period_ms`` into a
file; it is stopped, and waited for, when the window closes. Where the tool is
missing the run goes on with no samples.
"""

from __future__ import annotations

import shutil
import statistics
import subprocess
from pathlib import Path

FIELDS = "timestamp,clocks.sm,power.draw,temperature.gpu"


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them (empty without it)."""
    tool = shutil.which("nvidia-smi")
    if tool is None:
        return {}
    out = subprocess.run(
        [tool, "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30,
    )
    if out.returncode != 0 or not out.stdout.strip():
        return {}
    name, limit = [x.strip() for x in out.stdout.splitlines()[0].split(",")]
    return {"name": name, "power_limit_w": float(limit)}


class Sampler:
    def __init__(self, path: Path, period_ms: int = 200):
        self.path, self.period_ms, self.proc, self.file = Path(path), period_ms, None, None

    def __enter__(self):
        tool = shutil.which("nvidia-smi")
        if tool is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.file = open(self.path, "w")
            self.proc = subprocess.Popen(
                [tool, f"--query-gpu={FIELDS}", "--format=csv,noheader,nounits",
                 "-lms", str(self.period_ms)],
                stdout=self.file, stderr=subprocess.DEVNULL,
            )
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.file.close()
        return False

    def summary(self) -> dict:
        """Mean, least and most SM clock (MHz), power (W) and temperature (C) sampled."""
        rows = []
        if self.path.exists():
            for line in self.path.read_text().splitlines():
                parts = [p.strip() for p in line.split(",")]
                try:
                    rows.append([float(p) for p in parts[1:4]])
                except ValueError:
                    continue
        if not rows:
            return {}
        out = {"samples": len(rows)}
        for i, key in enumerate(("sm_mhz", "power_w", "temp_c")):
            col = [r[i] for r in rows]
            out[key] = [min(col), statistics.fmean(col), max(col)]
        return out
