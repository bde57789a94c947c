"""The benchmark's files against its own contract, its arithmetic, and its imports.

CPU only: nothing here needs a card or imports the port.
"""

from __future__ import annotations

import ast
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
sys.path[:0] = [str(REPO)]

from portbench import counts, harness, stats, telemetry  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_loads_and_reports_what_the_contract_asks(workload):
    cell = harness.load_cell(workload, BENCH)
    assert (ROOT / "loops" / f"{cell.traffic['loop']}.py").is_file()
    assert set(harness.systems(cell)) == {"port", "control"}
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))
    assert cell.limits["limits"] and all(v > 0 for v in cell.limits["limits"].values())
    if cell.system == "mset2":
        for key in ("n_signals", "n_memvec", "n_train", "kind", "reg", "precision", "sprt"):
            assert key in cell.config


def test_mfu_counts_all_three_products_at_fig8():
    m = b = 8192
    n = 1024
    flops = counts.surveil_flops(m, b, n)
    assert flops == 2 * m * b * n + 2 * m * m * b + 2 * b * m * n
    assert round(flops / 1e12, 3) == 1.374


def test_kernel_counts():
    assert counts.k1_flops(8192, 8192, 1024) == 2 * 8192 * 8192 * 1024
    assert counts.k1_bytes(2, 3, 5) == 4 * ((2 + 3) * 5 + 2 * 3)
    # K1 at fig8 is bound by operations, K3 by bytes: 13 an element
    assert counts.k1_seconds_at_roofline(8192, 8192, 1024) == pytest.approx(
        2 * 8192**2 * 1024 / 495e12)
    assert counts.k3_seconds_at_roofline(8192, 1024) == pytest.approx(13 * 8192 * 1024 / 3.35e12)


def test_percentile_is_taken_over_every_sample():
    values = list(range(1, 101))  # 1..100
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values[::-1], 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(1, 1001)), 95) == 950
    with pytest.raises(ValueError):
        stats.percentile([], 95)
    assert stats.quarter_means([1, 1, 1, 1, 2, 2, 2, 2]) == (1, 2)
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def test_p95_reader_takes_every_batch():
    run = harness.Run(cell=None, seed=0, traced=False, latencies_ms=[float(i) for i in range(200)])
    assert harness.reader("p95_ms")(run) == 189.0


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 3])
def test_traffic_is_the_same_under_a_seed(seed):
    p = json.loads((ROOT / "configs" / "mset2-fig8-1024x8192-reg1e-2.json").read_text())["telemetry"]
    a = telemetry.series(seed, 300, 16, p, "cpu")
    b = telemetry.series(seed, 300, 16, p, "cpu")
    c = telemetry.series(seed + 1, 300, 16, p, "cpu")
    assert a.is_contiguous() and a.shape == (300, 16) and a.isfinite().all()
    assert bytes(a.numpy()) == bytes(b.numpy()) and not (a == c).all()
    scale = a.std(dim=0)
    f1 = telemetry.add_faults(a.clone(), seed, 3, 0.25, 6.0, scale)
    f2 = telemetry.add_faults(b.clone(), seed, 3, 0.25, 6.0, scale)
    assert (f1 == f2).all() and int(((f1 - a).abs().sum(0) > 0).sum()) == 4
    assert harness.draw_samples(seed, 100, 2) == harness.draw_samples(seed, 100, 2)


def test_ar2_response_is_the_recursion():
    h = telemetry.ar2_response(0.85, -0.1).numpy()
    y = [1.0, 0.85]
    for _ in range(len(h) - 2):
        y.append(0.85 * y[-1] - 0.1 * y[-2])
    assert (abs(h / h[0] - y) < 1e-12).all() and abs((h * h).sum() - 1) < 1e-12


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            tops |= {a.value.split(".")[0] for a in node.args if isinstance(a, ast.Constant)}
    return tops


def test_nothing_imports_jax_or_the_jax_package_or_reads_the_old_benchmarks():
    files = sorted(ROOT.rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & set(harness.FORBIDDEN), f
        if not f.name.startswith("test_"):
            assert "benchmarks" not in f.read_text(), f
    # by whole top-level name: the port's name begins with the JAX package's
    assert "repro_torch" in _imports(ROOT / "systems" / "mset2.py")
    assert "repro" not in {m.split(".")[0] for m in ["repro_torch.mset", "repro_torchx"]}


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.mset", "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.mset.sprt", "numpy"]) == ["repro"]
    assert harness.forbidden_modules(["jax", "jaxlib.xla", "flax.linen"]) == ["flax", "jax", "jaxlib"]


TOY_LOOP = '''
"""A toy loop: each unit sums the rows of one input through the system."""
import time

import torch


class Loop:
    def __init__(self, run, dev, sut, cell):
        self.run, self.dev, self.sut, self.cfg = run, dev, sut, cell.config

    def setup(self):
        self.sut.prepare(self.cfg)
        g = torch.Generator().manual_seed(self.run.seed)
        self.x = torch.randn(self.cfg["rows"], self.cfg["width"], generator=g, dtype=torch.float64)
        t = time.perf_counter()
        self.window(units=2, measure=False)
        return (time.perf_counter() - t) / 2

    def window(self, seconds=None, units=None, measure=True, samples=()):
        self.sampled, sub, done = {}, [], []
        t_start = time.perf_counter()
        t_end = t_start + seconds if seconds is not None else float("inf")
        k = 0
        while (units is None or k < units) and (k == 0 or time.perf_counter() < t_end):
            sub.append(time.perf_counter())
            out = self.sut.step(self.x)
            done.append(time.perf_counter())
            if k in samples:
                self.sampled[k] = out
            k += 1
        if measure:
            self.run.units, self.run.unit_obs = k, self.cfg["rows"]
            self.run.window_s = done[-1] - t_start
            self.run.latencies_ms = [(d - s) * 1e3 for s, d in zip(sub, done)]
            self.run.intervals_ms = [(b - a) * 1e3 for a, b in zip(done, done[1:])]

    def free(self):
        pass

    def check(self):
        ref = self.x.sum(dim=1)
        gap = max((float((out - ref).abs().max()) for out in self.sampled.values()), default=0.0)
        return {"sum_gap": gap, "checked": len(self.sampled)}
'''

TOY_SYSTEM = '''
"""A toy system: row sums, exact (the port) and in bfloat16 (the control)."""
import torch


class Port:
    def prepare(self, cfg):
        self.width = cfg["width"]

    def step(self, x):
        return x.sum(dim=1)


class Control(Port):
    def step(self, x):
        return x.to(torch.bfloat16).sum(dim=1).to(x.dtype)


SYSTEMS = {"port": Port, "control": Control}
'''


def _toy_bench(tmp_path: Path) -> tuple[dict, Path]:
    """A benchmark of one toy cell whose loop and system exist only as files under
    ``tmp_path/bench``; the metrics' readers are the benchmark's own."""
    root = tmp_path / "bench"
    files = {
        "loops/toy.py": TOY_LOOP,
        "systems/toy.py": TOY_SYSTEM,
        "traffic/toy-mix.json": json.dumps({"loop": "toy", "samples": 2}),
        "configs/toy-config.json": json.dumps({"name": "toy-config", "system": "toy",
                                               "rows": 256, "width": 512}),
        "limits/toy-cell.json": json.dumps({"limits": {"sum_gap": 1e-9}}),
    }
    for rel, text in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    by_name = {m["name"]: m for m in BENCH["end_to_end"]}
    bench = {
        "configs": [{"name": "toy-config", "file": "bench/configs/toy-config.json"}],
        "workloads": [{"name": "toy-cell", "config": "toy-config", "traffic": "toy-mix",
                       "chips": 1}],
        "end_to_end": [dict(by_name[n], workloads=["toy-cell"])
                       for n in ("setup_s", "obs_per_s", "p95_ms")],
        "per_layer": [],
    }
    return bench, root


def test_a_loop_and_a_system_are_found_from_their_files_alone(tmp_path):
    bench, root = _toy_bench(tmp_path)
    cell = harness.load_cell("toy-cell", bench, root=root)
    assert cell.system == "toy" and cell.traffic["loop"] == "toy"
    run = harness.run(cell, 2**33 + 1, 0.2, False, device="cpu", out_dir=tmp_path / "out")
    out = harness.result(run, "cpu", 1)
    assert out["correct"] and run.units > 2 and out["attempted"] == run.units
    m = out["metrics"]
    assert m["obs_per_s"]["value"] == run.units * 256 / run.window_s
    assert m["p95_ms"]["value"] == stats.percentile(run.latencies_ms, 95)
    assert len(run.latencies_ms) == run.units and m["setup_s"]["value"] == run.setup_s
    # the control is the toy system's own, by name
    control = harness.run(cell, 2**33 + 1, 0.2, False, device="cpu",
                          sut=harness.systems(cell)["control"](), out_dir=tmp_path / "out")
    ok, shown = harness.verdict(control)
    assert not ok and shown["sum_gap"]["value"] > 1e-3


def test_a_missing_loop_or_system_is_named(tmp_path):
    bench, root = _toy_bench(tmp_path)
    (root / "systems" / "toy.py").unlink()
    cell = harness.load_cell("toy-cell", bench, root=root)
    with pytest.raises(SystemExit, match="no system 'toy'"):
        harness.run(cell, 1, 0.1, False, device="cpu")


def test_the_harness_names_no_loop_and_no_system():
    """Loops and systems are found by name, from files: the harness holds no table of
    them and imports neither a loop's reference nor a system."""
    assert not hasattr(harness, "LOOPS") and not hasattr(harness, "SYSTEMS")
    tree = ast.parse((ROOT / "harness.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            imported |= {node.module} | {f"{node.module}.{a.name}" for a in node.names}
        elif isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
    assert not {m for m in imported
                if m.startswith(("portbench.reference", "portbench.system", "repro_torch"))}
    classes = {n.name for n in ast.walk(tree) if isinstance(n, ast.ClassDef)}
    assert classes == {"Cell", "Device", "Run"}
