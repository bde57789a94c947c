"""The port's telemetry core (``repro_torch._telemetry``) on the MSET2 path, on the CPU:
its spans under ``torch.profiler`` and in a session, the off path, the trace's clock,
the kernels' build span and counter, and the device counters a session keeps.
"""

import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import _telemetry
from repro_torch.fleet import telemetry as fleet_telemetry
from repro_torch.kernels import _build
from repro_torch.mset import SPRTParams, estimate, sprt, train
from torch_parity_data import WELL_POSED, telemetry

TRAIN = {
    "mset2.train": [
        "mset2.train.standardize",
        "mset2.train.memory_vectors",
        "mset2.train.bandwidth",
        "mset2.train.similarity",
        "mset2.train.pinv",
    ]
}
ESTIMATE = {
    "mset2.estimate": [
        "mset2.estimate.standardize",
        "mset2.estimate.similarity",
        "mset2.estimate.ginv_k",
        "mset2.estimate.wt_d",
        "mset2.estimate.residuals",
    ]
}
# an ATen op each step must hold (the products, the solver, the pointwise passes)
HOLDS = {
    "mset2.train.standardize": "aten::std",
    "mset2.train.bandwidth": "aten::sort",
    "mset2.train.pinv": "aten::linalg_eigh",
    "mset2.estimate.standardize": "aten::div",
    "mset2.estimate.ginv_k": "aten::mm",
    "mset2.estimate.wt_d": "aten::mm",
    "mset2.estimate.residuals": "aten::sub",
}


def _data():
    seed, n_signals, n_obs, n_memvec = WELL_POSED[0]
    X = torch.from_numpy(telemetry(seed, n_obs, n_signals))
    return X, n_obs * 3 // 4, n_memvec


def _run(X, n_tr, n_memvec):
    model = train(X[:n_tr], n_memvec)
    _, r = estimate(model, X[n_tr:])
    sigma = torch.std(r, dim=0, correction=0)
    return model, r, sprt(r, sigma, SPRTParams())


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [
        (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), bool(e.is_user_annotation()))
        for e in prof.profiler.kineto_results.events()
    ]
    return out, events


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spans_nest_under_the_profiler_and_hold_their_steps_ops():
    X, n_tr, n_memvec = _data()
    _, events = _profiled(lambda: _run(X, n_tr, n_memvec))
    ranges = {}
    for e in events:
        if e[3] and e[0].startswith("mset2."):
            assert e[0] not in ranges, f"{e[0]} twice"
            ranges[e[0]] = e
    want = [*TRAIN, *TRAIN["mset2.train"], *ESTIMATE, *ESTIMATE["mset2.estimate"], "mset2.sprt"]
    assert sorted(ranges) == sorted(want)
    ops = [e for e in events if not e[3] and e[0].startswith("aten::")]
    for parent, children in {**TRAIN, **ESTIMATE}.items():
        kids = [ranges[c] for c in children]
        assert all(_inside(k, ranges[parent]) for k in kids)
        assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:])), "children in order"
        # every ATen op the step ran lies inside exactly one of its children
        under = [o for o in ops if _inside(o, ranges[parent])]
        assert under and all(sum(_inside(o, k) for k in kids) == 1 for o in under)
    for name, op in HOLDS.items():
        assert any(o[0] == op and _inside(o, ranges[name]) for o in ops), (name, op)
    for name in ("mset2.estimate.ginv_k", "mset2.estimate.wt_d"):  # one product each
        assert sum(o[0] == "aten::mm" and _inside(o, ranges[name]) for o in ops) == 1
    assert any(_inside(o, ranges["mset2.sprt"]) for o in ops)
    assert not _inside(ranges["mset2.sprt"], ranges["mset2.estimate"])


def test_off_path_enters_no_range_and_tracing_changes_no_bit(monkeypatch):
    X, n_tr, n_memvec = _data()
    profiled, _ = _profiled(lambda: _run(X, n_tr, n_memvec))
    with _telemetry.session():
        session_on = _run(X, n_tr, n_memvec)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert _telemetry.active() is None and not torch.autograd._profiler_enabled()
    assert _telemetry.span("mset2.train") is _telemetry.span("mset2.estimate")
    with _telemetry.span("mset2.train", k=1) as s:
        assert s is None
    off = _run(X, n_tr, n_memvec)
    with _telemetry.session() as tel:  # a session alone needs no profiler range
        on = _run(X, n_tr, n_memvec)
    assert [s.name for s in tel.tracer.roots] == ["mset2.train", "mset2.estimate", "mset2.sprt"]
    for a, b in ((off, on), (off, session_on), (off, profiled)):
        assert torch.equal(a[0].Ginv, b[0].Ginv) and torch.equal(a[1], b[1])
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


def test_session_spans_start_on_the_trace_clock():
    X, n_tr, n_memvec = _data()

    def traced():
        with _telemetry.session() as tel:
            _run(X, n_tr, n_memvec)
        return tel

    tel, events = _profiled(traced)
    starts = {e[0]: e[1] for e in events if e[3] and e[0].startswith("mset2.")}
    spans = [s for root in tel.tracer.roots for s, _, _ in root.walk()]
    assert {s.name for s in spans} == set(starts)
    for s in spans:
        # a perf_counter start would be ~1.8e18 ns off
        assert abs(s.start_ns - starts[s.name]) < 50_000_000, s.name
        assert s.duration_s >= 0 and s.events is None and s.device_ms is None
    tree = tel.tracer.render()
    assert tree.splitlines()[0].startswith("mset2.train ")
    assert "\n  mset2.train.pinv " in tree and "\n  mset2.estimate.ginv_k " in tree


def test_one_session_holds_fleet_and_mset2_spans_and_imports_stay_apart():
    X, n_tr, n_memvec = _data()
    assert fleet_telemetry.span is _telemetry.span
    assert fleet_telemetry.session is _telemetry.session
    assert fleet_telemetry.Telemetry is _telemetry.Telemetry
    with fleet_telemetry.session() as tel:
        with fleet_telemetry.span("control.run", scenario="s"):
            train(X[:n_tr], n_memvec)
        fleet_telemetry.counter("fleet_control_alarms_total")
    (root,) = tel.tracer.roots
    assert root.name == "control.run" and root.find("mset2.train.pinv") is not None
    assert tel.tracer.find("mset2.train.similarity").attrs == {}
    assert tel.metrics.get("fleet_control_alarms_total").value == 1.0
    # MSET2 and the kernels import the telemetry core, never the fleet package
    code = (
        "import sys, repro_torch.mset, repro_torch.kernels._build, repro_torch._telemetry; "
        "print(sorted(m for m in sys.modules if m.startswith('repro_torch.fleet')))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_kernel_build_is_a_span_and_a_counter(monkeypatch, tmp_path):
    source = tmp_path / "kern.cu"
    source.write_text("// a kernel\n")
    lib = tmp_path / "kern.so"
    results = iter([_build.BuildResult(lib, "", 2.5, cached=False)])
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", lambda src: next(results))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("dll", path))
    with _telemetry.session() as tel:
        assert _build.load(source) == ("dll", str(lib))
        assert _build.load(source) == ("dll", str(lib))  # loaded once a process
    (s,) = tel.tracer.roots
    assert (s.name, s.attrs) == ("kernels.build", {"kernel": "kern", "cached": False})
    assert tel.metrics.get("kernel_builds_total", kernel="kern", cached="false").value == 1.0
    assert 'kernel_builds_total{cached="false",kernel="kern"} 1.0' in tel.prometheus()
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", lambda src: _build.BuildResult(lib, "", 0.0, True))
    assert _build.load(source) == ("dll", str(lib))  # no session: nothing recorded


def test_device_counters_are_read_at_export(tmp_path):
    assert _telemetry.device_counter("sprt_rerun_steps_total", "cpu", size=2) is None
    with _telemetry.session() as tel:
        t = _telemetry.device_counter("sprt_rerun_steps_total", "cpu", size=2)
        assert t.tolist() == [0, 0] and t.dtype == torch.int64
        assert _telemetry.device_counter("sprt_rerun_steps_total", "cpu", size=2) is t
        t += torch.tensor([5, 3])
        t += torch.tensor([2, 4])
    assert tel.metrics.get("sprt_rerun_steps_total").value == 0.0  # not read yet
    assert "sprt_rerun_steps_total 7.0" in tel.prometheus()
    tel.export_jsonl(tmp_path / "events.jsonl")
    assert '"name": "sprt_rerun_steps_total"' in (tmp_path / "events.jsonl").read_text()
    # the plain SPRT re-runs nothing: a CPU run in a session adds no counter
    with _telemetry.session() as tel:
        sprt(torch.randn(64, 3), torch.ones(3))
    assert tel.device_counters == {}


def test_spans_export_their_start_and_path():
    with _telemetry.session() as tel:
        with _telemetry.span("outer", a=1):
            with _telemetry.span("inner"):
                pass
    (row, inner) = tel.tracer.to_events()
    assert row["start_ns"] > 1.7e18 and row["device_ms"] is None and row["attr_a"] == 1
    assert inner["path"] == "outer/inner" and inner["depth"] == 1
    assert inner["start_ns"] >= row["start_ns"]
