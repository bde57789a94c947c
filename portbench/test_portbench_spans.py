"""The readers of the program's own spans, on a hand-built trace: known device
operations, host ranges and idle gaps in, exact values out, and nothing where the
program has no such span.

CPU only: nothing here needs a card or imports the port.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT.parent)]

from portbench import harness  # noqa: E402
from portbench.trace import DeviceOp, HostEvent, Trace  # noqa: E402

MS = 1_000_000  # ns


def _run(trace, units=2):
    return harness.Run(cell=None, seed=0, traced=True, units=units, trace=trace)


def _estimate_trace(prefix="mset2.estimate"):
    """Two batches: each a span per step, one kernel launched in each, and a kernel
    of the library named ``gemm`` in each product."""
    host, ops = [], []
    for b in range(2):
        t = 100 * MS * b
        host.append(HostEvent(prefix, t, t + 50 * MS, True))
        steps = ("standardize", "similarity", "ginv_k", "wt_d", "residuals")
        for i, step in enumerate(steps):
            s = t + (1 + 10 * i) * MS
            host.append(HostEvent(f"{prefix}.{step}", s, s + 5 * MS, True))
            host.append(HostEvent("cudaLaunchKernel", s + MS, s + 2 * MS, False))
            kernel = "sm80_xmma_gemm_f32f32" if step in ("ginv_k", "wt_d") else step + "_kernel"
            # durations a step: 1, 2, 3, 4 and 5 ms (ginv_k 3, wt_d 4)
            ops.append(DeviceOp(kernel, s + 2 * MS, s + (3 + i) * MS, s + MS))
    # a kernel launched outside every span, and one whose launch is unknown
    ops.append(DeviceOp("sm80_xmma_gemm_f32f32", 300 * MS, 301 * MS, 299 * MS))
    ops.append(DeviceOp("orphan_gemm", 302 * MS, 303 * MS, None))
    host.append(HostEvent("cudaLaunchKernel", 299 * MS, 299 * MS + 10, False))
    return Trace((0, 400 * MS), ops, host)


@pytest.mark.parametrize(
    "metric,per_batch_ms",
    [("ginv_k_ms.surveil", 3.0), ("wt_d_ms.surveil", 4.0), ("pointwise_ms.surveil", 1.0 + 5.0),
     ("wt_d_ms.scope", 4.0)],
)
def test_estimate_span_readers_take_what_their_spans_launched(metric, per_batch_ms):
    assert harness.reader(metric)(_run(_estimate_trace())) == pytest.approx(per_batch_ms)
    # the library's GEMMs outside the spans are not the spans': 2 x (3 + 4) + 1 + 1
    assert _estimate_trace().device_s(r"gemm") * 1e3 == pytest.approx(16.0)


@pytest.mark.parametrize("metric", ["ginv_k_ms.surveil", "wt_d_ms.surveil", "pointwise_ms.surveil",
                                    "wt_d_ms.scope"])
def test_estimate_span_readers_find_nothing_without_the_programs_spans(metric):
    read = harness.reader(metric)
    assert read(_run(_estimate_trace(prefix="bench.estimate"))) is None  # the parent's trace
    assert read(_run(_estimate_trace(prefix="mset2.estimate.other"))) is None  # anchored
    assert read(_run(None)) is None
    assert read(_run(_estimate_trace(), units=0)) is None


def _scope_trace(pinv=("mset2.train.pinv",)):
    """A 100 ms window: the device busy over [0, 10), [20, 30), [34, 36) and [60, 100)
    ms, two pinv ranges over [15, 40) and [55, 70) ms, and a range named alike over
    the idle [40, 50) ms that is not the program's span."""
    ops = [
        DeviceOp("k", s * MS, e * MS, None)
        for s, e in ((0, 10), (20, 30), (34, 36), (60, 100), (35, 36))
    ]
    host = [HostEvent(n, 15 * MS, 40 * MS, True) for n in pinv]
    host += [HostEvent(n, 55 * MS, 70 * MS, True) for n in pinv]
    host.append(HostEvent("mset2.train.pinv.inner", 40 * MS, 50 * MS, True))
    host.append(HostEvent("mset2.train", 0, 100 * MS, True))
    return Trace((0, 100 * MS), ops, host)


def test_pinv_idle_reader_intersects_idle_time_with_the_span():
    read = harness.reader("pinv_idle_ms.scope")
    # idle inside [15, 40): [15, 20) + [30, 34) + [36, 40) = 13 ms; inside [55, 70): 5 ms
    assert read(_run(_scope_trace(), units=1)) == pytest.approx(18.0)
    assert read(_run(_scope_trace(), units=2)) == pytest.approx(9.0)
    # the window's whole idle time (38 ms) bounds it
    t = _scope_trace()
    assert (t.window_s - t.busy_s) * 1e3 == pytest.approx(38.0)
    # overlapping ranges count once
    twice = _scope_trace(pinv=("mset2.train.pinv", "mset2.train.pinv"))
    assert read(_run(twice, units=1)) == pytest.approx(18.0)
    # a span clipped to the window, and one with no idle time in it
    clipped = Trace((20 * MS, 60 * MS), t.ops, t.host)
    assert read(_run(clipped, units=1)) == pytest.approx(4.0 + 4.0 + 5.0)
    busy = Trace((0, 10 * MS), [DeviceOp("k", 0, 10 * MS, None)],
                 [HostEvent("mset2.train.pinv", 2 * MS, 8 * MS, True)])
    assert read(_run(busy, units=1)) == 0.0


def test_pinv_idle_reader_finds_nothing_without_the_span():
    read = harness.reader("pinv_idle_ms.scope")
    assert read(_run(_scope_trace(pinv=()), units=1)) is None
    assert read(_run(_scope_trace(pinv=("bench.eigh pseudo-inverse",)), units=1)) is None
    assert read(_run(None, units=1)) is None
    assert read(_run(_scope_trace(), units=0)) is None


def test_k1_reader_takes_both_of_k1s_kernels_a_cell():
    read = harness.reader("k1_ms.scope")
    ops = [DeviceOp("void (anonymous namespace)::similarity_tc_kernel<0, true>", 0, 100 * MS, None),
           DeviceOp("void (anonymous namespace)::split_kernel<float>", 100 * MS, 105 * MS, None),
           DeviceOp("(anonymous namespace)::gemm_split_t_kernel", 105 * MS, 106 * MS, None),
           DeviceOp("void symv_lo_direct_kernel", 106 * MS, 200 * MS, None)]
    t = Trace((0, 200 * MS), ops, [])
    assert read(_run(t, units=1)) == pytest.approx(105.0)
    assert read(_run(t, units=2)) == pytest.approx(52.5)
    assert read(_run(Trace((0, 200 * MS), ops[3:], []), units=1)) is None
    assert read(_run(None, units=1)) is None and read(_run(t, units=0)) is None
