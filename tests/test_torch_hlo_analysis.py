"""The port's op-by-op cost counter (``repro_torch.core.hlo_analysis``) against hand
counts, the reference's parser cases and XLA's count of the MSET service, and
``ContainerStress.run_analytic`` against the reference's analytic rows."""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop
from torch.utils.flop_counter import FlopCounterMode

from repro.core import ContainerStress as JContainerStress
from repro.core import fit_response_surface as j_fit
from repro.core.catalog import CloudShape as JCloudShape
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.hlo_analysis import CompiledCost as JCompiledCost
from repro.core.hlo_analysis import CollectiveStats as JCollectiveStats
from repro.core.hlo_analysis import analyze_compiled
from repro.mset import service as jservice
from repro_torch.core import (
    H100,
    CompiledCost,
    ContainerStress,
    analyze,
    fit_response_surface,
    get_shape,
    parse_collectives,
)
from repro_torch.core.hlo_analysis import CollectiveStats
from repro_torch.mset import mset2, service


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------- hand counts --------------------------------


def test_linear_bmm_einsum_and_conv_count_by_their_formulas():
    lin = torch.nn.Linear(32, 16, device="meta")
    assert analyze(lin, meta(8, 32)).flops == 2 * 8 * 32 * 16  # the bias rides in addmm
    assert analyze(torch.bmm, meta(4, 8, 16), meta(4, 16, 32)).flops == 2 * 4 * 8 * 16 * 32
    eq = partial(torch.einsum, "bqhd,bkhd->bhqk")
    assert analyze(eq, meta(2, 5, 3, 8), meta(2, 7, 3, 8)).flops == 2 * 2 * 3 * 5 * 7 * 8
    # a depthwise causal conv1d: one filter of width W a channel
    B, C, L, W = 2, 6, 20, 4
    conv = analyze(partial(F.conv1d, padding=W - 1, groups=C), meta(B, C, L), meta(C, 1, W))
    assert conv.flops == 2 * B * C * (L + W - 1) * W


def test_elementwise_reductions_and_transcendentals():
    x = meta(64, 32)
    # three elementwise ops, a FLOP an element each
    assert analyze(lambda t: F.relu(t * 2.0 + 1.0), x).flops == 3 * 64 * 32
    # converts and compares count, a select too; a copy in the same dtype does not
    assert analyze(lambda t: t.to(torch.bfloat16), x).flops == 64 * 32
    assert analyze(lambda t: torch.where(t > 0, t, 0.0), x).flops == 2 * 64 * 32
    assert analyze(torch.clone, x).flops == 0
    # a reduction, a FLOP an input element
    assert analyze(lambda t: t.sum(-1), x).flops == 64 * 32
    assert analyze(lambda t: t.amax(0), x).flops == 64 * 32
    # transcendentals are kept out of flops, as XLA keeps them
    for fn in (torch.exp, torch.tanh, torch.rsqrt, torch.sigmoid, F.silu):
        assert analyze(fn, x).flops == 0
    assert analyze(lambda t: t.square(), x).flops == 64 * 32  # x ** 2 is a product
    # a softmax: max, subtract, sum, divide
    assert analyze(lambda t: torch.softmax(t, -1), x).flops == 4 * 64 * 32


def test_bytes_count_inputs_read_and_outputs_written_and_views_move_nothing():
    x = meta(64, 32)
    assert analyze(lambda t: t + 1.0, x).bytes_accessed == 2 * 64 * 32 * 4
    assert analyze(lambda t: t.view(-1)[:100].unsqueeze(0).t(), x).bytes_accessed == 0
    assert analyze(lambda t: t.detach().unsqueeze(0).expand(3, 64, 32), x).bytes_accessed == 0
    # a broadcast operand is read once: x + y[None] reads x, y and writes x's size
    assert analyze(lambda a, b: a + b[None], x, meta(32)).bytes_accessed == (2 * 64 + 1) * 32 * 4
    # an in-place copy writes its destination and reads its source only
    assert analyze(lambda a, b: a.copy_(b), x, meta(64, 32)).bytes_accessed == 2 * 64 * 32 * 4


def test_a_python_loop_is_counted_once_a_pass():
    """The counterpart of test_hlo_analysis.py's test_xla_cpu_counts_loop_body_once:
    the reference's count sees a scanned body once, this one every pass."""
    x, w = meta(128, 128), meta(128, 128)

    def loop(c, w):
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c.sum()

    one = analyze(lambda c, w: torch.tanh(c @ w).sum(), x, w).flops
    assert analyze(loop, x, w).flops == 10 * 2 * 128**3 + 128 * 128
    assert one == 2 * 128**3 + 128 * 128


def test_checkpoint_recompute_is_counted():
    """torch.utils.checkpoint reruns the forward in the backward, as XLA counts remat:
    all of it without early stop, and by default only as far as the backward needs
    (here the first product and the relu, not the second product)."""
    w = torch.empty(64, 64, device="meta", requires_grad=True)
    x = meta(16, 64)

    def body(h):
        return torch.relu(h @ w) @ w

    def loss(x, remat):
        w.grad = None
        out = checkpoint(body, x, use_reentrant=False) if remat else body(x)
        out.sum().backward()

    forward = analyze(body, x).flops
    plain = analyze(loss, x, False).flops
    with set_checkpoint_early_stop(False):
        assert analyze(loss, x, True).flops == plain + forward
    assert analyze(loss, x, True).flops == plain + 2 * 16 * 64 * 64 + 16 * 64


def test_peak_memory_on_a_known_allocation_sequence():
    n = 1024
    A = n * 4

    def fn(x):
        a = x * 2  # live: A
        a.add_(1)  # in place: nothing new
        v = a.view(-1)  # a view: nothing new
        b = v + 1  # live: 2A
        del a, v  # a's storage dies with its last view: live A
        c = b * 3  # live: 2A, not 3A
        return c.sum()  # 4 bytes of output

    cost = analyze(fn, meta(n))
    assert cost.argument_bytes_per_device == A
    assert cost.output_bytes_per_device == 4
    assert cost.temp_bytes_per_device == 2 * A
    assert cost.peak_memory_per_device == A + 2 * A + 4
    # without the del, three buffers are live at once

    def keep(x):
        a = x * 2
        b = a + 1
        c = b * 3
        return c.sum()

    assert analyze(keep, meta(n)).temp_bytes_per_device == 3 * A


def test_an_argument_updated_in_place_is_an_argument_not_an_output():
    cost = analyze(lambda a: (a.mul_(2), a.sum()), meta(256))
    assert cost.argument_bytes_per_device == 1024
    assert cost.output_bytes_per_device == 4


def test_data_dependent_ops_and_tensors_off_meta_fail_loudly():
    x = meta(8)
    for fn in (lambda t: t.sum().item(), torch.nonzero, lambda t: torch.bincount(t.long())):
        with pytest.raises((RuntimeError, NotImplementedError)):
            analyze(fn, x)
    with pytest.raises(ValueError, match="meta tensors only"):
        analyze(lambda t: t + torch.ones(8), x)
    # an empty tensor on the CPU holds and computes nothing (checkpoint makes one)
    assert analyze(lambda t: (t, torch.empty(0)), x).flops == 0
    # MSET2 training reads its bandwidth back to the host unless gamma is given
    X = meta(512, 8)
    with pytest.raises(RuntimeError, match="meta"):
        analyze(lambda x: mset2.train(x, n_memvec=64), X)
    trained = analyze(lambda x: mset2.train(x, n_memvec=64, gamma=1.0), X)
    assert trained.flops > 2 * 64 * 64 * 8


# ------------------------------- the parser ---------------------------------

HLO = """
ENTRY %main {
  %ag = bf16[16,1024]{1,0} all-gather(%p0), replica_groups=[2,4]<=[8]
  %ar = f32[512,512]{1,0} all-reduce(%x), to_apply=%sum
  %rs = f32[64]{0} reduce-scatter(%y), dimensions={0}
  %a2a = bf16[4,128]{1,0} all-to-all(%z)
  %cp = f32[32,32]{1,0} collective-permute(%w), source_target_pairs={{0,1}}
  %dot = f32[512,512]{1,0} dot(%a, %b)
}
"""


def test_parser_cases_of_the_reference():
    st = parse_collectives(HLO)
    assert st.bytes_by_kind["all-gather"] == 16 * 1024 * 2
    assert st.bytes_by_kind["all-reduce"] == 512 * 512 * 4
    assert st.bytes_by_kind["reduce-scatter"] == 64 * 4
    assert st.bytes_by_kind["all-to-all"] == 4 * 128 * 2
    assert st.bytes_by_kind["collective-permute"] == 32 * 32 * 4
    assert st.total_count == 5
    assert "dot" not in st.bytes_by_kind
    st = parse_collectives("%d = f32[8,8]{1,0} dot(%a, %b)\n%r = f32[] reduce(%x)")
    assert st.total_bytes == 0 and st.total_count == 0
    st = parse_collectives("%ar = (f32[16]{0}, f32[32]{0}) all-reduce(%a, %b), to_apply=%sum")
    assert st.bytes_by_kind["all-reduce"] == 16 * 4 + 32 * 4


def test_compiled_cost_has_the_reference_fields_and_keys():
    vals = dict(
        n_devices=1,
        flops=1.0,
        bytes_accessed=2.0,
        collective_bytes=0.0,
        peak_memory_per_device=3.0,
        argument_bytes_per_device=1.0,
        temp_bytes_per_device=1.0,
        output_bytes_per_device=1.0,
    )
    ours = CompiledCost(collectives=CollectiveStats(), **vals)
    ref = JCompiledCost(collectives=JCollectiveStats(), **vals)
    assert ours.as_dict() == ref.as_dict()
    assert list(ours.as_dict()) == list(ref.as_dict())


# ------------------------------- the service --------------------------------

GAMMA, KIND = 1.7, "inverse_distance"


def port_service_cost(n, m, b):
    return analyze(
        partial(service._estimate_sharded, gamma=GAMMA, kind=KIND),
        *service.abstract_service_inputs(n, m, b).values(),
    )


def reference_service_cost(n, m, b):
    fn = jax.jit(partial(jservice._estimate_sharded, gamma=GAMMA, kind=KIND))
    return analyze_compiled(fn.lower(**jservice.abstract_service_inputs(n, m, b)).compile())


@pytest.mark.parametrize("n,m,b", [(64, 512, 4096), (1024, 4096, 8192)])
def test_service_flops_match_xla_and_its_matmuls_the_analytic_count(n, m, b):
    ours, ref = port_service_cost(n, m, b), reference_service_cost(n, m, b)
    assert ours.flops == pytest.approx(ref.flops, rel=0.01)
    analytic, _ = service.service_flops_bytes(n, m, b)
    with FlopCounterMode(display=False) as fc:
        service._estimate_sharded(
            **service.abstract_service_inputs(n, m, b), gamma=GAMMA, kind=KIND
        )
    assert fc.get_total_flops() == analytic
    print(
        f"({n}, {m}, {b}): flops {ours.flops:.4e} vs XLA {ref.flops:.4e}; bytes "
        f"{ours.bytes_accessed:.3e} vs {ref.bytes_accessed:.3e}; peak "
        f"{ours.peak_memory_per_device:.3e} vs {ref.peak_memory_per_device:.3e}"
    )


@pytest.mark.parametrize("kind", ["inverse_distance", "gaussian"])
@pytest.mark.parametrize("n,m,b", [(8, 32, 16), (64, 512, 256), (200, 300, 97)])
def test_service_estimate_equals_the_reference(n, m, b, kind):
    """The port's _estimate_sharded against repro's on the same numpy inputs (a mean
    off 0 and a std off 1, so standardizing and un-standardizing both show): Xhat and
    the residuals within float32 rounding, 1e-5 of their largest magnitude."""
    rng = np.random.default_rng(n + m + b)
    mean = rng.standard_normal(n).astype(np.float32)
    std = (0.5 + rng.random(n)).astype(np.float32)
    inputs = (
        rng.standard_normal((m, n)).astype(np.float32),  # D
        (rng.standard_normal((m, m)) / m).astype(np.float32),  # Ginv
        mean,
        std,
        (mean + std * rng.standard_normal((b, n))).astype(np.float32),  # X
    )
    kw = dict(gamma=float(n) ** 0.5, kind=kind)
    ours = service._estimate_sharded(*map(torch.from_numpy, inputs), **kw)
    ref = jservice._estimate_sharded(*map(jax.numpy.asarray, inputs), **kw)
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        assert o.shape == r.shape == (b, n)
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())


def test_service_inputs_have_the_reference_shapes():
    ours = service.abstract_service_inputs(64, 512, 4096)
    ref = jservice.abstract_service_inputs(64, 512, 4096)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in ref.items()}
    assert all(v.device.type == "meta" and v.dtype == torch.float32 for v in ours.values())


# memory vectors enough that every cell is compute-bound in both packages: the eager
# byte count is several times XLA's fused one, so memory-bound cells would fit other
# exponents
SERVICE_GRID = {"n_signals": [256, 1024], "n_memvec": [16384, 32768], "batch": [4096, 16384]}


def test_run_analytic_rows_give_the_reference_surface():
    """run_analytic's rows over a grid of service sizes on h100-1, fitted in log-log
    space: each exponent within 0.01 of the reference's from its own rows."""
    shape = get_shape("h100-1")
    cs = ContainerStress(H100)
    rows = cs.run_analytic(
        lambda p, s: (
            partial(service._estimate_sharded, gamma=GAMMA, kind=KIND),
            tuple(service.abstract_service_inputs(*p.values()).values()),
        ),
        SERVICE_GRID,
        [shape],
    )
    hw = JHardwareSpec(**{k: getattr(H100, k) for k in H100.__dataclass_fields__})
    jshape = JCloudShape("h100-1", (1, 1), ("data", "model"), hw)
    jrows = JContainerStress(hw).run_analytic(
        lambda p, s: jax.jit(partial(jservice._estimate_sharded, gamma=GAMMA, kind=KIND)).lower(
            **jservice.abstract_service_inputs(*p.values())
        ),
        SERVICE_GRID,
        [jshape],
    )
    assert len(rows.rows) == len(jrows.rows) == 8
    usd_per_s = H100.price_per_chip_hour / 3600
    for r, j in zip(rows.rows, jrows.rows):
        assert r.params == j.params and r.shape_name == j.shape_name
        assert set(r.analysis) == set(j.analysis)
        assert r.terms.dominant == j.terms.dominant == "compute"
        assert r.usd_per_1k_steps == pytest.approx(r.terms.t_step * 1000 * usd_per_s)
    names, X, y = rows.to_arrays()
    jnames, jX, jy = jrows.to_arrays()
    ours, ref = fit_response_surface(names, X, y, degree=1), j_fit(jnames, jX, jy, degree=1)
    print("exponents", np.round(ours.coef[1:], 3), "reference", np.round(ref.coef[1:], 3))
    assert np.allclose(ours.coef[1:], ref.coef[1:], atol=0.01)


def test_run_analytic_skips_infeasible_cells_and_propagates_the_rest():
    shape = get_shape("h100-1")

    def lower(p, s):
        if p["m"] > 64:
            raise ValueError("does not fit")
        return torch.relu, (meta(p["m"]),)

    res = ContainerStress().run_analytic(lower, {"m": [32, 128]}, [shape])
    assert [r.params for r in res.rows] == [{"m": 32, "shape": 1}]
    with pytest.raises(RuntimeError):
        item = (lambda x: x.item(), (meta(1),))
        ContainerStress().run_analytic(lambda p, s: item, {"m": [1]}, [shape])
    # a shape of two chips is counted per device in a world of two, globalized
    (row,) = ContainerStress().run_analytic(lower, {"m": [32]}, [get_shape("h100-2")]).rows
    assert row.params == {"m": 32, "shape": 2}
    assert row.analysis["flops"] == 2 * res.rows[0].analysis["flops"]
