"""The port's float32 product K4 (MSET2's W = Ginv K) against float64 and plain float32.

The CUDA kernel runs only on a card: its tests carry the ``gpu`` marker and skip on
machines without one. Its arithmetic (both operands split into TF32 hi + lo, three
products, each 32-deep K tile summed by a truncating adder and promoted into float32)
is emulated here with numpy (``torch_tf32_cases``), so that what it keeps of float32 is
tested on the CPU too. Errors are Frobenius norms relative to the float64 product's.
An all-positive long sum is the emulation's worst case (the truncation's bias adds up
tile after tile): PERF.md reports it beside the card's reading.
"""

import importlib
import io
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.kernels import gemm, gemm_cuda, gemm_ref, similarity, similarity_ref
from repro_torch.kernels.gemm import split_rows
from repro_torch.mset import estimate, train
from repro_torch.tpss import TPSSParams, synthesize
from torch_parity_data import WELL_POSED, telemetry
from torch_tf32_cases import tf32, truncating_product

# the wrapper module, which keeps the launch count (the package's `gemm` is the op)
gemm_module = importlib.import_module("repro_torch.kernels.gemm.gemm")

# ragged rows and columns of the product: not multiples of the kernel's 128-row tile
RAGGED = [1, 33, 127, 129, 1000]
# the emulation's and the kernel's error may be at most this many times plain float32's
FACTOR = 2.0


def _rel_err(out, exact):
    out, exact = np.asarray(out, np.float64), np.asarray(exact, np.float64)
    return float(np.linalg.norm(out - exact) / np.linalg.norm(exact))


def _mset2_operands(seed, n_signals, n_memvec, n_obs, reg, device="cpu"):
    """A trained MSET2 model's Ginv and the similarity K of its next n_obs observations
    against its memory matrix, as `estimate` forms them."""
    X = synthesize(seed, TPSSParams(n_signals=n_signals, n_obs=2 * n_memvec + n_obs), device)
    model = train(X[: 2 * n_memvec], n_memvec=n_memvec, reg=reg)
    Xs = (X[2 * n_memvec :] - model.mean) / model.std
    return model.Ginv, similarity(model.D, Xs, gamma=model.gamma, kind=model.kind)


def _emulated_errors(a, b):
    """Errors against float64 of plain float32 `a @ b`, of the kernel's arithmetic and of
    one TF32 product (hi.hi, summed exactly)."""
    exact = a.astype(np.float64) @ b.astype(np.float64)
    plain = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy()
    three = truncating_product(a, np.ascontiguousarray(b.T), tile=32)
    one = (tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)).astype(np.float32)
    return _rel_err(plain, exact), _rel_err(three, exact), _rel_err(one, exact)


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    return a, b


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ------------------------------------------------------------- the wrapper, on the CPU


def test_auto_on_cpu_takes_plain_version_without_launching():
    a, b = (torch.from_numpy(v) for v in _inputs(70, 45, 33))
    gemm_module.launches = 0
    out = gemm(a, b)
    assert torch.equal(out, a @ b) and torch.equal(gemm_ref(a, b), a @ b)
    assert gemm_module.launches == 0


def test_estimate_on_cpu_keeps_the_plain_product():
    seed, n_signals, n_obs, n_memvec = WELL_POSED[0]
    X = torch.from_numpy(telemetry(seed, n_obs, n_signals))
    model = train(X[: n_obs // 2], n_memvec=n_memvec)
    gemm_module.launches = 0
    xhat, res = estimate(model, X[n_obs // 2 :])
    assert gemm_module.launches == 0
    # estimate's arithmetic with W = Ginv @ K written out: the same bits
    Xs = (X[n_obs // 2 :] - model.mean) / model.std
    K = similarity_ref(model.D, Xs, model.gamma, model.kind)
    want = ((model.Ginv @ K).T @ model.D) * model.std + model.mean
    assert torch.equal(xhat, want) and torch.equal(res, X[n_obs // 2 :] - want)


def test_a_model_off_the_card_keeps_no_split():
    seed, n_signals, n_obs, n_memvec = WELL_POSED[0]
    model = train(torch.from_numpy(telemetry(seed, n_obs, n_signals)), n_memvec=n_memvec)
    assert model.ginv_split() is None and model._ginv_split is None
    with pytest.raises(ValueError, match="CUDA"):
        split_rows(model.Ginv)


def test_cuda_impl_on_cpu_tensor_raises():
    a = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        gemm(a, a.T.contiguous(), impl="cuda")


def test_unknown_impl_raises():
    a = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="unknown gemm impl"):
        gemm(a, a.T.contiguous(), impl="cublas")


@pytest.mark.parametrize(
    "a,b,err,match",
    [
        (torch.zeros((4, 3), dtype=torch.float64), torch.zeros((3, 5)), TypeError, "float32"),
        (torch.zeros((4, 3)), torch.zeros((3, 5), dtype=torch.bfloat16), TypeError, "float32"),
        (torch.zeros((4, 3)), torch.zeros((4, 5)), ValueError, "expected"),
        (torch.zeros((4, 3)), torch.zeros(3), ValueError, "expected"),
        (torch.zeros((3, 4)).T, torch.zeros((3, 5)), ValueError, "contiguous"),
        (torch.zeros((4, 3)), torch.zeros((5, 3)).T, ValueError, "contiguous"),
    ],
    ids=["f64", "bf16", "inner", "1-d", "a-view", "b-view"],
)
def test_kernel_rejects_what_it_does_not_take(a, b, err, match):
    with pytest.raises(err, match=match):
        gemm_cuda(a, b)


# ------------------------------------------------ the kernel's arithmetic, on the CPU


@pytest.mark.parametrize("reg", [1e-2, 1e-6])
def test_three_products_hold_float32_on_an_mset2_model(reg):
    # the benchmark's reg (1e-2) and the port's default (1e-6), whose Ginv is ~1e4 larger
    Ginv, K = _mset2_operands(29, 64, 256, 300, reg)
    plain, three, one = _emulated_errors(Ginv.numpy(), K.numpy())
    assert three <= FACTOR * plain, (three, plain)
    assert one > FACTOR * plain, (one, plain)


@pytest.mark.parametrize("k", [4096, 4103])
def test_three_products_hold_float32_over_a_long_contraction(k):
    # 128 promoted K tiles (4103: the last one ragged, padded with zeros by the kernel)
    plain, three, one = _emulated_errors(*_inputs(64, k, 48, seed=k))
    assert three <= FACTOR * plain, (three, plain)
    assert one > FACTOR * plain, (one, plain)


# ------------------------------------------------------------------- on the card


def _card_errors(a, b):
    """The kernel's and cuBLAS float32's errors against float64 on one card's inputs."""
    before = gemm_module.launches
    out = gemm(a, b)
    torch.cuda.synchronize()
    assert gemm_module.launches == before + 1
    exact = a.double() @ b.double()

    def err(x):
        return float(torch.linalg.norm(x.double() - exact) / torch.linalg.norm(exact))

    return err(out), err(a @ b)


@pytest.mark.gpu
def test_kernel_on_fig8_shapes_with_a_trained_ginv(cuda):
    # Fig. 8's widest cell as the benchmark runs it: 8,192 memory vectors of 1,024 signals,
    # a batch of 8,192 observations, reg 1e-2
    Ginv, K = _mset2_operands(31, 1024, 8192, 8192, 1e-2, device=cuda)
    kernel, cublas = _card_errors(Ginv, K)
    assert kernel <= FACTOR * cublas, (kernel, cublas)


@pytest.mark.gpu
@pytest.mark.parametrize("m", RAGGED)
@pytest.mark.parametrize("n", RAGGED)
def test_kernel_on_ragged_shapes(cuda, m, n):
    # contractions of 1,000 + m: 1001, 1033, 1127, 1129 and 2000, none a whole number of
    # 32-float K tiles. A wrong row, column or tile would be an error of order 1; 8 eps
    # of the product is the floor where a few elements' float32 errors may cancel by luck.
    a, b = (torch.from_numpy(v).to(cuda) for v in _inputs(m, 1000 + m, n, seed=m * n))
    kernel, cublas = _card_errors(a, b)
    assert kernel <= FACTOR * max(cublas, 4 * float(np.finfo(np.float32).eps)), (kernel, cublas)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [0, 1, 31, 33, 4103])
def test_kernel_over_contractions_not_a_multiple_of_32(cuda, k):
    a, b = (torch.from_numpy(v).to(cuda) for v in _inputs(256, k, 192, seed=k))
    if k == 0:
        assert torch.equal(gemm(a, b), torch.zeros((256, 192), device=cuda))
        return
    kernel, cublas = _card_errors(a, b)
    assert kernel <= FACTOR * max(cublas, 4 * float(np.finfo(np.float32).eps)), (kernel, cublas)


@pytest.mark.gpu
def test_estimate_on_the_card_takes_k4_and_matches_the_plain_product(cuda):
    seed, n_signals, n_obs, n_memvec = WELL_POSED[2]
    X = torch.from_numpy(telemetry(seed, n_obs, n_signals)).to(cuda)
    n_tr = n_obs * 3 // 4
    model = train(X[:n_tr], n_memvec=n_memvec)
    before = gemm_module.launches
    xhat, res = estimate(model, X[n_tr:])
    assert gemm_module.launches == before + 1
    Xs = (X[n_tr:] - model.mean) / model.std
    K = similarity(model.D, Xs, gamma=model.gamma, kind=model.kind)
    want = ((model.Ginv @ K).T @ model.D) * model.std + model.mean
    # the bar of the CPU parity with the JAX package (tests/test_torch_mset.py)
    tol = 1e-5 * float(X.abs().max())
    np.testing.assert_allclose(xhat.cpu().numpy(), want.cpu().numpy(), atol=tol, rtol=0)
    want_res = (X[n_tr:] - want).cpu().numpy()
    np.testing.assert_allclose(res.cpu().numpy(), want_res, atol=tol, rtol=0)


@pytest.mark.gpu
def test_a_given_split_gives_the_same_bits_and_a_wrong_one_raises(cuda):
    a, b = (torch.from_numpy(v).to(cuda) for v in _inputs(300, 1001, 200, seed=5))
    assert torch.equal(gemm(a, b, a_split=split_rows(a)), gemm(a, b))
    with pytest.raises(ValueError, match="a_split"):
        gemm(a, b, a_split=split_rows(a[:299].contiguous()))


@pytest.mark.gpu
def test_ginv_split_is_made_once_and_again_when_ginv_changes(cuda):
    seed, n_signals, n_obs, n_memvec = WELL_POSED[2]
    X = torch.from_numpy(telemetry(seed, n_obs, n_signals)).to(cuda)
    n_tr = n_obs * 3 // 4
    model = train(X[:n_tr], n_memvec=n_memvec)
    xhat, _ = estimate(model, X[n_tr:])
    planes = model.ginv_split()
    assert planes is model.ginv_split() and planes.shape == (2, n_memvec, 32)
    assert torch.equal(estimate(model, X[n_tr:])[0], xhat)
    # replaced: another tensor of the same values, another split of the same bits
    model.Ginv = model.Ginv.clone()
    assert model.ginv_split() is not planes and torch.equal(model.ginv_split(), planes)
    # edited in place: W = 0, so x_hat is the mean
    model.Ginv.zero_()
    assert not torch.equal(model.ginv_split(), planes)
    xhat0, _ = estimate(model, X[n_tr:])
    assert torch.equal(xhat0, model.mean.expand_as(xhat0))
    # the split is not state: the state dict and a saved model carry none
    assert set(model.state_dict()) == {"D", "Ginv", "mean", "std"}
    buf = io.BytesIO()
    torch.save(model, buf)
    buf.seek(0)
    assert torch.load(buf, weights_only=False)._ginv_split is None


@pytest.mark.gpu
def test_the_profiler_links_k4s_kernels_to_its_operator(cuda):
    # a kernel's device time is read under a span through the operator that launched it
    from torch.profiler import ProfilerActivity, profile

    a, b = (torch.from_numpy(v).to(cuda) for v in _inputs(256, 300, 192))
    planes = split_rows(a)
    gemm(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        split_rows(a)
        gemm(a, b, a_split=planes)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    ops = {
        e.correlation_id(): e.name()
        for e in events
        if e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith("repro_torch::")
    }
    kernel = re.compile(r"gemm_\w+_kernel")
    linked = sorted(
        (kernel.search(e.name()).group(), ops.get(e.linked_correlation_id()))
        for e in events
        if e.device_type() != torch.autograd.DeviceType.CPU and kernel.search(e.name())
    )
    assert linked == [
        ("gemm_split_rows_kernel", "repro_torch::gemm_split_rows"),
        ("gemm_split_t_kernel", "repro_torch::gemm_tf32x3"),
        ("gemm_tf32x3_kernel", "repro_torch::gemm_tf32x3"),
    ], linked
