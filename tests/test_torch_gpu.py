"""The port's slice on the card, held against its own plain (CPU) path.

Every test here needs a CUDA card and skips without one; none imports JAX, so
they run on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import torch_control_cases
from repro_torch.fleet import PredictivePolicy, torchsim
from repro_torch.kernels import sprt_chunked_ref, sprt_ref, sprt_scan
from repro_torch.launch import scope
from repro_torch.mset import SPRTParams, estimate, sprt, train
from repro_torch.tpss import TPSSParams, synthesize
from torch_fleet_cases import (
    DISCIPLINES,
    FAMILIES,
    GOLDEN,
    SUBSTEP_GRID,
    assert_bitexact,
    assert_equivalent,
    check_forecaster,
    check_kernel_steps,
    check_lattice,
    check_replay,
    fidelity_run,
    flash_slate,
    substep_run,
)
from torch_parity_data import WELL_POSED, telemetry
from torch_sprt_cases import CASES, CHUNKS, case_inputs, chunked_params

pytestmark = pytest.mark.gpu
sim_module = importlib.import_module("repro_torch.kernels.similarity.similarity")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_main_path_launches_the_kernel(cuda):
    sim_module.launches = 0
    grid = {"n_signals": [8, 16], "n_memvec": [32, 64], "n_observations": [512]}
    res, surf = scope.run_mset(grid, reps=1, device=cuda, verbose=False)
    assert len(res.rows) == 4 and np.isfinite(surf.r2)
    # one sim(D, D) and one sim(D, X) for each of warm-up + 1 rep, in each cell
    assert sim_module.launches == 4 * 2 * 2


def test_mset2_on_the_card_matches_the_cpu(cuda):
    seed, n_signals, n_obs, n_memvec = WELL_POSED[2]
    X = torch.from_numpy(telemetry(seed, n_obs, n_signals))
    n_tr = n_obs * 3 // 4
    cpu_model = train(X[:n_tr], n_memvec=n_memvec)
    _, r_cpu = estimate(cpu_model, X[n_tr:])
    model = train(X[:n_tr].to(cuda), n_memvec=n_memvec)
    _, r = estimate(model, X[n_tr:].to(cuda))
    assert r.is_cuda and model.Ginv.is_cuda
    # the same bar as the CPU parity with the JAX package (tests/test_torch_slice.py)
    tol = 1e-3 * float(X.abs().max())
    np.testing.assert_allclose(r.cpu().numpy(), r_cpu.numpy(), atol=tol, rtol=0)


def test_sprt_on_the_card_gives_the_cpu_alarms(cuda):
    rng = np.random.default_rng(2)
    r = rng.standard_normal((2000, 8)).astype(np.float32)
    r[1000:, 3] += 3.0
    r = torch.from_numpy(r)
    sigma = torch.ones(8)
    a_cpu, sp_cpu, _ = sprt(r, sigma, SPRTParams())
    a, sp, _ = sprt(r.to(cuda), sigma.to(cuda), SPRTParams())
    assert torch.equal(a.cpu(), a_cpu)
    np.testing.assert_allclose(sp.cpu().numpy(), sp_cpu.numpy(), atol=1e-5, rtol=1e-6)


sprt_module = importlib.import_module("repro_torch.kernels.sprt.sprt")


# (T, n, with mu, NaN at): n off multiples of 32, one step, one signal, a NaN residual
SPRT_SHAPES = [
    (3000, 64, True, None),
    (1, 33, True, None),
    (257, 1, False, None),
    (1000, 100, False, None),
    (2049, 65, True, (700, 3)),
]


@pytest.mark.parametrize("T,n,with_mu,nan_at", SPRT_SHAPES)
def test_sprt_kernel_equals_the_plain_loop_bit_for_bit(cuda, T, n, with_mu, nan_at):
    rng = np.random.default_rng(T + n)
    r = rng.standard_normal((T, n)).astype(np.float32)
    r[T // 2 :, n // 2] += 3.0  # a shift to alarm on
    if nan_at is not None:
        r[nan_at] = np.nan
    r = torch.from_numpy(r).to(cuda)
    sigma = torch.from_numpy(rng.uniform(0.8, 1.2, n).astype(np.float32)).to(cuda)
    mu = torch.from_numpy(rng.uniform(-0.1, 0.1, n).astype(np.float32)).to(cuda)
    mu = mu if with_mu else None
    for p in (SPRTParams(), SPRTParams(1e-2, 1e-3, 4.0)):
        kw = dict(m_shift=p.m_shift, upper=p.upper, lower=p.lower)
        before = sprt_module.launches
        a, sp, sn = sprt_scan(r, sigma, mu, **kw)
        assert sprt_module.launches == before + 1
        a_ref, sp_ref, sn_ref = sprt_scan(r, sigma, mu, **kw, impl="ref")
        assert torch.equal(a, a_ref)
        # bit for bit, NaN where the plain loop has one
        for x, y in ((sp, sp_ref), (sn, sn_ref)):
            assert x.stride() == y.stride()
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    if nan_at is not None:
        assert bool(torch.isnan(sp[nan_at[0] :, nan_at[1]]).all())


# the chunked scan at forced chunk lengths (edges on the NaNs and on T) and at its own
@pytest.mark.parametrize("name,chunk", chunked_params() + [(name, "own") for name in CASES])
def test_sprt_chunked_kernel_equals_the_plain_loop_bit_for_bit(cuda, name, chunk):
    r, sigma, mu = (None if x is None else torch.from_numpy(x).to(cuda) for x in case_inputs(name))
    T, n = r.shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    L = sprt_module.chunk_length(T, n, sms) if chunk == "own" else CHUNKS[chunk](T)
    p = SPRTParams()
    args = (r, sigma, mu, p.m_shift, p.upper, p.lower)
    counter = torch.zeros(2, dtype=torch.int64, device=cuda)
    before = sprt_module.launches
    forced = None if chunk == "own" else L
    a, sp, sn = sprt_module.sprt_cuda(*args, chunk=forced, reruns=counter)
    assert sprt_module.launches == before + 1
    a_ref, sp_ref, sn_ref = sprt_ref(*args)
    assert torch.equal(a, a_ref)
    for x, y in ((sp, sp_ref), (sn, sn_ref)):
        assert x.stride() == y.stride()
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    # pass 2 re-ran the steps the model of the algorithm re-runs at the same L
    *_, reruns = sprt_chunked_ref(*args, L)
    assert counter.tolist() == [int(reruns.sum()), int(reruns.max())]


def test_a_session_times_mset2_on_the_card_and_counts_k3_reruns(cuda):
    from repro_torch import _telemetry

    seed, n_signals, n_obs, n_memvec = WELL_POSED[2]
    X = torch.from_numpy(telemetry(seed, n_obs, n_signals)).to(cuda)
    n_tr = n_obs * 3 // 4
    # the pathological case re-runs the whole of every chunk after the first
    r, sigma, mu = (None if x is None else torch.from_numpy(x).to(cuda)
                    for x in case_inputs("pathological"))
    p = SPRTParams()
    with _telemetry.session() as tel:
        model = train(X[:n_tr], n_memvec=n_memvec)
        estimate(model, X[n_tr:])
        for _ in range(2):
            sprt(r, sigma, p, mu=mu)
    names = [s.name for s in tel.tracer.roots]
    assert names == ["mset2.train", "mset2.estimate", "mset2.sprt", "mset2.sprt"]
    for root in tel.tracer.roots:
        for s, _, _ in root.walk():
            assert s.device_ms is not None and s.device_ms >= 0, s.name
    assert " dev " in tel.tracer.render().splitlines()[0]
    T, n = r.shape
    L = sprt_module.chunk_length(T, n, torch.cuda.get_device_properties(cuda).multi_processor_count)
    *_, reruns = sprt_chunked_ref(r, sigma, mu, p.m_shift, p.upper, p.lower, L)
    assert int(reruns.sum()) > 0
    assert "sprt_rerun_steps_total " + repr(2.0 * int(reruns.sum())) in tel.prometheus()


def test_synthesis_on_the_card(cuda):
    p = TPSSParams(n_signals=16, n_obs=1024)
    a, b = synthesize(5, p, device=cuda), synthesize(5, p, device=cuda)
    assert a.is_cuda and a.shape == (1024, 16)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


# ------------------------------ LM serving (flash attention, K2) ------------

flash_module = importlib.import_module("repro_torch.kernels.attention.flash")

# (B, S, H, K, hd): tests/test_kernels.py's shapes, ragged S, small head dims and GQA,
# and S = 1, 65 and 129 (one row; one key past a tile; one past two) at every head dim
FLASH_SWEEP = [
    (2, 128, 2, 2, 64),
    (1, 256, 4, 4, 32),
    (2, 200, 2, 2, 64),
    (1, 64, 1, 1, 128),
    (1, 17, 2, 2, 16),
    (1, 100, 8, 2, 64),
    (1, 160, 24, 8, 128),
    (1, 100, 48, 1, 128),
] + [(2, S, 4, 2, hd) for S in (1, 65, 129) for hd in (16, 32, 64, 128)]


def _flash_bar(ref, dtype):
    """float32: tests/test_kernels.py's 2e-5. bfloat16: both sides get the same bf16
    inputs and compute P . V in float32, so they may differ by one bf16 ulp of the output."""
    if dtype == torch.float32:
        return 2e-5 + 2e-5 * ref.abs()
    return 1e-5 + 2**-7 * ref.abs()


def _check_flash(q, k, v, causal, dtype, scale=None):
    from repro_torch.kernels import gqa_attention

    before = flash_module.launches
    out = gqa_attention(q, k, v, causal=causal, scale=scale)
    assert flash_module.launches == before + 1
    ref = gqa_attention(q, k, v, causal=causal, scale=scale, impl="ref").float()
    diff = (out.float() - ref).abs()
    assert bool((diff <= _flash_bar(ref, dtype)).all()), float(diff.max())


@pytest.mark.parametrize("B,S,H,K,hd", FLASH_SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, B, S, H, K, hd, dtype):
    g = torch.Generator(device=cuda).manual_seed(S * H + hd)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    # k and v laid out (B, K, S, hd), as in the KV cache, and read through their strides
    k = torch.randn(B, K, S, hd, generator=g, device=cuda).to(dtype).transpose(1, 2)
    v = torch.randn(B, K, S, hd, generator=g, device=cuda).to(dtype).transpose(1, 2)
    for causal in (True, False):
        _check_flash(q, k, v, causal, dtype)


@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_large_logits(cuda, hd, dtype):
    # q x 8: scores of tens, so the running max jumps from tile to tile and the
    # rescaling by exp(m_old - m_new) carries the result
    g = torch.Generator(device=cuda).manual_seed(hd)
    q = (8 * torch.randn(2, 200, 8, hd, generator=g, device=cuda)).to(dtype)
    k, v = (torch.randn(2, 200, 2, hd, generator=g, device=cuda).to(dtype) for _ in range(2))
    for causal in (True, False):
        _check_flash(q, k, v, causal, dtype)


@pytest.mark.parametrize("scale", [0.0078125, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_a_softmax_scale(cuda, scale, dtype):
    """granite-4.0-h's 0.0078125 (1 / 128 at head_dim 128, not 128 ** -0.5) and a scale
    that sharpens the softmax, against the plain version at the same scale; the
    operator's launches show under a profiler range around the call."""
    g = torch.Generator(device=cuda).manual_seed(31)
    q = torch.randn(2, 300, 32, 128, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(2, 300, 8, 128, generator=g, device=cuda).to(dtype) for _ in range(2))
    for causal in (True, False):
        _check_flash(q, k, v, causal, dtype, scale=scale)
    default = flash_module.flash_attention_cuda(q, k, v)
    assert not torch.equal(flash_module.flash_attention_cuda(q, k, v, scale=scale), default)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        flash_module.flash_attention_cuda(q, k, v, scale=scale)
        torch.cuda.synchronize()
    assert any(e.name == "repro_torch::flash_attention" for e in prof.events())


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_structured_values(cuda, hd, dtype):
    # q = 0 makes P uniform over the unmasked keys and V[j, d] = j + d / 1000 names its
    # row and column, so a P fragment or a V row in the wrong place gives a large error
    S = 200
    q = torch.zeros(1, S, 4, hd, device=cuda, dtype=dtype)
    k = torch.randn(1, S, 2, hd, device=cuda).to(dtype)
    j = torch.arange(S, device=cuda, dtype=torch.float32)[:, None]
    d = torch.arange(hd, device=cuda, dtype=torch.float32)[None, :]
    v = (j + d / 1000).expand(1, 2, S, hd).transpose(1, 2).to(dtype)
    for causal in (True, False):
        _check_flash(q, k, v, causal, dtype)


def test_flash_kernel_refuses_misaligned_bf16_view(cuda):
    from repro_torch.kernels import gqa_attention

    B, S, H, hd = 1, 64, 2, 64
    flat = torch.randn(B * S * H * hd + 1, device=cuda).to(torch.bfloat16)
    q = flat[1:].view(B, S, H, hd)  # a storage offset of one element: data_ptr % 16 == 2
    k = v = flat[:-1].view(B, S, H, hd)
    before = flash_module.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        gqa_attention(q, k, v)
    assert flash_module.launches == before


def test_serve_path_launches_flash_kernel_per_layer(cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate

    flash_module.launches = 0
    r = generate("minitron-4b", batch=2, prompt_len=40, gen_tokens=4, device=cuda)
    assert r.tokens.shape == (2, 4)
    # one prefill, one kernel launch per attention layer; decode attention is plain torch
    assert flash_module.launches == get_config("minitron-4b", smoke=True).n_layers


def test_serving_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import decode_greedy
    from repro_torch.models import Model, build_model

    cfg = get_config("minitron-4b", smoke=True).replace(dtype="float32")
    cpu = build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    card = Model.from_numpy(cfg, cpu.to_numpy(), cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 48)))
    outs = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        cache, logits = model.prefill(toks.to(dev), model.init_cache(2, 56))
        outs.append((logits.float().cpu(), decode_greedy(model, cache, logits, 48, 8).cpu()))
    (l_cpu, t_cpu), (l_card, t_card) = outs
    assert float((l_card - l_cpu).abs().max()) <= 1e-4 * float(l_cpu.abs().max())
    assert torch.equal(t_card, t_cpu)


@pytest.mark.parametrize(
    "arch",
    ["olmoe-1b-7b", "granite-moe-3b-a800m", "mamba2-130m", "jamba-v0.1-52b", "granite-4.0-h-small"],
)
def test_families_serve_on_the_card(cuda, arch):
    """One K2 launch a prefill for each attention layer (none for mamba2), and the
    same tokens on a second call."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate

    cfg = get_config(arch, smoke=True)
    flash_module.launches = 0
    r = generate(arch, batch=2, prompt_len=40, gen_tokens=4, device=cuda)
    assert flash_module.launches == sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    again = generate(arch, batch=2, prompt_len=40, gen_tokens=4, device=cuda)
    np.testing.assert_array_equal(again.tokens, r.tokens)


def test_granite_on_the_card_follows_its_reference(cuda):
    """granite-4.0-h-small at the smoke size in bfloat16 on the card (K2 at its scale,
    the grouped expert products): prefill and four decode steps through the cache
    against the float32 plain reference's forward on the CPU: the norm of each logit
    vector's difference over the reference's about its mean. bfloat16 puts the port
    ~0.01 from it at this size on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import from_reference
    from test_torch_granite import load_reference

    ref = load_reference()
    cfg = get_config("granite-4.0-h-small", smoke=True)
    params = ref.init_params(cfg.published(), 9, "cpu", dtype=torch.float32)
    model = from_reference(cfg, _to(params, cuda))
    toks = torch.randint(0, cfg.vocab_size, (2, 48), generator=torch.Generator().manual_seed(9))
    cache, logits = model.prefill(toks.to(cuda), model.init_cache(2, 52))
    seq, fed = [logits[:, -1].float().cpu()], []
    for i in range(4):
        fed.append(seq[-1].argmax(-1))
        cache, logits = model.decode_step(cache, fed[-1][:, None].to(cuda), 48 + i)
        seq.append(logits[:, -1].float().cpu())
    want = ref.forward(cfg.published(), params, torch.cat([toks, torch.stack(fed, 1)], 1), last=5)
    got = torch.stack(seq, 1)
    rms = (got - want).norm(dim=-1) / (want - want.mean(-1, keepdim=True)).norm(dim=-1)
    assert float(rms.max()) < 0.05


def test_granite_at_published_widths_routes_every_slot(cuda):
    """granite-4.0-h-small at its published widths, cut to one 10-layer period, built by
    ``build_model`` and served by ``Model.prefill`` and ``decode_step`` in a telemetry
    session: each layer routes all T·k slots, none is dropped, and decode follows."""
    from repro_torch import _telemetry as telemetry
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("granite-4.0-h-small").replace(n_layers=10)
    model = build_model(cfg, cuda, torch.Generator(device=cuda).manual_seed(3))
    B, S = 2, 1024
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=cuda)
    with telemetry.session() as tel:
        cache, logits = model.prefill(toks, model.init_cache(B, S + 2))
        for i in range(2):
            cache, logits = model.decode_step(cache, logits[:, -1].argmax(-1)[:, None], S + i)
    tel.settle()
    snap = tel.metrics.snapshot()
    assert snap["counter"]["moe_dropped_slots_total"][""] == 0
    routed = snap["counter"]["moe_routed_slots_total"]
    assert routed == {f"layer={i}": B * S * 10 + 2 * B * 10 for i in range(10)}
    loads = snap["gauge"]["moe_expert_load_max"]
    assert len(loads) == 10 and all(v >= 1 for v in loads.values())
    assert bool(torch.isfinite(logits.float()).all())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_encoders_shape(cuda, dtype):
    """seamless-m4t-large-v2's encoder self-attention: B 4, 4096 frames, 16/16 heads of
    64, non-causal (and causal at the decoder's 512 tokens)."""
    g = torch.Generator(device=cuda).manual_seed(64)
    for S, causal in ((4096, False), (512, True)):
        q, k, v = (torch.randn(4, S, 16, 64, generator=g, device=cuda).to(dtype) for _ in range(3))
        _check_flash(q, k, v, causal, dtype)


def test_encdec_serves_on_the_card_and_matches_the_cpu(cuda):
    """seamless at smoke size: one K2 launch a prefill for each encoder and decoder
    layer, the same tokens on a second call; and in float32 the card's prefill logits
    and greedy tokens against the CPU's on the same weights, prompts and frames."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import decode_greedy, generate
    from repro_torch.models import Model, build_model

    arch = "seamless-m4t-large-v2"
    cfg = get_config(arch, smoke=True)
    flash_module.launches = 0
    r = generate(arch, batch=2, prompt_len=40, gen_tokens=4, device=cuda)
    assert flash_module.launches == cfg.n_enc_layers + cfg.n_layers
    again = generate(arch, batch=2, prompt_len=40, gen_tokens=4, device=cuda)
    np.testing.assert_array_equal(again.tokens, r.tokens)

    cfg = cfg.replace(dtype="float32")
    cpu = build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    card = Model.from_numpy(cfg, cpu.to_numpy(), cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48)))
    frames = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32))
    outs = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        cache, logits = model.prefill(toks.to(dev), model.init_cache(2, 56), frames=frames.to(dev))
        outs.append((logits.float().cpu(), decode_greedy(model, cache, logits, 48, 8).cpu()))
    (l_cpu, t_cpu), (l_card, t_card) = outs
    assert float((l_card - l_cpu).abs().max()) <= 1e-4 * float(l_cpu.abs().max())
    assert torch.equal(t_card, t_cpu)


def _moe_case(dtype, T=512):
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("olmoe-1b-7b", smoke=True).replace(
        n_experts=64, n_experts_per_tok=8, d_model=256, moe_d_ff=128, dtype=dtype
    )
    mod = moe.MoE(cfg, "cpu")
    mod.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, T // 2, 256, generator=torch.Generator().manual_seed(1)).to(mod.w_up.dtype)
    return cfg, mod, x


def test_moe_combine_is_deterministic_on_the_card(cuda):
    """bf16 at olmoe's 64 experts top 8: two runs on the card give the same bits, and the
    combine (summed in ascending expert id, no atomics) gives the CPU's bits on the
    same expert outputs."""
    from repro_torch.models import moe

    cfg, mod, x = _moe_case("bfloat16")
    mod = mod.to(cuda)
    y1, _ = mod(x.to(cuda))
    y2, _ = mod(x.to(cuda))
    assert torch.equal(y1, y2)
    T, k = x.shape[0] * x.shape[1], cfg.n_experts_per_tok
    g = torch.Generator().manual_seed(2)
    top_i = torch.stack([torch.randperm(64, generator=g)[:k] for _ in range(T)])
    C = moe.capacity(cfg, T)
    _, _, slot = moe._group(top_i.reshape(-1), torch.ones(T * k), T, 64, C)
    yg = torch.cat([torch.randn(64 * C, 256, generator=g), torch.zeros(1, 256)]).bfloat16()
    on_cpu = moe._combine(yg, slot, top_i, T)
    on_card = moe._combine(yg.to(cuda), slot.to(cuda), top_i.to(cuda), T)
    assert torch.equal(on_card.cpu(), on_cpu)


def test_apply_moe_on_the_card_matches_the_cpu(cuda):
    cfg, mod, x = _moe_case("float32")
    y_cpu, aux_cpu = mod(x)
    y_card, aux_card = mod.to(cuda)(x.to(cuda))
    torch.testing.assert_close(y_card.cpu(), y_cpu, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(aux_card.cpu(), aux_cpu, atol=1e-5, rtol=1e-4)


def test_apply_ssd_on_the_card_matches_the_cpu(cuda):
    """float32, at mamba2-130m's own widths: prefill with its cache, then a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba

    cfg = get_config("mamba2-130m").replace(dtype="float32")
    ssd = mamba.SSD(cfg, "cpu")
    ssd.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 300, cfg.d_model, generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cpu", cuda):
        m = ssd.to(dev)
        cache = {
            n: torch.zeros(sh, dtype=dt, device=dev)
            for n, (sh, dt) in mamba.cache_spec(cfg, 2).items()
        }
        y, _ = m(x[:, :299].to(dev), cache=cache)
        y_dec, _ = m(x[:, 299:].to(dev), cache=cache, pos=299)
        outs.append([t.cpu() for t in (y, y_dec, cache["conv"], cache["state"])])
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# ------------------- the fleet simulator's compiled backend -------------------
# The CPU tests' scenarios (tests/test_torch_fleet_backend.py) on the card, held
# against the numpy engine at the same bars.


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_fleet_golden_scenario_on_the_card(cuda, name):
    assert_equivalent(GOLDEN[name](), GOLDEN[name](backend="torch", device=cuda))


@pytest.mark.parametrize("disc", DISCIPLINES)
@pytest.mark.parametrize("n_substeps,preemptive", SUBSTEP_GRID)
def test_fleet_substep_bit_exact_on_the_card(cuda, disc, n_substeps, preemptive):
    a = substep_run(disc, n_substeps, preemptive)
    b = substep_run(disc, n_substeps, preemptive, backend="torch", device=cuda)
    assert_bitexact(a, b, f"{disc} n={n_substeps} pre={preemptive}")


def test_fleet_fidelity_case_preempts_on_the_card(cuda):
    a, b = fidelity_run(), fidelity_run(backend="torch", device=cuda)
    assert_bitexact(a, b, "fidelity")
    assert b.preemptions.sum() > 0


@pytest.mark.parametrize("family", FAMILIES)
def test_fleet_policy_kernel_on_the_card(cuda, family):
    check_kernel_steps(family, cuda)


def test_fleet_forecaster_on_the_card(cuda):
    check_forecaster(cuda)


def test_fleet_lattice_on_the_card(cuda):
    check_lattice(cuda)


def test_fleet_graph_replays_a_second_slate_of_one_signature(cuda):
    check_replay(cuda)
    assert len(torchsim._GRAPHS) == 1


def test_fleet_graphs_capture_on_the_second_dispatch_and_stay_bounded(cuda, monkeypatch):
    """A signature's first dispatch runs eagerly and captures nothing; the second
    captures and replays, equal to the first bit for bit; past ``_MAX_GRAPHS``
    signatures the least recently used graph is evicted."""
    monkeypatch.setattr(torchsim, "_MAX_GRAPHS", 2)
    held = torchsim.clear_compiled()
    sigs = []
    for n in (1, 2, 3):  # padded to 1, 2 and 4 candidates: three signatures
        wl, fleet, params, ctx = flash_slate(n=n, n_seeds=2, duration=300.0)
        pols = [PredictivePolicy.from_params(p, **ctx) for p in params]
        kernel, kw = torchsim.slate_arguments(wl, fleet, pols)
        before = set(torchsim._GRAPHS)
        eager = torchsim.run_dynamics(kernel, **kw, device=cuda)
        assert set(torchsim._GRAPHS) == before
        graph = torchsim.run_dynamics(kernel, **kw, device=cuda)
        (sig,) = set(torchsim._GRAPHS) - before
        sigs.append(sig)
        for k, v in eager.items():
            assert np.array_equal(v, graph[k]), (n, k)
        assert len(torchsim._GRAPHS) <= 2
    assert list(torchsim._GRAPHS) == sigs[1:]
    del held


def test_fleet_tiles_share_one_graph_and_equal_the_untiled_dispatch(cuda):
    wl, fleet, params, ctx = flash_slate(n=5, n_seeds=3, duration=300.0)
    pols = [PredictivePolicy.from_params(p, **ctx) for p in params]
    kernel, kw = torchsim.slate_arguments(wl, fleet, pols)
    held = torchsim.clear_compiled()
    tiled = torchsim.run_dynamics(kernel, **kw, tile=2, device=cuda)
    assert len(torchsim._GRAPHS) == 1  # three tiles of two, one signature
    untiled = torchsim.run_dynamics(kernel, **kw, device=cuda)
    for k, v in untiled.items():
        assert np.array_equal(v, tiled[k]), k
    del held


def test_fleet_window_sums_add_left_to_right_on_the_card(cuda):
    from repro_torch.fleet.kernels import seq_sum0

    rng = np.random.default_rng(1)
    for shape in ((48, 512, 12), (12, 24, 12), (9, 1, 1), (30,), (5, 3)):
        x = rng.random(shape) * np.exp(rng.normal(0, 6, shape))
        want = x[0].copy()
        for row in x[1:]:
            want = want + row
        got = seq_sum0(torch.from_numpy(x).to(cuda)).cpu().numpy()
        assert np.array_equal(got, want), shape


# ---------------------- the autonomous loop (drift, tuner, oracle, controller) -----------


def test_drift_probe_on_the_card_launches_k1_and_k3_and_gives_the_cpu_verdicts(cuda):
    """The probe trains and checks on the card (K1's sim(D, D) and sim(D, X), K3's
    SPRT) and reaches the CPU probe's verdicts on ``drift_setup``'s three windows, with
    the same first alarm bin where a window drifted (a quiet window's stray trips move
    with Ginv, which rounding decides on this baseline: ROADMAP R7)."""
    from repro_torch.fleet.telemetry.drift import DriftProbe

    _, run = torch_control_cases.drift_world()
    base = run(0)
    windows = torch_control_cases.drift_windows()
    sim_module.launches = sprt_module.launches = 0
    card = DriftProbe(device=cuda).fit(base)
    reports = {k: card.check(w) for k, w in windows.items()}
    assert sim_module.launches == 2 + 3  # sim(D, D) and one sim(D, X) a call
    assert sprt_module.launches >= 3
    cpu = DriftProbe(device="cpu").fit(base)
    for name, w in windows.items():
        want, got = cpu.check(w), reports[name]
        assert got.drifted == want.drifted, name
        if want.drifted:
            assert got.first_alarm_bin == want.first_alarm_bin, name


def test_small_tune_on_the_card_equals_numpy(cuda):
    import repro_torch.fleet as fm

    for build in (torch_control_cases.static_scenario, torch_control_cases.portfolio_scenario):
        want = fm.tune(build(backend="numpy"), fm.StaticPolicy.param_space(), fm.Objective(),
                       fm.TuningBudget(10), seed=7)
        got = fm.tune(build(backend="torch", device=cuda), fm.StaticPolicy.param_space(),
                      fm.Objective(), fm.TuningBudget(10), seed=7)
        assert got.winner.params == want.winner.params
        assert got.sims_used == want.sims_used
        assert torch_control_cases.same_evals(want.evals, got.evals)


def test_controller_drift_case_on_the_card_gives_the_cpu_events(cuda):
    cc = torch_control_cases
    ctl, case = cc.drift_case(backend="numpy", device="cpu")
    want = ctl.run(case)
    sim_module.launches = sprt_module.launches = 0
    ctl, case = cc.drift_case(backend="torch", device=cuda)
    got = ctl.run(case)
    assert sim_module.launches > 0 and sprt_module.launches > 0
    assert cc.events_of(got) == cc.events_of(want)
    assert got.est_factor == want.est_factor and got.active_params == want.active_params


def test_column_oracle_on_the_card_equals_the_per_cell_numpy_build(cuda):
    import repro_torch.fleet as fm

    cc = torch_control_cases
    svc = cc.service()
    fl = cc.fleet(cc.PORT, svc)
    kw = dict(objective=fm.Objective(min_attainment=0.9),
              budget=fm.TuningBudget(n_candidates=5, init_seeds=1))
    grid = cc.small_oracle_grid(cc.PORT, svc)
    col = fm.build_oracle(grid, fl, fm.PIPolicy, fm.PIPolicy.param_space(), backend="torch",
                          device=cuda, **kw)
    cell = fm.build_oracle(grid, fl, fm.PIPolicy, fm.PIPolicy.param_space(), backend="numpy",
                           **kw)
    assert [c.to_json() for _, c in sorted(col.cells.items())] == \
        [c.to_json() for _, c in sorted(cell.cells.items())]
    assert col.build_info["sims_used"] < cell.build_info["sims_used"]


# ------------------------------ training (no kernel of its own) ------------------------------


def test_flash_kernel_refuses_inputs_that_need_a_gradient(cuda):
    from repro_torch.kernels import flash_attention_cuda

    q, k, v = (torch.randn(1, 64, 2, 64, device=cuda) for _ in range(3))
    before = flash_module.launches
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(q.requires_grad_(True), k, v)
    assert flash_module.launches == before
    with torch.no_grad():
        flash_attention_cuda(q, k, v)  # serving's prefill: no gradient asked for
    flash_attention_cuda(q.detach(), k, v)
    assert flash_module.launches == before + 2


@pytest.mark.parametrize(
    "arch", ["minitron-4b", "olmoe-1b-7b", "mamba2-130m", "seamless-m4t-large-v2", "jamba-v0.1-52b"]
)
def test_training_on_the_card_matches_the_cpu_and_never_launches_k2(cuda, arch):
    """Loss within 1e-5 relative and every gradient within 1e-4 of its leaf's largest,
    wq, wk and wv nonzero; K2 launched 0 times."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, build_model

    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    cpu = build_model(cfg, "cpu", torch.Generator().manual_seed(0), trainable=True)
    card = Model.from_numpy(cfg, cpu.to_numpy(), cuda, trainable=True)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
    if cfg.encdec:
        batch["frames"] = torch.randn(2, 64, cfg.d_model, generator=g)
    flash_module.launches = 0
    results = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        loss, _ = model.loss({k: t.to(dev) for k, t in batch.items()})
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        results.append((float(loss.detach()), grads))
    assert flash_module.launches == 0
    (l_cpu, g_cpu), (l_card, g_card) = results
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for name, want in g_cpu.items():
        assert float((g_card[name] - want).abs().max()) <= 1e-4 * float(want.abs().max()), name
        if name.split(".")[-1] in ("wq", "wk", "wv"):
            assert float(g_card[name].abs().max()) > 0, name


def test_train_job_on_the_card_recovers_and_resumes(cuda, tmp_path):
    from repro_torch.distributed.fault import FaultInjector
    from repro_torch.launch.train import TrainJob, train

    kw = dict(
        arch="mamba2-130m",
        seq_len=64,
        global_batch=4,
        ckpt_dir=str(tmp_path),
        ckpt_every=5,
        log_every=100,
        device=cuda,
    )
    job = TrainJob(steps=15, injector=FaultInjector(nan_steps={12}), **kw)
    m = train(job, verbose=False)
    assert m["restarts"] == 1 and m["steps"] == 15 and m["final_loss"] < m["first_loss"]
    job2 = TrainJob(steps=18, **kw)
    train(job2, verbose=False)
    assert job2.history[0]["step"] == 15


def test_service_on_the_card_is_no_faster_than_its_analytic_compute_bound(cuda):
    """The MSET service's estimate at (1024 signals, 4096 memory vectors, 8192
    observations): K1 launched once a call, finite residuals, equal to its plain version
    on the same inputs (K within 5e-6 of similarity_ref; Xhat and the residuals within
    8 sqrt(m) eps32 of their largest magnitude, the rounding walk of the sums of m terms
    that follow K), and its time (CUDA events) at least 0.95 x the analytic probe's
    t_compute at the card's peak."""
    from functools import partial

    from repro_torch._device import f32_matmul_highest
    from repro_torch.core import H100, analyze, roofline
    from repro_torch.kernels import similarity, similarity_ref
    from repro_torch.mset import service

    f32_matmul_highest()
    n, m, b = 1024, 4096, 8192
    gamma, kind = float(n) ** 0.5, "inverse_distance"
    fn = partial(service._estimate_sharded, gamma=gamma, kind=kind)
    cost = analyze(fn, *service.abstract_service_inputs(n, m, b).values())
    t_compute = roofline(cost.flops, cost.bytes_accessed, 0.0, 1, H100).t_compute
    g = torch.Generator(device=cuda).manual_seed(0)
    D = torch.randn(m, n, generator=g, device=cuda)
    Ginv = torch.randn(m, m, generator=g, device=cuda) / m
    mean = torch.randn(n, generator=g, device=cuda)
    std = 0.5 + torch.rand(n, generator=g, device=cuda)
    X = mean + std * torch.randn(b, n, generator=g, device=cuda)
    sim_module.launches = 0
    Xhat, resid = fn(D, Ginv, mean, std, X)
    assert sim_module.launches == 1
    assert Xhat.shape == resid.shape == (b, n) and bool(torch.isfinite(resid).all())
    Xs = (X - mean) / std
    K, K_ref = similarity(D, Xs, gamma=gamma, kind=kind), similarity_ref(D, Xs, gamma, kind)
    torch.testing.assert_close(K, K_ref, atol=5e-6, rtol=5e-6)
    Xhat_ref = (Ginv @ K_ref).T @ D * std + mean
    bar = 8 * m**0.5 * float(np.finfo(np.float32).eps)
    for out, ref in ((Xhat, Xhat_ref), (resid, X - Xhat_ref)):
        assert float((out - ref).abs().max()) <= bar * float(ref.abs().max())
    for _ in range(2):
        fn(D, Ginv, mean, std, X)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        fn(D, Ginv, mean, std, X)
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 5 / 1e3
    assert seconds >= 0.95 * t_compute, (seconds, t_compute)


@pytest.fixture
def card_mesh(cuda):
    """A (1, 1) mesh on the card, over a process group of one started here and torn
    down after the test when none was running."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_dev_mesh

    started = not dist.is_initialized()
    yield make_dev_mesh(device_type="cuda")
    if started:
        dist.destroy_process_group()


def test_sharded_serving_on_a_one_card_mesh_gives_the_unsharded_tokens(cuda, card_mesh):
    """minitron smoke on the card: greedy tokens through Model.shard on the (1, 1) mesh
    equal the unsharded path's; K2 runs on the local shards, once a layer."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.serve import decode_greedy
    from repro_torch.models import build_model

    flash = importlib.import_module("repro_torch.kernels.attention.flash")
    cfg = get_config("minitron-4b", smoke=True)
    g = torch.Generator(device=cuda).manual_seed(0)
    model = build_model(cfg, cuda, g)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device=cuda)

    def greedy():
        cache, logits = model.prefill(prompts, model.init_cache(4, 72))
        return decode_greedy(model, cache, logits, 64, 8)

    want = greedy()
    model.shard(make_rules(card_mesh))
    flash.launches = 0
    got = greedy().full_tensor()
    assert flash.launches == cfg.n_layers
    assert torch.equal(got, want)


def test_sharded_service_on_a_one_card_mesh_launches_k1_on_local_shards(cuda, card_mesh):
    from repro_torch.distributed.sharding import place
    from repro_torch.kernels import similarity_ref
    from repro_torch.mset import MSETModel
    from repro_torch.mset.service import _estimate_sharded, make_service, sharded_similarity

    n, m, b = 16, 128, 256
    g = torch.Generator(device=cuda).manual_seed(1)
    D = torch.randn(m, n, generator=g, device=cuda)
    Ginv = torch.randn(m, m, generator=g, device=cuda) / m
    mean, std = torch.randn(n, generator=g, device=cuda), 0.5 + torch.rand(n, device=cuda)
    X = mean + std * torch.randn(b, n, generator=g, device=cuda)
    est = make_service(MSETModel(D, Ginv, 4.0, "gaussian", mean, std), card_mesh)
    sim_module.launches = 0
    Xhat, resid = est(X)
    assert sim_module.launches == 1
    want_hat, want_res = _estimate_sharded(D, Ginv, mean, std, X, gamma=4.0, kind="gaussian")
    bar = 8 * m**0.5 * float(np.finfo(np.float32).eps)
    for out, ref in ((Xhat.full_tensor(), want_hat), (resid.full_tensor(), want_res)):
        assert float((out - ref).abs().max()) <= bar * float(ref.abs().max())
    Xs = (X - mean) / std
    Dp = est.inputs["D"]
    K = sharded_similarity(Dp, place(Xs, (card_mesh, Dp.placements)), 4.0, "gaussian")
    K_ref = similarity_ref(D, Xs, 4.0, "gaussian")
    torch.testing.assert_close(K.full_tensor(), K_ref, atol=5e-6, rtol=5e-6)


def test_kernel_wrappers_refuse_a_dtensor_on_the_card(cuda, card_mesh):
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import place
    from repro_torch.kernels import flash_attention_cuda, similarity_cuda, sprt_cuda

    rep = (card_mesh, (Replicate(), Replicate()))
    q = place(torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16), rep)
    with pytest.raises(TypeError, match="local"):
        flash_attention_cuda(q, q, q)
    x = place(torch.zeros(8, 4, device=cuda), rep)
    with pytest.raises(TypeError, match="local"):
        similarity_cuda(x, x)
    with pytest.raises(TypeError, match="local"):
        sprt_cuda(x, x[0], None, 1.0, 2.0, -2.0)
