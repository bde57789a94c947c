"""granite-4.0-h-small (Granite 4.0-H: Mamba-2, NoPE attention, 72 routed experts top
10 and a shared expert, µP-style multipliers) through the port's serving path against
its plain reference, the benchmark's ``portbench/reference_granite.py`` (loaded from its
file), on the CPU at the smoke size with the same seeded weights. The JAX package has no
such model.
"""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import _telemetry as telemetry
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models.model import from_reference

ARCH = "granite-4.0-h-small"
REPO = Path(__file__).resolve().parents[1]
REFERENCE = REPO / "portbench" / "reference_granite.py"


def load_reference():
    """The plain reference, a module of its own loaded from its file."""
    spec = importlib.util.spec_from_file_location("reference_granite", REFERENCE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = load_reference()
B, S, N_DECODE = 2, 37, 8
# float32 on both sides: the same sums in other orders (the chunked SSD against the
# sequential recurrence, grouped products, blocked attention); measured ~1.4e-6 of the
# logits' spread, so 2e-5 is ~15x room and far under the ~3e-2 that bfloat16 gives.
TOL = 2e-5


def _cfg(**overrides):
    return get_config(ARCH, smoke=True).replace(dtype="float32", **overrides)


def _setup(cfg, seed=5):
    params = ref.init_params(cfg.published(), seed, "cpu", dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(seed))
    return params, toks


def _gap(port, reference):
    """max |port - reference| over each logit vector's spread, the largest over all."""
    return float(((port - reference).abs() / reference.std(-1, keepdim=True)).max())


def _prefill_and_decode(cfg, params, toks):
    """The port's last-token prefill logits and N_DECODE greedy decode steps through
    the prefill's cache: (logits (B, 1 + N_DECODE, V), the tokens fed back (B, N_DECODE))."""
    model = from_reference(cfg, params)
    cache, logits = model.prefill(toks, model.init_cache(B, S + N_DECODE))
    seq, fed = [logits[:, -1]], []
    for i in range(N_DECODE):
        fed.append(seq[-1].argmax(-1))
        cache, logits = model.decode_step(cache, fed[-1][:, None], S + i)
        seq.append(logits[:, -1])
    return torch.stack(seq, 1).float(), torch.stack(fed, 1)


def test_smoke_config_is_one_period_at_the_published_pattern():
    full, smoke = get_config(ARCH), get_config(ARCH, smoke=True)
    kinds = [full.published()["layer_types"][i] for i in range(10)]
    assert kinds == ["mamba"] * 5 + ["attention"] + ["mamba"] * 4
    assert smoke.published()["layer_types"] == kinds
    assert (full.ssm_nheads, full.d_inner, full.n_experts, full.shared_d_ff) == (128, 8192, 72, 1536)
    counts = full.param_counts()  # 32B total, 9B active: the shared expert counted
    assert round(counts["total"] / 1e9) == 32 and round(counts["active"] / 1e9) == 9
    no_shared = full.replace(shared_d_ff=0).param_counts()
    assert counts["total"] - no_shared["total"] == 40 * 3 * 4096 * 1536


def test_prefill_logits_match_reference():
    cfg = _cfg()
    params, toks = _setup(cfg)
    _, logits = from_reference(cfg, params).prefill(toks)
    assert _gap(logits[:, -1].float(), ref.forward(cfg.published(), params, toks)[:, -1]) < TOL


def test_prefill_and_decode_through_the_cache_match_the_full_forward():
    cfg = _cfg()
    params, toks = _setup(cfg, seed=11)
    port, fed = _prefill_and_decode(cfg, params, toks)
    full = torch.cat([toks, fed], 1)
    reference = ref.forward(cfg.published(), params, full, last=1 + N_DECODE)
    assert _gap(port, reference) < TOL


@pytest.mark.parametrize(
    "change",
    ["embedding_multiplier", "residual_multiplier", "attention_multiplier", "logits_scaling",
     "shared_expert"],
)
def test_each_multiplier_and_the_shared_expert_is_followed(change):
    """The reference without the one setting (at 1, or without the shared expert's
    output) gives other logits, and the port, set alike, follows it."""
    cfg = _cfg()
    params, toks = _setup(cfg, seed=3)
    hf = cfg.published()
    before = ref.forward(hf, params, toks)
    if change == "shared_expert":
        for layer in params["layers"]:
            layer["shared"]["down"] = torch.zeros_like(layer["shared"]["down"])
    else:
        cfg = cfg.replace(**{change: 1.0})
        hf = cfg.published()
    after = ref.forward(hf, params, toks)
    assert _gap(after, before) > 100 * TOL
    _, logits = from_reference(cfg, params).prefill(toks)
    assert _gap(logits[:, -1:].float(), after) < TOL


def _forced(cfg, T=48, seed=0):
    """Weights in the reference's layout and an input (T, d) whose router logits in layer
    0 put every token on the same top k experts, in the same order."""
    g = torch.Generator().manual_seed(seed)
    d, E, k = cfg.d_model, cfg.n_experts, cfg.n_experts_per_tok
    params = ref.init_params(cfg.published(), seed, "cpu", dtype=torch.float32)
    v = torch.randn(d, generator=g)
    x = v + 0.01 * torch.randn(T, d, generator=g)
    router = torch.zeros(d, E)
    for rank in range(k):  # expert 3 + rank gets logit ~ (k - rank) * 10 * |v|^2
        router[:, 3 + rank] = v * 10.0 * (k - rank)
    params["layers"][0]["moe"]["router"] = router
    return params, x


def test_dropless_dispatch_keeps_every_slot_of_a_router_forced_onto_one_expert():
    cfg = _cfg()
    params, x = _forced(cfg)
    T, k = x.shape[0], cfg.n_experts_per_tok
    p = dict(from_reference(cfg, params).blocks[0].ffn.named_parameters())
    params = params["layers"][0]
    with telemetry.session() as tel:
        y, _ = moe.apply_moe(cfg, p, x[None], layer=0)
    tel.settle()
    snap = tel.metrics.snapshot()
    assert snap["counter"]["moe_dropped_slots_total"][""] == 0
    assert snap["counter"]["moe_routed_slots_total"]["layer=0"] == T * k
    # each of the k chosen experts holds every token: E / k times the mean
    assert snap["gauge"]["moe_expert_load_max"]["layer=0"] == cfg.n_experts / k
    s = params["shared"]
    want = ref.moe(cfg.published(), params["moe"], x) + ref.swiglu(x, s["up"], s["gate"], s["down"])
    assert _gap(y[0], want) < TOL
    # the capacity path drops most of those slots: what the dropless one is for
    gathered, _ = moe.apply_moe(cfg.replace(moe_dropless=False, shared_d_ff=0), p, x[None])
    assert moe.capacity(cfg, T) < T and _gap(gathered[0], want) > 0.1


def test_grouped_products_equal_a_loop_over_the_experts_with_empty_experts():
    """bfloat16 takes ``torch._grouped_mm`` over the experts' offsets; experts with no
    rows (decode) are skipped. Each row against its own expert's product."""
    cfg = get_config(ARCH, smoke=True)
    g = torch.Generator().manual_seed(4)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {n: (torch.randn(E, *dims, generator=g) / dims[0] ** 0.5).bfloat16()
         for n, dims in (("w_up", (d, ff)), ("w_gate", (d, ff)), ("w_down", (ff, d)))}
    sizes = [3, 0, 0, 5, 1, 0, 7, 0]
    offs = torch.tensor(sizes).cumsum(0).to(torch.int32)
    xs = torch.randn(sum(sizes), d, generator=g).bfloat16()
    got = moe._expert_rows(cfg.mlp_type, p, xs, offs)
    e_of_row = torch.repeat_interleave(torch.arange(E), torch.tensor(sizes))
    for r, e in enumerate(e_of_row.tolist()):
        x = xs[r : r + 1].float()
        up, gate, down = (p[n][e].float() for n in ("w_up", "w_gate", "w_down"))
        want = ref.swiglu(x, up, gate, down)
        assert float((got[r].float() - want[0]).abs().max()) <= 0.05 * float(want.abs().max())


def test_serve_generates_through_the_cache():
    r = serve.generate(ARCH, device="cpu", batch=2, prompt_len=24, gen_tokens=6)
    assert r.tokens.shape == (2, 6)
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    model = from_reference(cfg, ref.init_params(cfg.published(), 2, "cpu", torch.float32))
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(2))
    _, whole = model.prefill(toks)
    cache, _ = model.prefill(toks[:, :-1], model.init_cache(2, 32))
    _, step = model.decode_step(cache, toks[:, -1:], 31)
    assert _gap(step[:, -1], whole[:, -1]) < TOL


def test_the_reference_imports_torch_alone():
    assert {"torch", "math", "__future__"} >= {
        line.split()[1].split(".")[0] for line in REFERENCE.read_text().splitlines()
        if line.startswith(("import ", "from "))
    }
