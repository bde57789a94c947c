"""The port's one-chip dry-run (``repro_torch.launch.dryrun``) against the reference's
``probe_cost`` at full width, its abstract trees and input specs, and its CLI.

The reference runs on a one-device mesh with Auto axes, built here: jax 0.9.0's
``jax.make_mesh`` makes Explicit axes by default, and ``with_sharding_constraint``
then refuses the reference's specs (ROADMAP, R2). Its probes take the MoE's gather
path (``moe_impl="gather"``), which is the port's at one chip.
"""

import ast
import inspect
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np
from jax.sharding import AxisType

import repro.configs.base as jax_cfgbase
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.distributed.sharding import make_rules
from repro.launch import dryrun as jax_dryrun
from repro.launch.steps import StepBuilder as JStepBuilder
from repro_torch import _tree
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, get_config, input_specs
from repro_torch.core import analyze
from repro_torch.launch import dryrun
from repro_torch.launch.steps import StepBuilder
from repro_torch.models import moe

# (kind, seq_len, global_batch): one microbatch for train; an enc-dec shape's seq_len
# is its source's (frames), its decoder tokens an eighth of it
CUT_SHAPES = {
    "prefill": ("prefill", 2048, 4),
    "train": ("train", 2048, 2),
    "decode": ("decode", 2048, 4),
}

# port / reference FLOPs where XLA:CPU counts what the port does not (ROADMAP, R14):
# the f32 <-> bf16 converts its float normalization puts around bf16 ops, repeated in
# every fusion that reads them, and in decode the weights' converts, a whole stack at
# each layer of its 2x probe. The matmuls agree (mamba2's prefill: 7.79e10 a layer in
# both). Measured with jax 0.9.0 and torch 2.13.0 on the CPU, at PROBES' shapes and cuts.
R14 = {
    ("mamba2-130m", "prefill"): 0.9423,
    ("mamba2-130m", "train"): 0.9593,
    ("minitron-4b", "decode"): 0.5322,
    ("olmoe-1b-7b", "decode"): 0.2463,
    ("mamba2-130m", "decode"): 0.6169,
    ("jamba-v0.1-52b", "decode"): 0.7319,
    ("seamless-m4t-large-v2", "decode"): 0.2961,
}
# (arch, step, depth cut or None): prefill and train for one config of each family
# but the hybrid, decode for every family
PROBES = [
    ("minitron-4b", "prefill", None),
    ("minitron-4b", "train", 8),
    ("olmoe-1b-7b", "prefill", None),
    ("olmoe-1b-7b", "train", 8),
    ("mamba2-130m", "prefill", None),
    ("mamba2-130m", "train", 8),
    ("seamless-m4t-large-v2", "prefill", None),
    ("seamless-m4t-large-v2", "train", 8),
    ("minitron-4b", "decode", None),
    ("olmoe-1b-7b", "decode", None),
    ("mamba2-130m", "decode", None),
    ("jamba-v0.1-52b", "decode", 8),
    ("seamless-m4t-large-v2", "decode", None),
]


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def both_probes(mesh, monkeypatch, arch, step, depth):
    kind, S, B = CUT_SHAPES[step]
    name = f"{step}_{S}x{B}"
    monkeypatch.setitem(jax_cfgbase.SHAPES, name, jax_cfgbase.ShapeSpec(name, kind, S, B))
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if depth:  # an enc-dec config's encoder is cut alike
        cut = dict(n_layers=depth, **({"n_enc_layers": depth} if cfg.encdec else {}))
        jcfg, cfg = jcfg.replace(**cut), cfg.replace(**cut)
    with mesh:
        ref = jax_dryrun.probe_cost(
            arch, name, mesh, n_microbatches=1, moe_impl="gather", cfg_base=jcfg
        )
    ours = dryrun.probe_cost(arch, ShapeSpec(name, kind, S, B), n_microbatches=1, cfg_base=cfg)
    return ours, ref


@pytest.mark.parametrize("arch,step,depth", PROBES)
def test_probe_cost_matches_the_reference_at_full_width(mesh, monkeypatch, arch, step, depth):
    """Full width, one chip: the port counts every layer directly where the reference
    extrapolates its unrolled 1x and 2x probes; both should give the same FLOPs
    (within 2 %), except where R14 holds, where the ratio is the recorded one within
    1 %. Bytes and peak are printed, not held: XLA:CPU's fusion is not the eager
    program's."""
    ours, ref = both_probes(mesh, monkeypatch, arch, step, depth)
    ratio = ours.flops / ref.flops
    print(
        f"{arch} {step}: flops {ours.flops:.4e} / {ref.flops:.4e} = {ratio:.4f}; bytes "
        f"{ours.bytes_accessed:.3e} / {ref.bytes_accessed:.3e}; peak "
        f"{ours.peak_memory_per_device:.3e} / {ref.peak_memory_per_device:.3e}"
    )
    want = R14.get((arch, step), 1.0)
    assert ratio == pytest.approx(want, rel=0.01 if (arch, step) in R14 else 0.02)


def test_dense_decode_equals_its_hand_count():
    """minitron-4b's decode step (B 4 at position 2047 of a 2048 cache) against the
    count from its config: 2·B for each matmul weight (every parameter but the token
    table, which decode gathers), 4·B·H·hd per cached position and attention layer;
    the port adds its elementwise ops (under 0.5 %). R14's reference count is 1.9x."""
    cfg = get_config("minitron-4b")
    B, S = 4, 2048
    weights = cfg.param_counts()["total"] - cfg.vocab_size * cfg.d_model
    hand = 2.0 * B * weights + 4.0 * B * cfg.n_heads * cfg.head_dim * S * cfg.n_layers
    ours = dryrun.probe_cost("minitron-4b", ShapeSpec("d", "decode", S, B))
    assert hand <= ours.flops <= 1.005 * hand


@pytest.mark.parametrize("opt", dryrun.KNOWN_OPTS)
def test_each_knob_moves_the_count_by_its_hand_count(opt):
    """A smoke-width minitron-4b training pass at S 4096 with each knob, against none.
    causal_skip: 4 query chunks of 1024 in 4 buckets read 1, 2, 3 and 4 chunks of keys,
    so 6/16 of the two score products go (forward, and twice that backward), and the
    elementwise work on those scores with them. bf16_loss: the logits' float32 copy goes
    (a bf16 read and a float32 write an element), and the loss reads bf16 logits.
    decode_tp_params and moe_dense act on a mesh only (a decode's rules, the MoE's
    path): at one chip the count stands still."""
    cfg = get_config("minitron-4b", smoke=True)
    B, S = 2, 4096
    shape = ShapeSpec("t", "train", S, B)
    base, knob = (
        dryrun.probe_cost(cfg.name, shape, n_microbatches=1, cfg_base=cfg, opts=opts)
        for opts in ((), (opt,))
    )
    if opt == "causal_skip":
        scores = 2 * 2.0 * B * cfg.n_heads * S * S * cfg.head_dim * cfg.n_layers
        assert base.flops - knob.flops >= 6 / 16 * 3 * scores
        assert knob.bytes_accessed < base.bytes_accessed
    elif opt in ("decode_tp_params", "moe_dense"):
        assert (knob.flops, knob.bytes_accessed) == (base.flops, base.bytes_accessed)
    else:
        assert base.bytes_accessed - knob.bytes_accessed >= B * S * cfg.vocab_size * (2 + 4)


def _attention_weights(cfg):
    q_o = 2 * cfg.d_model * cfg.n_heads * cfg.head_dim
    return q_o + 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim


def _moe_decode_hand(cfg, B, S):
    """Each layer: the attention's projections (2·B a weight) and its scores over S
    cached positions (4·B·H·hd·S); the router (2·B·d·E); the gather path's expert FFNs
    on every slot, E experts of C = capacity(B) slots each, empty or not (2·E·C·3·d·ff).
    Then the logits (2·B·d·V)."""
    C = moe.capacity(cfg, B)
    layer = 2 * B * _attention_weights(cfg) + 4 * B * cfg.n_heads * cfg.head_dim * S
    layer += 2 * B * cfg.d_model * cfg.n_experts
    layer += 2 * cfg.n_experts * C * 3 * cfg.d_model * cfg.moe_d_ff
    return layer * cfg.n_layers + 2 * B * cfg.d_model * cfg.vocab_size


def _encdec_decode_hand(cfg, B, S):
    """Each decoder layer: self-attention's projections and its scores over S cached
    positions; cross-attention's q and o projections (its k and v are cached) and its
    scores over enc_memory_len; the GELU FFN's two matrices. Then the logits. The
    encoder does not run."""
    hd = cfg.n_heads * cfg.head_dim
    layer = 2 * B * _attention_weights(cfg) + 4 * B * hd * S
    layer += 2 * B * 2 * cfg.d_model * hd + 4 * B * hd * cfg.enc_memory_len
    layer += 2 * B * 2 * cfg.d_model * cfg.d_ff
    return layer * cfg.n_layers + 2 * B * cfg.d_model * cfg.vocab_size


def _ssm_decode_hand(cfg, B, S):
    """Each layer: in_proj and out_proj (2·B a weight), the conv over its window of W
    inputs (2·B·W·cch), and the state update on (B, H, N, P): decay (a product), the
    outer product dt·B ⊗ x (a product an element), their sum, and C · state (2 an
    element). Then the tied logits. S does not enter."""
    din, H, G, N, P = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    d, cch = cfg.d_model, cfg.d_inner + 2 * G * N
    layer = 2 * B * d * (2 * din + 2 * G * N + H) + 2 * B * din * d
    layer += 2 * B * cfg.conv_width * cch + 5 * B * H * N * P
    return layer * cfg.n_layers + 2 * B * d * cfg.vocab_size


@pytest.mark.parametrize(
    "arch,hand_count",
    [
        ("olmoe-1b-7b", _moe_decode_hand),
        ("seamless-m4t-large-v2", _encdec_decode_hand),
        ("mamba2-130m", _ssm_decode_hand),
    ],
)
def test_decode_equals_its_hand_count(arch, hand_count):
    """Each family's decode step (B 4 at position 2047 of a 2048 cache) against the
    count from its config, the matmul-like work; the port adds the elementwise ops on
    the scores and activations (under 1 %). The reference's counts are about 4.1x
    (olmoe), 3.4x (seamless) and 1.6x (mamba2) the port's (R14)."""
    cfg = get_config(arch)
    B, S = 4, 2048
    hand = hand_count(cfg, B, S)
    ours = dryrun.probe_cost(arch, ShapeSpec("d", "decode", S, B))
    assert hand <= ours.flops <= 1.01 * hand


def test_probe_cost_scales_one_microbatch_as_the_full_step_counts():
    """probe_cost (one microbatch times the count, plus AdamW) against the full step
    counted whole: they differ by the gradient sums between microbatches."""
    cfg = get_config("minitron-4b", smoke=True)
    shape = ShapeSpec("t", "train", 64, 8)
    probe = dryrun.probe_cost(cfg.name, shape, n_microbatches=4, cfg_base=cfg)
    fn, args, _ = dryrun.lower_cell(cfg.name, shape, n_microbatches=4, cfg_base=cfg)
    full = analyze(fn, *args)
    assert probe.flops == pytest.approx(full.flops, rel=0.01)
    assert probe.bytes_accessed == pytest.approx(full.bytes_accessed, rel=0.05)


# ------------------------------ abstract trees ------------------------------


def _shapes(tree, torch_side):
    if torch_side:
        return _tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), tree)
    return jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), tree)


def _decoder_only_specs(shape):
    """The input shapes of a decoder-only arch, for one the JAX package lacks."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": (B, 1), "pos": ()}
    return {"tokens": (B, S), **({"targets": (B, S)} if shape.kind == "train" else {})}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_have_the_reference_keys_and_shapes(arch):
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        ours = input_specs(cfg, shape)
        if arch in JAX_ARCH_IDS:
            ref = jax_input_specs(jax_get_config(arch), jax_cfgbase.SHAPES[name])
            want = {k: v.shape for k, v in ref.items()}
        else:
            want = _decoder_only_specs(shape)
        assert {k: np.shape(v) for k, v in ours.items()} == want
        assert all(v.device.type == "meta" for v in ours.values() if torch.is_tensor(v))
        assert ours["tokens"].dtype == torch.int64
        if shape.kind == "decode":
            assert ours["pos"] == shape.seq_len - 1


def _published_abstract_trees(cfg):
    """granite-4.0-h-small, which the JAX package lacks, against its published widths:
    4 stacks of its 10-layer period, attention at position 5, the shared expert."""
    sb = StepBuilder(cfg, device="meta")
    d, E, ff, sff = 4096, 72, 768, 1536
    for dtype, want in ((None, "float32"), ("bfloat16", "bfloat16")):
        tree = sb.abstract_params(dtype)
        assert len(tree["blocks"]) == 10 and tree["embed"]["tok"].shape == (100352, d)
        ffn = _shapes(tree["blocks"][0]["ffn"], True)
        assert ffn["w_up"] == ((4, E, d, ff), want) and ffn["shared_up"] == ((4, d, sff), want)
        assert ffn["shared_down"] == ((4, sff, d), want) and ffn["router"] == ((4, d, E), want)
        assert _shapes(tree["blocks"][5]["mixer"], True)["wq"] == ((4, d, 32, 128), want)
        assert _shapes(tree["blocks"][0]["mixer"], True)["w_in"] == ((4, d, 16768), want)
    params = sb.abstract_params()
    opt = sb.abstract_opt_state(params)
    assert _shapes(opt.mu, True) == _shapes(params, True)
    cache = _shapes(sb.cache_abstract(SHAPES["decode_32k"]), True)
    assert cache[5] == {"attn": {n: ((4, 128, 8, 32_768, 128), "bfloat16") for n in "kv"}}
    assert cache[0] == {"ssm": {"conv": ((4, 128, 3, 8448), "bfloat16"),
                                "state": ((4, 128, 128, 128, 64), "float32")}}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_cache_match_the_reference_leaf_for_leaf(arch):
    if arch not in JAX_ARCH_IDS:
        return _published_abstract_trees(get_config(arch))
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    sb, jsb = StepBuilder(cfg, device="meta"), JStepBuilder(jcfg, make_rules(None))
    for dtype in (None, "bfloat16"):
        ours, (ref, _) = sb.abstract_params(dtype), jsb.abstract_params(dtype)
        assert _shapes(ours, True) == _shapes(ref, False)
    opt, jopt = sb.abstract_opt_state(sb.abstract_params()), jsb.abstract_opt_state(ref)
    assert _shapes(tuple(opt), True) == _shapes(tuple(jopt), False)
    shape = SHAPES["decode_32k"]
    ours, (ref, _) = sb.cache_abstract(shape), jsb.cache_abstract(jax_cfgbase.SHAPES["decode_32k"])
    assert _shapes(ours, True) == _shapes(ref, False)
    assert all(p.device.type == "meta" for p in sb.params.values())


# ---------------------------------- the CLI ---------------------------------


def _reference_ok_keys() -> set:
    """The keys of the reference's record for a cell that ran: its ``rec`` dict's first
    keys and those of its ``rec.update(status="ok", ...)``, read from its source."""
    tree = ast.parse(inspect.getsource(jax_dryrun.run_cell))
    keys = {"arch", "shape", "mesh"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "update":
            kw = {k.arg: k.value for k in node.keywords}
            if isinstance(kw.get("status"), ast.Constant) and kw["status"].value == "ok":
                keys |= set(kw)
    return keys


def test_cli_writes_a_record_with_the_reference_keys(tmp_path):
    recs = dryrun.main(["--arch", "mamba2-130m", "--shape", "train_4k", "--out", str(tmp_path)])
    path = tmp_path / "h100-1" / "mamba2-130m__train_4k.json"
    rec = json.loads(path.read_text())
    assert rec == json.loads(json.dumps(recs[0], default=float))
    assert rec["status"] == "ok" and rec["chips"] == 1 and rec["mesh"] == "h100-1"
    assert set(rec) == _reference_ok_keys()
    assert rec["t_step"] == max(rec["t_compute"], rec["t_memory"], rec["t_collective"])
    assert rec["flops"] > rec["model_flops"] > 0 and rec["peak_memory_per_device"] > 0


def test_cli_skips_what_the_reference_skips_and_refuses_many_chips(tmp_path):
    """The skip record; the refusals that remain: no cell named, and expert parallelism
    on the one-chip count, which has no mesh (the pod meshes take it)."""
    rec = dryrun.run_cell("minitron-4b", "long_500k", out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "skip" and set(rec) == {"arch", "shape", "mesh", "status", "reason"}
    for flags in ([], ["--moe-impl", "ep"], ["--mesh", "h100-1", "--moe-impl", "ep", "--all"]):
        with pytest.raises(SystemExit):
            dryrun.main(flags)
    with pytest.raises(ValueError, match="mesh"):
        dryrun.run_cell("olmoe-1b-7b", "decode_32k", moe_impl="ep", out_dir=str(tmp_path))
