"""The port's sharding layer (``repro_torch.distributed.sharding``, ``launch/mesh.py``,
the models' logical axes, ``launch/steps.py``'s shardings) against ``repro``'s, and
its sharded analytic count against the reference's on 8 devices.

The reference's resolution runs on ``tests/test_sharding.py``'s duck-typed mesh; the
port's on one with ``DeviceMesh``'s attributes, or on a real ``DeviceMesh`` in a
``fake_world``. The 8-device count runs the reference in a subprocess with
``--xla_force_host_platform_device_count=8`` on a mesh with Auto axes, built here
(jax 0.9.0's default Explicit axes make its dry-run raise, ROADMAP R2).
"""

import contextlib
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jax_sharding
from repro.distributed.sharding import unbox_axes as jax_unbox_axes
from repro.launch.steps import StepBuilder as JStepBuilder
from repro_torch import _tree
from repro_torch.configs import ARCH_IDS, ShapeSpec, get_config
from repro_torch.core import ContainerStress, get_shape
from repro_torch.core import hlo_analysis
from repro_torch.core.catalog import CATALOG
from repro_torch.distributed import sharding
from repro_torch.kernels import flash_attention_cuda, similarity_cuda
from repro_torch.launch import dryrun, mesh as mesh_mod
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.steps import StepBuilder
from repro_torch.models.model import Model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class JaxMesh:
    """tests/test_sharding.py's duck-typed mesh for the reference's resolution."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


class TorchMesh:
    """The same for the port: a ``DeviceMesh``'s names and shape."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


PKGS = {
    "repro": lambda sizes: jax_sharding.ShardingRules(JaxMesh(sizes)),
    "repro_torch": lambda sizes: sharding.ShardingRules(TorchMesh(sizes)),
}


def spec(r, axes, shape):
    return tuple(r.spec_for(axes, shape))


# ------------------ (a) tests/test_sharding.py's cases, both packages ------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_basic_resolution(pkg):
    r = PKGS[pkg]({"data": 4, "model": 4})
    assert spec(r, ("embed", "mlp"), (512, 2048)) == ("data", "model")


@pytest.mark.parametrize("pkg", PKGS)
def test_indivisible_dim_falls_back_to_replicated(pkg):
    r = PKGS[pkg]({"data": 4, "model": 16})
    assert spec(r, ("embed", "kv_heads", "head_dim"), (512, 1, 128)) == ("data",)


@pytest.mark.parametrize("pkg", PKGS)
def test_mesh_axis_used_once(pkg):
    r = PKGS[pkg]({"data": 4, "model": 4})
    assert spec(r, ("heads", "mlp"), (16, 2048)) == ("model",)


@pytest.mark.parametrize("pkg", PKGS)
def test_pod_axis_tuple(pkg):
    r = PKGS[pkg]({"pod": 2, "data": 4, "model": 4})
    assert spec(r, ("batch", None, None), (64, 128, 256))[0] == ("pod", "data")


@pytest.mark.parametrize("pkg", PKGS)
def test_missing_pod_axis_dropped(pkg):
    r = PKGS[pkg]({"data": 4, "model": 4})
    assert spec(r, ("batch",), (64,))[0] == "data"


@pytest.mark.parametrize("pkg", PKGS)
def test_constrain_noop_without_mesh(pkg):
    x = torch.ones(4, 4) if pkg == "repro_torch" else jax.numpy.ones((4, 4))
    r = sharding.ShardingRules(None) if pkg == "repro_torch" else jax_sharding.ShardingRules(None)
    assert r.constrain(x, ("batch", None)) is x


MESHES = {
    "1x1": {"data": 1, "model": 1},
    "2x4": {"data": 2, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
# dims that divide, that divide one axis of a pair but not both, and that divide none
DIMS = (1, 2, 3, 6, 8, 16, 24, 40, 64, 256, 4096)


@pytest.mark.parametrize("mesh", MESHES)
def test_every_logical_axis_resolves_as_the_reference(mesh):
    """spec_for of each logical axis (and of a pair on one mesh axis, and of None), at
    every dim size, in one and two dims: the same entries value for value."""
    ours, ref = PKGS["repro_torch"](MESHES[mesh]), PKGS["repro"](MESHES[mesh])
    names = sorted(jax_sharding.DEFAULT_RULES) + [None]
    assert sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES
    for a in names:
        for d in DIMS:
            assert spec(ours, (a,), (d,)) == spec(ref, (a,), (d,)), (a, d)
            for b in ("model", "heads", "batch", "embed", None):
                for e in (16, 40):
                    got, want = spec(ours, (a, b), (d, e)), spec(ref, (a, b), (d, e))
                    assert got == want, (a, b, d, e)


def test_placements_follow_the_spec_and_refuse_an_order_dtensor_would_change():
    r = sharding.ShardingRules(TorchMesh({"pod": 2, "data": 4, "model": 4}))
    assert r.placements_for(("batch", None, "act_vocab"), (64, 8, 512)) == (
        Shard(0),
        Shard(0),
        Shard(2),
    )
    assert r.placements_for(("embed", "kv_heads"), (512, 1)) == (
        Replicate(),
        Shard(0),
        Replicate(),
    )
    bad = sharding.ShardingRules(TorchMesh({"pod": 2, "data": 4}), {"batch": ("data", "pod")})
    with pytest.raises(ValueError, match="mesh order"):
        bad.placements_for(("batch",), (64,))


# --------------------- (b) logical axes of every leaf, every arch ---------------------


def _axes_leaves(tree, pkg):
    is_axes = lambda x: isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)
    if pkg == "repro":
        return jax.tree.leaves(tree, is_leaf=is_axes)
    return _tree.leaves(tree, is_leaf=is_axes)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_axes_equal_the_reference_leaf_for_leaf(arch):
    model = Model(get_config(arch, smoke=True), "meta")
    jsb = JStepBuilder(jax_get_config(arch, smoke=True), jax_sharding.make_rules(None))
    _, boxed = jsb.abstract_params()
    ref = _axes_leaves(jax_unbox_axes(boxed), "repro")
    assert _axes_leaves(model.param_axes(), "repro_torch") == ref
    cache = jax_unbox_axes(jsb.model.cache_specs(2, 16))
    assert _axes_leaves(model.cache_axes(), "repro_torch") == _axes_leaves(cache, "repro")
    assert any(a[0] == "stack" for a in ref)


# ------------------- (c) per-device shard shapes at (2, 4) and (16, 16) -------------------


def _ref_shard_shapes(rules, boxed, leaves_of):
    out = []
    sizes = dict(zip(rules.mesh.axis_names, rules.mesh.devices.shape))
    for b in leaves_of(boxed):
        shape = list(b.value.shape)
        for d, entry in enumerate(rules.spec_for(b.axes, shape)):
            for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                shape[d] //= sizes[a]
        out.append(tuple(shape))
    return out


def _local_shapes(shardings, shapes):
    out = []
    for (mesh, placements), shape in zip(shardings, shapes):
        out.append(tuple(sharding._local_shape(shape, mesh, placements)))
    return out


@pytest.mark.parametrize("mesh", ["2x4", "16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_shapes_equal_the_reference(arch, mesh):
    """Every parameter, optimizer-moment and cache leaf's per-device shape (experts
    padded to the model axis in both), and the optimizer step replicated."""
    sizes = MESHES[mesh]
    jrules = jax_sharding.make_rules(JaxMesh(sizes))
    jsb = JStepBuilder(jax_get_config(arch, smoke=True), jrules)
    _, boxed = jsb.abstract_params()
    is_box = lambda x: isinstance(x, jax_sharding.Box)
    jleaves = lambda t: jax.tree.leaves(t, is_leaf=is_box)
    ref_params = _ref_shard_shapes(jrules, boxed, jleaves)
    ref_cache = _ref_shard_shapes(jrules, jsb.model.cache_specs(32, 64), jleaves)
    shape = ShapeSpec("c", "decode", 64, 32)
    with fake_world(int(np.prod(list(sizes.values())))):
        dmesh = init_device_mesh("cpu", tuple(sizes.values()), mesh_dim_names=tuple(sizes))
        rules = sharding.make_rules(dmesh)
        sb = StepBuilder(get_config(arch, smoke=True), device="meta", rules=rules)
        is_sh = sharding.is_sharding
        ps = _tree.leaves(sb.param_shardings(), is_leaf=is_sh)
        shapes = [t.shape for t in _tree.leaves(sb.model.tree_like())]
        assert _local_shapes(ps, shapes) == ref_params
        opt = sb.opt_shardings(sb.param_shardings())
        assert opt.step[1] == (Replicate(),) * 2
        for moments in (opt.mu, opt.nu):
            assert _local_shapes(_tree.leaves(moments, is_leaf=is_sh), shapes) == ref_params
        cs = _tree.leaves(sb.cache_shardings(shape), is_leaf=is_sh)
        is_spec = lambda x: isinstance(x, tuple) and isinstance(x[0], tuple)
        cache_shapes = [s[0] for s in _tree.leaves(sb.model.cache_specs(32, 64), is_leaf=is_spec)]
        assert _local_shapes(cs, cache_shapes) == ref_cache


# ------------------------- mesh, catalog, kernels, scoping -------------------------


def test_meshes_catalog_and_fake_world():
    with fake_world(512):
        pod = mesh_mod.make_production_mesh(multi_pod=True, device_type="cpu")
        assert pod.mesh_dim_names == ("pod", "data", "model") and tuple(pod.shape) == (2, 16, 16)
        assert mesh_mod.mesh_axis_sizes(pod) == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError):  # a second world over a running one
        with fake_world(2):
            with fake_world(2):
                pass
    for shape in CATALOG:
        with fake_world(shape.chips):
            m = shape.make_mesh("cpu")
            assert tuple(m.shape) == shape.mesh_shape and m.mesh_dim_names == shape.axes
    with fake_world(8):
        dev = mesh_mod.make_dev_mesh(device_type="cpu")
        assert tuple(dev.shape) == (2, 4) and dev.mesh_dim_names == ("data", "model")
    assert not torch.distributed.is_initialized()


def test_kernel_wrappers_refuse_a_dtensor():
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        x = sharding.place(torch.zeros(4, 8, 2, 16), (mesh, (Replicate(), Replicate())))
        with pytest.raises(TypeError, match="local"):
            flash_attention_cuda(x, x, x)
        y = sharding.place(torch.zeros(8, 4), (mesh, (Replicate(), Replicate())))
        with pytest.raises(TypeError, match="local"):
            similarity_cuda(y, y)


def test_run_analytic_counts_a_shape_of_many_chips_per_device():
    """A step of one matmul on a (16, 16) mesh, its weight sharded over ``model``:
    per-device FLOPs times 256 are the global product's, and the all-gather of the
    activations' shards is counted by its result."""

    def lower(p, shape):
        mesh = shape.make_mesh("cpu")
        rules = sharding.make_rules(mesh)
        x, w = torch.empty(256, p["d"], device="meta"), torch.empty(p["d"], 512, device="meta")
        x = sharding.place(x, rules.sharding_for(("batch", None), x.shape))
        w = sharding.place(w, rules.sharding_for((None, "mlp"), w.shape))
        return (lambda x, w: (x @ w).redistribute(mesh, (Replicate(), Replicate()))), (x, w)

    res = ContainerStress().run_analytic(lower, {"d": [64]}, [get_shape("v5e-256")])
    (row,) = res.rows
    assert row.params == {"d": 64, "shape": 256}
    assert row.analysis["flops"] == 2 * 256 * 64 * 512
    assert set(row.analysis["collective_bytes_by_kind"]) == {"all-gather"}
    assert row.analysis["collective_bytes"] > 0


def test_multi_pod_dry_run_writes_an_ok_record_with_all_to_all(tmp_path, monkeypatch):
    """The CLI at pod2x16x16 on olmoe smoke's train step (experts parallel off decode)."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_config(arch, smoke=True))
    argv = ["--arch", "olmoe-1b-7b", "--shape", "train_4k", "--multi-pod", "--out", str(tmp_path)]
    (rec,) = dryrun.main(argv)
    path = tmp_path / "pod2x16x16" / "olmoe-1b-7b__train_4k.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec, default=float))
    assert rec["status"] == "ok" and rec["chips"] == 512 and rec["mesh"] == "pod2x16x16"
    assert rec["collective_bytes_by_kind"]["all-to-all"] > 0


# --------------------- (e) the 8-device count against the reference ---------------------

ARCHS_8 = ["minitron-4b", "olmoe-1b-7b", "mamba2-130m"]

REFERENCE = textwrap.dedent(
    """
    import json, math, os, re, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.configs import base as cfgbase
    from repro.core import hlo_analysis
    from repro.launch import dryrun
    from repro.models.transformer import block_period

    cfgbase.SHAPES["train_4k"] = cfgbase.ShapeSpec("train_4k", "train", 256, 8)
    auto = (AxisType.Auto,) * 2
    meshes = {
        8: jax.make_mesh((2, 4), ("data", "model"), axis_types=auto),
        1: jax.make_mesh((1, 1), ("data", "model"), axis_types=auto, devices=jax.devices()[:1]),
    }
    # the MoE's own all-to-alls (shard_map's), apart from GSPMD's reshards
    EP = re.compile(r'=\\s*(\\([^)]*\\)|\\S+)\\s*all-to-all\\(.*op_name="[^"]*shard_map')
    # a convert's elements (a FLOP each in XLA's cost analysis)
    CONVERT = re.compile(r'=\\s*\\w+\\[([\\d,]*)\\]\\S*\\s+convert\\(')
    seen, converts = [], []
    analyze_compiled = dryrun.analyze_compiled

    def recording(compiled, n_devices=1, hlo_text=None):
        text = compiled.as_text()
        hits = [EP.search(line) for line in text.splitlines()]
        seen.append(sum(hlo_analysis._shape_bytes(m.group(1)) for m in hits if m))
        dims = [m.group(1).split(",") for m in map(CONVERT.search, text.splitlines()) if m]
        converts.append(sum(math.prod(int(d) for d in ds if d) for ds in dims))
        return analyze_compiled(compiled, n_devices, hlo_text=text)

    dryrun.analyze_compiled = recording
    out = {}
    for arch in sys.argv[1:]:
        cfg = get_config(arch, smoke=True)
        n_stack = cfg.n_layers // block_period(dryrun.tune_cfg(cfg, cfgbase.SHAPES["train_4k"]))
        rec = {}
        for n, mesh in meshes.items():
            with mesh:
                del seen[:], converts[:]
                cost = dryrun.probe_cost(arch, "train_4k", mesh, n_microbatches=2, cfg_base=cfg)
                ep = 2 * (seen[0] + (n_stack - 1) * (seen[1] - seen[0]))
                c1, c2, c_opt = converts  # the probes at 1x and 2x depth, the optimizer
                conv = n * (2 * (c1 + (n_stack - 1) * (c2 - c1)) + c_opt)
                rec[n] = dict(flops=cost.flops, kinds=cost.collectives.bytes_by_kind,
                              total=cost.collective_bytes, ep_all_to_all=ep, converts=conv)
                if n == 8:
                    lowered, _ = dryrun.lower_cell(arch, "train_4k", mesh, n_microbatches=2,
                                                   cfg_base=cfg)
                    ma = lowered.compile().memory_analysis()
                    rec[n]["argument_bytes"] = ma.argument_size_in_bytes
        out[arch] = rec
    print(json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def counts():
    """Both packages' counts of tests/test_sharding.py's cell (train_4k cut to S 256,
    B 8, 2 microbatches, smoke configs) at (2, 4) and at one device."""
    # the host's CPU as 8 devices, also where jax would pick a card
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE, *ARCHS_8],
        capture_output=True,
        text=True,
        env=env,
        cwd=ROOT,
        timeout=400,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    shape = ShapeSpec("train_4k", "train", 256, 8)
    ours = {}
    for arch in ARCHS_8:
        cfg = get_config(arch, smoke=True)
        rec = {}
        for n, dims in ((8, (2, 4)), (1, (1, 1))):
            with fake_world(n):
                mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
                with _tallied_converts() as converts:
                    cost = dryrun.probe_cost(arch, shape, mesh, n_microbatches=2, cfg_base=cfg)
                mem, _ = dryrun.memory_cost(arch, shape, mesh, n_microbatches=2, cfg_base=cfg)
            c_probe, c_opt = converts  # one microbatch at full depth, the optimizer
            rec[n] = dict(
                flops=cost.flops,
                kinds=cost.collectives.bytes_by_kind,
                total=cost.collective_bytes,
                argument_bytes=mem.argument_bytes_per_device,
                converts=n * (2 * c_probe + c_opt),
            )
        ours[arch] = rec
    return ours, ref


@contextlib.contextmanager
def _tallied_converts():
    """The FLOPs the port's counter gives dtype conversions (a copy to another dtype,
    one an element), per device, one entry an ``analyze`` call made inside."""
    tallies = []
    dispatch = hlo_analysis._Counter.__torch_dispatch__

    def tallying(self, func, types, args=(), kwargs=None):
        if self not in tallies:
            tallies.append(self)
            self.converts = 0
        before = self.flops
        out = dispatch(self, func, types, args, kwargs)
        if hlo_analysis._rule(func)[1] == "copy":
            self.converts += self.flops - before
        return out

    converts = []
    hlo_analysis._Counter.__torch_dispatch__ = tallying
    try:
        yield converts
    finally:
        hlo_analysis._Counter.__torch_dispatch__ = dispatch
        converts.extend(c.converts for c in tallies)


def _table(ours, ref, arch):
    o, r = ours[arch][8], ref[arch]["8"]
    kinds = sorted(set(o["kinds"]) | set(r["kinds"]))
    return "\n".join(
        f"  {k:20s} port {o['kinds'].get(k, 0):12.0f}  reference {r['kinds'].get(k, 0):12.0f}"
        for k in kinds
    )


@pytest.mark.parametrize("arch", ARCHS_8)
def test_eight_device_argument_bytes_equal_the_reference(counts, arch):
    """Parameters, AdamW moments and step, and the batch, per device (the port's ids
    are int64 sharded over ``data``, the reference's int32 whole: the same bytes at
    (2, 4))."""
    ours, ref = counts
    assert ours[arch][8]["argument_bytes"] == ref[arch]["8"]["argument_bytes"]


def test_eight_device_expert_all_to_all_bytes_equal_the_reference(counts):
    """olmoe's expert-parallel all-to-alls (2 forward, 2 backward and 2 recomputed a
    layer, per microbatch): each (ep, E_l, C, d). XLA:CPU carries the reference's bf16
    buffers as float32 (its float normalization, ROADMAP R14), so its bytes are twice
    the port's bf16 ones."""
    ours, ref = counts
    port = ours["olmoe-1b-7b"][8]["kinds"]["all-to-all"]
    assert 2 * port == ref["olmoe-1b-7b"]["8"]["ep_all_to_all"] > 0
    assert "all-to-all" not in ours["minitron-4b"][8]["kinds"]


@pytest.mark.parametrize("arch", ARCHS_8)
def test_eight_device_collective_bytes_within_twice_the_reference(counts, arch):
    ours, ref = counts
    o, r = ours[arch][8]["total"], ref[arch]["8"]["total"]
    print(f"{arch}: port {o:.4e}, reference {r:.4e}\n" + _table(ours, ref, arch))
    assert r / 2 <= o <= 2 * r, _table(ours, ref, arch)


@pytest.mark.parametrize("arch", ARCHS_8)
def test_eight_device_flops_grow_with_the_mesh_as_the_reference(counts, arch):
    """The port/reference FLOPs ratio at (2, 4) against the same ratio at one device:
    both packages replicate the work the rules leave unsharded (norms and residuals
    over ``model``), each its own way (ROADMAP R15). The port's products are each
    rank's own (column and row parallel, the experts' and SSM heads' local), GSPMD
    replicates more: at (2, 4) the port's global FLOPs grow 2-18 % over one device,
    the reference's 19-33 %, so the ratio falls 11-16 %, not within the 1 % aimed at.
    Held within GROWTH; most of the gap is XLA's converts (the next test)."""
    ours, ref = counts
    at8 = ours[arch][8]["flops"] / ref[arch]["8"]["flops"]
    at1 = ours[arch][1]["flops"] / ref[arch]["1"]["flops"]
    print(f"{arch}: port/reference at (2, 4) {at8:.4f}, at one device {at1:.4f}")
    assert at8 / at1 == pytest.approx(1.0, abs=GROWTH[arch])


GROWTH = {"minitron-4b": 0.2, "olmoe-1b-7b": 0.2, "mamba2-130m": 0.2}


@pytest.mark.parametrize("arch", ARCHS_8)
def test_eight_device_flops_less_converts_grow_with_the_mesh_as_the_reference(counts, arch):
    """The same ratio with each package's dtype conversions taken out (XLA counts a
    convert's elements as FLOPs, the port a copy to another dtype). From one device to
    (2, 4) most of the reference's growth is converts: XLA:CPU computes bf16 in float32
    and converts around each partitioned op (ROADMAP R14, R15), which each device
    repeats. Without them minitron's and mamba2's ratios hold within 1 %; olmoe's falls
    4.6 %, GSPMD replicating more of its elementwise work than the port (the token
    gather's select, the backward's adds and products; ROADMAP R15)."""
    ours, ref = counts

    def ratio(n):
        o, r = ours[arch][n], ref[arch][str(n)]
        return (o["flops"] - o["converts"]) / (r["flops"] - r["converts"])

    print(f"{arch}: less converts, port/reference at (2, 4) {ratio(8):.4f}, one {ratio(1):.4f}")
    assert ratio(8) / ratio(1) == pytest.approx(1.0, abs=CONVERTLESS[arch])


CONVERTLESS = {"minitron-4b": 0.01, "olmoe-1b-7b": 0.05, "mamba2-130m": 0.01}


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "olmoe-1b-7b"])
def test_expert_padded_trees_load(arch):
    """``repro``'s init_values at EP 16 pads granite-moe's 40 experts to 48 (and
    olmoe's 64 stay 64): the tree loads into a model padded alike, leaf for leaf, and
    into an unpadded one with the padding cut off; the padded experts are never
    routed, so both give the same logits. Smoke widths, the full expert counts."""
    from repro.models import build_model as jax_build_model

    jcfg = jax_get_config(arch, smoke=True)
    full_e = jax_get_config(arch).n_experts
    jcfg = jcfg.replace(n_experts=full_e)
    cfg = get_config(arch, smoke=True).replace(n_experts=full_e, dtype="float32")
    tree = jax_build_model(jcfg, ep_size=16).init_values(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, tree)
    padded = -(-full_e // 16) * 16
    assert tree["blocks"][0]["ffn"]["w_up"].shape[1] == padded
    ours = Model.from_numpy(cfg, tree, "cpu", ep_size=16)
    assert ours.blocks[0].ffn.w_up.shape[0] == padded
    back = ours.to_numpy()
    for leaf, ref in zip(_tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(leaf, ref)
    cut = Model.from_numpy(cfg, tree, "cpu")
    assert cut.blocks[0].ffn.w_up.shape[0] == full_e
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    _, a = ours.prefill(tokens)
    _, b = cut.prefill(tokens)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
