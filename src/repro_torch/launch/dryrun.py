"""Dry-run: count every (architecture x input-shape) cell on meta tensors and derive
its roofline terms; the JAX package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape train_4k \
        --multi-pod

Artifacts: artifacts/dryrun/<mesh>/<arch>__<shape>.json, with the reference's record
keys. The reference lowers and compiles each cell for a production mesh and reads XLA's
cost analysis; here the step runs once on ``device="meta"`` tensors under
``core.hlo_analysis.analyze``, which counts every pass of every loop, so one microbatch
is counted at full depth directly where the reference extrapolates unrolled 1x and 2x
probes, and scaled by the microbatch count (``_scale_cost``). The meta run takes the
kernels' plain versions (``x.is_cuda`` is false), the functions the reference lowers:
on the card prefill runs K2 instead, which moves fewer bytes and holds less memory, so
there the counted bytes and peak are upper bounds.

Meshes: ``h100-1`` (one chip, no mesh: the MoE takes its gather path, the default),
``pod16x16`` (``--mesh pod16x16``: 256 chips, ``data`` x ``model``) and ``pod2x16x16``
(``--multi-pod``: 512 chips with ``pod``), the reference's production meshes. A mesh's
step runs sharded (``Model.shard``, DTensors) in a ``launch.mesh.fake_world`` of that
many ranks and is counted per device, its c10d collectives by kind; the pod meshes'
roofline is the reference's v5e cost model applied to the port's count (analytic, not a
measurement). ``--moe-impl ep`` (the default off decode on a mesh, as in the
reference) needs a mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    get_config,
    input_specs,
    model_flops,
    shape_applicable,
)
from repro_torch.core.catalog import get_shape
from repro_torch.core.cost_model import V5E, roofline
from repro_torch.core.hlo_analysis import CollectiveStats, analyze
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.steps import StepBuilder, batch_sharding, place_tree
from repro_torch.optim import AdamWConfig, adamw

MESH = "h100-1"
MESHES = {"h100-1": None, "pod16x16": False, "pod2x16x16": True}  # name -> multi_pod

# --- optimization knobs (all default-off) ---------------------------------------
# decode_tp_params : serve params TP-only (drop the FSDP 'embed'->data rule for
#                    decode, killing the per-step weight all-gather)
# causal_skip      : block-causal training attention — q-chunk bucket b reads only
#                    kv[0:(b+1)S/nb] (halves the attention's flops and bytes)
# bf16_loss        : bf16 softmax-xent with f32 reductions (no f32 logits)
# moe_dense        : force the gather MoE (vs EP) on a mesh
KNOWN_OPTS = ("decode_tp_params", "causal_skip", "bf16_loss", "moe_dense")


def tune_cfg(cfg, shape=None, moe_impl: str | None = None, opts: tuple = ()):
    """Per-cell config adjustments (the dry-run knobs the perf loop turns). The MoE
    takes ``moe_impl``, by default "ep" off decode and "dense" (the gather path) in
    decode, as the reference's; without a mesh every impl is the gather path."""
    kw = {}
    if cfg.moe and shape is not None:
        kw["moe_impl"] = moe_impl or ("ep" if shape.kind != "decode" else "dense")
        if "moe_dense" in opts:
            kw["moe_impl"] = "dense"
    if "causal_skip" in opts:
        kw["causal_block_skip"] = True
    if "bf16_loss" in opts:
        kw["softmax_dtype"] = "bfloat16"
    if kw:
        cfg = cfg.replace(**kw)
    return cfg


def rule_overrides_for(shape, opts: tuple = ()):
    if "decode_tp_params" in opts and shape.kind == "decode":
        return {"embed": None}  # TP-only serving params; no FSDP gather
    return None


def lower_cell(
    arch: str,
    shape,
    mesh=None,
    *,
    n_microbatches: int = 8,
    moe_impl: str | None = None,
    cfg_override: dict | None = None,
    grad_only: bool = False,
    cfg_base=None,
    opts: tuple = (),
):
    """The cell's step as ``(fn, args, aux)``: ``analyze(fn, *args)`` counts it. ``shape``
    is a name in SHAPES or a ShapeSpec; ``mesh`` a DeviceMesh (in a ``fake_world``) or
    None for one chip. train: the full step (``n_microbatches`` microbatches, then
    AdamW) on (params, opt_state, batch), or with ``grad_only`` the loss and gradients
    of one pass on (params, batch); prefill: a serving model's prefill on (params,
    batch); decode: a serving model's decode step on (params, cache, tokens, pos), the
    cache from ``init_cache`` and pos its last entry. Every tensor is on the meta
    device, placed by the step's shardings (``jit_*``) on a mesh before the count."""
    cfg = cfg_base or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = tune_cfg(cfg, shape, moe_impl, opts)
    if cfg_override:
        cfg = cfg.replace(**cfg_override)
    if cfg.encdec and shape.kind == "prefill" and shape.seq_len > cfg.enc_memory_len:
        # the reference's prefill returns a cross cache of the whole source; the port's
        # holds enc_memory_len entries, so it is sized to the source here
        cfg = cfg.replace(enc_memory_len=shape.seq_len)
    if n_microbatches > 1 and shape.kind == "train" and grad_only:
        raise ValueError("probes must use n_microbatches=1")
    rules = make_rules(mesh, rule_overrides_for(shape, opts)) if mesh is not None else None
    specs = input_specs(cfg, shape)
    specs = place_tree(specs, batch_sharding(rules, specs))
    aux = {"cfg": cfg, "shape": shape, "rules": rules}

    if shape.kind == "train":
        sb = StepBuilder(cfg, n_microbatches, device="meta", rules=rules)
        if grad_only:
            return sb.jit_grad_step(), (sb.params, specs), aux
        return sb.jit_train_step(), (sb.params, sb.opt_state, specs), aux

    sb = StepBuilder(cfg, device="meta", rules=rules, trainable=False)
    if shape.kind == "prefill":
        return sb.jit_prefill(shape), (sb.params, specs), aux
    cache = sb.model.init_cache(shape.global_batch, shape.seq_len)
    return sb.jit_decode_step(), (sb.params, cache, specs["tokens"], specs["pos"]), aux


# ---------------------------------------------------------------------------
# Compositional cost probes.
#
# The reference's XLA:CPU cost analysis counts a loop body once, so its probes lower
# unrolled graphs at 1x and 2x the block period and extrapolate. The port's count is
# per pass: one microbatch is counted at full depth directly, scaled by the
# microbatch count, and the optimizer is counted once a step. Scaling and adding move
# FLOPs, bytes and collectives; the memory fields stay the first cost's.
# ---------------------------------------------------------------------------


def _scale_cost(c, s: float):
    return dataclasses.replace(
        c,
        flops=c.flops * s,
        bytes_accessed=c.bytes_accessed * s,
        collective_bytes=c.collective_bytes * s,
        collectives=CollectiveStats(
            {k: v * s for k, v in c.collectives.bytes_by_kind.items()},
            {k: v * s for k, v in c.collectives.count_by_kind.items()},
        ),
    )


def _add_cost(a, b):
    by = dict(a.collectives.bytes_by_kind)
    count = dict(a.collectives.count_by_kind)
    for k, v in b.collectives.bytes_by_kind.items():
        by[k] = by.get(k, 0) + v
        count[k] = count.get(k, 0) + b.collectives.count_by_kind[k]
    return dataclasses.replace(
        a,
        flops=a.flops + b.flops,
        bytes_accessed=a.bytes_accessed + b.bytes_accessed,
        collective_bytes=a.collective_bytes + b.collective_bytes,
        collectives=CollectiveStats(by, count),
    )


def _chips(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def probe_cost(
    arch: str,
    shape,
    mesh=None,
    *,
    n_microbatches: int = 8,
    moe_impl: str | None = None,
    cfg_base=None,
    verbose: bool = False,
    opts: tuple = (),
):
    """The cell's cost per step: one microbatch's loss and gradients at full depth,
    times the microbatch count, plus the optimizer once (train); one prefill or decode
    step (the rest). Its memory fields are the probe's own (one microbatch, no
    optimizer state); ``run_cell`` takes the full step's."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    is_train = shape.kind == "train"
    mb = n_microbatches if is_train else 1
    probe_shape = shape
    if is_train and mb > 1:
        if shape.global_batch % mb:
            raise ValueError(f"a batch of {shape.global_batch} does not split into {mb}")
        probe_shape = ShapeSpec(shape.name, shape.kind, shape.seq_len, shape.global_batch // mb)
    t0 = time.time()
    fn, args, aux = lower_cell(
        arch,
        probe_shape,
        mesh,
        n_microbatches=1,
        moe_impl=moe_impl,
        grad_only=is_train,
        cfg_base=cfg_base,
        opts=opts,
    )
    total = _scale_cost(analyze(fn, *args, n_devices=_chips(mesh)), float(mb))
    if verbose:
        print(f"[probe] {arch} {shape.name} one pass: {time.time() - t0:.1f}s")
    if is_train:  # the optimizer on full-size params, once per step
        sb = StepBuilder(aux["cfg"], device="meta", rules=aux["rules"])
        total = _add_cost(total, _optimizer_probe(sb, _chips(mesh)))
    return total


def _optimizer_probe(sb: StepBuilder, chips: int = 1):
    """AdamW's update on (grads, state, params) of the builder's model, counted."""
    grads = {n: torch.empty_like(p) for n, p in sb.params.items()}
    oc = AdamWConfig(lr=1e-4)
    fn = lambda g, s, p: adamw.update(oc, g, s, p)
    return analyze(fn, grads, sb.opt_state, sb.params, n_devices=chips)


def memory_cost(
    arch: str,
    shape,
    mesh=None,
    *,
    n_microbatches: int = 8,
    moe_impl: str | None = None,
    cfg_base=None,
    opts: tuple = (),
):
    """The full step's memory picture (the reference takes it from its production
    executable), counted on a step of at most two microbatches of the cell's microbatch
    size: every microbatch after the first holds what the second holds (the gradients
    summed so far and its own activations), so a step of n >= 2 microbatches peaks as
    one of two does, apart from the batch itself, whose bytes (per device) are put
    right. Returns that step's CompiledCost with its memory fields adjusted, and
    lower_cell's aux."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mb = n_microbatches if shape.kind == "train" else 1
    counted = min(mb, 2)
    small = ShapeSpec(shape.name, shape.kind, shape.seq_len, shape.global_batch // mb * counted)
    fn, args, aux = lower_cell(
        arch,
        small,
        mesh,
        n_microbatches=counted,
        moe_impl=moe_impl,
        cfg_base=cfg_base,
        opts=opts,
    )
    cost = analyze(fn, *args, n_devices=_chips(mesh))
    rules = aux["rules"]
    extra = _batch_bytes(aux["cfg"], shape, rules) - _batch_bytes(aux["cfg"], small, rules)
    cost.argument_bytes_per_device += extra
    cost.peak_memory_per_device += extra
    return cost, aux


def _batch_bytes(cfg, shape, rules=None) -> int:
    """The batch's bytes on one device (its shards on a mesh)."""
    specs = input_specs(cfg, shape)
    placed = place_tree(specs, batch_sharding(rules, specs))
    local = [getattr(t, "_local_tensor", t) for t in placed.values() if torch.is_tensor(t)]
    return sum(t.numel() * t.element_size() for t in local)


def run_cell(
    arch: str,
    shape_name: str,
    *,
    mesh_name: str = MESH,
    multi_pod: bool = False,
    n_microbatches: int = 8,
    moe_impl: str | None = None,
    out_dir: str = "artifacts/dryrun",
    verbose: bool = True,
    probes: bool = True,
    opts: tuple = (),
) -> dict:
    """Count one cell and write its record: the cost from ``probe_cost`` (train;
    prefill and decode are one step, counted whole), the memory from the full step
    (``memory_cost``); the record's ``lower_s`` and ``compile_s`` are the seconds of
    those two counts. ``mesh_name`` is h100-1 (one chip, its hardware H100) or
    pod16x16, and ``multi_pod`` makes it pod2x16x16 (the reference's meshes, their
    roofline v5e's). Without ``probes`` the memory count stands for the cost (the
    reference's compile-only proof). Nothing is caught: a cell that cannot be counted
    raises."""
    if multi_pod:
        mesh_name = "pod2x16x16"
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        rec.update(status="skip", reason=why)
        _save(rec, out_dir, mesh_name, arch, shape_name)
        return rec

    pod = MESHES[mesh_name]
    if pod is None:
        if moe_impl == "ep":
            raise ValueError("expert parallelism needs a mesh: pick --mesh pod16x16 or --multi-pod")
        hw, chips = get_shape(MESH).hw, 1
        world = contextlib.nullcontext()
    else:
        hw, chips = V5E, 512 if pod else 256
        world = fake_world(chips)
    kw = dict(n_microbatches=n_microbatches, moe_impl=moe_impl, opts=opts)
    with world:
        mesh = None if pod is None else make_production_mesh(multi_pod=pod, device_type="cpu")
        t0 = time.time()
        sched, aux = memory_cost(arch, shape, mesh, **kw)
        t_memory = time.time() - t0
        if shape.kind == "train" and probes:
            cost = probe_cost(arch, shape, mesh, **kw)
        else:  # one step, already counted whole (or the compile-only proof)
            cost = sched
        t_cost = time.time() - t0 - t_memory
    cost.peak_memory_per_device = sched.peak_memory_per_device
    cost.argument_bytes_per_device = sched.argument_bytes_per_device
    cost.temp_bytes_per_device = sched.temp_bytes_per_device
    cost.output_bytes_per_device = sched.output_bytes_per_device
    terms = roofline(cost.flops, cost.bytes_accessed, cost.collective_bytes, chips, hw)
    mflops = model_flops(aux["cfg"], shape)
    rec.update(
        status="ok",
        chips=chips,
        lower_s=round(t_memory, 1),
        compile_s=round(t_cost, 1),
        flops=cost.flops,
        bytes_accessed=cost.bytes_accessed,
        collective_bytes=cost.collective_bytes,
        collective_bytes_by_kind=cost.collectives.bytes_by_kind,
        collective_count_by_kind=cost.collectives.count_by_kind,
        peak_memory_per_device=cost.peak_memory_per_device,
        argument_bytes_per_device=cost.argument_bytes_per_device,
        temp_bytes_per_device=cost.temp_bytes_per_device,
        t_compute=terms.t_compute,
        t_memory=terms.t_memory,
        t_collective=terms.t_collective,
        t_step=terms.t_step,
        dominant=terms.dominant,
        model_flops=mflops,
        useful_flops_ratio=(mflops / cost.flops) if cost.flops else None,
        roofline_fraction=(mflops / (terms.t_step * chips * hw.peak_flops))
        if terms.t_step > 0
        else None,
        n_microbatches=n_microbatches,
        opts=list(opts),
    )
    _save(rec, out_dir, mesh_name, arch, shape_name)
    if verbose:
        print(
            f"[dryrun] {arch} x {shape_name} x {mesh_name}: t_step={terms.t_step * 1e3:.2f}ms "
            f"dom={terms.dominant} mem/dev={cost.peak_memory_per_device / 2**30:.2f}GiB "
            f"useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)} "
            f"(memory {t_memory:.1f}s cost {t_cost:.1f}s)"
        )
    return rec


def _save(rec: dict, out_dir: str, mesh_name: str, arch: str, shape_name: str):
    d = os.path.join(out_dir, mesh_name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{arch}__{shape_name}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=float)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=[MESH, "pod16x16"], default=MESH)
    ap.add_argument("--multi-pod", action="store_true", help="pod2x16x16 (512 chips)")
    ap.add_argument("--both-meshes", action="store_true", help="pod16x16 and pod2x16x16")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--moe-impl", choices=["ep", "dense", "gather"])
    ap.add_argument(
        "--no-probes",
        action="store_true",
        help="the full step's count only (no per-microbatch cost probe)",
    )
    ap.add_argument(
        "--opt",
        action="append",
        default=[],
        choices=list(KNOWN_OPTS),
        help="perf knobs (repeatable); results tagged in the artifact",
    )
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("pick --arch and/or --shape, or --all")
    if args.both_meshes:
        meshes = ["pod16x16", "pod2x16x16"]
    else:
        meshes = ["pod2x16x16" if args.multi_pod else args.mesh]
    if args.moe_impl == "ep" and MESH in meshes:
        ap.error(f"--moe-impl ep needs a mesh; {MESH} has none (--mesh pod16x16, --multi-pod)")

    cells = [
        (a, s)
        for a in ([args.arch] if args.arch else ARCH_IDS)
        for s in ([args.shape] if args.shape else list(SHAPES))
    ]
    recs = [
        run_cell(
            arch,
            shape,
            mesh_name=mesh,
            n_microbatches=args.microbatches,
            moe_impl=args.moe_impl,
            out_dir=args.out,
            probes=not args.no_probes,
            opts=tuple(args.opt),
        )
        for mesh in meshes
        for arch, shape in cells
    ]
    n_ok = sum(r["status"] == "ok" for r in recs)
    print(f"[dryrun] done: {n_ok} ok, {len(recs) - n_ok} skipped")
    return recs


if __name__ == "__main__":
    main()
