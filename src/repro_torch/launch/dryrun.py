"""One-chip dry-run: count every (architecture x input-shape) cell on meta tensors and
derive its roofline terms; the JAX package's ``launch/dryrun.py`` at one chip.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Artifacts: artifacts/dryrun/h100-1/<arch>__<shape>.json, with the reference's record
keys. The reference lowers and compiles each cell for a production mesh and reads XLA's
cost analysis; here the step runs once on ``device="meta"`` tensors under
``core.hlo_analysis.analyze``, which counts every pass of every loop, so a cell is
counted at full depth directly where the reference extrapolates unrolled 1x and 2x
probes. The meta run takes the kernels' plain versions (``x.is_cuda`` is false), the
functions the reference lowers: on the card prefill runs K2 instead, which moves fewer
bytes and holds less memory, so there the counted bytes and peak are upper bounds.

Meshes of more than one chip (``--multi-pod``, ``--both-meshes``, ``--no-probes`` and
``--moe-impl ep``, which the CLI refuses, and the sharding knob ``decode_tp_params``)
wait for the port's ``distributed/``. At one chip the MoE takes its gather path, the
only one the port has, so the reference's ``moe_impl`` choice has nothing to pick.
"""

from __future__ import annotations

import argparse
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
from repro_torch.core.cost_model import roofline
from repro_torch.core.hlo_analysis import analyze
from repro_torch.launch.steps import StepBuilder
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw

MESH = "h100-1"

# --- optimization knobs (all default-off) ---------------------------------------
# causal_skip : block-causal training attention — q-chunk bucket b reads only
#               kv[0:(b+1)S/nb] (halves the attention's flops and bytes)
# bf16_loss   : bf16 softmax-xent with f32 reductions (no f32 logits)
KNOWN_OPTS = ("causal_skip", "bf16_loss")


def tune_cfg(cfg, opts: tuple = ()):
    """Per-cell config adjustments (the dry-run knobs the perf loop turns)."""
    kw = {}
    if "causal_skip" in opts:
        kw["causal_block_skip"] = True
    if "bf16_loss" in opts:
        kw["softmax_dtype"] = "bfloat16"
    if kw:
        cfg = cfg.replace(**kw)
    return cfg


def _source(batch: dict) -> dict:
    return {k: batch[k] for k in ("frames", "src_tokens") if k in batch}


def lower_cell(
    arch: str,
    shape,
    *,
    n_microbatches: int = 8,
    cfg_override: dict | None = None,
    grad_only: bool = False,
    cfg_base=None,
    opts: tuple = (),
):
    """The cell's step as ``(fn, args, aux)``: ``analyze(fn, *args)`` counts it. ``shape``
    is a name in SHAPES or a ShapeSpec. train: the full step (``n_microbatches``
    microbatches, then AdamW) on (params, opt_state, batch), or with ``grad_only`` the
    loss and gradients of one pass on (params, batch); prefill: a serving model's
    prefill on (params, batch); decode: a serving model's decode step on (params, cache,
    tokens, pos), the cache from ``cache_abstract`` and pos its last entry. Every tensor
    is on the meta device."""
    cfg = cfg_base or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = tune_cfg(cfg, opts)
    if cfg_override:
        cfg = cfg.replace(**cfg_override)
    if cfg.encdec and shape.kind == "prefill" and shape.seq_len > cfg.enc_memory_len:
        # the reference's prefill returns a cross cache of the whole source; the port's
        # holds enc_memory_len entries, so it is sized to the source here
        cfg = cfg.replace(enc_memory_len=shape.seq_len)
    if n_microbatches > 1 and shape.kind == "train" and grad_only:
        raise ValueError("probes must use n_microbatches=1")
    specs = input_specs(cfg, shape)
    aux = {"cfg": cfg, "shape": shape}

    if shape.kind == "train":
        sb = StepBuilder(cfg, n_microbatches, device="meta")
        if grad_only:
            return sb.grad_step, (sb.params, specs), aux

        def train_step(params, opt_state, batch):
            return sb.train_step(batch)

        return train_step, (sb.params, sb.opt_state, specs), aux

    model = Model(cfg, "meta")
    params = dict(model.named_parameters())
    if shape.kind == "prefill":

        def prefill(params, batch):
            return model.prefill(batch["tokens"], **_source(batch))

        return prefill, (params, specs), aux

    cache = StepBuilder(cfg, device="meta").cache_abstract(shape)

    def decode(params, cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)

    return decode, (params, cache, specs["tokens"], specs["pos"]), aux


# ---------------------------------------------------------------------------
# Compositional cost probes.
#
# The reference's XLA:CPU cost analysis counts a loop body once, so its probes lower
# unrolled graphs at 1x and 2x the block period and extrapolate. The port's count is
# per pass: one microbatch is counted at full depth directly, scaled by the
# microbatch count, and the optimizer is counted once a step. At one chip there are
# no collectives, so scaling and adding move FLOPs and bytes only; the memory fields
# stay the first cost's.
# ---------------------------------------------------------------------------


def _scale_cost(c, s: float):
    return dataclasses.replace(c, flops=c.flops * s, bytes_accessed=c.bytes_accessed * s)


def _add_cost(a, b):
    return dataclasses.replace(
        a, flops=a.flops + b.flops, bytes_accessed=a.bytes_accessed + b.bytes_accessed
    )


def probe_cost(
    arch: str,
    shape,
    *,
    n_microbatches: int = 8,
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
        n_microbatches=1,
        grad_only=is_train,
        cfg_base=cfg_base,
        opts=opts,
    )
    total = _scale_cost(analyze(fn, *args), float(mb))
    if verbose:
        print(f"[probe] {arch} {shape.name} one pass: {time.time() - t0:.1f}s")
    if is_train:  # the optimizer on full-size params, once per step
        total = _add_cost(total, _optimizer_probe(StepBuilder(aux["cfg"], device="meta")))
    return total


def _optimizer_probe(sb: StepBuilder):
    """AdamW's update on (grads, state, params) of the builder's model, counted."""
    grads = {n: torch.empty_like(p) for n, p in sb.params.items()}
    oc = AdamWConfig(lr=1e-4)
    return analyze(lambda g, s, p: adamw.update(oc, g, s, p), grads, sb.opt_state, sb.params)


def memory_cost(
    arch: str,
    shape,
    *,
    n_microbatches: int = 8,
    cfg_base=None,
    opts: tuple = (),
):
    """The full step's memory picture (the reference takes it from its production
    executable), counted on a step of at most two microbatches of the cell's microbatch
    size: every microbatch after the first holds what the second holds (the gradients
    summed so far and its own activations), so a step of n >= 2 microbatches peaks as
    one of two does, apart from the batch itself, whose bytes are put right. Returns
    that step's CompiledCost with its memory fields adjusted, and lower_cell's aux."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mb = n_microbatches if shape.kind == "train" else 1
    counted = min(mb, 2)
    small = ShapeSpec(shape.name, shape.kind, shape.seq_len, shape.global_batch // mb * counted)
    fn, args, aux = lower_cell(arch, small, n_microbatches=counted, cfg_base=cfg_base, opts=opts)
    cost = analyze(fn, *args)
    extra = _batch_bytes(aux["cfg"], shape) - _batch_bytes(aux["cfg"], small)
    cost.argument_bytes_per_device += extra
    cost.peak_memory_per_device += extra
    return cost, aux


def _batch_bytes(cfg, shape) -> int:
    specs = input_specs(cfg, shape)
    return sum(t.numel() * t.element_size() for t in specs.values() if torch.is_tensor(t))


def run_cell(
    arch: str,
    shape_name: str,
    *,
    n_microbatches: int = 8,
    out_dir: str = "artifacts/dryrun",
    verbose: bool = True,
    opts: tuple = (),
) -> dict:
    """Count one cell at one chip on ``h100-1``'s hardware and write its record: the
    cost from ``probe_cost``, the memory from the full step (``memory_cost``); the
    record's ``lower_s`` and ``compile_s`` are the seconds of those two counts. Nothing
    is caught: a cell that cannot be counted raises."""
    hw = get_shape(MESH).hw
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": MESH}
    if not ok:
        rec.update(status="skip", reason=why)
        _save(rec, out_dir, arch, shape_name)
        return rec

    t0 = time.time()
    sched, aux = memory_cost(arch, shape, n_microbatches=n_microbatches, opts=opts)
    t_memory = time.time() - t0
    if shape.kind == "train":
        cost = probe_cost(arch, shape, n_microbatches=n_microbatches, opts=opts)
    else:  # one step, already counted whole
        cost = sched
    t_cost = time.time() - t0 - t_memory
    cost.peak_memory_per_device = sched.peak_memory_per_device
    cost.argument_bytes_per_device = sched.argument_bytes_per_device
    cost.temp_bytes_per_device = sched.temp_bytes_per_device
    cost.output_bytes_per_device = sched.output_bytes_per_device
    chips = cost.n_devices
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
    _save(rec, out_dir, arch, shape_name)
    if verbose:
        print(
            f"[dryrun] {arch} x {shape_name} x {MESH}: t_step={terms.t_step * 1e3:.2f}ms "
            f"dom={terms.dominant} mem/dev={cost.peak_memory_per_device / 2**30:.2f}GiB "
            f"useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)} "
            f"(memory {t_memory:.1f}s cost {t_cost:.1f}s)"
        )
    return rec


def _save(rec: dict, out_dir: str, arch: str, shape_name: str):
    d = os.path.join(out_dir, MESH)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{arch}__{shape_name}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=float)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument(
        "--moe-impl",
        choices=["ep"],
        help="expert parallelism waits for distributed/; one chip takes the gather path",
    )
    ap.add_argument(
        "--opt",
        action="append",
        default=[],
        choices=list(KNOWN_OPTS),
        help="perf knobs (repeatable); results tagged in the artifact",
    )
    ap.add_argument("--out", default="artifacts/dryrun")
    for flag in ("--multi-pod", "--both-meshes", "--no-probes"):
        ap.add_argument(flag, action="store_true", help="waits for the port's distributed/")
    args = ap.parse_args(argv)
    waiting = [
        f for f in ("multi_pod", "both_meshes", "no_probes", "moe_impl") if getattr(args, f)
    ]
    if waiting:
        flag = "--" + waiting[0].replace("_", "-")
        ap.error(f"{flag} waits for the port's distributed/ (ROADMAP item 9): one chip so far")
    if not (args.all or args.arch or args.shape):
        ap.error("pick --arch and/or --shape, or --all")

    cells = [
        (a, s)
        for a in ([args.arch] if args.arch else ARCH_IDS)
        for s in ([args.shape] if args.shape else list(SHAPES))
    ]
    recs = [
        run_cell(
            arch,
            shape,
            n_microbatches=args.microbatches,
            out_dir=args.out,
            opts=tuple(args.opt),
        )
        for arch, shape in cells
    ]
    n_ok = sum(r["status"] == "ok" for r in recs)
    print(f"[dryrun] done: {n_ok} ok, {len(recs) - n_ok} skipped")
    return recs


if __name__ == "__main__":
    main()
