"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card: nvidia-smi's name and power limit, torch's device name and count;
2. build: the similarity kernel from ``csrc/similarity.cu`` with nvcc (ptxas report);
3. kernel against its plain version on the card: tests/test_kernels.py's sweep
   (float32 and bfloat16, both kinds) and the main path's shapes;
4. timing with CUDA events at the main path's shapes: kernel, plain version,
   ``torch.matmul`` (library yardstick for the product alone) and the bound;
5. the main path: ContainerStress.run_measured over the "paper" grid and the
   full-width Fig. 8 cell (1024 signals, 8192 memory vectors, 65,536 observations),
   response surface, recommendation over the h100 shapes, SPRT on the full-width
   residuals, the full-width cell split by step, and the launch counts;
6. one JSON line describing each kernel;
7. last line: ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Needs one CUDA card.
"""

import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 bandwidth.
# The kernel computes in IEEE float32 FMA, so its bound is the float32 rate.
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
EPS32 = float(np.finfo(np.float32).eps)
SWEEP = [(64, 32, 16), (256, 256, 256), (130, 70, 33), (8, 8, 4), (512, 128, 1024)]
# Kernel and plain version get the same (bf16-rounded) values and both compute in
# float32, so bfloat16 inputs are held at the float32 bar.
TOL = 5e-6
KINDS = ("inverse_distance", "gaussian")
TRAIN_SHAPE = (8192, 8192, 1024)  # G = sim(D, D): m x m over n signals
SURVEIL_SHAPE = (8192, 65536, 1024)  # K = sim(D, X): m x b over n signals
SMALL_SEED = 0  # small agreement input; its 32 memory vectors are all distinct


class SmokeFailure(RuntimeError):
    pass


def expect(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def compare(out, ref, atol, rtol):
    """max |out - ref| and whether |out - ref| <= atol + rtol |ref| everywhere."""
    diff = (out - ref).abs()
    return float(diff.max()), bool((diff <= atol + rtol * ref.abs()).all())


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(m, b, n, elem_bytes=4):
    """Least time for sim(x (m,n), y (b,n)): 2mbn float32 operations, or each input read
    once and the f32 output written once, whichever is longer."""
    t_ops = 2.0 * m * b * n / F32_FLOPS
    t_bytes = (elem_bytes * (m + b) * n + 4.0 * m * b) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def numpy_telemetry(seed, p):
    """TPSS telemetry from numpy draws: the same numbers on every machine and torch version."""
    from repro_torch.tpss import TPSSDraws, synthesize_from_draws

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    nh, ns = p.n_harmonics, p.n_signals
    draws = TPSSDraws(
        eps_own=t(rng.standard_normal((p.n_obs, ns))),
        eps_lat=t(rng.standard_normal((p.n_obs, p.cross_rank))),
        mix=t(rng.standard_normal((p.cross_rank, ns))),
        freqs=t(rng.uniform(2 * np.pi / p.n_obs * 2, 2 * np.pi / 64, (nh, ns))),
        phase=t(rng.uniform(0, 2 * np.pi, (nh, ns))),
        mean=t(rng.standard_normal(ns)),
        std=t(rng.standard_normal(ns)),
    )
    return synthesize_from_draws(draws, p)


def main():
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke run needs a CUDA card")

    from repro_torch._device import f32_matmul_highest
    from repro_torch.core import CATALOG, H100, CellResult, Constraint, ContainerStress
    from repro_torch.core import RooflineTerms, recommend
    from repro_torch.kernels import _build, similarity_cuda, similarity_ref
    from repro_torch.launch.scope import (
        FULL_WIDTH_CELL,
        cell_seed,
        mset_workload,
        run_mset,
        surveillance_split,
    )
    from repro_torch.mset import SPRTParams, empirical_false_alarm_rate, estimate, sprt, train
    from repro_torch.mset.mset2 import _bandwidth
    from repro_torch.tpss import TPSSParams, synthesize

    sim_module = importlib.import_module("repro_torch.kernels.similarity.similarity")
    f32_matmul_highest()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # ---------------------------------------------------------------- 1. card
    card = card_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print("== 1. card")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}: {kind} x {count}")

    # --------------------------------------------------------------- 2. build
    print("== 2. build")
    built = _build.build(sim_module.SOURCE)
    print(f"similarity: {built.library.name}, nvcc {built.seconds:.2f} s (cached={built.cached})")
    print(built.log.strip())

    # ------------------------------------------------- 3. kernel vs plain version
    print("== 3. kernel against its plain version on the card")
    g = torch.Generator(device=dev).manual_seed(0)
    for m, b, n in SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(m, n, generator=g, device=dev).to(dtype)
            y = torch.randn(b, n, generator=g, device=dev).to(dtype)
            # the median distance of the inputs keeps both kinds well away from 0
            gamma = float(_bandwidth(x.float()))
            for kind_ in KINDS:
                out, ref = similarity_cuda(x, y, gamma, kind_), similarity_ref(x, y, gamma, kind_)
                err, ok = compare(out, ref, TOL, TOL)
                print(
                    f"  sweep {m}x{b}x{n} {str(dtype)[6:]:8s} {kind_:16s} gamma {gamma:7.3f} "
                    f"min {float(ref.min()):.3f} max_abs_err {err:.3e} (bar {TOL:g})"
                )
                expect(float(ref.min()) > 0.01, f"sweep values near 0 at {m}x{b}x{n} {kind_}")
                expect(ok, f"kernel disagrees at {m}x{b}x{n} {dtype} {kind_}: {err}")
    torch.cuda.synchronize()

    m, b, n = SURVEIL_SHAPE
    D = torch.randn(m, n, generator=g, device=dev)
    X = torch.randn(b, n, generator=g, device=dev)
    gamma = float(_bandwidth(D))
    G, G_ref = similarity_cuda(D, D, gamma), similarity_ref(D, D, gamma)
    diag = torch.eye(m, dtype=torch.bool, device=dev)
    off_err = float((G - G_ref).abs().masked_fill(diag, 0).max())
    off_ok = bool(((G - G_ref).abs() <= 5e-6 + 5e-6 * G_ref.abs()).masked_fill(diag, True).all())
    diag_err = float((G.diagonal() - G_ref.diagonal()).abs().max())
    # d2 = |x|^2 + |x|^2 - 2 x.x cancels to ~0 on the diagonal with rounding of order
    # n * eps * max|x|^2 in either version; the square root amplifies it.
    diag_bound = float(torch.sqrt(4 * n * EPS32 * (D * D).sum(1).max())) / gamma
    print(
        f"  main path {m}x{m}x{n} f32 (G = sim(D, D)): off-diagonal max_abs_err {off_err:.3e} "
        f"(bar 5e-6), diagonal {diag_err:.3e} (cancellation bound {diag_bound:.3e})"
    )
    expect(off_ok and diag_err <= diag_bound, "kernel disagrees on sim(D, D)")
    del G, G_ref
    K, K_ref = similarity_cuda(D, X, gamma), similarity_ref(D, X, gamma)
    surv_err, ok = compare(K, K_ref, 5e-6, 5e-6)
    print(f"  main path {m}x{b}x{n} f32 (K = sim(D, X)): max_abs_err {surv_err:.3e} (bar 5e-6)")
    expect(ok, "kernel disagrees on sim(D, X)")
    del K, K_ref
    max_abs_err = max(off_err, surv_err)

    # --------------------------------------------------------------- 4. timing
    print(f"== 4. timing (CUDA events; {card})")
    timings = {}
    for label, (m, b, n), iters in (("train", TRAIN_SHAPE, 20), ("surveil", SURVEIL_SHAPE, 10)):
        x, y = D, (D if label == "train" else X)
        ms = cuda_ms(lambda: similarity_cuda(x, y, gamma), iters)
        plain_ms = cuda_ms(lambda: similarity_ref(x, y, gamma), iters)
        library_ms = cuda_ms(lambda: torch.matmul(x, y.T), iters)
        bound_ms, bound_by = bound(m, b, n)
        timings[label] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by
        )
        print(
            f"  {label} {m}x{b}x{n} f32: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"torch.matmul {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
            f"kernel at {bound_ms / ms:.1%} of bound"
        )
    del D, X

    # ----------------------------------------------------------- 5. main path
    print(f"== 5. main path on {card}")
    sim_module.launches = 0
    res, surf = run_mset("paper", reps=2, device=dev, verbose=False)
    torch.cuda.reset_peak_memory_stats()
    captured = {}

    def full_width(params):
        run = mset_workload(dev, split=surveillance_split)(params)

        def timed():
            captured["residuals"] = run()
            return captured["residuals"]

        return timed

    full = ContainerStress().run_measured(
        full_width, {k: [v] for k, v in FULL_WIDTH_CELL.items()}, reps=2
    )
    peak_bytes = torch.cuda.max_memory_allocated()
    expect(len(full.rows) == 1, "the full-width cell did not run")
    residuals = captured.pop("residuals")
    n_cal = residuals.shape[0] // 8
    mu, sigma = residuals[:n_cal].mean(0), residuals[:n_cal].std(0, correction=0)
    t0 = time.perf_counter()
    alarms, _, _ = sprt(residuals, sigma, SPRTParams(), mu=mu)
    torch.cuda.synchronize()
    sprt_s = time.perf_counter() - t0
    launches = sim_module.launches
    print(f"  similarity kernel launches during the main path: {launches}")
    expect(launches > 0, "the main path never launched the similarity kernel")

    for r in res.rows + full.rows:
        print(f"  {card} | {r.params} | {r.mean_s:.6f} s (std {r.std_s:.6f}, {r.reps} reps)")
    print(f"  response surface over the paper grid: r^2 = {surf.r2:.4f}")
    print(f"  full-width cell peak device memory: {peak_bytes / 2**30:.2f} GiB")
    cell = full.rows[0]
    shape = (FULL_WIDTH_CELL["n_observations"], FULL_WIDTH_CELL["n_signals"])
    expect(residuals.shape == shape, f"full-width residuals have shape {tuple(residuals.shape)}")
    expect(bool(torch.isfinite(residuals).all()), "full-width residuals are not finite")
    far = float(empirical_false_alarm_rate(alarms[n_cal:]))
    print(f"  SPRT over {tuple(residuals.shape)} residuals: {sprt_s:.3f} s, alarm rate {far:.2e}")
    expect(alarms.shape == residuals.shape and np.isfinite(far), "SPRT output malformed")

    # Recommendation: the full-width workload's observations arrive over a 60 s
    # window and must be trained on and surveilled within it; the stream splits
    # across the GPUs of a node, each holding the model. Only h100-1 is measured:
    # the other shapes are modelled as the measured time over the chip count.
    window_s = 60.0
    rows = [
        CellResult(
            params={"chips": s.chips},
            shape_name=s.name,
            terms=RooflineTerms(cell.mean_s / s.chips, 0.0, 0.0),
            analysis={"peak_memory_per_device": float(peak_bytes)},
        )
        for s in CATALOG
        if s.hw is H100
    ]
    rec = recommend(rows, Constraint(max_step_latency_s=window_s))
    chips = {s.name: s.chips for s in CATALOG}
    for name, t, price, ok in rec.ranking:
        how = "measured" if chips[name] == 1 else "modelled (linear in chips)"
        print(
            f"  {name:8s} t={t:.3f} s {how:26s} ${price:.2f}/hr  "
            f"{'feasible' if ok else 'infeasible'}"
        )
    expect(rec.shape is not None, f"no h100 shape meets the {window_s} s window")
    print(f"  recommendation: {rec.shape.name} ({rec.reason})")

    # Full-width cell split by step: the same cell's telemetry through MSET2's own
    # train and estimate, each step timed and ended by a synchronize.
    split = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[name] = split.get(name, 0.0) + time.perf_counter() - t0
        return out

    p = FULL_WIDTH_CELL
    n_tr, n_surv = surveillance_split(p)
    tpss = TPSSParams(n_signals=p["n_signals"], n_obs=n_tr + n_surv)
    Xall = synthesize(cell_seed(p), tpss, device=dev)
    model = train(Xall[:n_tr], n_memvec=p["n_memvec"], step=step)
    estimate(model, Xall[n_tr:], step=step)
    step("SPRT", lambda: sprt(residuals, sigma, SPRTParams(), mu=mu))
    repeats = p["n_memvec"] - len(torch.unique(model.D, dim=0))
    total = sum(split.values())
    print(f"  full-width cell: {repeats} of {p['n_memvec']} memory vectors repeat (ROADMAP, R3)")
    print(f"  full-width cell split ({card}):")
    for name, s in split.items():
        print(f"    {name:22s} {s:9.4f} s  {s / total:6.1%}")
    del Xall, model, residuals

    # Agreement with the plain version on a small input: the same telemetry through
    # MSET2 on the card (CUDA kernel) and on the CPU (plain version). The input's
    # memory vectors are all distinct; when they repeat, G is singular and Ginv is
    # decided by rounding in either version (ROADMAP, R3).
    Xsmall = numpy_telemetry(SMALL_SEED, TPSSParams(n_signals=4, n_obs=512))
    m_cpu = train(Xsmall[:384], n_memvec=32)
    expect(len(torch.unique(m_cpu.D, dim=0)) == 32, "small input repeats a memory vector")
    _, r_cpu = estimate(m_cpu, Xsmall[384:])
    _, r_gpu = estimate(train(Xsmall[:384].to(dev), n_memvec=32), Xsmall[384:].to(dev))
    small_err = float((r_gpu.cpu() - r_cpu).abs().max())
    small_tol = 1e-3 * float(Xsmall.abs().max())
    print(f"  small input, card vs CPU residuals: max_abs_err {small_err:.3e}, bar {small_tol:.3e}")
    expect(small_err <= small_tol, "MSET2 on the card disagrees with the CPU on a small input")

    # ------------------------------------------------------------ 6. kernels
    t = timings["surveil"]
    train_shape = "x = y {0}x{2}, float32 (G = sim(D, D))".format(*TRAIN_SHAPE)
    kernels = [
        {
            "name": "similarity",
            "route": "cuda",
            "source": "src/repro_torch/kernels/similarity/csrc/similarity.cu",
            "replaces": "src/repro/kernels/similarity/similarity.py:47",
            "launches": launches,
            "max_abs_err": max_abs_err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": "x {0}x{2}, y {1}x{2}, float32 (K = sim(D, X))".format(*SURVEIL_SHAPE),
            "train_shape": dict(timings["train"], shape=train_shape),
        }
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
