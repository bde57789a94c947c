"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in the order they run (numbered in the order they were added: 21 runs after 4,
14, 15, 16, 17 and 18 after 9, 19 and 20 after 12); any failure exits non-zero:

1. card: nvidia-smi's name and power limit, torch's device name and count;
2. build: the four kernels, ``kernels/similarity/csrc/similarity.cu``,
   ``kernels/gemm/csrc/gemm.cu`` (both with the shared ``kernels/csrc/hopper.cuh`` and
   ``tf32.cuh``), ``kernels/attention/csrc/flash.cu`` (with ``hopper.cuh``) and
   ``kernels/sprt/csrc/sprt.cu`` (its two passes), one nvcc each, started together;
   ptxas's registers and spills for each instance (none may spill);
3. the similarity kernel against its plain version on the card: tests/test_kernels.py's
   sweep plus ragged shapes (n of 1, 3 and 1000; m and b off multiples of 64), float32
   and bfloat16, both kinds, each also as sim(x, x); the MSET2 path's shapes on randn
   inputs; and the full-width cell's own operands (its memory matrix D against its
   standardized surveillance observations), where the kernel and the plain float32
   version are each held against a float64 product;
4. its timing with CUDA events at those shapes: kernel, the kernel on bfloat16 inputs
   (one TF32 product), plain version, ``torch.matmul`` (library yardstick for the
   product alone; under TF32 too, as context) and the bounds; and the device time of
   a call by kernel (split pre-pass, product) from torch.profiler;
21. K4 (W = Ginv K, ``kernels/gemm``) against float64 and cuBLAS float32 on the
   full-width cell's own Ginv (trained at the benchmark cells' reg 1e-2) and a batch's
   K, at ragged shapes and on random operands of a Fig. 8 batch, an A320 batch and a
   scope cell: its error at most twice cuBLAS's and never above 1e-2, one TF32
   product's above that bar, the same bits with Ginv's planes given; timed at those
   shapes beside cuBLAS float32 (the plain version) and its bound, with the device time
   of each of its kernels; then X_hat = W^T D (K4 too) on the cell's W at a Fig. 8
   batch, an A320 batch (75,000 random signals) and a scope cell, held to the same bar
   and timed alike with D^T's planes given;
5. the MSET2 path: ContainerStress.run_measured over the "paper" grid and the
   full-width Fig. 8 cell (1024 signals, 8192 memory vectors, 65,536 observations),
   response surface, recommendation over the h100 shapes, SPRT on the full-width
   residuals (the SPRT kernel), the launch counts; then the SPRT kernel against its
   plain version, bit for bit, on those residuals (at its own chunk length and as one
   chunk), at ragged sizes (n off multiples of 32, T = 1, no mean, a NaN residual), on
   tests/torch_sprt_cases.py's cases at forced chunk lengths (edges on T and on NaN
   residuals) and on a periodic input whose chunks never meet, with pass 2's re-run
   steps; timed at full width and on a narrow, long run (1,048,576 x 32), each beside
   the one-chunk path, the plain loop (full width) and the bound, with the device time
   of each pass (torch.profiler) and other chunk lengths; and the full-width cell split
   by step;
6. the flash-attention kernel against its plain version: tests/test_kernels.py's
   shapes plus ragged S (1, 65, 129 at every head dim), GQA, heads-major strides,
   large logits (q x 8) and a structured case (q = 0, V[j, d] = j + d / 1000) that
   shows a permuted P, float32 and bfloat16, causal or not;
7. flash attention at the serving shape (minitron-4b prefill, B 4, S 2048) and at
   prefill_32k's sequence (one layer) in bfloat16, and at the serving shape in float32:
   checked, then timed beside the plain version, ``scaled_dot_product_attention``
   (library yardstick) and the bound;
8. the LM serving path: ``generate("minitron-4b", smoke=False)`` at full width
   (32 layers, 4.19 B parameters, bf16) with 4 prompts of 2048 tokens and 32 new
   tokens, warm-up then timed, the kernel's launch count, and one prefill split
   by step;
9. correctness of that path: decode after prefill(x[:-1]) equals prefill(x) at full
   width in float32, and the smoke config's logits and greedy tokens on the card
   equal those on the CPU;
14. the MoE and SSM families: olmoe-1b-7b at full width (16 layers, 64 experts top 8,
    6.92 B parameters, bf16, not cut) served twice at phase 8's shape, K2 launched 16
    times a call and equal tokens from both calls, one prefill split by step beside its
    FLOP bound and the decode step beside its bytes bound, then decode against prefill
    in float32 at capacity 16; mamba2-130m at full width (24 SSD layers, not cut) served
    twice, its prefill split and the same float32 check; jamba-v0.1-52b at full width
    with its depth cut from 32 to 8 layers (one period of its block program, 13.3 B
    parameters: the 52 B model does not fit one card), served once with one K2 launch;
    and the four smoke configs' logits and greedy tokens on the card against the CPU;
    then one JSON line of it;
15. the enc-dec family: K2 against its plain version at the encoder's shape (B 4, 4096
    frames, 16/16 heads of 64, bf16, non-causal) and the decoder's (B 4, S 512, causal),
    each timed beside the plain version, SDPA and the bound; seamless-m4t-large-v2 at
    full width (24 encoder and 24 decoder layers, 1.63 B parameters, bf16, not cut)
    served twice with 4 prompts of 512 tokens over 4096 random frames and 32 new tokens,
    K2 launched 48 times a call (each encoder and decoder layer once; decode none) and
    equal tokens from both calls, one prefill split by step beside its FLOP bound, a
    decode step beside its bytes bound with its kernels and busy share (profiler); f32
    decode against prefill at full width; the smoke config card against CPU; then one
    JSON line of it;
16. training, which runs no kernel of its own (the reference trains through its plain
    attention, and K2 has no backward): every smoke arch's loss and gradients in float32
    on the card against the CPU (wq, wk and wv nonzero) and the full-width mamba2-130m's
    loss and gradient norm; mamba2-130m at full width, not cut, through
    ``launch.train.train`` (8 x 2048 tokens in 2 microbatches, 30 steps, a NaN loss at
    step 15 restored from step 10's checkpoint, the loss falling, a second job resuming
    at step 30), its warm step, tokens/s, AdamW step, peak memory and FLOP bound;
    minitron-4b at full width with its depth cut 32 -> 8 (2.23 B parameters), 6 steps of
    8 x 2048 tokens in 4 microbatches, split into forward + backward and AdamW, peak
    memory and bound; K2 launched 0 times in the phase; then one JSON line of it;
17. analytic scoping, each step counted on meta tensors on the host
    (``core.hlo_analysis.analyze``) and held against the card: the MSET service
    (``mset/service.py``'s ``_estimate_sharded``) through ``run_analytic`` at
    benchmarks/mset_service_roofline.py's three sizes, then on the card (K1 once a
    call, CUDA events, its peak beside the analytic one), no faster than 0.95 x its
    t_compute; every LM step phases 8, 14, 15 and 16 timed (prefill and the mean decode
    step of each served arch at its depth, the two training steps at their
    microbatches), probed by ``launch.dryrun.probe_cost`` and ``memory_cost``: each
    no faster than 0.95 x its t_compute, train and decode (where the card runs the
    probe's own ops, no K2) no faster than 0.95 x its t_step, and each training
    step's measured peak within 20 % of its analytic peak; then the dry-run over every
    (arch, shape) at one chip, each cell through ``launch.dryrun``'s CLI in one of
    SWEEP_WORKERS processes, with its wall time, t_step, dominant term, peak and
    whether ``recommend`` finds h100-1 feasible (minitron-4b's train_4k may not); then
    one JSON line of it;
18. sharding (``distributed/sharding.py``, DTensor): minitron-4b at full width served
    at phase 8's shape (8 greedy tokens) through ``Model.shard`` on a (1, 1) mesh of a
    process group of one, its tokens equal to the unsharded path's, its prefill logits
    within 4 bf16 ulps, K2 launched on the local shards, its prefill and decode step
    timed beside the unsharded; ``make_service`` on that mesh at the full-width service
    size (K1 on local shards: K against ``similarity_ref`` at 5e-6, Xhat and residuals
    against the unsharded service at phase 17's bar), timed beside it; then, on meta
    tensors in a fake world of 256 ranks, the dry-run's minitron-4b, olmoe-1b-7b (expert
    parallel) and mamba2-130m train_4k cells on pod16x16 and ``run_lm("minitron-4b",
    "train_4k")`` over v5e-64 ... 2x-v5e-256 with its recommendation; then one JSON
    line of it;
10. the fleet simulator's compiled backend (``backend="torch"``, its bin loop a CUDA
    graph) against the numpy engine: window-sum order; the golden scenarios of
    tests/test_jax_backend.py at its bar and the substep grid bit for bit; every policy
    kernel step by step; a graph replayed on another slate of its signature; the
    tuning round at 24 and 512 candidates x 12 seeds x 720 bins, cold (the eager
    loop), capture (the second dispatch) and warm (replays) beside numpy, with its
    peak memory and fixed rows against numpy; kernels a bin from torch.profiler; the
    substep cell and the fidelity case bit for bit, cold, capture, warm and numpy; then
    one JSON line of its numbers;
11. the paper's scoping example, ``examples/torch_scope_containers.py``'s ``main()``:
    measured scoping over its grid, the surface's r^2, and both customers' rankings
    over the v5e and h100 shapes; then one JSON line of it;
12. the autonomous loop at full width (benchmarks/closed_loop.py --full's world, built
    from the port): the incumbent tune on the card against numpy, bit for bit; the
    closed-loop controller on a x2 service drift, its probe and re-tunes on the card,
    with the same events, estimate and swap as on numpy with the probe on the CPU
    (the similarity and SPRT kernels' counts read around it); the probe's verdicts on
    the card against the CPU's on every segment, K1 at the probe's shapes against its
    plain version and K3 bit for bit on its residuals; the scoping oracle's column
    build on the card over benchmarks/oracle.py --full's grid against a numpy per-cell
    build of one column, its query latency and its verify_oracle bound; then one JSON
    line of it, with the dispatches by path;
19. several processes under torchrun (``python -m torch.distributed.run``): the server
    through ``-m repro_torch.launch.serve`` as a world of one on the card at phase 8's
    shape, alone on the card and its host, its tokens equal to phase 8's, its prefill
    seconds and tokens/s; then, beside phase 20, the elastic chain of mamba2-130m at full
    width in float32, 4 x 128 tokens: a gloo world of four on the host runs the job to its
    end, the card as a world of one resumes a copy of its step-2 checkpoint, a gloo world
    of two resumes a copy of the card's step-4 checkpoint, each resumed loss within 1e-5
    relative of the world of four's; each part's wall time; then one JSON line of it.
    NCCL refuses two ranks on one card, so no world of several ranks runs on the card;
20. every ``examples/torch_*.py`` as its own process on the card (this script's
    ``--example`` mode), three at a time beside the chain, each exiting 0 with what its
    ``main()`` returned and its kernels' launches printed, the quickstart's drift alarm
    gated; then one JSON line of it. Their wall times are shared ones;
13. one JSON line describing each kernel (with phase 20's launches);
then the last line: ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Needs one CUDA card.
"""

import glob
import importlib
import importlib.util
import json
import re
from concurrent.futures import ThreadPoolExecutor
from functools import partial
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# NVIDIA H100 SXM data sheet: TF32 and bf16 dense tensor cores, HBM3 bandwidth. The
# similarity kernel runs on the TF32 tensor cores, so its bound is the function's own
# work at the TF32 rate (its three products do 3x, printed beside it); flash
# attention's inputs are bf16 on the serving path, so its bound is the bf16 rate (the
# function's own work: the kernel's hi + lo split of P does 1.5x).
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # float32 FMA outside the tensor cores: flash attention's float32 path
HBM_BYTES_PER_S = 3.35e12
EPS32 = float(np.finfo(np.float32).eps)
SWEEP = [(64, 32, 16), (256, 256, 256), (130, 70, 33), (8, 8, 4), (512, 128, 1024)]
# n of 1, 3 and 1000 (off the kernel's 32-float K tile), m and b off multiples of 64
RAGGED = [(1, 1, 1), (97, 65, 3), (200, 333, 1000), (129, 191, 1), (300, 257, 3)]
# Kernel and plain version get the same (bf16-rounded) values and both compute in
# float32, so bfloat16 inputs are held at the float32 bar.
TOL = 5e-6
KINDS = ("inverse_distance", "gaussian")
TRAIN_SHAPE = (8192, 8192, 1024)  # G = sim(D, D): m x m over n signals
SURVEIL_SHAPE = (8192, 65536, 1024)  # K = sim(D, X): m x b over n signals
# W = Ginv K (K4): (m, k, n) = (m, m, b) at a Fig. 8 batch, an A320 batch and a scope cell
GEMM_SHAPES = {
    "fig8 batch": (8192, 8192, 8192),
    "a320 batch": (8192, 8192, 1024),
    "scope cell": (8192, 8192, 65536),
}
# X_hat = W^T D (K4 too): (b, m, n) observations, memory vectors and signals at the same three
WT_D_SHAPES = {
    "fig8 batch": (8192, 8192, 1024),
    "a320 batch": (1024, 8192, 75000),
    "scope cell": (65536, 8192, 1024),
}
# ragged (m, k, n): off the 128-row tile and the 32-deep K tile
GEMM_RAGGED = [(1, 1, 1), (33, 1001, 127), (129, 4103, 1000), (1000, 31, 33)]
GEMM_FACTOR = 2.0  # K4's error against float64 may be this many times cuBLAS f32's
# ... and never above this, in norm relative to the float64 product's: far below 1 (all
# zeros) and below one TF32 product's error, so that neither a kernel that writes nothing
# nor one that keeps only hi.hi passes where cuBLAS itself is far from float64
GEMM_CAP = 1e-2
# phase 21's Ginv is the full-width cell's at the benchmark cells' reg. At the default 1e-6
# W = Ginv K is so ill-conditioned that cuBLAS f32 is 0.61 from float64 and no bar tells a
# product from zeros; at 1e-2 cuBLAS f32 is 3.9e-3 from it and one TF32 product 0.81.
GEMM_REG = 1e-2
SMALL_SEED = 0  # small agreement input; its 32 memory vectors are all distinct
# flash attention (B, S, H, K, hd): tests/test_kernels.py's shapes, ragged S, small
# head dims, GQA (minitron-4b's 24/8 and granite-20b's 48/1), and S = 1, 65 and 129
# (one row; one key past a tile; one past two) at every head dim
FLASH_SWEEP = [
    (2, 128, 2, 2, 64),
    (1, 256, 4, 4, 32),
    (2, 200, 2, 2, 64),
    (1, 64, 1, 1, 128),
    (1, 16, 2, 2, 16),
    (1, 17, 2, 2, 32),
    (2, 100, 2, 2, 64),
    (1, 160, 2, 2, 16),
    (1, 100, 8, 2, 32),
    (1, 160, 24, 8, 128),
    (1, 100, 48, 1, 128),
] + [(2, S, 4, 2, hd) for S in (1, 65, 129) for hd in (16, 32, 64, 128)]
# cases beyond random (B, S, H, K, hd) inputs: heads-major views, q x 8 (large logits,
# which exercise the rescaling by exp(m_old - m_new)), and the structured case
FLASH_CASES = (
    [((2, 200, 8, 2, 64), "heads-major")]
    + [((2, 200, 8, 2, 128), "q x8"), ((1, 130, 4, 4, 32), "q x8")]
    + [((1, 200, 4, 2, hd), "structured") for hd in (16, 32, 64, 128)]
)
SERVE_SHAPE = (4, 2048, 24, 8, 128)  # minitron-4b prefill of 4 x 2048 tokens
LONG_SHAPE = (1, 32768, 24, 8, 128)  # prefill_32k's sequence (configs/base.py), one layer
LONG_TAIL = 1024  # query rows of the long shape checked against the plain version
SERVE_ARCH = "minitron-4b"
SERVE = dict(batch=4, prompt_len=2048, gen_tokens=32)
# Phase 15: enc_memory_len (4096) frames of source and a prompt of 4096 // 8 decoder
# tokens (configs/base.py's dec_len_fraction): a long source and a short target, as in
# speech-to-text.
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_SERVE = dict(batch=4, prompt_len=512, gen_tokens=32)
# Phase 16, training. (b) mamba2-130m at full width, not cut: examples/train_lm.py's job
# (2 microbatches, peak lr 6e-4) at a global batch of 8 x 2048 tokens for 30 steps with
# 10 of warm-up, a checkpoint every 10 steps and a NaN loss injected at step 15, then a
# second job that resumes from step 30's checkpoint; (c) minitron-4b at full width with
# its depth cut 32 -> 8 layers (2.23 B parameters, 16 B a parameter of training state),
# 8 x 2048 tokens in 4 microbatches of 2 x 2048, 6 steps.
TRAIN_JOB = dict(
    arch="mamba2-130m",
    smoke=False,
    steps=30,
    seq_len=2048,
    global_batch=8,
    n_microbatches=2,
    peak_lr=6e-4,
    warmup=10,
    ckpt_every=10,
    log_every=5,
)
TRAIN_NAN_STEP = 15
TRAIN_RESUME_STEPS = 32
TRAIN_CHECK_TOKENS = (1, 256)  # (a)'s full-width mamba2-130m, card against CPU
DENSE_TRAIN = dict(
    arch="minitron-4b", n_layers=8, steps=6, seq_len=2048, global_batch=8, n_microbatches=4
)
# Phase 17, analytic scoping: benchmarks/mset_service_roofline.py's service sizes
# (n_signals, n_memvec, batch), each measured with CUDA events over SERVICE_ITERS calls;
# and the dry-run sweep's worker processes.
SERVICE_SIZES = ((64, 512, 4096), (1024, 4096, 8192), (4096, 8192, 16384))
SERVICE_ITERS = 10
SWEEP_WORKERS = 8
# Phase 18: phase 8's serving shape with a few greedy steps on a one-card mesh; phase
# 17's full-width service size; the dry-run's cells on pod16x16 (256 chips) and the
# analytic LM scoping of minitron-4b across the catalog from 64 chips.
SHARDED_SERVE = dict(batch=4, prompt_len=2048, gen_tokens=8)
SHARDED_SERVICE = SERVICE_SIZES[1]
SHARDED_CELLS = (
    ("minitron-4b", "train_4k"),
    ("olmoe-1b-7b", "train_4k"),
    ("mamba2-130m", "train_4k"),
)
SHARDED_SCOPE = ("minitron-4b", "train_4k")
# The fleet phase's tuning rounds: benchmarks/tune_controller.py's flash-crowd
# predictive-tuning scenario, raced as (candidates, seeds, seconds at dt 5 s, tile).
# 24 x 12 x 720 bins is benchmarks/sim_perf.py's headline; 512 at tile 512 is the
# portfolio round's tile width. The rows checked against numpy are fixed in advance.
FLEET_LATTICES = (
    (24, 12, 3600.0, None, (0, 1, 23)),
    (512, 12, 3600.0, 512, (0, 1, 255, 256, 510, 511)),
)
FLEET_SUBSTEP_CELL = (8, 8, 720.0)  # sim_perf.py's SUBSTEP_CELL: n_substeps 4, preemptive
FLEET_FIDELITY = (600.0, 4)  # sim_perf.py's fidelity workload: seconds at dt 2 s, seeds
FLEET_WARM = 3  # warm dispatches (graph replays) timed after the cold one and the capture
# Bin loops counted under torch.profiler, each at two lengths so that the count a bin
# is the difference (set-up cancels): (candidates, seeds, seconds).
FLEET_PROFILE = {"coarse": (24, 12, (150.0, 300.0)), "substep": (8, 12, (25.0, 50.0))}


# The SPRT kernel beside its plain version: (T, n, with mu, NaN at) off the full-width
# residuals' shape: n off multiples of 32, one step, one signal, no mean, a NaN residual.
SPRT_RAGGED = [
    (1, 1024, True, None),
    (4099, 1000, False, None),
    (777, 33, True, None),
    (300, 1, False, None),
    (2049, 65, True, (700, 3)),
]
# float32 operations an element: divide, two products, two subtractions, two sums, two
# clamps, two comparisons (and the mean's subtraction)
SPRT_OPS = 11
# The narrow, long surveillance run (T, n): a customer with 32 sensors and a long history.
SPRT_NARROW = (1_048_576, 32)
# Chunk lengths the SPRT kernel is also timed at, beside its own choice.
SPRT_CHUNKS = (512, 1024, 2048, 4096)
# The two SPRT kernels, each built and reported by ptxas.
SPRT_KERNELS = ("sprt_scan_kernel", "sprt_fixup_kernel")
# Phase 12, the autonomous loop: benchmarks/closed_loop.py --full's world (its build()
# and run()), built here from the port since the benchmark folder is not ported. The
# MSET2 serving fleet of mset_scenario(1024 signals, 4096 memory vectors, 8 GB fleet,
# SLO 2 s) on its recommended shape; PIPolicy, quota QUOTA, COLD_START_S, max_queue of
# 2 x mean rate x DT_S; a diurnal trace of 7,200 s (--full) at AMPLITUDE and MEAN_MULT
# one replica's throughput, 8 Monte Carlo seeds (SEED + 1) and 4 live seeds (SEED + 101);
# Objective(TUNE_BAR, 2000); the incumbent tuned with TuningBudget(16, init_seeds=2);
# a DRIFT_FACTOR service drift at T_DRIFT_FRAC; the controller at SEGMENT_BINS with a
# re-tune budget of 16 (--full); recovery judged COLD_BINS after the swap.
CONTROL = dict(
    n_signals=1024, n_memvec=4096, fleet=8, slo_s=2.0, quota=24, cold_start_s=60.0,
    dt_s=10.0, duration_s=7200.0, amplitude=0.4, mean_mult=3.0, mc_seeds=8, live_seeds=4,
    seed=0, tune_bar=0.96, penalty=2000.0, tune_candidates=16, init_seeds=2,
    drift_factor=2.0, t_drift_frac=0.25, segment_bins=15, retune_candidates=16,
)
# benchmarks/oracle.py --full's grid: mean rates in multiples of one replica's throughput
# x BURST_AXIS x SLO_AXIS, GRID_DURATION_S at DT_S, 4 seeds, ORACLE_SEED, 14 candidates;
# verify_oracle's 5 spot checks (--full). The numpy per-cell build runs ORACLE_COLUMN,
# one (rate, burstiness) column, re-seeded so that its seed is that column's in the grid.
ORACLE = dict(
    rate_mults=(1.5, 3.0, 6.0, 12.0), burstiness=(1.0, 1.6, 2.2), slos=(1.0, 2.0, 4.0),
    duration_s=1800.0, n_seeds=4, seed=7, candidates=14, init_seeds=2, verify_samples=5,
)
ORACLE_COLUMN = (1, 1)


# Phase 19: several processes under torchrun (python -m torch.distributed.run). The
# server through its launcher as a world of one on the card, at phase 8's shape and seed;
# the elastic chain: mamba2-130m at full width in float32, 4 x 128 tokens, one job of
# CHAIN["steps"] steps run to the end by a gloo world of four on the host, resumed on the
# card (a world of one) from a copy of its step-2 checkpoint, and by a gloo world of two
# from a copy of the card's step-4 checkpoint. NCCL refuses two ranks on one card.
CHAIN = dict(arch="mamba2-130m", smoke=False, steps=5, seq_len=128, global_batch=4, ckpt_every=2)
CHAIN_LINKS = (("cpu x 4", 4, "cpu", None), ("card x 1", 1, "cuda", 2), ("cpu x 2", 2, "cpu", 4))
CHAIN_RTOL = 1e-5  # phase 16's bar for a loss, card against CPU
WORLD_TIMEOUT = 420
# Phase 20: every examples/torch_*.py as its own process on the card (this script's
# --example mode); the arguments of those whose defaults would run for minutes.
EXAMPLE_ARGS = {"torch_train_lm.py": ["--steps", "40"]}
EXAMPLES_FIRST = ("torch_simulate_fleet.py", "torch_train_lm.py")
EXAMPLE_TIMEOUT = 600
EXAMPLE_WORKERS = 3


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


def device_ms_by_kernel(fn, calls=5):
    """Device time of each kernel that ``fn`` launches, in ms a call: the mean over
    ``calls`` calls under torch.profiler, after a warm-up call; empty when the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = getattr(e, "cuda_time_total", 0) if us is None else us
        if us > 0:
            times[e.key] = us / 1e3 / calls
    return times


def bound(m, b, n, elem_bytes=4, products=1):
    """Least time for sim(x (m,n), y (b,n)): 2mbn operations (times ``products``) at the
    TF32 tensor-core rate, or each input read once and the f32 output written once,
    whichever is longer."""
    t_ops = 2.0 * m * b * n * products / TF32_FLOPS
    t_bytes = (elem_bytes * (m + b) * n + 4.0 * m * b) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def wide_gamma(x, y):
    """The larger of the median distance and a third of the largest, so that no value of
    either kind is near 0 even at n = 1 (gaussian >= exp(-4.5))."""
    d = torch.cdist(x.float(), y.float())
    return max(float(d.median()), float(d.max()) / 3, 1e-3)


def check_ragged(x, y, gamma, kind, out, ref):
    """The kernel's output ``out`` against the plain version ``ref`` and float64.

    A pair is ill-conditioned in float32 when moving its d2 by eight float32 roundings of
    the norms, 8 eps (|x_i|^2 + |y_j|^2), moves its similarity by more than half the bar:
    at n of 1 or 3 with inverse_distance, pairs so close that d2 = |x|^2 + |y|^2 - 2 x.y
    is mostly rounding, where no two float32 orders of rounding agree to the bar. There
    the kernel must be within the cancellation bound of float64,
    sqrt(2 (n + 1) eps (|x_i|^2 + |y_j|^2)) / gamma (G's diagonal bound, pair by pair);
    at every other pair, within the bar of the plain version. Returns (the error against
    the plain version where it applies, the number of ill-conditioned pairs, the kernel's
    error against float64 there, ok)."""
    x64, y64 = x.double(), y.double()
    norms = (x64 * x64).sum(1)[:, None] + (y64 * y64).sum(1)[None, :]
    d2 = (norms - 2 * x64 @ y64.T).clamp(min=0)

    def h(v):
        if kind == "inverse_distance":
            return 1 / (1 + v.sqrt() / gamma)
        return (-v / (2 * gamma**2)).exp()

    exact = h(d2)
    ill = (exact - h(d2 + 8 * EPS32 * norms)).abs() > TOL / 2
    diff = (out - ref).abs()
    err = float(diff.masked_fill(ill, 0).max())
    ok = bool((diff <= TOL + TOL * ref.abs()).masked_fill(ill, True).all())
    far = (out.double() - exact).abs()
    bound = torch.sqrt(2 * (x.shape[1] + 1) * EPS32 * norms) / gamma
    ok = ok and bool((far <= bound).masked_fill(~ill, True).all())
    far_err = float(far[ill].max()) if bool(ill.any()) else 0.0
    return err, int(ill.sum()), far_err, ok


def check_self(x, gamma, similarity_cuda, similarity_ref):
    """sim(x, x), which the kernel splits once: equal to sim(x, x.clone()), and held to
    the plain version as ``check_ragged`` holds a pair; the diagonal (d2 = 0) is
    ill-conditioned, so it is held to G's cancellation bound row by row, with n + 1 in
    place of n for the split's dropped lo.lo (at most 2^-22 |x|^2). Returns
    ``check_ragged``'s four values, ok also requiring the equality."""
    same, copy = similarity_cuda(x, x, gamma), similarity_cuda(x, x.clone(), gamma)
    err, n_ill, far_err, ok = check_ragged(x, x, gamma, KINDS[0], same, similarity_ref(x, x, gamma))
    return err, n_ill, far_err, ok and torch.equal(same, copy)


def float64_errors(D, X, gamma, similarity_cuda, similarity_ref):
    """max |kernel - exact| and max |plain - exact| for each kind, exact being the
    similarity of D and X computed in float64 on the card."""
    D64, X64 = D.double(), X.double()
    d2 = D64 @ X64.T
    d2.mul_(-2).add_((D64 * D64).sum(1)[:, None]).add_((X64 * X64).sum(1)[None, :])
    d2.clamp_(min=0)
    del D64, X64
    errs = {}
    for kind in KINDS:
        if kind == "inverse_distance":
            exact = d2.sqrt().div_(gamma).add_(1).reciprocal_()
        else:
            exact = d2.div(-2 * gamma * gamma).exp_()
        row = {}
        for name, fn in (("kernel", similarity_cuda), ("plain", similarity_ref)):
            out = fn(D, X, gamma, kind).double()
            row[name] = float(out.sub_(exact).abs_().max())
            del out
        errs[kind] = row
        del exact
    del d2
    torch.cuda.empty_cache()
    return errs


def tf32(t):
    """t rounded to TF32 (10 fraction bits), to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32``: one TF32 product's operands."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def gemm_phase(dev, card, gemm_module, Ginv, K_all, D):
    """Phase 21: K4 (W = Ginv K) against float64 and cuBLAS float32 on the full-width
    cell's own Ginv (at GEMM_REG) and a batch's K, at ragged shapes and on random operands
    of the main path's shapes; then timed at those shapes beside cuBLAS float32 (which is
    also the plain version) and its bound. Then X_hat = W^T D, estimate's second product,
    on the cell's W (Ginv times the K of ``K_all``'s first b observations) at WT_D_SHAPES,
    with the cell's D where it has the shape's signals and random signals else, held and
    timed alike with D^T's planes given, as ``estimate`` runs it. Each error is in norm,
    relative to the float64 product's; a third, one TF32 product's (hi.hi with float64
    sums, the best any one-product kernel can do), shows that the bar would catch such a
    kernel on the same operands."""
    print("== 21. K4, W = Ginv K on the cell's Ginv and ragged, against float64 and cuBLAS f32")
    K = K_all[:, : GEMM_SHAPES["fig8 batch"][2]].contiguous()
    eps = float(torch.finfo(torch.float32).eps)

    def errors(a, b, **kw):
        """K4's, cuBLAS f32's and one TF32 product's errors, and K4's bar."""
        exact = a.double() @ b.double()
        scale = torch.linalg.norm(exact)

        def err(out):
            return float(torch.linalg.norm(out.double().sub_(exact)) / scale)

        e = dict(
            kernel=err(gemm_module.gemm_cuda(a, b, **kw)),
            cublas=err(a @ b),
            one_tf32=err(tf32(a).double() @ tf32(b).double()),
        )
        e["bar"] = min(GEMM_FACTOR * max(e["cublas"], 4 * eps), GEMM_CAP)
        del exact
        torch.cuda.empty_cache()
        return e

    def held(label, e, witness=True):
        print(
            f"  {label}: K4 {e['kernel']:.3e}, cuBLAS f32 {e['cublas']:.3e}, one TF32 product "
            f"{e['one_tf32']:.3e}; bar {e['bar']:.3e}"
        )
        expect(e["kernel"] <= e["bar"], f"K4 far from float64 at {label}: {e}")
        if witness:
            expect(e["one_tf32"] > e["bar"], f"the bar at {label} would pass one TF32 product")

    planes = gemm_module.split_rows(Ginv)
    same = torch.equal(gemm_module.gemm_cuda(Ginv, K, planes), gemm_module.gemm_cuda(Ginv, K))
    cell = errors(Ginv, K, a_split=planes)
    print(f"  Ginv's planes given, the same bits as K4 splitting Ginv: {same}")
    expect(same, "K4 with Ginv's planes given differs from K4 splitting Ginv")
    held(f"the cell's Ginv {tuple(Ginv.shape)} (reg {GEMM_REG:g}) x K {tuple(K.shape)}", cell)
    del planes
    g = torch.Generator(device=dev).manual_seed(21)
    for m, k, n in GEMM_RAGGED:
        a = torch.randn(m, k, generator=g, device=dev)
        b = torch.randn(k, n, generator=g, device=dev)
        # a single product (k = 1) may round to TF32 by chance: no witness there
        held(f"ragged {m}x{k}x{n}", errors(a, b), witness=k > 1)
    def timed(label, a, b, given, float64_err):
        """K4's a @ b as ``estimate`` runs it, with the planes it keeps (``given``), and
        splitting every operand, beside cuBLAS float32 (also the plain version) and the
        bound; device time by kernel of the call that splits every operand."""
        (m, k), n = a.shape, b.shape[1]
        iters = max(2, int(2e13 // (m * k * n)))
        ms = cuda_ms(lambda: gemm_module.gemm_cuda(a, b, **given), iters)
        split_all_ms = cuda_ms(lambda: gemm_module.gemm_cuda(a, b), iters)
        library_ms = cuda_ms(lambda: a @ b, iters)
        bound_ms = 2.0 * m * k * n / TF32_FLOPS * 1e3
        device_ms = {
            re.sub(r"^(void )?\(anonymous namespace\)::|\(.*$", "", name): t
            for name, t in device_ms_by_kernel(lambda: gemm_module.gemm_cuda(a, b)).items()
        }
        print(
            f"  {label}: K4 {ms:.3f} ms with {', '.join(given)} given ({split_all_ms:.3f} ms "
            f"splitting every operand), cuBLAS f32 (the plain version) {library_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms (operations; three TF32 products at peak "
            f"{3 * bound_ms:.3f} ms), K4 at {3 * bound_ms / ms:.1%} of the 3xTF32 peak"
        )
        print(
            "    device time by kernel (torch.profiler): "
            + (", ".join(f"{k_} {v:.3f} ms" for k_, v in device_ms.items()) or "not measured")
        )
        return dict(
            shape=[m, k, n],
            ms=ms,
            split_all_ms=split_all_ms,
            plain_ms=library_ms,
            library_ms=library_ms,
            bound_ms=bound_ms,
            bound_by="operations",
            bound_3x_ms=3 * bound_ms,
            device_ms=device_ms,
            float64_err=float64_err,
        )

    print(f"== 21. K4 at the main path's shapes, and timed (CUDA events; {card})")
    timings = {}
    for label, (m, k, n) in GEMM_SHAPES.items():
        a = torch.randn(m, k, generator=g, device=dev)
        b = torch.rand(k, n, generator=g, device=dev)  # similarities lie in (0, 1]
        float64_err = errors(a, b)
        held(f"{label} {m}x{k}x{n}, randn x rand", float64_err)
        planes = gemm_module.split_rows(a)
        timings[label] = timed(f"{label} {m}x{k}x{n}", a, b, dict(a_split=planes), float64_err)
        del a, b, planes
        torch.cuda.empty_cache()
    del K
    print(f"== 21. K4, X_hat = W^T D on the cell's W, against float64 and cuBLAS f32 ({card})")
    wt_d = {}
    for label, (b, m, n) in WT_D_SHAPES.items():
        W = gemm_module.gemm_cuda(Ginv, K_all[:, :b].contiguous())
        Dn = D if D.shape == (m, n) else torch.randn(m, n, generator=g, device=dev)
        planes = gemm_module.split_cols(Dn)
        float64_err = errors(W.T, Dn, b_split=planes)
        text = f"{label} W^T {b}x{m} . D {m}x{n}"
        held(text, float64_err)
        wt_d[label] = timed(text, W.T, Dn, dict(b_split=planes), float64_err)
        del W, Dn, planes
        torch.cuda.empty_cache()
    return dict(float64_err=cell, timings=timings, wt_d=wt_d)


def step_timer():
    """(split, step): ``step(name, fn)`` runs fn between two synchronizes and adds its
    host-clock seconds to ``split[name]``; the models' ``step`` hooks take it."""
    split = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[name] = split.get(name, 0.0) + time.perf_counter() - t0
        return out

    return split, step


def attention_bound(B, S, H, K, hd, flops=BF16_FLOPS, elem_bytes=2, causal=True):
    """Least time for attention: 4·B·H·hd·S(S+1)/2 operations when causal, 4·B·H·hd·S²
    when not, at ``flops`` (the bf16 tensor core rate by default; float32 runs on the
    CUDA cores' FMA), or q, k, v read once and o written once, whichever is longer."""
    pairs = S * (S + 1) / 2 if causal else S * S
    t_ops = 4.0 * B * H * hd * pairs / flops
    t_bytes = elem_bytes * B * S * hd * (2 * H + 2 * K) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def flash_bar(ref, dtype):
    """float32: tests/test_kernels.py's 2e-5. bfloat16: kernel and plain version get the
    same bf16 inputs and both compute in float32, so they may differ by one bf16 ulp of
    the output (2^-7 relative), plus 1e-5 for outputs near 0."""
    if dtype == torch.float32:
        return 2e-5 + 2e-5 * ref.abs()
    return 1e-5 + 2.0**-7 * ref.abs()


def check_flash(out, ref, dtype):
    diff = (out.float() - ref.float()).abs()
    return float(diff.max()), bool((diff <= flash_bar(ref.float(), dtype)).all())


def attention_inputs(shape, dtype, g, dev, kind="randn"):
    """q (B, S, H, hd), k and v (B, S, K, hd) from randn. kind "heads-major": each a
    view of a (B, heads, S, hd) tensor, read through its strides; "q x8": q times 8;
    "structured": q = 0, so that P is uniform over the unmasked keys, and
    V[j, d] = j + d / 1000, so that a P or V fragment in the wrong place gives a large
    error that names the row and column it came from."""
    B, S, H, K, hd = shape
    out = []
    for n in (H, K, K):
        if kind == "heads-major":
            t = torch.randn(B, n, S, hd, generator=g, device=dev).transpose(1, 2)
        else:
            t = torch.randn(B, S, n, hd, generator=g, device=dev)
        out.append(t)
    if kind == "q x8":
        out[0] = out[0] * 8
    elif kind == "structured":
        out[0] = torch.zeros_like(out[0])
        j = torch.arange(S, device=dev, dtype=torch.float32)[:, None]
        d = torch.arange(hd, device=dev, dtype=torch.float32)[None, :]
        out[2] = (j + d / 1000).expand(B, K, S, hd).transpose(1, 2)
    return [t.to(dtype) for t in out]


def kernel_label(mangled):
    """``flash_tc_kernel<128>`` or ``similarity_tc_kernel<0, true>`` from a mangled name
    in nvcc's ptxas report."""
    m = re.search(r"\d+([a-z_]+_kernel)I(.*?)EEv", mangled)
    if m is None:  # not a template: the innermost of the nested name's <length><name> parts
        i, name = mangled.find("_ZN") + 3, mangled
        while i > 2 and (n := re.match(r"\d+", mangled[i:])):
            i += n.end() + int(n.group())
            name = mangled[i - int(n.group()) : i]
        return name
    kernel, args = m.groups()
    dtype = {"f": ["float"], "1": ["bf16"]}.get(args[:1], [])  # f, or 13__nv_bfloat16
    values = [
        v if t == "i" else ("true" if v == "1" else "false")
        for t, v in re.findall(r"L([ib])(-?\d+)E", args)
    ]
    return f"{kernel}<{', '.join(dtype + values)}>"


def ptxas_report(log):
    """(kernel, registers, spill store bytes, spill load bytes) for each instance that
    ``nvcc -Xptxas -v`` compiled."""
    rows = re.findall(
        r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) bytes spill stores, "
        r"(\d+) bytes spill loads\n[^\n]*Used (\d+) registers",
        log,
    )
    return [(kernel_label(n), int(regs), int(st), int(ld)) for n, st, ld, regs in rows]


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


def sprt_bound(T, n, with_mu):
    """Least time for the SPRT over (T, n) residuals: each residual read once (and sigma,
    mu), the alarm byte and both float32 LLRs written once, against SPRT_OPS float32
    operations an element at the CUDA cores' rate, whichever is longer."""
    t_bytes = ((4 + 1 + 8) * T * n + 4 * n * (2 if with_mu else 1)) / HBM_BYTES_PER_S
    t_ops = (SPRT_OPS + with_mu) * T * n / F32_FLOPS
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def check_sprt(r, sigma, mu, p, chunk=None, want=None):
    """The SPRT kernel (at ``chunk`` steps a chunk, or its own choice) against its plain
    version on the same card inputs, or against ``want``: (alarms identical, LLRs bit for
    bit with NaN where the plain version has one, max |kernel - plain| over the LLRs with
    NaN = NaN counted as 0, the steps pass 2 re-ran and the most in one chunk)."""
    from repro_torch.kernels import sprt_cuda, sprt_ref

    kw = dict(m_shift=p.m_shift, upper=p.upper, lower=p.lower)
    counter = torch.zeros(2, dtype=torch.int64, device=r.device)
    got = sprt_cuda(r, sigma, mu, **kw, chunk=chunk, reruns=counter)
    want = sprt_ref(r, sigma, mu, **kw) if want is None else want
    same_alarms = torch.equal(got[0], want[0])
    bits = all(
        x.stride() == y.stride() and torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(got[1:], want[1:])
    )
    err = max(
        float(torch.where(x.isnan() & y.isnan(), 0.0, (x - y).abs()).max())
        for x, y in zip(got[1:], want[1:])
    )
    return same_alarms, bits, err, counter.tolist()


def rerun_stats(counts, T, n, L):
    """Mean and most steps pass 2 re-ran in one chunk of one signal, over the chunks
    after the first."""
    chunks = -(-T // L)
    return dict(mean=counts[0] / max(1, (chunks - 1) * n), max=counts[1], chunks=chunks)


def sprt_phase(dev, card, residuals, sigma, mu):
    """Phase 5, after the main path: the SPRT kernel against its plain version on the
    full-width residuals (at its own chunk length and as one chunk), at ragged sizes, on
    the shared chunk-edge cases and on a periodic input that never meets; then timed at
    full width and on a narrow, long run, each beside the one-chunk path. Returns its
    record."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_sprt_cases import CASES, CHUNKS, case_inputs, chunked_params

    from repro_torch.kernels import sprt_cuda, sprt_ref
    from repro_torch.kernels.sprt.sprt import chunk_length
    from repro_torch.mset import SPRTParams

    print(f"  the SPRT kernel against its plain version ({card}):")
    p = SPRTParams()
    kw = dict(m_shift=p.m_shift, upper=p.upper, lower=p.lower)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    T, n = residuals.shape
    full = (residuals, sigma, mu)
    # the plain loop over the full-width residuals, timed once; it is also their reference
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want_full = sprt_ref(*full, **kw)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    patho = (torch.full((T, n), 1.6, device=dev), torch.ones(n, device=dev), None)
    want_patho = sprt_ref(*patho, **kw)
    cases = [
        (f"full width {T}x{n}", full, None, want_full),
        (f"full width {T}x{n}, one chunk", full, T, want_full),
        (f"pathological r = 1.6 {T}x{n}", patho, None, want_patho),
    ]
    g = torch.Generator(device=dev).manual_seed(3)
    for Tr, nr, with_mu, nan_at in SPRT_RAGGED:
        r = torch.randn(Tr, nr, generator=g, device=dev)
        r[Tr // 2 :, nr // 2] += 3.0  # a shift to alarm on
        if nan_at is not None:
            r[nan_at] = float("nan")
        s = 0.8 + 0.4 * torch.rand(nr, generator=g, device=dev)
        m = 0.1 * torch.randn(nr, generator=g, device=dev) if with_mu else None
        cases.append((f"ragged {Tr}x{nr} mu={with_mu} NaN at {nan_at}", (r, s, m), None, None))
    wants = {}
    for name, label in chunked_params() + [(name, "own") for name in CASES]:
        args = tuple(None if x is None else torch.from_numpy(x).to(dev) for x in case_inputs(name))
        if name not in wants:
            wants[name] = sprt_ref(*args, **kw)
        chunk = None if label == "own" else CHUNKS[label](args[0].shape[0])
        cases.append((f"case {name}, chunk {label}", args, chunk, wants[name]))
    max_err, reruns = 0.0, {}
    for name, args, chunk, want in cases:
        same_alarms, bits, err, counts = check_sprt(*args, p, chunk, want)
        max_err = max(max_err, err)
        Tc, nc = args[0].shape
        L = chunk_length(Tc, nc, sms) if chunk is None else min(chunk, Tc)
        stats = rerun_stats(counts, Tc, nc, L)
        reruns[name] = stats
        print(
            f"    {name}: L {L} ({stats['chunks']} chunks), alarms identical {same_alarms}, "
            f"LLRs bit for bit {bits}, max |kernel - plain| {err:.1e}; pass 2 re-ran "
            f"{counts[0]} steps, {stats['mean']:.3f} a chunk, at most {stats['max']}"
        )
        expect(same_alarms and bits and err == 0.0, f"SPRT kernel disagrees: {name}")
    del want_full, want_patho, wants

    def timed(args, chunk=None, iters=20):
        return cuda_ms(lambda: sprt_cuda(*args, **kw, chunk=chunk), iters)

    L = chunk_length(T, n, sms)
    ms, one_chunk_ms = timed(full), timed(full, T, 3)
    # the host's time to enqueue a call, with no synchronize: the events' time per call is
    # the host's when this is as long
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        sprt_cuda(*full, **kw)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    patho_ms = timed(patho, None, 3)
    bound_ms, bound_by = sprt_bound(T, n, True)
    split = {
        re.sub(r"^.*?(sprt_\w+_kernel).*$", r"\1", k): v
        for k, v in device_ms_by_kernel(lambda: sprt_cuda(*full, **kw)).items()
        if "sprt_" in k
    }
    sweep = {c: timed(full, c) for c in SPRT_CHUNKS}
    print(
        f"    full width {T}x{n}, L {L}: kernel {ms:.4f} ms, one chunk {one_chunk_ms:.3f} ms, "
        f"plain loop {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), kernel at "
        f"{bound_ms / ms:.1%} of bound, one chunk at {bound_ms / one_chunk_ms:.1%} ({card})"
    )
    print(
        "    device time by kernel (torch.profiler): "
        + (", ".join(f"{k} {v:.4f} ms" for k, v in split.items()) or "not measured")
        + f"; the host enqueues a call in {host_ms:.4f} ms"
    )
    print("    at other chunk lengths: " + ", ".join(f"L {c} {t:.4f} ms" for c, t in sweep.items()))
    print(
        f"    pathological r = 1.6 at {T}x{n}: {patho_ms:.3f} ms (every chunk after the first "
        f"re-run whole: {reruns[cases[2][0]]['mean']:.0f} steps a chunk)"
    )
    del patho
    # the narrow, long run, with mu: held against the one-chunk path, which the cases
    # above hold against the plain loop
    Tn, nn = SPRT_NARROW
    gn = torch.Generator(device=dev).manual_seed(4)
    narrow = (
        torch.randn(Tn, nn, generator=gn, device=dev),
        0.8 + 0.4 * torch.rand(nn, generator=gn, device=dev),
        0.1 * torch.randn(nn, generator=gn, device=dev),
    )
    one = sprt_cuda(*narrow, **kw, chunk=Tn)
    same_alarms, bits, err, counts = check_sprt(*narrow, p, None, one)
    del one
    Ln = chunk_length(Tn, nn, sms)
    narrow_stats = rerun_stats(counts, Tn, nn, Ln)
    expect(same_alarms and bits and err == 0.0, "SPRT kernel disagrees with one chunk, narrow")
    narrow_ms, narrow_one_ms = timed(narrow), timed(narrow, Tn, 2)
    narrow_bound, narrow_by = sprt_bound(Tn, nn, True)
    narrow_sweep = {c: timed(narrow, c) for c in SPRT_CHUNKS}
    print(
        f"    narrow {Tn}x{nn}, L {Ln}: bit for bit with one chunk {same_alarms and bits}; "
        f"kernel {narrow_ms:.4f} ms, one chunk {narrow_one_ms:.3f} ms, bound "
        f"{narrow_bound:.4f} ms ({narrow_by}), kernel at {narrow_bound / narrow_ms:.1%} of "
        f"bound, one chunk at {narrow_bound / narrow_one_ms:.1%}; pass 2 re-ran "
        f"{narrow_stats['mean']:.3f} steps a chunk, at most {narrow_stats['max']} ({card})"
    )
    print(
        "    at other chunk lengths: "
        + ", ".join(f"L {c} {t:.4f} ms" for c, t in narrow_sweep.items())
    )
    del narrow
    full_name = cases[0][0]
    return dict(
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        library_ms=None,
        max_abs_err=max_err,
        shape=f"residuals {T}x{n} float32, sigma and mu ({n},)",
        chunk=L,
        kernels_per_call=len(split) or None,
        one_chunk_ms=one_chunk_ms,
        device_ms=split,
        host_enqueue_ms=host_ms,
        chunk_sweep_ms=sweep,
        reruns=reruns[full_name],
        pathological=dict(ms=patho_ms, reruns=reruns[cases[2][0]]),
        narrow=dict(
            shape=f"residuals {Tn}x{nn} float32, sigma and mu ({nn},)",
            chunk=Ln,
            ms=narrow_ms,
            one_chunk_ms=narrow_one_ms,
            bound_ms=narrow_bound,
            bound_by=narrow_by,
            reruns=narrow_stats,
            chunk_sweep_ms=narrow_sweep,
        ),
    )


def flash_kernel_phases(dev, card):
    """Phases 6 and 7: flash attention against its plain version, then timed at the
    serving shape and at prefill_32k's sequence. Returns the timings by shape."""
    from repro_torch.kernels import gqa_attention, mha_ref

    print("== 6. flash attention against its plain version on the card")
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [(shape, "randn") for shape in FLASH_SWEEP] + FLASH_CASES
    for shape, kind in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attention_inputs(shape, dtype, g, dev, kind)
            for causal in (True, False):
                out = gqa_attention(q, k, v, causal=causal, impl="cuda")
                ref = gqa_attention(q, k, v, causal=causal, impl="ref")
                err, ok = check_flash(out, ref, dtype)
                print(
                    f"  sweep B,S,H,K,hd={shape}{'' if kind == 'randn' else ' ' + kind} "
                    f"{str(dtype)[6:]:8s} causal={causal!s:5s} max_abs_err {err:.3e}"
                )
                expect(ok, f"flash kernel disagrees at {shape} {dtype} causal={causal}: {err}")
    torch.cuda.synchronize()

    print(f"== 7. flash attention at the serving and long shapes (CUDA events; {card})")
    timings = {"serve": flash_at(SERVE_SHAPE, torch.bfloat16, g, dev, 10, "serve")}
    # the last rows attend to every key; the plain version of the whole sequence is
    # timed below, but held here on its tail alone
    shape = LONG_SHAPE
    _, S, H, K, _ = shape
    q, k, v = attention_inputs(shape, torch.bfloat16, g, dev)
    kx, vx = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
    ref = mha_ref(q[:, -LONG_TAIL:], kx, vx, q_offset=S - LONG_TAIL)
    out = gqa_attention(q, k, v, impl="cuda")[:, -LONG_TAIL:]
    del kx, vx
    err, ok = check_flash(out, ref, torch.bfloat16)
    print(
        f"  prefill_32k B,S,H,K,hd={shape} bf16 causal, the last {LONG_TAIL} rows: "
        f"max_abs_err {err:.3e}"
    )
    expect(ok, f"flash kernel disagrees at the prefill_32k shape: {err}")
    del out, ref
    timings["prefill_32k"] = flash_times(q, k, v, shape, torch.bfloat16, err, 3, "prefill_32k")
    del q, k, v
    # The float32 instance at the serving shape: the FMA kernel that every float32
    # forward takes, beside SDPA in float32 and the bound at the CUDA cores' FMA rate.
    timings["serve_f32"] = flash_at(SERVE_SHAPE, torch.float32, g, dev, 5, "serve_f32")
    torch.cuda.empty_cache()
    return timings


def flash_at(shape, dtype, g, dev, iters, label, causal=True):
    """K2 against its plain version on every row of ``dtype`` inputs at ``shape``,
    causal or not, then timed (``flash_times``). Returns the timings."""
    from repro_torch.kernels import gqa_attention

    q, k, v = attention_inputs(shape, dtype, g, dev)
    err, ok = check_flash(
        gqa_attention(q, k, v, causal=causal, impl="cuda"),
        gqa_attention(q, k, v, causal=causal, impl="ref"),
        dtype,
    )
    mode = "causal" if causal else "non-causal"
    print(
        f"  {label} B,S,H,K,hd={shape} {str(dtype)[6:]} {mode}, all {shape[1]} rows: "
        f"max_abs_err {err:.3e}"
    )
    expect(ok, f"flash kernel disagrees at the {label} shape {shape} {dtype} {mode}: {err}")
    t = flash_times(q, k, v, shape, dtype, err, iters, label, causal)
    del q, k, v
    torch.cuda.empty_cache()
    return t


def flash_times(q, k, v, shape, dtype, err, iters, label, causal=True):
    """K2, its plain version and SDPA timed by CUDA events on the same inputs, causal or
    not, beside the bound (bf16 at the tensor cores' rate, float32 at the FMA rate)."""
    from repro_torch.kernels import gqa_attention

    B, S, H, K, hd = shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    t = dict(
        ms=cuda_ms(lambda: gqa_attention(q, k, v, causal=causal, impl="cuda"), iters),
        plain_ms=cuda_ms(
            lambda: gqa_attention(q, k, v, causal=causal, impl="ref"), max(iters // 3, 1), 1
        ),
        library_ms=cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True), iters),
        max_abs_err=err,
    )
    f32 = dtype == torch.float32
    rate = dict(flops=F32_FLOPS, elem_bytes=4) if f32 else {}
    t["bound_ms"], t["bound_by"] = attention_bound(*shape, **rate, causal=causal)
    mode = "causal" if causal else "non-causal"
    t["shape"] = f"q {B}x{S}x{H}x{hd}, k/v {B}x{S}x{K}x{hd}, {str(dtype)[6:]}, {mode}"
    print(
        f"  {label}: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
        f"SDPA {t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms ({t['bound_by']}"
        f"{', float32 FMA 67 TFLOP/s' if f32 else ''}), kernel at {t['bound_ms'] / t['ms']:.2%} "
        f"of bound, {t['ms'] / t['library_ms']:.1f}x SDPA's time"
    )
    return t


def serving_phases(dev, card, flash_module):
    """Phases 8 and 9: the LM serving path at full width, its launch count and split,
    and its correctness checks. Returns the kernel's launch count and the generate
    calls' record (prefill and decode seconds, peak memory)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg = get_config(SERVE_ARCH)
    print(f"== 8. serving {cfg.name} at full width on {card}")
    print(
        f"  {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"head_dim {cfg.head_dim}, {cfg.mlp_type} MLP {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, {cfg.param_counts()['total']:,.0f} parameters; {SERVE}"
    )
    torch.cuda.reset_peak_memory_stats()
    flash_module.launches = 0
    runs = [generate(SERVE_ARCH, smoke=False, device=dev, **SERVE) for _ in range(2)]
    launches = flash_module.launches
    peak = torch.cuda.max_memory_allocated()
    for label, r in zip(("warm-up", "timed"), runs):
        print(
            f"  {label}: prefill {r.prefill_s:.4f} s, decode {r.decode_s:.4f} s "
            f"({SERVE['gen_tokens'] - 1} steps), {r.tokens_per_s:.1f} tokens/s "
            f"({r.tokens_per_s / SERVE['batch']:.1f} per sequence)"
        )
    print(f"  peak device memory {peak / 2**30:.2f} GiB")
    print(f"  flash kernel launches: {launches} over {len(runs)} generate calls")
    expect(launches > 0, "the serving path never launched the flash kernel")
    expect(launches == cfg.n_layers * len(runs), f"expected {cfg.n_layers} launches a call")
    toks = runs[1].tokens
    expect(toks.shape == (SERVE["batch"], SERVE["gen_tokens"]), f"tokens {toks.shape}")
    expect(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token ids out of range")
    same = bool((runs[0].tokens == toks).all())
    print(f"  the two calls gave the same tokens: {same}; first sequence {toks[0][:12]}")
    record = dict(
        prefill_s=[r.prefill_s for r in runs],
        decode_s=[r.decode_s for r in runs],
        peak_gib=peak / 2**30,
        tokens=toks.tolist(),
    )

    # One prefill split by step, each step ended by a synchronize.
    split, step = step_timer()
    g = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, dev, g)
    shape = (SERVE["batch"], SERVE["prompt_len"])
    prompts = torch.randint(0, cfg.vocab_size, shape, generator=g, device=dev)
    model.prefill(prompts)  # warm-up
    _, logits = model.prefill(prompts, step=step)
    expect(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
    total = sum(split.values())
    print(f"  one prefill split by step ({total:.4f} s in all; {card}):")
    for name, sec in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f"    {name:18s} {sec:9.4f} s  {sec / total:6.1%}")
    del model, logits, prompts
    torch.cuda.empty_cache()

    print("== 9. serving correctness")
    # decode(prefill(x[:-1]), x[-1]) == prefill(x) at the last token, at full width in
    # float32 (tests/test_models_smoke.py's bar): the flash kernel's prefill attention
    # against the plain decode attention, through all the layers.
    err, ok, top = decode_vs_prefill(cfg.replace(dtype="float32"), dev)
    print(
        f"  full width float32, B 2, S 256: decode vs prefill max_abs_err {err:.3e} "
        f"(bar 2e-4 + 2e-3|x|; max |logit| {top:.3f})"
    )
    expect(ok, f"decode disagrees with prefill at full width: {err}")
    card_vs_cpu(SERVE_ARCH, dev)
    return launches, record


def moe_prefill_bound(cfg, B, S):
    """Least time for an MoE prefill of B x S tokens (every layer attention + MoE, as
    olmoe's): its operations at the bf16 rate. A layer: the router, the expert FFNs on
    the T x k routed rows, the q/k/v/o projections and causal attention; then the last
    token's unembedding. Returns (ms, operations, the gather path's expert operations),
    the last over all E x C slots, filled or not, as that path computes them."""
    from repro_torch.models.moe import capacity

    T, d, E = B * S, cfg.d_model, cfg.n_experts
    ffn = 2.0 * (3 if cfg.mlp_type == "swiglu" else 2) * d * cfg.moe_d_ff
    experts = ffn * T * cfg.n_experts_per_tok
    proj = 2.0 * T * d * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    attn = 4.0 * B * cfg.n_heads * cfg.head_dim * S * (S + 1) / 2
    router = 2.0 * T * d * E
    flops = cfg.n_layers * (experts + proj + attn + router) + 2.0 * B * d * cfg.vocab_size
    return flops / BF16_FLOPS * 1e3, flops, cfg.n_layers * ffn * E * capacity(cfg, T)


def generate_cut(cfg, dev, batch, prompt_len, gen_tokens, seed=0):
    """``serve.generate``'s steps for a config that no registered name gives (a depth
    cut): weights and prompts from one generator seeded with ``seed``, a prefill into a
    cache of ``prompt_len + gen_tokens``, then greedy decoding, each timed."""
    from repro_torch.launch.serve import GenResult, decode_greedy
    from repro_torch.models import build_model

    g = torch.Generator(device=dev).manual_seed(seed)
    model = build_model(cfg, dev, g)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = model.prefill(prompts, model.init_cache(batch, prompt_len + gen_tokens))
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = decode_greedy(model, cache, logits, prompt_len, gen_tokens)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    tps = batch * (gen_tokens - 1) / t_decode
    return GenResult(toks.cpu().numpy(), t_prefill, t_decode, tps)


def decode_vs_prefill(cfg, dev, seed=1):
    """decode(prefill(x[:-1]), x[-1]) against prefill(x) at B 2, S 256 (an enc-dec
    config's two prefills encode the same frames, ``enc_memory_len`` of them): max
    |error|, whether it is within 2e-4 + 2e-3|x| (tests/test_models_smoke.py's bar),
    and max |logit|."""
    from repro_torch.models import build_model

    model = build_model(cfg, dev, torch.Generator(device=dev).manual_seed(seed))
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randint(0, cfg.vocab_size, (2, 256), generator=g, device=dev)
    src = {}
    if cfg.encdec:
        shape = (2, cfg.enc_memory_len, cfg.d_model)
        src["frames"] = torch.randn(shape, generator=g, device=dev)
    _, full = model.prefill(x, **src)
    cache, _ = model.prefill(x[:, :-1], model.init_cache(2, 256), **src)
    _, dec = model.decode_step(cache, x[:, -1:], 255)
    err = float((dec - full).abs().max())
    ok = bool(((dec - full).abs() <= 2e-4 + 2e-3 * full.abs()).all())
    top = float(full.abs().max())
    del model, cache, full, dec, src
    torch.cuda.empty_cache()
    return err, ok, top


def card_vs_cpu(arch, dev):
    """The smoke config in float32, the same weights and prompts (B 4, S 96; an enc-dec
    config's frames too, ``enc_memory_len`` of them) on the card (flash kernel) and on
    the CPU (plain version): prefill logits within 1e-4·max|logit| and 8 equal greedy
    tokens. Returns the logits' max |error|."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import decode_greedy
    from repro_torch.models import Model, build_model

    small = get_config(arch, smoke=True).replace(dtype="float32")
    cpu = build_model(small, "cpu", torch.Generator().manual_seed(0))
    on_card = Model.from_numpy(small, cpu.to_numpy(), dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, small.vocab_size, (4, 96)))
    src = {}
    if small.encdec:
        shape = (4, small.enc_memory_len, small.d_model)
        src["frames"] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    outs = []
    for m, d in ((cpu, "cpu"), (on_card, dev)):
        kw = {k: t.to(d) for k, t in src.items()}
        cache, logits = m.prefill(prompts.to(d), m.init_cache(4, 104), **kw)
        outs.append((logits.float().cpu(), decode_greedy(m, cache, logits, 96, 8).cpu()))
    (l_cpu, t_cpu), (l_card, t_card) = outs
    err, bar = float((l_card - l_cpu).abs().max()), 1e-4 * float(l_cpu.abs().max())
    same = bool(torch.equal(t_card, t_cpu))
    print(
        f"  {small.name} float32, card vs CPU prefill logits max_abs_err {err:.3e} "
        f"(bar {bar:.3e}); greedy tokens over 8 steps equal: {same}"
    )
    expect(err <= bar, f"{arch}: prefill logits on the card disagree with the CPU")
    expect(same, f"{arch}: greedy tokens on the card differ from the CPU")
    return err


def serve_calls(cfg, calls, run, flash_module, shape):
    """``calls`` calls of ``run(**shape)`` (a generate), K2's count set to 0 before
    each and read after it: it must equal the config's attention layers, and the
    encoder's layers for an enc-dec config. Returns the calls' record."""
    k2_per_call = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    k2_per_call += cfg.n_enc_layers if cfg.encdec else 0
    torch.cuda.reset_peak_memory_stats()
    runs, launches = [], []
    for _ in range(calls):
        flash_module.launches = 0
        runs.append(run(**shape))
        launches.append(flash_module.launches)
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    for i, r in enumerate(runs):
        print(
            f"  {cfg.name} call {i + 1}: prefill {r.prefill_s:.4f} s, "
            f"decode {r.decode_s:.4f} s ({shape['gen_tokens'] - 1} steps), "
            f"{r.tokens_per_s:.1f} tokens/s, "
            f"K2 launches {launches[i]}"
        )
    print(f"  {cfg.name}: peak device memory {peak / 2**30:.2f} GiB")
    toks = runs[-1].tokens
    expect(toks.shape == (shape["batch"], shape["gen_tokens"]), f"tokens {toks.shape}")
    expect(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token ids out of range")
    expect(
        all(n == k2_per_call for n in launches),
        f"{cfg.name}: K2 launched {launches} times, expected {k2_per_call} a call",
    )
    same = all(np.array_equal(r.tokens, toks) for r in runs)
    if calls > 1:
        print(f"  {cfg.name}: the {calls} calls gave the same tokens: {same}")
        expect(same, f"{cfg.name}: two generate calls gave different tokens")
    return dict(
        prefill_s=[r.prefill_s for r in runs],
        decode_s=[r.decode_s for r in runs],
        tokens_per_s=[r.tokens_per_s for r in runs],
        peak_gib=peak / 2**30,
        k2_launches=launches,
        parameters=cfg.param_counts()["total"],
    )


def split_prefill(cfg, dev, shape=SERVE):
    """One prefill at ``shape`` split by step (after a warm-up prefill; an enc-dec
    config encodes ``enc_memory_len`` frames); then one decode step after it under
    torch.profiler: kernels launched, host synchronisations and the card's busy share
    of the step's wall time."""
    from repro_torch.models import build_model
    from repro_torch.models.layers import working_dtype

    split, step = step_timer()
    g = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, dev, g)
    B, S = shape["batch"], shape["prompt_len"]
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    src = {}
    if cfg.encdec:
        frames = torch.randn((B, cfg.enc_memory_len, cfg.d_model), generator=g, device=dev)
        src["frames"] = frames.to(working_dtype(cfg))
    model.prefill(prompts, **src)
    cache, logits = model.prefill(prompts, model.init_cache(B, S + 2), step=step, **src)
    expect(bool(torch.isfinite(logits).all()), f"{cfg.name}: prefill logits are not finite")
    total = sum(split.values())
    print(f"  {cfg.name}: one prefill split by step ({total:.4f} s in all):")
    for name, sec in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f"    {name:28s} {sec:9.4f} s  {sec / total:6.1%}")
    tok = logits[:, -1].argmax(-1)[:, None]
    model.decode_step(cache, tok, S)  # warm-up
    kernels, copies, syncs, busy = profile_counts(lambda: model.decode_step(cache, tok, S + 1))
    n = sum(kernels.values())
    print(
        f"  {cfg.name}: a decode step launches {n} kernels ({n / cfg.n_layers:.1f} a layer), "
        f"{copies} copies and memsets, {syncs} host synchronisations; the card is busy "
        f"{busy:.1%} of its wall time under the profiler"
    )
    del model, cache, logits, prompts, src
    torch.cuda.empty_cache()
    return dict(split, total=total), dict(kernels=n, copies=copies, syncs=syncs, busy=busy)


def families_phase(dev, card, flash_module):
    """Phase 14: the MoE and SSM families. olmoe-1b-7b at full width (bf16, served
    twice; its prefill split; K2 against its plain version at its attention shape; f32
    decode against prefill at capacity 16), mamba2-130m at full width (the same, without
    K2), jamba-v0.1-52b at full width with its depth cut to one period of 8 layers
    (served once; K2 at its shape), and the four smoke configs card against CPU.
    Returns the phase's record."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import decode_flops_bytes, generate

    t_phase = time.perf_counter()
    print(f"== 14. the MoE and SSM families on {card}")
    rec = {"card": card, "serve": SERVE}

    g = torch.Generator(device=dev).manual_seed(2)

    def k2_check(cfg):
        """K2 against its plain version, and timed, at the shape this config's
        prefill gives it: SERVE's batch and prompt, bf16, causal."""
        shape = (SERVE["batch"], SERVE["prompt_len"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        return flash_at(shape, torch.bfloat16, g, dev, 10, f"{cfg.name} K2")

    def f32_check(cfg):
        err, ok, top = decode_vs_prefill(cfg, dev)
        print(
            f"  {cfg.name} full width float32 (capacity {cfg.capacity_factor:g}), B 2, S 256: "
            f"decode vs prefill max_abs_err {err:.3e} (bar 2e-4 + 2e-3|x|; max |logit| {top:.3f})"
        )
        expect(ok, f"{cfg.name}: decode disagrees with prefill at full width: {err}")
        return err

    # olmoe-1b-7b: full width, not cut
    cfg = get_config("olmoe-1b-7b")
    print(
        f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads} of "
        f"{cfg.head_dim} (qk-norm), {cfg.n_experts} experts top {cfg.n_experts_per_tok} of "
        f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{cfg.param_counts()['total']:,.0f} parameters, not cut"
    )
    olmoe = serve_calls(
        cfg, 2, partial(generate, cfg.name, smoke=False, device=dev), flash_module, SERVE
    )
    olmoe["split"], olmoe["decode_profile"] = split_prefill(cfg, dev)
    olmoe["k2"] = k2_check(cfg)
    bound_ms, flops, gather_flops = moe_prefill_bound(cfg, SERVE["batch"], SERVE["prompt_len"])
    ctx = SERVE["prompt_len"] + SERVE["gen_tokens"] // 2
    d_flops, d_bytes = decode_flops_bytes(cfg, SERVE["batch"], ctx)
    d_bound = max(d_flops / BF16_FLOPS, d_bytes / HBM_BYTES_PER_S) * 1e3
    step_ms = [s / (SERVE["gen_tokens"] - 1) * 1e3 for s in olmoe["decode_s"]]
    print(
        f"  {cfg.name}: prefill bound {bound_ms:.2f} ms ({flops / 1e12:.2f} TFLOP at bf16 "
        f"989 TFLOP/s; the experts on the T x k routed rows; the gather path's E x C slots "
        f"take {gather_flops / 1e12:.2f} TFLOP of expert work, "
        f"{gather_flops / BF16_FLOPS * 1e3:.2f} ms) against "
        f"{min(olmoe['prefill_s']) * 1e3:.2f} ms measured; decode bound {d_bound:.2f} ms a step "
        f"({d_bytes / 1e9:.2f} GB at 3.35 TB/s) against {min(step_ms):.2f} ms"
    )
    olmoe.update(
        prefill_bound_ms=bound_ms,
        gather_expert_ms=gather_flops / BF16_FLOPS * 1e3,
        decode_bound_ms=d_bound,
        decode_step_ms=step_ms,
    )
    olmoe["f32_decode_vs_prefill"] = f32_check(cfg.replace(dtype="float32", capacity_factor=16.0))
    rec["olmoe-1b-7b"] = olmoe

    # mamba2-130m: full width, not cut
    cfg = get_config("mamba2-130m")
    print(
        f"  {cfg.name}: {cfg.n_layers} SSD layers, d_model {cfg.d_model}, {cfg.ssm_nheads} heads "
        f"of {cfg.ssm_headdim}, d_state {cfg.ssm_state}, chunk {cfg.ssd_chunk}, "
        f"{cfg.param_counts()['total']:,.0f} parameters, not cut"
    )
    mamba = serve_calls(
        cfg, 2, partial(generate, cfg.name, smoke=False, device=dev), flash_module, SERVE
    )
    mamba["split"], mamba["decode_profile"] = split_prefill(cfg, dev)
    mamba["f32_decode_vs_prefill"] = f32_check(cfg.replace(dtype="float32"))
    rec["mamba2-130m"] = mamba

    # jamba-v0.1-52b: 103 GB in bf16 does not fit one card; one period of 8 layers does
    full = get_config("jamba-v0.1-52b")
    cfg = full.replace(n_layers=8)
    print(
        f"  {cfg.name}: depth cut {full.n_layers} -> {cfg.n_layers} (one period: 7 SSD mixers "
        f"with {cfg.ssm_nheads} heads, 1 attention layer of {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"4 MoE FFNs of {cfg.n_experts} x {cfg.moe_d_ff}, 4 dense FFNs of {cfg.d_ff}), "
        f"{cfg.param_counts()['total']:,.0f} parameters (of {full.param_counts()['total']:,.0f})"
    )
    jamba = serve_calls(cfg, 1, partial(generate_cut, cfg, dev), flash_module, SERVE)
    jamba["depth_cut"] = [full.n_layers, cfg.n_layers]
    jamba["k2"] = k2_check(cfg)
    rec["jamba-v0.1-52b"] = jamba

    rec["card_vs_cpu"] = {
        arch: card_vs_cpu(arch, dev)
        for arch in ("olmoe-1b-7b", "granite-moe-3b-a800m", "mamba2-130m", "jamba-v0.1-52b")
    }
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  the families phase took {rec['phase_s']:.1f} s")
    return rec


def encdec_prefill_flops(cfg, B, S):
    """Operations of an enc-dec prefill of B x S decoder tokens over B x enc_memory_len
    frames, as (encoder, decoder). An encoder layer: q/k/v/o projections, the MLP and
    non-causal attention; a decoder layer: its self-attention projections, the cross
    q and o on its tokens, the cross k and v on the encoder output, the MLP, causal
    self-attention and cross-attention; then the last token's unembedding."""
    L, d, ff = cfg.enc_memory_len, cfg.d_model, cfg.d_ff
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj, mlp = d * hd * (2 * H + 2 * K), (3 if cfg.mlp_type == "swiglu" else 2) * d * ff
    enc = 2.0 * B * L * (proj + mlp) + 4.0 * B * H * hd * L * L
    dec = (
        2.0 * B * S * (proj + 2 * d * H * hd + mlp)
        + 2.0 * B * L * 2 * d * K * hd
        + 4.0 * B * H * hd * (S * (S + 1) / 2 + S * L)
    )
    return cfg.n_enc_layers * enc, cfg.n_layers * dec + 2.0 * B * d * cfg.vocab_size


def encdec_decode_cost(cfg, B, ctx):
    """(operations, bytes) of one enc-dec decode step at context ``ctx``: the decoder's
    matmul weights (self-attention, cross q and o, MLP) in the working dtype and its
    norms in float32, the unembedding, and each layer's cross cache (enc_memory_len
    entries) and self cache (ctx entries), each read once."""
    el = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    L, d, ff, V = cfg.enc_memory_len, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mlp = (3 if cfg.mlp_type == "swiglu" else 2) * d * ff
    weights = cfg.n_layers * (d * hd * (2 * H + 2 * K) + 2 * d * H * hd + mlp) + d * V
    norms = (cfg.n_layers * 3 + 1) * 2 * d * 4
    caches = cfg.n_layers * 2 * B * K * hd * (L + ctx) * el
    ops = 2.0 * B * weights + 4.0 * B * cfg.n_layers * H * hd * (L + ctx)
    return ops, weights * el + norms + caches


def encdec_phase(dev, card, flash_module):
    """Phase 15: the enc-dec family. K2 against its plain version, then timed, at the
    encoder's shape (non-causal) and the decoder's (causal); seamless-m4t-large-v2 at
    full width served twice (a K2 launch for each encoder and decoder layer, equal
    tokens), its prefill split beside the FLOP bound and a decode step beside its bytes
    bound, with the decode step's kernels and busy share; f32 decode against prefill at
    full width; and the smoke config card against CPU. Returns the phase's record."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate

    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    B, S, n = ENCDEC_SERVE["batch"], ENCDEC_SERVE["prompt_len"], ENCDEC_SERVE["gen_tokens"]
    L = cfg.enc_memory_len
    print(f"== 15. the enc-dec family on {card}")
    print(
        f"  {cfg.name}: {cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, {cfg.mlp_type} "
        f"MLP {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{cfg.param_counts()['total']:,.0f} parameters, not cut; {L} frames, {ENCDEC_SERVE}"
    )
    rec = {"card": card, "serve": ENCDEC_SERVE, "frames": L}

    # 1. K2 at the two shapes this path gives it, against its plain version, then timed
    g = torch.Generator(device=dev).manual_seed(3)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    rec["k2"] = {
        "encoder": flash_at((B, L, *heads), torch.bfloat16, g, dev, 10, "encoder K2", False),
        "decoder": flash_at((B, S, *heads), torch.bfloat16, g, dev, 10, "decoder K2"),
    }

    # 2. serving at full width: K2 once a layer of either stack a prefill, none a decode
    serving = serve_calls(
        cfg, 2, partial(generate, ENCDEC_ARCH, smoke=False, device=dev), flash_module, ENCDEC_SERVE
    )
    split, serving["decode_profile"] = split_prefill(cfg, dev, ENCDEC_SERVE)
    serving["split"] = split
    enc_flops, dec_flops = encdec_prefill_flops(cfg, B, S)
    flops = enc_flops + dec_flops
    bound_ms = flops / BF16_FLOPS * 1e3
    enc_s = sum(sec for name, sec in split.items() if name.startswith("encoder "))
    cross_s = split.get("decoder cross attention", 0.0)
    d_ops, d_bytes = encdec_decode_cost(cfg, B, S + n // 2)
    d_bound = max(d_ops / BF16_FLOPS, d_bytes / HBM_BYTES_PER_S) * 1e3
    step_ms = [sec / (n - 1) * 1e3 for sec in serving["decode_s"]]
    print(
        f"  {cfg.name}: prefill bound {bound_ms:.2f} ms ({flops / 1e12:.2f} TFLOP at bf16 989 "
        f"TFLOP/s, the encoder {enc_flops / flops:.1%} of it) against "
        f"{min(serving['prefill_s']) * 1e3:.2f} ms measured; in the split the encoder took "
        f"{enc_s / split['total']:.1%} and the plain cross attention "
        f"{cross_s / split['total']:.1%}; decode bound {d_bound:.3f} ms a step "
        f"({d_bytes / 1e9:.3f} GB at 3.35 TB/s) against {min(step_ms):.2f} ms"
    )
    serving.update(
        prefill_tflop=flops / 1e12,
        prefill_bound_ms=bound_ms,
        encoder_flop_share=enc_flops / flops,
        encoder_split_share=enc_s / split["total"],
        cross_attention_split_share=cross_s / split["total"],
        decode_bytes=d_bytes,
        decode_bound_ms=d_bound,
        decode_step_ms=step_ms,
    )
    rec[cfg.name] = serving

    # 3. f32 decode against prefill at full width; 4. the smoke config card against CPU
    err, ok, top = decode_vs_prefill(cfg.replace(dtype="float32"), dev)
    print(
        f"  {cfg.name} full width float32, B 2, S 256, {L} frames: decode vs prefill "
        f"max_abs_err {err:.3e} (bar 2e-4 + 2e-3|x|; max |logit| {top:.3f})"
    )
    expect(ok, f"{cfg.name}: decode disagrees with prefill at full width: {err}")
    rec["f32_decode_vs_prefill"] = err
    rec["card_vs_cpu"] = card_vs_cpu(ENCDEC_ARCH, dev)
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  the enc-dec phase took {rec['phase_s']:.1f} s")
    return rec


def training_batch(cfg, B, S, seed):
    """Tokens, next-token targets and, for an enc-dec config, 2 S frames, drawn on the
    CPU from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
    if cfg.encdec:
        batch["frames"] = torch.randn(B, 2 * S, cfg.d_model, generator=g)
    return batch


def grads_card_vs_cpu(cfg, dev, B, S):
    """The loss and every gradient of a trainable ``cfg`` in float32 on the card
    against the CPU, on the same weights (drawn on the CPU) and batch. Returns (loss
    relative error, {parameter: max |error| / max |gradient|}, {parameter: max
    |gradient| on the card}, gradient norm relative error)."""
    from repro_torch.models import Model, build_model
    from repro_torch.optim import global_norm

    cpu = build_model(cfg, "cpu", torch.Generator().manual_seed(0), trainable=True)
    card = Model.from_numpy(cfg, cpu.to_numpy(), dev, trainable=True)
    batch = training_batch(cfg, B, S, seed=1)
    out = []
    for model, d in ((cpu, "cpu"), (card, dev)):
        loss, _ = model.loss({k: t.to(d) for k, t in batch.items()})
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        out.append((float(loss.detach()), grads, float(global_norm(grads))))
    (l_cpu, g_cpu, n_cpu), (l_card, g_card, n_card) = out
    rel = {
        n: float((g_card[n].cpu() - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        for n, g in g_cpu.items()
    }
    top = {n: float(g.abs().max()) for n, g in g_card.items()}
    del cpu, card, out, g_card
    torch.cuda.empty_cache()
    return abs(l_card - l_cpu) / abs(l_cpu), rel, top, abs(n_card - n_cpu) / n_cpu


def train_step_split(sb, pipe, steps):
    """``steps`` train_steps on ``pipe``'s batches, each split into "forward + backward"
    and "AdamW" by step_timer. Returns (per-step splits, the losses)."""
    splits, losses = [], []
    for i in range(steps):
        split, step = step_timer()
        metrics = sb.train_step(pipe.batch(i), step=step)
        losses.append(float(metrics["loss"]))
        splits.append(split)
    return splits, losses


def training_phase(dev, card, flash_module):
    """Phase 16: training, through the port's trainer and StepBuilder. (a) every smoke
    arch's loss and gradients in float32 on the card against the CPU (wq, wk and wv
    nonzero), and the full-width mamba2-130m's loss and gradient norm; (b) mamba2-130m
    at full width, not cut, through ``launch.train.train``: the NaN restart, the falling
    loss, the checkpoints and a second job's resume, the warm step's seconds, tokens/s,
    the AdamW step alone, peak memory and the step's FLOP bound; (c) minitron-4b at full
    width with its depth cut to 8: the step split, peak memory and bound. K2 may launch
    no time in the phase. Returns the phase's record."""
    import statistics
    import tempfile

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed.fault import FaultInjector
    from repro_torch.launch.steps import StepBuilder
    from repro_torch.launch.train import TrainJob, train
    from repro_torch.optim import AdamWConfig, warmup_cosine

    t_phase = time.perf_counter()
    print(f"== 16. training on {card}")
    rec = {"card": card}
    flash_module.launches = 0

    # (a) card against CPU: the smoke archs, then the full-width mamba2-130m
    rec["card_vs_cpu"] = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True).replace(dtype="float32")
        loss_err, rel, top, _ = grads_card_vs_cpu(cfg, dev, 2, 32)
        worst = max(rel, key=rel.get)
        attn = {n: v for n, v in top.items() if n.split(".")[-1] in ("wq", "wk", "wv")}
        print(
            f"  {cfg.name} float32: loss rel err {loss_err:.2e} (bar 1e-5), worst gradient "
            f"{worst} {rel[worst]:.2e} of its max (bar 1e-4); {len(attn)} wq/wk/wv leaves, "
            f"smallest max |g| {min(attn.values(), default=float('nan')):.3e}"
        )
        expect(loss_err <= 1e-5, f"{arch}: the loss on the card disagrees with the CPU")
        expect(rel[worst] <= 1e-4, f"{arch}: {worst}'s gradient disagrees with the CPU")
        expect(all(v > 0 for v in attn.values()), f"{arch}: a wq/wk/wv gradient is zero")
        expect(bool(attn) == (cfg.family != "ssm"), f"{arch}: attention leaves {sorted(attn)}")
        rec["card_vs_cpu"][arch] = dict(loss_rel_err=loss_err, worst_grad_rel_err=rel[worst])
    cfg = get_config(TRAIN_JOB["arch"]).replace(dtype="float32")
    loss_err, rel, _, norm_err = grads_card_vs_cpu(cfg, dev, *TRAIN_CHECK_TOKENS)
    print(
        f"  {cfg.name} full width float32, {TRAIN_CHECK_TOKENS[0]} x {TRAIN_CHECK_TOKENS[1]}: "
        f"loss rel err {loss_err:.2e} (bar 1e-5), gradient norm rel err {norm_err:.2e} (bar "
        f"1e-4), worst leaf {max(rel.values()):.2e} of its max"
    )
    expect(loss_err <= 1e-5, f"{cfg.name}: the full-width loss disagrees with the CPU")
    expect(norm_err <= 1e-4, f"{cfg.name}: the full-width gradient norm disagrees with the CPU")
    rec["card_vs_cpu"][cfg.name + " full width"] = dict(
        loss_rel_err=loss_err, grad_norm_rel_err=norm_err, worst_grad_rel_err=max(rel.values())
    )

    # (b) mamba2-130m at full width through the trainer
    cfg = get_config(TRAIN_JOB["arch"])
    tokens = TRAIN_JOB["global_batch"] * TRAIN_JOB["seq_len"]
    n_params = cfg.param_counts()["total"]
    bound_s = 8.0 * n_params * tokens / BF16_FLOPS
    with tempfile.TemporaryDirectory() as ckpt_dir:
        job = TrainJob(
            **TRAIN_JOB,
            ckpt_dir=ckpt_dir,
            injector=FaultInjector(nan_steps={TRAIN_NAN_STEP}),
            device=dev,
        )
        torch.cuda.reset_peak_memory_stats()
        m = train(job)
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in job.history]
        warm = [h["dt"] for h in job.history[1:]]
        resume = TrainJob(
            **dict(TRAIN_JOB, steps=TRAIN_RESUME_STEPS), ckpt_dir=ckpt_dir, device=dev
        )
        train(resume)
    step_s = statistics.median(warm)
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(
        f"  {cfg.name}: {len(job.history)} steps run, restarts {m['restarts']}, loss "
        f"{first5:.4f} (first 5) -> {last5:.4f} (last 5); the second job resumed at step "
        f"{resume.history[0]['step']}"
    )
    expect(m["restarts"] == 1 and m["steps"] == TRAIN_JOB["steps"], f"{cfg.name}: {m}")
    expect(last5 < first5, f"{cfg.name}: the loss did not fall ({first5} -> {last5})")
    expect(resume.history[0]["step"] >= TRAIN_JOB["steps"], "the second job started over")
    sb = StepBuilder(cfg, TRAIN_JOB["n_microbatches"], device=dev)
    pipe = TokenPipeline(
        cfg.vocab_size, TRAIN_JOB["seq_len"], TRAIN_JOB["global_batch"], device=dev
    )
    splits, _ = train_step_split(sb, pipe, 4)
    adamw_s = statistics.median(s["AdamW"] for s in splits[1:])
    fb_s = statistics.median(s["forward + backward"] for s in splits[1:])
    del sb, pipe
    torch.cuda.empty_cache()
    print(
        f"  {cfg.name} ({card}): warm step median {step_s:.4f} s ({tokens / step_s:,.0f} "
        f"tokens/s; {len(warm)} warm steps {min(warm):.4f}-{max(warm):.4f} s), peak "
        f"{peak / 2**30:.2f} GiB; split alone: forward + backward {fb_s:.4f} s, AdamW "
        f"{adamw_s:.4f} s; bound 8 N tokens = {8.0 * n_params * tokens / 1e12:.2f} TFLOP, "
        f"{bound_s * 1e3:.2f} ms at bf16 989 TFLOP/s ({bound_s / step_s:.1%} of the step)"
    )
    rec[cfg.name] = dict(
        job=dict(TRAIN_JOB),
        parameters=n_params,
        restarts=m["restarts"],
        losses=losses,
        first5=first5,
        last5=last5,
        resumed_at=resume.history[0]["step"],
        step_s=step_s,
        warm_steps_s=warm,
        tokens_per_s=tokens / step_s,
        forward_backward_s=fb_s,
        adamw_s=adamw_s,
        peak_gib=peak / 2**30,
        bound_ms=bound_s * 1e3,
        bound_share=bound_s / step_s,
    )

    # (c) minitron-4b at full width, its depth cut 32 -> 8
    d = DENSE_TRAIN
    full = get_config(d["arch"])
    cfg = full.replace(n_layers=d["n_layers"])
    counts = cfg.param_counts()
    tokens = d["global_batch"] * d["seq_len"]
    embed = cfg.d_model * cfg.vocab_size
    layer_params = counts["total"] - embed * (1 if cfg.tie_embeddings else 2)
    attn_pass = 4.0 * d["global_batch"] * cfg.n_heads * cfg.head_dim * d["seq_len"] ** 2
    flops = 8.0 * layer_params * tokens + 6.0 * embed * tokens + 4 * cfg.n_layers * attn_pass
    bound_s = flops / BF16_FLOPS
    print(
        f"  {cfg.name}: depth cut {full.n_layers} -> {cfg.n_layers}, {counts['total']:,.0f} "
        f"parameters ({16 * counts['total'] / 1e9:.1f} GB of float32 parameters, gradients, "
        f"m and v), {d['global_batch']} x {d['seq_len']} tokens in {d['n_microbatches']} "
        "microbatches"
    )
    torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=warmup_cosine(3e-4, 2, d["steps"]))
    sb = StepBuilder(cfg, d["n_microbatches"], opt, device=dev)
    pipe = TokenPipeline(cfg.vocab_size, d["seq_len"], d["global_batch"], device=dev)
    splits, losses = train_step_split(sb, pipe, d["steps"])
    peak = torch.cuda.max_memory_allocated()
    del sb, pipe
    torch.cuda.empty_cache()
    fb_s = statistics.median(s["forward + backward"] for s in splits[1:])
    adamw_s = statistics.median(s["AdamW"] for s in splits[1:])
    step_s = statistics.median(sum(s.values()) for s in splits[1:])
    print(
        f"  {cfg.name} ({card}): losses {', '.join(f'{x:.4f}' for x in losses)}; warm step "
        f"median {step_s:.4f} s ({tokens / step_s:,.0f} tokens/s): forward + backward "
        f"{fb_s / d['n_microbatches']:.4f} s a microbatch, AdamW {adamw_s:.4f} s; peak "
        f"{peak / 2**30:.2f} GiB; bound {flops / 1e12:.1f} TFLOP (layers 8 N, unembed 6 N, "
        f"attention 4 passes of the full rectangle), {bound_s * 1e3:.1f} ms at bf16 989 "
        f"TFLOP/s ({bound_s / step_s:.1%} of the step)"
    )
    expect(all(np.isfinite(losses)), f"{cfg.name}: a loss is not finite: {losses}")
    expect(peak < 80e9, f"{cfg.name}: peak {peak / 1e9:.1f} GB")
    rec[cfg.name] = dict(
        depth_cut=[full.n_layers, cfg.n_layers],
        parameters=counts["total"],
        losses=losses,
        step_s=step_s,
        tokens_per_s=tokens / step_s,
        forward_backward_microbatch_s=fb_s / d["n_microbatches"],
        adamw_s=adamw_s,
        splits=splits,
        peak_gib=peak / 2**30,
        bound_tflop=flops / 1e12,
        bound_ms=bound_s * 1e3,
        bound_share=bound_s / step_s,
    )
    rec["k2_launches"] = flash_module.launches
    print(f"  K2 launches in the training phase: {flash_module.launches}")
    expect(flash_module.launches == 0, "training launched the flash kernel")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  the training phase took {rec['phase_s']:.1f} s")
    return rec


def service_on_card(dev, n, m, b, sim_module):
    """The MSET service's estimate (``_estimate_sharded``, K1 on the card) at n signals,
    m memory vectors and a batch of b: random inputs from a seeded generator (a mean off
    0 and a std off 1), one call checked (K1 launched once, finite residuals), then held
    against its plain version on the same inputs: K from the wrapper the service calls
    against ``similarity_ref`` at phase 3's bar, and Xhat and the residuals against the
    service's products on that plain K, within 8 sqrt(m) eps32 of their largest
    magnitude: K1's error changes the roundings of the sums of m terms that follow, and
    their difference walks as sqrt(m) eps of the partial sums (eight deviations).
    Then SERVICE_ITERS calls timed with CUDA events. Returns (seconds a call, the call's
    peak device memory in bytes, its inputs' and outputs' included, the launches of the
    checked call, K's largest error, Xhat's and the residuals' largest error)."""
    from functools import partial

    from repro_torch.kernels import similarity, similarity_ref
    from repro_torch.mset import service

    g = torch.Generator(device=dev).manual_seed(n + m + b)
    D = torch.randn(m, n, generator=g, device=dev)
    Ginv = torch.randn(m, m, generator=g, device=dev) / m
    mean = torch.randn(n, generator=g, device=dev)
    std = 0.5 + torch.rand(n, generator=g, device=dev)
    X = mean + std * torch.randn(b, n, generator=g, device=dev)
    gamma, kind = float(n) ** 0.5, "inverse_distance"
    fn = partial(service._estimate_sharded, gamma=gamma, kind=kind)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    inputs = sum(t.numel() * 4 for t in (D, Ginv, mean, std, X))
    torch.cuda.reset_peak_memory_stats()
    sim_module.launches = 0
    Xhat, resid = fn(D, Ginv, mean, std, X)
    launches = sim_module.launches
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base + inputs
    label = f"the service at ({n}, {m}, {b})"
    expect(launches == 1, f"{label} launched K1 {launches} times")
    finite = bool(torch.isfinite(Xhat).all() and torch.isfinite(resid).all())
    expect(finite and resid.shape == (b, n), f"{label} is not finite")

    Xs = (X - mean) / std
    K, K_ref = similarity(D, Xs, gamma=gamma, kind=kind), similarity_ref(D, Xs, gamma, kind)
    k_err, k_ok = compare(K, K_ref, TOL, TOL)
    del K, Xs
    Xhat_ref = (Ginv @ K_ref).T @ D * std + mean
    del K_ref
    x_err, r_err = float((Xhat - Xhat_ref).abs().max()), float((resid - (X - Xhat_ref)).abs().max())
    x_bar = 8 * m**0.5 * EPS32 * float(Xhat_ref.abs().max())
    r_bar = 8 * m**0.5 * EPS32 * float((X - Xhat_ref).abs().max())
    print(
        f"  service ({n}, {m}, {b}) against its plain version: K max_abs_err {k_err:.3e} "
        f"(bar {TOL:g}), Xhat {x_err:.3e} (bar {x_bar:.3e}), residuals {r_err:.3e} "
        f"(bar {r_bar:.3e})"
    )
    expect(k_ok, f"{label}: K1 disagrees with similarity_ref: {k_err}")
    expect(x_err <= x_bar and r_err <= r_bar, f"{label} disagrees with its plain version")
    del Xhat, resid, Xhat_ref
    ms = cuda_ms(lambda: fn(D, Ginv, mean, std, X), SERVICE_ITERS)
    del D, Ginv, X
    torch.cuda.empty_cache()
    return ms / 1e3, peak, launches, k_err, max(x_err, r_err)


def sweep_cell(cell, out):
    """One cell of the dry-run sweep through its CLI, in a worker process."""
    from repro_torch.launch import dryrun

    return dryrun.main(["--arch", cell[0], "--shape", cell[1], "--out", out])[0]


def analytic_phase(dev, card, sim_module, serving, families, encdec, training):
    """Phase 17: analytic scoping (the step counted on meta tensors, on the host) held
    against what the card measured. (1) The MSET service: run_analytic over
    SERVICE_SIZES on h100-1, then each size on the card (K1 once a call), equal to its
    plain version on the same inputs and no faster than its t_compute. (2) Every LM
    step phases 8, 14, 15 and 16 timed, probed at the same arch, shape, depth and
    microbatches: no faster than its t_compute; train and decode, where the card runs
    the probe's ops, no faster than its t_step; the two training peaks within 20 % of
    the analytic one. (3) The dry-run sweep over every (arch, shape) at one chip, each
    cell through the CLI in a worker process, with its wall time and whether recommend
    finds h100-1 feasible. Returns the phase's
    record."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from functools import partial

    from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, get_config
    from repro_torch.core import H100, CellResult, Constraint, ContainerStress, get_shape
    from repro_torch.core import RooflineTerms, recommend, roofline
    from repro_torch.launch import dryrun
    from repro_torch.mset import service

    t_phase = time.perf_counter()
    print(f"== 17. analytic scoping against {card}")
    rec = {"card": card}

    # (1) the service
    h100_1 = get_shape("h100-1")
    grid = {"size": list(SERVICE_SIZES)}

    def lower(params, shape):
        fn = partial(service._estimate_sharded, gamma=1.0, kind="inverse_distance")
        return fn, tuple(service.abstract_service_inputs(*params["size"]).values())

    rows = ContainerStress(H100).run_analytic(lower, grid, [h100_1]).rows
    rec["service"], launches, k_errs = [], 0, []
    for row in rows:
        n, m, b = row.params["size"]
        seconds, peak, k1, k_err, x_err = service_on_card(dev, n, m, b, sim_module)
        launches += k1
        k_errs.append(k_err)
        t, a = row.terms, row.analysis
        print(
            f"  service ({n}, {m}, {b}): {seconds * 1e3:.4f} ms on the card; analytic "
            f"t_compute {t.t_compute * 1e3:.4f} ms, t_memory {t.t_memory * 1e3:.4f} ms "
            f"(eager bytes {a['bytes_accessed']:.3e}), t_step {t.t_step * 1e3:.4f} ms, "
            f"measured / t_step {seconds / t.t_step:.3f}; peak analytic "
            f"{a['peak_memory_per_device'] / 2**20:.1f} MiB, measured {peak / 2**20:.1f} MiB"
        )
        expect(seconds >= 0.95 * t.t_compute, f"the service at ({n}, {m}, {b}) beat t_compute")
        rec["service"].append(
            dict(
                size=[n, m, b],
                seconds=seconds,
                peak_bytes=peak,
                k_max_abs_err=k_err,
                xhat_max_abs_err=x_err,
                **t.as_dict(),
                **a,
            )
        )
    rec["service_k1_launches"] = launches
    rec["service_k1_max_abs_err"] = max(k_errs)

    # (2) the LM steps the earlier phases timed, each as (kind, arch, shape, microbatches,
    # depth cut, measured seconds, measured peak GiB or None); a decode step is probed
    # at the middle step's position (its cache's last entry), the mean over the calls'
    steps = []
    for arch, r in (
        (SERVE_ARCH, serving),
        ("olmoe-1b-7b", families["olmoe-1b-7b"]),
        ("mamba2-130m", families["mamba2-130m"]),
        ("jamba-v0.1-52b", families["jamba-v0.1-52b"]),
        (ENCDEC_ARCH, encdec[ENCDEC_ARCH]),
    ):
        served = ENCDEC_SERVE if arch == ENCDEC_ARCH else SERVE
        B, S, n = served["batch"], served["prompt_len"], served["gen_tokens"]
        cut = r.get("depth_cut", [None, None])[1]
        # an enc-dec prefill's seq_len is its source's: enc_memory_len frames, as served
        src = get_config(arch).enc_memory_len if arch == ENCDEC_ARCH else S
        prefill = ShapeSpec("p", "prefill", src, B)
        decode = ShapeSpec("d", "decode", S + n // 2 + 1, B)
        steps.append(("prefill", arch, prefill, 1, cut, min(r["prefill_s"]), None))
        steps.append(("decode", arch, decode, 1, cut, min(r["decode_s"]) / (n - 1), None))
    for job in (TRAIN_JOB, DENSE_TRAIN):
        r = training[job["arch"]]
        shape = ShapeSpec("t", "train", job["seq_len"], job["global_batch"])
        mb, cut = job["n_microbatches"], job.get("n_layers")
        steps.append(("train", job["arch"], shape, mb, cut, r["step_s"], r["peak_gib"]))
    rec["steps"] = []
    print(
        f"  {'step':34s} {'measured ms':>11s} {'t_compute':>9s} {'t_memory':>9s} {'t_step':>9s} "
        f"{'t_step/meas':>11s} {'peak GiB':>9s} {'measured':>8s}"
    )
    for kind, arch, shape, mb, cut, seconds, peak_gib in steps:
        cfg = get_config(arch)
        cfg = cfg.replace(n_layers=cut) if cut else cfg
        t0 = time.perf_counter()
        cost = dryrun.probe_cost(arch, shape, n_microbatches=mb, cfg_base=cfg)
        mem, _ = dryrun.memory_cost(arch, shape, n_microbatches=mb, cfg_base=cfg)
        probe_s = time.perf_counter() - t0
        t = roofline(cost.flops, cost.bytes_accessed, cost.collective_bytes, 1, H100)
        peak = mem.peak_memory_per_device / 2**30
        name = f"{arch}{f' ({cut} layers)' if cut else ''} {kind}"
        print(
            f"  {name:34s} {seconds * 1e3:11.3f} {t.t_compute * 1e3:9.3f} {t.t_memory * 1e3:9.3f} "
            f"{t.t_step * 1e3:9.3f} {t.t_step / seconds:11.3f} {peak:9.2f} "
            f"{'-' if peak_gib is None else f'{peak_gib:8.2f}'} (probed in {probe_s:.1f} s)"
        )
        expect(seconds >= 0.95 * t.t_compute, f"{name}: {seconds} s beat t_compute {t.t_compute}")
        if kind != "prefill":  # the card runs the probe's ops (no K2): the bytes bound too
            expect(seconds >= 0.95 * t.t_step, f"{name}: {seconds} s beat t_step {t.t_step}")
        if peak_gib is not None:
            ratio = peak_gib / peak
            print(f"    measured peak / analytic peak = {ratio:.4f}")
            expect(abs(ratio - 1) <= 0.2, f"{name}: peak {peak_gib} GiB against {peak} GiB")
        rec["steps"].append(
            dict(
                step=name,
                seconds=seconds,
                flops=cost.flops,
                bytes_accessed=cost.bytes_accessed,
                **t.as_dict(),
                analytic_peak_gib=peak,
                measured_peak_gib=peak_gib,
                probe_s=probe_s,
            )
        )

    # (3) the dry-run sweep over every (arch, shape), one chip, on the host
    cells = [(a, s_) for a in ARCH_IDS for s_ in SHAPES]
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out:
        with ProcessPoolExecutor(min(SWEEP_WORKERS, os.cpu_count()), mp_context=ctx) as pool:
            recs = list(pool.map(partial(sweep_cell, out=out), cells))
    sweep_s = time.perf_counter() - t0
    rec["sweep"] = []
    for r in recs:
        if r["status"] != "ok":
            print(f"  sweep {r['arch']:22s} {r['shape']:12s} skip: {r['reason']}")
            rec["sweep"].append(dict(arch=r["arch"], shape=r["shape"], status=r["status"]))
            continue
        terms = RooflineTerms(r["t_compute"], r["t_memory"], r["t_collective"])
        row = CellResult(
            params={},
            shape_name="h100-1",
            terms=terms,
            analysis={"peak_memory_per_device": r["peak_memory_per_device"]},
        )
        fits = recommend([row], Constraint()).shape is not None
        print(
            f"  sweep {r['arch']:22s} {r['shape']:12s} t_step {r['t_step'] * 1e3:12.3f} ms "
            f"({r['dominant']}), peak {r['peak_memory_per_device'] / 2**30:9.2f} GiB, h100-1 "
            f"{'feasible' if fits else 'infeasible'}"
        )
        rec["sweep"].append(
            dict(
                arch=r["arch"],
                shape=r["shape"],
                status="ok",
                t_step=r["t_step"],
                dominant=r["dominant"],
                peak_memory_per_device=r["peak_memory_per_device"],
                h100_1_feasible=fits,
            )
        )
    print(f"  the dry-run sweep: {len(cells)} cells in {sweep_s:.1f} s of wall time")
    fits = {(r["arch"], r["shape"]): r.get("h100_1_feasible") for r in rec["sweep"]}
    expect(not fits["minitron-4b", "train_4k"], "minitron-4b's train_4k fits one H100")
    rec["sweep_s"] = sweep_s
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  the analytic phase took {rec['phase_s']:.1f} s")
    return rec


def timed_generate(model, prompts, gen_tokens):
    """(greedy tokens, prefill's last-token logits, prefill seconds, seconds a decode
    step) of one prefill and gen_tokens - 1 greedy steps, each part ended by a
    synchronize."""
    from repro_torch.launch.serve import decode_greedy

    B, P = prompts.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = model.prefill(prompts, model.init_cache(B, P + gen_tokens))
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = decode_greedy(model, cache, logits, P, gen_tokens)
    torch.cuda.synchronize()
    t_step = (time.perf_counter() - t0) / (gen_tokens - 1)
    full = getattr(logits, "full_tensor", lambda: logits)
    return toks, full(), t_prefill, t_step


def sharded_phase(dev, card, flash_module, sim_module):
    """Phase 18: sharding on a one-card mesh, then analytic scoping across the catalog.
    (1) minitron-4b at full width served at phase 8's shape through
    ``Model.shard(make_rules(make_dev_mesh()))`` (a (1, 1) mesh on a process group of
    one): its greedy tokens equal to the unsharded path's, its prefill logits within 4
    bf16 ulps of the largest, K2 launched on the local shards (counted from 0 around
    the timed call), prefill and decode step timed beside the unsharded ones. (2) the
    MSET service through ``make_service`` on that mesh at phase 17's full-width size: K
    (``sharded_similarity``, K1 on the local shards) against ``similarity_ref`` at 5e-6,
    Xhat and residuals against the unsharded service within phase 17's bar, K1 launched,
    timed beside it. (3) with the process group gone, the dry-run's SHARDED_CELLS on
    pod16x16 (meta tensors in a fake world of 256 ranks, on the host) and
    ``run_lm(*SHARDED_SCOPE)`` over v5e-64 ... 2x-v5e-256 with its recommendation.
    Returns the phase's record."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_rules, place
    from repro_torch.kernels import similarity_ref
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.scope import run_lm
    from repro_torch.models import build_model
    from repro_torch.mset import MSETModel
    from repro_torch.mset.service import _estimate_sharded, make_service, sharded_similarity

    print(f"== 18. sharding: a one-card mesh, then the catalog's meshes ({card})")
    t_phase = time.perf_counter()
    rec = {}
    started = not dist.is_initialized()
    mesh = make_dev_mesh(device_type="cuda")
    expect(tuple(mesh.shape) == (1, 1), f"the one-card mesh is {tuple(mesh.shape)}")
    rules = make_rules(mesh)

    cfg = get_config(SERVE_ARCH)
    B, P, gen = SHARDED_SERVE["batch"], SHARDED_SERVE["prompt_len"], SHARDED_SERVE["gen_tokens"]
    g = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, dev, g)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev)
    timed_generate(model, prompts, gen)  # warm-up
    toks0, logits0, pre0, step0 = timed_generate(model, prompts, gen)
    model.shard(rules)
    expect(all(hasattr(p, "placements") for p in model.parameters()), "a parameter is not placed")
    timed_generate(model, prompts, gen)  # warm-up: DTensor's sharding propagation
    flash_module.launches = 0
    toks, logits, pre, step = timed_generate(model, prompts, gen)
    k2 = flash_module.launches
    toks = getattr(toks, "full_tensor", lambda: toks)()
    ulp = 2.0**-8 * float(logits0.float().abs().max())
    err = float((logits.float() - logits0.float()).abs().max())
    same = bool((toks == toks0).all())
    print(
        f"  {cfg.name} at full width, {B} x {P} tokens, {gen} greedy tokens, on the (1, 1) "
        f"mesh: prefill {pre:.4f} s (unsharded {pre0:.4f} s), decode step {step * 1e3:.2f} ms "
        f"(unsharded {step0 * 1e3:.2f} ms)"
    )
    print(
        f"  prefill logits max_abs_err {err:.3e} (bar 4 bf16 ulps of the largest, {4 * ulp:.3e}); "
        f"the same greedy tokens: {same}; K2 launches on the local shards: {k2}"
    )
    expect(same, "the sharded path's greedy tokens differ from the unsharded path's")
    expect(err <= 4 * ulp, f"sharded prefill logits off by {err}")
    expect(k2 > 0, "the sharded serving path never launched K2")
    expect(k2 == cfg.n_layers, f"expected {cfg.n_layers} K2 launches a sharded call, got {k2}")
    rec.update(
        serve=dict(
            prefill_s=pre,
            prefill_unsharded_s=pre0,
            step_s=step,
            step_unsharded_s=step0,
            logits_max_abs_err=err,
            same_tokens=same,
        ),
        k2_launches=k2,
    )
    del model, logits, logits0, prompts
    torch.cuda.empty_cache()

    n, m, b = SHARDED_SERVICE
    g = torch.Generator(device=dev).manual_seed(n + m + b)
    D = torch.randn(m, n, generator=g, device=dev)
    Ginv = torch.randn(m, m, generator=g, device=dev) / m
    mean = torch.randn(n, generator=g, device=dev)
    std = 0.5 + torch.rand(n, generator=g, device=dev)
    X = mean + std * torch.randn(b, n, generator=g, device=dev)
    gamma, kind = float(n) ** 0.5, "inverse_distance"
    est = make_service(MSETModel(D, Ginv, gamma, kind, mean, std), mesh)
    est(X)  # warm-up
    sim_module.launches = 0
    Xhat, resid = est(X)
    torch.cuda.synchronize()
    k1 = sim_module.launches
    Xhat, resid = Xhat.full_tensor(), resid.full_tensor()
    Xhat0, resid0 = _estimate_sharded(D, Ginv, mean, std, X, gamma=gamma, kind=kind)
    Xs = (X - mean) / std
    rows = (mesh, est.inputs["D"].placements)
    K = sharded_similarity(est.inputs["D"], place(Xs, rows), gamma, kind).full_tensor()
    k_err, k_ok = compare(K, similarity_ref(D, Xs, gamma, kind), TOL, TOL)
    del K
    x_err, r_err = float((Xhat - Xhat0).abs().max()), float((resid - resid0).abs().max())
    x_bar = 8 * m**0.5 * EPS32 * float(Xhat0.abs().max())
    r_bar = 8 * m**0.5 * EPS32 * float(resid0.abs().max())
    ms = cuda_ms(lambda: est(X), SERVICE_ITERS)
    unsharded = partial(_estimate_sharded, gamma=gamma, kind=kind)
    ms0 = cuda_ms(lambda: unsharded(D, Ginv, mean, std, X), SERVICE_ITERS)
    print(
        f"  make_service ({n}, {m}, {b}) on the mesh: K max_abs_err {k_err:.3e} (bar {TOL:g}), "
        f"Xhat {x_err:.3e} (bar {x_bar:.3e}), residuals {r_err:.3e} (bar {r_bar:.3e}) against "
        f"the unsharded service; K1 launches {k1}; {ms:.3f} ms a call (unsharded {ms0:.3f} ms)"
    )
    expect(k_ok, f"the sharded service's K disagrees with similarity_ref: {k_err}")
    expect(x_err <= x_bar and r_err <= r_bar, "the sharded service disagrees with the unsharded")
    expect(k1 > 0, "the sharded service never launched K1")
    rec["service"] = dict(
        size=SHARDED_SERVICE,
        ms=ms,
        unsharded_ms=ms0,
        k_max_abs_err=k_err,
        xhat_max_abs_err=x_err,
        resid_max_abs_err=r_err,
    )
    rec["k1_launches"], rec["k1_max_abs_err"] = k1, k_err
    del D, Ginv, X, Xs, Xhat, resid, Xhat0, resid0, est
    torch.cuda.empty_cache()
    if started:
        dist.destroy_process_group()

    cells = {}
    with tempfile.TemporaryDirectory() as out:
        for arch, shape in SHARDED_CELLS:
            t0 = time.perf_counter()
            r = dryrun.run_cell(arch, shape, mesh_name="pod16x16", out_dir=out, verbose=False)
            secs = time.perf_counter() - t0
            expect(r["status"] == "ok", f"{arch} x {shape} on pod16x16: {r}")
            kinds = {k: float(v) for k, v in r["collective_bytes_by_kind"].items()}
            print(
                f"  {arch} x {shape} x pod16x16 (analytic, v5e's cost model): flops "
                f"{r['flops']:.4e}, collective bytes {r['collective_bytes']:.4e} {kinds}, "
                f"{r['peak_memory_per_device'] / 2**30:.2f} GiB a device, t_step "
                f"{r['t_step'] * 1e3:.2f} ms ({r['dominant']}); counted in {secs:.1f} s"
            )
            cells[f"{arch} x {shape}"] = dict(
                flops=r["flops"],
                collective_bytes=r["collective_bytes"],
                collective_bytes_by_kind=kinds,
                peak_gib=r["peak_memory_per_device"] / 2**30,
                t_step=r["t_step"],
                dominant=r["dominant"],
                seconds=secs,
            )
    a2a = cells["olmoe-1b-7b x train_4k"]["collective_bytes_by_kind"].get("all-to-all", 0)
    expect(a2a > 0, "olmoe's expert-parallel cell counted no all-to-all")
    t0 = time.perf_counter()
    scoped = run_lm(*SHARDED_SCOPE)
    expect(scoped is not None, f"run_lm{SHARDED_SCOPE} did not apply")
    rows, best = scoped
    expect(len(rows) == 4, f"run_lm scoped {len(rows)} shapes, expected v5e-64 ... 2x-v5e-256")
    rec["cells"] = cells
    rec["scope"] = dict(
        rows={r.shape_name: r.terms.t_step for r in rows},
        recommendation=best.shape.name if best.shape else None,
        seconds=time.perf_counter() - t0,
    )
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  the sharding phase took {rec['phase_s']:.1f} s")
    return rec


def checked(label, fn, *args):
    """Run one of the shared CPU-test checks (tests/torch_fleet_cases.py) on the card;
    a failed assertion in it fails the smoke run."""
    try:
        fn(*args)
    except AssertionError as e:
        raise SmokeFailure(f"{label}: {e}") from e


def profile_counts(fn):
    """What ``fn`` asked of the card, from torch.profiler: kernel launches by name,
    copies and memsets, the host's CUDA synchronisations (stream and device
    synchronises, and blocking copies), and the share of ``fn``'s wall time (under the
    profiler) that the card spent in its kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, copies, syncs, busy_us = {}, 0, 0, 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            if e.key.startswith(("Memcpy", "Memset")):
                copies += e.count
            else:
                kernels[e.key] = e.count
                us = getattr(e, "self_device_time_total", None)
                busy_us += getattr(e, "self_cuda_time_total", 0) if us is None else us
        elif e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy"):
            syncs += e.count
    return kernels, copies, syncs, busy_us / wall_us


def timed_dispatches(fn, warm=FLEET_WARM):
    """Host-clock seconds of a call of ``fn`` (the cold dispatch: the eager loop), of
    a second (the capture and a replay) and of ``warm`` more (replays), each ended by
    a synchronize; and the first and last calls' results."""
    times, outs = [], []
    for _ in range(2 + warm):
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del outs[1:-1]
    return times, outs[0], outs[-1]


def same_outputs(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def dispatch_times(item):
    """One line of a fleet case's times: cold, capture, warm and (where measured)
    numpy, with the warm dispatch's speed-ups (its best of the warm runs)."""
    warm = min(item["warm_s"])
    text = (
        f"cold {item['cold_s']:.3f} s (the eager loop, {item['cold_s'] / warm:.1f}x the "
        f"warm time), capture {item['capture_s']:.3f} s (capture + replay), warm "
        f"{', '.join(f'{t:.3f}' for t in item['warm_s'])} s (replays)"
    )
    if "numpy_s" in item:
        text += f", numpy {item['numpy_s']:.3f} s ({item['numpy_s'] / warm:.1f}x the warm time)"
    return text


def fleet_phase(dev, card):
    """Phase 10: the fleet simulator's compiled backend (``backend="torch"``) on the
    card against the port's numpy engine. Returns the fleet JSON record."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fleet_cases import (
        DISCIPLINES,
        FAMILIES,
        GOLDEN,
        SUBSTEP_GRID,
        bit_gap,
        check_forecaster,
        check_kernel_steps,
        check_lattice,
        check_replay,
        coarse_gap,
        fidelity_run,
        flash_slate,
        substep_run,
    )

    from repro_torch.fleet import PredictivePolicy, simulate_fleet, torchsim
    from repro_torch.fleet.kernels import _ages, _window_sum, div, seq_sum0

    on_card = dict(backend="torch", device=dev)
    rec = {"card": card}
    print(f"== 10. the fleet simulator's compiled backend on {card}")
    t_phase = time.perf_counter()

    # The order of the window sums, and the reason no tensor is divided by a number.
    rng = np.random.default_rng(0)
    for shape in ((48, 512, 12), (12, 24, 12), (9, 1, 1), (30,)):
        x = rng.random(shape) * np.exp(rng.normal(0, 6, shape))
        want = x[0].copy()
        for row in x[1:]:
            want = want + row
        got = seq_sum0(torch.from_numpy(x).to(dev)).cpu().numpy()
        expect(np.array_equal(got, want), f"window sum {shape} is not left to right on the card")
    # one seed: numpy sums a window pairwise, and so must the kernels (up to 240 bins)
    for W in (20, 48, 240):
        x = rng.random((W, 64, 1)) * np.exp(rng.normal(0, 6, (W, 64, 1)))
        w = rng.integers(1, W + 1, (64, 1)).astype(float)
        got = _window_sum(torch.from_numpy(x).to(dev), _ages(W, dev), torch.from_numpy(w).to(dev))
        want = [np.ascontiguousarray(x[W - int(k):, i]).sum(axis=0) for i, k in enumerate(w[:, 0])]
        expect(np.array_equal(got.cpu().numpy(), np.array(want)), f"one-seed window sum {W}")
    x = torch.from_numpy(rng.random(1 << 20) * 1e3).to(dev)
    y = x.cpu().numpy() / 3.7
    rec["host_scalar_div_ulp_mismatches"] = int((x / 3.7).cpu().numpy().__ne__(y).sum())
    expect(np.array_equal(div(x, 3.7).cpu().numpy(), y), "div() is not the IEEE quotient")
    print(
        "  window sums add left to right (cumsum along an outer dim), and pairwise as numpy "
        "does with one seed, bit for bit; "
        f"x / 3.7 by a host scalar differs from the IEEE quotient in "
        f"{rec['host_scalar_div_ulp_mismatches']} of {x.numel()} doubles (div() in none)"
    )

    # 1. Golden scenarios and the substep grid, at tests/test_jax_backend.py's and
    #    tests/test_substep.py's bars; the policy kernels step by step; the lattice.
    golden = {}
    for name, run in GOLDEN.items():
        err, q_err, ok = coarse_gap(run(), run(**on_card))
        golden[name] = err
        print(f"  golden {name:24s} max |torch - numpy| {err:.3e}, sojourn quantiles {q_err:.1e}")
        expect(ok, f"golden scenario {name} misses the coarse bar on the card")
    for disc in DISCIPLINES:
        for n_sub, pre in SUBSTEP_GRID:
            ref = substep_run(disc, n_sub, pre)
            same, err = bit_gap(ref, substep_run(disc, n_sub, pre, **on_card))
            expect(same, f"substep {disc} n={n_sub} pre={pre} not bit-exact ({err:.3e})")
    print(f"  substep grid {DISCIPLINES} x {SUBSTEP_GRID}: bit-exact")
    for family in FAMILIES:
        checked(f"policy kernel {family}", check_kernel_steps, family, dev)
    checked("forecaster", check_forecaster, dev)
    checked("lattice", check_lattice, dev)
    checked("graph replay", check_replay, dev)
    print(
        f"  policy kernels {FAMILIES}, the forecaster and a tiled lattice: identical to numpy; "
        "a graph replayed on another slate of its signature (other knobs, arrivals and "
        "cold-start jitter) at the coarse bar"
    )
    rec["golden_max_abs_err"] = golden
    print(f"  ({time.perf_counter() - t_phase:.1f} s into the phase)")

    # 2. The tuning round at the size users race: the first dispatch of a signature
    #    runs the loop eagerly (cold), the second captures it and replays the graph,
    #    the next ones replay it (warm); beside them numpy.
    lattices = []
    for n, seeds, duration, tile, rows in FLEET_LATTICES:
        # free the earlier graphs' memory; policy kernels are cached by make_kernel, so
        # no kernel's id() is reused
        torchsim.clear_compiled()
        wl, fleet, params, ctx = flash_slate(n, n_seeds=seeds, duration=duration)
        pols = [PredictivePolicy.from_params(p, **ctx) for p in params]
        kernel, kw = torchsim.slate_arguments(wl, fleet, pols)
        torch.cuda.reset_peak_memory_stats()
        times, eager, out = timed_dispatches(
            lambda: torchsim.run_dynamics(kernel, **kw, tile=tile, device=dev)
        )
        peak = torch.cuda.max_memory_allocated()
        expect(same_outputs(eager, out), f"lattice {n}: the graph's outputs differ from eager")
        sims = torchsim.slate_results(
            wl, fleet, [pols[i] for i in rows], {k: v[list(rows)] for k, v in out.items()}
        )
        errs = []
        for i, sim in zip(rows, sims):
            ref = simulate_fleet(wl, fleet, PredictivePolicy.from_params(params[i], **ctx))
            err, q_err, ok = coarse_gap(ref, sim)
            errs.append(err)
            expect(ok, f"lattice {n}: candidate {i} misses the coarse bar against numpy")
        item = dict(
            candidates=n,
            seeds=seeds,
            bins=wl.n_bins,
            tile=tile,
            cold_s=times[0],
            capture_s=times[1],
            warm_s=times[2:],
            peak_gib=peak / 2**30,
            rows_checked=list(rows),
            max_abs_err=max(errs),
        )
        if n == FLEET_LATTICES[0][0]:
            t0 = time.perf_counter()
            for p in params:
                simulate_fleet(wl, fleet, PredictivePolicy.from_params(p, **ctx))
            item["numpy_s"] = time.perf_counter() - t0
        lattices.append(item)
        print(
            f"  lattice {n} x {seeds} x {wl.n_bins} bins (tile {tile}): "
            + dispatch_times(item)
            + f"; peak {peak / 2**30:.3f} GiB; eager outputs identical; rows {rows} at the "
            f"coarse bar, max |torch - numpy| {max(errs):.3e} ({card})"
        )
        del out, eager, sims
    rec["lattices"] = lattices
    print(f"  ({time.perf_counter() - t_phase:.1f} s into the phase)")

    # Kernels a bin (the graph's nodes) and host synchronisations, from torch.profiler
    # over the eager loop at two lengths: the loop never waits for the card, which is
    # what lets it be captured. Then the card's busy share over a warm dispatch.
    launches = {}
    for label, (n, seeds, durations) in FLEET_PROFILE.items():
        sub = dict(n_substeps=4, preemptive=True) if label == "substep" else {}
        counts = []
        for duration in durations:
            wl, fleet, params, ctx = flash_slate(n, n_seeds=seeds, duration=duration)
            pols = [PredictivePolicy.from_params(p, **ctx) for p in params]
            kernel, kw = torchsim.slate_arguments(wl, fleet, pols)
            statics, args = torchsim.core_inputs(**kw, **sub, n_pad=torchsim._pad_pow2(n))
            core = torchsim._build_core(kernel, **statics)
            inputs = torchsim.to_device(args, dev)

            def eager():
                with torch.no_grad():
                    core(*inputs)

            eager()  # warm-up
            kernels, copies, syncs, busy = profile_counts(eager)
            counts.append((wl.n_bins, sum(kernels.values()), copies, syncs, kernels, busy))
        (b0, k0, c0, s0, _, _), (b1, k1, c1, s1, by_name, busy) = counts
        expect(k1 > k0 > 0, f"torch.profiler saw no kernels in the {label} loops")
        expect(s1 == s0, f"host synchronisations grow with the bins in the {label} loop")
        for _ in range(2):  # the eager loop, then the capture
            torchsim.run_dynamics(kernel, **kw, **sub, device=dev)
        g_kernels, _, g_syncs, g_busy = profile_counts(
            lambda: torchsim.run_dynamics(kernel, **kw, **sub, device=dev)
        )
        per_bin = (k1 - k0) / (b1 - b0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        launches[label] = dict(
            bins=[b0, b1],
            kernels=[k0, k1],
            copies=[c0, c1],
            host_syncs=[s0, s1],
            kernels_per_bin=per_bin,
            top_kernels_per_bin={k: v / b1 for k, v in top},
            eager_busy_share=busy,
            graph_kernels=sum(g_kernels.values()),
            graph_host_syncs=g_syncs,
            graph_busy_share=g_busy if g_kernels else None,
        )
        print(
            f"  {label} loop, {n} candidates x {seeds} seeds x {b0} / {b1} bins: "
            f"{k0} / {k1} kernels ({per_bin:.1f} a bin), {c0} / {c1} copies and memsets, "
            f"{s0} / {s1} host synchronisations; run eagerly, kernels busy the card "
            f"{busy:.1%} of its wall time under the profiler; as a warm dispatch (graph "
            f"replay, input and output copies) {sum(g_kernels.values())} kernels, "
            + (f"busy {g_busy:.1%}" if g_kernels else "busy share not measured")
            + f" ({card})"
        )
        print("    most launched a bin: " + ", ".join(f"{k[:40]} {v / b1:.1f}" for k, v in top))
    rec["launches"] = launches
    print(f"  ({time.perf_counter() - t_phase:.1f} s into the phase)")

    # 3. The substep engine: sim_perf.py's SUBSTEP_CELL, and its fidelity workload
    #    under preemptive EDF, each on the card against numpy, bit for bit.
    torchsim.clear_compiled()
    n, seeds, duration = FLEET_SUBSTEP_CELL
    sub = dict(n_substeps=4, preemptive=True)
    wl, fleet, params, ctx = flash_slate(n, n_seeds=seeds, duration=duration)
    pols = [PredictivePolicy.from_params(p, **ctx) for p in params]
    kernel, kw = torchsim.slate_arguments(wl, fleet, pols)
    times, eager, out = timed_dispatches(
        lambda: torchsim.run_dynamics(kernel, **kw, **sub, device=dev)
    )
    expect(same_outputs(eager, out), "substep cell: the graph's outputs differ from eager")
    sims = torchsim.slate_results(wl, fleet, pols, out, **sub)
    t0 = time.perf_counter()
    refs = [
        simulate_fleet(wl, fleet, PredictivePolicy.from_params(p, **ctx), **sub) for p in params
    ]
    numpy_s = time.perf_counter() - t0
    for i, (ref, sim) in enumerate(zip(refs, sims)):
        same, err = bit_gap(ref, sim)
        expect(same, f"substep cell candidate {i} not bit-exact ({err:.3e})")
    rec["substep_cell"] = dict(
        candidates=n,
        seeds=seeds,
        bins=wl.n_bins,
        n_substeps=4,
        preemptive=True,
        cold_s=times[0],
        capture_s=times[1],
        warm_s=times[2:],
        numpy_s=numpy_s,
        bit_exact=True,
    )
    print(
        f"  substep cell {n} x {seeds} x {wl.n_bins} bins, n_substeps 4, preemptive: "
        + dispatch_times(rec["substep_cell"])
        + f"; all {n} bit-exact ({card})"
    )
    t0 = time.perf_counter()
    ref = fidelity_run(*FLEET_FIDELITY)
    numpy_s = time.perf_counter() - t0
    times, eager, sim = timed_dispatches(lambda: fidelity_run(*FLEET_FIDELITY, **on_card))
    same, err = bit_gap(ref, sim)
    expect(bit_gap(eager, sim)[0], "fidelity case: the graph's result differs from eager")
    n_pre = float(sim.preemptions.sum())
    expect(same, f"fidelity case not bit-exact ({err:.3e})")
    expect(n_pre > 0, "the fidelity case never preempted")
    rec["fidelity"] = dict(
        bins=sim.served.shape[1],
        seeds=sim.served.shape[0],
        classes=len(sim.classes),
        cold_s=times[0],
        capture_s=times[1],
        warm_s=times[2:],
        numpy_s=numpy_s,
        preemptions=n_pre,
        bit_exact=True,
    )
    print(
        f"  fidelity (tiered-SLA, EDF, preemptive, {sim.served.shape[0]} seeds x "
        f"{sim.served.shape[1]} bins), each a simulate call: "
        + dispatch_times(rec["fidelity"])
        + f"; {n_pre:.0f} preemptions, bit-exact ({card})"
    )
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  the fleet phase took {rec['phase_s']:.1f} s")
    torchsim.clear_compiled()
    torch.cuda.empty_cache()
    return rec


def example_phase(dev, card, counted):
    """Phase 11: ``examples/torch_scope_containers.py``'s ``main()`` on the card, with
    the kernels' counts set to 0 just before it and read just after. Returns its record."""
    print(f"== 11. the paper's scoping example on {card}")
    path = os.path.join(ROOT, "examples", "torch_scope_containers.py")
    spec = importlib.util.spec_from_file_location("torch_scope_containers", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for module in counted.values():
        module.launches = 0
    t0 = time.perf_counter()
    fig = example.main(dev)
    seconds = time.perf_counter() - t0
    launches = {name: module.launches for name, module in counted.items()}
    print(f"  kernel launches during the example: {launches}; it took {seconds:.1f} s")
    expect(launches["similarity"] > 0, "the example never launched the similarity kernel")
    r2 = fig["surface_r2"]
    expect(np.isfinite(r2), "the example's response surface is not finite")
    record = dict(card=card, seconds=seconds, surface_r2=r2, launches=launches)
    for label in ("customer_a", "customer_b"):
        rec = fig[label]
        expect(rec["shape"] is not None, f"no shape for {label}")
        record[label] = dict(shape=rec["shape"], ranking=rec["ranking"])
        print(f"  {label}: {rec['shape']} ({rec['reason']}); r^2 of the surface {r2:.4f}")
    return record


def walk_spans(spans):
    for span in spans:
        yield span
        yield from walk_spans(span.children)


def dispatch_record(tel):
    """Count and seconds of the ``torchsim.dispatch`` spans of a telemetry session, by
    ``path`` (eager, capture or replay), and its ``torchsim_dispatch_total`` counter."""
    paths = {}
    for span in walk_spans(tel.tracer.roots):
        if span.name == "torchsim.dispatch":
            item = paths.setdefault(span.attrs["path"], {"count": 0, "seconds": 0.0})
            item["count"] += 1
            item["seconds"] += span.duration_s
    counters = tel.metrics.snapshot()["counter"].get("torchsim_dispatch_total", {})
    return {"by_path": paths, "dispatch_total": counters}


def control_world(backend, device):
    """benchmarks/closed_loop.py --full's nominal tuning scenario and drifted live case,
    from the port (``CONTROL``), its scenario on ``backend`` and ``device``. Returns
    (scenario, case, shape)."""
    from repro_torch.core import recommend
    from repro_torch.fleet import (
        FleetConfig,
        PIPolicy,
        Workload,
        diurnal_trace,
        mset_scenario,
        service_degradation_case,
        tuning_scenario,
    )

    c = CONTROL
    scenario = mset_scenario(
        n_signals=c["n_signals"], n_memvec=c["n_memvec"], fleet=c["fleet"], slo_s=c["slo_s"]
    )
    shape = recommend(scenario.rows_at(), scenario.constraint()).shape.name
    mean_rate = c["mean_mult"] * scenario.service_for(shape).max_throughput
    kw = dict(dt_s=c["dt_s"], amplitude=c["amplitude"], period_s=c["duration_s"])
    mc = diurnal_trace(
        mean_rate, c["duration_s"], n_seeds=c["mc_seeds"], seed=c["seed"] + 1, **kw
    )
    live = diurnal_trace(
        mean_rate, c["duration_s"], n_seeds=c["live_seeds"], seed=c["seed"] + 101, **kw
    )
    pool = scenario.pool_for(shape, cold_start_s=c["cold_start_s"], max_replicas=c["quota"])
    fleet = FleetConfig((pool,), max_queue=2.0 * mean_rate * c["dt_s"])
    ts = tuning_scenario(
        scenario,
        mc,
        PIPolicy,
        fleet=fleet,
        cold_start_s=c["cold_start_s"],
        backend=backend,
        device=device,
        name="mset-diurnal/pi",
    )
    case = service_degradation_case(
        Workload.from_trace(live, scenario.slo_s),
        fleet,
        factor=c["drift_factor"],
        t_drift_frac=c["t_drift_frac"],
    )
    return ts, case, shape


def control_phase(dev, card, counted):
    """Phase 12: the autonomous loop at full width (``CONTROL``, ``ORACLE``): the
    incumbent tune, the closed-loop controller on a drift, the drift probe and the
    scoping oracle, each on the card (``backend="torch"``, probe on the card) against
    the port on numpy and the CPU. Returns the control JSON record."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_control_cases import events_of, same_evals

    from repro_torch.fleet import (
        ClosedLoopController,
        Objective,
        OracleGrid,
        PIPolicy,
        ScopingOracle,
        TraceFeatures,
        TuningBudget,
        build_oracle,
        query_latency_us,
        telemetry,
        torchsim,
        tune,
        verify_oracle,
        window_metrics,
    )
    from repro_torch.fleet.telemetry.drift import DriftProbe, telemetry_matrix
    from repro_torch.kernels import similarity_cuda, similarity_ref
    from repro_torch.mset import MSETModel, estimate

    c = CONTROL
    print(f"== 12. the autonomous loop at full width on {card}")
    t_phase = time.perf_counter()
    torchsim.clear_compiled()  # free phase 10's graphs
    ts_np, case, shape = control_world("numpy", "cpu")
    ts_card, _, _ = control_world("torch", dev)
    T, td = case.n_bins, case.drift_bins()[0]
    rec = {"card": card, "shape": shape, "bins": T, "mc_seeds": ts_np.n_seeds}
    objective = Objective(min_attainment=c["tune_bar"], penalty_usd_per_hour=c["penalty"])
    space = PIPolicy.param_space()
    budget = TuningBudget(n_candidates=c["tune_candidates"], init_seeds=c["init_seeds"])

    # 1. The incumbent tune: numpy, then the card in a telemetry session (its spans).
    t0 = time.perf_counter()
    inc_np = tune(ts_np, space, objective, budget, seed=c["seed"])
    tune_np_s = time.perf_counter() - t0
    with telemetry.session() as tel:
        t0 = time.perf_counter()
        inc_card = tune(ts_card, space, objective, budget, seed=c["seed"])
        tune_card_s = time.perf_counter() - t0
    expect(inc_card.winner.params == inc_np.winner.params, "the card's tune picks another winner")
    expect(inc_card.sims_used == inc_np.sims_used, "the card's tune spends another budget")
    expect(same_evals(inc_np.evals, inc_card.evals), "the card's tune differs from numpy's")
    rec["tune"] = dict(
        card_s=tune_card_s,
        numpy_s=tune_np_s,
        sims_used=inc_card.sims_used,
        winner=inc_card.winner.params,
        **dispatch_record(tel),
    )
    print(
        f"  incumbent tune ({T} bins, {ts_np.n_seeds} seeds, {c['tune_candidates']} "
        f"candidates): card {tune_card_s:.3f} s, numpy {tune_np_s:.3f} s; equal winner "
        f"{inc_card.winner.params}, {inc_card.sims_used} sims, per-seed arrays bit for bit; "
        f"dispatches {rec['tune']['by_path']}"
    )

    # 2. The controller on the drift: numpy with the probe on the CPU, then the card with
    #    the kernels' counts set to 0 just before and read just after.
    retune = TuningBudget(n_candidates=c["retune_candidates"], init_seeds=c["init_seeds"])
    kw = dict(segment_bins=c["segment_bins"], retune_budget=retune, objective=objective)
    t0 = time.perf_counter()
    res_np = ClosedLoopController(ts_np, inc_np, **kw).run(case)
    ctl_np_s = time.perf_counter() - t0
    ctl_card = ClosedLoopController(ts_card, inc_card, **kw)
    for module in counted.values():
        module.launches = 0
    with telemetry.session() as tel:
        t0 = time.perf_counter()
        res = ctl_card.run(case)
        ctl_card_s = time.perf_counter() - t0
    launches = {name: module.launches for name, module in counted.items()}
    print(f"  kernel launches during the controller's run: {launches}")
    expect(launches["similarity"] > 0, "the controller never launched the similarity kernel")
    expect(launches["sprt"] > 0, "the controller never launched the SPRT kernel")
    expect(events_of(res) == events_of(res_np), "the card's controller decides otherwise")
    expect(res.est_factor == res_np.est_factor, "the card's degradation estimate differs")
    expect(res.active_params == res_np.active_params, "the card's controller swaps otherwise")
    alarm = next((e.t_bin for e in res.events if e.kind == "drift-alarm"), None)
    swap = next((e.t_bin for e in res.events if e.kind == "swap"), None)
    t_rec = td if swap is None else min(swap + int(c["cold_start_s"] / c["dt_s"]), T - 1)
    rec["controller"] = dict(
        card_s=ctl_card_s,
        numpy_cpu_s=ctl_np_s,
        events=events_of(res),
        drift_bin=td,
        first_alarm_bin=alarm,
        detection_delay_bins=None if alarm is None else alarm - td,
        swap_bin=swap,
        est_factor=res.est_factor,
        active_params=res.active_params,
        post_swap_worst_class_attainment=window_metrics(res.sim, t_rec).worst_class_attainment,
        post_drift_usd_per_hour=window_metrics(res.sim, td, T).usd_per_hour,
        retune_sims=[r.sims_used for r in res.retunes],
        launches=launches,
        **dispatch_record(tel),
    )
    print(
        f"  controller: card {ctl_card_s:.3f} s, numpy with the probe on the CPU "
        f"{ctl_np_s:.3f} s; the same events {events_of(res)}, est_factor {res.est_factor}, "
        f"active {res.active_params}; drift at bin {td}, alarm at {alarm}, swap at {swap}; "
        "post-swap worst-class attainment "
        f"{rec['controller']['post_swap_worst_class_attainment']:.4f}"
    )

    # 3. The probe on the card against the CPU on the same windows: the live run's
    #    segments, fitted on the incumbent's model-predicted telemetry. K1 at the probe's
    #    shapes against its plain version (ill-conditioned pairs at n = 3 held to the
    #    float64 cancellation bound), K3 bit for bit on the probe's residuals.
    base = ctl_card._reference_run(case.workload, case.fleet, inc_np.winner.params, "fifo")
    X = telemetry_matrix(res_np.sim)
    windows = [X[t : t + c["segment_bins"]] for t in range(0, T, c["segment_bins"])]
    p_card, p_cpu = DriftProbe(device=dev).fit(base), DriftProbe(device="cpu").fit(base)
    v_card = [p_card.check(w).drifted for w in windows]
    v_cpu = [p_cpu.check(w).drifted for w in windows]
    expect(v_card == v_cpu, "the probe's verdicts on the card differ from the CPU's")
    # residuals of the whole live run: the CPU's model on the CPU, the same model carried
    # to the card, and the card's own model
    m = p_card.model
    Xw = torch.as_tensor(X.astype(np.float32))
    _, r_cpu = estimate(p_cpu.model, Xw)
    _, r_one = estimate(MSETModel.from_numpy(**p_cpu.model.to_numpy(), device=dev), Xw.to(dev))
    _, r_own = estimate(m, Xw.to(dev))
    scale = float(r_cpu.abs().max())
    one_err = float((r_one.cpu() - r_cpu).abs().max())
    own_err = float((r_own.cpu() - r_cpu).abs().max())
    resid = dict(
        cpu_max_abs=scale,
        one_model_max_abs_err=one_err,
        one_model_rel=one_err / scale,
        own_models_max_abs_err=own_err,
        own_models_rel=own_err / scale,
        ginv_max_abs={
            "card": float(m.Ginv.abs().max()),
            "cpu": float(p_cpu.model.Ginv.abs().max()),
        },
    )
    k1 = []
    for y in (m.D, (Xw.to(dev) - m.mean) / m.std):
        out = similarity_cuda(m.D, y, m.gamma, m.kind)
        ref = similarity_ref(m.D, y, m.gamma, m.kind)
        err, n_ill, far_err, ok = check_ragged(m.D, y, m.gamma, m.kind, out, ref)
        shape_k1 = [m.D.shape[0], y.shape[0], m.D.shape[1]]
        expect(ok, f"K1 at the probe's shape {shape_k1} misses its bar")
        k1.append(dict(shape=shape_k1, max_abs_err=err, ill=n_ill, float64_err=far_err))
    sig32 = torch.as_tensor(p_card.sigma, dtype=torch.float32, device=dev)
    mu32 = torch.as_tensor(p_card.mu, dtype=torch.float32, device=dev)
    same, bits, sprt_err, _ = check_sprt(r_own, sig32, mu32, p_card.sprt_params)
    expect(same and bits, "K3 on the probe's residuals differs from its plain version")
    distinct = int(len(torch.unique(m.D, dim=0)))
    rec["probe"] = dict(
        windows=len(windows),
        drifted_windows=sum(v_card),
        residuals=resid,
        k1=k1,
        k3_max_abs_err=sprt_err,
        memvec_distinct=distinct,
        n_memvec=int(m.D.shape[0]),
    )
    print(
        f"  probe: {len(windows)} windows, {sum(v_card)} drifted, the same verdicts on the "
        f"card and the CPU; {distinct} of {m.D.shape[0]} memory vectors distinct; residuals "
        f"card vs CPU {resid}; K1 {k1}; K3 bit for bit"
    )

    # 4. The oracle: the column build on the card; one column, cell by cell, on numpy.
    o = ORACLE
    mt = ts_np.fleet.pools[0].service.max_throughput
    grid = OracleGrid(
        mean_rates=tuple(r * mt for r in o["rate_mults"]),
        burstiness=o["burstiness"],
        slos=o["slos"],
        duration_s=o["duration_s"],
        dt_s=c["dt_s"],
        n_seeds=o["n_seeds"],
        seed=o["seed"],
    )
    okw = dict(
        objective=objective,
        budget=TuningBudget(n_candidates=o["candidates"], init_seeds=o["init_seeds"]),
        context=ts_np.context,
        max_queue=ts_np.max_queue,
        name="mset-oracle",
    )
    with telemetry.session() as tel:
        t0 = time.perf_counter()
        table = build_oracle(
            grid, ts_card.fleet, PIPolicy, space, backend="torch", device=dev, **okw
        )
        build_card_s = time.perf_counter() - t0
    # build_oracle seeds column (i, j) with seed + 7919 (1 + 31 i + j); a one-column
    # grid's column is (0, 0), so its seed is moved by 7919 (31 i + j)
    i, j = ORACLE_COLUMN
    column = OracleGrid(
        mean_rates=(grid.mean_rates[i],),
        burstiness=(grid.burstiness[j],),
        slos=o["slos"],
        duration_s=o["duration_s"],
        dt_s=c["dt_s"],
        n_seeds=o["n_seeds"],
        seed=o["seed"] + 7919 * (i * 31 + j),
    )
    t0 = time.perf_counter()
    per_cell = build_oracle(column, ts_np.fleet, PIPolicy, space, backend="numpy", **okw)
    build_np_s = time.perf_counter() - t0

    def cell_json(cell):
        return {k: v for k, v in cell.to_json().items() if k != "idx"}

    for k in range(len(o["slos"])):
        expect(
            cell_json(table.cells[(i, j, k)]) == cell_json(per_cell.cells[(0, 0, k)]),
            f"oracle cell {(i, j, k)}: the card's column build differs from numpy's",
        )
    lat = query_latency_us(ScopingOracle(table), TraceFeatures(3.1 * mt, 1.8, 0.0), c["slo_s"])
    t0 = time.perf_counter()
    ver = verify_oracle(
        table,
        ts_card.fleet,
        PIPolicy,
        n_samples=o["verify_samples"],
        seed=o["seed"],
        context=ts_np.context,
        max_queue=ts_np.max_queue,
        backend="torch",
        device=dev,
    )
    verify_s = time.perf_counter() - t0
    rec["oracle"] = dict(
        cells=table.n_cells,
        build_card_s=build_card_s,
        column_numpy_s=build_np_s,
        column_cells=len(o["slos"]),
        sims_used=table.build_info["sims_used"],
        query_median_us=lat["median_us"],
        query_p99_us=lat["p99_us"],
        verify_s=verify_s,
        verify={k: v for k, v in ver.to_json().items() if k != "checks"},
        **dispatch_record(tel),
    )
    print(
        f"  oracle: {table.n_cells} cells built on the card in {build_card_s:.3f} s; one "
        f"column of {len(o['slos'])} cells per cell on numpy in {build_np_s:.3f} s, equal "
        f"cell for cell; query median {lat['median_us']:.1f} us; verify {ver.summary()}"
    )
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  the autonomous-loop phase took {rec['phase_s']:.1f} s")
    return rec


def subprocess_env(cpu=False):
    """The environment of a process this script starts: the checkout's ``src`` on the
    path; a CPU world sees no card, so that nothing in it can reach one."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    if cpu:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def world(n, args, cpu=False):
    """A torchrun world of ``n`` ranks running ``args`` from the checkout's root (on the
    host's CPU with ``cpu``); (stdout, wall seconds). A world that fails or outlasts
    WORLD_TIMEOUT fails the script."""
    from repro_torch.launch.mesh import torchrun

    t0 = time.perf_counter()
    p = torchrun(n, args, WORLD_TIMEOUT, cwd=ROOT, env=subprocess_env(cpu))
    seconds = time.perf_counter() - t0
    expect(
        p.returncode == 0,
        f"a world of {n} running {args[:2]} exited {p.returncode}:\n{p.stdout[-2000:]}\n"
        f"{p.stderr[-4000:]}",
    )
    return p.stdout, seconds


def chain_rank(spec_path):
    """One rank of phase 19's elastic chain, under torchrun: ``launch.train.train`` of
    CHAIN's job in float32 on the spec's device, joining the world through the port's
    ``init_world``; rank 0 writes the history and metrics."""
    import torch.distributed as dist

    import repro_torch.launch.train as train_mod
    from repro_torch._device import f32_matmul_highest
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_world, is_main

    with open(spec_path) as f:
        spec = json.load(f)
    init_world(spec["device"])
    f32_matmul_highest()
    train_mod.get_config = lambda arch, smoke=True: get_config(arch, smoke).replace(
        dtype="float32"
    )
    job = train_mod.TrainJob(device=spec["device"], ckpt_dir=spec["ckpt_dir"], **CHAIN)
    metrics = train_mod.train(job, verbose=False)
    if is_main():
        hist = [(h["step"], h["loss"], h["grad_norm"]) for h in job.history]
        with open(spec["out"], "w") as f:
            json.dump({"history": hist, "metrics": metrics}, f)
    dist.destroy_process_group()


def chain_link(i, work):
    """Link ``i`` of CHAIN_LINKS as a torchrun world: from a copy of the last link's
    checkpoint at its resume step (none for the first); (its history, wall seconds)."""
    import shutil

    label, n, device, resume = CHAIN_LINKS[i]
    ckpt = os.path.join(work, f"chain{i}")
    if resume is not None:
        prev = os.path.join(work, f"chain{i - 1}")
        for cfg_dir in os.listdir(prev):
            name = f"step_{resume:010d}"
            shutil.copytree(os.path.join(prev, cfg_dir, name), os.path.join(ckpt, cfg_dir, name))
    spec = os.path.join(work, f"chain{i}.json")
    hist_path = os.path.join(work, f"chain{i}.out.json")
    with open(spec, "w") as f:
        json.dump({"device": device, "ckpt_dir": ckpt, "out": hist_path}, f)
    rank_args = [os.path.join(ROOT, "chip_smoke.py"), "--chain-rank", spec]
    _, seconds = world(n, rank_args, cpu=device == "cpu")
    with open(hist_path) as f:
        return json.load(f), seconds


def launcher_phase(card, serving, work):
    """Phase 19, first part, alone on the card and its host: the server through its
    launcher (``-m repro_torch.launch.serve``) as a torchrun world of one at phase 8's
    shape and seed, its tokens equal to phase 8's. Returns its record."""
    print(f"== 19. several processes under torchrun ({card}; the CPU worlds on its host)")
    out = os.path.join(work, "serve.json")
    args = ["-m", "repro_torch.launch.serve", "--arch", SERVE_ARCH, "--full"]
    args += ["--batch", SERVE["batch"], "--prompt-len", SERVE["prompt_len"]]
    args += ["--tokens", SERVE["gen_tokens"], "--out", out]
    _, seconds = world(1, args)
    with open(out) as f:
        r = json.load(f)
    same = r["tokens"] == serving["tokens"]
    print(
        f"  serve {SERVE_ARCH} --full through the launcher (a world of one, nothing else "
        f"running): prefill {r['prefill_s']:.4f} s, {r['tokens_per_s']:.1f} tokens/s; "
        f"tokens equal to phase 8's: {same}; {seconds:.1f} s of wall time"
    )
    expect(same, "the launcher's greedy tokens differ from phase 8's")
    return dict(prefill_s=r["prefill_s"], tokens_per_s=r["tokens_per_s"], wall_s=seconds)


def chain_phase(work):
    """Phase 19, second part: the elastic chain of CHAIN_LINKS (beside phase 20's
    examples), each resumed loss within CHAIN_RTOL of the uninterrupted world of four's
    at the same step; each link's wall time. Returns the chain's records."""
    t_chain = time.perf_counter()
    links = [chain_link(i, work) for i in range(len(CHAIN_LINKS))]
    recs = []
    want = {s: loss for s, loss, _ in links[0][0]["history"]}
    for (label, _, _, resume), (h, seconds) in zip(CHAIN_LINKS, links):
        steps = [s for s, *_ in h["history"]]
        expect(steps == list(range(resume or 0, CHAIN["steps"])), f"{label} ran steps {steps}")
        rel = max(abs(loss - want[s]) / abs(want[s]) for s, loss, _ in h["history"])
        print(
            f"  {label}: steps {steps[0]}-{steps[-1]}"
            + (f" resumed from step {resume}" if resume is not None else ", uninterrupted")
            + f", losses {[round(loss, 6) for _, loss, _ in h['history']]}, largest relative "
            f"difference from the world of four {rel:.2e} (bar {CHAIN_RTOL:g}); "
            f"{seconds:.1f} s of wall time (beside the examples)"
        )
        expect(rel <= CHAIN_RTOL, f"{label}: a resumed loss differs by {rel:.2e}")
        recs.append(
            dict(link=label, resume=resume, history=h["history"], max_rel=rel, wall_s=seconds)
        )
    print(f"  the chain took {time.perf_counter() - t_chain:.1f} s")
    return recs


def example_main(path, args):
    """This script's --example mode, one example as its own process (phase 20): its
    ``main()`` on the card (given ``args`` where there are any), then one line of what
    it returned, the kernels' launches in it and its seconds."""
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    sys.argv = [path, *args]
    t0 = time.perf_counter()
    figures = module.main(args) if args else module.main()
    seconds = time.perf_counter() - t0
    launches = {
        name: importlib.import_module(f"repro_torch.kernels.{mod}").launches
        for name, mod in (
            ("similarity", "similarity.similarity"),
            ("flash_attention", "attention.flash"),
            ("sprt", "sprt.sprt"),
        )
    }
    record = {"figures": figures, "launches": launches, "seconds": seconds}
    print("EXAMPLE " + json.dumps(record))


def run_example(path, work):
    """One example as its own process on the card (``--example``): (what it printed in
    its record line, the wall seconds)."""
    from repro_torch.launch.mesh import run_bounded

    name = os.path.basename(path)
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--example", path]
    cmd.append(json.dumps(EXAMPLE_ARGS.get(name, [])))
    t0 = time.perf_counter()
    p = run_bounded(cmd, EXAMPLE_TIMEOUT, cwd=work, env=subprocess_env())
    seconds = time.perf_counter() - t0
    expect(p.returncode == 0, f"{name} exited {p.returncode}:\n{p.stderr[-4000:]}")
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("EXAMPLE ")]
    expect(len(line) == 1, f"{name} printed no result")
    return json.loads(line[0][len("EXAMPLE "):]), seconds


def examples_phase(card, results):
    """Phase 20: every examples/torch_*.py as its own process on the card (EXAMPLE_WORKERS
    at a time, beside the chain; ``results`` the futures), each exiting 0 with what its
    ``main()`` returned printed, the quickstart's drift alarm gated, and each one's
    kernel launches. Returns the record."""
    print(f"== 20. the examples, each its own process on {card}, {EXAMPLE_WORKERS} at a time")
    rec, totals = {}, {}
    for name, fut in results.items():
        r, seconds = fut.result()
        for k, v in r["launches"].items():
            totals[k] = totals.get(k, 0) + v
        print(f"  {name}: {json.dumps(r['figures'])}")
        print(f"    kernel launches {r['launches']}; {seconds:.1f} s of wall time (shared)")
        rec[name] = dict(launches=r["launches"], wall_s=seconds, main_s=r["seconds"])
    delay = results["torch_quickstart.py"].result()[0]["figures"]["detection_delay"]
    expect(delay is not None, "the quickstart missed its injected drift")
    expect(totals.get("similarity", 0) > 0, "no example launched the similarity kernel")
    expect(totals.get("sprt", 0) > 0, "no example launched the SPRT kernel")
    expect(totals.get("flash_attention", 0) > 0, "no example launched the flash kernel")
    rec["launches"] = totals
    return rec


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
    sprt_module = importlib.import_module("repro_torch.kernels.sprt.sprt")
    gemm_module = importlib.import_module("repro_torch.kernels.gemm.gemm")
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
    flash_module = importlib.import_module("repro_torch.kernels.attention.flash")
    modules = {
        "similarity": sim_module,
        "flash attention": flash_module,
        "sprt": sprt_module,
        "gemm": gemm_module,
    }
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:  # one nvcc for each source, started together
        builds = list(pool.map(_build.build, (m.SOURCE for m in modules.values())))
    print(f"the {len(builds)} kernels built in {time.perf_counter() - t0:.2f} s of wall time")
    for name, built in zip(modules, builds):
        print(f"{name}: {built.library.name}, nvcc {built.seconds:.2f} s (cached={built.cached})")
        report = ptxas_report(built.log)
        expect(built.cached or report, f"no ptxas report for {name}")
        if name == "sprt" and not built.cached:  # both passes are built
            missing = set(SPRT_KERNELS) - {label for label, *_ in report}
            expect(not missing, f"no ptxas report for {sorted(missing)}")
        for label, regs, stored, loaded in report:
            print(f"  {label:34s} {regs:3d} registers, spills {stored} B stored, {loaded} B loaded")
            expect(stored == 0 and loaded == 0, f"{label} spills registers")
        for line in built.log.splitlines():
            if "wgmma" in line:  # ptxas says so when it serializes the asynchronous products
                print(f"  ptxas: {line.strip()}")

    # ------------------------------------------------- 3. kernel vs plain version
    print("== 3. kernel against its plain version on the card")
    g = torch.Generator(device=dev).manual_seed(0)
    for shapes in (SWEEP, RAGGED):
        for m, b, n in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(m, n, generator=g, device=dev).to(dtype)
                y = torch.randn(b, n, generator=g, device=dev).to(dtype)
                # the median distance of the inputs keeps both kinds well away from 0
                # (at n = 1 and 3, a third of the largest distance does)
                gamma = float(_bandwidth(x.float())) if shapes is SWEEP else wide_gamma(x, y)
                for kind_ in KINDS:
                    out = similarity_cuda(x, y, gamma, kind_)
                    ref = similarity_ref(x, y, gamma, kind_)
                    if shapes is SWEEP:
                        err, ok = compare(out, ref, TOL, TOL)
                        extra = ""
                    else:
                        err, n_cancel, far_err, ok = check_ragged(x, y, gamma, kind_, out, ref)
                        extra = (
                            f"; {n_cancel} ill-conditioned pairs, there {far_err:.3e} from float64"
                            if n_cancel
                            else ""
                        )
                    print(
                        f"  sweep {m}x{b}x{n} {str(dtype)[6:]:8s} {kind_:16s} gamma {gamma:7.3f} "
                        f"min {float(ref.min()):.3f} max_abs_err {err:.3e} (bar {TOL:g}){extra}"
                    )
                    expect(float(ref.min()) > 0.01, f"sweep values near 0 at {m}x{b}x{n} {kind_}")
                    expect(ok, f"kernel disagrees at {m}x{b}x{n} {dtype} {kind_}: {err}")
                err, n_ill, far_err, ok = check_self(x, gamma, similarity_cuda, similarity_ref)
                print(
                    f"  sweep {m}x{m}x{n} {str(dtype)[6:]:8s} sim(x, x) max_abs_err {err:.3e}; "
                    f"{n_ill} ill-conditioned pairs with the diagonal, there {far_err:.3e} from "
                    "float64; equal to sim(x, x.clone())"
                )
                expect(ok, f"sim(x, x) at {m}x{n} {dtype}: {err}, {far_err}")
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

    # The full-width cell's own operands: its memory matrix against its standardized
    # surveillance observations, as train and estimate make them. The kernel may be no
    # further from float64 than the plain float32 version is, plus the bar. (reg decides
    # Ginv alone, which phase 21 reads.)
    p = FULL_WIDTH_CELL
    n_tr, n_surv = surveillance_split(p)
    tpss = TPSSParams(n_signals=p["n_signals"], n_obs=n_tr + n_surv)
    Xall = synthesize(cell_seed(p), tpss, device=dev)
    cell_model = train(Xall[:n_tr], n_memvec=p["n_memvec"], reg=GEMM_REG)
    Xs = (Xall[n_tr:] - cell_model.mean) / cell_model.std
    del Xall
    tpss_errs = float64_errors(cell_model.D, Xs, cell_model.gamma, similarity_cuda, similarity_ref)
    for kind_, e in tpss_errs.items():
        print(
            f"  full-width cell D {tuple(cell_model.D.shape)} x standardized X {tuple(Xs.shape)} "
            f"{kind_:16s} against float64: kernel {e['kernel']:.3e}, plain f32 {e['plain']:.3e} "
            f"(kernel bar: plain + {TOL:g})"
        )
        expect(e["kernel"] <= e["plain"] + TOL, f"kernel far from float64 on the cell's {kind_}")
    # phase 21's operands: the cell's Ginv and D, and the K of its surveillance observations
    cell_Ginv, cell_D = cell_model.Ginv, cell_model.D
    cell_K = similarity_cuda(cell_model.D, Xs, cell_model.gamma)
    del cell_model, Xs
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 4. timing
    print(f"== 4. timing (CUDA events; {card})")
    timings = {}
    for label, (m, b, n), iters in (("train", TRAIN_SHAPE, 20), ("surveil", SURVEIL_SHAPE, 10)):
        x, y = D, (D if label == "train" else X)
        ms = cuda_ms(lambda: similarity_cuda(x, y, gamma), iters)
        xb = x.bfloat16()
        yb = xb if label == "train" else y.bfloat16()
        one_product_ms = cuda_ms(lambda: similarity_cuda(xb, yb, gamma), iters)
        del xb, yb
        plain_ms = cuda_ms(lambda: similarity_ref(x, y, gamma), iters)
        library_ms = cuda_ms(lambda: torch.matmul(x, y.T), iters)
        # context only: the product in one TF32 pass, which misses the float32 bar
        torch.set_float32_matmul_precision("high")
        tf32_ms = cuda_ms(lambda: torch.matmul(x, y.T), iters)
        f32_matmul_highest()
        expect(
            torch.get_float32_matmul_precision() == "highest"
            and not torch.backends.cuda.matmul.allow_tf32,
            "float32 products were not restored to full float32",
        )
        bound_ms, bound_by = bound(m, b, n)
        bound_3x_ms, _ = bound(m, b, n, products=3)
        # device time of the pre-pass and of the product, a call, under torch.profiler
        device_ms = {
            re.sub(r"^void \(anonymous namespace\)::|\(.*$", "", name): ms
            for name, ms in device_ms_by_kernel(lambda: similarity_cuda(x, y, gamma)).items()
        }
        timings[label] = dict(
            ms=ms,
            plain_ms=plain_ms,
            library_ms=library_ms,
            bound_ms=bound_ms,
            bound_by=bound_by,
            bound_3x_ms=bound_3x_ms,
            one_product_ms=one_product_ms,
            tf32_matmul_ms=tf32_ms,
            device_ms=device_ms,
        )
        print(
            f"  {label} {m}x{b}x{n} f32: kernel {ms:.3f} ms, on bf16 inputs (one TF32 product) "
            f"{one_product_ms:.3f} ms, plain {plain_ms:.3f} ms, torch.matmul {library_ms:.3f} ms "
            f"(TF32, context only: {tf32_ms:.3f} ms), bound {bound_ms:.3f} ms ({bound_by}; "
            f"three TF32 products at peak {bound_3x_ms:.3f} ms), kernel at "
            f"{bound_ms / ms:.1%} of bound, {bound_3x_ms / ms:.1%} of the 3xTF32 peak"
        )
        print(
            "    device time by kernel (torch.profiler): "
            + (", ".join(f"{k} {v:.3f} ms" for k, v in device_ms.items()) or "not measured")
        )
    del D, X

    # ------------------------------------------------------------ 21. K4
    gemm_checks = gemm_phase(dev, card, gemm_module, cell_Ginv, cell_K, cell_D)
    del cell_Ginv, cell_K, cell_D
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 5. main path
    print(f"== 5. the MSET2 path on {card}")
    sim_module.launches = sprt_module.launches = gemm_module.launches = 0
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
    launches, sprt_launches = sim_module.launches, sprt_module.launches
    gemm_launches = gemm_module.launches
    print(
        f"  kernel launches during the main path: similarity {launches}, SPRT {sprt_launches}, "
        f"gemm {gemm_launches}"
    )
    expect(launches > 0, "the main path never launched the similarity kernel")
    expect(sprt_launches > 0, "the main path never launched the SPRT kernel")
    expect(gemm_launches > 0, "the main path never launched the gemm kernel")

    for r in res.rows + full.rows:
        print(f"  {card} | {r.params} | {r.mean_s:.6f} s (std {r.std_s:.6f}, {r.reps} reps)")
    print(f"  response surface over the paper grid: r^2 = {surf.r2:.4f}")
    print(f"  full-width cell peak device memory: {peak_bytes / 2**30:.2f} GiB")
    cell = full.rows[0]
    shape = (FULL_WIDTH_CELL["n_observations"], FULL_WIDTH_CELL["n_signals"])
    expect(residuals.shape == shape, f"full-width residuals have shape {tuple(residuals.shape)}")
    expect(bool(torch.isfinite(residuals).all()), "full-width residuals are not finite")
    far = float(empirical_false_alarm_rate(alarms[n_cal:]))
    print(
        f"  SPRT over {tuple(residuals.shape)} residuals: {sprt_s:.4f} s (host clock, one "
        f"call), alarm rate {far:.2e}"
    )
    expect(alarms.shape == residuals.shape and np.isfinite(far), "SPRT output malformed")
    sprt_timing = sprt_phase(dev, card, residuals, sigma, mu)

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
    split, step = step_timer()
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

    # ------------------------------------------- 6-9. flash attention and serving
    flash_timings = flash_kernel_phases(dev, card)
    flash_launches, serving = serving_phases(dev, card, flash_module)

    # ------------------------------------------ 14. the MoE and SSM families
    families = families_phase(dev, card, flash_module)
    k2_families = [families[arch]["k2"] for arch in ("olmoe-1b-7b", "jamba-v0.1-52b")]
    print(json.dumps({"families": families}))

    # ---------------------------------------------------- 15. the enc-dec family
    encdec = encdec_phase(dev, card, flash_module)
    k2_encdec = list(encdec["k2"].values())
    print(json.dumps({"encdec": encdec}))

    # ----------------------------------------------------------- 16. training
    training = training_phase(dev, card, flash_module)
    print(json.dumps({"training": training}))

    # ----------------------------------------------- 17. analytic scoping
    analytic = analytic_phase(dev, card, sim_module, serving, families, encdec, training)
    print(json.dumps({"analytic": analytic}))

    # ----------------------------------------------------------- 18. sharding
    sharded = sharded_phase(dev, card, flash_module, sim_module)
    print(json.dumps({"sharded": sharded}))

    # ------------------------------------------------------------ 10. fleet
    fleet = fleet_phase(dev, card)
    print(json.dumps({"fleet": fleet}))

    # ------------------------------------------------------------ 11. example
    counted = {"similarity": sim_module, "flash_attention": flash_module, "sprt": sprt_module}
    print(json.dumps({"example": example_phase(dev, card, counted)}))

    # ---------------------------------------------------- 12. the autonomous loop
    control = control_phase(dev, card, counted)
    print(json.dumps({"control": control}))

    # ------------------------------ 19, 20. several processes; the examples
    with tempfile.TemporaryDirectory() as work:
        multiproc = {"card": card, "serve": launcher_phase(card, serving, work)}
        paths = sorted(  # the longest first: the fleet's eager dispatches, the trainer
            glob.glob(os.path.join(ROOT, "examples", "torch_*.py")),
            key=lambda p: (os.path.basename(p) not in EXAMPLES_FIRST, p),
        )
        t_shared = time.perf_counter()
        with ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:  # on the card beside the chain
            futures = {os.path.basename(p): pool.submit(run_example, p, work) for p in paths}
            multiproc["chain"] = chain_phase(work)
            print(json.dumps({"multiproc": multiproc}))
            examples = examples_phase(card, futures)
        examples["shared_s"] = time.perf_counter() - t_shared
        print(f"  the chain and the examples together took {examples['shared_s']:.1f} s")
        print(json.dumps({"examples": examples}))
    example_launches = examples["launches"]

    # ----------------------------------------------------------- 13. kernels
    t = timings["surveil"]
    train_shape = "x = y {0}x{2}, float32 (G = sim(D, D))".format(*TRAIN_SHAPE)
    kernels = [
        {
            "name": "similarity",
            "route": "cuda",
            "source": "src/repro_torch/kernels/similarity/csrc/similarity.cu",
            "replaces": "src/repro/kernels/similarity/similarity.py:47",
            "launches": launches,
            "control_launches": control["controller"]["launches"]["similarity"],
            "examples_launches": example_launches["similarity"],
            "analytic_launches": analytic["service_k1_launches"],
            "analytic_max_abs_err": analytic["service_k1_max_abs_err"],
            "sharded_launches": sharded["k1_launches"],
            "sharded_max_abs_err": sharded["k1_max_abs_err"],
            "max_abs_err": max_abs_err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "bound_3x_ms": t["bound_3x_ms"],
            "one_product_ms": t["one_product_ms"],
            "tf32_matmul_ms": t["tf32_matmul_ms"],
            "device_ms": t["device_ms"],
            "float64_err": tpss_errs,
            "shape": "x {0}x{2}, y {1}x{2}, float32 (K = sim(D, X))".format(*SURVEIL_SHAPE),
            "train_shape": dict(timings["train"], shape=train_shape),
        },
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/attention/csrc/flash.cu",
            "replaces": "src/repro/kernels/attention/flash.py:63",
            "launches": flash_launches,
            "families_launches": {
                arch: families[arch]["k2_launches"] for arch in ("olmoe-1b-7b", "jamba-v0.1-52b")
            },
            **flash_timings["serve"],
            "max_abs_err": max(
                t["max_abs_err"] for t in [*flash_timings.values(), *k2_families, *k2_encdec]
            ),
            "families": dict(zip(("olmoe-1b-7b", "jamba-v0.1-52b"), k2_families)),
            "encdec": dict(encdec["k2"], launches=encdec[ENCDEC_ARCH]["k2_launches"]),
            "prefill_32k": flash_timings["prefill_32k"],
            "training_launches": training["k2_launches"],
            "sharded_launches": sharded["k2_launches"],
            "examples_launches": example_launches["flash_attention"],
            "serve_f32": flash_timings["serve_f32"],
        },
        {
            "name": "sprt",
            "route": "cuda",
            "source": "src/repro_torch/kernels/sprt/csrc/sprt.cu",
            "replaces": "src/repro/mset/sprt.py:44",
            "launches": sprt_launches,
            "control_launches": control["controller"]["launches"]["sprt"],
            "examples_launches": example_launches["sprt"],
            **sprt_timing,
        },
        {
            "name": "gemm",
            "route": "cuda",
            "source": "src/repro_torch/kernels/gemm/csrc/gemm.cu",
            "replaces": None,  # MSET2's W = Ginv K and X_hat = W^T D, which the JAX package
            # leaves to XLA
            "launches": gemm_launches,
            **gemm_checks,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--chain-rank"]:  # one rank of phase 19's chain, under torchrun
        chain_rank(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--example"]:  # one example of phase 20, as its own process
        example_main(sys.argv[2], json.loads(sys.argv[3]))
        sys.exit(0)
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
