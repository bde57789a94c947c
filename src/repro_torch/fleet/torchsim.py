"""Compiled fleet-simulator backend in torch: the batched (candidate x seed x
bin) lattice of a racing round as one float64 bin loop on the card.

The counterpart of ``repro/fleet/jaxsim.py``. The numpy simulator
(``repro_torch.fleet.simulator``) is the reference implementation; its inner
loop is a Python ``for t in range(T)`` with a data-dependent cohort pour per
bin, run once per candidate. This module re-expresses the per-bin update as
fixed-shape tensor arithmetic over every candidate and seed at once:

* **time** is a Python ``for t in range(T)`` that plays ``lax.scan``'s step;
  its carry is the queue/fleet state (per-class cumulative admitted curves,
  ready/cold-starting replicas, the pending-launch ledger, the policy kernel's
  state);
* **the batch** is explicit leading dims (N candidates, S seeds) on every
  tensor, where the reference vmaps;
* **the cohort pour** is a bisect over prefix ranks of the discipline's static
  serve order (``discipline.cohort_tables``): ``n_rank_iters`` fixed
  iterations find the minimal prefix whose admitted mass covers the amount;
* **scale-down cancellation** (newest pending launches first) is a reverse
  water-fill over the pending-launch window;
* **the policy** runs as a functional kernel (``repro_torch.fleet.kernels``),
  its tunable knobs passed as (N, 1) tensors.

The loop never synchronises with the host: no ``.item()``, no ``.cpu()``, no
Python branch on a tensor's value, so it queues work as ``lax.scan`` did and
the host reads the outputs once, at the end. A round is a few hundred small
kernels a bin (``chip_smoke.py`` counts them), too many to launch one by one
from Python, so on a card a configuration that dispatches again is captured
once as a CUDA graph (the counterpart of XLA compiling the scan) and replayed.
The first dispatch of a signature runs the loop eagerly, so a one-shot call
pays no capture; the second captures the loop (the first was the warm-up a
capture needs) and replays it; later ones copy their inputs into the graph's
static tensors and replay it. Anything that varies between dispatches of one
signature is a tensor input, never a value baked in at capture. Each graph
keeps a private memory pool, so only the ``_MAX_GRAPHS`` most recently used
are kept. On the CPU the loop runs eagerly.

Everything is float64 and matches the numpy engine's operation order: bit for
bit on the substep core, and to float rounding on the coarse core, whose numpy
pour loop differs from the bisect by construction. Short sums over classes and
pools are explicit adds in numpy's order, window sums go through
``kernels.seq_sum0``, and no tensor is divided by a Python number (CUDA would
multiply by the reciprocal). With a single seed numpy sums a forecast window
pairwise rather than left to right, and ``kernels._window_sum`` follows it.

Candidate batches are padded to the next power of two (padding replays
candidate 0) and ``tile`` streams wide slates through fixed-width chunks, as in
the reference, so every tile of a slate shares one graph. ``clear_compiled``
evicts the captured graphs, as the reference's evicts its compiled programs.
XLA's persistent compilation cache has no counterpart: a CUDA graph lives in
its process, so ``enable_persistent_compile_cache`` and
``persistent_cache_stats`` are not ported. A signature's first dispatch is
labelled ``cold`` in the ``torchsim.dispatch`` span and counters, later ones
``warm``; the span's ``path`` says how it ran (``eager``, ``capture`` or
``replay``).
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.fleet import telemetry
from repro_torch.fleet.kernels import KernelObs, add_all, seq_sum_last

_EPS = 1e-12

# (kernel id, static configuration, padded shape, device) signatures that have
# dispatched at least once: the cold/warm classifier of the dispatch span.
_DISPATCHED: set = set()


def _build_core(
    kernel,
    *,
    T,
    C,
    P,
    Tpad,
    W,
    dt,
    order,
    t_fixed,
    t_unit,
    max_b,
    max_queue,
    n_substeps=1,
    preemptive=False,
    tput=(),
):
    """The bin loop for one static configuration, as a function of the batch's
    tensors (see :func:`run_dynamics` for their shapes)."""
    CT = C * T
    n_rank_iters = max(int(np.ceil(np.log2(CT + 1))), 1)
    n_sub = int(n_substeps)
    dt_sub = dt / n_sub  # host float, as the numpy engine computes it

    def core(
        arr,
        arr_tot,
        rate,
        rate_sum,
        jb,
        cnt,
        cls_rank,
        drop_rank,
        key_rank,
        kp,
        lo_q,
        hi_q,
        init_ready,
    ):
        N = cnt.shape[0]
        S = arr.shape[0]
        dev = arr.device
        f64 = dict(dtype=torch.float64, device=dev)
        arange_c = torch.arange(C, device=dev)
        cnt_e = cnt[:, None].expand(N, S, C, CT + 1)
        # launch-landing bin of a scale-up decided at bin t, per (seed, bin, pool)
        land = jb + torch.arange(1, T + 1, device=dev)[None, :, None]

        def take(Acum, done, r):
            """Per-class mass available in the first ``r`` cohorts of the
            serve order, for an (N, S) rank ``r``."""
            j = torch.gather(cnt_e, 3, r[:, :, None, None].expand(N, S, C, 1))
            a = torch.gather(Acum, 3, j)[..., 0]
            return torch.clamp(a - done, min=0.0)

        def bisect(Acum, done, covers):
            """Minimal prefix rank whose mass satisfies ``covers``."""
            lo = torch.zeros((N, S), dtype=torch.int64, device=dev)
            hi = torch.full((N, S), CT, dtype=torch.int64, device=dev)
            for _ in range(n_rank_iters):
                mid = (lo + hi) >> 1
                ge = covers(seq_sum_last(take(Acum, done, mid)))
                lo = torch.where(ge, lo, mid + 1)
                hi = torch.where(ge, mid, hi)
            return lo

        def pour(Acum, done, amt):
            """Pour ``amt`` into cohorts in global key order: every cohort below
            the covering prefix fully, the marginal one partially. Returns the
            (N, S, C) per-class split."""
            full = torch.clamp(Acum[..., T] - done, min=0.0)  # take(CT)
            amt = torch.minimum(torch.clamp(amt, min=0.0), seq_sum_last(full))
            lo = bisect(Acum, done, lambda m: m >= amt)
            rm1 = torch.clamp(lo - 1, min=0)
            base = take(Acum, done, rm1)
            marginal = torch.gather(cls_rank, 1, rm1)
            extra = torch.clamp(amt - seq_sum_last(base), min=0.0)
            split = base + extra[..., None] * (arange_c == marginal[..., None])
            return torch.where((lo > 0)[..., None], split, 0.0)

        def head_key(Acum, done):
            """Key of the head-of-queue cohort; +inf when the queue is empty."""
            total = seq_sum_last(torch.clamp(Acum[..., T] - done, min=0.0))
            lo = bisect(Acum, done, lambda m: m > 0.0)
            # an empty queue runs lo past CT: clip the rank as XLA's gather does
            key = torch.gather(key_rank, 1, torch.clamp(lo - 1, min=0, max=CT - 1))
            return torch.where(total > 0.0, key, np.inf)

        def admit(t, outstanding):
            """Admission control at arrival: shed overflow from the arriving
            cohorts the discipline would serve last. ``outstanding`` is the
            (N, S, C) work the bound counts. Returns (admitted, dropped)."""
            arr_c = arr[None, :, t].expand(N, S, C)
            if max_queue is None:
                return arr_c, torch.zeros_like(arr_c)
            over = torch.clamp(seq_sum_last(outstanding) + arr_tot[:, t] - max_queue, min=0.0)
            drop = torch.zeros((N, S, C), **f64)
            for rank in range(C):
                c = drop_rank[:, t, rank, None, None].expand(N, S, 1)
                d = torch.minimum(torch.gather(arr_c, 2, c)[..., 0], over)
                drop = drop.scatter_add(2, c, d[..., None])
                over = over - d
            return arr_c - drop, drop

        def decide(t, pstate, ready, in_flight, pend, queue, util, queue_c):
            """The policy's step, quota clipping, scale-down cancellation and
            scale-up launches. Writes ``pend`` in place and returns the new
            (pstate, ready, in_flight), the billed fleet and the serving fleet."""
            obs = KernelObs(
                t_s=(t + 1) * dt,
                dt_s=dt,
                arrival_rate=rate_sum[None, :, t].expand(N, S),
                queue=queue,
                replicas=seq_sum_last(ready),
                in_flight=seq_sum_last(in_flight),
                utilization=util,
                pool_replicas=ready,
                pool_in_flight=in_flight,
                class_queue=queue_c,
                class_arrival_rate=rate[None, :, t].expand(N, S, C),
                min_replicas=lo_q,
                max_replicas=hi_q,
            )
            pool_rep = ready  # the pre-decision (serving) fleet
            pstate, target = kernel.step(kp, pstate, obs)
            target = torch.clamp(target, min=lo_q, max=hi_q)
            # scale down: cancel pending launches newest-first (reverse
            # water-fill over the cold-start window), then shrink ready
            excess = torch.clamp(ready + in_flight - target, min=0.0)
            window = pend[:, :, t + 1 : t + 1 + W]
            csum = torch.cumsum(window, 2)  # replica counts: exact in any order
            newer = csum[:, :, -1:] - csum
            cut = torch.minimum(torch.clamp(excess[:, :, None] - newer, min=0.0), window)
            canceled = cut.sum(2)
            pend[:, :, t + 1 : t + 1 + W] = window - cut
            in_flight = in_flight - canceled
            ready = torch.clamp(ready - (excess - canceled), min=0.0)
            grow = torch.clamp(target - ready - in_flight, min=0.0)
            # one (row, pool) slot per (candidate, seed): each add is alone
            idx = land[None, :, t, None, :].expand(N, S, 1, P)
            pend.scatter_add_(2, idx, grow[:, :, None])
            in_flight = in_flight + grow
            return pstate, ready, in_flight, pool_rep + in_flight, pool_rep

        def fold(new_total, done):
            """Fold sub-eps float residue of a drained class into "empty" (the
            numpy pour's _MASS_EPS behaviour); without it a ~1e-11 leftover
            queue can flip a policy ceil() on the next bin."""
            return torch.where(new_total - done <= 1e-9 + 1e-12 * new_total, new_total, done)

        def batch_of(backlog, n, has, p):
            b = torch.where(has, torch.ceil(backlog / torch.where(has, n, 1.0)), 0.0)
            b = torch.clamp(b, min=1.0, max=max_b[p])
            return b, torch.clamp(t_fixed[p] + b * t_unit[p], min=_EPS)

        ready = init_ready.expand(N, S, P).contiguous()
        in_flight = torch.zeros((N, S, P), **f64)
        pend = torch.zeros((N, S, Tpad, P), **f64)
        done = torch.zeros((N, S, C), **f64)
        Acum = torch.zeros((N, S, C, T + 1), **f64)
        pstate = kernel.init(N, S, dev)
        ys = {}

        def emit(**kw):
            for k, v in kw.items():
                ys.setdefault(k, []).append(v)

        if n_sub == 1 and not preemptive:
            for t in range(T):
                matured = pend[:, :, t]
                ready = ready + matured
                in_flight = in_flight - matured
                total_prev = Acum[..., T]
                adm_c, drop = admit(t, total_prev - done)
                new_total = total_prev + adm_c
                Acum[..., t + 1 :] = new_total[..., None]

                remaining = seq_sum_last(new_total - done)
                capacity = None
                slot_split, slot_bt, slot_served = [], [], []
                for p in order:  # static drain order
                    n = torch.clamp(ready[..., p], min=0.0)
                    has = n > 0
                    b, bt = batch_of(remaining, n, has, p)
                    cap = torch.where(has, n * b / bt, 0.0) * dt
                    split = pour(Acum, done, torch.minimum(remaining, cap))
                    done = done + split
                    s_p = seq_sum_last(split)
                    remaining = remaining - s_p
                    capacity = cap if capacity is None else capacity + cap
                    slot_split.append(split)
                    slot_bt.append(bt)
                    slot_served.append(s_p)
                done = fold(new_total, done)
                queue_c = torch.clamp(new_total - done, min=0.0)
                served = add_all(slot_served)
                util = torch.where(
                    capacity > 0, served / torch.where(capacity > 0, capacity, 1.0), 0.0
                )
                pstate, ready, in_flight, billed, pool_rep = decide(
                    t, pstate, ready, in_flight, pend, seq_sum_last(queue_c), util, queue_c
                )
                emit(
                    slot_split=torch.stack(slot_split, 2),  # (N, S, P, C) rank order
                    slot_bt=torch.stack(slot_bt, 2),
                    slot_served=torch.stack(slot_served, 2),
                    admitted_c=adm_c,
                    dropped_c=drop,
                    queue_c=queue_c,
                    pool_rep=pool_rep,
                    billed=billed,
                    util=util,
                )
            return {k: torch.stack(v, 2) for k, v in ys.items()}

        # The substep (fine-dt, checkpoint-resume, optionally preemptive) core:
        # the twin of the numpy ``_run_substep_segment``. Substeps are unrolled
        # in the bin, the batch residue rides in the carry (one tensor per pool),
        # and every float op follows the numpy engine's order.
        zc = torch.zeros((N, S, C), **f64)
        zs = torch.zeros((N, S), **f64)
        ninf = torch.full((N, S), -np.inf, **f64)
        busy_m, busy_w, busy_k = [zc] * P, [zs] * P, [ninf] * P
        held_m, held_w, held_k = [zc] * P, [zs] * P, [ninf] * P
        for t in range(T):
            matured = pend[:, :, t]
            ready = ready + matured
            in_flight = in_flight - matured
            total_prev = Acum[..., T]
            # admission control bounds *outstanding* work: waiting mass plus
            # whatever is in flight or checkpointed on the pools
            outstanding = None
            if max_queue is not None:
                outstanding = (total_prev - done) + add_all(busy_m) + add_all(held_m)
            adm_c, drop = admit(t, outstanding)
            new_total = total_prev + adm_c
            Acum[..., t + 1 :] = new_total[..., None]

            served_bin = None
            pre_n, pre_w = zs, zs
            sub_split, sub_bt, sub_served = [], [], []
            for _ in range(n_sub):  # static unroll
                slot_split, slot_bt, slot_served = [], [], []
                for p in order:  # static drain order
                    n_rep = torch.clamp(ready[..., p], min=0.0)
                    has = n_rep > 0
                    hk = head_key(Acum, done)
                    bm, bw, bk = busy_m[p], busy_w[p], busy_k[p]
                    hm, hw, hkey = held_m[p], held_w[p], held_k[p]
                    if preemptive:
                        pr = (bw > 0.0) & (hk < bk)
                        hm = hm + torch.where(pr[..., None], bm, 0.0)
                        hw = hw + torch.where(pr, bw, 0.0)
                        hkey = torch.where(pr, torch.maximum(hkey, bk), hkey)
                        pre_n = pre_n + pr
                        pre_w = pre_w + torch.where(pr, bw, 0.0)
                        bm = torch.where(pr[..., None], 0.0, bm)
                        bw = torch.where(pr, 0.0, bw)
                        bk = torch.where(pr, -np.inf, bk)
                    # progress the in-flight batch over the whole substep
                    w = bw
                    fin = (w > 0.0) & (w <= dt_sub)
                    run = w > dt_sub
                    comp_m = torch.where(fin[..., None], bm, 0.0)
                    comp_btw = torch.where(fin, seq_sum_last(bm) * w, 0.0)
                    bw = torch.where(run, w - dt_sub, 0.0)
                    bm = torch.where(fin[..., None], 0.0, bm)
                    bk = torch.where(fin, -np.inf, bk)
                    tau = torch.where(fin, dt_sub - w, torch.where(run, 0.0, dt_sub))
                    # resume a checkpoint, else form a new batch
                    idle = bw == 0.0
                    res = idle & (hw > 0.0) & (hk >= hkey)
                    bm = torch.where(res[..., None], hm, bm)
                    bw = torch.where(res, hw, bw)
                    bk = torch.where(res, hkey, bk)
                    hm = torch.where(res[..., None], 0.0, hm)
                    hw = torch.where(res, 0.0, hw)
                    hkey = torch.where(res, -np.inf, hkey)

                    backlog = seq_sum_last(new_total - done)
                    form = idle & ~res & (backlog > 0.0) & (tau > 0.0) & has
                    b, bt_b = batch_of(backlog, n_rep, has, p)
                    amt = torch.where(form, torch.minimum(backlog, n_rep * b), 0.0)
                    split = pour(Acum, done, amt)
                    done = done + split
                    bm = torch.where(form[..., None], split, bm)
                    bw = torch.where(form, bt_b, bw)
                    # preemption rank = head key at formation: rank by the
                    # batch's most urgent cohort, so urgent mass is never
                    # checkpointed behind a max-key resume gate
                    bk = torch.where(form, hk, bk)
                    # progress the resumed/formed batch with the leftover budget
                    w2 = bw
                    tau0 = tau
                    fin2 = (w2 > 0.0) & (w2 <= tau0)
                    run2 = w2 > tau0
                    comp_m = comp_m + torch.where(fin2[..., None], bm, 0.0)
                    comp_btw = comp_btw + torch.where(
                        fin2, seq_sum_last(bm) * ((dt_sub - tau0) + w2), 0.0
                    )
                    bw = torch.where(run2, w2 - tau0, 0.0)
                    bm = torch.where(fin2[..., None], 0.0, bm)
                    bk = torch.where(fin2, -np.inf, bk)
                    tau = torch.where(fin2, tau0 - w2, torch.where(run2, 0.0, tau0))
                    # fluid tail (the coarse within-bin convention)
                    idle2 = bw == 0.0
                    backlog2 = seq_sum_last(new_total - done)
                    b2, bt2 = batch_of(backlog2, n_rep, has, p)
                    tail = idle2 & (tau > 0.0) & has
                    cap = torch.where(tail, n_rep * b2 / bt2, 0.0) * tau
                    amt2 = torch.minimum(torch.clamp(backlog2, min=0.0), cap)
                    split2 = pour(Acum, done, amt2)
                    done = done + split2
                    pour_tot = seq_sum_last(split2)
                    comp_tot = seq_sum_last(comp_m)
                    busy_m[p], busy_w[p], busy_k[p] = bm, bw, bk
                    held_m[p], held_w[p], held_k[p] = hm, hw, hkey
                    done_any = comp_tot > 0
                    slot_split += [comp_m, split2]
                    slot_bt += [
                        torch.where(done_any, comp_btw / torch.where(done_any, comp_tot, 1.0), 0.0),
                        torch.where(pour_tot > 0.0, (dt_sub - tau) + bt2, 0.0),
                    ]
                    slot_served += [comp_tot, pour_tot]
                    served_bin = comp_tot if served_bin is None else served_bin + comp_tot
                    served_bin = served_bin + pour_tot
                # fold sub-eps float residue once per substep
                done = fold(new_total, done)
                sub_split.append(torch.stack(slot_split, 2))  # (N, S, 2P, C)
                sub_bt.append(torch.stack(slot_bt, 2))
                sub_served.append(torch.stack(slot_served, 2))

            out_c = torch.clamp(new_total - done, min=0.0) + add_all(busy_m) + add_all(held_m)
            capacity = add_all(
                [torch.clamp(ready[..., p], min=0.0) * tput[p] * dt for p in range(P)]
            )
            has_cap = capacity > 0
            util = torch.where(has_cap, served_bin / torch.where(has_cap, capacity, 1.0), 0.0)
            util = torch.clamp(util, max=1.0)
            pstate, ready, in_flight, billed, pool_rep = decide(
                t, pstate, ready, in_flight, pend, seq_sum_last(out_c), util, out_c
            )
            emit(
                slot_split=torch.stack(sub_split, 2),  # (N, S, n_sub, 2P, C)
                slot_bt=torch.stack(sub_bt, 2),
                slot_served=torch.stack(sub_served, 2),
                served_bin=served_bin,
                admitted_c=adm_c,
                dropped_c=drop,
                queue_c=out_c,
                pool_rep=pool_rep,
                billed=billed,
                util=util,
                pre_n=pre_n,
                pre_w=pre_w,
                residue=add_all(busy_w) + add_all(held_w),
            )
        return {k: torch.stack(v, 2) for k, v in ys.items()}

    return core


def _pad_pow2(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def run_dynamics(
    kernel,
    *,
    arrivals,
    jb,
    dt,
    order,
    t_fixed,
    t_unit,
    max_b,
    max_queue,
    tables,
    kp,
    min_rep,
    max_rep,
    init_ready,
    max_cold_bins,
    tput=(),
    n_substeps: int = 1,
    preemptive: bool = False,
    tile: int = None,
    device=None,
    _pad_to: int = None,
    _tile_idx: tuple = None,
) -> dict:
    """Run the batched dynamics for a stacked batch of candidates against a
    shared seed batch, in one dispatch of the bin loop.

    arrivals (S, T, C) and jb (S, T, P) are shared across candidates (the
    paired common-random-numbers design); ``tables`` (stacked
    ``cohort_tables``), ``kp`` (stacked kernel params), quota bounds and
    initial fleets are per-candidate with leading dim N. Returns numpy arrays
    with leading dims (N, S, T). Candidate batches are padded to the next power
    of two (padding replays candidate 0; padded rows are discarded).

    ``tile`` streams candidate slates wider than the (pow2-rounded) tile
    through fixed-shape chunks: every chunk, the tail included, pads to the
    full tile width. That bounds device memory when a round carries thousands
    of candidates. Results are identical to the untiled dispatch.

    ``device`` is where the loop runs: ``None`` means the card (raising when
    there is none), ``"cpu"`` the CPU. On a card a signature's first dispatch
    (``cold``) runs the loop eagerly and later ones replay it as a CUDA graph
    (module docstring).
    """
    dev = resolve_device(device)
    arrivals = np.asarray(arrivals, np.float64)
    S, T, _ = arrivals.shape
    N = len(min_rep)
    if tile is not None:
        tile_w = _pad_pow2(int(tile))
        if N > tile_w:
            n_tiles = int(np.ceil(N / tile_w))
            kp = {k: np.asarray(v) for k, v in kp.items()}
            min_rep, max_rep, init_ready = (
                np.asarray(min_rep),
                np.asarray(max_rep),
                np.asarray(init_ready),
            )
            outs = []
            for i in range(n_tiles):
                sl = slice(i * tile_w, min((i + 1) * tile_w, N))
                outs.append(
                    run_dynamics(
                        kernel,
                        arrivals=arrivals,
                        jb=jb,
                        dt=dt,
                        order=order,
                        t_fixed=t_fixed,
                        t_unit=t_unit,
                        max_b=max_b,
                        max_queue=max_queue,
                        tables={k: v[sl] for k, v in tables.items()},
                        kp={k: v[sl] for k, v in kp.items()},
                        min_rep=min_rep[sl],
                        max_rep=max_rep[sl],
                        init_ready=init_ready[sl],
                        max_cold_bins=max_cold_bins,
                        tput=tput,
                        n_substeps=n_substeps,
                        preemptive=preemptive,
                        device=dev,
                        _pad_to=tile_w,
                        _tile_idx=(i, n_tiles),
                    )
                )
            telemetry.counter("torchsim_tiles_total", n_tiles)
            return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}
    Npad = _pad_pow2(N) if _pad_to is None else int(_pad_to)
    t0 = time.perf_counter()
    statics, args = core_inputs(
        arrivals=arrivals,
        jb=jb,
        dt=dt,
        order=order,
        t_fixed=t_fixed,
        t_unit=t_unit,
        max_b=max_b,
        max_queue=max_queue,
        tables=tables,
        kp=kp,
        min_rep=min_rep,
        max_rep=max_rep,
        init_ready=init_ready,
        max_cold_bins=max_cold_bins,
        tput=tput,
        n_substeps=n_substeps,
        preemptive=preemptive,
        n_pad=Npad,
    )
    sig = (id(kernel), tuple(sorted(statics.items())), Npad, S, str(dev))
    kind = "warm" if sig in _DISPATCHED else "cold"
    if dev.type != "cuda" or kind == "cold":
        path = "eager"
    else:
        path = "replay" if sig in _GRAPHS else "capture"
    attrs = dict(kind=kind, path=path, candidates=N, padded=Npad, seeds=S, bins=T)
    if _tile_idx is not None:
        attrs.update(tile=_tile_idx[0], n_tiles=_tile_idx[1])
    with telemetry.span("torchsim.dispatch", **attrs), torch.no_grad():
        if path == "eager":
            out = _build_core(kernel, **statics)(*to_device(args, dev))
        else:
            graph = _cached(sig) if path == "replay" else _capture(sig, kernel, statics, args, dev)
            out = graph.replay(args)
        out = {k: v[:N].cpu().numpy() for k, v in out.items()}  # waits for the card
    _DISPATCHED.add(sig)
    telemetry.counter("torchsim_dispatch_total", kind=kind)
    telemetry.counter("torchsim_dispatch_seconds_total", time.perf_counter() - t0, kind=kind)
    return out


def core_inputs(
    *,
    arrivals,
    jb,
    dt,
    order,
    t_fixed,
    t_unit,
    max_b,
    max_queue,
    tables,
    kp,
    min_rep,
    max_rep,
    init_ready,
    max_cold_bins,
    tput=(),
    n_substeps: int = 1,
    preemptive: bool = False,
    n_pad: int,
):
    """The static configuration of :func:`_build_core` and the bin loop's tensor
    arguments, on the CPU, for a batch padded to ``n_pad`` candidates (padding
    replays candidate 0). Everything that varies between dispatches of one
    configuration is a tensor here, so a captured graph replays it."""
    arrivals = np.asarray(arrivals, np.float64)
    S, T, C = arrivals.shape
    N = len(min_rep)

    def pad(a, dtype):
        a = np.asarray(a)
        if n_pad != N:
            a = np.concatenate([a, np.repeat(a[:1], n_pad - N, axis=0)], axis=0)
        return torch.from_numpy(np.ascontiguousarray(a, dtype))

    def f64(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float64))

    statics = dict(
        T=T,
        C=C,
        P=len(order),
        Tpad=T + max_cold_bins + 2,
        W=max_cold_bins + 1,
        dt=float(dt),
        order=tuple(order),
        t_fixed=tuple(float(v) for v in t_fixed),
        t_unit=tuple(float(v) for v in t_unit),
        max_b=tuple(float(v) for v in max_b),
        max_queue=None if max_queue is None else float(max_queue),
        n_substeps=int(n_substeps),
        preemptive=bool(preemptive),
        tput=tuple(float(v) for v in tput),
    )
    # host-side divisions: the policy ceil()s must see the exact IEEE
    # quotients the numpy reference sees
    arr_tot = arrivals.sum(axis=2)
    args = (
        f64(arrivals),
        f64(arr_tot),
        f64(arrivals / float(dt)),
        f64(arr_tot / float(dt)),
        torch.from_numpy(np.ascontiguousarray(jb, np.int64)),
        pad(tables["cnt"], np.int64),
        pad(tables["cls_of_rank"], np.int64),
        pad(tables["drop_rank"], np.int64),
        pad(tables["key_of_rank"], np.float64),
        {k: pad(v, np.float64)[:, None] for k, v in kp.items()},
        pad(min_rep, np.float64)[:, None, :],
        pad(max_rep, np.float64)[:, None, :],
        pad(init_ready, np.float64)[:, None, :],
    )
    return statics, args


def _leaves(args):
    """The tensors of the bin loop's arguments, in a fixed order."""
    for a in args:
        if isinstance(a, dict):
            yield from (a[k] for k in sorted(a))
        else:
            yield a


def to_device(args, dev):
    """:func:`core_inputs`' arguments copied to ``dev``."""
    return tuple(
        {k: v.to(dev) for k, v in a.items()} if isinstance(a, dict) else a.to(dev) for a in args
    )


class _Graph:
    """One configuration's bin loop captured as a CUDA graph: its static input
    tensors, its output tensors (both in the graph's private memory pool) and the
    policy kernel, held so that its ``id()`` in the signature is not reused while
    the graph lives."""

    def __init__(self, graph, inputs, outputs, kernel):
        self.graph, self.inputs, self.outputs, self.kernel = graph, inputs, outputs, kernel

    def replay(self, args):
        """Copy ``args`` (CPU tensors) into the static inputs and replay the loop;
        returns the static outputs, valid until the next replay."""
        for dst, src in zip(_leaves(self.inputs), _leaves(args), strict=True):
            if dst.shape != src.shape:
                raise ValueError(f"a {tuple(src.shape)} input for a {tuple(dst.shape)} graph")
            dst.copy_(src)
        self.graph.replay()
        return self.outputs


# Signature -> _Graph, least recently used first: the captured bin loops of the
# configurations dispatched more than once on a card. Each holds a private memory
# pool (about 1 GiB for a 512-candidate tile of 720 bins), so the cache keeps the
# _MAX_GRAPHS most recently used and clear_compiled() evicts them all.
_GRAPHS: OrderedDict = OrderedDict()
_MAX_GRAPHS = 4


def _cached(sig):
    """The captured graph of ``sig``, now the most recently used."""
    _GRAPHS.move_to_end(sig)
    return _GRAPHS[sig]


def _keep(sig, graph):
    """Cache ``graph`` for ``sig``, evicting the least recently used beyond
    ``_MAX_GRAPHS``."""
    _GRAPHS[sig] = graph
    while len(_GRAPHS) > _MAX_GRAPHS:
        _GRAPHS.popitem(last=False)


def _capture(sig, kernel, statics, args, dev):
    """Second dispatch of ``sig`` on a card: capture the bin loop into a graph
    over static copies of ``args`` and cache it. The signature's first dispatch
    ran the loop eagerly, which is the warm-up a capture needs. A capture error
    raises."""
    core = _build_core(kernel, **statics)
    inputs = to_device(args, dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev), torch.cuda.graph(graph):
        outputs = core(*inputs)
    captured = _Graph(graph, inputs, outputs, kernel)
    _keep(sig, captured)
    return captured


def clear_compiled() -> list:
    """Evict every captured graph and forget which configurations have dispatched
    (the next dispatch of each is cold again). Returns the evicted graphs, as the
    reference returns its evicted cores: a caller timing a cold rebuild holds them
    until it is done, so that no policy kernel's ``id()`` is reused meanwhile and a
    new kernel masquerades as dispatched."""
    evicted = list(_GRAPHS.values())
    _GRAPHS.clear()
    _DISPATCHED.clear()
    return evicted


def slate_arguments(
    workload,
    fleet,
    policies,
    *,
    discipline="fifo",
    max_queue=None,
    cold_start_seed: int = 0,
    cs_delay=None,
):
    """The arguments of :func:`run_dynamics` for a slate of policies of one
    family, all against the same workload and seeds (the lattice of a racing
    round; ``simulate_fleet(backend="torch")`` runs a slate of one). Returns
    ``(kernel, kwargs)``; pass ``n_substeps``, ``preemptive``, ``tile`` and
    ``device`` beside ``kwargs``. ``cs_delay`` is the (S, T, P) cold-start
    jitter, drawn from ``cold_start_seed`` when not given.

    Ring buffers are sized to the widest window in the slate, so candidates
    with different windows share one kernel; a slate that mixes families
    raises ValueError."""
    from repro_torch.fleet.discipline import cohort_tables, get_discipline
    from repro_torch.fleet.simulator import (
        _candidate_arrays,
        _dynamics_inputs,
        draw_cold_start_delays,
    )

    trace = workload.total_trace()
    S, T = trace.arrivals.shape
    # fit-to-usage keeps its own ring buffer (window_bins, no forecaster)
    windows = [
        int(p.forecaster.window_bins if hasattr(p, "forecaster") else getattr(p, "window_bins", 0))
        for p in policies
    ]
    sustains = [int(p.sustain.window_bins) for p in policies if hasattr(p, "sustain")]
    W = max(windows, default=0) or None
    Ws = max(sustains, default=0) or None
    kernel = policies[0].kernel(fleet, workload.classes, max_window=W, max_sustain=Ws)
    for pol in policies:
        if pol.kernel(fleet, workload.classes, max_window=W, max_sustain=Ws) is not kernel:
            raise ValueError("a slate batches one policy family with one configuration")
    order = fleet.drain_order()
    tables = cohort_tables(get_discipline(discipline), workload.classes, T, trace.dt_s)
    min_rep, max_rep, init_ready = _candidate_arrays(fleet, order, trace.rate[0])
    n = len(policies)
    if cs_delay is None:
        cs_delay = draw_cold_start_delays(
            fleet.pools, S, T, trace.dt_s, cold_start_seed, np.arange(S)
        )
    kwargs = dict(
        _dynamics_inputs(workload, fleet, order, cs_delay),
        max_queue=fleet.max_queue if max_queue is None else max_queue,
        tables={k: np.stack([v] * n) for k, v in tables.items()},
        kp={k: np.array([kernel.params_of(p)[k] for p in policies]) for k in kernel.param_names},
        min_rep=np.stack([min_rep] * n),
        max_rep=np.stack([max_rep] * n),
        init_ready=np.stack([init_ready] * n),
    )
    return kernel, kwargs


def slate_results(
    workload, fleet, policies, out, *, discipline="fifo", n_substeps=1, preemptive=False
):
    """One ``SimResult`` per policy from :func:`run_dynamics`'s outputs for the
    slate of :func:`slate_arguments`: row ``i`` equals
    ``simulate_fleet(workload, fleet, policies[i], backend="torch")``."""
    from repro_torch.fleet.discipline import get_discipline
    from repro_torch.fleet.simulator import _result_from_dynamics

    disc = get_discipline(discipline)
    order = fleet.drain_order()
    return [
        _result_from_dynamics(
            workload,
            fleet,
            disc,
            pol.name,
            order,
            workload.slos(),
            {k: v[i] for k, v in out.items()},
            n_substeps=n_substeps,
            preemptive=preemptive,
        )
        for i, pol in enumerate(policies)
    ]
