"""Exact FIFO request-cohort latency accounting.

The simulator's per-bin ``served`` counts say *how much* left the queue each
bin but not *who* — yet SLO attainment is a per-request property. For FIFO
service the mapping needs no per-request state: requests are identified by
their cumulative arrival index, departures by the cumulative served index, and
every per-request quantity becomes interval arithmetic between the two
cumulative curves. One vectorized pass over (seeds, slots) replaces the fluid
``wait = backlog / rate`` estimate with exact sojourns.

Model (matches the discrete simulator): all of bin t's *admitted* arrivals
queue at the start of bin t; service happens in "slots" — (bin, pool) pairs in
drain order, so heterogeneous pools with different batch times stay FIFO-exact.
A request served in slot k of bin ``u`` waited ``u - t`` whole bins and then
pays that slot's batch service time:

    sojourn = (u - t) * dt + batch_time[k]

A request served in its arrival bin pays only the batch time — the same
convention as the fluid model this replaces. Masses may be fractional (the
simulator is fluid within a bin); on integer traces the accounting matches a
brute-force per-request replay exactly (see tests/test_fleet_hetero.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_MASS_EPS = 1e-9


def row_searchsorted(rows: np.ndarray, x: np.ndarray, side: str = "left"
                     ) -> np.ndarray:
    """Batched ``np.searchsorted``: for each row s, positions of ``x[s]`` in
    the sorted row ``rows[s]``. Implemented with one flat searchsorted by
    offsetting each row into its own disjoint value range."""
    rows = np.asarray(rows, float)
    x = np.asarray(x, float)
    S, N = rows.shape
    span = float(max(rows.max(initial=0.0), x.max(initial=0.0))) + 1.0
    off = np.arange(S)[:, None] * span
    flat = np.searchsorted((rows + off).ravel(), (x + off).ravel(), side=side)
    return flat.reshape(x.shape) - np.arange(S)[:, None] * N


@dataclass(frozen=True)
class CohortMetrics:
    """Exact per-slot FIFO accounting (all mass in requests).

    ``ok_served[s, k]``     — mass served in slot k within the SLO deadline.
    ``mean_sojourn[s, k]``  — served-mass mean sojourn of slot k (0 if empty).
    ``sojourn_values/weights`` — the exact pooled sojourn distribution across
    seeds: every (arrival-bin, slot) segment contributes its mass, so weighted
    percentiles over these are per-request exact, not per-bin means.
    """
    ok_served: np.ndarray
    mean_sojourn: np.ndarray
    sojourn_values: np.ndarray
    sojourn_weights: np.ndarray


def cohort_metrics(admitted: np.ndarray, served: np.ndarray,
                   slot_bin: np.ndarray, slot_batch_time: np.ndarray,
                   dt_s: float, slo_s: float) -> CohortMetrics:
    """Exact FIFO sojourn/deadline accounting from cumulative arithmetic.

    admitted:        (S, T) arrivals entering the queue per bin (post-drop).
    served:          (S, K) mass departing per slot, slots in FIFO drain order.
    slot_bin:        (K,) int bin index of each slot (non-decreasing).
    slot_batch_time: (S, K) batch service time paid by requests in that slot.

    Requires the FIFO invariant cum_served[:, k] <= cum_admitted[:, slot_bin[k]]
    (a queue cannot serve requests that have not arrived).
    """
    admitted = np.asarray(admitted, float)
    served = np.asarray(served, float)
    slot_bin = np.asarray(slot_bin, int)
    bt = np.asarray(slot_batch_time, float)
    S, T = admitted.shape
    K = served.shape[1]

    A = np.cumsum(admitted, axis=1)                       # (S, T)
    D = np.cumsum(served, axis=1)                         # (S, K)
    # tolerance is relative: long traces accumulate float error proportional
    # to the total mass without any request actually being served early
    if np.any(D - np.take(A, slot_bin, axis=1) > 1e-6 + 1e-9 * D):
        raise ValueError("FIFO invariant violated: served mass outruns arrivals")
    Apad = np.concatenate([np.zeros((S, 1)), A], axis=1)  # Apad[:, j] = A[:, j-1]
    Dprev = np.concatenate([np.zeros((S, 1)), D[:, :-1]], axis=1)

    # --- deadline misses per slot -------------------------------------------
    # sojourn <= slo  <=>  arrival bin t >= u - floor((slo - bt) / dt), so the
    # missing mass in slot k is the part of (Dprev, D] that lies at or below
    # the cumulative-arrival mark of the last too-early cohort.
    wait_bins = np.floor((slo_s - bt) / dt_s + 1e-9)      # may be negative
    t_min = slot_bin[None, :] - wait_bins                 # cohorts >= t_min meet SLO
    j = np.clip(t_min, 0.0, float(T)).astype(int)
    miss = np.clip(np.take_along_axis(Apad, j, axis=1) - Dprev, 0.0, served)
    ok_served = served - miss

    # --- mean sojourn per slot ----------------------------------------------
    # G(x) = sum of arrival-bin indices weighted by mass over indices (0, x]:
    # full cohorts 0..j-1 plus the partial cohort j.
    Tw = np.concatenate(
        [np.zeros((S, 1)), np.cumsum(np.arange(T) * admitted, axis=1)], axis=1)

    def G(x):
        jj = row_searchsorted(A, x, side="left")
        jc = np.clip(jj, 0, T - 1)
        return (np.take_along_axis(Tw, jc, axis=1)
                + jc * (x - np.take_along_axis(Apad, jc, axis=1)))

    mass_t = G(D) - G(Dprev)                              # sum_t t * n[t, k]
    pos = served > _MASS_EPS
    mean_t = np.divide(mass_t, served, out=np.zeros_like(mass_t), where=pos)
    mean_sojourn = np.where(pos, bt + dt_s * (slot_bin[None, :] - mean_t), 0.0)

    # --- exact pooled sojourn distribution ----------------------------------
    # Merge the arrival and departure partitions of the served mass: each
    # elementary segment has a unique (arrival bin, slot) pair, i.e. a single
    # sojourn value. At most T + K segments per seed — no per-request blowup.
    Dend = D[:, -1:]
    cuts = np.sort(np.concatenate([np.minimum(A, Dend), D], axis=1), axis=1)
    lo = np.concatenate([np.zeros((S, 1)), cuts[:, :-1]], axis=1)
    w = cuts - lo
    mid = 0.5 * (cuts + lo)
    t_idx = np.clip(row_searchsorted(A, mid, side="left"), 0, T - 1)
    k_idx = np.clip(row_searchsorted(D, mid, side="left"), 0, K - 1)
    soj = ((slot_bin[k_idx] - t_idx) * dt_s
           + np.take_along_axis(bt, k_idx, axis=1))
    keep = w > _MASS_EPS
    return CohortMetrics(ok_served=ok_served, mean_sojourn=mean_sojourn,
                         sojourn_values=soj[keep], sojourn_weights=w[keep])


def multiclass_cohort_metrics(admitted: np.ndarray, served: np.ndarray,
                              slot_bin: np.ndarray,
                              slot_batch_time: np.ndarray, dt_s: float,
                              slo_s) -> list:
    """Per-class exact sojourn recovery: one ``CohortMetrics`` per class.

    Every scheduling discipline in ``repro_torch.fleet.discipline`` keeps cohort
    keys non-decreasing in the arrival bin within a class, so service *within*
    a class is FIFO under all of them and the single-class cumulative
    arithmetic applies class by class — the discipline only shows up through
    the per-class served-per-slot split.

    admitted: (S, T, C) post-admission arrivals; served: (S, K, C) per-slot
    per-class served mass; slo_s: per-class deadline, scalar or (C,).
    """
    admitted = np.asarray(admitted, float)
    served = np.asarray(served, float)
    C = admitted.shape[2]
    slo = np.broadcast_to(np.asarray(slo_s, float), (C,))
    return [cohort_metrics(admitted[:, :, c], served[:, :, c], slot_bin,
                           slot_batch_time, dt_s, float(slo[c]))
            for c in range(C)]
