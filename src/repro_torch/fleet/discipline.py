"""Scheduling disciplines: orderings over (arrival-bin, class) cohorts.

The simulator is fluid within a bin, so a discipline never needs per-request
state — it only decides how each service slot's mass splits across the queued
*cohorts* (one cohort = all admitted requests of one class in one bin). Every
discipline here assigns each cohort a static scalar key and serves eligible
(already-arrived, unfinished) cohorts in increasing key order:

* ``fifo``     — key = arrival time: one global queue, same-bin ties to the
  lower class index.
* ``priority`` — key = (priority rank, arrival time): strict priority, all
  queued mass of a more critical class (lower ``RequestClass.priority``) goes
  first; FIFO within a class.
* ``edf``      — key = arrival time + the class's SLO: earliest absolute
  deadline first.

Keys are non-decreasing in arrival bin within a class, so service within a
class is always FIFO and per-class sojourns stay recoverable by the exact
cumulative cohort arithmetic in ``repro_torch.fleet.cohort`` (per-class cumulative
served counts, batched searchsorted). The pour loop in ``CohortQueue.serve``
iterates over cohort *segments* actually drained — amortized O(classes x bins)
per trace — never over individual requests; it is validated against a
brute-force per-request replay for all three disciplines in
``tests/test_disciplines.py``.
"""
from __future__ import annotations

import numpy as np

_MASS_EPS = 1e-9


class Discipline:
    """Base: a static key per (class, arrival bin) cohort; lower key = served
    first, ties to the lower class index. Keys must be non-decreasing in the
    arrival bin within each class (this keeps per-class service FIFO)."""
    name = "discipline"

    def keys(self, classes, n_bins: int, dt_s: float) -> np.ndarray:
        """(n_classes, n_bins) cohort keys."""
        raise NotImplementedError


class FIFODiscipline(Discipline):
    """One global queue in arrival order — the pre-multi-class behaviour."""
    name = "fifo"

    def keys(self, classes, n_bins, dt_s):
        t = np.arange(n_bins) * dt_s
        return np.tile(t, (len(classes), 1))


class PriorityDiscipline(Discipline):
    """Strict priority (at bin granularity): every queued cohort of a more
    critical class is served before any less critical mass."""
    name = "priority"

    def keys(self, classes, n_bins, dt_s):
        t = np.arange(n_bins) * dt_s
        prios = np.array([c.priority for c in classes], float)
        rank = np.searchsorted(np.unique(prios), prios).astype(float)
        # one full trace-span per priority level: any lower-priority cohort
        # keys strictly above every higher-priority cohort, FIFO within
        span = n_bins * dt_s + 1.0
        return rank[:, None] * span + t[None, :]


class EDFDiscipline(Discipline):
    """Earliest (absolute) deadline first: arrival time + the class SLO."""
    name = "edf"

    def keys(self, classes, n_bins, dt_s):
        t = np.arange(n_bins) * dt_s
        slos = np.array([c.slo_s for c in classes], float)
        return t[None, :] + slos[:, None]


DISCIPLINES = {d.name: d for d in
               (FIFODiscipline(), PriorityDiscipline(), EDFDiscipline())}


def get_discipline(discipline) -> Discipline:
    """Resolve a discipline by name (or pass a ``Discipline`` through)."""
    if isinstance(discipline, Discipline):
        return discipline
    try:
        return DISCIPLINES[discipline]
    except KeyError:
        raise ValueError(f"unknown discipline {discipline!r}; "
                         f"available: {sorted(DISCIPLINES)}") from None


class CohortQueue:
    """Key-ordered fluid multi-class queue, vectorized over Monte Carlo seeds.

    Per-class state is two cumulative counts — admitted and served — which is
    exactly what the cohort sojourn arithmetic (batched searchsorted over the
    same curves) needs afterwards. ``serve`` pours a slot's capacity into
    eligible cohorts in increasing key order; the oldest-unfinished-cohort
    pointers advance monotonically along the cumulative-admitted curves, so
    no per-request bookkeeping ever exists.
    """

    def __init__(self, discipline, classes, n_seeds: int, n_bins: int,
                 dt_s: float):
        self.discipline = get_discipline(discipline)
        self.classes = tuple(classes)
        C = len(self.classes)
        self.keys = np.asarray(
            self.discipline.keys(self.classes, n_bins, dt_s), float)
        if self.keys.shape != (C, n_bins):
            raise ValueError(f"{self.discipline.name}: keys shape "
                             f"{self.keys.shape} != {(C, n_bins)}")
        if C and np.any(np.diff(self.keys, axis=1) < 0):
            raise ValueError(f"{self.discipline.name}: cohort keys must be "
                             "non-decreasing in the arrival bin")
        self._cum = np.zeros((C, n_seeds, n_bins))   # cumulative admitted
        self.admitted_total = np.zeros((n_seeds, C))
        self.served_total = np.zeros((n_seeds, C))
        # oldest unfinished cohort per (seed, class); monotone because
        # within-class service is FIFO, so it advances incrementally —
        # amortized O(n_bins) per (seed, class) over the whole trace
        self._head = np.zeros((n_seeds, C), int)
        self._t = -1

    def backlog(self) -> np.ndarray:
        """(n_seeds, n_classes) queued mass per class."""
        return self.admitted_total - self.served_total

    def admit(self, t: int, mass: np.ndarray) -> None:
        """Bin ``t``'s post-admission arrivals join the queue (call once per
        bin, in order, even when the mass is zero)."""
        if t != self._t + 1:
            raise ValueError(f"admit() must be called once per bin: bin {t} "
                             f"after bin {self._t}")
        self._t = t
        self.admitted_total = self.admitted_total + np.maximum(mass, 0.0)
        for c in range(len(self.classes)):
            self._cum[c, :, t] = self.admitted_total[:, c]

    def drop_order(self, t: int) -> list:
        """Class indices in load-shedding order for bin ``t``'s arrivals:
        largest cohort key first, so overflow is dropped from the requests the
        discipline would have served last."""
        k = self.keys[:, t]
        return sorted(range(len(self.classes)), key=lambda c: (-k[c], -c))

    def serve(self, t: int, amount: np.ndarray) -> np.ndarray:
        """Serve up to ``amount`` (n_seeds,) total mass from the queue in key
        order; returns the (n_seeds, n_classes) per-class split."""
        C = len(self.classes)
        S = len(amount)
        rem = np.clip(np.asarray(amount, float), 0.0, None)
        served = np.zeros((S, C))
        if C == 1:      # single class: plain FIFO, no head search needed
            served[:, 0] = np.minimum(self.backlog()[:, 0], rem)
            self.served_total = self.served_total + served
            return served
        idx = np.arange(S)
        head_key = np.empty((S, C))
        head_mass = np.empty((S, C))
        # each pass drains one cohort segment per seed: iterations are
        # bounded by cohorts exhausted plus one, amortized O(C * n_bins)
        # across the whole trace
        while (rem > _MASS_EPS).any():
            for c in range(C):
                done = self.served_total[:, c] + served[:, c]
                cum = self._cum[c]
                head = self._head[:, c]
                # advance the head to the first cohort with admitted mass
                # strictly beyond what this class has served (the eps folds
                # sub-eps float residue of an exhausted cohort into its
                # successor's take)
                while True:
                    adv = (head <= t) & (cum[idx, np.minimum(head, t)]
                                         <= done + _MASS_EPS)
                    if not adv.any():
                        break
                    head = head + adv
                self._head[:, c] = head
                empty = head > t
                hc = np.minimum(head, t)
                head_key[:, c] = np.where(empty, np.inf, self.keys[c, hc])
                head_mass[:, c] = np.where(empty, 0.0, cum[idx, hc] - done)
            pick = np.argmin(head_key, axis=1)    # ties -> lower class index
            take = np.where(np.isfinite(head_key[idx, pick]),
                            np.minimum(head_mass[idx, pick], rem), 0.0)
            if not (take > _MASS_EPS).any():
                break                             # queue empty on every seed
            served[idx, pick] += take
            rem = rem - take
        self.served_total = self.served_total + served
        return served


def cohort_tables(discipline, classes, n_bins: int, dt_s: float) -> dict:
    """Static serve-order tables for the compiled (torch) simulator backend.

    ``CohortQueue.serve`` pours capacity into cohorts in increasing
    (key, class) order, heads advancing FIFO within each class. Because
    within-class keys are non-decreasing in the arrival bin, that order is a
    *static* permutation of the ``n_classes x n_bins`` cohorts — nothing about
    it depends on the simulated masses. A compiled backend can therefore
    replace the data-dependent pour loop with a binary search over prefix
    ranks of the global order (``repro_torch.fleet.torchsim``). Returns plain numpy
    arrays (they are data to the compiled path, so one jitted program serves
    every discipline):

    * ``cnt`` (C, C*T+1) int32 — ``cnt[c, r]``: how many class-c cohorts sit
      among the first ``r`` cohorts of the global order; indexes the
      per-class cumulative-admitted curve to price a prefix.
    * ``cls_of_rank`` (C*T,) int32 — the class of the cohort at each global
      rank (the marginal cohort of a partial pour).
    * ``drop_rank`` (T, C) int32 — admission-shedding class order per arrival
      bin (largest key first, ties to the higher class index), matching
      ``CohortQueue.drop_order``.
    * ``key_of_rank`` (C*T,) float — the cohort key at each global rank:
      what prices the substep engine's *preemption rank*. A formed batch
      carries the head-of-queue key at formation (``table_head_key`` — the
      key of the most urgent cohort it swept up); a preemptive discipline
      interrupts it whenever the head-of-queue key drops strictly below
      that. Ranking by the head rather than the largest key touched keeps
      urgent mass inside a mixed batch from being checkpointed behind its
      own class's fresh arrivals (priority inversion).
    """
    disc = get_discipline(discipline)
    classes = tuple(classes)
    C = len(classes)
    keys = np.asarray(disc.keys(classes, n_bins, dt_s), float)
    if keys.shape != (C, n_bins):
        raise ValueError(f"{disc.name}: keys shape {keys.shape} != "
                         f"{(C, n_bins)}")
    cls_idx = np.repeat(np.arange(C), n_bins)
    bin_idx = np.tile(np.arange(n_bins), C)
    # lexsort: primary = key, then class (pour ties go to the lower class),
    # then bin (stable FIFO within a class)
    order = np.lexsort((bin_idx, cls_idx, keys.ravel()))
    cls_of_rank = cls_idx[order].astype(np.int32)
    cnt = np.zeros((C, C * n_bins + 1), np.int32)
    cnt[:, 1:] = np.cumsum(cls_of_rank[None, :] == np.arange(C)[:, None],
                           axis=1)
    drop_rank = np.empty((n_bins, C), np.int32)
    for t in range(n_bins):
        drop_rank[t] = np.lexsort((-np.arange(C), -keys[:, t]))
    return {"cnt": cnt, "cls_of_rank": cls_of_rank, "drop_rank": drop_rank,
            "key_of_rank": keys.ravel()[order]}


def table_prefix(Acum: np.ndarray, done: np.ndarray,
                 cnt: np.ndarray) -> np.ndarray:
    """(S, C*T+1) available mass in every prefix of the global serve order.

    ``Acum`` (S, C, T+1) per-class cumulative-admitted curves (leading zero,
    flat beyond the current bin), ``done`` (S, C) per-class poured totals.
    Entry ``r`` prices the first ``r`` cohorts exactly as the compiled
    backend's bisect does: per class, ``clip(cum_at_prefix - done, 0)``,
    then the sum over classes — cohorts not yet arrived sit flat on the
    curve and contribute zero."""
    S = Acum.shape[0]
    idx = np.broadcast_to(cnt[None], (S,) + cnt.shape)
    a = np.take_along_axis(Acum, idx, axis=2)
    return np.clip(a - done[:, :, None], 0.0, None).sum(axis=1)


def table_pour(Acum: np.ndarray, done: np.ndarray, amt: np.ndarray,
               tables: dict):
    """Pour ``amt`` (S,) into the queue in global key order — the vectorized
    numpy mirror of the compiled backend's covering-prefix bisect, driven by
    the same ``cohort_tables`` and the same operation order (so the substep
    engines agree bit-for-bit). Returns ``(split, key)``: the (S, C)
    per-class mass taken and the (S,) largest cohort key touched — the
    upper edge of the swept key range (``-inf`` when nothing poured). The
    substep engines rank a formed batch for preemption by its *head* key
    (``table_head_key`` before the pour), not this upper edge."""
    cnt = tables["cnt"]
    cls_of_rank = tables["cls_of_rank"]
    key_of_rank = tables["key_of_rank"]
    S, C, _ = Acum.shape
    CT = cnt.shape[1] - 1
    pre = table_prefix(Acum, done, cnt)
    amt = np.minimum(np.maximum(np.asarray(amt, float), 0.0), pre[:, CT])
    # minimal prefix rank covering amt: the prefixes are non-decreasing, so
    # counting the strictly-cheaper ones lands exactly where the compiled
    # backend's left bisect does
    lo = (pre < amt[:, None]).sum(axis=1)
    rm1 = np.maximum(lo - 1, 0)
    j = cnt[:, rm1]                                        # (C, S)
    a = np.take_along_axis(Acum, j.T[:, :, None], axis=2)[:, :, 0]
    base = np.clip(a - done, 0.0, None)
    marginal = cls_of_rank[rm1]
    split = base + np.maximum(amt - base.sum(axis=1), 0.0)[:, None] \
        * (np.arange(C)[None, :] == marginal[:, None])
    split = np.where((lo > 0)[:, None], split, 0.0)
    key = np.where(lo > 0, key_of_rank[rm1], -np.inf)
    return split, key


def table_head_key(Acum: np.ndarray, done: np.ndarray,
                   tables: dict) -> np.ndarray:
    """(S,) key of the head-of-queue cohort — the next mass a pour would
    touch; ``+inf`` when the queue is empty. The substep engine's preemption
    test compares this against a running batch's ``key`` (strictly lower
    head key interrupts), and its resume gate re-activates a checkpointed
    batch once no queued cohort outranks it."""
    cnt = tables["cnt"]
    key_of_rank = tables["key_of_rank"]
    CT = cnt.shape[1] - 1
    pre = table_prefix(Acum, done, cnt)
    hr = np.minimum((pre <= 0.0).sum(axis=1), CT)
    return np.where(pre[:, CT] > 0.0, key_of_rank[np.maximum(hr - 1, 0)],
                    np.inf)


def split_service(discipline, classes, admitted: np.ndarray,
                  capacity: np.ndarray, slot_bin: np.ndarray,
                  dt_s: float = 1.0) -> np.ndarray:
    """Replay per-slot service capacity against per-class arrival streams.

    admitted: (S, T, C) post-admission arrivals per bin and class.
    capacity: (S, K) mass each service slot can carry (clipped to backlog).
    slot_bin: (K,) bin of each slot, non-decreasing, covering bins in order.

    Returns served (S, K, C): the per-class mass each slot served under the
    discipline — the building block the property tests and the brute-force
    validation drive directly, and what ``multiclass_cohort_metrics`` turns
    into exact per-class sojourns.
    """
    admitted = np.asarray(admitted, float)
    capacity = np.asarray(capacity, float)
    slot_bin = np.asarray(slot_bin, int)
    S, T, C = admitted.shape
    K = capacity.shape[1]
    q = CohortQueue(discipline, classes, S, T, dt_s)
    served = np.zeros((S, K, C))
    k = 0
    for t in range(T):
        q.admit(t, admitted[:, t, :])
        while k < K and slot_bin[k] == t:
            amt = np.minimum(capacity[:, k], q.backlog().sum(axis=1))
            served[:, k, :] = q.serve(t, amt)
            k += 1
    return served
