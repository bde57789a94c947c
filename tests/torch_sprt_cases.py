"""SPRT inputs shared by the CPU tests (``test_torch_sprt.py``), the ``gpu`` tests
(``test_torch_gpu.py``) and ``chip_smoke.py``: the cases the chunked scan of K3 is held
to, each made from a seed with numpy.

Chunk edges fall on the NaN residuals: 448 = 7 x 64 is the first step of a chunk at
chunk lengths 1, 7, 64 and 448, and 447 the last; T - 1 is the first step of the
second chunk at chunk length T - 1 and the last step of the only chunk at T.
"""

import numpy as np

# name: (T, n, with mu, kind)
CASES = {
    "gauss": (1000, 6, True, "gauss"),
    "gauss-no-mu": (1000, 6, False, "gauss"),
    "shift-3sigma": (1000, 6, True, "shift"),
    "pathological": (1000, 4, False, "pathological"),
    "nan-at-chunk-edges": (1000, 6, True, "nan"),
    "one-step": (1, 5, True, "shift"),
    "one-signal": (1000, 1, True, "shift"),
}
NAN_AT = [(448, 1), (447, 2), (999, 3)]

# chunk lengths by name, as functions of T: short chunks, chunk edges at T, one chunk
CHUNKS = {
    "1": lambda T: 1,
    "7": lambda T: 7,
    "64": lambda T: 64,
    "447": lambda T: 447,
    "448": lambda T: 448,
    "T-1": lambda T: T - 1,
    "T": lambda T: T,
    "T+1": lambda T: T + 1,
    "3T": lambda T: 3 * T,
}


def case_inputs(name):
    """(residuals (T, n), sigma (n,), mu (n,) or None), float32 numpy arrays.

    ``pathological`` is r = 1.6 with sigma = 1 and no mean: the positive sum climbs
    0.3 a step and restarts every 24 steps, so a run from another start keeps its
    own phase for ever and pass 2 re-runs the whole of every chunk after the first."""
    T, n, with_mu, kind = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if kind == "pathological":
        return np.full((T, n), 1.6, np.float32), np.ones(n, np.float32), None
    r = rng.standard_normal((T, n)).astype(np.float32)
    sigma = rng.uniform(0.8, 1.2, n).astype(np.float32)
    mu = rng.uniform(-0.1, 0.1, n).astype(np.float32) if with_mu else None
    if kind == "shift":
        r[T // 2 :, ::2] += 3.0  # a 3 sigma shift to alarm on, in every other signal
        r[2 * T // 3 :, 1::2] -= 3.0
    if kind == "nan":
        for at in NAN_AT:
            r[at] = np.nan
    return r, sigma, mu


def chunked_params():
    """(case, chunk name) pairs, without chunk lengths below 1 or repeats of a case's
    lengths."""
    pairs = []
    for name, (T, *_) in CASES.items():
        seen = set()
        for label, fn in CHUNKS.items():
            L = fn(T)
            if L >= 1 and L not in seen:
                seen.add(L)
                pairs.append((name, label))
    return pairs
