"""The ``prefill`` loop: a language model's prefill, served in a closed loop.

A unit is one prefill of ``batch`` prompts of ``prompt_len`` tokens, through the
system's cache, ending in each prompt's first greedy token in host memory; the next
unit is submitted when it is there. Prompts come from a pool of ``pool`` batches made
from the seed and taken in turn: token ids drawn Zipf (``zipf_s``) over the whole
vocabulary, the ranks shuffled by the seed, as natural text's are, so that the
experts' load is uneven. A unit's latency runs from its submission to its first
tokens on the host, so ``p95_ms`` is a batch's time to first token; ``unit_obs`` is
its prompt tokens, so ``obs_per_s`` is prefill tokens a second.

The check takes one prompt of each sampled unit: its last-token logits from the timed
prefill, then ``decode_steps`` greedy steps through that prefill's own cache, each
step's logits against the float32 reference's (``reference_granite.py``) one forward
over the prompt and the tokens fed, computed a layer at a time; and the state that the
timed prefill's first Mamba-2 layer reached over the prompt, against the reference's
float32 recurrence over the inputs that layer's scan was given. The logits read every
rounding of the bfloat16 products, amplified where it turns the routing to another
expert; the state reads the precision of the scan alone, which the configuration keeps
in float32.
"""

from __future__ import annotations

import math
import random
import time

import torch

from portbench import reference_granite as reference
from portbench import telemetry
from portbench import trace as tracing
from portbench.harness import Cell, Device, Run

WEIGHTS, TOKENS = 1, 2  # sub-seed parts


def zipf_tokens(seed: int, shape, vocab: int, s: float, device, part: int):
    """Token ids of ``shape``: ranks drawn with probability ∝ 1 / rank^s over the
    vocabulary, mapped to ids by a permutation drawn from the seed (one for every
    batch of a run)."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device).pow(-s)
    cdf = torch.cumsum(ranks, 0) / ranks.sum()
    perm = torch.randperm(vocab, generator=telemetry.generator(seed, TOKENS, device), device=device)
    u = torch.rand(shape, generator=telemetry.generator(seed, TOKENS + 1 + part, device),
                   dtype=torch.float64, device=device)
    return perm[torch.searchsorted(cdf, u).clamp_(max=vocab - 1)]


def gaps(port, ref) -> tuple[float, float]:
    """Each logit vector (last dim) of the port against the reference's: (the largest
    |difference| over the reference's standard deviation, the norm of the difference
    over that of the reference about its mean), the worst of each over the vectors."""
    ref = ref.double()
    diff = port.double() - ref
    dev = ref - ref.mean(-1, keepdim=True)
    peak = diff.abs().amax(-1) / ref.std(-1)
    rms = diff.norm(dim=-1) / dev.norm(dim=-1)
    return float(peak.max()), float(rms.max())


class Loop:
    def __init__(self, run: Run, dev: Device, sut, cell: Cell):
        self.run, self.dev, self.sut = run, dev, sut
        self.cfg, self.tr = cell.config, cell.traffic

    def setup(self):
        """The weights, the prompt pool and a pinned buffer for the first tokens, then
        the warm-up; -> the warm-up's seconds a unit."""
        cfg, tr, dev, run = self.cfg, self.tr, self.dev, self.run
        t = time.perf_counter()
        self.sut.prepare(cfg, telemetry.sub_seed(run.seed, WEIGHTS), dev.dev)
        dev.sync()
        run.phases["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        shape = (tr["batch"], tr["prompt_len"])
        self.pool = [zipf_tokens(run.seed, shape, cfg["vocab_size"], tr["zipf_s"], dev.dev, i)
                     for i in range(tr["pool"])]
        self.first = dev.host((tr["batch"],), torch.int64)
        dev.sync()
        run.phases["data_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.window(units=tr["warmup_units"], measure=False)
        run.phases["warmup_s"] = time.perf_counter() - t
        return run.phases["warmup_s"] / tr["warmup_units"]

    def window(self, seconds=None, units=None, measure=True, samples=()):
        dev, run, sut, tr = self.dev, self.run, self.sut, self.tr
        traced = run.traced and measure
        self.sampled, subs, done = {}, [], []
        rng = random.Random(telemetry.sub_seed(run.seed, 1 << 21))  # each sample's prompt
        picks = {k: rng.randrange(tr["batch"]) for k in sorted(samples)}
        t_start = time.perf_counter()
        t_end = t_start + seconds if seconds is not None else math.inf
        k = 0
        while (units is None or k < units) and (k == 0 or time.perf_counter() < t_end):
            tokens = self.pool[k % len(self.pool)]
            subs.append(time.perf_counter())
            with tracing.span("unit", traced):
                logits, state, scan = sut.prefill(tokens, tr["decode_steps"], tap=picks.get(k))
                first = logits.argmax(-1)
                self.first.copy_(first)  # waits for the unit: its tokens on the host
            done.append(time.perf_counter())
            if k in samples:
                self.sampled[k] = (logits.float(), state, first, scan, picks[k])
            del logits, state, scan
            k += 1
        if measure:
            run.units = k
            run.unit_obs = tr["batch"] * tr["prompt_len"]
            run.window_s = done[-1] - t_start
            run.latencies_ms = [(d - s) * 1e3 for s, d in zip(subs, done)]
            run.intervals_ms = [(b - a) * 1e3 for a, b in zip(done, done[1:])]

    def free(self):
        pass

    def check(self) -> dict:
        """One prompt of each sampled unit (drawn from the seed): its prefill's logits, its
        decode steps' and its first Mamba-2 layer's state against the float32 reference."""
        n = self.tr["decode_steps"]
        first_mamba = next(lp["mamba"] for lp in self.sut.params["layers"] if "mamba" in lp)
        worst = {"prefill_gap": 0.0, "prefill_rms": 0.0, "decode_gap": 0.0, "decode_rms": 0.0,
                 "state_rms": 0.0}
        checked = 0
        for k in sorted(self.sampled):
            logits, state, first, scan, b = self.sampled.pop(k)
            tokens = self.pool[k % len(self.pool)]
            decoded, fed = self.sut.decode(state, tokens, first, n)
            del state
            seq = torch.cat([tokens[b], fed[b]])[None]
            ref = reference.forward(self.cfg, self.sut.params, seq, last=n + 1)[0]
            inputs = (scan[name].float() for name in ("xs", "dt", "Bm"))
            want = reference.recurrence(self.cfg, first_mamba, *inputs)[1].double()
            gap = float((scan["state"].double() - want).norm() / want.norm())
            worst["state_rms"] = max(worst["state_rms"], gap if math.isfinite(gap) else math.inf)
            del scan, want
            for name, port, want in (("prefill", logits[b], ref[0]), ("decode", decoded[b], ref[1:])):
                peak, rms = gaps(port, want)
                worst[f"{name}_gap"] = max(worst[f"{name}_gap"], peak if math.isfinite(peak) else math.inf)
                worst[f"{name}_rms"] = max(worst[f"{name}_rms"], rms if math.isfinite(rms) else math.inf)
            checked += 1
        return {**worst, "checked": checked}
