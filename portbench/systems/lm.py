"""The ``lm`` system: a language model's serving path, as the port (the system under
test: ``repro_torch``'s ``Model.prefill`` and ``decode_step`` through the model's own
cache) and, in its place, the control: the plain reference, ``reference_granite.py``,
below the configuration's precision. The configuration keeps its weights and products
in bfloat16 and the SSD's state, decay and scan, the norms and the softmaxes in
float32; the control computes every step in bfloat16, those parts too.

Both draw the same weights from the seed with the reference's ``init_params``; the
port views them in its own layout (``from_reference``), so the check's float32
reference reads the very weights the port ran. Each gives ``prepare``, ``prefill`` and
``decode`` with one signature. ``prefill(..., tap=b)`` also returns, for prompt b, the
first Mamba-2 layer's recurrence as that prefill ran it: its inputs, in the form that
``reference_granite.recurrence`` takes, and its state after the prompt (None without
``tap``). The port is imported only when it is built, so that the benchmark's tests
and the control never load it; a program without the configuration's ``arch`` raises
in ``prepare``, before any weight is drawn.
"""

from __future__ import annotations

import importlib

import torch

from portbench import reference_granite as reference

BF16 = torch.bfloat16


def greedy(step, first, n: int):
    """n greedy steps from the tokens ``first`` (B,): ``step(i, tokens (B,))`` feeds the
    tokens at the i-th position after the prompt and returns the logits there (B, V).
    -> (logits (B, n, V) float32, the tokens fed (B, n))."""
    fed, out = [first], []
    for i in range(n):
        out.append(step(i, fed[-1]).float())
        fed.append(out[-1].argmax(-1))
    return torch.stack(out, 1), torch.stack(fed[:-1], 1)


class Port:
    """``repro_torch``: the configuration's ``arch`` cut to its ``num_hidden_layers``."""

    name = "port"

    def __init__(self):
        self.configs = importlib.import_module("repro_torch.configs")
        self.model_mod = importlib.import_module("repro_torch.models.model")

    def arch(self, cfg: dict):
        """The port's config of ``cfg["arch"]`` at the configuration's depth."""
        return self.configs.get_config(cfg["arch"]).replace(n_layers=cfg["num_hidden_layers"])

    def prepare(self, cfg: dict, seed: int, device):
        arch = self.arch(cfg)
        wrong = {k: (cfg.get(k), v) for k, v in arch.published().items() if cfg.get(k) != v}
        if wrong:
            raise ValueError(f"{cfg['name']} differs from the port's {arch.name}: {wrong}")
        self.params = reference.init_params(cfg, seed, device)
        self.model = self.model_mod.from_reference(arch, self.params)

    def prefill(self, tokens, extra: int, tap=None):
        """tokens (B, S) -> (last-token logits (B, V), the cache, of S + ``extra``, the
        first Mamba-2 layer's recurrence for prompt ``tap`` or None)."""
        cache = self.model.init_cache(tokens.shape[0], tokens.shape[1] + extra)
        if tap is None:
            cache, logits = self.model.prefill(tokens, cache)
            return logits[:, -1], cache, None
        a, kept = self.model.cfg, {}
        din, GN, S = a.d_inner, a.ssm_ngroups * a.ssm_state, tokens.shape[1]

        def step(name, fn):  # the first Mamba-2 layer's dt, conv output and last state
            out = fn()
            if name not in kept:
                if name == "in_proj":  # dt: its last H columns
                    kept[name] = out[tap : tap + 1, :, -a.ssm_nheads :].clone()
                elif name == "conv":  # x and B
                    kept[name] = out[tap : tap + 1, :, : din + GN].clone()
                elif name == "SSD":
                    kept[name] = out[1][tap : tap + 1].clone()
            return out

        cache, logits = self.model.prefill(tokens, cache, step)
        xbc = kept["conv"]
        scan = {"xs": xbc[..., :din].reshape(1, S, a.ssm_nheads, a.ssm_headdim), "dt": kept["in_proj"],
                "Bm": xbc[..., din:].reshape(1, S, a.ssm_ngroups, a.ssm_state), "state": kept["SSD"]}
        return logits[:, -1], cache, scan

    def decode(self, cache, tokens, first, n: int):
        """n greedy steps through the prefill's cache."""
        S = tokens.shape[1]

        def step(i, t):
            return self.model.decode_step(cache, t[:, None], S + i)[1][:, -1]

        return greedy(step, first, n)


class Control:
    """The reference in the program's place, every step in bfloat16, with no cache: a
    decode step is a whole forward over the prompt and the tokens fed so far."""

    name = "control"

    def prepare(self, cfg: dict, seed: int, device):
        self.cfg = cfg
        self.params = reference.init_params(cfg, seed, device)

    def forward(self, tokens, tap=None):
        return reference.forward(self.cfg, self.params, tokens, dtype=BF16, tap=tap)

    def prefill(self, tokens, extra: int, tap=None):
        kept = {}

        def keep(i, xs, dt, Bm, state):  # the first Mamba-2 layer's, prompt ``tap``'s
            if not kept:
                kept.update(zip(("xs", "dt", "Bm", "state"),
                                (t[tap : tap + 1] for t in (xs, dt, Bm, state))))

        logits = self.forward(tokens, None if tap is None else keep)
        return logits[:, -1], tokens, kept or None

    def decode(self, tokens, _, first, n: int):
        fed = [first[:, None]]

        def step(i, t):
            if i:
                fed.append(t[:, None])
            return self.forward(torch.cat([tokens, *fed], 1))[:, -1]

        return greedy(step, first, n)


SYSTEMS = {"port": Port, "control": Control}
