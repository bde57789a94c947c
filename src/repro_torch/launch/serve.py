"""Batched serving driver: prefill prompts into a KV cache, then greedy decode.
Counterpart of the JAX package's ``launch/serve.py`` for every family: dense, MoE,
SSM, hybrid, and enc-dec (seamless-m4t-large-v2), whose prefill first encodes a
source of ``enc_memory_len`` random frames.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b --full \\
        --batch 4 --prompt-len 2048 --tokens 32
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch._device import resolve_device, sync
from repro_torch.configs import get_config
from repro_torch.models.layers import working_dtype
from repro_torch.models.model import build_model


def decode_flops_bytes(cfg, batch: int, ctx: int = 512):
    """Analytic per-decode-step cost of batched serving (one token for each of
    ``batch`` sequences at context ``ctx``) — roofline feedstock for the fleet
    scenarios.

    FLOPs: 2 FLOPs/param on the *active* params per token, plus attention
    against the KV cache. Bytes: every weight streamed once per step (the
    decode-bandwidth wall) plus the KV cache read.
    """
    counts = cfg.param_counts()
    dt_bytes = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    q_dim = max(cfg.n_heads, 0) * max(cfg.head_dim, 0)  # query heads
    kv_dim = max(cfg.n_kv_heads, 0) * max(cfg.head_dim, 0)  # cached heads
    flops = 2.0 * counts["active"] * batch
    flops += 4.0 * batch * cfg.n_layers * q_dim * ctx  # QK^T + AV
    bytes_ = counts["total"] * dt_bytes
    bytes_ += 2.0 * batch * cfg.n_layers * kv_dim * ctx * dt_bytes
    return flops, bytes_


@dataclass
class GenResult:
    tokens: np.ndarray
    prefill_s: float
    decode_s: float
    tokens_per_s: float


def decode_greedy(model, cache, logits, pos: int, n: int):
    """n greedy tokens (B, n): the first from ``logits`` (the prefill's last-token
    logits), then n - 1 decode steps from absolute position ``pos``, each feeding back
    the previous token. The cache is updated in place."""
    out = [logits[:, -1].argmax(-1)]
    for i in range(n - 1):
        cache, logits = model.decode_step(cache, out[-1][:, None], pos + i)
        out.append(logits[:, -1].argmax(-1))
    return torch.stack(out, dim=1)


def generate(
    arch: str,
    *,
    smoke: bool = True,
    batch: int = 4,
    prompt_len: int = 32,
    gen_tokens: int = 16,
    seed: int = 0,
    device=None,
) -> GenResult:
    """Random weights and prompts from one ``torch.Generator`` seeded with ``seed``
    on ``device`` (None -> cuda), prefill, then ``gen_tokens - 1`` greedy decode steps.
    An enc-dec config's source is frames of (batch, ``enc_memory_len``, d_model), normal
    draws from the same generator after the prompts, in the working dtype, as the
    reference's.

    The KV cache is allocated once at ``prompt_len + gen_tokens`` and filled in place;
    the reference prefills a prompt-length cache and pads it (``pad_cache``). Prefill
    time counts the cache's allocation, as the reference's counts the padding, and the
    encoder, as the reference's does. Decoding is greedy, as in the reference."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = build_model(cfg, dev, g)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g, device=dev)
    source = {}
    if cfg.encdec:
        shape = (batch, cfg.enc_memory_len, cfg.d_model)
        source["frames"] = torch.randn(shape, generator=g, device=dev).to(working_dtype(cfg))
    max_len = prompt_len + gen_tokens

    sync()
    t0 = time.perf_counter()
    cache, logits = model.prefill(prompts, model.init_cache(batch, max_len), **source)
    sync()
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    toks = decode_greedy(model, cache, logits, prompt_len, gen_tokens)
    sync()
    t_decode = time.perf_counter() - t0
    tps = batch * (gen_tokens - 1) / max(t_decode, 1e-9)
    return GenResult(toks.cpu().numpy(), t_prefill, t_decode, tps)


def main():
    ap = argparse.ArgumentParser(
        description="Serve a registered architecture with random weights: prefill a batch "
        "of random prompts (an enc-dec arch, seamless-m4t-large-v2, first encodes "
        "enc_memory_len random frames), then greedy decode."
    )
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()
    r = generate(
        args.arch,
        smoke=not args.full,
        batch=args.batch,
        prompt_len=args.prompt_len,
        gen_tokens=args.tokens,
        device=args.device,
    )
    print(
        f"[serve] {resolve_device(args.device)}: prefill {r.prefill_s * 1e3:.1f}ms "
        f"decode {r.decode_s * 1e3:.1f}ms ({r.tokens_per_s:.1f} tok/s) "
        f"sample: {r.tokens[0][:12]}"
    )


if __name__ == "__main__":
    main()
