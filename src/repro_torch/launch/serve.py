"""Batched serving driver: prefill prompts into a KV cache, then greedy decode.
Counterpart of the JAX package's ``launch/serve.py`` for every family: dense, MoE,
SSM, hybrid, and enc-dec (seamless-m4t-large-v2), whose prefill first encodes a
source of ``enc_memory_len`` random frames.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b --full \\
        --batch 4 --prompt-len 2048 --tokens 32
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.serve --arch olmoe-1b-7b --device cpu      # 4 CPU ranks

Under ``torchrun`` with N > 1 processes, one device each, the model is sharded on a mesh
of them (``make_dev_mesh``, the reference's multi-device ``generate``): every rank draws
the same weights and prompts, keeps its blocks, and returns the same gathered tokens.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device, sync
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import full, local_part, make_rules
from repro_torch.launch.mesh import barrier, is_main, make_dev_mesh, world_size
from repro_torch.launch.steps import batch_sharding
from repro_torch.models import moe
from repro_torch.models.layers import working_dtype
from repro_torch.models.model import Model, build_model


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


def _sharded(cfg, dev, g, mesh):
    """The model of ``build_model(cfg, dev, g)`` sharded on ``mesh``: the same draws,
    its experts padded to the ``model`` axis where they do not divide it."""
    rules = make_rules(mesh)
    ep = rules.axis_size("model")
    model = build_model(cfg, dev, g)
    if cfg.moe and moe.padded_experts(cfg, ep) != cfg.n_experts:
        model = Model(cfg, dev, ep_size=ep).load_numpy(model.to_numpy())
    return model.shard(rules)


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
    encoder, as the reference's does. Decoding is greedy, as in the reference.

    In a world of several ranks the model is sharded on ``make_dev_mesh``, the prompts
    (and frames) placed by the batch axes, and the tokens gathered: every rank returns
    the same result; each time ends when every rank is done."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    g = torch.Generator(device=dev).manual_seed(seed)
    mesh = make_dev_mesh(device_type=dev.type) if world_size() > 1 else None
    model = build_model(cfg, dev, g) if mesh is None else _sharded(cfg, dev, g, mesh)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g, device=dev)
    inputs = {"tokens": prompts}
    if cfg.encdec:
        shape = (batch, cfg.enc_memory_len, cfg.d_model)
        inputs["frames"] = torch.randn(shape, generator=g, device=dev).to(working_dtype(cfg))
    if mesh is not None:
        placed = batch_sharding(model.rules, inputs)
        inputs = {k: local_part(v, placed[k]) for k, v in inputs.items()}
    prompts = inputs.pop("tokens")
    max_len = prompt_len + gen_tokens

    sync()
    barrier()  # a time read after it is the world's
    t0 = time.perf_counter()
    cache, logits = model.prefill(prompts, model.init_cache(batch, max_len), **inputs)
    sync()
    barrier()
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    toks = decode_greedy(model, cache, logits, prompt_len, gen_tokens)
    sync()
    barrier()
    t_decode = time.perf_counter() - t0
    tps = batch * (gen_tokens - 1) / max(t_decode, 1e-9)
    return GenResult(full(toks).cpu().numpy(), t_prefill, t_decode, tps)


def main(argv=None):
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
    ap.add_argument("--out", default=None, help="also write the result here as JSON")
    args = ap.parse_args(argv)
    r = generate(
        args.arch,
        smoke=not args.full,
        batch=args.batch,
        prompt_len=args.prompt_len,
        gen_tokens=args.tokens,
        device=args.device,
    )
    if is_main():
        print(
            f"[serve] {resolve_device(args.device)} x {world_size()}: prefill "
            f"{r.prefill_s * 1e3:.1f}ms decode {r.decode_s * 1e3:.1f}ms "
            f"({r.tokens_per_s:.1f} tok/s) sample: {r.tokens[0][:12]}"
        )
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(vars(r), tokens=r.tokens.tolist()), f)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
