"""Batched LM serving demo on the PyTorch/CUDA port: prefill a batch of prompts, decode
with the KV/state cache, report throughput, across three architecture families
(attention, MoE, SSM) through one API.

    PYTHONPATH=src python examples/torch_serve_lm.py                 # on the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        examples/torch_serve_lm.py --device cpu                      # sharded, 2 ranks

Under ``torchrun`` each model is sharded over the world's ranks and rank 0 prints. The
counterpart of ``examples/serve_lm.py``; it imports only ``repro_torch``.
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.launch.mesh import is_main
from repro_torch.launch.serve import generate

ARCHS = ("minitron-4b", "olmoe-1b-7b", "mamba2-130m")


def main(device=None, archs=ARCHS) -> dict:
    """Each arch's smoke config served on ``device`` (the card unless ``"cpu"``).
    Returns {arch: (tokens/s, the first sequence's tokens)}."""
    out = {}
    for arch in archs:
        r = generate(arch, smoke=True, batch=4, prompt_len=32, gen_tokens=16, device=device)
        out[arch] = (r.tokens_per_s, r.tokens[0].tolist())
        if is_main():
            print(
                f"{arch:22s} prefill={r.prefill_s * 1e3:7.1f}ms "
                f"decode={r.decode_s * 1e3:7.1f}ms  {r.tokens_per_s:7.1f} tok/s  "
                f"sample={r.tokens[0][:8].tolist()}"
            )
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
    if dist.is_initialized():
        dist.destroy_process_group()
