"""End-to-end driver on the PyTorch/CUDA port: train the FULL mamba2-130m (~130M
params) for a few hundred steps, with checkpointing, fault tolerance, and resume.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300              # on the card
    PYTHONPATH=src python examples/torch_train_lm.py --smoke --steps 20 --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        examples/torch_train_lm.py --smoke --steps 20 --device cpu    # sharded, 2 ranks
(Ctrl-C and re-run: it resumes from the last checkpoint.) Under ``torchrun`` the model
trains on a mesh of the world's ranks and rank 0 prints.

The counterpart of ``examples/train_lm.py``; it imports only ``repro_torch``.
"""

import argparse
import dataclasses

import torch.distributed as dist

from repro_torch.launch.mesh import is_main
from repro_torch.launch.train import TrainJob, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", help="tiny config instead")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_train_lm")
    args = ap.parse_args(argv)

    job = TrainJob(
        arch="mamba2-130m",
        smoke=args.smoke,  # full 130M config by default
        steps=args.steps,
        seq_len=args.seq_len,
        global_batch=args.batch,
        n_microbatches=2,
        peak_lr=6e-4,
        warmup=50,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        log_every=10,
        device=args.device,
    )
    metrics = train(job)
    if is_main():
        print(f"\nfinal: {metrics}")
        print("loss curve (every 25 steps):")
        for h in job.history[::25]:
            print(f"  step {h['step']:4d}: {h['loss']:.4f}")
    return {"job": dataclasses.asdict(job), "metrics": metrics}


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
