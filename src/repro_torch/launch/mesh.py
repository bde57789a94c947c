"""Mesh construction: the JAX package's ``launch/mesh.py`` on ``DeviceMesh``.

Functions only: importing this module touches no process group. A mesh of several
devices needs ``torch.distributed`` initialised with one process a device (under
``torchrun``, or ``fake_world`` for an analytic count); ``make_dev_mesh`` on one device
starts a process group of one when none is running.

The reference's meshes have Auto axes only by intent (ROADMAP, R2); a ``DeviceMesh``
has no such split: every placement is explicit.
"""

from __future__ import annotations

import contextlib
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed.sharding import mesh_axis_sizes

__all__ = ["fake_world", "make_dev_mesh", "make_production_mesh", "mesh_axis_sizes"]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_dev_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """Small mesh over the world's devices (tests / one card): (1, 1) for one, else
    (n / model, model) with model 4 or 2 where it divides n."""
    if not dist.is_initialized():
        _init_single()
    n = n_devices or dist.get_world_size()
    model = 1
    if n > 1:
        for m in (4, 2):
            if n % m == 0:
                model = m
                break
    return init_device_mesh(device_type, (n // model, model), mesh_dim_names=("data", "model"))


def _init_single():
    """A process group of one on localhost (gloo for the CPU, nccl besides on the card)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=1, rank=0
    )


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks in this process, this one rank 0, whose
    collectives move nothing (the ``"fake"`` backend): for counting a sharded step on
    meta tensors, the counterpart of the reference's
    ``--xla_force_host_platform_device_count``. Torn down on exit; it refuses to start
    over a real process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world needs no process group running; one is")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
