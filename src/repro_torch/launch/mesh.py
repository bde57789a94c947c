"""Mesh construction: the JAX package's ``launch/mesh.py`` on ``DeviceMesh``.

Functions only: importing this module touches no process group. A mesh of several
devices needs ``torch.distributed`` initialised with one process a device: ``init_world``
joins the world that ``torchrun`` (``python -m torch.distributed.run``) describes in the
environment, and starts a world of one for a lone process; ``fake_world`` makes one for
an analytic count. ``world_size`` stands where the reference asks ``len(jax.devices())``;
``is_main``, ``barrier`` and ``from_main`` are what the launchers need of a running world,
and ``torchrun`` starts one (``run_bounded`` bounds any process in time).

A world is started for one device type: ``"cpu"`` over gloo, ``"cuda"`` over NCCL (gloo
beside it for host tensors), one card a process, the card ``LOCAL_RANK`` taken before
the group starts. NCCL refuses two ranks on one card, so a world of several ranks on one
machine with one card runs on the CPU.

The reference's meshes have Auto axes only by intent (ROADMAP, R2); a ``DeviceMesh``
has no such split: every placement is explicit.
"""

from __future__ import annotations

import contextlib
import os
import signal
import socket
import subprocess
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed.sharding import mesh_axis_sizes

__all__ = [
    "barrier",
    "fake_world",
    "from_main",
    "init_world",
    "is_main",
    "make_dev_mesh",
    "make_production_mesh",
    "mesh_axis_sizes",
    "run_bounded",
    "torchrun",
    "world_size",
]

_BACKENDS = {"cpu": "gloo", "cuda": "cpu:gloo,cuda:nccl"}


def world_size() -> int:
    """The ranks of the running world, or of the one ``torchrun`` describes when none
    runs yet (1 for a lone process)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_main() -> bool:
    """Whether this process is rank 0 (or alone): the one that prints and writes."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", "0")) == 0


def barrier():
    """Every rank of a running world of several waits here; nothing otherwise."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def from_main(obj):
    """Rank 0's ``obj`` (picklable) on every rank of a running world of several;
    ``obj`` itself otherwise."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def run_bounded(cmd, timeout: float, **popen) -> subprocess.CompletedProcess:
    """``cmd`` in a session of its own, its output captured as text, the whole session
    (a torchrun agent's workers included) killed when it outlasts ``timeout`` seconds,
    and TimeoutError raised with the end of what it printed. ``popen`` goes to
    ``subprocess.Popen`` (``env``, ``cwd``, ``preexec_fn``)."""
    with subprocess.Popen(
        cmd,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        start_new_session=True,
        **popen,
    ) as p:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            out, err = p.communicate()
            what = " ".join(map(str, cmd[:8]))
            raise TimeoutError(
                f"{what} did not end within {timeout} s:\n{out[-3000:]}\n{err[-6000:]}"
            ) from None
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


def torchrun(n: int, argv, timeout: float, **popen) -> subprocess.CompletedProcess:
    """``python -m torch.distributed.run --standalone --nproc-per-node n argv``, a
    world of ``n`` ranks on this machine, through ``run_bounded``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone"]
    return run_bounded(cmd + ["--nproc-per-node", str(n), *map(str, argv)], timeout, **popen)


def init_world(device_type: str = "cuda"):
    """Join the world that ``torchrun``'s environment describes (``env://``), or start a
    world of one on localhost for a lone process; nothing when a world runs. On the card
    each process takes the card ``LOCAL_RANK`` first."""
    if dist.is_initialized():
        return
    if device_type not in _BACKENDS:
        raise ValueError(f"a world runs on 'cpu' or 'cuda', not {device_type!r}")
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        _init_single(device_type)
        return
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(_BACKENDS[device_type], init_method="env://")


def world_device_type() -> str | None:
    """The device type of the running world: "cuda" where its backend has NCCL, "cpu"
    where it has gloo alone, None for a world that serves every type (``fake_world``)."""
    if dist.get_backend() == "fake":
        return None
    return "cuda" if "nccl" in dist.get_backend_config() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_dev_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """Small mesh over the world's devices (tests / one card): (1, 1) for one, else
    (n / model, model) with model 4 or 2 where it divides n. Joins or starts the world
    (``init_world``) when none runs; raises ValueError when the running world was
    started for another device type."""
    init_world(device_type)
    have = world_device_type()
    if have is not None and have != device_type:
        raise ValueError(f"a {device_type!r} mesh on a world started for {have!r}")
    n = n_devices or dist.get_world_size()
    model = 1
    if n > 1:
        for m in (4, 2):
            if n % m == 0:
                model = m
                break
    return init_device_mesh(device_type, (n // model, model), mesh_dim_names=("data", "model"))


def _init_single(device_type: str):
    """A process group of one on localhost (gloo for the CPU, nccl besides on the card)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(
        _BACKENDS[device_type], init_method=f"tcp://localhost:{port}", world_size=1, rank=0
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
