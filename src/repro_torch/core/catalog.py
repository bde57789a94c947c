"""The cloud-'Shape' catalog (paper: CPU/GPU container shapes -> TPU v5e slices and
single-node H100 GPU shapes).

The v5e entries are kept so the recommender answers as the JAX package does on
the same rows. ``CloudShape.make_mesh`` builds a shape's ``DeviceMesh``; a shape of
more than one chip needs a process group of that many ranks (under ``torchrun``, or
``launch.mesh.fake_world`` for an analytic count on meta tensors). Shapes of several
GPU nodes are not in the catalog: the reference has none.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.cost_model import H100, V5E, HardwareSpec


@dataclass(frozen=True)
class CloudShape:
    name: str
    mesh_shape: tuple
    axes: tuple
    hw: HardwareSpec = V5E

    @property
    def chips(self) -> int:
        n = 1
        for s in self.mesh_shape:
            n *= s
        return n

    @property
    def price_per_hour(self) -> float:
        return self.chips * self.hw.price_per_chip_hour

    def make_mesh(self, device_type: str = "cuda"):
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(device_type, self.mesh_shape, mesh_dim_names=self.axes)


CATALOG: list[CloudShape] = [
    CloudShape("v5e-4", (2, 2), ("data", "model")),
    CloudShape("v5e-8", (2, 4), ("data", "model")),
    CloudShape("v5e-16", (4, 4), ("data", "model")),
    CloudShape("v5e-32", (4, 8), ("data", "model")),
    CloudShape("v5e-64", (8, 8), ("data", "model")),
    CloudShape("v5e-128", (8, 16), ("data", "model")),
    CloudShape("v5e-256", (16, 16), ("data", "model")),
    CloudShape("2x-v5e-256", (2, 16, 16), ("pod", "data", "model")),
    # one node, 1/2/4/8 GPUs joined by NVLink
    CloudShape("h100-1", (1, 1), ("data", "model"), H100),
    CloudShape("h100-2", (1, 2), ("data", "model"), H100),
    CloudShape("h100-4", (1, 4), ("data", "model"), H100),
    CloudShape("h100-8", (1, 8), ("data", "model"), H100),
]

_BY_NAME: dict[str, CloudShape] = {s.name: s for s in CATALOG}


def get_shape(name: str) -> CloudShape:
    try:
        return _BY_NAME[name]
    except KeyError:
        known = [s.name for s in CATALOG]
        raise KeyError(f"unknown cloud shape {name!r}; known: {known}") from None


def register_shape(shape: CloudShape, overwrite: bool = False) -> CloudShape:
    """Add a custom shape to the catalog (e.g. fleet scenarios injecting
    non-standard slices or alternate HardwareSpecs)."""
    if shape.name in _BY_NAME and not overwrite:
        raise ValueError(
            f"shape {shape.name!r} already registered (pass overwrite=True to replace)"
        )
    if shape.name in _BY_NAME:
        CATALOG[[s.name for s in CATALOG].index(shape.name)] = shape
    else:
        CATALOG.append(shape)
    _BY_NAME[shape.name] = shape
    return shape
