"""Mesh construction.

Functions (not module-level constants) so importing this module never
touches device or process-group state.  The production shapes are the
reference's: a (16, 16) ('data', 'model') mesh of 256 devices, and the
multi-pod (2, 16, 16) ('pod', 'data', 'model') one of 512.

Every mesh function makes a real ``DeviceMesh`` (``init_device_mesh``)
over the process group the caller has already initialised, and raises
when that group's world size is not the mesh's size: a mesh is never
shrunk to the devices at hand.  ``make_abstract_mesh`` is the device-free stand-in the
sharding rules take where only axis names and sizes matter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.config import MeshConfig


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, with no devices behind it."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_abstract_mesh(shape: Sequence[int], axis_names: Sequence[str]
                       ) -> AbstractMesh:
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                         f"{tuple(axis_names)} differ in length")
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axis_names))


def _device_mesh(shape: Sequence[int], axis_names: Sequence[str],
                 device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    want = 1
    for s in shape:
        want *= int(s)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a {tuple(shape)} mesh needs an initialised process group of "
            f"{want} ranks (torch.distributed.init_process_group)")
    have = dist.get_world_size()
    if have != want:
        raise RuntimeError(f"a {tuple(shape)} {tuple(axis_names)} mesh needs "
                           f"{want} ranks; the process group has {have}")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_mesh(cfg: MeshConfig, device_type: str = "cuda"):
    return _device_mesh(cfg.shape, cfg.axis_names, device_type)


def make_test_mesh(data: int = 2, model: int = 2, pods: int = 0, *,
                   device_type: str = "cuda"):
    """A small mesh; on the CPU over a gloo or ``fake`` process group."""
    if pods:
        return _device_mesh((pods, data, model), ("pod", "data", "model"),
                            device_type)
    return _device_mesh((data, model), ("data", "model"), device_type)
