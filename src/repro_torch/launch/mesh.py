"""Device meshes.

Single pod: 16x16 = 256 devices, axes (data, model).
Multi-pod:  2x16x16 = 512 devices, axes (pod, data, model): `pod` is pure
data parallelism across pods.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the default
process group, which the caller starts (`init_process_group` with its
address, world size and rank; the dry-run starts a fake group). Defined as
functions, so importing this module touches no process group.
`AbstractMesh` carries a mesh's shape and axis names alone, for the
sharding rules and their tests.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.models.pspec import mesh_axes

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, no devices (JAX's AbstractMesh):
    enough for `param_specs`, `cache_specs` and the pspec rules."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        return math.prod(self.shape)


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = _world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {n} ranks, found "
            f"{world} — run the production mesh through the dry-run "
            "(python -m repro_torch.launch.dryrun), which starts a fake "
            f"group of {n} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), device_type="cuda"):
    """A small mesh over the default group (whose world size must be the
    mesh's size): subprocess tests on gloo, one card on NCCL."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh."""
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


__all__ = ["AbstractMesh", "MULTI_POD", "SINGLE_POD", "dp_axes",
           "make_debug_mesh", "make_production_mesh", "mesh_axes"]
