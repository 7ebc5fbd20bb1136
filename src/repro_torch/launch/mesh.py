"""Mesh descriptions: the axes a plan shards over, without devices.

The counterpart of the JAX package's ``launch/mesh.py``:

Single pod: 16 x 16 = 256 chips, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 chips, axes (pod, data, model); the 'pod'
axis is pure data parallelism across pods.

A :class:`Mesh` is a shape and its axis names, nothing more: the plans
(``launch/sharding.py``) and the dry-run (``launch/dryrun.py``) take it
with no process group and no device, at production sizes.  A mesh run
(``serve(..., mesh=)`` / ``train(..., mesh=)``) makes the process groups
of its description (``launch/distributed.py::MeshRun``), inside a process
group that it is given.  Importing this module touches no device and no
process group.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

AXES = ("pod", "data", "model")


@dataclass(frozen=True)
class Mesh:
    dims: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh dims {self.dims} and axes "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names) or not set(
                self.axis_names) <= set(AXES):
            raise ValueError(f"mesh axes {self.axis_names}: distinct names "
                             f"from {AXES}")
        if any(int(n) < 1 for n in self.dims):
            raise ValueError(f"mesh dims {self.dims} must be positive")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}``, in the axes' order."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def make_mesh(dims, axis_names=None) -> Mesh:
    """A mesh of ``dims``; without names, two dims are (data, model) and
    three (pod, data, model)."""
    dims = tuple(int(n) for n in dims)
    if axis_names is None:
        if len(dims) not in (2, 3):
            raise ValueError(f"mesh dims {dims}: name the axes of a mesh "
                             f"that is not 2- or 3-dimensional")
        axis_names = AXES[3 - len(dims):]
    return Mesh(dims, tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    return make_mesh((2, 16, 16) if multi_pod else (16, 16))


def make_host_mesh() -> Mesh:
    """The 1 x 1 mesh: one rank, the distributed code paths on one
    device."""
    return make_mesh((1, 1))


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def data_shards(mesh: Mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n

