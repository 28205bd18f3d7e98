"""The data-parallel mesh of a run: its axes, their sizes and the process
group of every set of axes an exchange runs over.

A mesh shape is written as the reference's ``--mesh``: ``N`` or ``Nx1``
(one dp axis, ``("dp",)``), ``PxNx1`` (``("pod", "data")``: P pods of N
ranks).  The trailing model axis must be 1: tensor parallelism is not
ported.  When the mesh has more than one dp axis the leading one is the
pod (cross-pod) axis (:func:`pod_split`).

:func:`build_mesh` makes the groups over the initialised default process
group, a ``torch.distributed.device_mesh.DeviceMesh`` for the two-axis
mesh (global rank = pod * N + data; the "pod" group's rank is the pod
index, the "data" group's the data index, the reference's axis order),
and installs the axes -> group map that ``plan.executor`` reads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.plan import executor as _exec

FLAT_AXES = ("dp",)
POD_AXES = ("pod", "data")


def parse_mesh(spec) -> Tuple[int, ...]:
    """The dp sizes of a mesh written ``N``, ``Nx1`` or ``PxNx1`` (or given
    as a tuple of ints); a model axis above 1 raises."""
    shape = tuple(int(s) for s in (spec.split("x") if isinstance(spec, str)
                                   else spec))
    if not shape or len(shape) > 3 or any(s < 1 for s in shape):
        raise ValueError(f"mesh {spec!r}: expected N, Nx1 or PxNx1")
    if len(shape) >= 2:
        if shape[-1] != 1:
            raise NotImplementedError(
                f"mesh {spec!r}: a model axis of {shape[-1]} needs tensor "
                "parallelism, which the port does not have yet")
        shape = shape[:-1]
    return shape


def mesh_axes(dp_sizes: Sequence[int]) -> Tuple[str, ...]:
    """Axis names of a mesh with these dp sizes."""
    return FLAT_AXES if len(dp_sizes) == 1 else POD_AXES


def pod_split(dp_axes: Sequence[str], dp_sizes: Sequence[int]):
    """The pod-axis convention: with more than one dp axis the leading one
    is the pod (cross-pod) axis and the rest are intra-pod.  Returns
    (inner_axes, outer_axes, n_inner, n_outer); a single dp axis is one
    pod (outer empty)."""
    dp_axes, dp_sizes = tuple(dp_axes), tuple(dp_sizes)
    if len(dp_axes) > 1:
        return dp_axes[1:], dp_axes[:1], math.prod(dp_sizes[1:]), \
            dp_sizes[0]
    return dp_axes, (), math.prod(dp_sizes), 1


@dataclasses.dataclass(frozen=True)
class DpMesh:
    """A built mesh: axis names and sizes, and the groups of every axis set
    (None = the default group)."""

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    groups: Dict[Tuple[str, ...], Optional[object]]

    @property
    def n_dp(self) -> int:
        return math.prod(self.sizes)


def build_mesh(spec, device_type: str = "cpu") -> DpMesh:
    """Build the mesh ``spec`` over the default process group (which must
    span exactly its ranks; none needed for one rank) and install its
    groups for the executor."""
    sizes = parse_mesh(spec)
    axes = mesh_axes(sizes)
    n = math.prod(sizes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"mesh {spec!r} holds {n} ranks, the process group "
                         f"{world}")
    groups: Dict[Tuple[str, ...], Optional[object]] = {}
    if n > 1:
        groups[axes] = None
        if len(axes) == 2:
            from torch.distributed.device_mesh import init_device_mesh
            dm = init_device_mesh(device_type, sizes, mesh_dim_names=axes)
            for a in axes:
                groups[(a,)] = dm.get_group(a)
    _exec.set_groups(groups)
    return DpMesh(axes=axes, sizes=sizes, groups=groups)
