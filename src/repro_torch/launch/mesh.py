"""The mesh of a run: its data-parallel axes and model axis, their sizes,
and the process group of every set of axes a collective runs over.

A mesh shape is written as the reference's ``--mesh``: ``N`` (one dp axis,
``("dp",)``), ``NxT`` (N dp ranks x a model axis of T), ``PxNxT``
(``("pod", "data")``: P pods of N ranks, x T).  When the mesh has more
than one dp axis the leading one is the pod (cross-pod) axis
(:func:`pod_split`).

The model axis varies fastest: global rank = dp index * T + model index,
the dp index = pod * N + data, the reference's axis order.  Each model
rank runs the optimizer's exchange over its own dp group (the ranks of
the same model index), and the model's collectives over its model group
(the ranks of the same dp index).

:func:`build_mesh` makes the groups over the initialised default process
group, and installs the axes -> group map that ``plan.executor`` reads:
the dp axes (each, and together) -> this model rank's dp group(s),
``("model",)`` -> the model group, the model axis with every dp axis ->
the default group.  At T = 1 the dp axes together are the default group
and there are no model or kv-duplicate groups.  Every rank creates every
group in the same order: the model groups, the kv-duplicate groups (the
groups of ``rep`` contiguous model ranks, for every ``rep`` that divides
T, ``models.common.ParallelCtx.kv_group``), then the dp groups.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.models.common import MODEL_AXIS, ParallelCtx
from repro_torch.plan import executor as _exec

FLAT_AXES = ("dp",)
POD_AXES = ("pod", "data")
# the reference's production meshes: one pod of 16 dp x 16 model ranks,
# and two such pods
PRODUCTION_MESH = (16, 16)
MULTI_POD_MESH = (2, 16, 16)


def parse_mesh(spec) -> Tuple[Tuple[int, ...], int]:
    """(dp sizes, model axis size) of a mesh written ``N``, ``NxT`` or
    ``PxNxT`` (or given as a tuple of ints)."""
    shape = tuple(int(s) for s in (spec.split("x") if isinstance(spec, str)
                                   else spec))
    if not shape or len(shape) > 3 or any(s < 1 for s in shape):
        raise ValueError(f"mesh {spec!r}: expected N, NxT or PxNxT")
    if len(shape) == 1:
        return shape, 1
    return shape[:-1], shape[-1]


def mesh_axes(dp_sizes: Sequence[int]) -> Tuple[str, ...]:
    """Dp axis names of a mesh with these dp sizes."""
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
    """A built mesh: the dp axis names and sizes, the groups of every axis
    set (None = the default group), the model axis's size and this rank's
    place on it (``model_group`` None with ``tp`` 1: no model axis), and
    the kv-duplicate groups (see :class:`~repro_torch.models.common.
    ParallelCtx`)."""

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    groups: Dict[Tuple[str, ...], Optional[object]]
    tp: int = 1
    model_group: Optional[object] = None
    kv_groups: Tuple[Tuple[int, object], ...] = ()

    @property
    def n_dp(self) -> int:
        return math.prod(self.sizes)

    @property
    def model_rank(self) -> int:
        """This rank's index on the model axis."""
        return dist.get_rank() % self.tp if self.tp > 1 else 0

    @property
    def dp_rank(self) -> int:
        """This rank's dp index (pod * N + data)."""
        if self.n_dp == 1:
            return 0
        return dist.get_rank() // self.tp

    @property
    def tp_axes(self) -> Tuple[str, ...]:
        """``("model",)`` when the model axis is above 1, else ()."""
        return (MODEL_AXIS,) if self.tp > 1 else ()

    def parallel_ctx(self, sp: bool = False) -> ParallelCtx:
        """The model code's view of this rank's model axis."""
        if self.tp == 1:
            return ParallelCtx()
        return ParallelCtx(group=self.model_group, tp=self.tp, sp=sp,
                           kv_groups=self.kv_groups)


def _subgroups(rank_sets: List[List[int]], me: int):
    """Create every group of ``rank_sets`` (all ranks, same order); return
    the one that holds ``me``."""
    mine = None
    for ranks in rank_sets:
        g = dist.new_group(ranks)
        if me in ranks:
            mine = g
    return mine


def build_mesh(spec) -> DpMesh:
    """Build the mesh ``spec`` over the default process group (which must
    span exactly its ranks; none needed for one rank) and install its
    groups for the executor."""
    sizes, tp = parse_mesh(spec)
    axes = mesh_axes(sizes)
    n = math.prod(sizes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n * tp:
        raise ValueError(f"mesh {spec!r} holds {n * tp} ranks, the process "
                         f"group {world}")
    me = dist.get_rank() if dist.is_initialized() else 0
    groups: Dict[Tuple[str, ...], Optional[object]] = {}
    model_group, kv_groups = None, []
    if tp > 1:
        model_group = _subgroups(
            [[i * tp + m for m in range(tp)] for i in range(n)], me)
        for rep in range(2, tp):
            if tp % rep == 0:
                kv_groups.append((rep, _subgroups(
                    [[i * tp + g * rep + j for j in range(rep)]
                     for i in range(n) for g in range(tp // rep)], me)))
        groups[(MODEL_AXIS,)] = model_group
        groups[(MODEL_AXIS,) + axes] = None
    if n > 1:
        groups[axes] = None if tp == 1 else _subgroups(
            [[i * tp + m for i in range(n)] for m in range(tp)], me)
        if len(axes) == 2:
            p_n, d_n = sizes
            groups[("pod",)] = _subgroups(
                [[(p * d_n + d) * tp + m for p in range(p_n)]
                 for m in range(tp) for d in range(d_n)], me)
            groups[("data",)] = _subgroups(
                [[(p * d_n + d) * tp + m for d in range(d_n)]
                 for m in range(tp) for p in range(p_n)], me)
    _exec.set_groups(groups)
    return DpMesh(axes=axes, sizes=sizes, groups=groups, tp=tp,
                  model_group=model_group, kv_groups=tuple(kv_groups))


def make_production_mesh(*, multi_pod: bool = False) -> DpMesh:
    """The reference's production mesh, 16 x 16 (or 2 x 16 x 16), built
    over the default process group, which must hold its 256 (512) ranks:
    as many cards under ``torchrun``, or ``launch.dryrun.fake_world`` for
    the dry run."""
    return build_mesh(MULTI_POD_MESH if multi_pod else PRODUCTION_MESH)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> DpMesh:
    """:func:`build_mesh` of ``shape`` with its axes named ``axes`` (the
    reference's helper): a trailing ``"model"`` is the model axis, the
    others are the dp axes, at most two (pods leading).  The executor's
    group map is keyed by these names, so a collective over ``axes``
    finds its group."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    has_model = bool(axes) and axes[-1] == MODEL_AXIS
    dp_names = axes[:-1] if has_model else axes
    if not 1 <= len(dp_names) <= 2:
        raise ValueError(f"axes {axes}: one or two dp axes, then an "
                         f"optional {MODEL_AXIS!r}")
    mesh = build_mesh(shape if has_model else shape + (1,))
    rename = dict(zip(mesh.axes, dp_names))
    groups = {tuple(rename.get(a, a) for a in k): g
              for k, g in mesh.groups.items()}
    _exec.set_groups(groups)
    return dataclasses.replace(mesh, axes=dp_names, groups=groups)
