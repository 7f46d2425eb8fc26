"""Device-mesh construction from config (port of trlx_tpu.parallel.mesh).

Axis sizes come from ``TrainConfig.mesh`` (e.g. ``{"dp": -1, "fsdp": 2,
"tp": 4}``); one axis may be -1, meaning "every remaining process". The
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world of
processes (one card each), with the five named dims in trlx_tpu's
outer-to-inner order, so tp is innermost: the ranks of one tp group are
neighbours, as NVLink and torchrun's rank numbering on one host want.

``mesh_from_config`` returns None for a world of one process whose axes
all resolve to 1: the single-card path then runs unchanged, on plain
tensors. A mesh built explicitly (``build_mesh``) always takes the mesh
path, even on one rank.
"""

import math
from typing import Dict, Optional

# Outer-to-inner axis order; see module docstring.
AXES = ("dp", "pp", "fsdp", "sp", "tp")


def resolve_axis_sizes(
    mesh_config: Optional[Dict[str, int]], n_devices: int
) -> Dict[str, int]:
    """Fill in -1 ("all remaining devices") and validate divisibility."""
    sizes = {ax: 1 for ax in AXES}
    if mesh_config:
        unknown = set(mesh_config) - set(AXES)
        if unknown:
            raise ValueError(
                f"unknown mesh axes {sorted(unknown)}; valid axes: {AXES}"
            )
        sizes.update({ax: int(v) for ax, v in mesh_config.items()})
    bad = {ax: v for ax, v in sizes.items() if v < 1 and v != -1}
    if bad:
        raise ValueError(
            f"mesh axis sizes must be positive (or -1 for 'all remaining "
            f"devices'), got {bad}"
        )

    wildcards = [ax for ax, v in sizes.items() if v == -1]
    if len(wildcards) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {wildcards}")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if wildcards:
        if n_devices % fixed != 0:
            raise ValueError(
                f"fixed mesh axes use {fixed} devices which does not divide "
                f"the {n_devices} available"
            )
        sizes[wildcards[0]] = n_devices // fixed
    elif fixed != n_devices:
        raise ValueError(
            f"mesh axes {sizes} require {fixed} devices but {n_devices} are "
            f"available; set one axis to -1 to absorb the remainder"
        )
    return sizes


def build_mesh(mesh_config: Optional[Dict[str, int]] = None,
               device_type: Optional[str] = None):
    """A DeviceMesh over every process of the world, dims named
    :data:`AXES`. ``mesh_config`` maps axis name -> size; missing axes
    default to 1 and one axis may be -1. With no config at all every
    process goes to ``dp``. ``device_type`` is "cuda" (the default: NCCL,
    one card per process) or "cpu" (gloo). Without a process group (one
    process, not under torchrun) a world of one is started first."""
    from torch.distributed.device_mesh import init_device_mesh

    from trlx_tpu_torch.parallel.runtime import (
        ensure_process_group,
        process_count,
    )

    device_type = ensure_process_group(device_type)
    if mesh_config is None:
        mesh_config = {"dp": -1}
    sizes = resolve_axis_sizes(mesh_config, process_count())
    return init_device_mesh(device_type, tuple(sizes[ax] for ax in AXES),
                            mesh_dim_names=AXES)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh from :func:`build_mesh`."""
    return {ax: mesh.size(i) for i, ax in enumerate(AXES)}


def axis_group(mesh, axis: str):
    """(process group, this process's rank in it, its size, the global
    rank of each member in group-rank order) of one mesh axis: the
    processes that share every other coordinate with this one. Point-to-
    point ops name their peers by global rank."""
    import torch.distributed as dist

    group = mesh.get_group(AXES.index(axis))
    size = mesh.size(AXES.index(axis))
    ranks = [dist.get_global_rank(group, r) for r in range(size)]
    return group, dist.get_rank(group), size, ranks


def mesh_from_config(train_config, device_type: Optional[str] = None):
    """The mesh of ``TrainConfig.mesh`` over the world, or None when the
    world is one process and every axis resolves to 1 (the plain
    single-card path)."""
    from trlx_tpu_torch.parallel.runtime import process_count

    config = getattr(train_config, "mesh", None)
    world = process_count()
    sizes = resolve_axis_sizes(config or {"dp": -1}, world)
    if world == 1 and all(v == 1 for v in sizes.values()):
        return None
    return build_mesh(config, device_type)


def single_device_mesh(device_type: Optional[str] = None):
    """A 1x1x1x1x1 mesh over a world of one process: the mesh code path
    on one card."""
    from trlx_tpu_torch.parallel.runtime import process_count

    mesh = build_mesh({}, device_type)
    if process_count() != 1:
        raise ValueError("single_device_mesh needs a world of one process")
    return mesh
