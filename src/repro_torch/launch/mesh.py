"""Production and local mesh definitions over torch ``DeviceMesh``.

Functions, not module-level constants: importing this module creates no
process group and no mesh.  Every function that returns a ``DeviceMesh``
needs the caller's default process group (``torch.distributed.
init_process_group``) to hold at least the mesh's ranks; the mesh takes
the first ranks of that world.

Shapes and axis names are the reference's (``repro.launch.mesh``), so the
rule tables' divisibility results compare across packages.  Single pod:
``(data=16, model=16)`` = 256 ranks.  Multi-pod: a leading ``pod`` axis,
``(pod=2, data=16, model=16)`` = 512 ranks, data parallel with optional
gradient compression (``distributed/collectives.py``).  On H100 nodes of 8
GPUs joined by NVLink, a 16-wide ``model`` axis spans two nodes: its
tensor-parallel collectives cross the nodes' network (InfiniBand) as well
as NVLink, so a ring over it runs at the slower links' rate; ``data`` and
``pod`` stride over nodes.

Multi-replica serving adds a leading ``replica`` axis: each index along it
is one full serving cell, an independent ``SpinEngine`` whose LLM is laid
out over that slice's remaining (data, model) axes.  The replica axis
carries no collectives (the router in ``serving/router.py`` balances the
request stream), and the rule tables apply unchanged on each sub-mesh,
because the replica axis never appears inside one.  With fewer cards than
replicas (the one H100: a fleet of replicas sharing the card) each
replica's sub-mesh is the 1x1 mesh of the card the fleet shares.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np


class RankGrid(NamedTuple):
    """A mesh whose replicas share ranks (more replicas than cards): the
    rank of every (replica, data, model) position.  ``DeviceMesh`` refuses
    repeated ranks, so such a mesh stays a grid until
    :func:`replica_submeshes` carves one ``DeviceMesh`` per replica."""
    device_type: str
    mesh: np.ndarray
    mesh_dim_names: Tuple[str, ...]


def _device_mesh(device_type: str, ranks: np.ndarray,
                 names: Tuple[str, ...]):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.as_tensor(np.asarray(ranks),
                                                   dtype=torch.int64),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, replicas: int = 1,
                         device_type: str = "cuda"):
    """The reference's production mesh over the first ranks of the default
    process group (256 single pod, 512 multi-pod, times ``replicas``)."""
    shape: Tuple[int, ...] = (2, 16, 16) if multi_pod else (16, 16)
    axes: Tuple[str, ...] = (("pod", "data", "model") if multi_pod
                             else ("data", "model"))
    if replicas > 1:
        shape = (replicas,) + shape
        axes = ("replica",) + axes
    return _device_mesh(device_type, np.arange(int(np.prod(shape)))
                        .reshape(shape), axes)


def make_local_mesh(data: int = 1, model: int = 1, replicas: int = 1,
                    device_type: str = "cuda"):
    """Small mesh over the default process group's ranks (CPU tests,
    examples, the one card).  With more replica positions than ranks the
    replicas share them, one ``data x model`` slice each: a
    :class:`RankGrid`, carved by :func:`replica_submeshes`."""
    import torch.distributed as dist
    world = dist.get_world_size()
    if data * model > world:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks; "
                         f"the process group has {world}")
    if replicas == 1:
        return _device_mesh(device_type, np.arange(data * model)
                            .reshape(data, model), ("data", "model"))
    shape, names = (replicas, data, model), ("replica", "data", "model")
    if replicas * data * model <= world:
        return _device_mesh(device_type, np.arange(replicas * data * model)
                            .reshape(shape), names)
    shared = np.arange(data * model).reshape(1, data, model)
    return RankGrid(device_type, np.repeat(shared, replicas, axis=0), names)


def carve_replica_axis(devices: np.ndarray, axis_names: Tuple[str, ...]
                       ) -> Tuple[List[np.ndarray], Tuple[str, ...]]:
    """Split a mesh's device (rank) array along its ``replica`` axis: one
    sub-array per replica, plus the axis names that remain.  Pure array
    logic; without a replica axis the whole array is the single
    replica's."""
    if "replica" not in axis_names:
        return [devices], tuple(axis_names)
    ax = list(axis_names).index("replica")
    moved = np.moveaxis(np.asarray(devices), ax, 0)
    names = tuple(n for n in axis_names if n != "replica")
    return [moved[i] for i in range(moved.shape[0])], names


def replica_submeshes(mesh) -> List:
    """One ``DeviceMesh`` per index of the mesh's ``replica`` axis (the
    whole mesh if it has none).  Each sub-mesh keeps the remaining axes, so
    serve/train rule tables resolve against it exactly as on a
    single-replica mesh."""
    names = tuple(mesh.mesh_dim_names)
    if "replica" not in names:
        return [mesh]
    ranks = np.asarray(mesh.mesh)
    parts, rest = carve_replica_axis(ranks, names)
    return [_device_mesh(mesh.device_type, p, rest) for p in parts]


def elastic_replica_submeshes(mesh, replicas_max: int) -> List:
    """Pre-carve the MAXIMUM fleet's sub-meshes for the elastic router:
    one sub-mesh (and one standby engine) per slot, reserved up front; the
    router's lifecycle states decide which slots serve.  The mesh's
    replica axis must carry exactly ``replicas_max`` slots: a mismatch
    would mispair engines and device slices silently."""
    if replicas_max < 1:
        raise ValueError("replicas_max must be >= 1")
    subs = replica_submeshes(mesh)
    if len(subs) != replicas_max:
        raise ValueError(
            f"mesh carves {len(subs)} replica sub-meshes but the elastic "
            f"fleet needs replicas_max={replicas_max} — launch with "
            f"--replicas equal to --replicas-max")
    return subs
