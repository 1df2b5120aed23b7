"""Process groups for the port's distribution tests: a world of one ``gloo``
rank over an in-process store (no socket), and the dry-run's fake world.
Each is destroyed on exit, so the next test on the same worker starts
with no default group."""

import contextlib

import numpy as np
import torch
import torch.distributed as dist


@contextlib.contextmanager
def gloo_world():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def seeded(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 3.0


def collective_rank(rank, path, kind, out):
    """One rank of a spawned 2-rank ``gloo`` group (a file store at
    ``path``): reduce its seeded input with a residual through
    ``distributed.collectives`` and put (rank, reduced, new residual) on
    ``out``.  Here, not in the test module, so the spawned process imports
    no JAX."""
    from repro_torch.distributed import collectives as col
    dist.init_process_group("gloo", store=dist.FileStore(path, 2),
                            rank=rank, world_size=2)
    try:
        x = torch.from_numpy(seeded((6, 7), 10 + rank))
        res = torch.from_numpy(seeded((6, 7), 20 + rank) * 0.01)
        group = dist.group.WORLD
        if kind == "int8":
            red, new = col.compressed_psum_int8(x, group, residual=res)
        else:
            red, new = col.compressed_psum_topk(x, group, frac=0.2,
                                                residual=res)
        out.put((rank, red.numpy(), new.numpy()))
    finally:
        dist.destroy_process_group()


SHARD_WRITES = {
    # (rows, slots) of the updates: spread over both ranks' halves, with a
    # repeated row; and all in rank 0's half of the rows
    "spread": ([0, 1, 3, 3, 2], [5, 0, 2, 4, 1]),
    "one half": ([0, 1, 1], [3, 0, 5]),
}


def shard_write_rank(rank, path, out):
    """One rank of a spawned 2-rank ``gloo`` group (a file store at
    ``path``): ``sharding.shard_write`` of each of :data:`SHARD_WRITES`
    into a (4, 6, 2, 3) cache sharded on rows, slots or heads, the updates
    plain, replicated or laid out as the cache's heads; put (rank,
    {case: the cache gathered}) on ``out``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import sharding
    dist.init_process_group("gloo", store=dist.FileStore(path, 2),
                            rank=rank, world_size=2)
    try:
        mesh = init_device_mesh("cpu", (2,))
        full = torch.from_numpy(seeded((4, 6, 2, 3), 30))
        got = {}
        for name, (rows, slots) in SHARD_WRITES.items():
            idx = (torch.tensor(rows), torch.tensor(slots))
            src = torch.from_numpy(seeded((len(rows), 2, 3), 31))
            for dim in (0, 1, 2):
                for how in ("plain", "replicated", "laid out"):
                    if how == "plain":
                        upd = src
                    elif how == "replicated":
                        upd = distribute_tensor(src, mesh, [Replicate()])
                    else:
                        upd = distribute_tensor(
                            src, mesh, [Shard(1) if dim == 2 else Shard(0)])
                    dst = distribute_tensor(full.clone(), mesh, [Shard(dim)])
                    sharding.shard_write(dst, idx, upd)
                    got[(name, dim, how)] = dst.full_tensor().numpy()
        out.put((rank, got))
    finally:
        dist.destroy_process_group()
