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


def _laid_out(tree, axes, mesh, rules):
    """Each tensor of ``tree`` distributed over ``mesh`` as ``rules`` lay
    out its logical ``axes`` (a tree of the same structure)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding
    return sharding.map_axes(lambda ax, t: distribute_tensor(
        t, mesh, sharding.placements(sharding.assign_spec(
            rules, ax, t.shape, mesh), mesh)), axes, tree)


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def sharded_ops_rank(rank, path, out):
    """One rank of a spawned 4-rank ``gloo`` group (a file store at
    ``path``) on a (2, 2) ``data, model`` mesh: each op the models run
    over shards (attention core, vocab-sharded embedding, the MoE and
    ``row_gather`` in each of its layouts, the last-token gather, xLSTM,
    Mamba2, the prefix concatenation) on
    DTensors laid out as in the dry-run's cells, beside the plain op on
    the full tensors; rank 0 puts {case: (sharded, plain)} (numpy) on
    ``out``."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import registry
    from repro_torch.distributed import sharding
    from repro_torch.models import layers, mamba2, moe, xlstm
    from repro_torch.models import transformer as T
    dist.init_process_group("gloo", store=dist.FileStore(path, 4),
                            rank=rank, world_size=4)
    got = {}

    def keep(name, sharded, plain):
        got[name] = (_full(sharded).detach().numpy(),
                     plain.detach().numpy())

    def t(shape, seed, scale=1.0):
        return torch.from_numpy(seeded(shape, seed) * scale / 3.0)

    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        R, S0 = Replicate(), Shard(0)
        serve, train = sharding.serve_rules(), sharding.train_rules()
        # attention core: batch on data, kv heads (Kh 2) on model; then
        # the cache sequence on model (Kh 1), with segments, a window and
        # tree terms, one row's keys all masked on a shard
        B, Sq, D = 4, 5, 8
        for name, Kh, G, kp in (("attention kv heads", 2, 2, (S0, Shard(2))),
                                ("attention cache seq", 1, 4,
                                 (S0, Shard(1))),
                                ("attention query heads", 2, 4, (S0, R))):
            Skv = 12
            q, k, v = (t((B, Sq, Kh * G, D), 1), t((B, Skv, Kh, D), 2),
                       t((B, Skv, Kh, D), 3))
            qpos = torch.tensor([[7, 8, 9, 10, 11]] * B, dtype=torch.int32)
            kvpos = torch.arange(Skv, dtype=torch.int32).expand(B, Skv)
            kvpos = torch.where(torch.arange(B)[:, None] == 1,
                                kvpos % 6, kvpos).contiguous()
            qseg = torch.zeros((B, Sq), dtype=torch.int32)
            kvseg = torch.where(kvpos < 3, -1, 0).to(torch.int32)
            anc = torch.full((B, Sq), 0b101, dtype=torch.int32)
            node = torch.where(kvpos > 8, kvpos % 3, -1).to(torch.int32)
            kw = dict(q_positions=qpos, q_segments=qseg, q_anc=anc,
                      window=8, q_block=2)
            want = layers.attention(q, k, v, kv_positions=kvpos,
                                    kv_segments=kvseg, kv_node=node, **kw)
            with sharding.use_rules(mesh, serve), implicit_replication():
                kd, vd = (distribute_tensor(x, mesh, kp) for x in (k, v))
                pd = distribute_tensor(kvpos, mesh, kp[:1] + (
                    kp[1] if kp[1] == Shard(1) else R,))
                kvseg_d = distribute_tensor(kvseg, mesh, pd.placements)
                qd = distribute_tensor(q, mesh, (S0, R))
                o = layers.attention(qd, kd, vd, kv_positions=pd,
                                     kv_segments=kvseg_d, kv_node=node, **kw)
            keep(name, o, want)
        # vocab-sharded embedding, forward and gradient: table (V, d) with
        # the vocab on model and d on data (FSDP), tokens' batch on data
        table = t((32, 6), 4)
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, 32, (4, 3)).astype(np.int64))
        w = t((4, 3, 6), 6)
        tab = table.clone().requires_grad_(True)
        e = layers.embed(toks, tab)
        (e * w).sum().backward()
        td = distribute_tensor(table, mesh, (Shard(1), S0)).requires_grad_()
        with implicit_replication():
            ed = layers.embed(distribute_tensor(toks, mesh, (S0, R)), td)
            (ed * distribute_tensor(w, mesh, (S0, R))).sum().backward()
        keep("embedding", ed, e)
        keep("embedding grad", td.grad, tab.grad)
        # MoE: the tokens' rows on both mesh dims, the experts on model
        E, d, ff, Tn = 4, 6, 5, 16
        x, router = t((Tn, d), 7), t((d, E), 8)
        wg, wu, wd = t((E, d, ff), 9), t((E, d, ff), 10), t((E, ff, d), 11)
        xs = x.clone().requires_grad_(True)
        want = moe.moe_ffn(xs, router, wg, wu, wd, top_k=2, cf=1.0)
        want[0].pow(2).sum().backward()
        with implicit_replication():
            xd = distribute_tensor(x, mesh, (S0, S0)).requires_grad_()
            ws = [distribute_tensor(a, mesh, (R, S0)) for a in (wg, wu, wd)]
            o = moe.moe_ffn(xd, router, *ws, top_k=2, cf=1.0)
            o[0].pow(2).sum().backward()
        for i, n in enumerate(("moe out", "moe aux", "moe z")):
            keep(n, o[i], want[i])
        keep("moe grad", xd.grad, xs.grad)
        # the MoE under the training table in each plan of its grid (d 6:
        # capacity split, weights gathered; d 176: weights in place, the
        # grid's d split as theirs), its gathers in each layout (every
        # split mesh dim looked up in place, or every one gathered):
        # values and the gradients of the tokens and a weight
        real = sharding.lookup_bytes
        for plan, dm in (("capacity", d), ("stationary", 176)):
            xm, rm = t((Tn, dm), 7), t((dm, E), 8)
            wm = [t((E, dm, ff), 9), t((E, dm, ff), 10), t((E, ff, dm), 11)]
            xs = xm.clone().requires_grad_(True)
            wgs = wm[0].clone().requires_grad_(True)
            want = moe.moe_ffn(xs, rm, wgs, *wm[1:], top_k=2, cf=1.0)
            want[0].pow(2).sum().backward()
            for how, pick in (("local", lambda g: len(g)),
                              ("gather", lambda g: -len(g))):
                sharding.lookup_bytes = (lambda *a, pick=pick: pick(a[7]))
                try:
                    with sharding.use_rules(mesh, train), \
                            implicit_replication():
                        xd = distribute_tensor(xm, mesh,
                                               (S0, R)).requires_grad_()
                        wd_ = [distribute_tensor(w, mesh, p).requires_grad_()
                               for w, p in zip(wm, ((Shard(1), S0),
                                                    (Shard(1), S0),
                                                    (Shard(2), S0)))]
                        o = moe.moe_ffn(xd, rm, *wd_, top_k=2, cf=1.0)
                        o[0].pow(2).sum().backward()
                finally:
                    sharding.lookup_bytes = real
                keep(f"moe {plan} [{how}] out", o[0], want[0])
                keep(f"moe {plan} [{how}] x grad", xd.grad, xs.grad)
                keep(f"moe {plan} [{how}] w_gate grad", wd_[0].grad,
                     wgs.grad)
        # row_gather itself, forward and gradient, in every layout: a token
        # table with its rows on both mesh dims, ids on data; an expert grid
        # (E, C, d) with the experts on model and the slots on data, or its
        # slots or its d on data and partial sums over model, read by
        # (expert, slot) ids on data
        rg = np.random.default_rng(16)
        tok = t((16, 6), 17)
        tok_ids = torch.from_numpy(rg.integers(0, 16, (4, 5)))
        grid = t((4, 8, 6), 18)
        ge = torch.from_numpy(rg.integers(0, 4, (12,)))
        gs = torch.from_numpy(rg.integers(0, 8, (12,)))
        for name, full, place, ids in (
                ("tokens", tok, (S0, S0), (tok_ids,)),
                ("grid", grid, (Shard(1), S0), (ge, gs)),
                ("partial grid", grid, (Shard(1), Partial()), (ge, gs)),
                ("split d grid", grid, (Shard(2), Partial()), (ge, gs))):
            split = [m for m, p in enumerate(place) if p.is_shard()]
            w = t(tuple(ids[0].shape) + tuple(full.shape[len(ids):]), 19)
            tab = full.clone().requires_grad_(True)
            (tab[ids] * w).sum().backward()
            for g in ((), (0,), (1,), (0, 1)):
                if not set(g) <= set(split):
                    continue
                if place[1].is_partial():
                    # the model ranks hold a quarter and three quarters
                    data, model = mesh.get_coordinate()
                    local = full.chunk(2, place[0].dim)[data] * (
                        0.25 + 0.5 * model)
                    td = DTensor.from_local(local, mesh, place,
                                            run_check=False)
                    td = td.detach().requires_grad_()
                else:
                    td = distribute_tensor(full, mesh, place).requires_grad_()
                # the layout that gathers the table over g, forced
                sharding.lookup_bytes = (lambda *a, g=g: a[7] != g)
                try:
                    with implicit_replication():
                        idd = [distribute_tensor(i, mesh, (S0, R))
                               for i in ids]
                        o = sharding.row_gather(td, *idd)
                        (o * distribute_tensor(w, mesh, (S0, R))
                         ).sum().backward()
                finally:
                    sharding.lookup_bytes = real
                keep(f"row_gather {name} {g} out", o, full[ids])
                keep(f"row_gather {name} {g} grad", td.grad, tab.grad)
        # attention whose query heads divide neither the model dim nor
        # whole groups, forward and gradients, on a (1, 4) mesh: 6 query
        # heads over 2 kv heads (padded to 8, two a device, one device's
        # heads reading both kv heads), and 6 over 3 (groups of 2, three
        # heads a device over a model dim of 2 on the (2, 2) mesh)
        wide = init_device_mesh("cpu", (1, 4),
                                mesh_dim_names=("data", "model"))
        for name, m_, H, Kh in (("padded", wide, 6, 2),
                                ("uneven groups", mesh, 6, 3)):
            B, Sq, D = 2, 6, 8
            q, k, v = (t((B, Sq, H, D), 20), t((B, Sq, Kh, D), 21),
                       t((B, Sq, Kh, D), 22))
            pos = torch.arange(Sq, dtype=torch.int32).expand(B, Sq)
            w = t((B, Sq, H, D), 23)
            leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
            want = layers.attention(*leaves, q_positions=pos,
                                    kv_positions=pos, q_block=4)
            (want * w).sum().backward()
            with sharding.use_rules(m_, train), implicit_replication():
                dd = [distribute_tensor(a, m_, (S0, R)).requires_grad_()
                      for a in (q, k, v)]
                o = layers.attention(*dd, q_positions=pos, kv_positions=pos,
                                     q_block=4)
                (o * distribute_tensor(w, m_, (S0, R))).sum().backward()
            keep(f"attention {name} out", o, want)
            for n_, a, b in zip("qkv", dd, leaves):
                keep(f"attention {name} {n_} grad", a.grad, b.grad)
        # the last-token gather, batch on both mesh dims
        h, idx = t((8, 5, 6), 12), torch.tensor([4, 0, 2, 3, 1, 4, 0, 2])
        with implicit_replication():
            o = T.last_rows(distribute_tensor(h, mesh, (S0, S0)),
                            distribute_tensor(idx, mesh, (S0, S0)))
        keep("last rows", o, T.last_rows(h, idx))
        # logsigmoid, forward and gradient, laid out on the batch
        g = t((4, 6), 13)
        gs = g.clone().requires_grad_(True)
        torch.nn.functional.logsigmoid(gs).sum().backward()
        gd = distribute_tensor(g, mesh, (S0, Shard(1))).requires_grad_()
        with sharding.use_rules(mesh, train):
            ld = torch.nn.functional.logsigmoid(gd)
            ld.sum().backward()
        keep("logsigmoid", ld, torch.nn.functional.logsigmoid(g))
        keep("logsigmoid grad", gd.grad, gs.grad)
        # xLSTM (mLSTM and sLSTM blocks), Mamba2 and the prefix
        # concatenation: params laid out by the training table, the input's
        # batch on data; the reduced configs' widths
        for arch, kinds in (("xlstm-350m", ("mlstm", "slstm")),
                            ("zamba2-1.2b", ("mamba2",))):
            cfg = registry.reduced_for(arch)
            for kind in kinds:
                spec = T._block_spec(cfg, kind)
                p = T.init_params(dataclasses.replace(
                    cfg, unit=(kind,), tail=(), n_layers=1), 3,
                    device="cpu")["layers"][0]
                axes = {n: s.axes for n, s in spec.items()}
                xin = t((4, 16, cfg.d_model), 14)
                fwd = {"mlstm": lambda p, x: xlstm.mlstm_forward(
                           p, x, cfg, chunk=8),
                       "slstm": lambda p, x: xlstm.slstm_forward(p, x, cfg),
                       "mamba2": lambda p, x: mamba2.forward(
                           p, x, cfg, chunk=8)}[kind]
                want, wst = fwd(p, xin)
                with sharding.use_rules(mesh, train), implicit_replication():
                    pd = _laid_out(p, axes, mesh, train)
                    o, st = fwd(pd, distribute_tensor(xin, mesh, (S0, R)))
                keep(f"{kind} out", o, want)
                for i, (a, b) in enumerate(zip(st, wst)):
                    keep(f"{kind} state {i}", a, b)
        cfg = registry.reduced_for("internvl2-26b")
        p = T.init_params(cfg, 4, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(6).integers(
            0, cfg.vocab_size, (4, 6)).astype(np.int32))
        pre = t((4, cfg.num_prefix_embeds, cfg.d_model), 15)
        want = T._inputs_to_x(cfg, p, toks, prefix_embeds=pre)
        with sharding.use_rules(mesh, train), implicit_replication():
            pd = _laid_out(p, T.logical_axes(cfg), mesh, train)
            o = T._inputs_to_x(cfg, pd, distribute_tensor(toks, mesh, (S0, R)),
                               prefix_embeds=distribute_tensor(
                                   pre, mesh, (S0, R)))
        keep("prefix concat", o, want)
        if rank == 0:
            out.put(got)
    finally:
        dist.destroy_process_group()
