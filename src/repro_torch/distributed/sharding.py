"""Logical-axis sharding (MaxText-style rule table) over a torch ``DeviceMesh``.

Every parameter / activation / cache dimension carries a *logical* axis name
(``models/params.py`` specs and the ``constrain`` call sites of
``models/transformer.py``).  A rule table maps logical names to mesh-axis
candidates; assignment is greedy by priority with divisibility checks, so
one table serves every architecture (kv_heads=8 cannot shard over model=16
-> the cache sequence dim takes the model axis instead).  The tables, the
priorities and the algorithm are the reference's (``repro.distributed.
sharding``); only the output differs: a :data:`Spec` (one tuple of mesh
axes or None per dim) that :func:`placements` turns into DTensor
``Shard``/``Replicate`` placements, one per mesh dim.

``constrain`` is a no-op outside an active rule context, so model code runs
unchanged on one device.
"""

from __future__ import annotations

import contextlib
import math
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple

Candidate = Optional[Tuple[str, ...]]     # mesh axes for one dim (None = repl)
Rules = Dict[str, List[Candidate]]
# one entry per tensor dim: the mesh axes that shard it, or None
Spec = Tuple[Candidate, ...]

# Lower priority = assigned first (gets first pick of mesh axes).
PRIORITY: Dict[str, int] = {
    "batch": 10, "act_batch": 10, "cache_batch": 10,
    "vocab": 20, "heads": 20, "kv_heads": 22, "experts": 20, "mlp": 24,
    "ssm_in": 20, "ssm_inner": 20, "ssm_conv": 20, "xl_up": 20,
    "xl_inner": 26, "xl_inner2": 20, "ssm_heads": 20,
    "embed": 30, "act_embed": 30, "exp_embed": 30,
    "cache_seq": 40, "seq": 45, "exp_cap": 18,
}
DEFAULT_PRIORITY = 50


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a torch ``DeviceMesh`` (or of any object with a
    ``shape`` mapping, as the tests' stand-in meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _axes_size(shape: Dict[str, int], axes: Tuple[str, ...]) -> int:
    return math.prod(shape[a] for a in axes)


def assign_spec(rules: Rules, dims: Sequence[Optional[str]],
                shape: Sequence[int], mesh) -> Spec:
    """Pick mesh axes per dim: greedy by priority, divisibility-checked,
    each mesh axis used at most once."""
    sizes = mesh_shape(mesh)
    order = sorted(range(len(dims)),
                   key=lambda i: PRIORITY.get(dims[i] or "", DEFAULT_PRIORITY))
    used: set = set()
    chosen: List[Candidate] = [None] * len(dims)
    for i in order:
        name = dims[i]
        if name is None:
            continue
        for cand in rules.get(name, [None]):
            if cand is None:
                break
            cand = tuple(cand)
            if any(a in used for a in cand):
                continue
            if any(a not in sizes for a in cand):
                continue
            if shape[i] % _axes_size(sizes, cand) != 0:
                continue
            chosen[i] = cand
            used.update(cand)
            break
    return tuple(chosen)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim, ``Shard(i)``
    for the tensor dim ``i`` whose entry names that axis, else
    ``Replicate()``.  A dim over two axes, such as ``("pod", "data")``, is
    ``Shard(i)`` on both mesh dims (split over pod, then data, as the
    reference's PartitionSpec)."""
    from torch.distributed.tensor import Replicate, Shard
    where = {a: i for i, axes in enumerate(spec) if axes for a in axes}
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in mesh.mesh_dim_names)


# Rule tables ---------------------------------------------------------------

def train_rules(multi_pod: bool = False) -> Rules:
    dp = ("pod", "data") if multi_pod else ("data",)
    return {
        # activations
        "batch": [dp, ("data",), None],
        "seq": [None],
        "act_embed": [None],
        "exp_cap": [dp, ("data",), None],
        # weights: FSDP over data, TP over model
        "embed": [("data",), None],
        "exp_embed": [("data",), None],
        "vocab": [("model",), None],
        "heads": [("model",), None],
        "kv_heads": [("model",), None],
        "mlp": [("model",), None],
        "experts": [("model",), None],
        "ssm_in": [("model",), None],
        "ssm_inner": [("model",), None],
        "ssm_conv": [("model",), None],
        "xl_up": [("model",), None],
        "xl_inner": [("data",), None],
        "xl_inner2": [("model",), None],
        "ssm_heads": [("model",), None],
        # caches (unused in train)
        "cache_batch": [dp, ("data",), None],
        "cache_seq": [None],
    }


def serve_rules(multi_pod: bool = False) -> Rules:
    """Inference: batch DP over (pod,)data; TP over model; KV cache sharded
    over batch x (kv_heads | seq)."""
    r = train_rules(multi_pod)
    r.update({
        "cache_seq": [("model",), None],     # used when kv_heads can't shard
        "kv_heads": [("model",), None],
        "seq": [None],
    })
    return r


def train_rules_seqparallel(multi_pod: bool = False) -> Rules:
    """Megatron-style sequence parallelism: residual-stream activations are
    sharded over `model` along the sequence axis."""
    r = train_rules(multi_pod)
    r["seq"] = [("model",), None]
    return r


def train_rules_noremat_zero1(multi_pod: bool = False) -> Rules:
    """ZeRO-1 style: parameters replicated over data (only optimizer state
    sharded)."""
    r = train_rules(multi_pod)
    for k in ("embed", "xl_inner"):
        r[k] = [None]
    return r


def serve_rules_seqshard(multi_pod: bool = False) -> Rules:
    """Flash-decode style: KV cache sequence sharded over `model` (for GQA
    archs whose kv_heads don't divide the TP degree)."""
    r = serve_rules(multi_pod)
    r["cache_seq"] = [("model",), None]
    r["kv_heads"] = [None]
    return r


def serve_rules_batch_model(multi_pod: bool = False) -> Rules:
    """Decode batch sharded over BOTH data and model axes (weights fully
    replicated over model)."""
    r = serve_rules(multi_pod)
    r["batch"] = [("data", "model"), ("data",), None]
    r["cache_batch"] = [("data", "model"), ("data",), None]
    for k in ("heads", "kv_heads", "mlp", "experts", "vocab", "ssm_in",
              "ssm_inner", "ssm_conv", "xl_up", "xl_inner2", "ssm_heads"):
        r[k] = [None]
    return r


def serve_rules_zero1(multi_pod: bool = False) -> Rules:
    """Inference: weights replicated over `data` (TP-only sharding)."""
    r = serve_rules(multi_pod)
    for k in ("embed", "exp_embed", "xl_inner"):
        r[k] = [None]
    return r


def serve_rules_attn_repl(multi_pod: bool = False) -> Rules:
    """MoE serving hybrid: attention/router weights replicated over `data`;
    the expert tensors stay FSDP-sharded."""
    r = serve_rules(multi_pod)
    r["embed"] = [None]
    r["exp_embed"] = [("data",), None]
    return r


def serve_rules_seq_data(multi_pod: bool = False) -> Rules:
    """Long-context prefill: shard the SEQUENCE over `data` instead of
    batch."""
    r = serve_rules(multi_pod)
    r["seq"] = [("data",), None]
    r["cache_seq"] = [("data",), ("model",), None]
    return r


RULE_VARIANTS = {
    "train": train_rules,
    "serve": serve_rules,
    "train_seqparallel": train_rules_seqparallel,
    "train_zero1": train_rules_noremat_zero1,
    "serve_seqshard": serve_rules_seqshard,
    "serve_batch_model": serve_rules_batch_model,
    "serve_zero1": serve_rules_zero1,
    "serve_attn_repl": serve_rules_attn_repl,
    "serve_seq_data": serve_rules_seq_data,
}


# Context -------------------------------------------------------------------

class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[Rules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(mesh, rules: Rules):
    prev = (_CTX.mesh, _CTX.rules)
    register_strategies()
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active() -> bool:
    return _CTX.mesh is not None


def layout(*dims: Optional[str], shape: Sequence[int]) -> tuple:
    """The active rule table's placements for a tensor of ``shape`` whose
    dims are named ``dims`` (trailing dims not named are replicated)."""
    names = list(dims) + [None] * (len(shape) - len(dims))
    return placements(assign_spec(_CTX.rules, names, shape, _CTX.mesh),
                      _CTX.mesh)


def constrain(x, *dims: Optional[str], shape: Optional[Sequence[int]] = None):
    """Redistribute a DTensor ``x`` to the active rule table's layout for
    ``dims`` (trailing dims not named are replicated); the analogue of the
    reference's ``with_sharding_constraint``.  ``shape`` replaces x's shape
    in the divisibility checks (a dim that merges heads and head_dim is
    laid out as its head count allows).  A no-op outside
    :func:`use_rules`.  A plain tensor is returned unchanged: on a
    one-device mesh (each replica's sub-mesh on one card) the plain tensor
    is already the only layout, and only the dry-run's params and inputs
    are DTensors."""
    if _CTX.mesh is None or _CTX.rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    names = list(dims) + [None] * (x.ndim - len(dims))
    spec = assign_spec(_CTX.rules, names, shape or x.shape, _CTX.mesh)
    # redistributed even where the layout already matches: the backward
    # then lays the gradient out alike, as the reference's constraint
    # also constrains the cotangent
    return x.redistribute(_CTX.mesh, placements(spec, _CTX.mesh))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing
    ``torch.distributed.tensor`` where nothing has (then nothing is one)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _plain(x, mesh, placements=None):
    """The local tensor of ``x`` redistributed to ``placements`` (default
    replicated); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(mesh, placements or replicated(mesh)).to_local()


def _shard_offsets(mesh, placements, shape, local_shape) -> list:
    """Where this device's shard starts in each dim of a tensor of
    ``shape`` laid out by ``placements`` (shards over several mesh dims
    split in mesh-dim order: pod, then data); the shards must be even."""
    coord = mesh.get_coordinate()
    offsets, parts = [0] * len(shape), [1] * len(shape)
    for m, p in enumerate(placements):
        if p.is_shard():
            offsets[p.dim] = offsets[p.dim] * mesh.size(m) + coord[m]
            parts[p.dim] *= mesh.size(m)
    for d in range(len(shape)):
        if shape[d] != local_shape[d] * parts[d]:
            raise ValueError(f"dim {d} of {tuple(shape)} is not split "
                             f"evenly over {parts[d]} shards")
        offsets[d] *= local_shape[d]
    return offsets


def shard_write(dst, index, src) -> None:
    """``dst[index] = src`` for a DTensor ``dst`` whose leading
    ``len(index)`` dims are indexed (a cache's batch rows and slots), each
    device writing into its local shard the updates that land there: the
    analogue of XLA's partitioned scatter, which DTensor does not have
    in place.  The index tensors are replicated, the updates are laid out
    as ``dst``'s trailing dims; shards are even (:func:`assign_spec` checks
    divisibility).  Static shapes and no host sync, so it also runs on
    shapes alone (the dry-run): every device handles all n updates, those
    in its shard first, the rest repeating the first of them (the same
    value at the same place); with none in its shard, it rewrites one slot
    with its own value."""
    import torch
    from torch.distributed.tensor import Replicate, Shard
    mesh, local = dst.device_mesh, dst.to_local()
    k = len(index)
    offsets = _shard_offsets(mesh, dst.placements, dst.shape, local.shape)
    # the updates: dim 0 the update list, then dst's trailing dims laid out
    # as dst's
    want = tuple(Shard(p.dim - k + 1) if p.is_shard() and p.dim >= k
                 else Replicate() for p in dst.placements)
    vals = _plain(src, mesh, want)
    if not is_dtensor(src):
        for d in range(k, dst.ndim):
            vals = vals.narrow(d - k + 1, offsets[d], local.shape[d])
    idx = [_plain(i, mesh).long() - offsets[d] for d, i in enumerate(index)]
    keep = torch.ones_like(idx[0], dtype=torch.bool)
    for d, i in enumerate(idx):
        keep &= (i >= 0) & (i < local.shape[d])
    n = keep.shape[0]
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    pick = torch.where(torch.arange(n, device=keep.device) < keep.sum(),
                       order, order[:1])
    at = tuple(i[pick].clamp(0, local.shape[d] - 1)
               for d, i in enumerate(idx))
    vals = vals[pick].to(local.dtype)
    # 0-d, so that DTensor's dispatch takes it as a scalar, not as a
    # one-element tensor to replicate
    none = ~keep.any()
    local[at] = torch.where(none, local[at], vals)


# Ops on local shards --------------------------------------------------------
#
# Model code reaches these only where its tensors are DTensors (the
# dry-run's cells, the tests' meshes): the ops DTensor has no strategy for
# at the layouts the rule tables give, written as each device's work on its
# own shards plus the collectives the reference's partitioner inserts.

def on_shards(fn, mesh, args, in_placements, out_placements):
    """``fn`` on each device's local shards (torch's ``local_map``, with the
    inputs laid out first): every tensor of ``args`` is redistributed to its
    entry of ``in_placements`` (a plain tensor is taken as replicated, so
    laying it out is a local slice), ``fn`` runs on the local tensors, and
    its output (a tensor or a tuple) is a DTensor of ``out_placements``
    (one tuple, or one per output).  ``fn`` must be local: each output
    shard depends only on the input shards of its device, collectives that
    ``fn`` runs itself aside.  Gradients flow through: an input replicated
    on a mesh dim where an output is sharded takes a partial gradient
    there (each device saw only its shard's use of it)."""
    from torch.distributed.tensor import DTensor, Partial
    outs = (out_placements if isinstance(out_placements[0], tuple)
            else (out_placements,))
    split = [any(o[m].is_shard() for o in outs) for m in range(mesh.ndim)]
    local = []
    for x, want in zip(args, in_placements):
        if want is None or x is None:
            local.append(x)
            continue
        want = tuple(want)
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, replicated(mesh),
                                   run_check=False)
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
        grad = tuple(Partial() if p.is_replicate() and split[m] else p
                     for m, p in enumerate(want))
        local.append(x.to_local(grad_placements=grad))
    out = fn(*local)
    if isinstance(out_placements[0], tuple):
        return tuple(DTensor.from_local(o, mesh, p, run_check=False)
                     for o, p in zip(out, out_placements))
    return DTensor.from_local(out, mesh, out_placements, run_check=False)


def all_reduce_over(x, op: str, mesh, mesh_dims: Sequence[int]):
    """``x`` (a local tensor) reduced with ``op`` ("sum", "max") over each
    of ``mesh_dims`` of ``mesh``: a functional collective, which the
    dry-run counts."""
    from torch.distributed import _functional_collectives as funcol
    for m in mesh_dims:
        x = funcol.all_reduce(x, op, (mesh, m))
        x = x.wait() if hasattr(x, "wait") else x
    return x


def _collective(name, new):
    """The functional collective ``name`` of this torch (``new``, its
    later name, where it has one), its result waited for."""
    from torch.distributed import _functional_collectives as funcol
    fn = getattr(funcol, new, None) or getattr(funcol, name)

    def run(*args):
        x = fn(*args)
        return x.wait() if hasattr(x, "wait") else x
    return run


def _row_gather_fn():
    import torch

    class MaskedLookup(torch.autograd.Function):
        """``table[ids]`` over the leading ``len(ids)`` dims of a local
        table (a shard where ``offsets`` place it), zeros for ids outside
        the shard, then summed over each mesh dim of ``steps`` in turn:
        reduce-scattered along the output dim the step names, or
        all-reduced where it names none.  The backward all-gathers the
        gradient where the forward scattered it, masks it and scatter-adds
        it into the shard."""

        @staticmethod
        def forward(ctx, table, offsets, mesh, steps, *ids):
            at, hit = [], None
            for d, (i, off) in enumerate(zip(ids, offsets)):
                i = i.long() - off
                ok = (i >= 0) & (i < table.shape[d])
                hit = ok if hit is None else hit & ok
                at.append(i.clamp(0, table.shape[d] - 1))
            at = tuple(torch.broadcast_tensors(*at))
            out = table[at]
            out = out * hit.reshape(hit.shape + (1,) * (out.ndim - hit.ndim)
                                    ).to(out.dtype)
            scatter = _collective("reduce_scatter_tensor",
                                  "reduce_scatter_single")
            for m, d in steps:
                out = (all_reduce_over(out, "sum", mesh, [m]) if d is None
                       else scatter(out.contiguous(), "sum", d, (mesh, m)))
            ctx.save_for_backward(hit, *at)
            ctx.table_shape, ctx.mesh, ctx.steps = table.shape, mesh, steps
            return out

        @staticmethod
        def backward(ctx, g):
            hit, *at = ctx.saved_tensors
            gather = _collective("all_gather_tensor", "all_gather_single")
            for m, d in reversed(ctx.steps):
                if d is not None:
                    g = gather(g.contiguous(), d, (ctx.mesh, m))
            g = g * hit.reshape(hit.shape + (1,) * (g.ndim - hit.ndim)
                                ).to(g.dtype)
            grad = torch.zeros(ctx.table_shape, dtype=g.dtype,
                               device=g.device)
            grad.index_put_(tuple(at), g, accumulate=True)
            return (grad, None, None, None) + (None,) * len(at)

    return MaskedLookup


_ROW_GATHER = []


def lookup_bytes(table_shape, k, elem, placements, ids_numel, id_elem, ip,
                 gathered, sizes) -> float:
    """Collective bytes per device of one :func:`row_gather` layout by the
    dry-run's ring model (an all-gather or an all-to-all its output, a
    reduce-scatter its input, an all-reduce twice its input).  The table
    (``placements`` on the mesh) is gathered over the mesh dims
    ``gathered``; over every other mesh dim that splits it, and where it
    holds partial sums, the ids are gathered (where ``ip``, their
    placements, split them) and each device looks them up in its shard:
    rows split there are summed back (reduce-scattered to the ids' split,
    else all-reduced), as are partial sums; a split of the rows' trailing
    dims is moved back to the ids' split (all-to-all), else gathered.
    Shapes only: the choice made on it is static."""
    split = {m: p.dim for m, p in enumerate(placements) if p.is_shard()}
    table = math.prod(table_shape) * elem
    row = math.prod(table_shape[k:]) * elem
    for m in split:
        table /= sizes[m]
        if split[m] >= k:
            row /= sizes[m]
    cost = 0.0
    for m in sorted(gathered):
        table *= sizes[m]
        cost += table
        if split[m] >= k:
            row *= sizes[m]
    local = [m for m, p in enumerate(placements)
             if m not in gathered and not p.is_replicate()]
    n = ids_numel / math.prod(sizes[m] for m, p in enumerate(ip)
                              if p.is_shard())
    for m in local:
        if ip[m].is_shard():
            n *= sizes[m]
            cost += n * id_elem * k
    out = n * row
    for m in local:
        if placements[m].is_shard() and split[m] >= k:
            continue
        if ip[m].is_shard():
            cost += out
            out /= sizes[m]
        else:
            cost += 2 * out
    for m in local:
        if placements[m].is_shard() and split[m] >= k:
            if not ip[m].is_shard():
                out *= sizes[m]
            cost += out
    return cost


def row_gather(table, *ids):
    """``table[ids]`` for a DTensor ``table`` indexed on its leading
    ``len(ids)`` dims (an embedding table by token, a token list by slot,
    an expert output grid by (expert, slot)); the ids alike in shape.  The
    output's rows are whole and laid out as the ids (the first id
    tensor's layout, which the others take): each row lands on the
    devices that hold its id.  Each mesh dim that splits the table takes
    one of two layouts, whichever moves fewer collective bytes
    (:func:`lookup_bytes`, from the shapes alone): the table gathered over
    it, then looked up locally; or the ids gathered over it and looked up
    in each device's own shard, the rows then summed back where the
    table's rows are split (reduce-scattered to the ids' layout where the
    ids are split there, all-reduced where they are not) or moved back
    where the rows' trailing dims are (all-to-all, or all-gather).  A
    table of partial sums is looked up as it is and its rows summed
    alike.  The table's gradient comes back in the table's own layout:
    each layout's backward is its own transpose."""
    import itertools

    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not _ROW_GATHER:
        _ROW_GATHER.append(_row_gather_fn())
    mesh, k = table.device_mesh, len(ids)
    ids = [i if is_dtensor(i) else DTensor.from_local(
        i, mesh, replicated(mesh), run_check=False) for i in ids]
    ip = tuple(ids[0].placements)
    ids = [i if tuple(i.placements) == ip else i.redistribute(mesh, ip)
           for i in ids]
    places = tuple(p if type(p) is Shard or p.is_partial() else Replicate()
                   for p in table.placements)
    split = [m for m, p in enumerate(places) if p.is_shard()]
    sizes = [mesh.size(m) for m in range(mesh.ndim)]
    costs = {g: lookup_bytes(tuple(table.shape), k, table.element_size(),
                             places, ids[0].numel(), ids[0].element_size(),
                             ip, g, sizes)
             for r in range(len(split) + 1)
             for g in itertools.combinations(split, r)}
    # the cheaper layout; on a tie, the fewer gathers
    gathered = min(costs, key=lambda g: (costs[g], len(g)))
    tp = tuple(Replicate() if m in gathered else p
               for m, p in enumerate(places))
    t = table if tuple(table.placements) == tp else table.redistribute(
        mesh, tp)
    # the table's gradient: its own shards where it stays split, whole
    # where its sums are partial, partial where the ids split the lookup
    grad = tuple(p if p.is_shard() else Partial() if ip[m].is_shard()
                 and p.is_replicate() else Replicate()
                 for m, p in enumerate(tp))
    local = t.to_local(grad_placements=grad)
    offs = _shard_offsets(mesh, tp, t.shape, local.shape)[:k]
    lp = tuple(p if tp[m].is_replicate() else Replicate()
               for m, p in enumerate(ip))
    ids = [(i if lp == ip else i.redistribute(mesh, lp)).to_local()
           for i in ids]
    # summed over the mesh dims that split the rows or hold partial sums
    steps = tuple((m, ip[m].dim if ip[m].is_shard() else None)
                  for m, p in enumerate(tp)
                  if p.is_partial() or p.is_shard() and p.dim < k)
    out = _ROW_GATHER[0].apply(local, offs, mesh, steps, *ids)
    # a split of the rows' trailing dims, moved back to the ids' layout
    op = tuple(Shard(p.dim - k + ids[0].ndim) if p.is_shard() and p.dim >= k
               else ip[m] for m, p in enumerate(tp))
    out = DTensor.from_local(out, mesh, op, run_check=False)
    return out if op == ip else out.redistribute(mesh, ip)


_STRATEGIES = []


def register_strategies() -> None:
    """Pointwise DTensor sharding strategies for the ops the models run
    that DTensor has none for (``F.logsigmoid``'s forward and backward):
    every tensor argument and output laid out alike.  Once per process."""
    if _STRATEGIES:
        return
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    def pointwise(n_out, n_in):
        def strategy(x, *rest):
            same = [([Replicate()] * n_out, [Replicate()] * n_in)]
            for d in range(len(x.shape)):
                same.append(([Shard(d)] * n_out, [Shard(d)] * n_in))
            return same
        return strategy

    # log_sigmoid_forward(x) -> (out, buffer); on the CPU the buffer has x's
    # shape (the only device a DTensor of the models runs on)
    register_sharding(aten.log_sigmoid_forward.default)(pointwise(2, 1))
    # log_sigmoid_backward(grad, x, buffer) -> grad_x
    register_sharding(aten.log_sigmoid_backward.default)(pointwise(1, 3))
    _STRATEGIES.append(True)


# Sharding trees ------------------------------------------------------------

def _is_axes(a) -> bool:
    return isinstance(a, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in a)


def map_axes(fn, axes_tree, *rest):
    """``fn(axes, *leaves)`` over a dict/list tree whose leaves are
    logical-axis tuples, with trees of the same structure in ``rest``."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(map_axes(fn, *xs)
                               for xs in zip(axes_tree, *rest))
    raise TypeError(f"unexpected axes node {type(axes_tree)}")


def sharding_tree(mesh, rules: Rules, axes_tree, abstract_tree):
    """Per leaf, its DTensor placements on ``mesh`` (a tuple, one per mesh
    dim): the analogue of the reference's NamedSharding tree.

    axes_tree: tree of logical-axis tuples (same structure as
    abstract_tree).  abstract_tree: tree of tensors or meta tensors (their
    shapes feed the divisibility checks)."""
    return map_axes(lambda axes, ab: placements(
        assign_spec(rules, axes, ab.shape, mesh), mesh), axes_tree,
        abstract_tree)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def replica_sharding_trees(submeshes: Sequence, rules: Rules, axes_tree,
                           abstract_tree) -> List:
    """Per-replica placement trees for multi-replica serving: the same rule
    table applied over each replica's sub-mesh (from
    ``launch.mesh.replica_submeshes``).  Rule tables never name the
    ``replica`` axis: replicas are full parameter copies, and each sub-mesh
    only exposes the remaining axes."""
    for m in submeshes:
        if "replica" in mesh_shape(m):
            raise ValueError(
                "sub-mesh still carries a 'replica' axis — carve with "
                "launch.mesh.replica_submeshes before building shardings")
    return [sharding_tree(m, rules, axes_tree, abstract_tree)
            for m in submeshes]
