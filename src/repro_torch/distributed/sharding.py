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
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active() -> bool:
    return _CTX.mesh is not None


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
    want = placements(spec, _CTX.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(_CTX.mesh, want)


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
    coord = mesh.get_coordinate()
    k = len(index)
    offsets = [0] * dst.ndim
    parts = [1] * dst.ndim
    for m, p in enumerate(dst.placements):
        if p.is_shard():
            offsets[p.dim] = offsets[p.dim] * mesh.size(m) + coord[m]
            parts[p.dim] *= mesh.size(m)
    for d in range(dst.ndim):
        if dst.shape[d] != local.shape[d] * parts[d]:
            raise ValueError(f"dim {d} of {tuple(dst.shape)} is not split "
                             f"evenly over {parts[d]} shards")
        offsets[d] *= local.shape[d]
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
    none = (~keep.any()).reshape((1,) * vals.ndim)
    local[at] = torch.where(none, local[at], vals)


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
