"""Multi-pod dry-run: the distribution config on 256 or 512
placeholder ranks, with no card.

For every (architecture x input shape) cell the step (a train step with
AdamW, a prefill, or a decode step) runs once on the production meshes,
16x16 single pod AND 2x16x16 multi-pod, as torch's analogue of the
reference's "lower and compile on 512 placeholder devices"
(``repro.launch.dryrun``):

* one ``"fake"`` process group of 512 ranks per process (torch's testing
  ``FakeStore``: every collective returns at once, nothing crosses a
  wire); each mesh takes the first 256 or 512 ranks of it
  (``launch.mesh.make_production_mesh``), so the group is never re-created
  between meshes;
* ``FakeTensorMode``: tensors carry shapes, dtypes and strides but no
  memory, so a 141B-parameter model "fits";
* params, optimizer state, batch and cache are ``distribute_tensor``ed by
  the rule tables (``distributed/sharding.py``; prefill is handed the
  cache it fills, as the reference's out_shardings lay it out); the model
  code runs unchanged, the plain tensors it makes (positions, masks) taken
  as replicated (``implicit_replication``), and its ``constrain`` calls
  redistribute the residual stream as the reference's sharding
  constraints do.  The model writes a sharded cache through
  ``sharding.shard_write`` (each device into its shard, as XLA partitions
  the scatter), with ``Opts.writes_in_range`` set: there are no positions
  to filter the writes by, and the cells' writes all land in range;
* rank 0's view is what is counted, so every count is **per device**, as
  the reference's (XLA's per-device cost analysis): a counting dispatch
  mode defers every op on DTensors to DTensor's own dispatch and counts the
  ops that dispatch runs on the local shards (a mode around DTensor sees
  global shapes, so it would count the global work).  DTensor's sharding
  propagation runs each op once more at global shapes to learn the output
  shape; those runs are not counted.

What the record measures (``run_cell``): ``flops`` (the local ops' flop
formulas of ``torch.utils.flop_counter``: matmuls, attention, convolutions;
elementwise work is not counted, as in XLA's count of a fused elementwise
op), ``bytes`` (each non-view local op's input and output bytes: eager
torch writes every op's output to memory, so this is the step's eager
memory traffic, with no fusion; allocations and fills, ``empty``,
``zeros`` and ``full``, are not counted), ``collective_bytes`` per kind by the ring
model of the reference (all-reduce 2x its bytes, all-gather its output,
reduce-scatter its input, all-to-all its output), counted from what
DTensor asked for (on a CPU mesh DTensor runs an all-to-all as an
all-gather and a chunk; that stand-in is counted as the all-to-all it
replaces), and ``memory``: ``argument_bytes`` (the local shards of
params, optimizer state, batch and cache), ``temp_bytes`` (the peak of the
live local storage the step's ops made) and ``peak_bytes`` (their sum).
There is no compiler-fused memory plan, so peak_bytes is the peak of live
local storage that this eager run saw.

What it does not measure: time.  ``--roofline`` turns the counts into the
least time on an H100 SXM (datasheet figures below).  Eager torch runs
every layer, so there is no while-loop undercount: the counts are the full
depth's, and ``roofline_stats`` extrapolates over units no longer.  Only
stacks with a recurrent time scan (Mamba2, mLSTM, sLSTM) at sequences
over 1024 (train, prefill) are counted at 256, 512 and 1024 tokens and fit
with cost(T) = a + bT + cT^2 at the full length, as the reference does
(an sLSTM steps one token at a time: 4k steps of eager DTensor dispatch a
layer); their ``memory`` is the 1024-token run's.

An op with no DTensor sharding strategy raises; the cell is recorded as
``FAILED`` with the error, as in the reference, and nothing is replicated
to make it pass.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k
  python -m repro_torch.launch.dryrun --all --json results/torch_dryrun.json
  python -m repro_torch.launch.dryrun --arch ... --shape ... --roofline
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import registry
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (SHAPES, batch_logical_axes,
                                      cell_applicable, specs_for)
from repro_torch.models import config as C
from repro_torch.models import params as pp
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import AdamWState

# NVIDIA H100 SXM datasheet figures (dense, no sparsity, at the 700 W
# power limit; a card set below it runs slower)
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12             # HBM3 bytes/s per GPU
# A 16-wide axis spans two 8-GPU NVLink nodes, so a ring over it runs at
# the inter-node rate: one ConnectX-7 NDR InfiniBand port per GPU, 400
# Gb/s = 50 GB/s each way (DGX H100 datasheet).  Within a node NVLink 4
# gives 450 GB/s each way; the slower link bounds the ring.
COLLECTIVE_BW = 50e9
WORLD = 512                  # ranks of the fake group: the 2x16x16 mesh

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")
# functional collective -> (kind, which bytes the ring model charges)
_COLLECTIVES = {
    "all_reduce": ("all-reduce", "in2"),
    "all_reduce_": ("all-reduce", "in2"),
    "all_reduce_coalesced": ("all-reduce", "in2"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "in"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in"),
    "all_to_all_single": ("all-to-all", "out"),
    "shard_dim_alltoall": ("all-to-all", "out"),
    "broadcast": ("collective-permute", "out"),
}
_FREE = {"empty", "empty_strided", "empty_like", "zeros", "full", "device",
         "wait_tensor", "detach", "lift_fresh", "_local_scalar_dense",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset"}


_PRIM_DEVICE = torch.ops.prim.device.default


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _op_tensors(args, kwargs):
    """The tensors of an aten op's arguments (tensors and tensor lists, no
    deeper): :func:`_tensors` without a pytree walk, once per op."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# the function of DTensor's sharding propagator that runs an op at global
# shapes for its output's metadata (torch 2.11-2.13); checked at startup
_PROPAGATION = "_propagate_tensor_meta_non_cached"


def _check_propagation_hook() -> None:
    """Fail loudly where this torch has no :data:`_PROPAGATION`: every
    global-shape run would then be counted as the device's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if not callable(getattr(ShardingPropagator, _PROPAGATION, None)):
        raise RuntimeError(
            f"torch {torch.__version__}: DTensor's ShardingPropagator has no "
            f"{_PROPAGATION}; the per-device counts cannot leave out the "
            f"global-shape propagation runs")


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation runs this op (its global-shape
    run for the output's metadata, not part of the local work)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == _PROPAGATION:
            return True
        f = f.f_back
    return False


class DeviceCounter(TorchDispatchMode):
    """Counts one device's work: flops, bytes, collective bytes and the
    peak of live storage of the ops run on local (non-DTensor) tensors."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.live = 0
        self.peak = 0
        self._standin = 0        # depth inside a CPU all-to-all stand-in

    def _release(self, n):
        self.live -= n

    def _collective(self, name, args, out) -> bool:
        kind, rule = _COLLECTIVES.get(name, (None, None))
        if kind is None:
            return False
        ins = _tensors(args)
        if rule == "out":
            n = sum(_nbytes(t) for t in _tensors(out))
        else:
            n = sum(_nbytes(t) for t in ins[:1]) * (2 if rule == "in2" else 1)
        self.collectives[kind] += float(n)
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _PRIM_DEVICE:
            # a tensor's device, asked for by most ops: no work
            return func(*args, **kwargs)
        ins = _op_tensors(args, kwargs)
        if any(isinstance(t, DTensor) for t in ins):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._standin or _in_sharding_propagation():
            return out
        name = func._overloadpacket.__name__
        if self._collective(name, (args, kwargs), out):
            return out
        if name in _FREE or func.is_view:
            return out
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += float(self.flop_registry[packet](
                *args, **kwargs, out_val=out))
        outs = _op_tensors(out if isinstance(out, tuple) else (out,), {})
        seen = {id(t) for t in ins}
        self.bytes += float(sum(_nbytes(t) for t in ins)
                            + sum(_nbytes(t) for t in outs
                                  if id(t) not in seen))
        for t in outs:
            if id(t) in seen or t._base is not None:
                continue
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._release, n)
        return out

    @contextlib.contextmanager
    def alltoall_as_issued(self):
        """On a CPU mesh DTensor runs an all-to-all as an all-gather plus a
        chunk (``placement_types.shard_dim_alltoall``); count it as the
        all-to-all it stands in for, and nothing inside it."""
        from torch.distributed.tensor import placement_types as ptypes
        inner = ptypes.shard_dim_alltoall

        def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
            self._standin += 1
            try:
                out = inner(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._standin -= 1
            if mesh.device_type == "cpu":
                self.collectives["all-to-all"] += float(_nbytes(out))
            return out

        ptypes.shard_dim_alltoall = counted
        try:
            yield
        finally:
            ptypes.shard_dim_alltoall = inner

    def stats(self) -> Dict[str, Any]:
        coll = dict(self.collectives)
        coll["total"] = sum(coll.values())
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": coll["total"], "collectives": coll}


@contextlib.contextmanager
def fake_world(world: int = WORLD):
    """The default process group as a ``"fake"`` group of ``world`` ranks,
    this process rank 0, destroyed on exit.  Refuses to replace a group the
    caller made."""
    import torch.distributed as dist
    # torch's own testing store: every collective on the fake group returns
    # at once, so nothing crosses a wire
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _check_propagation_hook()
    if dist.is_initialized():
        raise RuntimeError("a default process group exists; the dry-run "
                           "needs its own fake group (run it in its own "
                           "process, or destroy the group first)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _distribute(tree, axes_tree, mesh, rules, dtype=None):
    """Fake tensors of ``tree``'s (meta) leaves laid out over ``mesh`` by
    ``rules`` (``dtype`` overrides the leaves' dtype)."""
    from torch.distributed.tensor import distribute_tensor

    def one(axes, leaf):
        t = torch.empty(leaf.shape, dtype=dtype or leaf.dtype)
        spec = shd.assign_spec(rules, axes, leaf.shape, mesh)
        return distribute_tensor(t, mesh, shd.placements(spec, mesh))
    return shd.map_axes(one, axes_tree, tree)


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in pp.tensor_leaves(tree))


def _step(cfg, info, mesh, rules, opts: T.Opts):
    """(step function of no arguments, its arguments' local bytes): the
    cell's inputs made and laid out over ``mesh``."""
    kind, B, S = info["kind"], info["batch"], info["seq"]
    ab, ax = T.abstract_params(cfg), T.logical_axes(cfg)
    params = _distribute(ab, ax, mesh, rules)
    kw = specs_for(cfg, kind, B, S)
    if kind == "train":
        batch = _distribute(kw["batch"], batch_logical_axes(kw["batch"]),
                            mesh, rules)
        optimizer = AdamW(lr=1e-4)
        # a literal: the fake mode keeps its value, which the update reads
        state = AdamWState(step=torch.tensor(0, dtype=torch.int32),
                           mu=_distribute(ab, ax, mesh, rules, torch.float32),
                           nu=_distribute(ab, ax, mesh, rules, torch.float32))
        step = T.make_train_step(cfg, optimizer, opts)
        return (lambda: step(params, state, batch),
                _local_bytes([params, state.mu, state.nu, batch]))
    if kind == "prefill":
        # the cache prefill fills, laid out as the reference's out_shardings
        cache = _distribute(T.abstract_cache(cfg, B, S),
                            T.cache_logical_axes(cfg, B, S), mesh, rules)
        args = _distribute(kw, batch_logical_axes(kw), mesh, rules)
        return (lambda: T.prefill(params, cfg, max_len=S, opts=opts,
                                  last_logits_only=True, cache=cache,
                                  **args),
                _local_bytes([params, cache, args]))
    cache = _distribute(kw.pop("cache"), T.cache_logical_axes(cfg, B, S),
                        mesh, rules)
    args = _distribute(kw, batch_logical_axes(kw), mesh, rules)
    return (lambda: T.decode_step(params, cfg, cache, opts=opts, **args),
            _local_bytes([params, cache, args]))


def count_step(cfg, info, mesh, rules, opts: T.Opts) -> Dict[str, Any]:
    """Run one step of ``info``'s kind on ``mesh`` under FakeTensorMode and
    return rank 0's counts (:class:`DeviceCounter`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    opts = dataclasses.replace(opts, writes_in_range=True)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, arg_bytes = _step(cfg, info, mesh, rules, opts)
        counter = DeviceCounter()
        with counter.alltoall_as_issued(), counter, implicit_replication(), \
                shd.use_rules(mesh, rules):
            out = fn()
        out_bytes = _local_bytes(out[0] if info["kind"] != "train"
                                 else out[2])
        del out
    rec = counter.stats()
    rec["memory"] = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                     "temp_bytes": counter.peak,
                     "peak_bytes": arg_bytes + counter.peak}
    return rec


FIT_SEQS = (256, 512, 1024)


def needs_seq_fit(cfg, shape: str) -> bool:
    """A stack with a recurrent time scan (Mamba2, mLSTM, sLSTM), at a
    sequence over 1024, in a train or prefill cell."""
    recurrent = {C.MAMBA2, C.MLSTM, C.SLSTM}
    info = SHAPES[shape]
    return bool(recurrent & (set(cfg.unit) | set(cfg.tail))) \
        and info["seq"] > FIT_SEQS[-1] and info["kind"] != "decode"


def roofline_stats(cfg, shape: str, mesh, rules, opts: T.Opts
                   ) -> Dict[str, Any]:
    """The cell's per-device counts at full depth: one run at the full
    sequence, or (:func:`needs_seq_fit`) cost(T) = a + bT + cT^2 fit over
    :data:`FIT_SEQS` and evaluated at the full sequence, the memory of the
    longest fit run."""
    info = SHAPES[shape]
    if not needs_seq_fit(cfg, shape):
        return count_step(cfg, info, mesh, rules, opts)
    runs = [count_step(cfg, dict(info, seq=s), mesh, rules, opts)
            for s in FIT_SEQS]

    def fit(values):
        coeff = np.polyfit(np.array(FIT_SEQS, float),
                           np.array(values, float), 2)
        return float(np.polyval(coeff, info["seq"]))

    out = dict(runs[-1], counted_seqs=list(FIT_SEQS))
    for key in ("flops", "bytes", "collective_bytes"):
        out[key] = fit([r[key] for r in runs])
    out["collectives"] = {k: fit([r["collectives"][k] for r in runs])
                          for k in runs[-1]["collectives"]}
    return out


def roofline_terms(stats: Dict[str, float], n_chips: int) -> Dict[str, Any]:
    """Least time of the per-device counts on an H100 SXM (datasheet):
    flops over the bf16 peak, bytes over HBM, collective bytes over the
    inter-node link."""
    t_comp = stats["flops"] / PEAK_FLOPS
    t_mem = stats["bytes"] / HBM_BW
    t_coll = stats["collective_bytes"] / COLLECTIVE_BW
    dominant = max((("compute", t_comp), ("memory", t_mem),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_comp, "t_memory_s": t_mem,
            "t_collective_s": t_coll, "dominant": dominant,
            "global_flops": stats["flops"] * n_chips}


def model_flops(cfg, shape: str) -> float:
    """6 N D for a train step (forward and backward), 2 N D for inference,
    N the active parameters, D the tokens of the step."""
    info = SHAPES[shape]
    kind = info["kind"]
    tokens = info["batch"] * (1 if kind == "decode" else info["seq"])
    factor = 6.0 if kind == "train" else 2.0
    return factor * cfg.active_params_count() * tokens


def _where(exc) -> str:
    """The innermost frame of the port's model code in ``exc``'s
    traceback (file:line and its code): the op that failed."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename
              and not f.filename.endswith("dryrun.py")]
    if not frames:
        return ""
    f = frames[-1]
    path = f.filename[f.filename.index("repro_torch"):]
    return f"{path}:{f.lineno} {f.line}"


def run_cell(arch: str, shape: str, *, multi_pod: bool, roofline: bool,
             rules_kind: str = "auto", opts: Optional[T.Opts] = None,
             rules: Optional[dict] = None, cfg=None,
             mesh=None) -> Dict[str, Any]:
    """One cell's record.  Needs the fake world (:func:`fake_world`).
    ``cfg`` replaces the registry's config of ``arch`` and ``mesh`` the
    production mesh (tests run reduced configs on small fake meshes)."""
    cfg = cfg or registry.get(arch)
    ok, why = cell_applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape,
                           "multi_pod": multi_pod,
                           "torch": torch.__version__}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    mesh = mesh or make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
    kind = SHAPES[shape]["kind"]
    if rules is None:
        if rules_kind == "auto":
            rules = (shd.train_rules(multi_pod) if kind == "train"
                     else shd.serve_rules(multi_pod))
        else:
            rules = shd.RULE_VARIANTS[rules_kind](multi_pod)
    opts = opts or T.Opts()
    t0 = time.time()
    try:
        stats = roofline_stats(cfg, shape, mesh, rules, opts)
        rec["status"] = "ok"
        rec.update(stats)
        rec["compile_s"] = time.time() - t0
        n_chips = mesh.size()
        rec["n_chips"] = n_chips
        rec["model_flops"] = model_flops(cfg, shape)
        if roofline:
            rec["roofline_raw"] = {k: stats[k] for k in
                                   ("flops", "bytes", "collective_bytes")}
            rec["roofline"] = roofline_terms(stats, n_chips)
            rec["useful_flops_frac"] = (
                rec["model_flops"] / max(stats["flops"] * n_chips, 1.0))
    except Exception as e:                                  # noqa: BLE001
        rec["status"] = "FAILED"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["at"] = _where(e)
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    args = ap.parse_args(argv)

    opts = T.Opts(remat=args.remat)
    archs = registry.ASSIGNED if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    results = []
    with fake_world():
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    print(f"=== {arch} x {shape} x "
                          f"{'2x16x16' if mp else '16x16'} ===", flush=True)
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   roofline=args.roofline and not mp,
                                   opts=opts)
                    show = {k: v for k, v in rec.items()
                            if k not in ("traceback", "collectives",
                                         "roofline_raw")}
                    print(json.dumps(show, indent=1, default=str),
                          flush=True)
                    results.append(rec)
                    if args.json:
                        os.makedirs(os.path.dirname(args.json) or ".",
                                    exist_ok=True)
                        with open(args.json, "w") as f:
                            json.dump(results, f, indent=1, default=str)
    n_fail = sum(1 for r in results if r.get("status") == "FAILED")
    print(f"\n{len(results)} cells: "
          f"{sum(1 for r in results if r.get('status') == 'ok')} ok, "
          f"{sum(1 for r in results if r.get('status') == 'skipped')} "
          f"skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
