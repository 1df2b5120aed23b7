"""The port's rule tables, meshes and dry-run input specs
(``distributed/sharding.py``, ``launch/mesh.py``, ``launch/specs.py``)
against the reference's on the CPU: the same specs for every parameter and
cache leaf on the production meshes, the same carving of replica axes, the
same cells' inputs."""

import multiprocessing as mp
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jregistry
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.models import transformer as JT
from repro_torch.configs import registry
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.models import params as pp
from repro_torch.models import transformer as T
from torch_dist import SHARD_WRITES, gloo_world, seeded, shard_write_rank


class FakeMesh:
    """Minimal mesh stand-in exposing .shape for assign_spec tests."""
    def __init__(self, shape):
        self.shape = shape


POD = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})


def ours(spec):
    """The reference's PartitionSpec in the port's form."""
    return tuple(None if p is None else ((p,) if isinstance(p, str)
                                         else tuple(p)) for p in spec)


# (rules, dims, shape, mesh, expected), the reference's test cases
ASSIGN = [
    (jshd.serve_rules(False), ("cache_batch", "cache_seq", "kv_heads",
                               "head_dim"), (128, 32768, 8, 128), POD,
     JP("data", "model", None, None)),
    (jshd.serve_rules(False), ("cache_batch", "cache_seq", "kv_heads",
                               "head_dim"), (128, 32768, 16, 128), POD,
     JP("data", None, "model", None)),
    (jshd.train_rules(True), ("batch", "seq"), (256, 4096), MULTI,
     JP(("pod", "data"), None)),
    (jshd.train_rules(True), ("batch", "seq"), (1, 4096), MULTI,
     JP(None, None)),
    (jshd.train_rules(False), ("vocab", "heads"), (32768, 48), POD, None),
]


@pytest.mark.parametrize("case", range(len(ASSIGN)))
def test_assign_spec_matches_reference(case):
    jrules, dims, shape, m, want = ASSIGN[case]
    name = next(k for k, f in jshd.RULE_VARIANTS.items()
                if f("pod" in m.shape) == jrules)
    rules = shd.RULE_VARIANTS[name]("pod" in m.shape)
    got = shd.assign_spec(rules, dims, shape, m)
    assert got == ours(jshd.assign_spec(jrules, dims, shape, m))
    if want is not None:
        assert got == ours(want)
    else:   # vocab and heads both want model: only one gets it
        assert sum(p == ("model",) for p in got) == 1


def test_tables_and_priorities_are_the_reference():
    assert shd.PRIORITY == jshd.PRIORITY
    assert shd.DEFAULT_PRIORITY == jshd.DEFAULT_PRIORITY
    assert list(shd.RULE_VARIANTS) == list(jshd.RULE_VARIANTS)
    for name, fn in shd.RULE_VARIANTS.items():
        for mp in (False, True):
            assert fn(mp) == jshd.RULE_VARIANTS[name](mp), (name, mp)


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _ref_leaves(tree, is_leaf=None):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path)] = leaf
    return out


def _is_axes(a):
    return isinstance(a, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in a)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x22b",
                                  "zamba2-1.2b", "xlstm-350m", "llama-7b"])
def test_param_specs_match_reference_per_leaf(arch):
    """Every port leaf's spec, on both production meshes under the train
    and serve tables, equals the reference's leaf's (its leading unit axis
    dropped for a leaf of the scanned stack)."""
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    ab, ax = T.abstract_params(cfg), T.logical_axes(cfg)
    jab = _ref_leaves(JT.abstract_params(jcfg))
    jax_ = _ref_leaves(JT.logical_axes(jcfg), is_leaf=_is_axes)
    port = dict(_port_leaves(ab))
    axes = dict(_port_leaves(ax))
    assert len(port) == sum(
        jab[k].shape[0] if k.startswith("scan/") else 1 for k in jab)
    for mp, m in ((False, POD), (True, MULTI)):
        for name in ("train", "serve"):
            rules = shd.RULE_VARIANTS[name](mp)
            jrules = jshd.RULE_VARIANTS[name](mp)
            for key, leaf in port.items():
                rkey, unit = pp.reference_key(key, cfg)
                jshape, jaxes = tuple(jab[rkey].shape), jax_[rkey]
                jspec = ours(jshd.assign_spec(jrules, jaxes, jshape, m))
                if unit is not None:
                    jshape, jaxes, jspec = jshape[1:], jaxes[1:], jspec[1:]
                assert tuple(leaf.shape) == jshape and axes[key] == jaxes
                got = shd.assign_spec(rules, axes[key], leaf.shape, m)
                assert got == jspec, (arch, key, name, mp)


def test_placements_of_multi_axis_dims():
    from torch.distributed.tensor import Replicate, Shard
    m = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert shd.placements((("pod", "data"), None, ("model",)), m) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements((None, ("data", "model")), m) == (
        Replicate(), Shard(1), Shard(1))
    assert shd.placements((None, None), m) == (Replicate(),) * 3
    assert shd.replicated(types.SimpleNamespace(ndim=2)) == (Replicate(),) * 2


def test_placements_lay_out_local_shards():
    """On a fake 2x2x2 mesh a (pod, data) dim splits over four ranks and a
    model dim over two: rank 0's shard of (8, 4, 6) is (2, 4, 3)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    with dryrun.fake_world(8):
        m = mesh._device_mesh("cpu", np.arange(8).reshape(2, 2, 2),
                              ("pod", "data", "model"))
        spec = shd.assign_spec(shd.train_rules(True),
                               ("batch", None, "mlp"), (8, 4, 6), m)
        assert spec == (("pod", "data"), None, ("model",))
        with FakeTensorMode(allow_non_fake_inputs=True):
            t = distribute_tensor(torch.empty(8, 4, 6), m,
                                  shd.placements(spec, m))
            assert tuple(t.to_local().shape) == (2, 4, 3)
            # constrain redistributes a DTensor to the rule's layout
            with shd.use_rules(m, shd.train_rules(True)):
                r = shd.constrain(t, None, None, "mlp")
            assert tuple(r.to_local().shape) == (8, 4, 3)


def test_constrain_is_a_no_op_without_rules_and_on_plain_tensors():
    x = torch.randn(4, 8)
    assert not shd.active()
    assert shd.constrain(x, "batch", "act_embed") is x
    with shd.use_rules(POD, shd.serve_rules()):
        assert shd.active()
        assert shd.constrain(x, "batch", "act_embed") is x
    assert not shd.active()


CARVE = [((2, 16, 16), ("replica", "data", "model")),
         ((16, 3, 16), ("data", "replica", "model")),
         ((16, 16), ("data", "model")),
         ((1, 4, 2), ("replica", "data", "model"))]


@pytest.mark.parametrize("shape,names", CARVE)
def test_carve_replica_axis_matches_reference(shape, names):
    devices = np.arange(int(np.prod(shape))).reshape(shape)
    parts, rest = mesh.carve_replica_axis(devices, names)
    jparts, jrest = jmesh.carve_replica_axis(devices, names)
    assert rest == jrest and len(parts) == len(jparts)
    for p, jp in zip(parts, jparts):
        np.testing.assert_array_equal(p, jp)


def test_replica_submeshes_of_a_fake_world():
    """The first 8 ranks of a 256-rank world as (replica 2, data 2, model
    2): two sub-meshes, the reference's carving of the same ranks; the
    elastic carve holds the replica count; the 16x16 production mesh."""
    with dryrun.fake_world(256):
        m = mesh._device_mesh("cpu", np.arange(8).reshape(2, 2, 2),
                              ("replica", "data", "model"))
        subs = mesh.replica_submeshes(m)
        jparts, _ = jmesh.carve_replica_axis(np.arange(8).reshape(2, 2, 2),
                                             ("replica", "data", "model"))
        assert [s.mesh_dim_names for s in subs] == [("data", "model")] * 2
        for s, jp in zip(subs, jparts):
            np.testing.assert_array_equal(s.mesh.numpy(), jp)
        assert mesh.elastic_replica_submeshes(m, 2) == subs
        prod = mesh.make_production_mesh(device_type="cpu")
        assert shd.mesh_shape(prod) == {"data": 16, "model": 16}
        assert mesh.replica_submeshes(prod) == [prod]


def test_elastic_mismatch_error_matches_reference():
    jm = jax.make_mesh((1, 1, 1), ("replica", "data", "model"))
    with pytest.raises(ValueError) as jerr:
        jmesh.elastic_replica_submeshes(jm, 2)
    with gloo_world():
        m = mesh.make_local_mesh(replicas=1, device_type="cpu")
        grid = mesh.RankGrid("cpu", np.zeros((1, 1, 1), np.int64),
                             ("replica", "data", "model"))
        with pytest.raises(ValueError) as err:
            mesh.elastic_replica_submeshes(grid, 2)
        assert str(err.value) == str(jerr.value)
        with pytest.raises(ValueError, match=">= 1"):
            mesh.elastic_replica_submeshes(m, 0)


def test_replicas_share_the_one_rank():
    """With fewer ranks than replicas (one card) every replica's sub-mesh is
    the 1x1 mesh of the shared rank."""
    with gloo_world():
        grid = mesh.make_local_mesh(replicas=3, device_type="cpu")
        assert isinstance(grid, mesh.RankGrid)
        subs = mesh.replica_submeshes(grid)
        assert len(subs) == 3
        for s in subs:
            assert shd.mesh_shape(s) == {"data": 1, "model": 1}
            assert s.mesh.tolist() == [[0]]
        with pytest.raises(ValueError, match="needs 4 ranks"):
            mesh.make_local_mesh(data=2, model=2, device_type="cpu")


CELLS = [(a, s) for a in jregistry.ASSIGNED for s in jspecs.SHAPES]
_PORT_CACHE = {"C": "mlstm_C", "n": "mlstm_n"}


def _port_cache_name(ref_key):
    """The port's cache leaf of a reference cache path (scan/u0_mlstm/C,
    tail0_attn/k)."""
    block, field = ref_key.split("/")[-2:]
    kind = block.split("_", 1)[1]
    if kind == "mlstm":
        return _PORT_CACHE[field]
    if kind == "slstm":
        return "slstm_" + field
    return field


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    ok, why = specs.cell_applicable(cfg, shape)
    assert (ok, why) == jspecs.cell_applicable(jcfg, shape)
    if not ok:
        return
    assert specs.SHAPES[shape] == jspecs.SHAPES[shape]
    kw, jkw = specs.input_specs(cfg, shape), jspecs.input_specs(jcfg, shape)
    cache, jcache = kw.pop("cache", None), jkw.pop("cache", None)
    mine = dict(_port_leaves(kw))
    ref = _ref_leaves(jkw)
    assert sorted(mine) == sorted(ref)
    for k, t in mine.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[k].shape), k
        assert str(t.dtype).split(".")[1] == str(ref[k].dtype), k
    assert specs.batch_logical_axes(kw) == jspecs.batch_logical_axes(jkw)
    if cache is None:
        return
    info = specs.SHAPES[shape]
    axes = T.cache_logical_axes(cfg, info["batch"], info["seq"])
    jaxes = _ref_leaves(JT.cache_logical_axes(jcfg, info["batch"],
                                              info["seq"]),
                        is_leaf=_is_axes)
    layers = dict.fromkeys(cache, 0)
    for k, leaf in _ref_leaves(jcache).items():
        name, scan = _port_cache_name(k), k.startswith("scan/")
        block = tuple(leaf.shape[1:] if scan else leaf.shape)
        assert tuple(cache[name].shape[1:]) == block, (k, name)
        assert axes[name][1:] == (jaxes[k][1:] if scan else jaxes[k])
        layers[name] += leaf.shape[0] if scan else 1
    assert layers == {n: t.shape[0] for n, t in cache.items()}


def test_shard_write_over_two_ranks(tmp_path):
    """``sharding.shard_write`` on a spawned 2-rank ``gloo`` group: a cache
    sharded on rows, slots or heads, written by updates that land on both
    ranks or on one, gathers to the plain ``dst[rows, slots] = src``."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=shard_write_rank, args=(r, store, out))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict(out.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    full = seeded((4, 6, 2, 3), 30)
    for name, (rows, slots) in SHARD_WRITES.items():
        want = full.copy()
        want[rows, slots] = seeded((len(rows), 2, 3), 31)
        for r in range(2):
            for (case, dim, how), cache in got[r].items():
                if case == name:
                    np.testing.assert_array_equal(
                        cache, want, err_msg=f"{case} {dim} {how} rank {r}")
    assert len(got[0]) == len(SHARD_WRITES) * 9


@pytest.mark.parametrize("S", [8, 5])
def test_write_index_in_range_keeps_every_write(S):
    """``Opts.writes_in_range``'s form of ``write_index``: the whole grid,
    no filter; equal to the filtering form where every write is in range,
    and an out-of-range write then raises at the write."""
    idx = torch.tensor([[0, 1, 2], [4, 5, 6]], dtype=torch.int32)
    kept = T.write_index(idx, S, in_range=True)
    assert [t.tolist() for t in kept] == [[0, 0, 0, 1, 1, 1],
                                          [0, 1, 2, 4, 5, 6],
                                          [0, 1, 2, 3, 4, 5]]
    if S == 8:
        assert all(torch.equal(a, b)
                   for a, b in zip(kept, T.write_index(idx, S)))
    else:
        with pytest.raises(IndexError):
            T.masked_write(torch.zeros(2, S), kept[:2],
                           torch.ones(6)[kept[2]])
