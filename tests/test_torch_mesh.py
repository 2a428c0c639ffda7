"""The port's mesh and sharding modules against the JAX package's.

``compute/mesh.py``: ``MeshSpec.resolved`` gives JAX's sizes and error
texts, ``make_mesh`` keeps every canonical axis, and
``mesh_for_generation`` takes the first ``tensor`` devices in index
order and validates with JAX's texts (on the forced 8-device CPU mesh
that ``tests/conftest.py`` sets up on the JAX side, ``["cpu"] * 8`` on
the port's). ``compute/sharding.py``: ``spec_for``/``tree_specs`` map
logical axes to JAX's PartitionSpecs entry for entry,
``transformer.logical_axes`` is JAX's tree for dense, per-layer and MoE
configs, and ``shard_tree`` cuts every leaf whose dims map to
``tensor`` into the pieces JAX's ``device_put`` lays on each device
(compared exactly, on the same numpy weights), sharing one copy of each
replicated leaf between the shards of one device. The training mesh:
``topology_chips`` and ``mesh_for_slice`` give JAX's sizes, a
position's coordinates are its place in JAX's device grid, and
``place_tree`` cuts all four models' params over every axis into the
shards JAX's ``NamedSharding`` puts on each device, one copy a
position.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.compute import mesh as j_mesh
from kubeflow_tpu.compute import sharding as j_sharding
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import mesh as t_mesh
from kubeflow_tpu_torch.compute import sharding as t_sharding
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_from_jax

CPU8 = ["cpu"] * 8


def _jcfg(**kw):
    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                max_seq=64, dtype="float32", attention="dense", remat=False)
    return jt.Config(**{**base, **kw})


def _tcfg(j):
    return tt.Config(**{f.name: getattr(j, f.name)
                        for f in dataclasses.fields(tt.Config)})


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("sizes,n", [
    (dict(tensor=4), 4), (dict(data=-1, tensor=2), 8),
    (dict(data=2, fsdp=2, tensor=2), 8), (dict(tensor=-1), 3)])
def test_meshspec_resolves_as_jax(sizes, n):
    assert t_mesh.MeshSpec(**sizes).resolved(n) \
        == j_mesh.MeshSpec(**sizes).resolved(n)
    assert t_mesh.AXIS_ORDER == j_mesh.AXIS_ORDER
    assert t_mesh.TENSOR == j_mesh.TENSOR


@pytest.mark.parametrize("sizes,n", [
    (dict(data=-1, tensor=-1), 8), (dict(data=-1, tensor=3), 8),
    (dict(tensor=4), 3)])
def test_meshspec_errors_are_jax_texts(sizes, n):
    assert _raises(lambda: t_mesh.MeshSpec(**sizes).resolved(n)) \
        == _raises(lambda: j_mesh.MeshSpec(**sizes).resolved(n))


def test_make_mesh_keeps_every_axis():
    t = t_mesh.make_mesh(data=2, tensor=2, devices=["cpu"] * 4)
    j = j_mesh.make_mesh(data=2, tensor=2, devices=jax.devices()[:4])
    assert t.shape == dict(zip(j.axis_names, j.devices.shape))
    assert t.size == 4 and t.devices == (torch.device("cpu"),) * 4


@pytest.mark.parametrize("tensor", [1, 2, 4, 8])
def test_mesh_for_generation_takes_the_first_devices(tensor):
    t = t_mesh.mesh_for_generation(tensor=tensor, devices=CPU8)
    j = j_mesh.mesh_for_generation(tensor=tensor)
    assert t.shape == dict(zip(j.axis_names, j.devices.shape))
    assert len(t.devices) == tensor
    # index order, as JAX orders by id
    devs = [torch.device("cuda", 3), torch.device("cuda", 1),
            torch.device("cuda", 2)]
    assert sorted(devs, key=lambda d: d.index)[:2] \
        == [torch.device("cuda", 1), torch.device("cuda", 2)]


@pytest.mark.parametrize("tensor", [0, -1, 9])
def test_mesh_for_generation_validates_as_jax(tensor):
    assert _raises(lambda: t_mesh.mesh_for_generation(
        tensor=tensor, devices=CPU8)) \
        == _raises(lambda: j_mesh.mesh_for_generation(tensor=tensor))


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the default devices are the CUDA cards")
def test_default_devices_are_the_cards_and_never_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_mesh.mesh_for_generation(tensor=1)


@pytest.mark.parametrize("axes", [
    None, ("embed", "mlp"), ("layers", "embed", "heads", None),
    ("vocab", "embed"), ("batch", "seq", "act_heads"),
    ("expert", "embed", "mlp")])
def test_spec_for_is_jax(axes):
    assert t_sharding.spec_for(axes) == tuple(j_sharding.spec_for(axes))


@pytest.mark.parametrize("kw", [
    {}, dict(scan_layers=False), dict(n_kv_heads=2),
    dict(moe_experts=4, d_ff=48)])
def test_logical_axes_and_specs_are_jax(kw):
    j = _jcfg(**kw)
    want = jt.logical_axes(j)
    got = tt.logical_axes(_tcfg(j))
    assert got == want
    jspecs = j_sharding.tree_specs(want)
    tspecs = t_sharding.tree_specs(got)
    flat = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert [tuple(s) for s in flat] == jax.tree.leaves(
        tspecs, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shard_tree_pieces_equal_jax_device_put(tp):
    """The platform rules over a ``tensor=tp`` mesh: piece i of every
    leaf is exactly the shard JAX's ``shard_tree`` puts on device i."""
    jcfg = _jcfg(n_kv_heads=2) if tp <= 2 else _jcfg()
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(tp))
    jm = j_mesh.mesh_for_generation(tensor=tp)
    axes = jt.logical_axes(jcfg)
    jshards = j_sharding.shard_tree(jparams, jm, axes)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    tm = t_mesh.mesh_for_generation(tensor=tp, devices=CPU8)
    pieces = t_sharding.shard_tree(tparams, tm, tt.logical_axes(
        _tcfg(jcfg)))
    assert len(pieces) == tp
    for path, leaf in jax.tree_util.tree_leaves_with_path(jshards):
        keys = [k.key for k in path]
        by_dev = {s.device.id: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        for i, dev in enumerate(jm.devices.reshape(-1)):
            got = pieces[i]
            for k in keys:
                got = got[k]
            np.testing.assert_array_equal(got.numpy(), by_dev[dev.id])


def test_shard_tree_shares_replicated_leaves_per_device():
    tree = {"w": torch.arange(24.).reshape(2, 12), "n": torch.ones(3)}
    axes = {"w": (None, "mlp"), "n": None}
    mesh = t_mesh.mesh_for_generation(tensor=4, devices=["cpu"] * 4)
    shards = t_sharding.shard_tree(tree, mesh, axes)
    assert all(s["n"] is tree["n"] for s in shards)
    torch.testing.assert_close(torch.cat([s["w"] for s in shards], 1),
                               tree["w"], rtol=0, atol=0)
    assert [tuple(s["w"].shape) for s in shards] == [(2, 3)] * 4


def test_shard_tree_refuses_what_it_cannot_split():
    mesh = t_mesh.mesh_for_generation(tensor=4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="does not split into 4"):
        t_sharding.shard_tree({"w": torch.ones(2, 6)}, mesh,
                              {"w": (None, "mlp")})
    fsdp = t_mesh.make_mesh(fsdp=2, tensor=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="only non-trivial axis"):
        t_sharding.shard_tree({"w": torch.ones(2, 4)}, fsdp,
                              {"w": (None, "mlp")})


# ------------------------------------------------------ the training mesh

@pytest.mark.parametrize("topology", ["2x2", "2x2x4", "4x4", "8"])
def test_topology_chips_is_jax(topology):
    from kubeflow_tpu.api import tpuslice
    assert t_mesh.topology_chips(topology) \
        == tpuslice.topology_chips(topology)


@pytest.mark.parametrize("kw", [dict(tensor=2), dict(fsdp=2, tensor=2),
                                dict(), dict(tensor=8)])
def test_mesh_for_slice_fills_data_as_jax(kw):
    t = t_mesh.mesh_for_slice("tpu-v5-lite-podslice", "4x4", devices=CPU8,
                              **kw)
    j = j_mesh.mesh_for_slice("tpu-v5-lite-podslice", "4x4", **kw)
    assert t.shape == dict(zip(j.axis_names, j.devices.shape))


def test_coords_and_groups_follow_the_device_grid():
    t = t_mesh.make_mesh(data=2, fsdp=2, tensor=2, devices=CPU8)
    j = j_mesh.make_mesh(data=2, fsdp=2, tensor=2,
                         devices=jax.devices()[:8])
    grid = np.vectorize(lambda d: d.id)(j.devices)
    for p in range(8):
        c = t.coords(p)
        assert grid[tuple(c[a] for a in j.axis_names)] == p
        assert t.position(c) == p
    assert t.along(5, "tensor") == [4, 5]
    assert t.along(5, ("data", "fsdp")) == [1, 3, 5, 7]
    assert t.along(0, ()) == [0]


@functools.lru_cache(maxsize=None)
def _model_trees():
    """(name, JAX params, port params, port and JAX logical axes) of the
    four models at widths that divide over the meshes below."""
    from kubeflow_tpu.compute.models import bert as jb
    from kubeflow_tpu.compute.models import mlp as jm
    from kubeflow_tpu.compute.models import resnet as jr
    from kubeflow_tpu_torch.compute.models import bert as tb
    from kubeflow_tpu_torch.compute.models import mlp as tm
    from kubeflow_tpu_torch.compute.models import resnet as tr
    from kubeflow_tpu_torch.compute.params import tree_from_jax
    key = jax.random.PRNGKey(0)
    out = []
    jcfg = _jcfg(n_kv_heads=4)
    out.append(("transformer", jt.init_params(jcfg, key),
                tt.logical_axes(_tcfg(jcfg)), jt.logical_axes(jcfg)))
    bcfg = jb.Config(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                     d_ff=128, max_seq=32, dtype="float32")
    out.append(("bert", jb.init_params(bcfg, key),
                tb.logical_axes(tb.Config(**dataclasses.asdict(bcfg))),
                jb.logical_axes(bcfg)))
    mcfg = jm.Config(in_dim=64, hidden=32, n_classes=8)
    out.append(("mlp", jm.init_params(mcfg, key),
                tm.logical_axes(tm.Config(**dataclasses.asdict(mcfg))),
                jm.logical_axes(mcfg)))
    rcfg = jr.Config(depth=18, n_classes=8, width=8, dtype="float32")
    params, _ = jax.jit(functools.partial(jr.init_params, rcfg))(key)
    out.append(("resnet", params,
                tr.logical_axes(tr.Config(**dataclasses.asdict(rcfg)))[0],
                jr.logical_axes(rcfg)[0]))
    return [(name, jp, tree_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu"), taxes, jaxes)
            for name, jp, taxes, jaxes in out]


@pytest.mark.parametrize("sizes", [dict(data=2, fsdp=2, tensor=2),
                                   dict(fsdp=2, tensor=4), dict(data=8)])
def test_place_tree_pieces_equal_jax_named_shardings(sizes):
    """Every position's piece of every leaf of the four models is the
    shard JAX's ``NamedSharding`` puts on the device at the same place
    in the grid (compared exactly), and each position has its own copy."""
    from kubeflow_tpu_torch.compute import train as t_train
    jm_ = j_mesh.make_mesh(devices=jax.devices()[:8], **sizes)
    tm_ = t_mesh.make_mesh(devices=CPU8, **sizes)
    for name, jparams, tparams, taxes, jaxes in _model_trees():
        assert taxes == jaxes, name
        jplaced = jax.device_put(jparams,
                                 j_sharding.tree_shardings(jm_, jaxes))
        placed = t_sharding.place_tree(tparams, tm_, taxes)
        tshard = t_sharding.tree_shardings(tm_, taxes)
        jleaves = jax.tree_util.tree_leaves_with_path(jplaced)
        tleaves = t_train.tree_leaves(placed)
        assert len(jleaves) == len(tleaves), name
        for (path, jleaf), tleaf, sh in zip(
                jleaves, tleaves, t_train.tree_leaves(tshard)):
            assert tleaf.spec == tuple(jleaf.sharding.spec) == sh.spec
            by_dev = {s.device.id: np.asarray(s.data)
                      for s in jleaf.addressable_shards}
            for p, dev in enumerate(jm_.devices.reshape(-1)):
                np.testing.assert_array_equal(
                    tleaf.pieces[p].numpy(), by_dev[dev.id],
                    err_msg=f"{name} {jax.tree_util.keystr(path)}")
            ptrs = {t.data_ptr() for t in tleaf.pieces}
            assert len(ptrs) == 8
            np.testing.assert_array_equal(tleaf.gather().numpy(),
                                          np.asarray(jleaf))


def test_init_state_shards_as_jax():
    """``TestTrainEngine.test_state_is_sharded_on_mesh``: on fsdp=2,
    tensor=4 the stacked w_gate is (None, fsdp, tensor), and the moments
    take the params' layout."""
    from kubeflow_tpu_torch.compute import train as t_train
    cfg = _tcfg(_jcfg())
    mesh = t_mesh.make_mesh(fsdp=2, tensor=4, devices=CPU8)
    state = t_train.init_state(
        functools.partial(tt.init_params, cfg), t_train.make_optimizer(),
        mesh=mesh, logical_axes=tt.logical_axes(cfg))
    leaf = state.params["layers"]["w_gate"]
    assert tuple(leaf.sharding.spec) == (None, "fsdp", "tensor")
    assert leaf.pieces[0].shape == (2, 16, cfg.ff_dim // 4)
    assert all(t.requires_grad for t in leaf.pieces)
    mu = state.opt_state["mu"]["layers"]["w_gate"]
    assert mu.sharding is leaf.sharding and not mu.pieces[0].requires_grad
