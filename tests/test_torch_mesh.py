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
replicated leaf between the shards of one device.
"""

import dataclasses

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
