"""The port's ring attention (``compute/attention.py``) and the
``sequence`` axis of its training mesh, against the JAX package's, on
the CPU in fp32.

JAX runs on ``jax.devices()[:n]`` of the forced 8-device CPU mesh
(``tests/conftest.py``), the port on a mesh of ``["cpu"] * n`` with the
same axis sizes; inputs and weights are the same numpy arrays (JAX
``init_params`` carried across with ``params_from_jax``), the
transformer's shared through a module fixture.

Tolerances: attention outputs 1e-6 absolute (the port folds the blocks
in JAX's order, so only fp32 rounding of the einsums differs);
gradients rtol 1e-4 / atol 1e-6 and losses rtol 1e-5, as the JAX
package's tests hold them; three train steps by
``tests/test_torch_train_mesh.py``'s rules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.compute import attention as j_attn
from kubeflow_tpu.compute import sharding as j_sharding
from kubeflow_tpu.compute import train as j_train
from kubeflow_tpu.compute.models import bert as jb
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import attention as t_attn
from kubeflow_tpu_torch.compute import data as t_data
from kubeflow_tpu_torch.compute import sharding as t_sharding
from kubeflow_tpu_torch.compute import train as t_train
from kubeflow_tpu_torch.compute.models import bert as tb
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_from_jax, tree_from_jax
from test_torch_train_mesh import (_lm_batches, _meshes, _np, _parity,
                                   _port_cfg)

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _qkv(shape=(2, 64, 4, 16), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------ the ring

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax(n, causal):
    q, k, v = _qkv()
    jmesh, tmesh = _meshes(sequence=n)
    want = j_attn.ring_attention_sharded(q, k, v, causal=causal, mesh=jmesh)
    got = t_attn.ring_attention_sharded(_t(q), _t(k), _t(v), tmesh,
                                        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # the blocks live on their positions: the list form gives the same
    c = q.shape[1] // n
    blocks = t_attn.ring_attention(
        *[[_t(x[:, j * c:(j + 1) * c]) for j in range(n)]
          for x in (q, k, v)], causal=causal)
    np.testing.assert_array_equal(torch.cat(blocks, dim=1).numpy(),
                                  got.numpy())


def test_ring_gradients_match_jax():
    """``test_ring_gradients_match_dense``'s loss ``sum(o²)`` on
    sequence=4: the gradient of q, k and v through the folds and the
    hops against ``jax.grad`` of JAX's ring."""
    q, k, v = _qkv(seed=1)
    jmesh, tmesh = _meshes(sequence=4)
    with jax.set_mesh(jmesh):
        want = jax.jit(jax.grad(
            lambda q, k, v: (j_attn.ring_attention_sharded(q, k, v) ** 2
                             ).sum(), argnums=(0, 1, 2)))(q, k, v)
    ts = [_t(x).requires_grad_() for x in (q, k, v)]
    out = t_attn.ring_attention_sharded(*ts, tmesh)
    got = torch.autograd.grad((out ** 2).sum(), ts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_ring_composes_with_tensor_axis():
    """Heads cut over tensor=4 while the sequence rides a ring of 2."""
    q, k, v = _qkv(seed=2)
    jmesh, tmesh = _meshes(sequence=2, tensor=4)
    want = j_attn.ring_attention_sharded(q, k, v, mesh=jmesh)
    got = t_attn.ring_attention_sharded(_t(q), _t(k), _t(v), tmesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    dense = t_attn.dense_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5)


def test_ring_refuses_an_uneven_sequence():
    q, k, v = (_t(x[:, :30]) for x in _qkv())
    _, tmesh = _meshes(sequence=4)
    with pytest.raises(ValueError, match="S=30 does not divide over the "
                                         "mesh's sequence axis of 4"):
        t_attn.ring_attention_sharded(q, k, v, tmesh)


# ------------------------------------------------------ the transformer

def _lm_cfg(**kw):
    """``test_compute_models.py``'s ``tiny_cfg`` with ring attention and
    GQA 4:2."""
    base = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, max_seq=32, dtype="float32", attention="ring",
                remat=True)
    base.update(kw)
    jcfg = jt.Config(**base)
    return jcfg, _port_cfg(tt, jcfg)


def _lm_params(jcfg, seed=0):
    return _np(jt.init_params(jcfg, jax.random.PRNGKey(seed)))


def jax_loss_and_grads(jcfg, params, batch, sizes):
    """JAX's ``value_and_grad`` of ``loss_fn`` on the mesh ``sizes``
    (one device when empty), the params placed by ``logical_axes``."""
    jmesh = _meshes(**sizes)[0] if sizes else _meshes(data=1)[0]
    placed = j_sharding.shard_tree(jax.tree.map(jnp.asarray, params), jmesh,
                                   jt.logical_axes(jcfg))
    with jax.set_mesh(jmesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jt.loss_fn(p, jax.tree.map(jnp.asarray, batch),
                                 jcfg)[0]))(placed)
    return float(loss), jax.tree.leaves(_np(grads))


def port_loss_and_grads(tcfg, params, batch, sizes, model=tt):
    """The port's loss on the mesh ``sizes`` and each leaf's logical
    gradient (every piece's gradient summed over its copies, as the
    train step sums them, then gathered)."""
    _, tmesh = _meshes(**sizes)
    state = t_train.init_state(
        lambda g, device: tree_from_jax(params, device=device),
        t_train.make_optimizer(), mesh=tmesh,
        logical_axes=model.logical_axes(tcfg))
    leaves = t_train.tree_leaves(state.params)
    pieces = t_sharding.pieces_of(leaves)
    loss, _ = model.loss_fn(state.params, t_data.shard_batch(batch, tmesh),
                            tcfg)
    grads, _ = t_train._sum_copies(leaves, t_train._grads(loss, pieces))
    out, start = [], 0
    for leaf in leaves:
        n = len(leaf.pieces)
        out.append(t_sharding.Sharded(grads[start:start + n], leaf.sharding,
                                      leaf.shape).gather())
        start += n
    return float(loss.detach()), out


def assert_loss_and_grads(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


@pytest.fixture(scope="module")
def lm_case():
    jcfg, tcfg = _lm_cfg()
    return jcfg, tcfg, _lm_params(jcfg), _lm_batches()[0]


@pytest.mark.parametrize("sizes", [dict(sequence=2), dict(sequence=4),
                                   dict(data=2, sequence=2, tensor=2)],
                         ids=["seq2", "seq4", "data2-seq2-tp2"])
def test_transformer_ring_loss_and_grads_match_jax(lm_case, sizes):
    """At sequence=4 a wrong RoPE or mask offset cannot cancel: each
    chunk's rotation and causal mask are its global positions'."""
    jcfg, tcfg, params, batch = lm_case
    assert_loss_and_grads(port_loss_and_grads(tcfg, params, batch, sizes),
                          jax_loss_and_grads(jcfg, params, batch, sizes))


def test_transformer_one_device_ring_matches_jax(lm_case):
    """Without a mesh the ring is one position's, as JAX's under a
    one-device mesh; logits and the loss's gradients agree."""
    jcfg, tcfg, params, batch = lm_case
    want = jax_loss_and_grads(jcfg, params, batch, {})
    tparams = params_from_jax(params, device="cpu")
    leaves = t_train.tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = tt.loss_fn(tparams, t_data.to_device(batch, "cpu"), tcfg)
    assert_loss_and_grads((float(loss.detach()),
                           t_train._grads(loss, leaves)), want)
    jmesh = _meshes(data=1)[0]
    placed = j_sharding.shard_tree(jax.tree.map(jnp.asarray, params), jmesh,
                                   jt.logical_axes(jcfg))
    with jax.set_mesh(jmesh):
        logits = jax.jit(lambda p, t: jt.apply(p, t, jcfg))(
            placed, jnp.asarray(batch["tokens"]))
    np.testing.assert_allclose(
        tt.apply(tparams, torch.from_numpy(batch["tokens"]), tcfg)
        .detach().numpy(), np.asarray(logits), atol=1e-4, rtol=0)


def test_transformer_ring_train_steps_match_jax():
    """3 steps of JAX's ``make_train_step`` and the port's on data=2,
    sequence=2, tensor=2, and the port's unsharded step (a ring of one
    position), with masks."""
    jcfg, tcfg = _lm_cfg()
    params = _lm_params(jcfg, seed=3)
    _parity(j_train.plain_loss(jt.loss_fn, jcfg),
            t_train.plain_loss(tt.loss_fn, tcfg),
            lambda k: jax.tree.map(jnp.asarray, params),
            lambda g, device: params_from_jax(params, device=device),
            jt.logical_axes(jcfg), tt.logical_axes(tcfg), _lm_batches(),
            dict(data=2, sequence=2, tensor=2))


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_dense_and_flash_on_a_sequence_mesh_match_jax(lm_case, attention):
    """Dense and flash attention on sequence=2: each head group's chunks
    are joined over the whole sequence (XLA's gather), so the loss and
    grads are JAX's on that mesh."""
    _, _, params, batch = lm_case
    jcfg, tcfg = _lm_cfg(attention=attention)
    sizes = dict(data=2, sequence=2, tensor=2)
    assert_loss_and_grads(port_loss_and_grads(tcfg, params, batch, sizes),
                          jax_loss_and_grads(jcfg, params, batch, sizes))


def test_transformer_refuses_an_uneven_sequence(lm_case):
    _, tcfg, params, batch = lm_case
    batch = {k: v[:, :30] for k, v in batch.items()}
    with pytest.raises(ValueError, match="sequence length 30 does not "
                                         "divide over the mesh's sequence "
                                         "axis of 4"):
        port_loss_and_grads(tcfg, params, batch, dict(sequence=4))


# ----------------------------------------------------------------- BERT

@pytest.mark.parametrize("sizes", [dict(sequence=2),
                                   dict(data=2, sequence=2, tensor=2)],
                         ids=["seq2", "data2-seq2-tp2"])
def test_bert_ring_loss_and_grads_match_jax(sizes):
    """``TestBert``'s config with ``attention="ring"`` (non-causal):
    ``pos_embed`` at each chunk's global rows, the chunks joined before
    the MLM head; the loss and every gradient leaf against JAX's on the
    same mesh (the key bias, zero analytically, within 1e-6)."""
    jcfg = jb.Config(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                     d_ff=128, max_seq=32, dtype="float32", attention="ring",
                     remat=False)
    tcfg = _port_cfg(tb, jcfg)
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), _np(jb.init_params(jcfg, jax.random.PRNGKey(0))))
    batch = tb.mlm_batch(np.random.default_rng(5), 4, tcfg)
    jmesh = _meshes(**sizes)[0]
    placed = j_sharding.shard_tree(jax.tree.map(jnp.asarray, params), jmesh,
                                   jb.logical_axes(jcfg))
    with jax.set_mesh(jmesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jb.loss_fn(p, jax.tree.map(jnp.asarray, batch),
                                 jcfg)[0]))(placed)
    got = port_loss_and_grads(tcfg, params, batch, sizes, model=tb)
    np.testing.assert_allclose(got[0], float(loss), rtol=1e-5)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(grads)]
    for name, g, w in zip(names, got[1], jax.tree.leaves(_np(grads))):
        if "bk" in name:
            assert np.abs(g.numpy()).max() < 1e-6 and np.abs(w).max() < 1e-6
        else:
            np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL,
                                       err_msg=name)


def test_bert_refuses_a_pipeline_mesh():
    cfg = tb.Config(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                    d_ff=64, max_seq=16, dtype="float32", attention="dense")
    with pytest.raises(ValueError, match="BERT has no pipeline"):
        tb._check_mesh(cfg, _meshes(pipeline=2)[1])

