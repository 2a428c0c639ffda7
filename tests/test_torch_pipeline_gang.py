"""``train_1f1b`` on a mesh whose ``data`` axis crosses two processes,
against the port's one-process mesh and JAX's ``jax.jit(train_1f1b)``
on the same global mesh.

One pair of ``gloo`` ranks runs every case: the toy stack of
``tests/test_torch_pipeline.py`` (``tanh`` layers, a cross-entropy
head) with no aux, with the plain aux ``mean(x²)`` and with the
non-linear ``(mean x)²`` in row form (``pipeline.RowAux``; JAX's twin is
``jnp.mean(x) ** 2`` on the whole microbatch), each on a gang of
``data=1 × pipeline=2`` a rank (global ``data=2``) and of ``data=2 ×
pipeline=2`` a rank (global ``data=4``). ``ROWS`` global rows in
``MICRO`` microbatches; each rank feeds its half.

Tolerances: the ranks byte-equal each other (loss and every gradient);
one process's ``data=D × pipeline=2`` to the bit where each rank holds
one coordinate (every sum then has the same two summands), within 1e-6
of each leaf's max |g| (loss rtol 1e-6) where it holds two (the gang
sums ``(g0 + g1) + (g2 + g3)``, one process ``((g0 + g1) + g2) + g3``);
JAX's within loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6, as
``test_1f1b_beside_other_axes_matches_jax`` holds it.

The rank children import this file (no JAX) and run with one thread and
a timeout.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.compute import mesh as t_mesh
from kubeflow_tpu_torch.compute import pipeline as t_pipeline
from kubeflow_tpu_torch.compute import train as t_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180
D, V, L, S = 16, 32, 4, 8
ROWS, MICRO, AUX_WEIGHT = 16, 4, 0.3
#: ``(data coordinates a rank, aux)``
CASES = [(dl, aux) for dl in (1, 2) for aux in (None, "square", "row")]
IDS = [f"dl{dl}-{aux or 'none'}" for dl, aux in CASES]


def toy_fns(aux=None):
    """The port's toy ``(embed_fn, layer_fn, loss_fn)``: ``layer_fn``'s
    aux None, ``"square"`` (``mean(x²)``, 0-d) or ``"row"`` (``(mean
    x)²`` as a :class:`pipeline.RowAux`: the sum of the cut's ``x`` and
    its square over the whole microbatch's count)."""
    def embed(ep, tok):
        return ep["emb"][tok.long()]

    def layer(lp, x):
        y = x + torch.tanh(x @ lp["w"])
        if aux == "square":
            return y, x.square().mean()
        if aux == "row":
            per_row = x[0].numel()
            return y, t_pipeline.RowAux(
                x.sum().reshape(1),
                lambda total, rows: (total[0] / (rows * per_row)) ** 2)
        return y, None

    def loss(hp, y, tgt):
        logits = y @ hp["out"]
        lab = torch.gather(logits, -1, tgt.long()[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - lab).mean()

    return embed, layer, loss


def toy_data(batch, seed=3):
    tok = np.random.default_rng(seed).integers(0, V, (batch, S),
                                               dtype=np.int32)
    return tok, np.roll(tok, -1, axis=1)


def toy_params(seed=7):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    return {"embed": {"emb": normal(V, D)}, "layers": {"w": normal(L, D, D)},
            "head": {"out": normal(D, V)}}


def run(mesh, rows, aux):
    """``train_1f1b`` of the toy on ``mesh``, fed rows ``rows`` (a slice)
    of the global batch → ``(loss, gradient leaves, live inputs)``."""
    tok, tgt = (torch.from_numpy(x[rows]) for x in toy_data(ROWS))
    params = t_train.tree_map(torch.from_numpy, toy_params())
    loss, grads = t_pipeline.train_1f1b(
        *toy_fns(aux), params, tok, tgt, MICRO, mesh,
        aux_weight=AUX_WEIGHT if aux else 0.0)
    return (loss.detach(), t_train.tree_leaves(grads),
            t_pipeline.train_1f1b.live_inputs)


def gang_runs(rank):
    """Every case on this rank's part of the gang → ``{case id:
    run(...)}``."""
    import torch.distributed as dist
    out = {}
    half = ROWS // 2
    for name, (dl, aux) in zip(IDS, CASES):
        mesh = t_mesh.make_mesh(t_mesh.MeshSpec(data=-1, pipeline=2),
                                devices=["cpu"] * (2 * dl),
                                group=dist.group.WORLD)
        out[name] = run(mesh, slice(rank * half, (rank + 1) * half), aux)
    return out


_RANK = textwrap.dedent('''
    import sys
    import torch, torch.distributed as dist
    import test_torch_pipeline_gang as G
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                            world_size=2, rank=rank)
    torch.save(G.gang_runs(rank), out)
    dist.destroy_process_group()
''')


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The two ranks' results of one subprocess pair."""
    tmp = tmp_path_factory.mktemp("gang1f1b")
    port = str(_free_port())
    outs = [tmp / f"rank{r}.pt" for r in range(2)]
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                              "tests")]))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port,
                               str(outs[r])], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    return [torch.load(o, weights_only=False) for o in outs]


def _one_process(dl, aux):
    n = 2 * dl
    return run(t_mesh.make_mesh(data=n, pipeline=2, devices=["cpu"] * 2 * n),
               slice(None), aux)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's ``jax.jit(train_1f1b)`` on a ``data=2·dl × pipeline=2`` mesh
    of its CPU devices, the whole batch, for every case → ``{case id:
    (loss, gradient leaves)}``. JAX is imported here alone: the rank
    children import this file."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.compute import mesh as j_mesh
    from kubeflow_tpu.compute import pipeline as j_pipeline
    from test_torch_pipeline import _j_fns

    tok, tgt = toy_data(ROWS)
    out = {}
    for name, (dl, aux) in zip(IDS, CASES):
        jmesh = j_mesh.make_mesh(devices=jax.devices()[:4 * dl],
                                 data=2 * dl, pipeline=2)
        with jax.set_mesh(jmesh):
            loss, grads = jax.jit(lambda p, aux=aux: j_pipeline.train_1f1b(
                *_j_fns(aux), p, tok, tgt, n_microbatches=MICRO,
                aux_weight=AUX_WEIGHT if aux else 0.0))(
                    jax.tree.map(jnp.asarray, toy_params()))
        out[name] = (float(loss), [np.asarray(g) for g in
                                   jax.tree.leaves(grads)])
    return out


@pytest.mark.parametrize("name", IDS)
def test_ranks_are_byte_equal(gang, name):
    """Both ranks report the gang's loss and the same global gradients,
    byte for byte, and hold at most ``2P - 1`` stage inputs."""
    (l0, g0, live0), (l1, g1, live1) = gang[0][name], gang[1][name]
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1) == 3
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert max(live0, live1) <= 3


@pytest.mark.parametrize("name,case", list(zip(IDS, CASES)), ids=IDS)
def test_gang_matches_one_process(gang, name, case):
    """The gang equals one process's ``data=2·dl × pipeline=2`` call on
    the whole batch: to the bit at one coordinate a rank, within 1e-6 of
    each leaf's max |g| at two."""
    loss, grads, _ = gang[0][name]
    want_loss, want, live = _one_process(*case)
    assert live <= 3
    if case[0] == 1:
        assert torch.equal(loss, want_loss)
        for a, b in zip(grads, want):
            assert torch.equal(a, b)
        return
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for a, b in zip(grads, want):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.parametrize("name", IDS)
def test_gang_matches_jax(gang, jax_runs, name):
    """The gang against JAX's jitted ``train_1f1b`` on the same global
    mesh: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6."""
    loss, grads, _ = gang[0][name]
    want_loss, want = jax_runs[name]
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6)
