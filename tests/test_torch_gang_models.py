"""BERT, the MLP and ResNet trained on a ``data`` mesh across two
processes, against JAX's jitted train step and the port's one-process
mesh on the same inputs.

One pair of ``gloo`` ranks (each ``["cpu"] * 2``, ``data=2`` inside it,
``data=4`` over the gang) trains the MLP, a narrow BERT (2 layers,
dense attention) and ResNet-18 (fp32, width 8, 32² images, every batch
norm's scale and bias drawn at random so every block's branch is live)
for 3 steps on fixed global batches, each rank fed its half. JAX's
``make_train_step`` on a ``data=4`` mesh of its CPU devices, and the
port on one process's ``data=4``, take the same steps on the whole
batches from the same weights (the port's seeded init, to JAX through
numpy).

The gang sums its loss terms with ``mesh.global_sum`` and ResNet's
batch-norm moments with ``mesh.global_sum_synced``, whose backward sums
the moments' gradients over the ranks: without it a rank's gradient
would miss the other rank's terms through the shared moments.

Tolerances: the ranks byte-equal each other after every step; their
losses, metrics and ResNet's running statistics within rtol 1e-6 of one
process's (ResNet's loss 1e-5) and 1e-5 of JAX's, the statistics of
each leaf's max |value|; the MLP's and BERT's params within 1e-6
absolute, ResNet's within 1e-6 of each leaf's max |value|, with the
Adam-noise allowances that ``_assert_steps_close`` states. The gang
sums the same terms in another order, nothing else.

The rank children import this file (no JAX) and run with one thread and
a timeout.
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.compute import mesh as t_mesh
from kubeflow_tpu_torch.compute import train as t_train
from kubeflow_tpu_torch.compute.models import bert as tb
from kubeflow_tpu_torch.compute.models import mlp as tm
from kubeflow_tpu_torch.compute.models import resnet as tr
from kubeflow_tpu_torch.compute.params import params_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180
STEPS, ROWS, LR = 3, 8, 1e-3
MODELS = ("mlp", "bert", "resnet")


def _bn_randomised(params, seed):
    """ResNet ``params`` with every batch norm's scale and bias drawn
    from ``seed`` (the init's zero scales would leave each block's
    branch dead on the first step)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if "scale" in tree and "bias" in tree:
            n = tree["scale"].shape[0]
            return {"scale": torch.from_numpy(
                        (1 + 0.3 * rng.standard_normal(n)).astype(np.float32)),
                    "bias": torch.from_numpy(
                        (0.1 * rng.standard_normal(n)).astype(np.float32))}
        return {k: walk(v) if isinstance(v, (dict, list)) else v
                for k, v in tree.items()}

    return walk(params)


def _case(name):
    """``name`` → ``(cfg, loss, init_fn, logical_axes, extra, batches)``:
    the model's config, train loss, seeded init, layout, mutable state
    and ``STEPS`` global batches of ``ROWS`` rows."""
    if name == "mlp":
        cfg = tm.Config(in_dim=32, hidden=32, n_classes=8)
        batches = []
        for i in range(STEPS):
            x = np.random.default_rng(10 + i).standard_normal(
                (ROWS, 32)).astype(np.float32)
            batches.append({"image": x,
                            "label": (np.abs(x[:, :8]).argmax(-1)
                                      ).astype(np.int32)})
        return (cfg, t_train.plain_loss(tm.loss_fn, cfg),
                functools.partial(tm.init_params, cfg),
                tm.logical_axes(cfg), None, batches)
    if name == "bert":
        cfg = tb.Config(vocab_size=256, d_model=32, n_layers=2, n_heads=2,
                        d_ff=64, max_seq=16, dtype="float32",
                        attention="dense", remat=False)
        rng = np.random.default_rng(20)
        return (cfg, t_train.plain_loss(tb.loss_fn, cfg),
                functools.partial(tb.init_params, cfg),
                tb.logical_axes(cfg), None,
                [tb.mlm_batch(rng, ROWS, cfg) for _ in range(STEPS)])
    cfg = tr.Config(depth=18, n_classes=4, width=8, dtype="float32")
    params, stats = tr.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    params = _bn_randomised(params, 30)
    batches = []
    for i in range(STEPS):
        x = np.random.default_rng(40 + i).standard_normal(
            (ROWS, 32, 32, 3)).astype(np.float32)
        batches.append({"image": x,
                        "label": np.arange(ROWS, dtype=np.int32) % 4})
    return (cfg, t_train.stateful_loss(tr.loss_fn, cfg),
            lambda g, device: t_train.tree_map(torch.clone, params),
            tr.logical_axes(cfg)[0], stats, batches)


def train_on(mesh, rows):
    """Each model's ``STEPS`` steps on ``mesh``, fed rows ``rows`` (a
    slice) of every global batch → ``{model: [(metrics, params leaves,
    statistics leaves), ...]}``, one entry a step."""
    out = {}
    for name in MODELS:
        _, loss, init_fn, axes, extra, batches = _case(name)
        opt = t_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
        state = t_train.init_state(
            init_fn, opt, mesh=mesh, logical_axes=axes,
            generator=torch.Generator().manual_seed(0),
            extra=None if extra is None else t_train.tree_map(torch.clone,
                                                             extra))
        step = t_train.make_train_step(loss, opt, mesh)
        steps = []
        for batch in batches:
            state, m = step(state, {k: v[rows] for k, v in batch.items()})
            steps.append((
                {k: float(v) for k, v in m.items()},
                t_train.tree_leaves(t_train.gather_params(state)),
                [t.gather("cpu") for t in t_train.tree_leaves(state.extra)]))
        out[name] = steps
    return out


def synced_sums(mesh, rank):
    """``global_sum_synced`` and ``global_sum`` of ``(rank + 1)·[1, 2]``
    on ``mesh``, each weighted by ``[rank + 1, 3]`` and differentiated
    → ``{kind: (total, this rank's gradient)}``."""
    out = {}
    for kind, fn in (("synced", t_mesh.global_sum_synced),
                     ("plain", t_mesh.global_sum)):
        t = (torch.tensor([1.0, 2.0]) * (rank + 1)).requires_grad_()
        total = fn(t, mesh)
        (total * torch.tensor([rank + 1.0, 3.0])).sum().backward()
        out[kind] = (total.detach(), t.grad)
    return out


_RANK = textwrap.dedent('''
    import sys
    import torch, torch.distributed as dist
    import test_torch_gang_models as G
    from kubeflow_tpu_torch.compute import mesh as M
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                            world_size=2, rank=rank)
    mesh = M.make_mesh(M.MeshSpec(data=-1), devices=["cpu"] * 2,
                       group=dist.group.WORLD)
    half = G.ROWS // 2
    result = G.train_on(mesh, slice(rank * half, (rank + 1) * half))
    result["sums"] = G.synced_sums(
        M.make_mesh(M.MeshSpec(data=-1), devices=["cpu"],
                    group=dist.group.WORLD), rank)
    torch.save(result, out)
    dist.destroy_process_group()
''')


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The two ranks' results of one subprocess pair."""
    tmp = tmp_path_factory.mktemp("gang")
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


@pytest.fixture(scope="module")
def one_process():
    return train_on(t_mesh.make_mesh(data=4, devices=["cpu"] * 4),
                    slice(None))


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's jitted train step on a ``data=4`` mesh of its CPU devices,
    from the port's init (through numpy) on the same global batches →
    ``train_on``'s ``{model: [(metrics, params, statistics), ...]}``
    with numpy leaves in the same order. JAX is imported here alone: the
    rank children import this file."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.compute import mesh as j_mesh
    from kubeflow_tpu.compute import train as j_train
    from kubeflow_tpu.compute.models import bert as jb
    from kubeflow_tpu.compute.models import mlp as jm
    from kubeflow_tpu.compute.models import resnet as jr

    jmesh = j_mesh.make_mesh(devices=jax.devices()[:4], data=4)
    out = {}
    for name, jmod in (("mlp", jm), ("bert", jb), ("resnet", jr)):
        cfg, _, init_fn, axes, extra, batches = _case(name)
        jcfg = jmod.Config(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(jmod.Config)})
        params = params_to_numpy(init_fn(torch.Generator().manual_seed(0),
                                         device="cpu"))
        wrap = (j_train.plain_loss if extra is None
                else j_train.stateful_loss)
        opt = j_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
        state = j_train.init_state(
            lambda k: jax.tree.map(jnp.asarray, params), opt, jmesh, axes,
            jax.random.PRNGKey(0),
            extra=None if extra is None else jax.tree.map(
                jnp.asarray, params_to_numpy(extra)))
        step = j_train.make_train_step(wrap(jmod.loss_fn, jcfg), opt, jmesh)
        steps = []
        for batch in batches:
            state, m = step(state, jax.tree.map(jnp.asarray, batch))
            steps.append(({k: float(v) for k, v in m.items()},
                          [torch.from_numpy(np.array(x)) for x in
                           jax.tree.leaves(state.params)],
                          [torch.from_numpy(np.array(x)) for x in
                           jax.tree.leaves(state.extra)]))
        out[name] = steps
    return out


@pytest.mark.parametrize("name", MODELS)
def test_ranks_stay_byte_equal(gang, name):
    """After every step both ranks hold the same params and statistics
    and report the same (the gang's) metrics."""
    for (m0, p0, s0), (m1, p1, s1) in zip(gang[0][name], gang[1][name]):
        assert m0 == m1
        for a, b in zip(p0 + s0, p1 + s1):
            assert torch.equal(a, b)


#: where a metric may differ more than 1e-6 from one process's:
#: ResNet-18's fp32 loss after 20 batch norms whose moments are summed
#: in another order (1.4e-6)
METRIC_RTOL = {("resnet", "loss"): 1e-5}
#: leaves whose gradient is zero analytically (BERT's key bias), so that
#: Adam steps their rounding noise by up to lr on either side; held to
#: the steps' size, as ``test_torch_train_mesh.py`` holds them
NOISE = {"bert": ("bk",)}


def _names(tree, path=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _names(v, f"{path}/{i}")]
    return [path]


def _assert_steps_close(name, got, want, rtol):
    """Each step's metrics within ``rtol`` (or ``METRIC_RTOL``'s entry)
    of ``want``'s and ResNet's running statistics within ``rtol`` of
    each leaf's max |value|; params within 1e-6: the MLP's and BERT's
    absolute (BERT's key bias within the steps' 2·lr), ResNet's of each
    leaf's max |value| on at least 99.9 % of the elements and within
    the steps' 2·lr everywhere (Adam's first moves are ±lr on a
    gradient of rounding noise)."""
    _, _, init_fn, _, _, _ = _case(name)
    names = _names(init_fn(torch.Generator().manual_seed(0), device="cpu"))
    steps_size = 2 * LR * (STEPS - 1)
    assert len(got) == len(want) == STEPS
    for (m, p, s), (mw, pw, sw) in zip(got, want):
        assert m.keys() == mw.keys()
        for k in mw:
            np.testing.assert_allclose(
                m[k], mw[k],
                rtol=max(rtol, METRIC_RTOL.get((name, k), 0)),
                err_msg=f"{name} {k}")
        assert len(p) == len(pw) == len(names) and len(s) == len(sw)
        over, total = 0, 0
        for n, a, w in zip(names, p, pw):
            assert a.shape == w.shape, n
            d = (a - w).abs()
            if name != "resnet":
                noise = any(k in n for k in NOISE.get(name, ()))
                assert float(d.max()) <= (steps_size if noise else 1e-6), n
                continue
            assert float(d.max()) <= steps_size, n
            over += int((d > 1e-6 * float(w.abs().max())).sum())
            total += d.numel()
        assert over <= 1e-3 * total
        for a, w in zip(s, sw):
            assert float((a - w).abs().max()) <= rtol * float(w.abs().max())


@pytest.mark.parametrize("name", MODELS)
def test_gang_matches_one_process(gang, one_process, name):
    """Each step of the gang within rtol 1e-6 of one process on
    ``data=4`` in its metrics (ResNet's loss 1e-5) and statistics, with
    ``_assert_steps_close``'s rule on params. With
    ``global_sum`` in the batch norm's place the gang's ResNet gradient
    norm is 22 % low and the check fails."""
    _assert_steps_close(name, gang[0][name], one_process[name], 1e-6)


@pytest.mark.parametrize("name", MODELS)
def test_gang_matches_jax(gang, jax_steps, name):
    """Each step of the gang against JAX's jitted step on its own
    ``data=4`` mesh: metrics within rtol 1e-5 (fp32 sums in another
    order, as ``test_torch_train_mesh.py`` holds them) and ResNet's
    statistics within 1e-5 of each leaf's max |value| (JAX's variance is
    not the port's one-pass fp32 one: 1.4e-6 measured after the first
    step), ``_assert_steps_close``'s rule on params. ResNet's gradient
    reaches every rank's rows through the synced moments in both."""
    _assert_steps_close(name, gang[0][name], jax_steps[name], 1e-5)


def test_synced_sum_backward_sums_over_the_ranks(gang):
    """``global_sum_synced``'s gradient on each rank is the sum of every
    rank's weights (the psum's transpose); ``global_sum``'s is the
    rank's own. Both forwards are the gang's total."""
    for rank in range(2):
        sums = gang[rank]["sums"]
        for kind in ("synced", "plain"):
            assert torch.equal(sums[kind][0], torch.tensor([3.0, 6.0]))
        assert torch.equal(sums["synced"][1], torch.tensor([3.0, 6.0]))
        assert torch.equal(sums["plain"][1],
                           torch.tensor([rank + 1.0, 3.0]))


def test_synced_sum_is_the_identity_on_one_process():
    mesh = t_mesh.make_mesh(data=2, devices=["cpu"] * 2)
    t = torch.ones(3, requires_grad=True)
    assert t_mesh.global_sum_synced(t, mesh) is t
