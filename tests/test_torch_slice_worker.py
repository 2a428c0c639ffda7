"""The port's multi-process training — the gang env, the multislice
layout, two ``gloo`` processes training one mesh, and the
``slice-worker`` entry's fault and gang restart — against the JAX
package's, on the CPU.

Every subprocess runs with a timeout and one thread (the ranks share
this host's cores); a port comes from binding port 0 on ``127.0.0.1``.
Tolerances: the ranks' parameters byte-equal each other after every
step; two processes of ``data`` within 1e-6 of one process whose mesh
has the same axes (the gang sums the same gradients in another order);
a restarted gang's last checkpoint within 1e-6 of an uninterrupted
gang's. JAX's own gang test (``test_slice_worker_multiprocess.py``)
stays ``slow``; this file is not.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from kubeflow_tpu.compute import mesh as j_mesh
from kubeflow_tpu.compute import telemetry as j_tel
from kubeflow_tpu_torch.compute import mesh as t_mesh
from kubeflow_tpu_torch.compute import telemetry as t_tel
from kubeflow_tpu_torch.obs import goodput as t_goodput

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for name in ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
                 "JAX_COORDINATOR_ADDRESS", "SLICE_WORKER_FAULT_AT_STEP",
                 "SLICE_WORKER_FAULT_WORKER"):
        env.pop(name, None)
    env.update(extra)
    return env


# --------------------------------------------------------- the gang env

@pytest.mark.parametrize("env", [
    {},
    {"TPU_WORKER_ID": "1"},
    {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "h0, h1 ,h2"},
    {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "a,b",
     "JAX_COORDINATOR_ADDRESS": "a.svc:9000"},
    {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": ""}],
    ids=["none", "no-hosts", "default-port", "coordinator", "empty"])
def test_distributed_env_matches_jax(monkeypatch, env):
    for name in ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
                 "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert t_mesh.distributed_env() == j_mesh.distributed_env()
    if not env.get("TPU_WORKER_HOSTNAMES"):
        assert t_mesh.initialize_distributed(device="cpu") is False


def test_backend_rule():
    assert t_mesh.gang_backend("cpu", 2) == "gloo"
    assert t_mesh.gang_backend("cuda:0", 2) == "gloo"   # ranks share it
    assert t_mesh.gang_backend(None, 2) == (
        "nccl" if torch.cuda.device_count() >= 2 else "gloo")
    assert t_mesh.process_device("cpu", 1, 2) == torch.device("cpu")


# ---------------------------------------------------- multislice layout

class FakeDev:
    def __init__(self, i, slice_index):
        self.id = i
        self.slice_index = slice_index


def _ids(groups):
    return [[(d.id, d.slice_index) for d in g] for g in groups]


def test_device_slice_groups_match_jax():
    devs = [FakeDev(i, i // 4) for i in range(8)]
    for order in (devs, devs[::-1], devs[3::2] + devs[::2] + devs[1:3:2]):
        assert _ids(t_mesh.device_slice_groups(order)) == _ids(
            j_mesh.device_slice_groups(order))
    for bad in (devs[:6], devs[:5]):
        with pytest.raises(ValueError, match="rectangular"):
            j_mesh.device_slice_groups(bad)
        with pytest.raises(ValueError, match="rectangular"):
            t_mesh.device_slice_groups(bad)
    # a torch.device has no slice_index: one group, order kept
    cpus = [torch.device("cpu")] * 4
    assert t_mesh.device_slice_groups(cpus) == [cpus]


@pytest.mark.parametrize("inner", [dict(fsdp=2, tensor=2), dict(tensor=2),
                                   dict(expert=2, sequence=2), {},
                                   dict(fsdp=8), dict(tensor=0)],
                         ids=["fsdp2-tp2", "tp2", "ep2-sp2", "none",
                              "too-big", "zero"])
def test_multislice_layout_matches_jax(inner):
    groups = j_mesh.device_slice_groups(
        [FakeDev(i, i // 4) for i in range(8)])
    try:
        j_ordered, j_spec = j_mesh.multislice_layout(groups, **inner)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:30]):
            t_mesh.multislice_layout(groups, **inner)
        return
    t_ordered, t_spec = t_mesh.multislice_layout(groups, **inner)
    assert [d.id for d in t_ordered] == [d.id for d in j_ordered]
    assert t_spec.resolved(8) == j_spec.resolved(8)
    mesh = t_mesh.make_multislice_mesh(devices=["cpu"] * 8, **inner)
    assert mesh.shape == j_spec.resolved(8)


def test_process_mesh_keeps_non_data_axes_inside_a_process(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    mesh = t_mesh.make_mesh(t_mesh.MeshSpec(data=-1, fsdp=2),
                            devices=["cpu"] * 2, group="gang")
    assert mesh.shape["data"] == 1 and mesh.shape["fsdp"] == 2
    assert mesh.global_shape["data"] == 2 and mesh.process_index == 1
    with pytest.raises(ValueError, match="only the data axis may span "
                                         "processes.*'fsdp': 4"):
        t_mesh.make_mesh(t_mesh.MeshSpec(fsdp=4), devices=["cpu"] * 2,
                         group="gang")


# ------------------------------------------------------------ telemetry

def test_checkpoint_books_goodput_as_jax():
    j = j_tel.TrainTelemetry("sw-ckpt", gang="tns/sw", resumed=True)
    t = t_tel.TrainTelemetry("sw-ckpt", gang="tns/sw", resumed=True)
    for tel in (j, t):
        tel.step()
        tel.checkpoint(0.25)
        tel.checkpoint(0.5)
    assert t_goodput.GOODPUT.value("tns/sw", "checkpoint") == \
        pytest.approx(j_tel.GOODPUT.value("tns/sw", "checkpoint")) == \
        pytest.approx(0.75)
    assert t_goodput.GOODPUT.value("tns/sw", "restart") >= 0
    # the save restarts the step mark: the next step is not the save's
    mark = t._mark
    t.checkpoint(0.1)
    assert t._mark >= mark


# ------------------------------------------- two processes, one mesh

_RANK = textwrap.dedent('''
    import functools, sys
    import numpy as np, torch, torch.distributed as dist
    from kubeflow_tpu_torch.compute import mesh as M, train as T
    from kubeflow_tpu_torch.compute.models import transformer as tt
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                            world_size=2, rank=rank)
    result = {}
    for name, kw, axes in (("dense", {}, {}),
                           ("moe", dict(moe_experts=4, moe_top_k=2,
                                        moe_dropless=True), {"expert": 2})):
        cfg = tt.Config(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                        max_seq=16, dtype="float32", attention="dense",
                        **kw)
        mesh = M.make_mesh(M.MeshSpec(data=-1, **axes),
                           devices=["cpu"] * 2, group=dist.group.WORLD)
        opt = T.make_optimizer(3e-3, warmup_steps=1, total_steps=10)
        state = T.init_state(functools.partial(tt.init_params, cfg), opt,
                             mesh=mesh, logical_axes=tt.logical_axes(cfg),
                             generator=torch.Generator().manual_seed(0))
        step = T.make_train_step(T.plain_loss(tt.loss_fn, cfg), opt, mesh)
        steps = []
        for i in range(3):
            toks = np.random.default_rng(1000 + i).integers(
                0, 256, (8, 16), dtype=np.int32)
            mine = toks[rank * 4:(rank + 1) * 4]
            state, m = step(state, {"tokens": mine,
                                    "targets": np.roll(mine, -1, 1)})
            steps.append(({k: float(v) for k, v in m.items()},
                          T.tree_leaves(T.gather_params(state))))
        result[name] = steps
    torch.save(result, out)
    dist.destroy_process_group()
''')


def _one_process(name):
    import functools

    from kubeflow_tpu_torch.compute import train as T
    from kubeflow_tpu_torch.compute.models import transformer as tt
    kw, axes = ({}, dict(data=4)) if name == "dense" else (
        dict(moe_experts=4, moe_top_k=2, moe_dropless=True),
        dict(data=2, expert=2))
    cfg = tt.Config(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    max_seq=16, dtype="float32", attention="dense", **kw)
    mesh = t_mesh.make_mesh(devices=["cpu"] * 4, **axes)
    opt = T.make_optimizer(3e-3, warmup_steps=1, total_steps=10)
    state = T.init_state(functools.partial(tt.init_params, cfg), opt,
                         mesh=mesh, logical_axes=tt.logical_axes(cfg),
                         generator=torch.Generator().manual_seed(0))
    step = T.make_train_step(T.plain_loss(tt.loss_fn, cfg), opt, mesh)
    steps = []
    for i in range(3):
        toks = np.random.default_rng(1000 + i).integers(0, 256, (8, 16),
                                                        dtype=np.int32)
        state, m = step(state, {"tokens": toks,
                                "targets": np.roll(toks, -1, 1)})
        steps.append(({k: float(v) for k, v in m.items()},
                      T.tree_leaves(T.gather_params(state))))
    return steps


def test_two_gloo_processes_train_one_mesh(tmp_path):
    """Two ranks, each ``["cpu"] * 2``: the dense slice-worker config on
    ``data`` = 2 × 2 and an MoE with ``expert=2`` inside each rank
    (``data`` = 2 across them), 3 steps. The ranks' params are
    byte-equal after every step, their metrics the gang's, and both
    within 1e-6 of one process on the same axes (data=4; data=2,
    expert=2) fed the same global batches."""
    port = str(_free_port())
    outs = [tmp_path / f"rank{r}.pt" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port,
                               str(outs[r])], env=_env(),
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
    ranks = [torch.load(o, weights_only=False) for o in outs]
    for name in ("dense", "moe"):
        want = _one_process(name)
        for (m0, p0), (m1, p1), (mw, pw) in zip(ranks[0][name],
                                                ranks[1][name], want):
            assert m0 == m1
            for a, b, w in zip(p0, p1, pw):
                assert torch.equal(a, b)
                np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0,
                                           atol=1e-6)
            for k in mw:
                np.testing.assert_allclose(m0[k], mw[k], rtol=1e-6,
                                           err_msg=f"{name} {k}")
        assert "moe_aux" in ranks[0]["moe"][0][0]


# ------------------------------------------------- the slice-worker CLI

def _gang(ckpt, tmp_path, tag, steps=5, **env):
    """Start a gang of 2 ``slice-worker`` processes → the processes."""
    port = _free_port()
    procs = []
    for w in range(2):
        with open(tmp_path / f"{tag}.w{w}.err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kubeflow_tpu_torch.cmd",
                 "slice-worker", "--ckpt-dir", str(ckpt), "--steps",
                 str(steps), "--ckpt-every", "2", "--seq", "16",
                 "--log", str(tmp_path / f"{tag}.w{w}.jsonl")],
                env=_env(TPU_WORKER_ID=str(w),
                         TPU_WORKER_HOSTNAMES="127.0.0.1,127.0.0.1",
                         JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                         SLICE_WORKER_DEVICE="cpu", **env),
                stdout=subprocess.DEVNULL, stderr=err))
    return procs


def _events(tmp_path, tag, w):
    path = tmp_path / f"{tag}.w{w}.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _finish(procs):
    try:
        return [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()


def _final(ckpt):
    steps = sorted(int(n) for n in os.listdir(ckpt) if n.isdigit())
    saved = torch.load(os.path.join(ckpt, str(steps[-1]), "state.pt"),
                       weights_only=True)
    return steps[-1], saved


def test_slice_worker_gang_restart_resumes_and_matches(tmp_path):
    """Worker 1 dies with exit 17 before step 3; the controller's gang
    restart (here: the test kills worker 0, stuck in the step's
    all_reduce, and starts both again) resumes from the last durable
    step, 2, and finishes; its last checkpoint equals an uninterrupted
    gang's within 1e-6."""
    clean = _gang(tmp_path / "clean", tmp_path, "clean")
    faulty = _gang(tmp_path / "ckpt", tmp_path, "run1",
                   SLICE_WORKER_FAULT_AT_STEP="3",
                   SLICE_WORKER_FAULT_WORKER="1")
    try:
        assert faulty[1].wait(timeout=TIMEOUT_S) == 17
    finally:
        for p in faulty:
            p.kill()
            p.wait()
    assert [e["event"] for e in _events(tmp_path, "run1", 1)][-1] == \
        "fault-injected"
    joined = [e for e in _events(tmp_path, "run1", 0)
              if e["event"] == "joined"]
    assert joined[0]["processes"] == 2 and not joined[0]["resumed"]
    assert joined[0]["backend"] == "gloo"
    assert joined[0]["mesh"].startswith("{'data': 2, 'pipeline': 1")
    restarted = _gang(tmp_path / "ckpt", tmp_path, "run2",
                      SLICE_WORKER_FAULT_AT_STEP="3",
                      SLICE_WORKER_FAULT_WORKER="1")
    assert _finish(restarted) == [0, 0]
    assert _finish(clean) == [0, 0]
    for w in range(2):
        ev = _events(tmp_path, "run2", w)
        assert ev[0]["event"] == "joined" and ev[0]["resumed"] is True
        assert ev[0]["start_step"] == 2
        assert ev[-1] == {**ev[-1], "event": "done", "step": 5}
        assert not any(e["event"] == "fault-injected" for e in ev)
    steps = [_events(tmp_path, "run2", w) for w in range(2)]
    assert [e.get("loss") for e in steps[0]] == \
        [e.get("loss") for e in steps[1]]
    step, got = _final(tmp_path / "ckpt")
    clean_step, want = _final(tmp_path / "clean")
    assert step == clean_step == 5
    from kubeflow_tpu_torch.compute.train import tree_leaves
    for a, b in zip(tree_leaves([got["params"], got["opt_state"]]),
                    tree_leaves([want["params"], want["opt_state"]])):
        if torch.is_tensor(a):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)
        else:
            assert a == b
