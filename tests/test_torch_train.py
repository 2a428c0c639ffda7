"""The port's training slice against the JAX package's.

Weights come from JAX ``init_params`` and cross through numpy
(``params_from_jax``); batches are ``synthetic_lm`` numpy from a seed.
The tiny flagship shape: vocab 128, d_model 64, 2 layers, 4 query over
2 kv heads, S 32, fp32, flash attention (JAX: Pallas in interpret mode
on a 1-device CPU mesh; the port: the plain versions of K3/K4/K5 that
its autograd Function runs on CPU tensors).

Tolerances, with their reasons:

- loss, accuracy, perplexity and grad_norm: rtol 1e-5 (fp32 reduction
  order only);
- every gradient leaf: max |Δ| ≤ 1e-5 × that leaf's max |g| (the same);
- params after 3 optimizer steps: atol 1e-6 on all but a few elements.
  Adam divides the moment by its root: where a gradient element is
  near zero, the two frameworks' last-bit differences can give it
  opposite signs and the update then moves it by ±lr·|u| (|u| ≤ 1)
  the other way. So each element must agree within 1e-6, or within
  2·lr per nonzero-rate update if it is one of at most 0.1 % of the
  elements (the first update has rate 0 under warmup);
- the chunked cross-entropy: 1e-5 (values) and 1e-5 relative (grads).
"""

import functools
import importlib
import threading
import time

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.compute import mesh as j_mesh
from kubeflow_tpu.compute import train as j_train
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import checkpoint as t_ckpt
from kubeflow_tpu_torch.compute import data as t_data
from kubeflow_tpu_torch.compute import profiler as t_prof
from kubeflow_tpu_torch.compute import telemetry as t_tel
from kubeflow_tpu_torch.compute import train as t_train
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.ops import cross_entropy as t_xent
from kubeflow_tpu_torch.compute.params import (params_from_jax,
                                               params_to_numpy)

j_xent = importlib.import_module("kubeflow_tpu.compute.ops.cross_entropy")

LR = 1e-3


def _jcfg(**kw):
    base = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, max_seq=32, dtype="float32",
                attention="flash", remat=False, scan_layers=True)
    base.update(kw)
    return jt.Config(**base)


def _tcfg(jcfg, **kw):
    import dataclasses
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tt.Config)}
    fields.update(kw)
    return tt.Config(**fields)


@pytest.fixture(scope="module")
def jparams():
    return jt.init_params(_jcfg(), jax.random.PRNGKey(0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(accum=1, seed=1):
    b = next(t_data.synthetic_lm(4, 32, 128, seed=seed))
    if accum > 1:
        b = {k: v.reshape(accum, 4 // accum, 32) for k, v in b.items()}
    return b


def _t_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _t_state(jparams, opt):
    return t_train.init_state(
        lambda g, device: params_from_jax(_np(jparams), device=device),
        opt, device="cpu")


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _t_flat(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": t.detach().numpy() for n, t in v.items()})
        else:
            out[k] = v.detach().numpy()
    return out


def _assert_leaves_close(got, want, rel):
    assert got.keys() == want.keys()
    for name in want:
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(got[name] - want[name]).max())
        assert err <= rel * scale, f"{name}: max |Δ| {err}, max |g| {scale}"


# ------------------------------------------------------- loss and grads

@pytest.mark.parametrize("chunked", [False, True])
def test_loss_metrics_and_grads_match_jax(jparams, chunked):
    jcfg = _jcfg(chunked_ce=chunked, ce_chunk=32)
    batch = _batch()
    batch["mask"] = (np.arange(32)[None, :] < 28).repeat(4, 0).astype(
        np.float32)
    jloss = j_train.plain_loss(jt.loss_fn, jcfg)
    (jl, (jm, _)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jparams, {}, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(_np(jparams), device="cpu")
    for t in t_train.tree_leaves(params):
        t.requires_grad_(True)
    tl, tm = tt.loss_fn(params, _t_batch(batch), _tcfg(jcfg))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in ("loss", "accuracy", "perplexity"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    grads = {k: (({n: t.grad for n, t in v.items()})
                 if isinstance(v, dict) else v.grad)
             for k, v in params.items()}
    _assert_leaves_close(_t_flat(grads), _flat(jg), 1e-5)


def test_remat_gives_the_same_gradients(jparams):
    batch = _t_batch(_batch())
    grads = []
    for remat in (False, True):
        params = params_from_jax(_np(jparams), device="cpu")
        leaves = t_train.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = tt.loss_fn(params, batch, _tcfg(_jcfg(), remat=remat))
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_config_accepts_remat_and_defaults_to_it():
    assert tt.Config().remat is True
    assert tt.Config(remat=False).remat is False


def test_flops_and_param_count_match_jax():
    for kw in ({}, dict(n_kv_heads=4, d_ff=96), dict(vocab_size=32768,
                                                       d_model=1024,
                                                       n_layers=12,
                                                       n_heads=8,
                                                       n_kv_heads=2,
                                                       max_seq=1024)):
        jcfg = _jcfg(**kw)
        assert tt.flops_per_token(_tcfg(jcfg)) == jt.flops_per_token(jcfg)
        assert tt.param_count(_tcfg(jcfg)) == jt.param_count(jcfg)


# ------------------------------------------------------------ the step

def _run_jax(jparams, accum, steps, batch):
    jcfg = _jcfg()
    mesh = j_mesh.make_mesh(devices=jax.devices()[:1])
    opt = j_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
    state = j_train.init_state(lambda k: jparams, opt, mesh,
                               jt.logical_axes(jcfg), jax.random.PRNGKey(0))
    step = j_train.make_train_step(j_train.plain_loss(jt.loss_fn, jcfg),
                                   opt, mesh, accum_steps=accum)
    history = []
    for _ in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        history.append({k: float(v) for k, v in m.items()})
    return state, history


def _run_port(jparams, accum, steps, batch):
    opt = t_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
    state = _t_state(jparams, opt)
    step = t_train.make_train_step(t_train.plain_loss(tt.loss_fn,
                                                      _tcfg(_jcfg())),
                                   opt, accum_steps=accum)
    history = []
    for _ in range(steps):
        state, m = step(state, _t_batch(batch))
        history.append({k: float(v) for k, v in m.items()})
    return state, history


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(jparams, accum):
    batch = _batch(accum)
    jstate, jhist = _run_jax(jparams, accum, 3, batch)
    tstate, thist = _run_port(jparams, accum, 3, batch)
    assert tstate.step == int(jstate.step) == 3
    assert tstate.opt_state["count"] == 3
    for t, j in zip(thist, jhist):
        assert t.keys() == j.keys()
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)
    # the first update has rate 0: losses 1 and 2 are the same
    np.testing.assert_allclose(thist[0]["loss"], thist[1]["loss"],
                               rtol=1e-6)
    got = _t_flat(tstate.params)
    want = _flat(jstate.params)
    flips_allowed = 2 * LR * 2      # two updates at a nonzero rate
    for name in want:
        d = np.abs(got[name] - want[name])
        assert d.max() <= flips_allowed, name
        assert (d > 1e-6).mean() <= 1e-3, name


def test_first_update_has_rate_zero_and_grad_norm_is_pre_clip(jparams):
    opt = t_train.make_optimizer(LR, warmup_steps=1, total_steps=10,
                                 clip_norm=1e-3)
    state = _t_state(jparams, opt)
    before = _t_flat(state.params)
    step = t_train.make_train_step(
        t_train.plain_loss(tt.loss_fn, _tcfg(_jcfg())), opt)
    state, m = step(state, _t_batch(_batch()))
    assert float(m["grad_norm"]) > 1e-3          # the norm before clipping
    for name, v in _t_flat(state.params).items():
        np.testing.assert_array_equal(v, before[name])


def test_warmup_cosine_matches_optax():
    for peak, warmup, total in ((3e-4, 5, 20), (1e-3, 1, 10),
                                (2e-3, 0, 8)):
        want = j_train.warmup_cosine(peak, warmup, total)
        got = t_train.warmup_cosine(peak, warmup, total)
        # optax evaluates the schedule in fp32, the port in double
        for count in range(total + 4):
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(3, 5)).astype(np.float32) * scale,
            "b": rng.normal(size=(7,)).astype(np.float32) * scale}
    clip = optax.clip_by_global_norm(1.0)
    want, _ = clip.update(jax.tree.map(jnp.asarray, tree),
                          clip.init(tree))
    got, norm = t_train.clip_by_global_norm(
        [torch.from_numpy(tree[k]) for k in ("a", "b")], 1.0)
    np.testing.assert_allclose(float(norm),
                               float(optax.global_norm(tree)), rtol=1e-6)
    for g, k in zip(got, ("a", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_softmax_xent_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    head = (rng.normal(size=(32, 40)) * 0.3).astype(np.float32)
    targets = rng.integers(0, 40, (2, 6)).astype(np.int32)
    jx, jh = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, head))

    def jloss(x, h):
        nll, logz, _ = j_xent.chunked_softmax_xent(x, h, jnp.asarray(
            targets), 8)
        return (nll + 1e-4 * logz ** 2).mean()

    (jn, jz, jp) = j_xent.chunked_softmax_xent(jx, jh, jnp.asarray(targets),
                                               8)
    jgx, jgh = jax.grad(jloss, argnums=(0, 1))(jx, jh)
    tx, th = (torch.from_numpy(a).to(getattr(torch, dtype))
              .requires_grad_() for a in (x, head))
    nll, logz, pred = t_xent.chunked_softmax_xent(
        tx, th, torch.from_numpy(targets), 8)
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jn),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(logz.detach().numpy(), np.asarray(jz),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jp))
    (nll + 1e-4 * logz ** 2).mean().backward()
    for got, want in ((tx.grad, jgx), (th.grad, jgh)):
        assert got.dtype == getattr(torch, dtype)
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        rel = 1e-5 if dtype == "float32" else 1e-2
        assert err <= rel * np.abs(want).max()


# ------------------------------------------------------ loop machinery

def test_prefetcher_early_break_and_close():
    pulled = []

    def source():
        i = 0
        while True:
            pulled.append(i)
            yield {"x": np.full((2,), i, np.int32)}
            i += 1

    with t_data.Prefetcher(source(), "cpu", depth=2) as pf:
        got = [int(next(pf)["x"][0]) for _ in range(3)]
    assert got == [0, 1, 2]
    assert not pf._thread.is_alive()
    assert len(pulled) <= 3 + 2 + 2      # taken + queue depth + one put
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_surfaces_a_source_error():
    def source():
        yield {"x": np.zeros(1)}
        raise OSError("read failed")

    pf = t_data.Prefetcher(source(), "cpu")
    next(pf)
    with pytest.raises(OSError, match="read failed"):
        next(pf)
    pf.close()


def test_fit_stops_when_on_step_says_so(jparams):
    opt = t_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
    state = _t_state(jparams, opt)
    step = t_train.make_train_step(
        t_train.plain_loss(tt.loss_fn, _tcfg(_jcfg())), opt)
    seen = []
    before = threading.active_count()
    state, m = t_train.fit(state, step, t_data.synthetic_lm(4, 32, 128),
                           on_step=lambda n, m: seen.append(n) or n < 2)
    assert seen == [1, 2] and state.step == 2 and "loss" in m
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_checkpoint_restore_and_continue_equals_uninterrupted(jparams,
                                                              tmp_path):
    cfg = _tcfg(_jcfg())
    batches = list(t_data.synthetic_lm(4, 32, 128, seed=3, steps=4))

    def run(state, opt, bs):
        step = t_train.make_train_step(t_train.plain_loss(tt.loss_fn, cfg),
                                       opt)
        return t_train.fit(state, step, iter(bs))[0]

    opt = t_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
    straight = run(_t_state(jparams, opt), opt, batches)

    opt = t_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
    ckpt = t_ckpt.Checkpointer(tmp_path / "run", max_to_keep=2,
                               save_interval_steps=2)
    state = run(_t_state(jparams, opt), opt, batches[:2])
    assert ckpt.save(state)
    assert not ckpt.save(state)                  # not newer
    ckpt.wait()
    assert ckpt.all_steps() == [2]

    opt2 = t_train.make_optimizer(LR, warmup_steps=1, total_steps=10)
    ckpt2, fresh, resumed = t_ckpt.restore_or_init(
        tmp_path / "run", lambda: _t_state(jparams, opt2),
        max_to_keep=2, save_interval_steps=2)
    assert resumed and fresh.step == 2 and fresh.opt_state["count"] == 2
    assert all(t.requires_grad for t in t_train.tree_leaves(fresh.params))
    resumed_state = run(fresh, opt2, batches[2:])
    for name, v in _t_flat(straight.params).items():
        np.testing.assert_array_equal(_t_flat(resumed_state.params)[name], v)
    for s in (3, 4):
        resumed_state.step = s
        assert ckpt2.save(resumed_state) == (s % 2 == 0)
    ckpt2.save(resumed_state, force=False)
    ckpt2.close()
    assert ckpt2.all_steps() == [2, 4]
    resumed_state.step = 5
    assert ckpt2.save(resumed_state, force=True)
    ckpt2.close()
    assert ckpt2.all_steps() == [4, 5]           # max_to_keep=2


def test_params_to_numpy_round_trips(jparams):
    tree = _np(jparams)
    back = params_to_numpy(params_from_jax(tree, dtype=torch.bfloat16,
                                           device="cpu"))
    assert back.keys() == tree.keys()
    for k, v in tree["layers"].items():
        want = np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(back["layers"][k], want)
    # fp32 masters come back bit for bit, and JAX takes them as they are
    exact = params_to_numpy(params_from_jax(tree, device="cpu"))
    logits = jt.apply(jax.tree.map(jnp.asarray, exact),
                      jnp.zeros((1, 8), jnp.int32), _jcfg())
    np.testing.assert_array_equal(
        np.asarray(logits),
        np.asarray(jt.apply(jparams, jnp.zeros((1, 8), jnp.int32),
                            _jcfg())))


def test_eval_step_takes_no_gradient(jparams):
    opt = t_train.make_optimizer(LR)
    state = _t_state(jparams, opt)
    ev = t_train.make_eval_step(
        t_train.plain_loss(tt.loss_fn, _tcfg(_jcfg())))
    m = ev(state, _t_batch(_batch()))
    assert set(m) == {"loss", "accuracy", "perplexity"}
    assert not m["loss"].requires_grad


def test_telemetry_mfu_with_a_given_peak():
    tel = t_tel.TrainTelemetry("port-test-mfu", flops_per_step=2e12,
                               peak=1e14, ema=0.5)
    tel.step()                                   # start-up, not a step
    assert tel.ema_step is None
    tel.step(seconds=0.1)
    tel.step(seconds=0.3)
    assert tel.ema_step == pytest.approx(0.2)
    assert tel.live_mfu() == pytest.approx(2e12 / 0.2 / 1e14)
    assert t_tel.STEP_SECONDS.value("port-test-mfu") == 2


def test_peak_flops_names_the_card(monkeypatch):
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA H100 PCIe", 756e12),
                       ("NVIDIA H200", 989e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None, n=name: n)
        assert t_tel.peak_flops() == peak
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Some Other Card")
    with pytest.raises(ValueError, match="no bf16 peak"):
        t_tel.peak_flops()


def test_init_state_needs_a_device_without_cuda(jparams):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.init_state(functools.partial(tt.init_params,
                                             _tcfg(_jcfg())),
                           t_train.make_optimizer())


def test_profiler_refuses_nesting_and_stops_on_a_crash(tmp_path):
    with t_prof.trace(tmp_path) as cap:
        torch.ones(4).sum()
        with pytest.raises(t_prof.ProfilerActiveError):
            with t_prof.trace(tmp_path / "other"):
                pass
    assert cap.path.startswith(t_prof.trace_dir(str(tmp_path)))
    assert cap.path.endswith(".pt.trace.json")
    with pytest.raises(ZeroDivisionError):
        with t_prof.trace(tmp_path) as crashed:
            1 / 0
    assert crashed.path is not None          # written despite the raise
    with t_prof.trace(tmp_path) as cpu_only:  # the session was released
        torch.ones(4).sum()
    with pytest.raises(RuntimeError, match="no CUDA kernels"):
        t_prof.device_summary(cpu_only.profile, wall_ms=1.0)
    for name, group in (
            ("void (anonymous namespace)::flash_bwd_dkv_kernel<float, 64>",
             "K5 flash_bwd_dkv"),
            ("void (anonymous namespace)::flash_bwd_dkv_tc_kernel<128>",
             "K5 flash_bwd_dkv"),
            ("void (anonymous namespace)::flash_fwd_tc_kernel<64>",
             "K3 flash_fwd"),
            ("void (anonymous namespace)::flash_bwd_dq_tc_kernel<128>",
             "K4 flash_bwd_dq"),
            ("void (anonymous namespace)::gmm_dw_wgmma_kernel<true>",
             "K7 grouped_matmul_dw"),
            ("void (anonymous namespace)::gmm_fwd_wgmma_kernel<128, true, "
             "true>", "K6 grouped_matmul"),
            ("void (anonymous namespace)::paged_chunk_tc_kernel<signed "
             "char, 128>", "K2 paged_chunk"),
            ("void (anonymous namespace)::paged_chunk_combine_kernel<128>",
             "K2 paged_chunk"),
            ("void (anonymous namespace)::paged_decode_kernel<float>",
             "K1 paged_decode"),
            ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", "matmul"),
            ("void at::native::reduce_kernel<512, 1>", "reduction"),
            ("void at::native::vectorized_elementwise_kernel<4>",
             "elementwise"),
            ("some_new_kernel", "other")):
        assert t_prof.kernel_group(name) == group
    timer = t_prof.StepTimer(ema=0.5)
    assert timer.tick() is None and timer.throughput(8) is None
    time.sleep(0.01)
    assert timer.tick() > 0 and timer.throughput(8) > 0

