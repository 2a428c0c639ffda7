"""The port's MLP, trial entrypoint, vectorized sweep and functional
optimizer.

Against the JAX package: the MLP's loss and 30 train steps on JAX's
weights and batch carried over through numpy (final loss within 1e-5).
Inside the port, the invariants of ``tests/test_compute_sweep.py``: a
vectorized K-trial sweep IS K independent trials — same objectives
(within 1e-5: the batched matmuls sum in another order), same report
contract.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.compute import mesh as j_mesh
from kubeflow_tpu.compute import train as j_train
from kubeflow_tpu.compute import trial as j_trial
from kubeflow_tpu.compute.models import mlp as j_mlp
from kubeflow_tpu_torch.compute import sweep, telemetry, trial
from kubeflow_tpu_torch.compute import train as t_train
from kubeflow_tpu_torch.compute.models import mlp as t_mlp
from kubeflow_tpu_torch.compute.params import tree_from_jax


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True)
def metrics_file(monkeypatch, tmp_path):
    """A lone trial's final report writes METRICS_PATH: keep every
    test's file in its own temporary directory."""
    path = tmp_path / "trial-metrics.json"
    monkeypatch.setenv("METRICS_PATH", str(path))
    return path


# ------------------------------------------------------------------ MLP

@pytest.fixture(scope="module")
def mnist():
    """JAX's MLP weights and the JAX trial's batch, as numpy."""
    cfg = j_mlp.Config(in_dim=784, hidden=64, n_classes=10)
    params = _np(j_mlp.init_params(cfg, jax.random.PRNGKey(0)))
    key = jax.random.PRNGKey(1)
    batch = {"image": np.asarray(jax.random.normal(key, (64, 28, 28, 1))),
             "label": np.asarray(jax.random.randint(key, (64,), 0, 10))}
    return cfg, params, batch


def test_mlp_loss_and_grads_match_jax(mnist):
    jcfg, params, batch = mnist
    tcfg = t_mlp.Config(in_dim=784, hidden=64, n_classes=10)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_mlp.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jcfg),
        has_aux=True)(params)
    tparams = tree_from_jax(params, device="cpu")
    leaves = t_train.tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tl, tm = t_mlp.loss_fn(tparams, {k: torch.tensor(v) for k, v in
                                     batch.items()}, tcfg)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]))
    for g, w in zip(torch.autograd.grad(tl, leaves),
                    jax.tree.leaves(_np(jg))):
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    assert t_mlp.param_count(tcfg) == j_mlp.param_count(jcfg) \
        == sum(t.numel() for t in leaves)


def test_mlp_thirty_train_steps_match_jax(mnist):
    """The trial's loop on both sides: same weights, batch and
    optimizer (lr 1e-2, warmup 2, 30 steps) → the final loss within
    1e-5."""
    jcfg, params, batch = mnist
    steps = 30
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=steps,
              weight_decay=0.01, clip_norm=1.0)
    mesh = j_mesh.make_mesh(devices=jax.devices()[:1])
    jopt = j_train.make_optimizer(**kw)
    jstate = j_train.init_state(
        lambda k: jax.tree.map(jnp.asarray, params), jopt, mesh,
        j_mlp.logical_axes(jcfg), jax.random.PRNGKey(0))
    jstep = j_train.make_train_step(j_train.plain_loss(j_mlp.loss_fn, jcfg),
                                    jopt, mesh)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tcfg = t_mlp.Config(in_dim=784, hidden=64, n_classes=10)
    topt = t_train.make_optimizer(**kw)
    tstate = t_train.init_state(
        lambda g, device: tree_from_jax(params, device=device), topt,
        device="cpu")
    tstep = t_train.make_train_step(t_train.plain_loss(t_mlp.loss_fn, tcfg),
                                    topt)
    tstate, tm = t_train.fit(tstate, tstep,
                             ({k: v for k, v in batch.items()}
                              for _ in range(steps)))
    for _ in range(steps):
        jstate, jm = jstep(jstate, jbatch)
    assert tstate.step == steps
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    assert float(tm["loss"]) < 0.1          # it memorised the batch
    np.testing.assert_allclose(float(tm["accuracy"]),
                               float(jm["accuracy"]))


# --------------------------------------------- the functional optimizer

@pytest.mark.parametrize("clip_norm", [1.0, 1e-3])
def test_update_fn_equals_update_exactly(clip_norm):
    g = torch.Generator().manual_seed(0)
    params = {"layers": [{"w": torch.randn((5, 3), generator=g),
                          "b": torch.randn((3,), generator=g)},
                         {"w": torch.randn((3, 2), generator=g),
                          "b": torch.randn((2,), generator=g)}]}
    opt = t_train.make_optimizer(1e-2, warmup_steps=2, total_steps=10,
                                 weight_decay=0.1, clip_norm=clip_norm)
    live = t_train.tree_map(torch.clone, params)
    live_state = opt.init(live)
    pure, pure_state = params, opt.init(params)
    for i in range(5):
        grads = t_train.tree_map(
            lambda t: torch.randn(t.shape, generator=g) * (i + 1), params)
        norm_a = opt.update(t_train.tree_leaves(live),
                            t_train.tree_leaves(grads), live_state)
        prev = pure
        before = t_train.tree_map(torch.clone, prev)
        pure, pure_state, norm_b = opt.update_fn(prev, grads, pure_state)
        assert torch.equal(norm_a, norm_b)
        assert pure_state["count"] == live_state["count"] == i + 1
        for key in ("mu", "nu"):
            for a, b in zip(t_train.tree_leaves(live_state[key]),
                            t_train.tree_leaves(pure_state[key])):
                assert torch.equal(a, b)
        for a, b in zip(t_train.tree_leaves(live),
                        t_train.tree_leaves(pure)):
            assert torch.equal(a, b)
        # pure: the inputs were not written
        for a, b in zip(t_train.tree_leaves(before),
                        t_train.tree_leaves(prev)):
            assert torch.equal(a, b)
    assert isinstance(pure["layers"], list)


def test_update_fn_takes_tensor_knobs_under_vmap():
    """Per-trial lr, weight_decay and clip_norm as 0-d tensors under
    vmap give each trial the update its own float knobs give alone."""
    from torch.func import vmap
    g = torch.Generator().manual_seed(1)
    k = 3
    params = {"w": torch.randn((k, 4, 2), generator=g)}
    grads = {"w": torch.randn((k, 4, 2), generator=g) * 3}
    knobs = {"lr": torch.tensor([1e-2, 1e-3, 5e-2]),
             "wd": torch.tensor([0.0, 0.1, 0.01]),
             "clip": torch.tensor([1.0, 0.5, 100.0])}

    def make(lr, wd, clip):
        return t_train.make_optimizer(lr, warmup_steps=0, total_steps=10,
                                      weight_decay=wd, clip_norm=clip)

    def one(hp, p, gr):
        opt = make(hp["lr"], hp["wd"], hp["clip"])
        state = {"count": 1, "mu": {"w": torch.zeros_like(p["w"])},
                 "nu": {"w": torch.zeros_like(p["w"])}}
        return opt.update_fn(p, gr, state)[0]

    got = vmap(one)(knobs, params, grads)["w"]
    for i in range(k):
        opt = make(float(knobs["lr"][i]), float(knobs["wd"][i]),
                   float(knobs["clip"][i]))
        p = {"w": params["w"][i].clone()}
        want, _, _ = opt.update_fn(p, {"w": grads["w"][i]},
                                   {"count": 1, "mu": {"w": torch.zeros(4, 2)},
                                    "nu": {"w": torch.zeros(4, 2)}})
        torch.testing.assert_close(got[i], want["w"], rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ bucketing

class TestBucketing:
    def test_buckets_never_mix_shapes(self):
        trials = [(i, {"lr": 0.01 * (i + 1), "hidden": 64 * (1 + i % 3)})
                  for i in range(12)]
        buckets = sweep.bucket_trials(trials)
        assert len(buckets) == 3
        seen = []
        for key, members in buckets:
            sigs = {sweep.bucket_key(p) for _, p in members}
            assert sigs == {key}            # uniform shape per bucket
            seen += [i for i, _ in members]
        assert sorted(seen) == list(range(12))   # partition, no loss

    def test_continuous_knobs_share_a_bucket(self):
        trials = [(0, {"lr": 1e-2, "weight_decay": 0.1, "hidden": 64}),
                  (1, {"lr": 1e-4, "clip_norm": 0.5, "hidden": 64})]
        assert len(sweep.bucket_trials(trials)) == 1

    def test_member_order_preserved_within_bucket(self):
        trials = [(i, {"lr": 0.01, "hidden": 64}) for i in (5, 2, 9)]
        [(_, members)] = sweep.bucket_trials(trials)
        assert [i for i, _ in members] == [5, 2, 9]

    def test_mixed_value_types_still_bucket(self):
        trials = [(0, {"hidden": 64}), (1, {"hidden": "wide"})]
        assert len(sweep.bucket_trials(trials)) == 2

    def test_matches_the_jax_packages_bucketing(self):
        from kubeflow_tpu.compute import sweep as j_sweep
        trials = [(i, {"lr": 0.01 * (i + 1), "hidden": 64 * (1 + i % 3),
                       "clip_norm": 1.0 + i}) for i in range(9)]
        assert sweep.bucket_trials(trials) == j_sweep.bucket_trials(trials)
        assert sweep.CONTINUOUS_KEYS == j_sweep.CONTINUOUS_KEYS
        assert sweep._pad_members(trials[:3], 8) == j_sweep._pad_members(
            trials[:3], 8)
        assert len(sweep._pad_members(trials[:3], 1)) == 3


class TestVectorizedEqualsIndependent:
    PARAMS = [{"lr": 1e-2, "hidden": 64},
              {"lr": 1e-3, "hidden": 64, "weight_decay": 0.1},
              {"lr": 1e-2, "hidden": 128},
              {"lr": 1e-4, "hidden": 64, "clip_norm": 0.5}]

    def test_sweep_matches_single_trials(self, monkeypatch):
        """The acceptance invariant: same hyperparameters → same
        objective whether run alone (run_mnist_trial) or packed
        (run_mnist_sweep). Two shape buckets, per-trial
        lr/weight_decay/clip_norm."""
        results = sweep.run_mnist_sweep(self.PARAMS, steps=8, device="cpu")
        assert [r["index"] for r in results] == [0, 1, 2, 3]
        for p, r in zip(self.PARAMS, results):
            monkeypatch.setenv("TRIAL_PARAMETERS", json.dumps(p))
            with contextlib.redirect_stdout(io.StringIO()):
                ref = trial.run_mnist_trial(steps=8, device="cpu")
            assert r["objective"] == pytest.approx(ref, rel=1e-5,
                                                   abs=1e-5), p
            assert set(r["metrics"]) == {"loss", "accuracy"}

    def test_hp_argument_and_indices_are_honored(self, monkeypatch):
        monkeypatch.delenv("TRIAL_PARAMETERS", raising=False)
        results = sweep.run_mnist_sweep(
            [(7, {"lr": 3e-3, "hidden": 32}), (2, {"hidden": 32})], steps=4,
            device="cpu")
        assert [r["index"] for r in results] == [7, 2]
        with contextlib.redirect_stdout(io.StringIO()):
            ref = trial.run_mnist_trial({"lr": 3e-3, "hidden": 32}, steps=4,
                                        device="cpu")
        assert results[0]["objective"] == pytest.approx(ref, rel=1e-5,
                                                        abs=1e-5)

    def test_padding_never_leaks_into_results(self):
        """3 trials padded to a trial axis of 8: the padded clones'
        results are dropped, order kept, and the live trials' objectives
        are those of the unpadded run."""
        params = [{"lr": 1e-2, "hidden": 64}, {"lr": 1e-3, "hidden": 64},
                  {"lr": 1e-4, "hidden": 64}]
        results = sweep.run_mnist_sweep(params, steps=3, device="cpu",
                                        trial_shard=8)
        assert [r["index"] for r in results] == [0, 1, 2]
        losses = [r["objective"] for r in results]
        assert len(set(losses)) == 3     # a pad leak would duplicate
        plain = sweep.run_mnist_sweep(params, steps=3, device="cpu")
        assert losses == pytest.approx([r["objective"] for r in plain],
                                       rel=1e-6)

    def test_device_none_means_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: nothing to refuse")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sweep.run_mnist_sweep([{"hidden": 8}], steps=1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trial.run_mnist_trial(steps=1)


class TestReportFanout:
    def _results(self, k):
        return [{"index": i, "objective": 0.5 + i,
                 "metrics": {"loss": 0.5 + i, "accuracy": 0.9}}
                for i in range(k)]

    def test_one_parseable_line_per_trial(self, capsys):
        sweep.report_sweep(self._results(4))
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 4
        for i, line in enumerate(lines):
            parsed = trial.parse_metric_line(line)
            assert parsed is not None
            assert parsed["trial"] == i
            assert parsed["value"] == pytest.approx(0.5 + i)
            assert parsed["extra"] == {"accuracy": 0.9}
            # the JAX package's collector reads the same line
            assert j_trial.parse_metric_line(line) == parsed

    def test_objective_name_env_honored(self, monkeypatch, capsys):
        monkeypatch.setenv("TRIAL_OBJECTIVE_NAME", "val_acc")
        sweep.report_sweep(self._results(1))
        parsed = trial.parse_metric_line(capsys.readouterr().out)
        assert parsed["name"] == "val_acc"

    def test_single_trial_report_contract_unchanged(self, monkeypatch,
                                                    capsys, tmp_path):
        monkeypatch.setenv("METRICS_PATH", str(tmp_path / "m.json"))
        monkeypatch.delenv("TRIAL_OBJECTIVE_NAME", raising=False)
        trial.report(0.75, extra={"accuracy": 0.9})
        line = capsys.readouterr().out
        assert line == ('trial-metric {"name": "objective", '
                        '"value": 0.75, "extra": {"accuracy": 0.9}}\n')
        assert json.loads((tmp_path / "m.json").read_text()) == {
            "objective": 0.75, "accuracy": 0.9}
        j_trial.report(0.75, extra={"accuracy": 0.9})
        assert capsys.readouterr().out == line

    def test_default_metrics_path_follows_tmpdir(self, monkeypatch,
                                                 tmp_path, capsys):
        import tempfile
        monkeypatch.delenv("METRICS_PATH")
        monkeypatch.delenv("TRIAL_OBJECTIVE_NAME", raising=False)
        monkeypatch.setenv("TMPDIR", str(tmp_path))
        monkeypatch.setattr(tempfile, "tempdir", None)   # drop the cache
        trial.report(0.25)
        capsys.readouterr()
        assert json.loads(
            (tmp_path / "trial-metrics.json").read_text()) == {
                "objective": 0.25}

    def test_sweep_report_skips_metrics_path(self, monkeypatch, tmp_path,
                                             capsys):
        monkeypatch.setenv("METRICS_PATH", str(tmp_path / "m.json"))
        trial.report(0.5, trial=3)
        capsys.readouterr()
        assert not (tmp_path / "m.json").exists()

    def test_intermediate_report_goes_to_stdout_only(self, monkeypatch,
                                                     tmp_path, capsys):
        monkeypatch.setenv("METRICS_PATH", str(tmp_path / "m.json"))
        payload = trial.report(0.5, step=3)
        assert payload["step"] == 3
        assert trial.parse_metric_line(capsys.readouterr().out) == payload
        assert not (tmp_path / "m.json").exists()
        assert trial.parse_metric_line("something else") is None
        assert trial.parse_metric_line("trial-metric {broken") is None

    def test_params_reads_both_env_forms(self, monkeypatch):
        monkeypatch.setenv("TRIAL_PARAMETERS", json.dumps({"lr": 0.5}))
        monkeypatch.setenv("TRIAL_PARAM_HIDDEN", "128")
        monkeypatch.setenv("TRIAL_PARAM_NAME", "not-json")
        got = trial.params({"lr": 0.1, "clip_norm": 1.0})
        assert got == {"lr": 0.5, "clip_norm": 1.0, "hidden": 128,
                       "name": "not-json"}
        assert got == j_trial.params({"lr": 0.1, "clip_norm": 1.0})


class TestWorkerEnv:
    def test_trials_from_env(self, monkeypatch):
        blob = json.dumps([{"index": 4, "parameters": {"lr": 0.1}},
                           {"index": 7, "parameters": {"hidden": 128}}])
        monkeypatch.setenv("TRIAL_SWEEP_PARAMETERS", blob)
        assert sweep.trials_from_env() == [(4, {"lr": 0.1}),
                                           (7, {"hidden": 128})]

    def test_empty_env_is_a_hard_error(self, monkeypatch):
        monkeypatch.delenv("TRIAL_SWEEP_PARAMETERS", raising=False)
        with pytest.raises(SystemExit):
            sweep.main(device="cpu")

    def test_worker_runs_and_reports_every_trial(self, monkeypatch, capsys):
        blob = json.dumps([{"index": 4, "parameters": {"lr": 0.1,
                                                       "hidden": 16}},
                           {"index": 7, "parameters": {"hidden": 16}}])
        monkeypatch.setenv("TRIAL_SWEEP_PARAMETERS", blob)
        monkeypatch.setenv("TRIAL_SWEEP_STEPS", "3")
        monkeypatch.setenv("METRICS_PATH", "/nonexistent/never-written")
        steps_before = telemetry.STEP_SECONDS.samples().get(
            ("sweep-mlp",), {}).get("count", 0)
        assert sweep.main(device="cpu") == 0
        lines = [trial.parse_metric_line(ln) for ln in
                 capsys.readouterr().out.strip().splitlines()]
        assert [p["trial"] for p in lines] == [4, 7]
        assert all(np.isfinite(p["value"]) for p in lines)
        assert telemetry.STEP_SECONDS.samples()[("sweep-mlp",)]["count"] \
            == steps_before + 3


class TestObsFamilies:
    def test_program_and_occupancy_observed(self):
        per_program = sweep.TRIALS_PER_PROGRAM.samples().get((), {})
        occupancy = sweep.BUCKET_OCCUPANCY.samples().get((), {})
        before = occupancy.get("count", 0), per_program.get("count", 0), \
            occupancy.get("sum", 0.0)
        sweep.run_mnist_sweep(
            [{"lr": 1e-2, "hidden": 64}, {"lr": 1e-3, "hidden": 64},
             {"lr": 1e-4, "hidden": 64}], steps=2, device="cpu",
            trial_shard=8)
        assert sweep.TRIALS_PER_PROGRAM.samples()[()]["count"] \
            == before[1] + 1
        occ = sweep.BUCKET_OCCUPANCY.samples()[()]
        assert occ["count"] == before[0] + 1
        # 3 live trials on the padded 8-wide axis: occupancy 3/8 —
        # padding is visible, not silent
        assert occ["sum"] - before[2] == pytest.approx(3 / 8)

    def test_compile_cache_family_is_registered_and_counts_nothing(self):
        sweep.install_cache_listener()
        sweep.install_cache_listener()      # a no-op, twice
        assert sweep.COMPILE_CACHE.name == "sweep_compile_cache_total"
        assert sweep.COMPILE_CACHE.label_names == ("result",)
        sweep.run_mnist_sweep([{"hidden": 8}], steps=1, device="cpu")
        assert sweep.COMPILE_CACHE.samples() == {}


# ----------------------------------------------------------- telemetry

def test_telemetry_without_a_card_feeds_steps_but_no_mfu():
    """The trial arms ``flops_per_step``; on a host without CUDA there is
    no peak to divide by, so the MFU gauge stays unset (no number that is
    not a device metric) while the step histogram is fed."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the gauge is set")
    tel = telemetry.TrainTelemetry("cpu-mfu-test", flops_per_step=1e9)
    tel.step()
    tel.step(0.5)
    tel.observe_steps(4, 2.0)
    assert tel.live_mfu() == 0.0
    assert telemetry.STEP_SECONDS.samples()[("cpu-mfu-test",)]["count"] == 5
    given = telemetry.TrainTelemetry("cpu-mfu-given", flops_per_step=1e9,
                                     peak=1e12)
    given.step()
    given.step(0.5)
    assert given.live_mfu() == pytest.approx(1e9 / 0.5 / 1e12)


def test_trial_arms_the_mfu_model(monkeypatch):
    """6·N·batch, the JAX trial's flops model."""
    seen = {}
    real = telemetry.TrainTelemetry.step

    def spy(self, seconds=None):
        seen["flops"] = self.flops_per_step
        return real(self, seconds)

    monkeypatch.setattr(telemetry.TrainTelemetry, "step", spy)
    monkeypatch.delenv("TRIAL_PARAMETERS", raising=False)
    with contextlib.redirect_stdout(io.StringIO()):
        trial.run_mnist_trial({"hidden": 16}, steps=2, device="cpu")
    cfg = t_mlp.Config(in_dim=784, hidden=16, n_classes=10)
    assert seen["flops"] == 6.0 * t_mlp.param_count(cfg) * 64


def test_trial_and_sweep_worker_spans_and_exporter(monkeypatch, tmp_path,
                                                   capsys):
    """As in JAX (``trial.py:87-96, :139-147``, ``sweep.py:278-301``):
    each entry runs the shard exporter for its whole run, and its loop
    is one span (``trial``, ``sweep-worker``) on the controller's trace,
    continued from ``TRACEPARENT``."""
    from kubeflow_tpu_torch.obs import tracing
    trace_id = "4bf92f3577b34da6a3ce929d0e0e4736"
    monkeypatch.setenv("TRACEPARENT",
                       f"00-{trace_id}-00f067aa0ba902b7-01")
    monkeypatch.setenv("METRICS_PATH", str(tmp_path / "metrics.json"))
    monkeypatch.delenv("TRIAL_PARAMETERS", raising=False)
    monkeypatch.setenv("TRIAL_SWEEP_PARAMETERS", json.dumps(
        [{"index": 0, "parameters": {"hidden": 16}},
         {"index": 1, "parameters": {"hidden": 16, "lr": 0.1}}]))
    monkeypatch.setenv("TRIAL_SWEEP_STEPS", "2")
    for name, run in (("trial", lambda: trial.run_mnist_trial(
            {"hidden": 16}, steps=2, device="cpu")),
            ("sweep-worker", lambda: sweep.main(device="cpu"))):
        shards = tmp_path / name
        monkeypatch.setenv("OBS_EXPORT_DIR", str(shards))
        monkeypatch.delenv("OBS_POD_NAME", raising=False)
        monkeypatch.setenv("POD_NAME", f"{name}-0")
        run()
        spans = [s for s in tracing.TRACES.spans(trace_id)
                 if s.name == name]
        assert len(spans) == 1 and spans[0].status == "ok"
        assert spans[0].attrs["steps"] == 2
        assert (shards / f"{name}-0.prom").read_text().startswith(
            "# kubeflow-tpu-shard")
    assert spans[0].attrs["trials"] == 2
    capsys.readouterr()
