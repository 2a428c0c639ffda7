"""The port's token ledger (``kubeflow_tpu_torch/qos``) against the JAX
package's (``kubeflow_tpu/qos/buckets.py``).

Both ledgers are built from the same tenant spec at the same injected
clock and driven through the same seeded schedule of ``fits``,
``try_charge``, ``retry_after``, ``headroom``, ``report``, ``credit``
and ``class_of`` calls at rising instants: every answer must be equal,
and so must every bucket's level after each step. Hand-made cases pin
cohort borrowing, the burst clamp and ``from_env``; the five
``serving_qos_*`` families must be registered on the port's registry
with the JAX package's names, labels, buckets and help text.
"""

import math

import numpy as np
import pytest

from kubeflow_tpu.obs import metrics as j_metrics
from kubeflow_tpu.qos import buckets as j_qos
from kubeflow_tpu_torch import qos as t_qos_pkg
from kubeflow_tpu_torch.obs import metrics as t_metrics
from kubeflow_tpu_torch.qos import buckets as t_qos

TENANTS = ("acme", "beta", "crawler", "delta", "eve")
OPS = ("fits", "try_charge", "retry_after", "headroom", "report",
       "credit", "class_of")


def _spec(rng):
    """A seeded tenant spec: rates (some tenants unconstrained), bursts
    (some defaulted, some below the charges drawn), classes, cohorts."""
    spec = {}
    for t in TENANTS:
        s = {}
        if rng.random() < 0.8:
            s["rate"] = float(rng.choice([0.5, 2.0, 10.0, 40.0]))
            if rng.random() < 0.6:
                s["burst"] = float(rng.choice([4.0, 16.0, 64.0, 200.0]))
        if rng.random() < 0.7:
            s["class"] = str(rng.choice(j_qos.QOS_CLASSES))
        if rng.random() < 0.6:
            s["cohort"] = str(rng.choice(["prod", "lab"]))
        spec[t] = s
    return spec


def _levels(ledger):
    return {t: (b.level, b.stamp) for t, b in ledger.buckets.items()}


@pytest.mark.parametrize("seed", range(8))
def test_seeded_schedules_decide_alike(seed):
    rng = np.random.default_rng(seed)
    spec = _spec(rng)
    j = j_qos.TokenLedger(spec, now=0.0)
    t = t_qos.TokenLedger(spec, now=0.0)
    assert (t.nominal, t.cohorts, t.classes) == (j.nominal, j.cohorts,
                                                 j.classes)
    now = 0.0
    charged = 0
    for _ in range(200):
        now += float(rng.exponential(0.5))
        op = OPS[int(rng.integers(len(OPS)))]
        tenant = str(rng.choice(TENANTS + (None, "stranger")))
        tokens = int(rng.integers(1, 300))
        if op == "credit":
            if tenant in j.buckets:
                j.buckets[tenant].credit(tokens)
                t.buckets[tenant].credit(tokens)
            continue
        if op == "class_of":
            assert t.class_of(tenant) == j.class_of(tenant)
            continue
        if tenant is None and op in ("headroom", "report"):
            continue
        args = (tenant,) if op in ("headroom", "report") \
            else (tenant, tokens)
        want = getattr(j, op)(*args, now=now)
        got = getattr(t, op)(*args, now=now)
        assert got == want, (op, tenant, tokens, now)
        charged += op == "try_charge" and bool(got)
        assert _levels(t) == _levels(j)
    assert charged > 0


def test_cohort_borrowing_draws_peers_in_sorted_order():
    spec = {"a": {"rate": 1, "burst": 10, "cohort": "c"},
            "b": {"rate": 1, "burst": 10, "cohort": "c"},
            "z": {"rate": 1, "burst": 10, "cohort": "c"},
            "solo": {"rate": 1, "burst": 10}}
    for lib in (j_qos, t_qos):
        ledger = lib.TokenLedger(spec, now=0.0)
        assert ledger.headroom("a", now=0.0) == 30.0
        assert ledger.try_charge("a", 25, now=0.0)
        assert _levels(ledger) == {"a": (0.0, 0.0), "b": (0.0, 0.0),
                                   "z": (5.0, 0.0), "solo": (10.0, 0.0)}
        assert not ledger.fits("a", 6, now=0.0)
        assert ledger.retry_after("a", 6, now=0.0) == pytest.approx(1 / 3)
        assert ledger.fits("solo", 11, now=0.0)      # the burst clamp
        assert ledger.members("solo") == {"solo"}


def test_the_burst_clamp_admits_a_charge_above_the_burst_once_full():
    for lib in (j_qos, t_qos):
        bucket = lib.TokenBucket(rate=2, burst=8, now=0.0)
        assert bucket.try_charge(100, now=0.0)          # clamped to 8
        assert bucket.level == 0.0
        assert not bucket.try_charge(100, now=1.0)
        assert bucket.retry_after(100, now=1.0) == 3.0
        assert bucket.try_charge(100, now=4.0)
        zero = lib.TokenBucket(rate=0, burst=1, now=0.0)
        zero.try_charge(1, now=0.0)
        assert zero.retry_after(1, now=9.0) == math.inf


@pytest.mark.parametrize("env", [
    {},
    {"QOS_TENANTS": ""},
    {"QOS_TENANTS": '{"acme": {"rate": 50, "burst": 500, '
                    '"class": "interactive", "cohort": "prod"}, '
                    '"crawler": {"class": "batch"}}'},
    {"QOS_TENANTS": '{"x": {"rate": 3}}', "QOS_DEFAULT_CLASS": "batch"},
], ids=["unset", "empty", "two-tenants", "default-class"])
def test_from_env_builds_the_same_ledger(env):
    j = j_qos.from_env(env)
    t = t_qos.from_env(env)
    assert (t.default_class, t.nominal, t.cohorts, t.classes) == (
        j.default_class, j.nominal, j.cohorts, j.classes)
    for tenant in ("acme", "crawler", "x", "nobody", None):
        assert t.class_of(tenant) == j.class_of(tenant)
        if tenant is not None:
            assert t.report(tenant, now=5.0) == j.report(tenant, now=5.0)


@pytest.mark.parametrize("env,err", [
    ({"QOS_TENANTS": "[1, 2]"}, "JSON object"),
    ({"QOS_TENANTS": '{"a": {"class": "platinum"}}'}, "unknown qos class"),
    ({"QOS_TENANTS": '{"a": {"speed": 1}}'}, "unknown tenant spec keys"),
])
def test_from_env_refuses_alike(env, err):
    for lib in (j_qos, t_qos):
        with pytest.raises(ValueError, match=err):
            lib.from_env(env)


def test_the_package_exports_the_copy():
    assert t_qos_pkg.TokenLedger is t_qos.TokenLedger
    assert t_qos_pkg.QOS_CLASSES == j_qos.QOS_CLASSES
    assert t_qos_pkg.PRIORITY == j_qos.PRIORITY
    assert t_qos_pkg.DEFAULT_CLASS == j_qos.DEFAULT_CLASS
    assert t_qos_pkg.TENANTS_ENV == j_qos.TENANTS_ENV == "QOS_TENANTS"


@pytest.mark.parametrize("name", [
    "serving_qos_tokens_total", "serving_qos_throttled_total",
    "serving_qos_ttft_seconds", "serving_qos_inter_token_seconds",
    "serving_qos_preemptions_total"])
def test_the_families_are_jaxs(name):
    j = j_metrics.REGISTRY._by_name[name]
    t = t_metrics.REGISTRY._by_name[name]
    assert type(t).__name__ == type(j).__name__
    assert (t.label_names, t.help) == (j.label_names, j.help)
    assert getattr(t, "buckets", None) == getattr(j, "buckets", None)
