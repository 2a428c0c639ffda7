"""Token-economy ledger of the port — per-tenant budgets for the
``:generate`` engine's admission, a copy of ``kubeflow_tpu/qos/buckets.py``.

- ``TokenBucket`` is the rate half: ``rate`` tokens/sec of refill up to
  a ``burst`` ceiling. A request *prepays* its worst case (its
  ``max_tokens``) — token streams cannot be un-emitted, so admission is
  where the budget bites.
- ``TokenLedger`` is the tenancy half: ``nominal`` is a tenant's own
  refill rate, tenants sharing a ``cohort`` may borrow a peer's idle
  burst, and a tenant with no nominal rate is unconstrained — it neither
  lends nor borrows.
- QoS classes order tenants under pressure: ``batch`` < ``standard`` <
  ``interactive``. The ledger only *names* the class; the engine's
  priority admission and preemption (``compute/generate.py``) enforce
  it.

The model server builds its ledger from the ``QOS_TENANTS`` env spec:

    QOS_TENANTS='{"acme": {"rate": 50, "burst": 500,
                           "class": "interactive", "cohort": "prod"}}'

Rates are tokens/sec; ``burst`` defaults to 10s of refill; ``class``
defaults to ``standard``; a tenant with no ``rate`` is unconstrained.
The ``serving_qos_*`` families are registered on the port's
``obs.metrics.REGISTRY`` under the JAX package's names, labels, buckets
and help text.
"""

import json
import math
import os
import time

from ..obs import metrics as obs_metrics

#: priority order of the QoS classes — higher admits first, and a
#: strictly-higher class may preempt a running lower-class slot
QOS_CLASSES = ("batch", "standard", "interactive")
PRIORITY = {cls: rank for rank, cls in enumerate(QOS_CLASSES)}
DEFAULT_CLASS = "standard"

#: the env spec the model server reads
TENANTS_ENV = "QOS_TENANTS"

# the serving_qos_* families under the JAX package's names, labels,
# buckets and help text (one dashboard and one metrics hub for both)
TOKENS_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_qos_tokens_total",
    "Generated tokens emitted per tenant and QoS class — the token "
    "economy's spend ledger (only tenant-attributed requests are "
    "counted; anonymous traffic stays in serving_generate_tokens_total "
    "alone)",
    ("tenant", "class"))
THROTTLED_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_qos_throttled_total",
    "QoS enforcement hits per tenant by mechanism: budget = router "
    "429 (token bucket empty), shed = router 429 (burn-rate load "
    "shedding of low classes), deferred = engine admission postponed "
    "until the tenant's bucket refilled",
    ("tenant", "reason"))
TTFT_SECONDS = obs_metrics.REGISTRY.histogram(
    "serving_qos_ttft_seconds",
    "Per-tenant time to first token — the tenant-sliced twin of "
    "serving_generate_ttft_seconds, so one noisy neighbor is visible "
    "next to the model-wide aggregate",
    ("tenant", "class"),
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
             10.0))
INTER_TOKEN_SECONDS = obs_metrics.REGISTRY.histogram(
    "serving_qos_inter_token_seconds",
    "Per-tenant gap between token emission events — a preempted "
    "stream's suspension shows up here as one long gap (the price a "
    "batch-class tenant pays under interactive pressure)",
    ("tenant", "class"),
    buckets=(5e-4, 1e-3, 2.5e-3, 5e-3, 0.01, 0.025, 0.05, 0.1, 0.25,
             1.0))
PREEMPTIONS_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_qos_preemptions_total",
    "Mid-stream suspensions suffered per tenant and class — the "
    "eviction-economics counterpart of serving_generate_preemptions_"
    "total, attributed to who paid the interruption",
    ("tenant", "class"))


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/sec refill, ``burst``
    ceiling, charges are all-or-nothing. One deliberate deviation: a
    charge larger than a full burst is clamped to ``burst`` for
    affordability (it is admitted when the bucket is FULL and drains
    it) — otherwise a tenant whose burst is below the model's
    ``max_tokens`` could never generate at all.

    Time is passed in (``now``) or taken from ``time.monotonic()``;
    tests inject their own clock."""

    __slots__ = ("rate", "burst", "level", "stamp")

    def __init__(self, rate, burst, now=None):
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)
        self.stamp = time.monotonic() if now is None else float(now)

    def _refill(self, now):
        if now > self.stamp:
            self.level = min(self.burst,
                             self.level + (now - self.stamp) * self.rate)
            self.stamp = now

    def available(self, now=None):
        self._refill(time.monotonic() if now is None else now)
        return self.level

    def _cost(self, tokens):
        return min(float(tokens), self.burst)

    def try_charge(self, tokens, now=None):
        self._refill(time.monotonic() if now is None else now)
        cost = self._cost(tokens)
        if self.level >= cost:
            self.level -= cost
            return True
        return False

    def credit(self, tokens):
        """Refund (bounded by burst) — e.g. a prepaid request that was
        rejected downstream before emitting anything."""
        self.level = min(self.burst, self.level + float(tokens))

    def retry_after(self, tokens, now=None):
        """Seconds until a charge of ``tokens`` could succeed (0.0 if
        it would succeed now, ``inf`` for a zero-rate bucket)."""
        self._refill(time.monotonic() if now is None else now)
        deficit = self._cost(tokens) - self.level
        if deficit <= 0:
            return 0.0
        if self.rate <= 0:
            return math.inf
        return deficit / self.rate


class TokenLedger:
    """Per-tenant token budgets + QoS classes. ``nominal`` maps tenant
    -> refill rate (tokens/sec) or None for unconstrained; ``cohorts``
    maps tenant -> cohort name
    (absent = the tenant pools only with itself). Cohort members may
    borrow a peer's *currently idle* tokens; an unconstrained tenant
    neither lends nor borrows."""

    #: default burst = this many seconds of nominal refill
    BURST_SECONDS = 10.0

    def __init__(self, tenants=None, default_class=DEFAULT_CLASS,
                 now=None):
        self.default_class = default_class
        self.nominal = {}      # tenant -> rate | None
        self.cohorts = {}      # tenant -> cohort
        self.classes = {}      # tenant -> qos class
        self.buckets = {}      # tenant -> TokenBucket (constrained only)
        for tenant, spec in (tenants or {}).items():
            self.add(tenant, now=now, **spec)

    def add(self, tenant, rate=None, burst=None, qos_class=None,
            cohort=None, now=None, **legacy):
        # accept the env-spec key "class" (a Python keyword)
        qos_class = qos_class or legacy.pop("cls", None) \
            or legacy.pop("class", None)
        if legacy:
            raise ValueError(f"unknown tenant spec keys: "
                             f"{sorted(legacy)}")
        qos_class = qos_class or self.default_class
        if qos_class not in PRIORITY:
            raise ValueError(
                f"unknown qos class {qos_class!r} (expected one of "
                f"{QOS_CLASSES})")
        self.nominal[tenant] = None if rate is None else float(rate)
        self.classes[tenant] = qos_class
        if cohort:
            self.cohorts[tenant] = cohort
        if rate is not None:
            if burst is None:
                burst = max(1.0, float(rate) * self.BURST_SECONDS)
            self.buckets[tenant] = TokenBucket(rate, burst, now=now)
        return self

    # ---------------------------------------------------------- identity

    def class_of(self, tenant):
        if tenant is None:
            return self.default_class
        return self.classes.get(tenant, self.default_class)

    def cohort_of(self, tenant):
        return self.cohorts.get(tenant) or f"tenant:{tenant}"

    def members(self, tenant):
        """Tenants pooling budget with ``tenant`` (inclusive); only
        rate-carrying members count."""
        cohort = self.cohort_of(tenant)
        out = {tenant}
        for t, c in self.cohorts.items():
            if c == cohort and self.nominal.get(t) is not None:
                out.add(t)
        return out

    def constrained(self, tenant):
        return tenant is not None and tenant in self.buckets

    # ---------------------------------------------------------- charging

    def _peers(self, tenant):
        return [self.buckets[t] for t in sorted(self.members(tenant))
                if t != tenant and t in self.buckets]

    def headroom(self, tenant, now=None):
        """Tokens chargeable right now (own bucket plus cohort peers'
        idle tokens), or None when unconstrained."""
        if not self.constrained(tenant):
            return None
        now = time.monotonic() if now is None else now
        return self.buckets[tenant].available(now) + sum(
            b.available(now) for b in self._peers(tenant))

    def fits(self, tenant, tokens, now=None):
        head = self.headroom(tenant, now)
        if head is None:
            return True
        own = self.buckets[tenant]
        cost = min(float(tokens),
                   own.burst + sum(b.burst for b in self._peers(tenant)))
        return cost <= head

    def try_charge(self, tenant, tokens, now=None):
        """All-or-nothing charge: the tenant's own bucket pays first,
        any deficit borrows from cohort peers (sorted order, so the
        draw is deterministic)."""
        if not self.constrained(tenant):
            return True
        now = time.monotonic() if now is None else now
        if not self.fits(tenant, tokens, now):
            return False
        own = self.buckets[tenant]
        peers = self._peers(tenant)
        cost = min(float(tokens),
                   own.burst + sum(b.burst for b in peers))
        take = min(cost, own.available(now))
        own.level -= take
        cost -= take
        for bucket in peers:
            if cost <= 0:
                break
            take = min(cost, bucket.available(now))
            bucket.level -= take
            cost -= take
        return True

    def retry_after(self, tenant, tokens, now=None):
        """Seconds until the charge could succeed, against the pooled
        cohort refill rate — what a 429's Retry-After should say."""
        head = self.headroom(tenant, now)
        if head is None:
            return 0.0
        own = self.buckets[tenant]
        peers = self._peers(tenant)
        cost = min(float(tokens),
                   own.burst + sum(b.burst for b in peers))
        deficit = cost - head
        if deficit <= 0:
            return 0.0
        pooled_rate = own.rate + sum(b.rate for b in peers)
        if pooled_rate <= 0:
            return math.inf
        return deficit / pooled_rate

    def report(self, tenant, now=None):
        """One tenant's budget snapshot."""
        head = self.headroom(tenant, now)
        return {
            "nominal": self.nominal.get(tenant),
            "cohort": self.cohorts.get(tenant),
            "class": self.class_of(tenant),
            "available": None if not self.constrained(tenant)
                else round(self.buckets[tenant].available(
                    time.monotonic() if now is None else now), 3),
            "headroom": None if head is None else round(head, 3),
        }


def from_env(env=None):
    """Build the process's ledger from ``QOS_TENANTS`` (JSON mapping
    tenant -> {rate, burst, class, cohort}). An unset/empty spec yields
    an empty ledger: every tenant unconstrained, every class the
    default — QoS stays fully inert until configured."""
    env = os.environ if env is None else env
    spec = (env.get(TENANTS_ENV) or "").strip()
    default_class = env.get("QOS_DEFAULT_CLASS", DEFAULT_CLASS)
    tenants = {}
    if spec:
        parsed = json.loads(spec)
        if not isinstance(parsed, dict):
            raise ValueError(f"{TENANTS_ENV} must be a JSON object")
        tenants = parsed
    return TokenLedger(tenants, default_class=default_class)
