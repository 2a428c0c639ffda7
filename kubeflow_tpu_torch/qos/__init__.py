"""The port's multi-tenant token economy: per-tenant token buckets and
QoS classes (``batch`` < ``standard`` < ``interactive``), enforced at
the generation engine's admission queue (``compute/generate.py``:
priority-ordered admission, preemptible decoding with a cache-retained
suspend and a prefix-cached resume). A copy of ``kubeflow_tpu/qos``
without the router's gate."""

from .buckets import (DEFAULT_CLASS, INTER_TOKEN_SECONDS,  # noqa: F401
                      PREEMPTIONS_TOTAL, PRIORITY, QOS_CLASSES,
                      TENANTS_ENV, THROTTLED_TOTAL, TOKENS_TOTAL,
                      TTFT_SECONDS, TokenBucket, TokenLedger, from_env)
