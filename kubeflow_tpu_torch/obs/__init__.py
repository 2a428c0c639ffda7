"""Observability of the port: its own copies of the JAX package's
dependency-free metric registry (``metrics``) and goodput ledger
(``goodput``), which the training telemetry books into."""
