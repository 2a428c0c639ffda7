"""Observability of the port: its own copies of the JAX package's
dependency-free metric registry (``metrics``), goodput ledger
(``goodput``), request tracing (``tracing``) and shard exporter
(``export``), which the training telemetry and the model server book
into."""
