"""Compute layer of the port: the TransformerLM, the attention reads,
the hand-written Hopper kernels under ``ops/``, the greedy generation
engine and the training loop (``train``, ``data``, ``checkpoint``,
``telemetry``, ``profiler``)."""
