"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: ``paged_attention`` (K1, the decode read over the
paged KV pool; K2, the chunk read after a cached prefix),
``flash_attention`` (K3, the tiled attention forward; K4 and K5, its
backward), ``grouped_matmul`` (K6, the block-diagonal grouped matmul of
dropless MoE; K7, its weight gradient) and ``cross_entropy`` (the
chunked LM loss, plain PyTorch). ``_build`` compiles ``csrc/*.cu`` at
first use."""
