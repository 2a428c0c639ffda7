"""The plain reference: a decoder-only transformer (Mistral's dense
SwiGLU layers, Mixtral's top-k experts) written out in float32 PyTorch
operations, its loss and gradients, and a plain AdamW. It imports no
kernel, cache or code of the port (nor JAX), and takes only what the
benchmark makes from the seed: the weights and the token ids.

Matmuls run in float32 with TF32 off (:func:`fp32_matmuls`); the
``precision="fp8"`` option rounds both operands of every linear product
to float8 (e4m3, one scale per tensor) first — the control, one
precision below the bfloat16 the configurations state."""
