"""Int8 quantization: weight-only per output channel for serving, and per
(position, head) for the KV pool.

Torch twin of ``kubeflow_tpu/compute/quantize.py``, op for op:

- :func:`quantize_array` / :func:`quantize_tree` /
  :func:`dequantize_tree` / :func:`quantized_bytes` (:24-77, :104-116):
  symmetric int8 on the large float leaves of a params tree, stored as
  ``{"q": int8, "scale": float32, "_int8": True}`` leaves;
- :func:`kv_quantize` / :func:`kv_dequantize` (:80-101): symmetric int8
  over the trailing (head_dim) axis with one fp32 scale per (position,
  head), the generation engine's ``kv_dtype="int8"`` pool.

Both quantizers compute in fp32 with IEEE division and round half to
even (``torch.round``, as ``np.round`` and ``jnp.round``), so the codes
and scales are bit-identical to the JAX package's on the same input.
Trees are nested dicts, lists and tuples of tensors.
"""

import torch

#: leaves smaller than this stay in float (norm scales, biases: their
#: bytes do not matter and their dynamic range often does)
MIN_QUANT_SIZE = 4096


def quantize_array(w, axis=-1):
    """Symmetric per-channel int8 → ``{"q": int8, "scale": fp32,
    "_int8": True}``. ``axis`` is the preserved (output-channel) axis;
    the scales broadcast back over every other axis. A 1-D leaf takes
    one tensor scale (per-element scales would be larger than fp32)."""
    w = torch.as_tensor(w).float()
    reduce_axes = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    if not reduce_axes:
        reduce_axes = tuple(range(w.dim()))
    amax = w.abs().amax(dim=reduce_axes, keepdim=True)
    scale = amax / 127.0
    scale = torch.where(scale == 0.0, 1.0, scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale, "_int8": True}


def _is_qleaf(x):
    return isinstance(x, dict) and "_int8" in x and "q" in x \
        and "scale" in x


def _map(fn, tree):
    """``fn`` on every leaf of ``tree``; a quantized leaf is one leaf."""
    if _is_qleaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    """The leaves of ``tree`` in JAX's pytree order (dict keys sorted);
    a quantized leaf is one leaf."""
    if _is_qleaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def quantize_tree(params, min_size=MIN_QUANT_SIZE, axis=-1):
    """Quantize every float leaf of at least 2 dimensions and
    ``min_size`` elements; smaller, 1-D and integer leaves pass through
    untouched."""
    def one(w):
        if isinstance(w, torch.Tensor) and w.dim() >= 2 \
                and w.numel() >= min_size and w.is_floating_point():
            return quantize_array(w, axis=axis)
        return w
    return _map(one, params)


def dequantize_tree(qparams, dtype=torch.bfloat16):
    """Inverse of :func:`quantize_tree`: each int8 leaf widens to
    ``dtype`` and multiplies its scale, rounded to ``dtype``, in
    ``dtype``."""
    def one(x):
        if _is_qleaf(x):
            return x["q"].to(dtype) * x["scale"].to(dtype)
        return x
    return _map(one, qparams)


def kv_quantize(x):
    """Symmetric int8 over the trailing (head_dim) axis, one scale per
    (position, head) → ``(int8 codes, fp32 scales [..., 1])``. An
    all-zero row takes scale 1."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0.0, 1.0, amax / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q, scale, dtype=torch.bfloat16):
    """Inverse of :func:`kv_quantize`: each operand is cast to ``dtype``
    first and the product taken in ``dtype`` (``quantize.py:101``)."""
    return q.to(dtype) * scale.to(dtype)


def quantized_bytes(qparams):
    """``(quantized bytes, float32-equivalent bytes)`` of a tree: an
    int8 leaf counts its codes plus 4 bytes a scale against 4 bytes a
    code; every other leaf counts its own bytes in both."""
    qb = fb = 0
    for leaf in _leaves(qparams):
        if _is_qleaf(leaf):
            qb += leaf["q"].numel() + leaf["scale"].numel() * 4
            fb += leaf["q"].numel() * 4
        else:
            t = torch.as_tensor(leaf)
            qb += t.numel() * t.element_size()
            fb += t.numel() * t.element_size()
    return qb, fb
