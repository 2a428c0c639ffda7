"""Weights across the framework boundary: the JAX package's parameter
pytree, as numpy arrays, into the port's dict of tensors
(:func:`params_from_jax`) and back (:func:`params_to_numpy`).

No weights are downloaded anywhere in the repo; a test that holds the
port to the JAX reference initialises once in JAX, converts each leaf
with ``np.asarray`` and hands the tree here. JAX's ``init_params``
returns fp32 masters, so plain numpy dtypes suffice.
"""

import numpy as np
import torch

from . import device as device_lib


def _tensor(a, dtype, dev):
    a = np.asarray(a)
    if a.dtype.kind not in "fiu":
        raise TypeError(
            f"cannot convert a {a.dtype} array; pass fp32 masters (JAX "
            f"init_params output) as numpy arrays")
    t = torch.tensor(a)   # a copy: JAX's host buffers are read-only
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(dev)


def params_from_jax(tree, dtype=None, device=None):
    """JAX parameter pytree (numpy leaves) → the port's params dict.

    ``tree["layers"]`` may be the scan-stacked dict (leading layer dim)
    or the per-layer list of dicts (``scan_layers=False``); the list is
    stacked, as the JAX engine does (``generate.py:801-806``).
    ``dtype`` optionally casts the float leaves; ``device`` None → the
    card."""
    dev = device_lib.resolve(device)
    layers = tree["layers"]
    if isinstance(layers, (list, tuple)):
        layers = {k: np.stack([np.asarray(lp[k]) for lp in layers])
                  for k in layers[0]}
    out = {k: _tensor(v, dtype, dev) for k, v in tree.items()
           if k != "layers"}
    out["layers"] = {k: _tensor(v, dtype, dev) for k, v in layers.items()}
    return out


def params_to_numpy(params):
    """The port's params dict → the JAX layout as numpy arrays (the
    reverse of :func:`params_from_jax`, stacked layers): copies on the
    host, float leaves as fp32 (numpy has no bfloat16), so the tree can
    go to ``jnp.asarray`` or a checkpoint."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy().copy()
    return {k: ({n: leaf(t) for n, t in v.items()}
                if isinstance(v, dict) else leaf(v))
            for k, v in params.items()}
