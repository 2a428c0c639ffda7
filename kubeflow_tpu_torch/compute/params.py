"""Weights across the framework boundary: the JAX package's parameter
pytree, as numpy arrays, into the port's tensors
(:func:`params_from_jax` for the transformer, :func:`tree_from_jax` for
any tree) and back (:func:`params_to_numpy`).

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


def tree_from_jax(tree, dtype=None, device=None):
    """Any nested dict / list / tuple of numpy leaves → the same
    structure of tensors: ResNet's ``(params, stats)``, BERT's and the
    MLP's trees, which keep JAX's layout as they are. ``dtype``
    optionally casts the float leaves; ``device`` None → the card."""
    dev = device_lib.resolve(device)
    if isinstance(tree, dict):
        return {k: tree_from_jax(v, dtype, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_jax(v, dtype, dev) for v in tree)
    return _tensor(tree, dtype, dev)


def params_to_numpy(params):
    """A tree of tensors (nested dicts, lists, tuples) → the same
    structure of numpy arrays (the reverse of :func:`params_from_jax`,
    stacked layers, and of :func:`tree_from_jax`): copies on the host,
    float leaves as fp32 (numpy has no bfloat16), so the tree can go to
    ``jnp.asarray`` or a checkpoint."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to_numpy(v) for v in params)
    t = params.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy().copy()
