"""A decoder-only transformer's weights drawn from the seed on the
device, in the layout both the port and the reference take: a dict with
``embed [V, D]``, ``final_norm [D]``, ``head [D, V]`` and ``layers``, a
dict of leaves stacked over layers — ``attn_norm [L, D]``, ``wq [L, D,
H, hd]``, ``wk``/``wv [L, D, KV, hd]``, ``wo [L, H, hd, D]``, ``mlp_norm
[L, D]`` and either ``w_gate``/``w_up [L, D, F]``, ``w_down [L, F, D]``
or, for a mixture of experts, ``router [L, D, E]``, ``we_gate``/``we_up
[L, E, D, F]``, ``we_down [L, E, F, D]``.

Each matrix is ``N(0, 1) · fan_in^-½`` (fan-in: the input width of the
product it takes part in), each norm scale 1. Every leaf has a generator
of its own, seeded from the run's seed and the leaf's index, so one
leaf can be drawn again alone (the training check recomputes the
initial weights leaf by leaf). Each is one ``torch.randn`` on the
device, in the dtype it is served or trained in.
"""

import math

import torch

from ..roofline.model_flops import Shape


def leaves(config):
    """``[(path, shape, fan_in or None for a norm)]`` in a fixed order;
    ``path`` is ``(name,)`` or ``("layers", name)``."""
    s = Shape.of(config)
    L, D, H, KV, hd, F, V = (s.layers, s.d, s.heads, s.kv_heads,
                             s.head_dim, s.ffn, s.vocab)
    out = [(("embed",), (V, D), D), (("final_norm",), (D,), None),
           (("head",), (D, V), D)]
    layer = [("attn_norm", (L, D), None), ("wq", (L, D, H, hd), D),
             ("wk", (L, D, KV, hd), D), ("wv", (L, D, KV, hd), D),
             ("wo", (L, H, hd, D), H * hd), ("mlp_norm", (L, D), None)]
    if s.experts:
        E = s.experts
        layer += [("router", (L, D, E), D), ("we_gate", (L, E, D, F), D),
                  ("we_up", (L, E, D, F), D), ("we_down", (L, E, F, D), F)]
    else:
        layer += [("w_gate", (L, D, F), D), ("w_up", (L, D, F), D),
                  ("w_down", (L, F, D), F)]
    out += [(("layers", n), shape, fan) for n, shape, fan in layer]
    return out


def _leaf_seed(seed, index):
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (2 ** 63)


def make_leaf(config, path, seed, device, dtype):
    """One leaf, exactly as :func:`make` draws it."""
    for i, (p, shape, fan_in) in enumerate(leaves(config)):
        if p == tuple(path):
            if fan_in is None:
                return torch.ones(shape, dtype=dtype, device=device)
            g = torch.Generator(device=device)
            g.manual_seed(_leaf_seed(seed, i))
            t = torch.randn(shape, generator=g, dtype=dtype, device=device)
            return t.mul_(math.sqrt(1.0 / fan_in))
    raise KeyError(f"no leaf {path!r}")


def make(config, seed, device, dtype):
    """Every leaf, drawn on ``device`` in ``dtype``."""
    params = {"layers": {}}
    for path, _, _ in leaves(config):
        t = make_leaf(config, path, seed, device, dtype)
        if path[0] == "layers":
            params["layers"][path[1]] = t
        else:
            params[path[0]] = t
    return params


def flat(params):
    """``[(path, tensor)]`` in :func:`leaves`' order's names, for any
    tree of this layout."""
    out = [((k,), v) for k, v in sorted(params.items()) if k != "layers"]
    out += [(("layers", k), v) for k, v in sorted(params["layers"].items())]
    return out
