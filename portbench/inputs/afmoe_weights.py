"""An AFMoE model's weights (Arcee's Trinity) drawn from the seed on the
device, in the layout the port's engine serves (``PortConfig``'s AFMoE
layout) and the reference (``reference/afmoe.py``) reads:

- ``embed [V, D]``, ``final_norm [D]``, ``head [D, V]``;
- ``layers``, stacked over all ``L`` layers: ``attn_norm``,
  ``post_attn_norm``, ``mlp_norm``, ``post_mlp_norm`` ``[L, D]``,
  ``q_norm``/``k_norm [L, hd]``, ``wq``/``w_attn_gate [L, D, H, hd]``,
  ``wk``/``wv [L, D, KV, hd]``, ``wo [L, H, hd, D]``;
- ``dense_mlp``, over the leading dense layers: ``w_gate``/``w_up
  [Ld, D, F]``, ``w_down [Ld, F, D]``;
- ``moe_mlp``, over the expert layers: ``router [Lm, D, E]`` and
  ``router_bias [Lm, E]`` (float32), ``we_gu [Lm, E, D, 2f]`` (each
  expert's gate then up, joined as the grouped matmul reads them),
  ``we_down [Lm, E, f, D]``, ``ws_gu [Lm, D, 2fs]`` and ``ws_down [Lm,
  fs, D]`` (the shared experts).

Each matrix is ``N(0, 1) · fan_in^-½``, each norm scale 1, the router's
selection bias ``N(0, BIAS_STD²)``. Every leaf has a generator of its
own, seeded from the run's seed and the leaf's index; each is one
``torch.randn`` on the device, in the dtype it is served in (the router
and its bias in float32, as the engine reads them), so the engine holds
these tensors and no copy of them.
"""

import math

import torch

from ..roofline.afmoe import Afmoe
from .weights import _leaf_seed

#: the standard deviation of the router's selection bias
BIAS_STD = 0.02
FP32_LEAVES = ("router", "router_bias")


def leaves(config):
    """``[(path, shape, fan_in, or None for a norm, or "bias")]`` in a
    fixed order."""
    s = Afmoe.of(config)
    L, D, H, KV, hd, V = (s.layers, s.d, s.heads, s.kv_heads, s.head_dim,
                          s.vocab)
    Ld, Lm, E, f = s.dense_layers, s.moe_layers, s.experts, s.expert_ffn
    fs = s.shared * f
    out = [(("embed",), (V, D), D), (("final_norm",), (D,), None),
           (("head",), (D, V), D)]
    out += [(("layers", n), shape, fan) for n, shape, fan in (
        ("attn_norm", (L, D), None), ("wq", (L, D, H, hd), D),
        ("wk", (L, D, KV, hd), D), ("wv", (L, D, KV, hd), D),
        ("q_norm", (L, hd), None), ("k_norm", (L, hd), None),
        ("w_attn_gate", (L, D, H, hd), D), ("wo", (L, H, hd, D), H * hd),
        ("post_attn_norm", (L, D), None), ("mlp_norm", (L, D), None),
        ("post_mlp_norm", (L, D), None))]
    if Ld:
        out += [(("dense_mlp", n), shape, fan) for n, shape, fan in (
            ("w_gate", (Ld, D, s.ffn), D), ("w_up", (Ld, D, s.ffn), D),
            ("w_down", (Ld, s.ffn, D), s.ffn))]
    moe = [("router", (Lm, D, E), D), ("router_bias", (Lm, E), "bias"),
           ("we_gu", (Lm, E, D, 2 * f), D), ("we_down", (Lm, E, f, D), f)]
    if fs:
        moe += [("ws_gu", (Lm, D, 2 * fs), D), ("ws_down", (Lm, fs, D), fs)]
    out += [(("moe_mlp", n), shape, fan) for n, shape, fan in moe]
    return out


def make(config, seed, device, dtype):
    """Every leaf, drawn on ``device`` in ``dtype`` (the router and its
    bias in float32)."""
    params = {}
    for i, (path, shape, fan_in) in enumerate(leaves(config)):
        dt = torch.float32 if path[-1] in FP32_LEAVES else dtype
        if fan_in is None:
            t = torch.ones(shape, dtype=dt, device=device)
        else:
            g = torch.Generator(device=device)
            g.manual_seed(_leaf_seed(seed, i))
            t = torch.randn(shape, generator=g, dtype=dt, device=device)
            t.mul_(BIAS_STD if fan_in == "bias" else math.sqrt(1.0 / fan_in))
        if len(path) == 1:
            params[path[0]] = t
        else:
            params.setdefault(path[0], {})[path[1]] = t
    return params
