"""TransformerLM — the decoder-only flagship (llama-family shape), as
plain PyTorch functions over a parameter dict.

Port of ``kubeflow_tpu/compute/models/transformer.py`` (``Config``
:32-121, ``logical_axes`` :162, ``init_params`` :178, the forward
:215-586, ``loss_fn`` :589, ``flops_per_token`` :624, ``param_count``
:638): dense layers and the
mixture-of-experts MLP (capacity dispatch ``_switch_moe`` and dropless
``_dropless_moe``, the latter on the grouped-matmul kernels K6/K7 of
``ops/grouped_matmul.py``). The parameter layout is the JAX one — a dict
with ``embed``, ``final_norm``, ``head`` and a stacked ``layers`` dict
whose leaves carry a leading layer dim — so weights cross between the
two packages through numpy unchanged (``compute/params.py``).
``lax.scan`` over the stacked layers becomes a Python loop.

On a training mesh (:func:`loss_fn` given ``sharding.Sharded`` params)
each batch piece runs on its positions through
:func:`layer_core`'s sharded form: a position's weights gathered over
``fsdp``, its heads of wq/wk/wv and columns of w_gate/w_up, its
attention over its local heads (K3, and K4 + K5 in the backward, per
shard), its row partials of wo/w_down summed in position order on its
sequence chunk's lead position, where that chunk of the residual
stream, the norms, the embedding and the LM head (gathered whole, each
chunk with its own copy) live. The ``sequence`` axis cuts each piece's
sequence into chunks at their global RoPE positions; the heads of one
``tensor`` coordinate ride the ring over the chunks
(``attention="ring"``), or are joined over the whole sequence for dense
and flash attention. With ``pipeline_stages > 1`` the ``pipeline`` axis
holds the stages (``compute/pipeline.py``'s GPipe schedule); without,
it is a replica the piece runs on once, at pipeline coordinate 0. The
``expert`` axis cuts a mixture of experts' weights: each expert shard
computes its experts' share of the MLP (:meth:`_TrainShards.moe`), a
dense model runs replicated over it. The loss and metrics are the
global batch's: each chunk's sums and mask count, summed over the
chunks, the pieces and a gang's processes, then divided; the MoE aux
loss is formed from per-row statistics over the global batch
(:func:`_global_aux`), as JAX's is.

Numerics mirrored on purpose (the token-identity contract rests on
them): RoPE rotates interleaved (even, odd) pairs and restacks them
(not ``rotate_half``); RMSNorm takes its variance in fp32, casts the
rsqrt to x's dtype and multiplies in x's dtype; logits are fp32 from
operands in the compute dtype. The fp32 masters are cast to the
compute dtype inside the autograd graph (:func:`cast_params`), so a
backward lands its gradients on the masters, as JAX's ``.astype`` does.
"""

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import attention as attn_lib
from .. import device as device_lib
from .. import mesh as mesh_lib
from .. import pipeline as pipeline_lib
from .. import sharding
from ..ops import grouped_matmul as gmm_lib
from ..ops.flash_attention import flash_attention

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX ``Config``'s fields, with its checks (:90-98).
    ``attention="ring"`` runs :func:`attention.ring_attention` over the
    mesh's ``sequence`` axis (a ring of one position on one device).
    ``pipeline_stages > 1`` (dividing ``n_layers``, with
    ``scan_layers=True``) runs the layers as a GPipe pipeline of
    :attr:`microbatches` microbatches over the mesh's ``pipeline`` axis
    (one stage on one device), the stacked-layer dim leading with the
    ``"stage"`` logical axis. ``remat`` (default True, as in JAX)
    recomputes each layer's activations in the backward
    (``torch.utils.checkpoint``); it changes nothing without one.

    MoE (``moe_experts`` > 0): ``moe_top_k`` 1 is Switch, 2 GShard-style
    with renormalized gates; ``moe_dropless`` picks dropless dispatch
    over capacity buffers (``moe_capacity_factor``). ``moe_gmm`` picks
    the dropless engine: True or "auto" the grouped matmul (kernels K6
    and K7 on the card — where JAX's "auto" takes ``lax.ragged_dot`` off
    the TPU), False the plain ragged engine (a product per expert),
    which is the reference the card holds the kernels' path against.
    On the card ``moe_gmm_block_m`` must be a multiple of 64 (the
    kernels' row tile)."""
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 0          # 0 → = n_heads (no GQA)
    d_ff: int = 0                # 0 → swiglu default, rounded to 256
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    attention: str = "flash"     # dense | flash | ring
    remat: bool = True
    scan_layers: bool = True
    chunked_ce: bool = False
    ce_chunk: int = 2048
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_dropless: bool = False
    moe_gmm: object = "auto"
    moe_gmm_block_m: int = 128
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0

    def __post_init__(self):
        if self.moe_gmm not in (True, False, "auto"):
            raise ValueError(
                f"moe_gmm must be True, False or 'auto', got "
                f"{self.moe_gmm!r}")
        if self.attention not in ("dense", "flash", "ring"):
            raise ValueError(f"attention={self.attention!r}: dense, flash "
                             f"or ring")
        if self.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} must divide "
                f"n_heads={self.n_heads} (GQA groups q heads evenly "
                f"over kv heads)")
        if self.chunked_ce and self.vocab_size % self.ce_chunk:
            raise ValueError(
                f"ce_chunk={self.ce_chunk} must divide "
                f"vocab_size={self.vocab_size}")
        if self.pipeline_stages > 1:
            if not self.scan_layers:
                raise ValueError(
                    "pipeline_stages needs scan_layers=True (stage "
                    "assignment shards the stacked-layer dim)")
            if self.n_layers % self.pipeline_stages:
                raise ValueError(
                    f"n_layers={self.n_layers} not divisible by "
                    f"pipeline_stages={self.pipeline_stages}")

    @property
    def microbatches(self):
        return self.pipeline_microbatches or self.pipeline_stages

    @property
    def kv_heads(self):
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def ff_dim(self):
        if self.d_ff:
            return self.d_ff
        return ((8 * self.d_model // 3) + 255) // 256 * 256

    @property
    def compute_dtype(self):
        return _DTYPES[self.dtype]


# ---------------------------------------------------------------- params

def _layer_shapes(c):
    h, kv, d, f, hd = (c.n_heads, c.kv_heads, c.d_model, c.ff_dim,
                       c.head_dim)
    shapes = {
        "attn_norm": (d,),
        "wq": (d, h, hd),
        "wk": (d, kv, hd),
        "wv": (d, kv, hd),
        "wo": (h, hd, d),
        "mlp_norm": (d,),
    }
    if c.moe_experts:
        e = c.moe_experts
        shapes.update({"router": (d, e), "we_gate": (e, d, f),
                       "we_up": (e, d, f), "we_down": (e, f, d)})
    else:
        shapes.update({"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)})
    return shapes


#: each layer leaf's logical axes (JAX ``_layer_shapes``' second
#: element), which ``sharding.spec_for`` maps to mesh axes
_LAYER_AXES = {
    "attn_norm": (None,),
    "wq": ("embed", "heads", None),
    "wk": ("embed", "heads", None),
    "wv": ("embed", "heads", None),
    "wo": ("heads", None, "embed"),
    "mlp_norm": (None,),
    "router": ("embed", None),
    "we_gate": ("expert", "embed", "mlp"),
    "we_up": ("expert", "embed", "mlp"),
    "we_down": ("expert", "mlp", "embed"),
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
}


def _shapes(c):
    """Every leaf → ``(shape, logical axes)`` (JAX ``_shapes``, :152)."""
    return {
        "embed": ((c.vocab_size, c.d_model), ("vocab", "embed")),
        "final_norm": ((c.d_model,), (None,)),
        "head": ((c.d_model, c.vocab_size), ("embed", "vocab")),
        "layers": {k: (s, _LAYER_AXES[k])
                   for k, s in _layer_shapes(c).items()},
    }


def logical_axes(config):
    """The params tree's logical axes (JAX ``logical_axes``, :162): the
    stacked layout's leaves lead with ``"layers"``, or with ``"stage"``
    when ``pipeline_stages > 1`` (the stage assignment, over the
    ``pipeline`` mesh axis); with ``scan_layers=False`` the layers are a
    per-layer list."""
    tree = {}
    for name, v in _shapes(config).items():
        if name == "layers":
            lead = "stage" if config.pipeline_stages > 1 else "layers"
            prefix = (lead,) if config.scan_layers else ()
            tree["layers"] = {k: prefix + ax for k, (_, ax) in v.items()}
            if not config.scan_layers:
                tree["layers"] = [tree["layers"]] * config.n_layers
        else:
            tree[name] = v[1]
    return tree


def init_params(config, generator=None, *, device=None):
    """Random fp32 master weights in the JAX layout (stacked
    ``layers``), drawn on the CPU from ``generator`` (a
    ``torch.Generator``; a fresh one seeded 0 when None) so a seed gives
    the same weights on every device, then moved to ``device`` (None →
    the card). The same scheme as JAX ``init_params`` — N(0, 1) scaled
    by fan-in^-1/2, ones for the norms — but not the same numbers: a
    test that needs JAX's weights carries them across with
    ``params_from_jax``."""
    dev = device_lib.resolve(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    c = config

    def normal(shape, std):
        return torch.randn(shape, generator=generator,
                           dtype=torch.float32) * std

    params = {
        "embed": normal((c.vocab_size, c.d_model), c.d_model ** -0.5),
        "final_norm": torch.ones((c.d_model,), dtype=torch.float32),
        "head": normal((c.d_model, c.vocab_size), c.d_model ** -0.5),
    }
    layers = {}
    for name, shape in _layer_shapes(c).items():
        full = (c.n_layers,) + shape
        if len(shape) == 1:
            layers[name] = torch.ones(full, dtype=torch.float32)
        else:
            # expert weights [E, in, out]: fan-in is the middle dim (:197)
            fan_in = shape[1] if name.startswith("we_") else shape[0]
            layers[name] = normal(full, fan_in ** -0.5)
    params["layers"] = layers
    return {k: ({n: t.to(dev) for n, t in v.items()}
                if isinstance(v, dict) else v.to(dev))
            for k, v in params.items()}


def cast_params(params, dtype, device=None):
    """fp32 masters → compute dtype, once. JAX casts at every use
    (``.astype(dt)``); casting once at load gives the same values. The
    MoE ``router`` stays fp32: JAX widens the master for the routing
    logits (``_router``, :305-307), never rounding it."""
    def cast(t, to=dtype):
        return t.to(device=device or t.device, dtype=to)
    return {k: ({n: cast(t, torch.float32 if n == "router" else dtype)
                 for n, t in v.items()}
                if isinstance(v, dict) else cast(v))
            for k, v in params.items()}


def layer_params(params, i):
    """Layer ``i``'s weights as views of the stacked tensors, the
    projections flattened to 2-D for ``torch.matmul``."""
    return flat_layer({k: v[i] for k, v in params["layers"].items()})


def flat_layer(lp):
    """One layer's weights with the projections flattened to 2-D."""
    lp = dict(lp)
    d = lp["wq"].shape[0]
    for name in ("wq", "wk", "wv"):
        lp[name] = lp[name].reshape(d, -1)
    lp["wo"] = lp["wo"].reshape(-1, d)
    return lp


# ---------------------------------------------------------------- forward

def _rmsnorm(x, scale, eps=1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope_tables(config, positions):
    """cos/sin tables for rotary embedding at the given positions."""
    hd = config.head_dim
    freqs = config.rope_theta ** (
        -torch.arange(0, hd, 2, dtype=torch.float32,
                      device=positions.device) / hd)
    angles = positions[..., None].float() * freqs      # [S, hd/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: [B, S, H, D]; rotate pairs (even, odd)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape)


def _attention(q, k, v, config):
    """q [B, S, H, D]; k, v [B, S, kv_heads, D] (not repeated: the flash
    kernel reads kv head ``h // n_rep`` itself). ``"ring"`` on one
    device is the ring of one position."""
    if config.attention == "flash":
        return flash_attention(q, k, v, causal=True)[0]
    if config.attention == "ring":
        return _ring([q], [k], [v], config)[0]
    n_rep = config.n_heads // config.kv_heads
    return attn_lib.dense_attention(
        q, attn_lib.repeat_kv(k, n_rep), attn_lib.repeat_kv(v, n_rep),
        causal=True)


def _ring(qs, ks, vs, config):
    """The causal ring over sequence blocks, K/V repeated to the query
    heads first (JAX's ``_attention`` repeats before the ring)."""
    n_rep = config.n_heads // config.kv_heads
    return attn_lib.ring_attention(
        qs, [attn_lib.repeat_kv(k, n_rep) for k in ks],
        [attn_lib.repeat_kv(v, n_rep) for v in vs], causal=True)


# ------------------------------------------------------------------ MoE

def _router(h, lp, config):
    """The routing head (``transformer.py:299-312``): fp32 logits from
    the fp32 router, softmax, the top-k (sorted, as ``lax.top_k``) and
    the gates renormalized over the chosen experts → ``(probs [b, s,
    e], gate_vals [b, s, k], expert_idx [b, s, k])``."""
    k = min(config.moe_top_k, config.moe_experts)
    logits = torch.einsum("bsd,de->bse", h.float(), lp["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def _moe_aux(probs, expert_idx, e):
    """Switch/GShard load-balancing aux loss from the first choice
    (:315-320)."""
    first = F.one_hot(expert_idx[..., 0], e).float()
    return e * (first.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()


def _row_stats(probs, expert_idx, e):
    """The aux loss's statistics of each batch row → fp32 ``[b, 2, e]``:
    the first-choice count of each expert and the routing probabilities
    summed over the row's tokens (the second under autograd). The mesh
    forward sums them over pieces, chunks and processes before it forms
    :func:`_moe_aux`'s global means."""
    first = F.one_hot(expert_idx[..., 0], e).float().sum(dim=1)
    return torch.stack([first, probs.sum(dim=1)], dim=1)


def _moe_row_aux(probs, expert_idx, e):
    """:func:`_moe_aux` in ``pipeline.train_1f1b``'s row form: the
    statistics of :func:`_row_stats` summed over the rows (``[2, e]``)
    and ``finish(total, rows) = e · Σ (total[0]/n)(total[1]/n)``, ``n``
    the rows' tokens, so a microbatch cut over ``data`` gets the whole
    microbatch's aux (a product of two means is not the mean of the
    cuts' products)."""
    seq = probs.shape[1]

    def finish(total, rows):
        frac = total / (rows * seq)
        return e * (frac[0] * frac[1]).sum()

    return pipeline_lib.RowAux(_row_stats(probs, expert_idx, e).sum(0),
                               finish)


def _aux(probs, expert_idx, e, row_aux):
    return (_moe_row_aux if row_aux else _moe_aux)(probs, expert_idx, e)


def _dispatch(expert_idx, config):
    """The capacity dispatch one-hot ``[b, s, k, e, c]`` in the compute
    dtype (``_switch_moe`` :271-282): each of the k choices is a slot,
    positions within an expert's capacity ``int(k·s/e·capacity_factor)``
    taken in (s, k) order per batch row, slots over capacity dropped."""
    b, s, k = expert_idx.shape
    e = config.moe_experts
    dt = config.compute_dtype
    capacity = max(1, int(k * s / e * config.moe_capacity_factor))
    assign = F.one_hot(expert_idx, e).float()                # [b,s,k,e]
    flat = assign.reshape(b, s * k, e)
    pos = (torch.cumsum(flat, dim=1) * flat - 1.0).reshape(b, s, k, e)
    within = (pos >= 0) & (pos < capacity)
    return (F.one_hot(pos.clamp(0, capacity - 1).long(), capacity)
            .to(dt) * within.to(dt)[..., None])


def _switch_experts(h, dispatch, gate_vals, shards, config):
    """The capacity dispatch's expert work and combine → ``[b, s, d]``.
    ``shards``: per expert shard (in order, each holding ``e / len``
    consecutive experts), its ``(device, layer params)`` per tensor
    shard; each shard routes its experts' slice of ``dispatch`` on its
    device, and the partials are summed in order on ``h``'s device (one
    shard: the whole einsums on one device)."""
    dt = config.compute_dtype
    el = config.moe_experts // len(shards)
    combine = dispatch * gate_vals.to(dt)[..., None, None]
    parts = []
    for c, group in enumerate(shards):
        mine = slice(c * el, (c + 1) * el)
        for dev, lp in group:
            disp = dispatch[..., mine, :].to(dev)
            xin = torch.einsum("bskec,bsd->ebcd", disp, h.to(dev))
            gate_h = torch.einsum("ebcd,edf->ebcf", xin, lp["we_gate"])
            up = torch.einsum("ebcd,edf->ebcf", xin, lp["we_up"])
            out_e = torch.einsum("ebcf,efd->ebcd", F.silu(gate_h) * up,
                                 lp["we_down"])
            parts.append(torch.einsum("bskec,ebcd->bsd",
                                      combine[..., mine, :].to(dev),
                                      out_e).to(h.device))
    return functools.reduce(torch.add, parts)


def _switch_moe(h, lp, config, row_aux=False):
    """Top-k MoE with capacity dispatch (``_switch_moe`` :249-296) on one
    device: :func:`_dispatch`, one-hot einsums route and combine. No
    kernel. → ``(out [b, s, d], aux)``, aux in row form with
    ``row_aux``."""
    probs, gate_vals, expert_idx = _router(h, lp, config)
    out = _switch_experts(h, _dispatch(expert_idx, config), gate_vals,
                          [[(h.device, lp)]], config)
    return out, _aux(probs, expert_idx, config.moe_experts, row_aux)


def _ragged_dot(x, w, counts):
    """``lax.ragged_dot``: the rows of x in runs of ``counts`` (host
    ints), run ``i`` times ``w[i]``."""
    return torch.cat([torch.matmul(xs, w[i])
                      for i, xs in enumerate(torch.split(x, counts))])


def _ragged_engine(wg, wu, wd, hf, key, tok, gates):
    """The plain dropless engine (``_ragged_core`` :352-377): assignment
    ``r`` is token ``tok[r]`` to expert ``key[r]`` with gate
    ``gates[r]``; a stable sort by expert, the fused gate|up product and
    the down product per expert over its contiguous rows, the gate
    scaling and a scatter-add combine into ``[tokens, d]``. Reads the
    counts on the host."""
    f = wg.shape[-1]
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=wg.shape[0]).tolist()
    tok = tok[order]
    gu = _ragged_dot(hf[tok], torch.cat([wg, wu], dim=-1), counts)
    rows = _ragged_dot(F.silu(gu[:, :f]) * gu[:, f:], wd, counts)
    rows = rows * gates[order][:, None]
    return torch.zeros_like(hf).index_add(0, tok, rows)


def _gmm_rows(wg, wu, wd, hf, key, tok, block_m):
    """The grouped-matmul engine's rows (``gmm_inline`` :392-420):
    assignments laid out by :func:`padded_group_layout` over their
    experts ``key``, one int scatter for the dest→source map (padding
    rows point at a trailing zero row), a gather of the tokens ``tok``
    into ``x_pad``, the fused gate|up grouped matmul, SiLU·up, the down
    grouped matmul (K6 each; K6 + K7 in the backward) → each
    assignment's output row, in the given order."""
    f = wg.shape[-1]
    pos, be, fst, lst, m_pad = gmm_lib.padded_group_layout(key, wg.shape[0],
                                                           block_m)
    inv = torch.full((m_pad,), hf.shape[0], dtype=torch.long,
                     device=hf.device)
    inv[pos.long()] = tok
    hf_aug = torch.cat([hf, hf.new_zeros((1, hf.shape[1]))])
    x_pad = hf_aug[inv]
    gu = gmm_lib.gmm(x_pad, torch.cat([wg, wu], dim=-1), be, fst, lst,
                     block_m)
    act = F.silu(gu[:, :f]) * gu[:, f:]
    rows_pad = gmm_lib.gmm(act, wd, be, fst, lst, block_m)
    return rows_pad[pos.long()]


def _expert_rows(lp, hf, flat, gates, k, config, sel=None, first=0):
    """One expert shard's dropless work on its device → its partial
    ``[tokens, d]``: the assignments ``sel`` (indices into the flattened
    ``[tokens·k]`` choices ``flat``, all when None) to its experts, which
    start at global id ``first``. The grouped-matmul engine writes each
    assignment's row back in source order, where a token's k choices are
    adjacent, and combines by a reshape-sum (the rows of other shards'
    assignments exact zeros); the plain engine scatter-adds."""
    dev = lp["we_gate"].device
    hf = hf.to(dev)
    n_rows = flat.shape[0]
    if sel is None:
        key, tok, g = flat, torch.arange(n_rows, device=dev) // k, gates
    else:
        key = flat[sel] - first
        tok, g = sel // k, gates[sel]
    key, tok, g = key.to(dev), tok.to(dev), g.to(dev)
    weights = (lp["we_gate"], lp["we_up"], lp["we_down"])
    if config.moe_gmm is False:
        return _ragged_engine(*weights, hf, key, tok, g)
    rows = _gmm_rows(*weights, hf, key, tok, config.moe_gmm_block_m) \
        * g[:, None]
    if sel is not None:
        rows = rows.new_zeros((n_rows, rows.shape[1])).index_copy(
            0, sel.to(dev), rows)
    return rows.reshape(n_rows // k, k, -1).sum(dim=1)


def _dropless_experts(h, gate_vals, expert_idx, shards, config):
    """Dropless expert work and combine → ``[b, s, d]``. ``shards`` as
    :func:`_switch_experts`'. With one expert shard every assignment is
    computed there; over several (``_dropless_moe``'s ``manual``,
    :379-390), each computes only the assignments routed to its experts
    (JAX hands the others to a zero-weight dummy group; here they are
    left out, as they add exact zeros), a shard with none launches
    nothing, and the partials are summed in order on ``h``'s device
    (JAX's psum over ``expert``)."""
    dt = config.compute_dtype
    b, s, d = h.shape
    k = expert_idx.shape[-1]
    hf = h.reshape(b * s, d)
    flat = expert_idx.reshape(-1)
    gates = gate_vals.reshape(-1).to(dt)
    el = config.moe_experts // len(shards)
    if len(shards) == 1:
        sels = [None]
    else:
        owner = flat // el
        order = torch.argsort(owner, stable=True)
        sels = torch.split(order, torch.bincount(
            owner, minlength=len(shards)).tolist())
    parts = [_expert_rows(lp, hf, flat, gates, k, config, sel, c * el)
             .to(h.device)
             for c, (sel, group) in enumerate(zip(sels, shards))
             if sel is None or sel.numel()
             for _, lp in group]
    return functools.reduce(torch.add, parts).reshape(b, s, d)


def _dropless_moe(h, lp, config, row_aux=False):
    """Dropless MoE (``_dropless_moe`` :323-493) on one device: every
    (token, choice) assignment is computed, no capacity buffers. The
    grouped-matmul engine for ``moe_gmm`` True or "auto", the plain
    ragged engine for False. → ``(out [b, s, d], aux)``, aux in row form
    with ``row_aux``."""
    probs, gate_vals, expert_idx = _router(h, lp, config)
    out = _dropless_experts(h, gate_vals, expert_idx, [[(h.device, lp)]],
                            config)
    return out, _aux(probs, expert_idx, config.moe_experts, row_aux)


# ---------------------------------------------------------------- layers

def _swiglu(h, lp):
    """The dense MLP's gated hidden ``silu(h @ w_gate) * (h @ w_up)``
    (over whatever columns of the two weights ``lp`` holds)."""
    gate = torch.matmul(h, lp["w_gate"])
    up = torch.matmul(h, lp["w_up"])
    return F.silu(gate) * up


def _mlp(h, lp, config, row_aux=False):
    """The layer's MLP → ``(down [B, S, D], aux)``: MoE (dropless or
    capacity) with its aux loss (in row form with ``row_aux``), or the
    dense SwiGLU with aux None."""
    if config.moe_experts and config.moe_dropless:
        return _dropless_moe(h, lp, config, row_aux)
    if config.moe_experts:
        return _switch_moe(h, lp, config, row_aux)
    return torch.matmul(_swiglu(h, lp), lp["w_down"]), None


class _Whole:
    """The unsharded layer as the one shard of itself: the hooks of
    :func:`layer_core`'s sharded form over one parameter dict."""

    def __init__(self, lp):
        self.lp = lp
        self.layers = [lp]

    def norm(self, x, name):
        return [_rmsnorm(x, self.lp[name])]

    def project(self, x, pieces, name):
        return x + torch.matmul(pieces[0], self.lp[name])


def layer_core(x, lp, attend, config, shards=None, row_aux=False):
    """The transformer layer with attention abstracted — ``attend(q, k,
    v) → (o, extra)`` gets the projected (pre-RoPE) heads → ``(x, extra,
    aux)``, aux the MoE load-balancing loss (None for a dense MLP; with
    ``row_aux`` the unsharded layer gives it in ``pipeline.train_1f1b``'s
    row form, :func:`_moe_row_aux`).
    Shared by :func:`apply` and the generation engine's prefill, decode,
    verify and draft, sharded or not, so the cached and sharded paths
    cannot drift from the model.

    The sharded form (the engine's tensor mesh, the training mesh; a
    dense MLP): ``shards`` holds ``layers``, each shard's layer params
    with its column slices of wq/wk/wv and w_gate/w_up; ``norm(x,
    name)``, each shard's normed input; and ``project(x, pieces,
    name)``, the residual plus the shards' head or hidden slices brought
    back to full width through ``wo``/``w_down``. ``x`` is whatever
    those hooks take, ``lp`` is unused, and ``attend(heads) → outs``
    gets every shard's projected ``(q, k, v)`` over its local heads at
    once (a ring needs the other shards' K/V; :func:`each_shard` makes
    one from a per-shard read). The unsharded layer is the one-shard
    case. A mixture of experts hands the MLP to ``moe(x) → (x, aux)``
    (the training mesh's expert parallelism), its aux the per-row
    statistics of :func:`_row_stats`."""
    whole = shards is None
    if whole:
        shards = _Whole(lp)
    hd = config.head_dim
    heads = []
    for sp, h in zip(shards.layers, shards.norm(x, "attn_norm")):
        B, S, _ = h.shape
        heads.append(tuple(torch.matmul(h, sp[w]).view(B, S, -1, hd)
                           for w in ("wq", "wk", "wv")))
    extra = None
    if whole:
        o, extra = attend(*heads[0])
        outs = [o]
    else:
        outs = attend(heads)
    outs = [o.reshape(*o.shape[:2], -1) for o in outs]
    x = shards.project(x, outs, "wo")
    if config.moe_experts and not whole:
        x, aux = shards.moe(x)
        return x, None, aux
    hs = shards.norm(x, "mlp_norm")
    if whole:
        down, aux = _mlp(hs[0], lp, config, row_aux)
        return x + down, extra, aux
    acts = [_swiglu(h, sp) for sp, h in zip(shards.layers, hs)]
    return shards.project(x, acts, "w_down"), None, None


def each_shard(attend):
    """A per-shard read ``attend(i, q, k, v) → o`` as the sharded
    form's ``attend(heads) → outs``."""
    return lambda heads: [attend(i, *h) for i, h in enumerate(heads)]


def _layer(lp, x, rope, config, row_aux=False):
    """One layer on one device → ``(x, aux)``; ``row_aux`` gives an MoE
    layer's aux in row form, as ``pipeline.train_1f1b`` on a ``data``
    axis needs it."""
    cos, sin = rope

    def attend(q, k, v):
        return _attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin),
                          v, config), None

    x, _, aux = layer_core(x, lp, attend, config, row_aux=row_aux)
    return x, aux


def backbone(params, tokens, config):
    """tokens [B, S] int → ``(final-norm hidden states [B, S, D], aux)``,
    aux the MoE load-balancing loss averaged over layers (fp32; 0 for a
    dense MLP), as JAX's ``backbone`` (:536-573). With ``config.remat``
    and autograd recording, each layer is a non-reentrant checkpoint
    (``jax.checkpoint``, :545): its activations are recomputed in the
    backward instead of kept. With ``pipeline_stages > 1`` the layers
    run as the one-stage GPipe pipeline of ``config.microbatches``
    microbatches (:547-562; aux then the mean over layers ×
    microbatches)."""
    p = cast_params(params, config.compute_dtype)
    x = p["embed"][tokens.long()]
    positions = torch.arange(tokens.shape[1], device=x.device)
    rope = rope_tables(config, positions)
    remat = config.remat and torch.is_grad_enabled()

    def layer(lp, x):
        if remat:
            return checkpoint(_layer, lp, x, rope, config,
                              use_reentrant=False)
        return _layer(lp, x, rope, config)

    layers = [layer_params(p, i) for i in range(config.n_layers)]
    if config.pipeline_stages > 1:
        x, auxs = pipeline_lib.pipelined_layers(layer, [layers], x,
                                                config.microbatches)
        aux = pipeline_lib.aux_mean(auxs, x.device)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in layers:
            x, a = layer(lp, x)
            if a is not None:
                aux = aux + a / config.n_layers
    return _rmsnorm(x, p["final_norm"]), aux


def _logits(x, head):
    """fp32 logits from compute-dtype operands: both widened exactly, so
    the product sums in fp32 like JAX's ``preferred_element_type`` (with
    TF32 off, which is PyTorch's default for matmuls)."""
    return torch.matmul(x.float(), head.float())


def apply(params, tokens, config):
    """tokens [B, S] int → logits [B, S, vocab] fp32 (the MoE aux loss
    is dropped here; :func:`loss_fn` carries it)."""
    x, _ = backbone(params, tokens, config)
    return _logits(x, params["head"].to(config.compute_dtype))


def _loss_terms(x, head, targets, mask, config):
    """Final-norm hidden states and the LM head → the sums the loss and
    metrics divide by the mask count: ``loss`` (nll + z-loss, under
    autograd), ``nll`` and ``correct`` (detached), ``count``."""
    if config.chunked_ce:
        from ..ops.cross_entropy import chunked_softmax_xent
        nll, logz, pred = chunked_softmax_xent(x, head, targets,
                                               config.ce_chunk)
    else:
        logits = _logits(x, head)
        logz = torch.logsumexp(logits, dim=-1)
        label = torch.gather(logits, -1, targets[..., None])[..., 0]
        nll = logz - label
        pred = logits.argmax(-1)
    z_loss = 1e-4 * logz.square()
    terms = {"loss": ((nll + z_loss) * mask).sum(), "count": mask.sum()}
    with torch.no_grad():
        terms["nll"] = (nll * mask).sum()
        terms["correct"] = ((pred == targets) * mask).sum()
    return terms


def _finish(terms, aux, config):
    """The sums of :func:`_loss_terms` (one batch's, or summed over a
    mesh's pieces) → ``(loss, metrics)``."""
    denom = terms["count"].clamp_min(1.0)
    loss = terms["loss"] / denom
    if config.moe_experts:
        loss = loss + 0.01 * aux
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "accuracy": terms["correct"] / denom,
            "perplexity": torch.exp(terms["nll"] / denom)}
        if config.moe_experts:
            metrics["moe_aux"] = aux.detach()
    return loss, metrics


def _mask(batch, targets):
    mask = batch.get("mask")
    return (torch.ones(targets.shape, dtype=torch.float32,
                       device=targets.device)
            if mask is None else mask.float())


def loss_fn(params, batch, config):
    """batch: ``{tokens [B, S], targets [B, S], mask [B, S] optional}``
    (tensors on the params' device) → ``(loss, metrics)``.

    Cross entropy in fp32 with z-loss ``1e-4·logz²`` against logit
    drift, over the masked positions (``transformer.py:589-621``). With
    ``config.chunked_ce`` the fp32 ``[B, S, V]`` logits are never formed
    (``ops/cross_entropy.py``). An MoE model adds ``0.01·aux`` (the
    Switch load-balancing loss) and reports it as ``moe_aux``.
    ``metrics`` (``loss``, ``accuracy``, ``perplexity``) are detached
    0-d tensors: reading one waits for the device. Params placed on a
    mesh (``train.init_state(mesh=)``) and a batch from
    ``data.shard_batch`` run the mesh forward (:func:`_mesh_loss`)."""
    mesh = sharding.mesh_of(params)
    if mesh is not None:
        return _mesh_loss(params, batch, config, mesh)
    targets = batch["targets"].long()
    mask = _mask(batch, targets)
    x, aux = backbone(params, batch["tokens"], config)
    head = params["head"].to(config.compute_dtype)
    return _finish(_loss_terms(x, head, targets, mask, config), aux,
                   config)


# ------------------------------------------------------------- mesh

def _check_mesh(config, mesh):
    """The dims the mesh forward cuts must divide (ValueError names the
    field and the axis)."""
    tp, fsdp = mesh.shape[mesh_lib.TENSOR], mesh.shape[mesh_lib.FSDP]
    ep = mesh.shape[mesh_lib.EXPERT]
    for name, value, axis, n in (
            ("n_heads", config.n_heads, "tensor", tp),
            ("kv_heads", config.kv_heads, "tensor", tp),
            ("ff_dim", config.ff_dim, "tensor", tp),
            ("vocab_size", config.vocab_size, "tensor", tp),
            ("d_model", config.d_model, "fsdp", fsdp),
            ("moe_experts", config.moe_experts, "expert", ep)):
        if value % n:
            raise ValueError(f"{name}={value} does not divide over the "
                             f"mesh's {axis} axis of {n}")


class _TrainShards:
    """One batch piece's hooks for :func:`layer_core`'s sharded form on
    one pipeline stage: ``x`` is the piece's sequence chunks, chunk
    ``j`` on its lead (the position of tensor coordinate 0, which holds
    that chunk of the residual stream); ``layers`` each shard's layer
    params (gathered over ``fsdp``, in the compute dtype), chunk-major
    (chunk ``j``'s ``tensor`` shards at ``j·tp … j·tp + tp - 1``). The
    norms run on each chunk's lead with its copy of the scales, the
    normed input sent to the chunk's shards; the row projections are
    each shard's partial product, summed in shard order on the lead;
    the attention rotates q and k to their global positions and runs
    each head group over the chunks (:func:`attention.over_chunks`).

    A mixture of experts (:meth:`moe`): ``experts[j]`` holds chunk
    ``j``'s expert shards, per ``expert`` coordinate ``c`` its ``tensor``
    shards' ``(device, params)`` at positions ``(c, j, t)`` (shard ``c``
    holds experts ``[c·E/ep, (c+1)·E/ep)``, gathered over ``fsdp``). The
    router runs in fp32 on each chunk's lead; dropless expert work is
    token-local, so chunk ``j``'s runs at its own positions; the
    capacity dispatch numbers a row's slots over its whole sequence, so
    its chunks are joined on the piece's lead, the expert work runs at
    sequence coordinate 0, and the result is cut back into chunks."""

    def __init__(self, layers, devices, ropes, n_chunks, config,
                 experts=None):
        self.layers, self.devices, self.ropes = layers, devices, ropes
        self.n_chunks, self.config = n_chunks, config
        self.experts = experts

    def _groups(self, x):
        tp = len(self.layers) // len(x)
        return [range(j * tp, (j + 1) * tp) for j in range(len(x))]

    def norm(self, x, name):
        out = []
        for xj, group in zip(x, self._groups(x)):
            h = _rmsnorm(xj, self.layers[group[0]][name])
            out.extend(h.to(self.devices[i]) for i in group)
        return out

    def project(self, x, pieces, name):
        return [xj + functools.reduce(torch.add, (
            torch.matmul(pieces[i], self.layers[i][name]).to(xj.device)
            for i in group)) for xj, group in zip(x, self._groups(x))]

    def attend(self, heads):
        c = self.config
        roped = [(apply_rope(q, *rope), apply_rope(k, *rope), v)
                 for (q, k, v), rope in zip(heads, self.ropes)]
        ring = (functools.partial(_ring, config=c) if c.attention == "ring"
                else None)
        return attn_lib.over_chunks(
            roped, self.n_chunks, lambda q, k, v: _attention(q, k, v, c),
            ring)

    def moe(self, x):
        """The expert-parallel MoE MLP → ``(x + out, per-row statistics
        [b, 2, e] summed over the chunks, on chunk 0's lead)``."""
        c = self.config
        leads = [self.layers[g[0]] for g in self._groups(x)]
        hs = [_rmsnorm(xj, lp["mlp_norm"]) for xj, lp in zip(x, leads)]
        if c.moe_dropless:
            outs, stats = [], []
            for j, (h, lp) in enumerate(zip(hs, leads)):
                probs, gate_vals, idx = _router(h, lp, c)
                outs.append(_dropless_experts(h, gate_vals, idx,
                                              self.experts[j], c))
                stats.append(_row_stats(probs, idx, c.moe_experts))
        else:
            h = torch.cat([h.to(x[0].device) for h in hs], dim=1)
            probs, gate_vals, idx = _router(h, leads[0], c)
            out = _switch_experts(h, _dispatch(idx, c), gate_vals,
                                  self.experts[0], c)
            outs = [o.to(xj.device) for o, xj in zip(
                torch.split(out, [xj.shape[1] for xj in x], dim=1), x)]
            stats = [_row_stats(probs, idx, c.moe_experts)]
        stat = functools.reduce(torch.add, (t.to(x[0].device)
                                            for t in stats))
        return [xj + o for xj, o in zip(x, outs)], stat


def _piece_loss(params, batch, config, mesh, lead):
    """The loss sums of the batch piece whose lead position is ``lead``
    (:func:`_loss_terms`, summed over its sequence chunks), on the last
    stage's lead device → ``(terms, row_aux)``: ``row_aux`` None for a
    dense MLP, else each layer's per-row aux statistics ``[b, 2, e]``
    (:func:`_row_stats`) in layer order."""
    dt = config.compute_dtype
    base = mesh.coords(lead)
    n_seq, tp = mesh.shape[mesh_lib.SEQUENCE], mesh.shape[mesh_lib.TENSOR]
    ep = mesh.shape[mesh_lib.EXPERT]
    staged = config.pipeline_stages > 1
    n_stages = mesh.shape[mesh_lib.PIPELINE] if staged else 1
    moe = bool(config.moe_experts)

    def at(stage, j, t=0, c=0):
        return mesh.position({**base, mesh_lib.PIPELINE: stage,
                              mesh_lib.SEQUENCE: j, mesh_lib.TENSOR: t,
                              mesh_lib.EXPERT: c})

    seq = batch["tokens"].shape[1]
    if seq % n_seq:
        raise ValueError(f"sequence length {seq} does not divide over the "
                         f"mesh's sequence axis of {n_seq}")
    chunk = seq // n_seq

    def cast(t):
        return t.to(dt)

    def keep(t):        # the router stays fp32 (``cast_params``)
        return t

    def local(name, pos, j):
        return batch[name].pieces[pos][:, j * chunk:(j + 1) * chunk]

    def stage_layers(s):
        """Stage ``s``'s layers, each as its hooks over the stage's
        shards (``L / stages`` layers of the stacked dim)."""
        shards = [at(s, j, t) for j in range(n_seq) for t in range(tp)]
        devices = [mesh.devices[q] for q in shards]
        stacks = [{k: v.gather_at(q, (mesh_lib.FSDP,),
                                  keep if k == "router" else cast)
                   for k, v in params["layers"].items()
                   if not k.startswith("we_")} for q in shards]
        ropes = [rope_tables(config, (i // tp) * chunk + torch.arange(
            chunk, device=d)) for i, d in enumerate(devices)]
        experts = None
        if moe:
            experts = [[[(q, {k: params["layers"][k].gather_at(
                q, (mesh_lib.FSDP,), cast)
                for k in ("we_gate", "we_up", "we_down")})
                for q in (at(s, j, t, c) for t in range(tp))]
                for c in range(ep)] for j in range(n_seq)]

        def hooks(i):
            ex = None if experts is None else [
                [[(mesh.devices[q], {k: v[i] for k, v in st.items()})
                  for q, st in group] for group in chunk_shards]
                for chunk_shards in experts]
            return _TrainShards([layer_params({"layers": st}, i)
                                 for st in stacks], devices, ropes, n_seq,
                                config, ex)

        return [hooks(i) for i in range(config.n_layers // n_stages)]

    remat = config.remat and torch.is_grad_enabled()

    def layer(hooks, x):
        def run(*x):
            y, _, aux = layer_core(list(x), None, hooks.attend, config, hooks)
            return tuple(y) + ((aux,) if moe else ())
        out = (checkpoint(run, *x, use_reentrant=False) if remat
               else run(*x))
        return (list(out[:-1]), out[-1]) if moe else (list(out), None)

    x = [params["embed"].gather_at(at(0, j), cast=cast)[
        local("tokens", at(0, j), j).long()] for j in range(n_seq)]
    if staged:
        x, auxs = pipeline_lib.pipelined_layers(
            layer, [stage_layers(s) for s in range(n_stages)], x,
            config.microbatches,
            hop=lambda s, y: [t.to(mesh.devices[at(s, j)])
                              for j, t in enumerate(y)])
        row_aux = [torch.cat(a, dim=0) for a in auxs] if moe else None
    else:
        row_aux = []
        for hooks in stage_layers(0):
            x, a = layer(hooks, x)
            row_aux.append(a)
    last = n_stages - 1
    terms = []
    for j, xj in enumerate(x):
        pos = at(last, j)
        targets = local("targets", pos, j).long()
        mask = _mask({"mask": local("mask", pos, j)} if "mask" in batch
                     else {}, targets)
        xj = _rmsnorm(xj, params["final_norm"].gather_at(pos, cast=cast))
        terms.append(_loss_terms(xj, params["head"].gather_at(pos, cast=cast),
                                 targets, mask, config))
    dev = mesh.devices[at(last, 0)]
    return ({k: functools.reduce(torch.add, (t[k].to(dev) for t in terms))
             for k in terms[0]}, row_aux if moe else None)


def _global_aux(row_auxs, config, mesh, seq):
    """The MoE aux loss from the pieces' per-row statistics (``row_auxs``:
    per piece, in global row order, each layer's ``[b, 2, e]``) as JAX
    computes it over the global batch: the rows grouped as JAX groups
    them — the whole global batch, or with ``pipeline_stages > 1`` its
    microbatch ``i``, the global rows ``[i·B/M, (i+1)·B/M)``
    (``pipeline.py:83-84``) — their counts and probabilities summed over
    pieces and processes, and ``e · Σ_e mean(first choice == e) ·
    mean(probs_e)`` averaged over layers × groups. A mean of per-piece
    aux values would not be it: the aux is a product of means."""
    e = config.moe_experts
    dev = mesh.devices[0]
    b = row_auxs[0][0].shape[0]
    n_groups = config.microbatches if config.pipeline_stages > 1 else 1
    rows = b * len(row_auxs) * mesh.process_count
    per_group = rows // n_groups
    base = mesh.process_index * b * len(row_auxs)
    stats = torch.zeros((config.n_layers, n_groups, 2, e),
                        dtype=torch.float32, device=dev)
    for p, layers in enumerate(row_auxs):
        group = (base + p * b + torch.arange(b, device=dev)) // per_group
        stats = stats.index_add(1, group, torch.stack(
            [a.to(dev) for a in layers]))
    frac = mesh_lib.global_sum(stats, mesh) / (per_group * seq)
    return (e * (frac[:, :, 0] * frac[:, :, 1]).sum(dim=-1)).mean()


def _mesh_loss(params, batch, config, mesh):
    """:func:`loss_fn` on a mesh → the global batch's ``(loss,
    metrics)`` on the first position's device. One position of one
    process is the model on one device (its MoE included). On a gang of
    processes the mask count, the metrics' sums and the MoE statistics
    are summed over the gang (:func:`mesh.global_sum`): every process
    reports the gang's loss, and its gradient is its own share of it."""
    if mesh.size == 1 and mesh.process_count == 1:
        return loss_fn(sharding.local(params, 0),
                       sharding.local(batch, 0), config)
    _check_mesh(config, mesh)
    # the port's layers are stacked whatever scan_layers says
    sharding.check_layout(
        params, logical_axes(dataclasses.replace(config, scan_layers=True)),
        "the transformer")
    dev = mesh.devices[0]
    pieces = [_piece_loss(params, batch, config, mesh, lead)
              for lead in mesh.along(0, (mesh_lib.DATA, mesh_lib.FSDP))]
    terms = {k: mesh_lib.global_sum(functools.reduce(
        torch.add, (t[k].to(dev) for t, _ in pieces)), mesh)
        for k in pieces[0][0]}
    aux = None
    if config.moe_experts:
        aux = _global_aux([a for _, a in pieces], config, mesh,
                          batch["tokens"].shape[1])
    return _finish(terms, aux, config)


def flops_per_token(config):
    """Analytic 6ND forward+backward FLOPs per token (MFU accounting),
    the JAX package's formula (``transformer.py:624-635``). It counts
    the dense MLP once whatever ``moe_experts`` and ``moe_top_k`` are, so
    an MoE model's MFU by it is JAX's reading, not the work done."""
    c = config
    n_params = (
        c.vocab_size * c.d_model * 2
        + c.n_layers * (
            c.d_model * (c.n_heads + 2 * c.kv_heads) * c.head_dim
            + c.n_heads * c.head_dim * c.d_model
            + 3 * c.d_model * c.ff_dim
            + 2 * c.d_model))
    attn = 12 * c.n_layers * c.d_model * c.max_seq  # per-token attn matmuls
    return 6 * n_params + attn


def param_count(config):
    """Number of parameters (``transformer.py:638``)."""
    c = config
    return (2 * c.vocab_size * c.d_model + c.d_model     # embed, head, norm
            + c.n_layers * sum(math.prod(s)
                               for s in _layer_shapes(c).values()))
