"""TransformerLM — the decoder-only flagship (llama-family shape), as
plain PyTorch functions over a parameter dict.

Port of ``kubeflow_tpu/compute/models/transformer.py`` (``Config``
:32-121, ``init_params`` :178, the forward :215-586, ``loss_fn`` :589,
``flops_per_token`` :624, ``param_count`` :638), dense layers. The
parameter layout is the JAX one — a dict with ``embed``,
``final_norm``, ``head`` and a stacked ``layers`` dict whose leaves
carry a leading layer dim — so weights cross between the two packages
through numpy unchanged (``compute/params.py``). ``lax.scan`` over the
stacked layers becomes a Python loop.

Numerics mirrored on purpose (the token-identity contract rests on
them): RoPE rotates interleaved (even, odd) pairs and restacks them
(not ``rotate_half``); RMSNorm takes its variance in fp32, casts the
rsqrt to x's dtype and multiplies in x's dtype; logits are fp32 from
operands in the compute dtype. The fp32 masters are cast to the
compute dtype inside the autograd graph (:func:`cast_params`), so a
backward lands its gradients on the masters, as JAX's ``.astype`` does.
"""

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import attention as attn_lib
from .. import device as device_lib
from ..ops.flash_attention import flash_attention

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX ``Config``'s fields. MoE, pipeline stages and ring
    attention are refused (``NotImplementedError``) until their slice of
    the port. ``remat`` (default True, as in JAX) recomputes each
    layer's activations in the backward
    (``torch.utils.checkpoint``); it changes nothing without one."""
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 0          # 0 → = n_heads (no GQA)
    d_ff: int = 0                # 0 → swiglu default, rounded to 256
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    attention: str = "flash"     # dense | flash
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
        if self.moe_experts:
            raise NotImplementedError(
                "mixture-of-experts layers are not ported yet")
        if self.pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline parallelism is not ported yet")
        if self.attention not in ("dense", "flash"):
            raise NotImplementedError(
                f"attention={self.attention!r} is not ported yet "
                f"(dense | flash)")
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
    return {
        "attn_norm": (d,),
        "wq": (d, h, hd),
        "wk": (d, kv, hd),
        "wv": (d, kv, hd),
        "wo": (h, hd, d),
        "mlp_norm": (d,),
        "w_gate": (d, f),
        "w_up": (d, f),
        "w_down": (f, d),
    }


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
            layers[name] = normal(full, shape[0] ** -0.5)
    params["layers"] = layers
    return {k: ({n: t.to(dev) for n, t in v.items()}
                if isinstance(v, dict) else v.to(dev))
            for k, v in params.items()}


def cast_params(params, dtype, device=None):
    """fp32 masters → compute dtype, once. JAX casts at every use
    (``.astype(dt)``); casting once at load gives the same values."""
    def cast(t):
        return t.to(device=device or t.device, dtype=dtype)
    return {k: ({n: cast(t) for n, t in v.items()}
                if isinstance(v, dict) else cast(v))
            for k, v in params.items()}


def layer_params(params, i):
    """Layer ``i``'s weights as views of the stacked tensors, the
    projections flattened to 2-D for ``torch.matmul``."""
    lp = {k: v[i] for k, v in params["layers"].items()}
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
    kernel reads kv head ``h // n_rep`` itself)."""
    if config.attention == "flash":
        return flash_attention(q, k, v, causal=True)[0]
    n_rep = config.n_heads // config.kv_heads
    return attn_lib.dense_attention(
        q, attn_lib.repeat_kv(k, n_rep), attn_lib.repeat_kv(v, n_rep),
        causal=True)


def layer_core(x, lp, attend, config):
    """The transformer layer with attention abstracted — ``attend(q, k,
    v) → (o, extra)`` gets the projected (pre-RoPE) heads. Shared by
    :func:`apply` and the generation engine's prefill and decode, so the
    cached paths cannot drift from the model."""
    B, S, d = x.shape
    hd = config.head_dim
    h = _rmsnorm(x, lp["attn_norm"])
    q = torch.matmul(h, lp["wq"]).view(B, S, config.n_heads, hd)
    k = torch.matmul(h, lp["wk"]).view(B, S, config.kv_heads, hd)
    v = torch.matmul(h, lp["wv"]).view(B, S, config.kv_heads, hd)
    o, extra = attend(q, k, v)
    x = x + torch.matmul(o.reshape(B, S, -1), lp["wo"])
    h = _rmsnorm(x, lp["mlp_norm"])
    gate = torch.matmul(h, lp["w_gate"])
    up = torch.matmul(h, lp["w_up"])
    return x + torch.matmul(F.silu(gate) * up, lp["w_down"]), extra


def _layer(lp, x, rope, config):
    cos, sin = rope

    def attend(q, k, v):
        return _attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin),
                          v, config), None

    return layer_core(x, lp, attend, config)[0]


def backbone(params, tokens, config):
    """tokens [B, S] int → final-norm hidden states [B, S, D]. With
    ``config.remat`` and autograd recording, each layer is a
    non-reentrant checkpoint (``jax.checkpoint``, :545): its activations
    are recomputed in the backward instead of kept."""
    p = cast_params(params, config.compute_dtype)
    x = p["embed"][tokens.long()]
    positions = torch.arange(tokens.shape[1], device=x.device)
    rope = rope_tables(config, positions)
    remat = config.remat and torch.is_grad_enabled()
    for i in range(config.n_layers):
        lp = layer_params(p, i)
        if remat:
            x = checkpoint(_layer, lp, x, rope, config, use_reentrant=False)
        else:
            x = _layer(lp, x, rope, config)
    return _rmsnorm(x, p["final_norm"])


def _logits(x, head):
    """fp32 logits from compute-dtype operands: both widened exactly, so
    the product sums in fp32 like JAX's ``preferred_element_type`` (with
    TF32 off, which is PyTorch's default for matmuls)."""
    return torch.matmul(x.float(), head.float())


def apply(params, tokens, config):
    """tokens [B, S] int → logits [B, S, vocab] fp32."""
    x = backbone(params, tokens, config)
    return _logits(x, params["head"].to(config.compute_dtype))


def loss_fn(params, batch, config):
    """batch: ``{tokens [B, S], targets [B, S], mask [B, S] optional}``
    (tensors on the params' device) → ``(loss, metrics)``.

    Cross entropy in fp32 with z-loss ``1e-4·logz²`` against logit
    drift, over the masked positions (``transformer.py:589-621``). With
    ``config.chunked_ce`` the fp32 ``[B, S, V]`` logits are never formed
    (``ops/cross_entropy.py``). ``metrics`` (``loss``, ``accuracy``,
    ``perplexity``) are detached 0-d tensors: reading one waits for the
    device."""
    targets = batch["targets"].long()
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32,
                       device=targets.device)
            if mask is None else mask.float())
    x = backbone(params, batch["tokens"], config)
    head = params["head"].to(config.compute_dtype)
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
    denom = mask.sum().clamp_min(1.0)
    loss = ((nll + z_loss) * mask).sum() / denom
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "accuracy": ((pred == targets) * mask).sum() / denom,
            "perplexity": torch.exp((nll * mask).sum() / denom)}
    return loss, metrics


def flops_per_token(config):
    """Analytic 6ND forward+backward FLOPs per token (MFU accounting),
    the JAX package's formula (``transformer.py:624-635``)."""
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
