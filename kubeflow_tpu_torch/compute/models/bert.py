"""BERT — bidirectional encoder with MLM pretraining loss.

Port of ``kubeflow_tpu/compute/models/bert.py``. Same functional
conventions as ``transformer.py``; differences: bidirectional
(non-causal) flash attention — K3 forward with K4/K5 behind it, at
head_dim 64 for bert-base —, learned position embeddings, GELU MLP (the
tanh approximation, ``jax.nn.gelu``'s default), LayerNorm (not RMS),
tied MLM head over the embedding table. The params keep JAX's layout;
``layers`` may be the stacked dict (leading layer dim, JAX's
``scan_layers=True``) or the per-layer list. ``logical_axes`` is JAX's
(:72).

On a training mesh (:func:`loss_fn` given ``sharding.Sharded`` params)
each batch piece's layers run over its ``tensor`` positions: each holds
its heads of wq/wk/wv with their biases, its rows of wo, its columns of
w_up/b_up and its rows of w_down (gathered over ``fsdp``); the row
partials are summed in position order on the piece's lead position,
and ``bo``/``b_down`` added once, after the sum. The tied embedding and
``mlm_bias`` are gathered whole there (JAX's one-hot ``embed_lookup``
is exact, so a plain index matches it). The loss is the global batch's:
the pieces' masked nll sums and masked-token counts, each summed, then
divided. The ``sequence`` axis cuts each piece's sequence into chunks,
each with its own copy of the embeddings (``pos_embed`` at the chunk's
global rows); a head group's attention runs over the chunks, on the
ring for ``attention="ring"`` (non-causal) or over the whole sequence
joined for dense and flash. The MLM head reads whole sequences (its
positions index the full sequence), so the chunks are joined on the
piece's lead before it, as XLA gathers a sequence-cut dim for
``take_along_axis``. BERT has no pipeline (JAX's neither): a
``pipeline`` axis larger than 1 is refused.

bert-base = Config(vocab_size=30522, d_model=768, n_layers=12,
n_heads=12, d_ff=3072, max_seq=512).
"""

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import attention as attn_lib
from .. import device as device_lib
from .. import mesh as mesh_lib
from .. import sharding
from ..ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class Config:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 512
    type_vocab: int = 2
    dtype: str = "bfloat16"
    attention: str = "flash"    # dense | flash | ring (non-causal,
    #                             over the mesh's sequence axis)
    remat: bool = True
    scan_layers: bool = True
    ln_eps: float = 1e-12
    #: MLM head evaluated only at up to this many masked positions per
    #: sequence (standard max_predictions_per_seq) — the [B,S,vocab]
    #: logits tensor never materializes
    max_predictions: int = 80

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)


def _layer_shapes(c):
    d, h, hd, f = c.d_model, c.n_heads, c.head_dim, c.d_ff
    return {
        "ln1_scale": (d,), "ln1_bias": (d,),
        "wq": (d, h, hd), "wk": (d, h, hd), "wv": (d, h, hd),
        "bq": (h, hd), "bk": (h, hd), "bv": (h, hd),
        "wo": (h, hd, d), "bo": (d,),
        "ln2_scale": (d,), "ln2_bias": (d,),
        "w_up": (d, f), "b_up": (f,),
        "w_down": (f, d), "b_down": (d,),
    }


#: each layer leaf's logical axes (JAX ``_layer_shapes``' second element)
_LAYER_AXES = {
    "ln1_scale": (None,), "ln1_bias": (None,),
    "wq": ("embed", "heads", None), "wk": ("embed", "heads", None),
    "wv": ("embed", "heads", None),
    "bq": ("heads", None), "bk": ("heads", None), "bv": ("heads", None),
    "wo": ("heads", None, "embed"), "bo": (None,),
    "ln2_scale": (None,), "ln2_bias": (None,),
    "w_up": ("embed", "mlp"), "b_up": ("mlp",),
    "w_down": ("mlp", "embed"), "b_down": (None,),
}


def logical_axes(config):
    """The params tree's logical axes (JAX ``logical_axes``, :72): the
    stacked layout's layer leaves lead with ``"layers"``; with
    ``scan_layers=False`` the layers are a per-layer list."""
    prefix = ("layers",) if config.scan_layers else ()
    layers = {k: prefix + ax for k, ax in _LAYER_AXES.items()}
    if not config.scan_layers:
        layers = [layers] * config.n_layers
    return {
        "embed": ("vocab", "embed"),
        "pos_embed": (None, "embed"),
        "type_embed": (None, "embed"),
        "embed_ln_scale": (None,), "embed_ln_bias": (None,),
        "layers": layers,
        "mlm_ln_scale": (None,), "mlm_ln_bias": (None,),
        "mlm_dense": ("embed", None),
        "mlm_bias": ("vocab",),
    }


def init_params(config, generator=None, *, device=None):
    """Random fp32 masters in the JAX layout, drawn on the CPU from
    ``generator`` (a fresh one seeded 0 when None), on ``device`` (None →
    the card): embeddings N(0, 0.02²), matrices N(0, 1) · fan-in^-1/2,
    ones for the norm scales, zeros for every bias. JAX's scheme, not
    its numbers. ``scan_layers`` picks the stacked or the per-layer
    layout of ``layers``."""
    dev = device_lib.resolve(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    c = config

    def normal(shape, std):
        return (torch.randn(shape, generator=generator,
                            dtype=torch.float32) * std).to(dev)

    params = {
        "embed": normal((c.vocab_size, c.d_model), 0.02),
        "pos_embed": normal((c.max_seq, c.d_model), 0.02),
        "type_embed": normal((c.type_vocab, c.d_model), 0.02),
        "embed_ln_scale": torch.ones((c.d_model,), device=dev),
        "embed_ln_bias": torch.zeros((c.d_model,), device=dev),
        "mlm_ln_scale": torch.ones((c.d_model,), device=dev),
        "mlm_ln_bias": torch.zeros((c.d_model,), device=dev),
        "mlm_dense": normal((c.d_model, c.d_model), c.d_model ** -0.5),
        "mlm_bias": torch.zeros((c.vocab_size,), device=dev),
    }

    def layer_params():
        out = {}
        for name, shape in _layer_shapes(c).items():
            if name.startswith(("ln", "b")) or len(shape) == 1:
                init = torch.ones if "scale" in name else torch.zeros
                out[name] = init(shape, dtype=torch.float32, device=dev)
            else:
                out[name] = normal(shape, shape[0] ** -0.5)
        return out

    layers = [layer_params() for _ in range(c.n_layers)]
    if c.scan_layers:
        layers = {k: torch.stack([lp[k] for lp in layers])
                  for k in layers[0]}
    params["layers"] = layers
    return params


def _ln(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _attention(q, k, v, config):
    """Non-causal attention of one head group; ``"ring"`` on one device
    is the ring of one position."""
    if config.attention == "ring":
        return _ring([q], [k], [v])[0]
    if config.attention == "flash":
        return flash_attention(q, k, v, causal=False)[0]
    return attn_lib.dense_attention(q, k, v, causal=False)


def _ring(qs, ks, vs):
    return attn_lib.ring_attention(qs, ks, vs, causal=False)


def _layer(sps, xs, devices, config):
    """One encoder layer over its shards: ``xs`` the residual stream's
    sequence chunks (one on one device), chunk ``j`` on its lead, the
    device of its first shard; ``sps`` each shard's layer params on
    ``devices``, chunk-major (chunk ``j``'s ``tensor`` shards at
    ``j·tp … j·tp + tp - 1``; one: the whole layer on x's device). Each
    shard projects its heads and MLP columns; each head group attends
    over the chunks (:func:`attention.over_chunks`); the row partials
    (wo, w_down) are summed in shard order on the chunk's lead, then the
    replicated biases added once → the new chunks."""
    dt = config.compute_dtype
    tp = len(sps) // len(xs)
    groups = [range(j * tp, (j + 1) * tp) for j in range(len(xs))]

    def rows(parts, x):
        return functools.reduce(torch.add, (p.to(x.device) for p in parts))

    heads = []
    for x, group in zip(xs, groups):
        for i in group:
            lp, h = sps[i], x.to(devices[i])
            heads.append(tuple(
                torch.einsum("bsd,dhk->bshk", h, lp[w].to(dt))
                + lp[b].to(dt)
                for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))))
    outs = attn_lib.over_chunks(
        heads, len(xs), lambda q, k, v: _attention(q, k, v, config),
        _ring if config.attention == "ring" else None)
    new = []
    for x, group in zip(xs, groups):
        lead = sps[group[0]]
        o = rows([torch.einsum("bshk,hkd->bsd", outs[i], sps[i]["wo"].to(dt))
                  for i in group], x) + lead["bo"].to(dt)
        x = _ln(x + o, lead["ln1_scale"].to(dt), lead["ln1_bias"].to(dt),
                config.ln_eps)
        downs = []
        for i in group:
            lp, h = sps[i], x.to(devices[i])
            up = torch.einsum("bsd,df->bsf", h, lp["w_up"].to(dt)) \
                + lp["b_up"].to(dt)
            downs.append(torch.einsum("bsf,fd->bsd", _gelu(up),
                                      lp["w_down"].to(dt)))
        down = rows(downs, x) + lead["b_down"].to(dt)
        new.append(_ln(x + down, lead["ln2_scale"].to(dt),
                       lead["ln2_bias"].to(dt), config.ln_eps))
    return new


def _layers(params):
    """The per-layer dicts of either layout of ``params["layers"]``."""
    layers = params["layers"]
    if isinstance(layers, dict):
        n = next(iter(layers.values())).shape[0]
        return [{k: v[i] for k, v in layers.items()} for i in range(n)]
    return layers


def _embed(params, tokens, config, token_types=None, offset=0):
    """The embeddings of tokens [B,S] at sequence positions ``offset +
    arange(S)``, layer-normed → [B,S,D]."""
    dt = config.compute_dtype
    x = params["embed"].to(dt)[tokens.long()]
    x = x + params["pos_embed"][offset:offset + tokens.shape[1]].to(dt)
    if token_types is not None:
        x = x + params["type_embed"].to(dt)[token_types.long()]
    return _ln(x, params["embed_ln_scale"].to(dt),
               params["embed_ln_bias"].to(dt), config.ln_eps)


def _encoder(xs, layers, devices, config):
    """The layers over sequence chunks ``xs`` (:func:`_layer`; ``layers``
    each layer's list of its shards' params on ``devices``). With
    ``remat`` and autograd recording, each layer is a non-reentrant
    checkpoint (``jax.checkpoint``): its activations are recomputed in
    the backward."""
    remat = config.remat and torch.is_grad_enabled()
    for sps in layers:
        if remat:
            xs = checkpoint(_layer, sps, xs, devices, config,
                            use_reentrant=False)
        else:
            xs = _layer(sps, xs, devices, config)
    return xs


def encode(params, tokens, config, token_types=None):
    """tokens [B,S] → hidden states [B,S,D]."""
    x = _embed(params, tokens, config, token_types)
    return _encoder([x], [[lp] for lp in _layers(params)], [x.device],
                    config)[0]


def mlm_head(params, x, config):
    """Vocab logits for selected hidden states [B,P,d] → [B,P,vocab]
    fp32 (tied to the embedding table; fp32 sums of compute-dtype
    operands)."""
    dt = config.compute_dtype
    x = _gelu(torch.einsum("bsd,de->bse", x, params["mlm_dense"].to(dt)))
    x = _ln(x, params["mlm_ln_scale"].to(dt), params["mlm_ln_bias"].to(dt),
            config.ln_eps)
    # both operands widened exactly, so the product sums in fp32 like
    # JAX's preferred_element_type (TF32 off, PyTorch's matmul default)
    logits = torch.einsum("bsd,vd->bsv", x.float(),
                          params["embed"].to(dt).float())
    return logits + params["mlm_bias"]


def apply(params, tokens, config, token_types=None):
    """Full-sequence MLM logits [B,S,vocab] fp32 (inference surface;
    training gathers masked positions first — see loss_fn)."""
    return mlm_head(params, encode(params, tokens, config, token_types),
                    config)


def _loss_terms(params, x, batch, config):
    """Hidden states → the masked nll sum (under autograd), the masked
    correct count and the masked-token count. The MLM head runs only on
    the (up to max_predictions) masked positions per sequence — the
    [B,S,vocab] tensor never exists (the published recipe's
    max_predictions_per_seq). The masked positions come first under a
    STABLE descending sort of the mask, as in JAX, so both pick the same
    weight-0 positions as padding."""
    weights = batch["mask"].float()
    p = min(config.max_predictions, config.max_seq)
    idx = torch.argsort(-weights, dim=1, stable=True)[:, :p]    # [B,P]
    x = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    targets = torch.gather(batch["targets"].long(), 1, idx)     # [B,P]
    weights = torch.gather(weights, 1, idx)                     # [B,P]
    logits = mlm_head(params, x, config)                        # [B,P,V]
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, 2, targets[..., None])[..., 0]
    nll = logz - label_logits
    return {"nll": (nll * weights).sum(), "count": weights.sum(),
            "correct": ((logits.argmax(-1) == targets) * weights).sum()}


def _finish(terms):
    denom = torch.clamp_min(terms["count"], 1.0)
    loss = terms["nll"] / denom
    acc = terms["correct"] / denom
    return loss, {"loss": loss, "mlm_accuracy": acc}


def loss_fn(params, batch, config):
    """batch: tokens (with [MASK] substitutions applied), targets
    (original ids), mask (1.0 where a token was masked-out for MLM).
    The loss is the masked nll sum over the masked-token count. Params
    placed on a mesh (``train.init_state(mesh=)``) and a batch from
    ``data.shard_batch`` run the mesh forward: the loss is then the
    global batch's, whatever each piece's count. On a mesh across
    processes the nll, count and accuracy sums are the gang's
    (``mesh.global_sum``): every process reports the gang's loss, and
    its gradient is its own share of the gang's."""
    mesh = sharding.mesh_of(params)
    if mesh is not None:
        return _mesh_loss(params, batch, config, mesh)
    x = encode(params, batch["tokens"], config, batch.get("token_types"))
    return _finish(_loss_terms(params, x, batch, config))


def _check_mesh(config, mesh):
    if mesh.shape[mesh_lib.PIPELINE] > 1:
        raise ValueError(f"BERT has no pipeline: the mesh's pipeline axis "
                         f"is {mesh.shape[mesh_lib.PIPELINE]}")
    tp, fsdp = mesh.shape[mesh_lib.TENSOR], mesh.shape[mesh_lib.FSDP]
    for name, value, axis, n in (
            ("n_heads", config.n_heads, "tensor", tp),
            ("d_ff", config.d_ff, "tensor", tp),
            ("vocab_size", config.vocab_size, "tensor", tp),
            ("d_model", config.d_model, "fsdp", fsdp)):
        if value % n:
            raise ValueError(f"{name}={value} does not divide over the "
                             f"mesh's {axis} axis of {n}")


def _mesh_loss(params, batch, config, mesh):
    """:func:`loss_fn` on a mesh → the global batch's ``(loss,
    metrics)`` on the first position's device, its sums the gang's."""
    _check_mesh(config, mesh)
    sharding.check_layout(params, logical_axes(config), "BERT")
    dt = config.compute_dtype

    def cast(t):
        return t.to(dt)

    def is_leaf(x):
        return isinstance(x, sharding.Sharded)

    n_seq = mesh.shape[mesh_lib.SEQUENCE]
    seq = batch["tokens"].shape[1]
    if seq % n_seq:
        raise ValueError(f"sequence length {seq} does not divide over the "
                         f"mesh's sequence axis of {n_seq}")
    chunk = seq // n_seq
    terms = []
    for lead in mesh.along(0, (mesh_lib.DATA, mesh_lib.FSDP)):
        leads = mesh.along(lead, mesh_lib.SEQUENCE)
        shards = [q for j in leads for q in mesh.along(j, mesh_lib.TENSOR)]
        per_shard = [_layers({"layers": sharding._map(
            lambda v, q=q: v.gather_at(q, (mesh_lib.FSDP,), cast),
            params["layers"], is_leaf=is_leaf)}) for q in shards]
        copies = [{k: v.gather_at(pos) for k, v in params.items()
                   if k != "layers"} for pos in leads]
        xs = []
        for j, (pos, mine) in enumerate(zip(leads, copies)):
            cut = {k: v.pieces[pos][:, j * chunk:(j + 1) * chunk]
                   for k, v in batch.items()
                   if k in ("tokens", "token_types")}
            xs.append(_embed(mine, cut["tokens"], config,
                             cut.get("token_types"), j * chunk))
        xs = _encoder(xs, list(map(list, zip(*per_shard))),
                      [mesh.devices[q] for q in shards], config)
        local = {k: v.pieces[lead] for k, v in batch.items()}
        x = xs[0] if n_seq == 1 else torch.cat(
            [x.to(mesh.devices[lead]) for x in xs], dim=1)
        terms.append(_loss_terms(copies[0], x, local, config))
    dev = mesh.devices[0]
    return _finish({k: mesh_lib.global_sum(functools.reduce(
        torch.add, (t[k].to(dev) for t in terms)), mesh)
        for k in terms[0]})


def param_count(config):
    c = config
    per_layer = sum(int(np.prod(s)) for s in _layer_shapes(c).values())
    return (c.vocab_size * c.d_model + c.max_seq * c.d_model
            + c.type_vocab * c.d_model + 4 * c.d_model
            + c.d_model * c.d_model + c.vocab_size
            + c.n_layers * per_layer)


def flops_per_token(config):
    """6ND + attention matmul fwd+bwd FLOPs/token."""
    n = param_count(config)
    attn = 12 * config.n_layers * config.d_model * config.max_seq
    return 6 * n + attn


def mlm_batch(rng, batch_size, config, mask_prob=0.15, mask_id=103):
    """Synthetic MLM batch (benchmark/data-pipeline contract); numpy,
    the same numbers as the JAX package's for one ``rng``."""
    low = min(1000, config.vocab_size // 2)  # skip special-token range
    toks = rng.integers(low, config.vocab_size,
                        (batch_size, config.max_seq), dtype=np.int32)
    mask = rng.random((batch_size, config.max_seq)) < mask_prob
    inputs = np.where(mask, mask_id, toks).astype(np.int32)
    return {"tokens": inputs, "targets": toks,
            "mask": mask.astype(np.float32)}
