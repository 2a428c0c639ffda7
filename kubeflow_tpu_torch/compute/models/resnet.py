"""ResNet-50 — the package's headline vision workload. Functional NHWC
implementation.

Port of ``kubeflow_tpu/compute/models/resnet.py``. The parameter and
batch-statistics trees keep JAX's layout (conv weights HWIO ``[kh, kw,
in, out]``, ``stages`` a list of lists of per-block dicts), so weights
cross with ``params.tree_from_jax``. Activations stay NHWC in memory:
an NHWC-contiguous tensor permuted to ``[N, C, H, W]`` IS a
``channels_last`` tensor, so the convolutions (cuDNN through
``F.conv2d``; XLA's in JAX, outside any hand-written kernel) need no
copy, and ``ops.fused_block`` (K8) takes the activation as it is.

What differs from PyTorch's habits and is kept as in JAX:

- XLA's ``"SAME"`` padding, which for stride 2 on an even plane pads one
  pixel more at the high end than at the low end (``F.pad`` + a conv
  with no padding of its own);
- batch norm (:func:`_bn`) with one-pass fp32 statistics, the biased
  variance in the running average, momentum on the OLD value, and the
  normalise as one multiply-add in the compute dtype.

bf16 conv compute with fp32 BN statistics and master weights.

Batch norm reduces over the GLOBAL batch, as JAX's does under a data
mesh (XLA inserts the psum: sync BN). The forward therefore runs a
batch held in pieces — one on one device, a mesh's on their positions'
devices — through each layer together: :func:`_bn_pieces` sums each piece's
Σx, Σx² and count in piece order on the first piece's device and hands
the global mean and variance back to every piece, differentiably. On a
training mesh (:func:`loss_fn` given ``sharding.Sharded`` params and
statistics; every leaf replicated, JAX's :func:`logical_axes`) each
position's copy of the running statistics moves by those global values,
so the copies stay equal. On a mesh across processes (``make_mesh(
group=)``) the two sums are summed over the gang as well, in one
collective whose backward sums the moments' gradients over the gang
(``mesh.global_sum_synced``; ``torch.nn.SyncBatchNorm`` does the same):
every process's output depends on every process's rows, so each
process's gradient needs the others' terms through the moments.
"""

import dataclasses
import functools

import torch
import torch.nn.functional as F

from .. import device as device_lib
from .. import mesh as mesh_lib
from .. import sharding

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BOTTLENECK = {50, 101, 152}


@dataclasses.dataclass(frozen=True)
class Config:
    depth: int = 50
    n_classes: int = 1000
    width: int = 64
    dtype: str = "bfloat16"
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    # Space-to-depth stem: rearrange [B,224,224,3]→[B,112,112,12] and run
    # the 7×7/s2 stem conv as an exactly-equivalent 4×4/s1 conv over the
    # packed input (four times the contraction width for the same math).
    # Weights stay stored as [7,7,3,64] — the rearrangement happens at
    # apply time, so checkpoints are layout-independent.
    stem_s2d: bool = True

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)


def _block_channels(config, stage):
    base = config.width * (2 ** stage)
    if config.depth in BOTTLENECK:
        return base, base * 4
    return base, base


def init_params(config, generator=None, *, device=None):
    """Returns ``(params, batch_stats)`` in the JAX layout, fp32, drawn
    on the CPU from ``generator`` (a fresh one seeded 0 when None) and
    moved to ``device`` (None → the card). The same scheme as JAX
    ``init_params`` — He-normal convs, ones/zeros for BN with the last
    BN scale of every block zero, a projection on the first block of a
    stage — but not the same numbers."""
    dev = device_lib.resolve(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def conv(shape):
        fan_in = shape[0] * shape[1] * shape[2]
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * (2 / fan_in) ** 0.5).to(dev)

    def bn(ch, zero_scale=False):
        scale = torch.zeros if zero_scale else torch.ones
        return {"scale": scale((ch,), device=dev),
                "bias": torch.zeros((ch,), device=dev)}

    def bn_stats(ch):
        return {"mean": torch.zeros((ch,), device=dev),
                "var": torch.ones((ch,), device=dev)}

    bottleneck = config.depth in BOTTLENECK
    params = {"stem": {"conv": conv((7, 7, 3, config.width)),
                       "bn": bn(config.width)}}
    stats = {"stem": {"bn": bn_stats(config.width)}}
    in_ch = config.width
    stages, sstages = [], []
    for stage, n_blocks in enumerate(STAGE_BLOCKS[config.depth]):
        mid, out = _block_channels(config, stage)
        blocks, sblocks = [], []
        for b in range(n_blocks):
            bp, bs = {}, {}
            if bottleneck:
                shapes = [(1, 1, in_ch, mid), (3, 3, mid, mid),
                          (1, 1, mid, out)]
            else:
                shapes = [(3, 3, in_ch, mid), (3, 3, mid, out)]
            for i, shape in enumerate(shapes):
                bp[f"conv{i}"] = conv(shape)
                bp[f"bn{i}"] = bn(shape[-1],
                                  zero_scale=(i == len(shapes) - 1))
                bs[f"bn{i}"] = bn_stats(shape[-1])
            if b == 0 and (in_ch != out or stage > 0):
                bp["proj"] = conv((1, 1, in_ch, out))
                bp["proj_bn"] = bn(out)
                bs["proj_bn"] = bn_stats(out)
            blocks.append(bp)
            sblocks.append(bs)
            in_ch = out
        stages.append(blocks)
        sstages.append(sblocks)
    params["stages"] = stages
    stats["stages"] = sstages
    params["fc"] = {
        "w": (torch.randn((in_ch, config.n_classes), generator=generator,
                          dtype=torch.float32) * in_ch ** -0.5).to(dev),
        "b": torch.zeros((config.n_classes,), device=dev)}
    return params, stats


def _same_pad(n, k, stride):
    """XLA's ``"SAME"`` padding of one spatial dim → ``(low, high)``:
    the output has ``ceil(n / stride)`` positions, the total padding is
    split with the odd pixel at the HIGH end."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv_nhwc(x, w, stride, pad_h, pad_w):
    """``lax.conv_general_dilated`` on NHWC x and HWIO w with explicit
    ``(low, high)`` paddings: ``F.pad`` (it may be asymmetric), then a
    conv with no padding of its own on the channels-last view."""
    if any(pad_h) or any(pad_w):
        x = F.pad(x, (0, 0, *pad_w, *pad_h))
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def _conv(x, w, stride=1, dtype=None):
    """``"SAME"`` convolution, NHWC × HWIO → NHWC in ``dtype``."""
    return _conv_nhwc(x.to(dtype), w.to(dtype), stride,
                      _same_pad(x.shape[1], w.shape[0], stride),
                      _same_pad(x.shape[2], w.shape[1], stride))


def _space_to_depth(x):
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def _stem_s2d_weights(w):
    """[7,7,Cin,Cout] → [4,4,4·Cin,Cout]: exact phase decomposition of a
    7×7/stride-2 kernel over 2×2 space-to-depth input. With SAME
    padding (2 low, 3 high) out[m] reads original rows 2m−2…2m+4 = s2d
    rows m−1…m+2 at phases a∈{0,1}, i.e. tap p = 2r+a for r∈0…3 — pad
    one zero row/col at the end so the (r,a) unfold is a plain reshape."""
    cin, cout = w.shape[2], w.shape[3]
    w = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))                    # [8,8,ci,co]
    k = w.reshape(4, 2, 4, 2, cin, cout)                      # [r,a,s,b,..]
    return k.permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * cin, cout)


def _stem(x, w, config, dt):
    if config.stem_s2d and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
        xs = _space_to_depth(x)
        ws = _stem_s2d_weights(w)
        # output m ← s2d rows m−1…m+2: explicit (1,2) padding, stride 1
        return _conv_nhwc(xs.to(dt), ws.to(dt), 1, (1, 2), (1, 2))
    return _conv(x, w, 2, dt)


def _replicated(tree):
    """Every leaf's logical axes, all None."""
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replicated(v) for v in tree]
    return (None,) * len(tree.shape)


def logical_axes(config):
    """``(params axes, statistics axes)``: every leaf replicated, JAX's
    (:110; the weights are small next to the activations)."""
    params, stats = init_params(config, device="meta")
    return _replicated(params), _replicated(stats)


def _bn_pieces(xs, bps, bss, config, train, gang=None):
    """Batch norm as the JAX package computes it, over a batch in pieces
    (``xs``; one piece is one device's batch) → ``(ys, moments)``:
    one-pass fp32 statistics (E[x], E[x²], the variance clamped at 0)
    over batch and space — each piece's sums added in piece order on the
    first piece's device —, then the normalise folded to one
    multiply-add ``x*scale'+bias'`` in x's dtype, each piece with its
    params ``bps`` (in eval: its running statistics ``bss``). Gradients
    flow through the batch statistics. ``moments`` is ``{"mean",
    "var"}`` of the global batch (train) or None. ``gang`` (a mesh
    across processes, or None) sums the two ``[C]`` sums over its
    processes in one stacked ``[2, C]`` collective whose backward sums
    too, and counts the gang's elements."""
    if train:
        dev = xs[0].device
        xfs = [x.float() for x in xs]
        n = sum(x.shape[0] * x.shape[1] * x.shape[2] for x in xs)

        def total(parts):
            return functools.reduce(torch.add, (t.to(dev) for t in parts))

        s1 = total([xf.sum(dim=(0, 1, 2)) for xf in xfs])
        s2 = total([(xf * xf).sum(dim=(0, 1, 2)) for xf in xfs])
        if gang is not None and gang.process_count > 1:
            s1, s2 = mesh_lib.global_sum_synced(torch.stack([s1, s2]), gang)
            n *= gang.process_count
        m1, m2 = s1 / n, s2 / n
        moments = {"mean": m1, "var": torch.clamp_min(m2 - m1 * m1, 0.0)}
        stats = [moments] * len(xs)
    else:
        moments, stats = None, bss
    ys = []
    for x, bp, st in zip(xs, bps, stats):
        mean, var = st["mean"].to(x.device), st["var"].to(x.device)
        scale = bp["scale"] * torch.rsqrt(var + config.bn_eps)  # [C] fp32
        bias = bp["bias"] - mean * scale
        ys.append(x * scale.to(x.dtype) + bias.to(x.dtype))
    return ys, moments


def _bn(x, bp, bs, config, train):
    """:func:`_bn_pieces` on one device → ``(y, new stats)``."""
    ys, moments = _bn_pieces([x], [bp], [bs], config, train)
    return ys[0], _moved(bs, moments, config)


def _moved(stats, moments, config):
    """Running statistics moved by a batch's moments: the BIASED
    variance, ``bn_momentum`` on the old value (eval: unchanged)."""
    if moments is None:
        return stats
    mom = config.bn_momentum

    def move(old, new):
        if isinstance(old, dict):
            return {k: move(old[k], new[k]) for k in old}
        if isinstance(old, list):
            return [move(o, n) for o, n in zip(old, new)]
        return mom * old + (1 - mom) * new.to(old.device)

    return move(stats, moments)


def _blocks(xs, bps, bss, config, stride, train, gang=None):
    """One block over a batch in pieces (each piece's params ``bps``,
    statistics ``bss``; ``gang`` as :func:`_bn_pieces` takes it) →
    ``(ys, the block's moments)``."""
    dt = config.compute_dtype
    bottleneck = config.depth in BOTTLENECK
    moments = {}
    n_convs = 3 if bottleneck else 2
    hs = xs
    for i in range(n_convs):
        s = stride if i == (1 if bottleneck else 0) else 1
        hs = [_conv(h, bp[f"conv{i}"], s, dt) for h, bp in zip(hs, bps)]
        hs, moments[f"bn{i}"] = _bn_pieces(hs, [bp[f"bn{i}"] for bp in bps],
                                    [bs[f"bn{i}"] for bs in bss], config,
                                    train, gang)
        if i < n_convs - 1:
            hs = [torch.relu(h) for h in hs]
    residuals = xs
    if "proj" in bps[0]:
        residuals = [_conv(x, bp["proj"], stride, dt)
                     for x, bp in zip(xs, bps)]
        residuals, moments["proj_bn"] = _bn_pieces(
            residuals, [bp["proj_bn"] for bp in bps],
            [bs["proj_bn"] for bs in bss], config, train, gang)
    return ([torch.relu(h + r.to(h.dtype)) for h, r in zip(hs, residuals)],
            moments)


def _block(x, bp, bs, config, stride, train):
    """One block on one device → ``(y, its new statistics)``."""
    ys, moments = _blocks([x], [bp], [bs], config, stride, train)
    new = {k: (_moved(bs[k], m, config) if m is not None else bs[k])
           for k, m in moments.items()}
    return ys[0], new


def block_stride(stage, block):
    """The stride of block ``block`` of stage ``stage``: 2 on the first
    block of every stage after the first."""
    return 2 if (stage > 0 and block == 0) else 1


def _trunks_in(params, stats, xs, config, train, gang=None):
    """Stem conv → BN → relu → 3×3/2 max pool (SAME: −inf padding, the
    odd pixel high) over a batch in pieces (``gang`` as
    :func:`_bn_pieces` takes it) → ``(hs, the stem's moments)``."""
    dt = config.compute_dtype
    hs = [_stem(x, p["stem"]["conv"], config, dt)
          for x, p in zip(xs, params)]
    hs, moments = _bn_pieces(hs, [p["stem"]["bn"] for p in params],
                      [st["stem"]["bn"] for st in stats], config, train,
                      gang)
    out = []
    for h in hs:
        h = torch.relu(h)
        pad_h = _same_pad(h.shape[1], 3, 2)
        pad_w = _same_pad(h.shape[2], 3, 2)
        h = F.pad(h, (0, 0, *pad_w, *pad_h), value=float("-inf"))
        out.append(
            F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1))
    return out, moments


def _trunk_in(params, stats, x, config, train):
    """:func:`_trunks_in` on one device → ``(h, the stem's new BN
    stats)``."""
    hs, moments = _trunks_in([params], [stats], [x], config, train)
    return hs[0], _moved(stats["stem"]["bn"], moments, config)


def _head(params, h):
    """fp32 mean pool over space, then the fp32 classifier."""
    h = h.float().mean(dim=(1, 2))
    return h @ params["fc"]["w"] + params["fc"]["b"]


def _forward(params, stats, xs, config, train, gang=None):
    """The network over a batch in pieces (each piece's params and
    statistics; ``gang`` as :func:`_bn_pieces` takes it) → ``(logits
    per piece, the batch's moments)`` (moments None in eval)."""
    hs, stem = _trunks_in(params, stats, xs, config, train, gang)
    moments = {"stem": {"bn": stem}, "stages": []}
    for stage, blocks in enumerate(params[0]["stages"]):
        per_block = []
        for b in range(len(blocks)):
            hs, m = _blocks(hs, [p["stages"][stage][b] for p in params],
                            [st["stages"][stage][b] for st in stats],
                            config, block_stride(stage, b), train, gang)
            per_block.append(m)
        moments["stages"].append(per_block)
    return ([_head(p, h) for p, h in zip(params, hs)],
            moments if train else None)


def apply(params, stats, x, config, train=True):
    """x [B,H,W,3] → (logits fp32 [B,n_classes], new_stats)."""
    logits, moments = _forward([params], [stats], [x], config, train)
    return logits[0], _moved(stats, moments, config)


def loss_fn(params, stats, batch, config, train=True):
    """Mean cross entropy and accuracy → ``(loss, (metrics,
    new_stats))``; on a mesh (params and statistics placed by
    ``train.init_state(mesh=)``) those of the global batch, sync BN. On
    a mesh across processes the BN moments and the loss and accuracy
    sums are the gang's: every process reports the gang's loss, its
    statistics move by the gang's moments (so they stay byte-equal),
    and its gradient is its own share of the gang's, the cross terms
    through the moments included."""
    mesh = sharding.mesh_of(params)
    if mesh is not None:
        return _mesh_loss(params, stats, batch, config, train, mesh)
    logits, new_stats = apply(params, stats, batch["image"], config, train)
    labels = batch["label"].long()
    nll = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    loss = nll.mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, ({"loss": loss, "accuracy": acc}, new_stats)


def _mesh_loss(params, stats, batch, config, train, mesh):
    """:func:`loss_fn` on a mesh: every batch piece through each layer
    together on its lead position, with that position's copies of the
    params and statistics; then each position's statistics moved by the
    global moments (on a gang of processes, the gang's)."""
    sharding.check_layout(params, _replicated(params), "ResNet params")
    sharding.check_layout(stats, _replicated(stats), "ResNet statistics")
    leads = mesh.along(0, (mesh_lib.DATA, mesh_lib.FSDP))
    logits, moments = _forward(
        [sharding.local(params, q) for q in leads],
        [sharding.local(stats, q) for q in leads],
        [batch["image"].pieces[q] for q in leads], config, train, mesh)
    dev = mesh.devices[0]
    nll, correct, rows = [], [], 0
    for q, lg in zip(leads, logits):
        labels = batch["label"].pieces[q].long()
        nll.append((-F.log_softmax(lg, dim=-1).gather(
            1, labels[:, None])[:, 0]).sum().to(dev))
        correct.append((lg.argmax(-1) == labels).float().sum().to(dev))
        rows += labels.shape[0]
    rows *= mesh.process_count
    loss = mesh_lib.global_sum(functools.reduce(torch.add, nll), mesh) / rows
    acc = mesh_lib.global_sum(functools.reduce(torch.add, correct),
                              mesh) / rows
    new_stats = stats
    if moments is not None:
        new_stats = sharding.from_local(
            [_moved(sharding.local(stats, q), moments, config)
             for q in range(mesh.size)], stats)
    return loss, ({"loss": loss, "accuracy": acc}, new_stats)


def flops_per_sample(depth=50, image=224):
    """Analytic fwd+bwd FLOPs per 224px sample (for MFU): ResNet-50's
    forward is 4.09 GMACs = 8.2 GFLOPs (the paper's "3.8/4.1 billion
    FLOPs" counts a multiply-add as one op); training ≈ 3× the forward.
    The figure is the analytic one for every depth and image size, as in
    the JAX package."""
    return 3 * 2 * 4.09e9
