"""Training engine: init → train step → metrics, on one device or a
mesh.

Port of ``kubeflow_tpu/compute/train.py``. PyTorch runs eagerly, so the
step is a plain function: the loss and its gradients through autograd
(the attention backward through kernels K4 and K5), then the
optimizer's update applied to the parameters in place (JAX donates the
old state instead; updating in place keeps one copy of the masters and
the moments on the card).

On a mesh (``compute/mesh.py``; ``data``, ``fsdp``, ``tensor``,
``sequence`` and ``pipeline`` axes) the step is the one controller that
XLA's partitioner and the manual ``shard_map``s of ring attention and
the pipeline are in JAX.
``init_state(mesh=, logical_axes=)`` places the fp32 masters, the
moments and the model state as ``sharding.Sharded`` leaves, one copy of
its piece per position. The models' losses see the sharded tree and run
each position's share on its device (the gathers over ``fsdp`` and the
``tensor`` partials are ``.to()`` and ``torch.cat``/sums under
autograd, so their backward is the reduce-scatter and the psum), and
return the loss and metrics of the GLOBAL batch. The step then sums
each piece's gradient over its copies in position order, hands every
copy that sum, clips by the norm of the logical elements (each counted
once) and updates every copy with the same arithmetic: replicated
copies stay byte-equal. A copy the forward does not read (a
replicated pipeline's, with no stages) takes the sum of the others, as
JAX's psum hands it. A mesh over a gang of processes (``make_mesh(
group=)``) adds one step: each unique piece's gradient is summed over
the processes (``all_reduce``, a few flat buffers), so every process
applies the same bytes and its replicas stay byte-equal with the
others'.

Mixed precision: fp32 master weights (``state.params``), the compute
dtype cast inside the model's graph, fp32 gradients summed over
microbatches.

The optimizer is optax's ``chain(clip_by_global_norm(c), adamw(...))``
of ``make_optimizer`` (train.py:53-65) step for step, written out here
as a small functional AdamW over the parameter tree: the clip by
optax's formula (``g`` when ``‖g‖ < c``, else ``g / ‖g‖ · c``, not
``clip_grad_norm_``'s ``+1e-6``), decay on every leaf, and the learning
rate of update ``t`` taken from the schedule at the count BEFORE the
update, so with warmup the first update has rate 0.
"""

import dataclasses
import functools
import math

import torch

from . import data as data_lib
from . import device as device_lib
from . import sharding as sharding_lib


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict
    opt_state: dict
    extra: dict  # mutable model state (e.g. BN batch_stats); {} if none


# --------------------------------------------------------------- trees

def tree_leaves(tree):
    """The leaves of a tree of nested dicts, lists and tuples in JAX's
    pytree order: dict keys sorted, sequences by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of a tree of nested dicts, lists and tuples
    (and on the matching leaves of ``rest``, trees of the same
    structure) → a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


# ----------------------------------------------------------- optimizer

def warmup_cosine(peak, warmup_steps, total_steps):
    """``optax.warmup_cosine_decay_schedule(0, peak, …, end_value=0)`` as
    JAX's ``warmup_cosine`` builds it (train.py:39-50): a linear warmup
    from 0 joined to a cosine decay with alpha 0 → ``count ↦ rate``."""
    decay = max(total_steps, warmup_steps + 1) - warmup_steps

    def schedule(count):
        if count < warmup_steps:
            frac = 1 - max(count, 0) / warmup_steps
            return -peak * frac + peak
        c = min(count - warmup_steps, decay)
        return peak * (0.5 * (1 + math.cos(math.pi * c / decay)))

    return schedule


def global_norm(tensors):
    """``optax.global_norm``: the square root of the summed squares,
    fp32, on the first tensor's device (no host sync)."""
    dev = tensors[0].device
    return torch.sqrt(sum(t.float().square().sum().to(dev)
                          for t in tensors))


def clip_by_global_norm(grads, max_norm, norm=None):
    """``optax.clip_by_global_norm``'s update on a list of tensors →
    ``(clipped, norm)``: each ``g`` kept when ``‖g‖ < max_norm``, else
    ``(g / ‖g‖) · max_norm``, chosen on the device. ``norm`` (default
    the norm of ``grads``) is given where ``grads`` holds some elements
    more than once (a mesh's copies)."""
    if norm is None:
        norm = global_norm(grads)
    out = []
    for g in grads:
        n = norm.to(g.device)
        out.append(torch.where(n < max_norm, g, (g / n) * max_norm))
    return out, norm


class AdamW:
    """Global-norm clip + AdamW + a schedule, the update of
    ``optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, b1,
    b2, eps, weight_decay=…))``: in place (:meth:`update`, the train
    step's) or as a pure function of trees (:meth:`update_fn`, which the
    vectorized sweep maps over trials). The schedule's peak,
    ``weight_decay`` and ``clip_norm`` may be 0-d tensors.

    State: ``{"count": int, "mu": tree, "nu": tree}`` (fp32 moments in
    the params' layout)."""

    def __init__(self, schedule, b1, b2, eps, weight_decay, clip_norm):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params):
        def zeros(p):
            if isinstance(p, sharding_lib.Sharded):
                return p.map(zeros)
            return torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def _leaf(self, p, g, mu, nu, count):
        """One leaf's AdamW arithmetic at the pre-increment ``count`` →
        ``(the step to add to p, new mu, new nu)``."""
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g.square() + b2 * nu
        u = (mu / (1 - b1 ** (count + 1))) / (
            torch.sqrt(nu / (1 - b2 ** (count + 1))) + self.eps)
        u = u + self.weight_decay * p
        return (-self.schedule(count) * u).to(p.dtype), mu, nu

    @torch.no_grad()
    def update(self, params, grads, opt_state, unique=None):
        """One update of the ``params`` leaves (in place) from ``grads``
        (matching list of fp32 tensors) → the pre-clip global norm. On
        a mesh ``params`` and ``grads`` are every position's pieces and
        ``unique`` holds each logical element's gradient once, for the
        norm."""
        grads, norm = clip_by_global_norm(
            grads, self.clip_norm,
            None if unique is None else global_norm(unique))
        count = opt_state["count"]
        for p, g, mu, nu in zip(
                params, grads,
                sharding_lib.pieces_of(tree_leaves(opt_state["mu"])),
                sharding_lib.pieces_of(tree_leaves(opt_state["nu"]))):
            step, new_mu, new_nu = self._leaf(p, g, mu, nu, count)
            mu.copy_(new_mu)
            nu.copy_(new_nu)
            p.add_(step)
        opt_state["count"] = count + 1
        return norm

    def update_fn(self, params, grads, opt_state):
        """The same update as a pure function of trees: ``(params,
        grads, opt_state) → (new params, new opt_state, the pre-clip
        global norm)``; nothing is written in place, so it runs under
        ``torch.func.vmap``."""
        norm = global_norm(tree_leaves(grads))
        keep = norm < self.clip_norm
        count = opt_state["count"]
        stepped = tree_map(
            lambda p, g, mu, nu: self._leaf(
                p, torch.where(keep, g, (g / norm) * self.clip_norm), mu,
                nu, count),
            params, grads, opt_state["mu"], opt_state["nu"])
        new_params = tree_map(lambda p, s: p + s[0], params, stepped)
        return new_params, {
            "count": count + 1,
            "mu": tree_map(lambda p, s: s[1], params, stepped),
            "nu": tree_map(lambda p, s: s[2], params, stepped)}, norm


def make_optimizer(learning_rate=3e-4, warmup_steps=100,
                   total_steps=100_000, weight_decay=0.01, b1=0.9,
                   b2=0.95, clip_norm=1.0):
    """AdamW + global-norm clip + warmup-cosine — the standard recipe,
    with the JAX package's defaults. ``learning_rate``, ``weight_decay``
    and ``clip_norm`` may be 0-d tensors (the vectorized sweep's
    per-trial knobs)."""
    return AdamW(warmup_cosine(learning_rate, warmup_steps, total_steps),
                 b1=b1, b2=b2, eps=1e-8, weight_decay=weight_decay,
                 clip_norm=clip_norm)


# ---------------------------------------------------------------- state

def init_state(init_params_fn, optimizer, *, mesh=None, logical_axes=None,
               device=None, generator=None, extra=None):
    """A fresh TrainState on ``device`` (None → the card; raises on a
    host without CUDA), or placed on ``mesh`` (JAX ``init_state``, :68).
    ``init_params_fn(generator, device=...)`` builds the fp32 masters
    (``functools.partial(transformer.init_params, config)`` fits); they
    become leaves that require grad. ``extra`` is the model's mutable
    state (ResNet's batch statistics; None → ``{}``): its leaves take
    no gradient.

    On a mesh the masters are built on the host and cut by
    ``logical_axes`` under ``sharding.DEFAULT_RULES`` (the layout the
    models' mesh forwards compute on; JAX's ``rules=`` is not taken),
    every position keeping a copy of its piece; the moments take the params'
    layout; ``extra`` is replicated unless its leaves are placed
    already. The mesh names the devices, so ``device`` must be None."""
    if mesh is not None:
        if device is not None:
            raise ValueError("init_state takes a mesh or a device, not "
                             "both: the mesh names the devices")
        params = sharding_lib.place_tree(
            init_params_fn(generator, device="cpu"), mesh, logical_axes)
        for t in sharding_lib.pieces_of(tree_leaves(params)):
            if t.is_floating_point():
                t.requires_grad_(True)
        extra = tree_map(
            lambda x: x if isinstance(x, sharding_lib.Sharded)
            else sharding_lib.place(x.detach(), (), mesh),
            extra if extra is not None else {})
        return TrainState(step=0, params=params,
                          opt_state=optimizer.init(params), extra=extra)
    dev = device_lib.resolve(device)
    params = init_params_fn(generator, device=dev)

    def leaf(t):
        t = t.detach().to(dev)
        return t.requires_grad_(True) if t.is_floating_point() else t

    params = tree_map(leaf, params)
    extra = tree_map(lambda t: t.detach().to(dev),
                     extra if extra is not None else {})
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(params), extra=extra)


def gather_params(state, device="cpu"):
    """A mesh state's params as the logical tree, each leaf a fresh
    tensor on ``device`` (a single-device state's leaves copied)."""
    return sharding_lib.gather_tree(state.params, device)


def _grads(loss, leaves):
    """The loss's gradient for every leaf; zeros for a leaf the loss
    does not reach (BERT's ``type_embed`` without token types), as
    ``jax.grad`` gives."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def make_train_step(loss_fn, optimizer, mesh=None, accum_steps=1):
    """The train step ``run(state, batch) → (state, metrics)``.

    ``loss_fn(params, extra, batch) -> (loss, (metrics, new_extra))``.
    With ``accum_steps > 1`` every batch leaf has a leading
    ``[accum_steps, ...]`` dim: the microbatches run in turn (activation
    memory of one), their gradients summed in fp32 and divided by the
    count; loss and metrics are the microbatch means.
    ``metrics["grad_norm"]`` is the pre-clip global norm. The params are
    updated in place and the returned state shares them. ``new_extra``
    passes from one microbatch to the next (JAX's ``micro`` carry) and
    is returned detached from the graph.

    With ``mesh`` the state is ``init_state(mesh=)``'s and the batch
    either placed already (``data.shard_batch``, ``fit(mesh=)``) or host
    arrays, which the step cuts by ``data.BATCH_SPEC`` (microbatch by
    microbatch under ``accum_steps``). On a gang of processes each
    feeds its own rows, and the gradients are summed over the gang
    after the copies' sum."""

    def run(state, batch):
        leaves = tree_leaves(state.params)
        pieces = sharding_lib.pieces_of(leaves)
        if accum_steps == 1:
            loss, (metrics, new_extra) = loss_fn(
                state.params, state.extra, _on_mesh(batch, mesh))
            grads = _grads(loss, pieces)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in pieces]
            new_extra = state.extra
            history = []
            for i in range(accum_steps):
                micro = _on_mesh({k: _micro(v, i) for k, v in
                                  batch.items()}, mesh)
                loss, (metrics, new_extra) = loss_fn(state.params,
                                                     new_extra, micro)
                new_extra = _detached(new_extra)
                for acc, g in zip(grads, _grads(loss, pieces)):
                    acc.add_(g)
                history.append(metrics)
            grads = [g / accum_steps for g in grads]
            metrics = {k: torch.stack([m[k] for m in history]).mean()
                       for k in history[0]}
        unique = None
        if mesh is not None:
            grads, unique = _sum_copies(leaves, grads, mesh)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.update(pieces, grads,
                                                state.opt_state,
                                                unique=unique)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=state.opt_state,
                          extra=_detached(new_extra)), metrics

    return run


def _on_mesh(batch, mesh, spec=data_lib.BATCH_SPEC):
    """A batch as placed leaves: host arrays cut by ``spec`` (as it is
    without a mesh)."""
    if mesh is None or all(isinstance(v, sharding_lib.Sharded)
                           for v in batch.values()):
        return batch
    return data_lib.shard_batch(batch, mesh, spec)


def _micro(leaf, i):
    """Microbatch ``i`` of a batch leaf (placed with a leading
    replicated accumulation dim, or on the host)."""
    if not isinstance(leaf, sharding_lib.Sharded):
        return leaf[i]
    if leaf.spec[:1] not in ((), (None,)):
        raise ValueError(f"an accumulated batch leaf needs a replicated "
                         f"leading dim, got spec {leaf.spec}")
    return sharding_lib.Sharded(
        [t[i] for t in leaf.pieces],
        sharding_lib.NamedSharding(leaf.mesh, leaf.spec[1:]),
        leaf.shape[1:])


def _detached(tree):
    return tree_map(lambda x: x.map(torch.Tensor.detach)
                    if isinstance(x, sharding_lib.Sharded) else x.detach(),
                    tree)


def _sum_copies(leaves, grads, mesh=None):
    """Every piece's gradient (``grads``: the pieces' in
    ``pieces_of(leaves)`` order) → ``(each copy's gradient, one per
    piece)``: the copies' gradients summed in position order on the
    first copy's device, on a gang of processes that sum summed over
    them (:func:`_all_reduce`), and handed to every copy (the psum over
    the axes a leaf is replicated on)."""
    totals = []
    start = 0
    for leaf in leaves:
        mine = grads[start:start + len(leaf.pieces)]
        start += len(leaf.pieces)
        for group in leaf.sharding.copies:
            dev = mine[group[0]].device
            totals.append((group, functools.reduce(
                torch.add, (mine[q].to(dev) for q in group))))
    unique = [t for _, t in totals]
    if mesh is not None and mesh.process_count > 1:
        _all_reduce(unique, mesh.group)
    out, k = [], 0
    for leaf in leaves:
        summed = [None] * len(leaf.pieces)
        for _ in leaf.sharding.copies:
            group, total = totals[k]
            k += 1
            for q in group:
                summed[q] = total.to(leaf.pieces[q].device)
        out.extend(summed)
    return out, unique


#: the most bytes one all_reduce of :func:`_all_reduce` carries
BUCKET_BYTES = 256 << 20


def _all_reduce(tensors, group):
    """Sum ``tensors`` over the processes of ``group`` in place: the
    tensors of one device and dtype flattened into buckets of up to
    :data:`BUCKET_BYTES`, one ``all_reduce`` each."""
    import torch.distributed as dist
    by_kind = {}
    for t in tensors:
        by_kind.setdefault((t.device, t.dtype), []).append(t)
    for same in by_kind.values():
        bucket, size = [], 0
        for t in same + [None]:
            if t is not None and (not bucket or size + t.numel()
                                  * t.element_size() <= BUCKET_BYTES):
                bucket.append(t)
                size += t.numel() * t.element_size()
                continue
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            for b, part in zip(bucket, torch.split(
                    flat, [b.numel() for b in bucket])):
                b.copy_(part.view_as(b))
            bucket, size = ([t], t.numel() * t.element_size()) \
                if t is not None else ([], 0)


def fit(state, step_fn, batches, mesh=None, steps=None, spec=None,
        prefetch_depth=2, on_step=None, telemetry=None):
    """Run a training loop over host batches with prefetch overlap.

    ``batches`` is a host-batch iterator; it is wrapped in a
    ``data.Prefetcher`` (host→device copy overlaps compute) — onto
    ``mesh`` by ``spec`` (default ``data.BATCH_SPEC``) through
    ``shard_batch``, else onto the params' device — under its context
    manager, so the pump thread is released on every exit path —
    exhaustion, the ``steps`` cap, an ``on_step`` early stop, or an
    exception.

    ``on_step(step_count, metrics)`` runs after every step; returning
    False stops the loop. ``telemetry`` (a ``telemetry.TrainTelemetry``)
    gets one ``step()`` per iteration. Returns ``(state,
    last_metrics)``."""
    if mesh is not None:
        target = mesh
    else:
        target = tree_leaves(state.params)[0].device
    metrics = None
    done = 0
    with data_lib.Prefetcher(batches, target,
                             spec=spec or data_lib.BATCH_SPEC,
                             depth=prefetch_depth) as pf:
        for batch in pf:
            state, metrics = step_fn(state, batch)
            done += 1
            if telemetry is not None:
                telemetry.step()
            if on_step is not None and on_step(done, metrics) is False:
                break
            if steps is not None and done >= steps:
                break
    return state, metrics


def make_eval_step(loss_fn, mesh=None):
    """``run(state, batch) → metrics`` without gradients; on ``mesh``
    host batches are cut by ``data.BATCH_SPEC``."""
    def run(state, batch):
        batch = _on_mesh(batch, mesh)
        with torch.no_grad():
            return loss_fn(state.params, state.extra, batch)[1][0]
    return run


# Adapters: models expose loss(params, batch, config) or
# loss(params, stats, batch, config, train).

def plain_loss(model_loss, config):
    """For stateless models (transformer, bert, mlp)."""
    def loss(params, extra, batch):
        value, metrics = model_loss(params, batch, config)
        return value, (metrics, extra)
    return loss


def stateful_loss(model_loss, config, train=True):
    """For models with mutable state (resnet's batch statistics in
    ``extra``)."""
    def loss(params, extra, batch):
        return model_loss(params, extra, batch, config, train)
    return loss
