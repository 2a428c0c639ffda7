"""GPipe and 1F1B pipeline schedules over a mesh's ``pipeline`` axis,
for the one controller.

Port of ``kubeflow_tpu/compute/pipeline.py``: :func:`pipelined_layers`
(:40, GPipe) and :func:`train_1f1b` (:135). Stage assignment is a
placement: the stacked-layer leaves carry the ``"stage"`` logical axis,
which ``sharding.DEFAULT_RULES`` maps to ``pipeline``, so stage ``s``
holds layers ``[s·L/P, (s+1)·L/P)`` on its positions (with the ``fsdp``
and ``tensor`` cuts inside them) and a checkpoint stays a logical tree.

JAX runs every stage as one traced program inside a ``shard_map`` and
hops activations between neighbours with ``lax.ppermute``; its warm-up
and drain ticks compute on garbage that is masked out. The one
controller keeps the tick order (stage ``s`` runs microbatch ``t - s``
at tick ``t``), moves a stage's output to the next stage's devices with
``.to()``, and does not run the bubbles at all: the same numbers, in
the same order, without the wasted work.
"""

import functools

import torch

from . import mesh as mesh_lib
from . import sharding
from .train import tree_leaves, tree_map


def _each(fn, x):
    """``fn`` on a tensor, or on each tensor of a list of them."""
    return [fn(t) for t in x] if isinstance(x, (list, tuple)) else fn(x)


def _first(x):
    return x[0] if isinstance(x, (list, tuple)) else x


def _stage_aux(auxs):
    """A stage's per-layer aux values summed in fp32 (None: no layer
    gave one — a dense MLP)."""
    auxs = [a for a in auxs if a is not None]
    if not auxs:
        return None
    total = auxs[0].float()
    for a in auxs[1:]:
        total = total + a.float().to(total.device)
    return total


def pipelined_layers(layer_fn, stages, x, n_microbatches, hop=None):
    """Run a stack of layers as a GPipe pipeline (``pipeline.py:40``).

    ``layer_fn(lp, x) → (x', aux)``, one layer (remat'd by the caller;
    ``aux`` None for a layer without one); ``stages``: one list of layer
    params per stage, in layer order; ``x``: the first stage's input,
    ``[B, ...]`` or a list of such tensors (a mesh's sequence chunks),
    B divisible by ``n_microbatches``; ``hop(s, y)`` moves a stage's
    output onto stage ``s``'s devices (default: left where it is).

    Microbatch ``i`` is rows ``[i·mb, (i+1)·mb)``. → ``(y, auxs)``: the
    last stage's outputs joined in microbatch order, and each layer's
    aux values (in layer order), each a list over the microbatches in
    order (:func:`aux_mean` is JAX's reduction of them)."""
    m = n_microbatches
    batch = _first(x).shape[0]
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by "
                         f"n_microbatches={m}")
    mb = batch // m
    micro = [_each(lambda t, i=i: t[i * mb:(i + 1) * mb], x)
             for i in range(m)]
    n_stages = len(stages)
    inbox, outs = {}, [None] * m
    auxs = [[[None] * m for _ in st] for st in stages]
    for t in range(m + n_stages - 1):
        for s in range(n_stages):
            i = t - s
            if not 0 <= i < m:
                continue              # a warm-up or drain bubble
            y = micro[i] if s == 0 else inbox.pop((s, i))
            for li, lp in enumerate(stages[s]):
                y, auxs[s][li][i] = layer_fn(lp, y)
            if s == n_stages - 1:
                outs[i] = y
            else:
                inbox[(s + 1, i)] = y if hop is None else hop(s + 1, y)
    if isinstance(x, (list, tuple)):
        y = [torch.cat(parts, dim=0) for parts in zip(*outs)]
    else:
        y = torch.cat(outs, dim=0)
    return y, [layer for st in auxs for layer in st]


def aux_mean(auxs, device):
    """:func:`pipelined_layers`' aux values (0-d, or None for a layer
    without one) → their mean over layers × microbatches, fp32 0-d on
    ``device``: each microbatch's sum over the layers added in
    microbatch order, as a stage's ticks add them in JAX, divided by
    ``L·M`` (``pipeline.py:119-129``; 0 without any)."""
    n_layers, m = len(auxs), len(auxs[0])
    total = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(m):
        a = _stage_aux([layer[i] for layer in auxs])
        if a is not None:
            total = total + a.to(device)
    return total / (n_layers * m)


# ------------------------------------------------------------- 1F1B

def _placed(params, mesh):
    """``params`` (``{"embed", "layers", "head"}``) as :class:`Sharded`
    leaves: placed already (each ``layers`` leaf cut over ``pipeline``
    on dim 0), or plain tensors placed here — ``layers`` by the
    ``"stage"`` logical axis, ``embed`` and ``head`` replicated."""
    leaves = tree_leaves(params)
    if all(isinstance(x, sharding.Sharded) for x in leaves):
        if mesh.shape[mesh_lib.PIPELINE] > 1:
            for leaf in tree_leaves(params["layers"]):
                if leaf.sharding.dim_axes(len(leaf.shape))[0] != (
                        mesh_lib.PIPELINE,):
                    raise ValueError(
                        f"train_1f1b: a layers leaf lies by spec "
                        f"{leaf.spec}; its dim 0 must be cut over "
                        f"'{mesh_lib.PIPELINE}'")
        return params
    logical = {"embed": tree_map(lambda _: None, params["embed"]),
               "layers": tree_map(lambda _: ("stage",), params["layers"]),
               "head": tree_map(lambda _: None, params["head"])}
    return sharding.place_tree(
        tree_map(lambda t: t.detach(), params), mesh, logical)


def _add(acc, grads):
    for a, g in zip(acc, grads):
        if g is not None:
            a.add_(g.float())


def train_1f1b(embed_fn, layer_fn, loss_fn, params, tokens, targets,
               n_microbatches, mesh, aux_weight=0.0):
    """One 1F1B pipeline training step (``pipeline.py:135``) →
    ``(loss, grads)``.

    ``params``: ``{"embed", "layers", "head"}`` trees; ``layers`` leaves
    carry the leading layer dim. Plain tensors are placed on ``mesh``
    (``layers`` cut over ``pipeline``, the rest replicated) and the
    grads come back as logical tensors on each leaf's device;
    ``Sharded`` leaves (``layers`` cut over ``pipeline`` on dim 0, any
    dim cut over the other axes) get grads in their own layout: each
    piece the slice of the gradient that it holds, every copy the whole
    sum (the psum). ``embed_fn(ep, tokens_mb) → x0``; ``layer_fn(lp, x)
    → (y, aux)`` (aux None or a 0-d tensor); ``loss_fn(hp, y,
    targets_mb) →`` the microbatch's mean loss. ``aux_weight`` adds
    ``aux_weight · mean(aux)`` over layers × microbatches to the
    objective.

    The schedule is JAX's: stage ``s`` forwards microbatch ``t - s`` at
    tick ``t`` under ``no_grad``, keeping its input in a ring of ``2P``
    slots, and backwards microbatch ``t - 2(P-1) + s``, recomputing the
    stage from the saved input and taking ``torch.autograd.grad`` with
    the cotangent received from the next stage (cast to the activation
    dtype). The last stage applies the loss as soon as a microbatch's
    forward ends and seeds the cotangent at once: ``1/M`` for the loss,
    ``aux_weight / (L·M)`` for the aux. So at most ``2P - 1`` stage
    inputs are live per stage whatever M is; the most any stage held in
    this call is left on ``train_1f1b.live_inputs``.

    The other axes of ``mesh`` (JAX's are XLA's, outside the manual
    ``pipeline`` axis) compute the same numbers:

    - ``data``: microbatch ``f`` is still the global rows ``[f·mb,
      (f+1)·mb)``; data coordinate ``d`` takes its contiguous cut of
      ``mb/D`` rows (an ``mb`` that does not divide is refused) and runs
      the stage chain on the positions ``(d, s)`` (each with its own
      ring of saved inputs: ``live_inputs`` is counted per ``(d, s)``).
      The last stage joins the ``D`` cuts' outputs on ``(0, P-1)``,
      applies ``loss_fn`` once to the whole microbatch and cuts the
      cotangent back, so any ``loss_fn`` is JAX's. ``embed_fn`` and
      ``layer_fn`` must be row-local (a row's output depends on that row
      alone; every layer in the repo is). A layer's aux for a
      microbatch is the mean of its cuts' values: JAX's for an aux that
      is a mean over rows, not for a non-linear one. The MoE's
      load-balancing aux (``models/transformer.py`` ``_moe_aux``, a
      product of two fractions of the microbatch's rows) is one, so an
      MoE ``layer_fn`` with ``aux_weight`` > 0 matches JAX only at
      ``data`` = 1.
    - ``fsdp``, ``tensor``, ``sequence``, ``expert``: each stage's
      ``layers`` leaves are gathered whole on each ``(d, s)`` position
      (coordinate 0 on those axes), ``embed`` on each ``(d, 0)`` and
      ``head`` on ``(0, P-1)``, once a call; ``layer_fn`` sees logical
      tensors and runs whole there. Exact, not XLA's intra-stage
      partitioning.

    Embed grads land at stage 0, head grads at the last stage; each is
    summed over ``d`` in coordinate order, as the layer grads are. A
    mesh across processes is refused: the gang would have to exchange
    rows for microbatch ``f`` to keep JAX's global grouping."""
    m = n_microbatches
    tokens, targets = torch.as_tensor(tokens), torch.as_tensor(targets)
    if tokens.shape[0] % m:
        raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                         f"n_microbatches={m}")
    if mesh.process_count > 1:
        raise ValueError(f"train_1f1b runs on one process's mesh; its "
                         f"'{mesh_lib.DATA}' axis spans "
                         f"{mesh.process_count} processes")
    p, n_data = mesh.shape[mesh_lib.PIPELINE], mesh.shape[mesh_lib.DATA]
    mb = tokens.shape[0] // m
    if mb % n_data:
        raise ValueError(f"a microbatch of {mb} rows does not divide over "
                         f"the mesh's '{mesh_lib.DATA}' axis of {n_data}")
    cut = mb // n_data
    lead = [[mesh.position({mesh_lib.DATA: d, mesh_lib.PIPELINE: s})
             for s in range(p)] for d in range(n_data)]
    devs = [[mesh.devices[q] for q in row] for row in lead]
    placed = _placed(params, mesh)
    inner = tuple(a for a in mesh_lib.AXIS_ORDER if a != mesh_lib.PIPELINE)

    def alias(x, q, axes=mesh_lib.AXIS_ORDER):
        return x.gather_at(q, axes).detach().requires_grad_()

    local = [[tree_map(lambda x, q=q: alias(x, q, inner), placed["layers"])
              for q in row] for row in lead]
    eparams = [tree_map(lambda x, q=row[0]: alias(x, q), placed["embed"])
               for row in lead]
    hdev = devs[0][p - 1]
    hparams = tree_map(lambda x: alias(x, lead[0][p - 1]), placed["head"])
    n_local = tree_leaves(local[0][0])[0].shape[0]
    n_layers = n_local * p
    toks = [[tokens[i * mb + d * cut:i * mb + (d + 1) * cut].to(devs[d][0])
             for i in range(m)] for d in range(n_data)]
    tgts = [targets[i * mb:(i + 1) * mb].to(hdev) for i in range(m)]

    def stage_fwd(d, s, xin):
        y, auxs = xin, []
        for i in range(n_local):
            y, aux = layer_fn(tree_map(lambda t: t[i], local[d][s]), y)
            auxs.append(aux)
        return y, _stage_aux(auxs)

    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)

    l_leaves = [[tree_leaves(lp) for lp in row] for row in local]
    e_leaves = [tree_leaves(ep) for ep in eparams]
    h_leaves = tree_leaves(hparams)
    g_l = [[[zeros(t) for t in ls] for ls in row] for row in l_leaves]
    g_e = [[zeros(t) for t in ls] for ls in e_leaves]
    g_h = [zeros(t) for t in h_leaves]
    loss_sum = [torch.zeros((), dtype=torch.float32, device=d)
                for d in devs[0]]
    aux_cot = aux_weight / (n_layers * m * n_data)
    ring = 2 * p
    saved = [[{} for _ in range(p)] for _ in range(n_data)]
    live = 0
    recv_f, recv_b = {}, {}
    for t in range(m + 2 * (p - 1)):
        send_f, send_b = {}, {}
        for s in range(p):
            last = s == p - 1
            cots = None
            f = t - s                 # forward half: microbatch f
            if 0 <= f < m:
                ys, auxs = [], []
                for d in range(n_data):
                    with torch.no_grad():
                        xin = (embed_fn(eparams[d], toks[d][f]) if s == 0
                               else recv_f.pop((d, s)))
                        saved[d][s][f % ring] = xin
                        live = max(live, len(saved[d][s]))
                        y, aux_f = stage_fwd(d, s, xin)
                    ys.append(y)
                    auxs.append(aux_f)
                if auxs[0] is not None:   # the cuts' mean
                    aux_f = sum(a.to(devs[0][s]) for a in auxs) / n_data
                    loss_sum[s] += aux_weight * aux_f / (n_layers * m)
                if last:              # the loss and its cotangent, now
                    yy = (ys[0] if n_data == 1 else torch.cat(
                        [y.to(hdev) for y in ys])).detach().requires_grad_()
                    with torch.enable_grad():
                        loss_f = loss_fn(hparams, yy, tgts[f])
                    *dh, cot = torch.autograd.grad(
                        loss_f, h_leaves + [yy],
                        torch.full_like(loss_f, 1.0 / m), allow_unused=True)
                    _add(g_h, dh)
                    loss_sum[s] += loss_f.detach().float() / m
                    cots = [c.to(devs[d][s])
                            for d, c in enumerate(cot.split(cut))]
                else:
                    for d, y in enumerate(ys):
                        send_f[(d, s + 1)] = y
            b = t - 2 * (p - 1) + s   # backward half: microbatch b
            if not 0 <= b < m:
                continue
            for d in range(n_data):
                x_req = saved[d][s].pop(b % ring).detach().requires_grad_()
                cot = cots[d] if last else recv_b.pop((d, s))
                with torch.enable_grad():
                    yb, aux_b = stage_fwd(d, s, x_req)
                outs, grads_in = [yb], [cot.to(yb.dtype)]
                if aux_b is not None and aux_b.requires_grad:
                    outs.append(aux_b)
                    grads_in.append(torch.full_like(aux_b, aux_cot))
                *dl, dxin = torch.autograd.grad(
                    outs, l_leaves[d][s] + [x_req], grads_in,
                    allow_unused=True)
                _add(g_l[d][s], dl)
                if s == 0:
                    with torch.enable_grad():
                        x0 = embed_fn(eparams[d], toks[d][b])
                    _add(g_e[d], torch.autograd.grad(
                        x0, e_leaves[d], dxin, allow_unused=True))
                else:
                    send_b[(d, s - 1)] = dxin
        recv_f = {k: y.to(devs[k[0]][k[1]]) for k, y in send_f.items()}
        recv_b = {k: g.to(devs[k[0]][k[1]]) for k, g in send_b.items()}
    train_1f1b.live_inputs = live
    loss = sum(x.to(devs[0][0]) for x in loss_sum)

    def over_data(parts):
        """Per-``d`` gradients summed in coordinate order on ``d``=0's
        device."""
        dev = parts[0].device
        return functools.reduce(torch.add, (g.to(dev) for g in parts))

    stage_g = [[over_data([g_l[d][s][i] for d in range(n_data)])
                for i in range(len(g_l[0][s]))] for s in range(p)]
    embed_g = [over_data([g_e[d][i] for d in range(n_data)])
               for i in range(len(g_e[0]))]

    def rebuild(tree, whole):
        """``tree``'s leaves, each position's piece cut from ``whole(i,
        coords)`` (the i-th leaf's gradient the position's stage holds,
        and the offset of its dim 0 there)."""
        index = {id(leaf): i for i, leaf in enumerate(tree_leaves(tree))}

        def pieces(leaf):
            out = []
            for q, dev in enumerate(mesh.devices):
                g, offset = whole(index[id(leaf)], mesh.coords(q))
                for dim, (start, n) in enumerate(
                        leaf.sharding.bounds(leaf.shape, q)):
                    g = g.narrow(dim, start - (offset if dim == 0 else 0),
                                 n)
                out.append(g.to(dev))
            return sharding.Sharded(out, leaf.sharding, leaf.shape)

        return tree_map(pieces, tree)

    pipe = mesh_lib.PIPELINE
    grads = {
        "embed": rebuild(placed["embed"], lambda i, c: (embed_g[i], 0)),
        "layers": rebuild(placed["layers"], lambda i, c: (
            stage_g[c[pipe]][i], c[pipe] * n_local)),
        "head": rebuild(placed["head"], lambda i, c: (g_h[i], 0))}
    if placed is not params:
        grads = tree_map(lambda g, x: g.gather(x.device), grads, params)
    return loss, grads


train_1f1b.live_inputs = 0
