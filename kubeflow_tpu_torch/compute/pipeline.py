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

:func:`train_1f1b` also runs on a gang of processes whose ``data`` axis
crosses them (``mesh.make_mesh(group=)``): each process passes its own
rows and gets JAX's global loss and gradients back, the gang joining
the global batch, each microbatch's last-stage outputs and the aux
statistics with exact ``all_reduce``s, then summing the gradients. A
layer aux that is not a mean over rows comes in row form
(:class:`RowAux`), so a microbatch cut over ``data`` still gets the
whole microbatch's aux.
"""

import functools
import typing

import torch

from . import mesh as mesh_lib
from . import sharding
from . import train as train_lib
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


class RowAux(typing.NamedTuple):
    """A layer's aux in row form, which :func:`train_1f1b` turns into the
    aux of the whole microbatch however the microbatch is cut: ``stats``
    is an fp32 tensor that sums over the rows the layer saw (with its
    gradient), and ``finish(total, rows)`` makes the 0-d aux from the
    whole microbatch's summed ``stats`` and its row count. An aux that
    is not a mean over rows needs it (the MoE's load-balancing aux, a
    product of two means: ``models/transformer.py`` ``_moe_row_aux``)."""

    stats: torch.Tensor
    finish: typing.Callable


def _aux_form(auxs):
    """A stage's per-layer aux values → None (no layer gave one),
    ``"row"`` (each a :class:`RowAux`) or ``"plain"`` (each 0-d)."""
    if all(a is None for a in auxs):
        return None
    rows = sum(isinstance(a, RowAux) for a in auxs)
    if rows and rows != len(auxs):
        raise ValueError("train_1f1b: a stage's layers give their aux in "
                         "more than one form")
    return "row" if rows else "plain"


def _gang_cat(mine, first, total, mesh):
    """The gang's ``total`` equal pieces joined over dim 0, on every
    process: this process holds ``mine`` (a list), pieces ``first`` on.
    One ``all_reduce`` of a zero-filled byte buffer into which each
    process writes its pieces' bytes: every byte has one non-zero
    summand, so the sum is the bytes of the concatenation, whatever the
    dtype. gloo runs ``all_reduce`` on CUDA tensors too (through the
    host), NCCL on the card."""
    import torch.distributed as dist
    like = mine[0]
    buf = torch.zeros((total, like.numel() * like.element_size()),
                      dtype=torch.uint8, device=like.device)
    for i, t in enumerate(mine):
        buf[first + i] = t.to(like.device).contiguous().reshape(-1).view(
            torch.uint8)
    dist.all_reduce(buf, group=mesh.group)
    return buf.view(like.dtype).reshape(total * like.shape[0],
                                        *like.shape[1:])


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
    → (y, aux)``, aux None, a 0-d tensor or a :class:`RowAux`;
    ``loss_fn(hp, y, targets_mb) →`` the microbatch's mean loss.
    ``aux_weight`` adds ``aux_weight · mean(aux)`` over layers ×
    microbatches to the objective.

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
      alone; every layer in the repo is). A layer's aux is the whole
      microbatch's, as JAX's ``layer_fn`` sees it: in row form the
      cuts' ``stats`` are summed on the stage's lead, ``aux =
      finish(S, mb)`` joins the loss, and ``∂aux/∂S`` (taken once, kept
      with the microbatch's saved input) seeds each cut's recomputed
      ``stats`` in the backward, the exact gradient with no collective
      there; a plain 0-d aux is the mean of the cuts' values, exact for
      an aux that is a mean over rows (JAX's tests' ``mean(x²)``).
      Every layer in the repo whose aux is not linear over rows (the
      MoE's) gives the row form under this schedule.
    - ``fsdp``, ``tensor``, ``sequence``, ``expert``: each stage's
      ``layers`` leaves are gathered whole on each ``(d, s)`` position
      (coordinate 0 on those axes), ``embed`` on each ``(d, 0)`` and
      ``head`` on ``(0, P-1)``, once a call; ``layer_fn`` sees logical
      tensors and runs whole there. Exact, not XLA's intra-stage
      partitioning.

    Embed grads land at stage 0, head grads at the last stage; each is
    summed over ``d`` in coordinate order, as the layer grads are.

    A gang of processes (``make_mesh(group=)``: only ``data`` crosses
    them, process ``q`` holding the global coordinates ``[q·D_l,
    (q+1)·D_l)``) runs the same call on every process. Each passes its
    own rows, ``[q·b, (q+1)·b)`` of the global batch of ``B = Q·b``
    (as ``data.shard_batch`` and the slice worker feed them), and gets
    back JAX's global values, the same on every process: the gang's
    loss and the global gradients. That is a whole step's ``(loss,
    grads)``, as JAX's is, where the train step returns each process's
    share. Microbatch ``f`` is the global rows ``[f·mb, (f+1)·mb)``
    with ``mb = B/M`` cut over the gang's ``D = Q·D_l`` coordinates, so
    the gang first joins the global tokens and targets on every process
    (one exact ``all_reduce`` each, :func:`_gang_cat`). The last stage
    joins the ``D`` cuts' outputs of each microbatch over the gang the
    same way and every process applies ``loss_fn`` to the whole
    microbatch, keeping its own cuts' cotangent: the head grads come out
    whole on each process and are not summed. An aux sums over the gang
    before it is formed (the row form's ``stats``, a plain aux's cut
    values). The layer and embed grads, summed over this process's
    coordinates in order, are then summed over the gang
    (``train._all_reduce``, flat buckets). Every process runs the same
    ticks, so the collectives come in the same order on each: the
    exchange, the aux sums and joins tick by tick, the gradient sums."""
    m = n_microbatches
    tokens, targets = torch.as_tensor(tokens), torch.as_tensor(targets)
    gang, q = mesh.process_count, mesh.process_index
    p, n_mine = mesh.shape[mesh_lib.PIPELINE], mesh.shape[mesh_lib.DATA]
    n_data = n_mine * gang
    batch = tokens.shape[0] * gang
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by "
                         f"n_microbatches={m}")
    mb = batch // m
    if mb % n_data:
        where = (f" ({n_mine} on each of {gang} processes)" if gang > 1
                 else "")
        raise ValueError(f"a microbatch of {mb} rows does not divide over "
                         f"the mesh's '{mesh_lib.DATA}' axis of "
                         f"{n_data}{where}")
    cut = mb // n_data
    first = q * n_mine                # this process's first coordinate
    lead = [[mesh.position({mesh_lib.DATA: d, mesh_lib.PIPELINE: s})
             for s in range(p)] for d in range(n_mine)]
    devs = [[mesh.devices[i] for i in row] for row in lead]
    placed = _placed(params, mesh)
    inner = tuple(a for a in mesh_lib.AXIS_ORDER if a != mesh_lib.PIPELINE)

    def alias(x, i, axes=mesh_lib.AXIS_ORDER):
        return x.gather_at(i, axes).detach().requires_grad_()

    local = [[tree_map(lambda x, i=i: alias(x, i, inner), placed["layers"])
              for i in row] for row in lead]
    eparams = [tree_map(lambda x, i=row[0]: alias(x, i), placed["embed"])
               for row in lead]
    hdev = devs[0][p - 1]
    hparams = tree_map(lambda x: alias(x, lead[0][p - 1]), placed["head"])
    n_local = tree_leaves(local[0][0])[0].shape[0]
    n_layers = n_local * p
    if gang > 1:                      # the global batch, on every process
        tokens = _gang_cat([tokens.to(devs[0][0])], q, gang, mesh)
        targets = _gang_cat([targets.to(devs[0][0])], q, gang, mesh)
    toks = [[tokens[i * mb + (first + d) * cut:
                    i * mb + (first + d + 1) * cut].to(devs[d][0])
             for i in range(m)] for d in range(n_mine)]
    tgts = [targets[i * mb:(i + 1) * mb].to(hdev) for i in range(m)]

    def stage_fwd(d, s, xin):
        y, auxs = xin, []
        for i in range(n_local):
            y, aux = layer_fn(tree_map(lambda t: t[i], local[d][s]), y)
            auxs.append(aux)
        return y, auxs

    def whole_aux(s, form, auxs):
        """A microbatch's stage aux (fp32 0-d on stage ``s``'s lead)
        from its cuts' per-layer values ``auxs[d]``, summed over the
        gang; for the row form also ``∂aux/∂S``, one row a layer."""
        dev = devs[0][s]
        if form == "plain":
            total = functools.reduce(torch.add, (_stage_aux(a).to(dev)
                                                 for a in auxs))
            return mesh_lib.global_sum(total, mesh) / n_data, None
        stats = functools.reduce(torch.add, (torch.stack(
            [r.stats.float().to(dev) for r in a]) for a in auxs))
        stats = mesh_lib.global_sum(stats, mesh).requires_grad_()
        with torch.enable_grad():
            aux = _stage_aux([r.finish(stats[i], mb)
                              for i, r in enumerate(auxs[0])])
        g, = torch.autograd.grad(aux, stats)
        return aux.detach(), g

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
    aux_cot = aux_weight / (n_layers * m)
    ring = 2 * p
    saved = [[{} for _ in range(p)] for _ in range(n_mine)]
    aux_g = [{} for _ in range(p)]    # the row form's ∂aux/∂S, by slot
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
                for d in range(n_mine):
                    with torch.no_grad():
                        xin = (embed_fn(eparams[d], toks[d][f]) if s == 0
                               else recv_f.pop((d, s)))
                        saved[d][s][f % ring] = xin
                        live = max(live, len(saved[d][s]))
                        y, aux_f = stage_fwd(d, s, xin)
                    ys.append(y)
                    auxs.append(aux_f)
                form = _aux_form(auxs[0])
                if form is not None:
                    aux_f, aux_g[s][f % ring] = whole_aux(s, form, auxs)
                    loss_sum[s] += aux_weight * aux_f / (n_layers * m)
                if last:              # the loss and its cotangent, now
                    if gang > 1:
                        yy = _gang_cat([y.to(hdev) for y in ys], first,
                                       n_data, mesh)
                    else:
                        yy = ys[0] if n_mine == 1 else torch.cat(
                            [y.to(hdev) for y in ys])
                    yy = yy.detach().requires_grad_()
                    with torch.enable_grad():
                        loss_f = loss_fn(hparams, yy, tgts[f])
                    *dh, cot = torch.autograd.grad(
                        loss_f, h_leaves + [yy],
                        torch.full_like(loss_f, 1.0 / m), allow_unused=True)
                    _add(g_h, dh)
                    loss_sum[s] += loss_f.detach().float() / m
                    cots = [c.to(devs[d][s]) for d, c in enumerate(
                        cot.split(cut)[first:first + n_mine])]
                else:
                    for d, y in enumerate(ys):
                        send_f[(d, s + 1)] = y
            b = t - 2 * (p - 1) + s   # backward half: microbatch b
            if not 0 <= b < m:
                continue
            g_aux = aux_g[s].pop(b % ring, None)
            for d in range(n_mine):
                x_req = saved[d][s].pop(b % ring).detach().requires_grad_()
                cot = cots[d] if last else recv_b.pop((d, s))
                with torch.enable_grad():
                    yb, auxs_b = stage_fwd(d, s, x_req)
                outs, grads_in = [yb], [cot.to(yb.dtype)]
                form = _aux_form(auxs_b)
                if form == "row":
                    for r, g in zip(auxs_b, g_aux):
                        if r.stats.requires_grad:
                            outs.append(r.stats)
                            grads_in.append((aux_cot * g).to(
                                r.stats.device, r.stats.dtype))
                elif form == "plain":
                    aux_b = _stage_aux(auxs_b)
                    if aux_b.requires_grad:
                        outs.append(aux_b)
                        grads_in.append(torch.full_like(aux_b,
                                                        aux_cot / n_data))
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

    stage_g = [[over_data([g_l[d][s][i] for d in range(n_mine)])
                for i in range(len(g_l[0][s]))] for s in range(p)]
    embed_g = [over_data([g_e[d][i] for d in range(n_mine)])
               for i in range(len(g_e[0]))]
    if gang > 1:     # the head grads are already whole on every process
        train_lib._all_reduce([g for st in stage_g for g in st] + embed_g,
                              mesh.group)

    def rebuild(tree, whole):
        """``tree``'s leaves, each position's piece cut from ``whole(i,
        coords)`` (the i-th leaf's gradient the position's stage holds,
        and the offset of its dim 0 there)."""
        index = {id(leaf): i for i, leaf in enumerate(tree_leaves(tree))}

        def pieces(leaf):
            out = []
            for i, dev in enumerate(mesh.devices):
                g, offset = whole(index[id(leaf)], mesh.coords(i))
                for dim, (start, n) in enumerate(
                        leaf.sharding.bounds(leaf.shape, i)):
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
