"""Logical-axis partition rules → per-shard tensors.

Port of ``kubeflow_tpu/compute/sharding.py``: ``DEFAULT_RULES`` (:22),
``spec_for`` (:42), ``tree_specs`` (:56) and ``shard_tree`` (:81).
Models name each parameter's dims with *logical* axes ("embed",
"heads", "vocab", …); the rule table maps them to mesh axes, so a
layout change is a rule edit, not a model edit. A spec is a tuple with
one entry per dim: a mesh axis name, a tuple of names, or None
(replicated along that dim); ``()`` is a fully replicated leaf.

Where JAX's ``device_put`` lays a leaf out on the mesh as one global
array, :func:`shard_tree` hands back one tree per position on the
mesh's ``tensor`` axis, each holding that shard's piece on that shard's
device, for the one controller that drives them (``compute/generate.py``).
The auto-SPMD helpers (``constrain``, ``embed_lookup``) have no
counterpart: the port's engine shards by hand, as JAX's does inside its
manual ``shard_map`` (``generate.py:1116-1135``).
"""

from . import mesh as mesh_lib

#: logical axis → mesh axis (or tuple of mesh axes, or None=replicated).
#: One table serves every mesh shape because size-1 mesh axes are no-ops.
DEFAULT_RULES = {
    # activations
    "batch": (mesh_lib.DATA, mesh_lib.FSDP),
    "seq": mesh_lib.SEQUENCE,
    "act_embed": None,
    "act_heads": mesh_lib.TENSOR,
    # parameters
    "embed": mesh_lib.FSDP,         # fsdp shards the non-tensor dim
    "vocab": mesh_lib.TENSOR,
    "mlp": mesh_lib.TENSOR,
    "heads": mesh_lib.TENSOR,
    "kv": None,
    "expert": mesh_lib.EXPERT,
    "layers": None,                  # the stacked-layer leading dim
    "stage": mesh_lib.PIPELINE,
}


def spec_for(logical_axes, rules=None):
    """('embed','mlp') → (fsdp, tensor). ``None`` (whole-array) → ``()``,
    fully replicated."""
    if logical_axes is None:
        return ()
    rules = rules or DEFAULT_RULES
    return tuple(None if ax is None else rules[ax] for ax in logical_axes)


def _is_axes(x):
    return x is None or isinstance(x, tuple)


def _map(fn, tree, *rest, is_leaf):
    """``fn`` over the leaves of nested dicts and lists (the param
    layout), ``rest`` trees of the same structure alongside."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest),
                               is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_specs(logical_tree, rules=None):
    """Map a tree of logical-axis tuples to specs."""
    return _map(lambda axes: spec_for(axes, rules), logical_tree,
                is_leaf=_is_axes)


def _tensor_dims(spec, mesh):
    """The dims of ``spec`` that shard over the ``tensor`` axis; a spec
    naming any other mesh axis larger than 1 is refused (the generation
    mesh shards ``tensor`` only; the training mesh is its own slice)."""
    dims = []
    for dim, entry in enumerate(spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for name in names:
            if name == mesh_lib.TENSOR:
                dims.append(dim)
            elif mesh.shape[name] != 1:
                raise ValueError(
                    f"shard_tree splits the '{mesh_lib.TENSOR}' axis only; "
                    f"spec {spec} names '{name}' of size "
                    f"{mesh.shape[name]}")
    return dims


def shard_tree(tree, mesh, logical_tree, rules=None):
    """Split a tree of tensors over the mesh per its logical axes → one
    tree per position on the ``tensor`` axis (every other axis size 1).
    A leaf whose dims map to ``tensor`` is cut into ``tp`` equal pieces
    along them, piece ``i`` on ``mesh.devices[i]``; a replicated leaf is
    copied once to every distinct device, and shards that share a device
    share that copy."""
    tp = mesh.shape[mesh_lib.TENSOR]
    if tp != mesh.size:
        raise ValueError(f"shard_tree needs a mesh whose only non-trivial "
                         f"axis is '{mesh_lib.TENSOR}', got {mesh.shape}")
    specs = tree_specs(logical_tree, rules)

    def pieces(t, spec):
        dims = _tensor_dims(spec, mesh)
        if not dims:
            on = {d: t.to(d) for d in dict.fromkeys(mesh.devices)}
            return [on[d] for d in mesh.devices]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} maps '{mesh_lib.TENSOR}' to "
                             f"more than one dim")
        dim = dims[0]
        if t.shape[dim] % tp:
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} leaf does "
                             f"not split into {tp} pieces")
        n = t.shape[dim] // tp
        return [t.narrow(dim, i * n, n).to(d).contiguous()
                for i, d in enumerate(mesh.devices)]

    split = _map(pieces, tree, specs, is_leaf=lambda x: hasattr(x, "shape"))
    return [_map(lambda ps, i=i: ps[i], split,
                 is_leaf=lambda x: isinstance(x, list)
                 and x and hasattr(x[0], "shape"))
            for i in range(tp)]
