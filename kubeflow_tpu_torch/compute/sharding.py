"""Logical-axis partition rules → per-shard tensors.

Port of ``kubeflow_tpu/compute/sharding.py``: ``DEFAULT_RULES`` (:22),
``spec_for`` (:42), ``tree_specs`` (:56) and ``shard_tree`` (:81).
Models name each parameter's dims with *logical* axes ("embed",
"heads", "vocab", …); the rule table maps them to mesh axes, so a
layout change is a rule edit, not a model edit. A spec is a tuple with
one entry per dim: a mesh axis name, a tuple of names, or None
(replicated along that dim); ``()`` is a fully replicated leaf.

Where JAX's ``device_put`` lays a leaf out on the mesh as one global
array, the port keeps its pieces, for the one controller that drives
them:

- :func:`shard_tree` (serving, the ``tensor`` axis only) hands back one
  tree per position on the ``tensor`` axis, each holding that shard's
  piece, a replicated leaf copied once per device and shared by the
  shards on it (``compute/generate.py``);
- :func:`place_tree` (training, every axis) turns each leaf into a
  :class:`Sharded`: one piece per mesh position, cut along each dim
  whose spec names a mesh axis larger than 1 and replicated over the
  axes it does not name, each piece a copy of its own even where two
  positions name one device (so a train step's sum over a replicated
  piece's copies and its equal update of each run the same code on one
  card as on many). :func:`tree_shardings` records each leaf's layout
  (:class:`NamedSharding`, JAX ``sharding.py:65``) and
  :meth:`Sharded.gather_at` reassembles what a position sees over some
  axes, differentiably.

A dim that does not divide by its axes is refused (JAX pads uneven
shards). The auto-SPMD helpers (``constrain``, ``embed_lookup``) have
no counterpart: the port's engine and models shard by hand, as JAX's
engine does inside its manual ``shard_map`` (``generate.py:1116-1135``).
"""

import dataclasses
import functools
import math

import torch

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


# ------------------------------------------------------- every axis

def _names(entry):
    """A spec entry → the mesh axes it names, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A leaf's layout on a mesh, JAX's ``NamedSharding``: ``spec`` has
    one entry per leading dim (missing trailing entries replicate)."""

    mesh: object
    spec: tuple

    def dim_axes(self, ndim):
        """Per dim, the mesh axes larger than 1 that cut it."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [tuple(a for a in _names(e) if self.mesh.shape[a] > 1)
                for e in spec]

    def check(self, shape, name):
        """Raise ``ValueError`` naming the leaf, the dim and the axes
        where ``shape`` does not divide (or the spec is malformed)."""
        if len(self.spec) > len(shape):
            raise ValueError(f"{name}: spec {self.spec} has more entries "
                             f"than the leaf's {len(shape)} dims")
        named = [a for e in self.spec for a in _names(e)]
        if len(set(named)) != len(named):
            raise ValueError(f"{name}: spec {self.spec} names a mesh axis "
                             f"twice")
        for dim, axes in enumerate(self.dim_axes(len(shape))):
            k = math.prod(self.mesh.shape[a] for a in axes)
            if shape[dim] % k:
                raise ValueError(
                    f"{name}: dim {dim} of size {shape[dim]} does not "
                    f"divide over {axes} = {k} (the port refuses uneven "
                    f"shards, which JAX pads)")

    def bounds(self, shape, position):
        """Per dim, ``(start, length)`` of position's piece."""
        coords = self.mesh.coords(position)
        out = []
        for dim, axes in enumerate(self.dim_axes(len(shape))):
            idx = 0
            for a in axes:
                idx = idx * self.mesh.shape[a] + coords[a]
            n = shape[dim] // math.prod(self.mesh.shape[a] for a in axes)
            out.append((idx * n, n))
        return out

    @functools.cached_property
    def copies(self):
        """The groups of positions holding the same piece (one group a
        piece, each in position order, groups by their first)."""
        named = [a for e in self.spec for a in _names(e)]
        groups = {}
        for p in range(self.mesh.size):
            c = self.mesh.coords(p)
            groups.setdefault(tuple(c[a] for a in named), []).append(p)
        return sorted(groups.values())


class Sharded:
    """One logical tensor laid out on a mesh: ``pieces[p]`` is position
    ``p``'s piece, on ``mesh.devices[p]``; ``shape`` is the logical
    shape and ``sharding`` the layout."""

    __slots__ = ("pieces", "sharding", "shape")

    def __init__(self, pieces, sharding, shape):
        self.pieces = list(pieces)
        self.sharding = sharding
        self.shape = tuple(shape)

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def spec(self):
        return self.sharding.spec

    def map(self, fn):
        """``fn`` on every piece (keeping each piece's shape) → a
        :class:`Sharded` of the same layout."""
        return Sharded([fn(t) for t in self.pieces], self.sharding,
                       self.shape)

    def gather_at(self, position, axes=mesh_lib.AXIS_ORDER, cast=None):
        """What ``position`` sees of the leaf gathered over ``axes``: its
        own piece joined, along each dim cut by those axes, with the
        pieces of the positions that differ from it only there (its own
        coordinates, so its own copies, on every other axis), on its
        device. ``cast`` maps each piece before it moves (a dtype cast).
        Differentiable: the backward of the moves and the joins hands
        each piece the gradient of its slice."""
        mesh = self.mesh
        dev = mesh.devices[position]
        order = []
        for dim, names in enumerate(self.sharding.dim_axes(len(self.shape))):
            inside = [a for a in names if a in axes]
            if inside and len(inside) != len(names):
                raise ValueError(f"cannot gather dim {dim} over {inside} "
                                 f"alone: it is cut over {names}")
            order.extend((a, dim) for a in inside)

        def build(coords, rest):
            if not rest:
                t = self.pieces[mesh.position(coords)]
                return (t if cast is None else cast(t)).to(dev)
            (axis, dim), tail = rest[0], rest[1:]
            return torch.cat([build({**coords, axis: i}, tail)
                              for i in range(mesh.shape[axis])], dim=dim)

        return build(mesh.coords(position), order)

    @torch.no_grad()
    def gather(self, device=None):
        """The logical tensor as a fresh copy on ``device`` (default the
        first position's): the pieces of the positions at coordinate 0
        on every axis that does not cut the leaf."""
        t = self.gather_at(0)
        return t.to(device if device is not None else t.device, copy=True)


@torch.no_grad()
def place(tensor, spec, mesh, name="leaf"):
    """Cut ``tensor`` over ``mesh`` by ``spec`` → a :class:`Sharded`
    whose every position holds a copy of its own piece."""
    sh = NamedSharding(mesh, tuple(spec))
    sh.check(tuple(tensor.shape), name)
    pieces = []
    for p, dev in enumerate(mesh.devices):
        piece = tensor
        for dim, (start, n) in enumerate(sh.bounds(tuple(tensor.shape), p)):
            piece = piece.narrow(dim, start, n)
        pieces.append(torch.empty(piece.shape, dtype=piece.dtype,
                                  device=dev).copy_(piece))
    return Sharded(pieces, sh, tensor.shape)


def tree_shardings(mesh, logical_tree):
    """Each leaf's :class:`NamedSharding` on ``mesh`` under
    :data:`DEFAULT_RULES`."""
    return _map(lambda spec: NamedSharding(mesh, spec),
                tree_specs(logical_tree), is_leaf=_is_axes)


def place_tree(tree, mesh, logical_tree=None):
    """Every tensor of ``tree`` placed on ``mesh`` by its logical axes
    under :data:`DEFAULT_RULES` (``logical_tree`` None: every leaf
    replicated) → the same structure of :class:`Sharded` leaves. Raises
    ``ValueError`` naming the leaf whose dim does not divide."""
    specs = None if logical_tree is None else tree_specs(logical_tree)

    def walk(t, spec, path):
        if isinstance(t, dict):
            return {k: walk(v, None if spec is None else spec[k],
                            f"{path}/{k}" if path else str(k))
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, None if spec is None else spec[i],
                                f"{path}/{i}") for i, v in enumerate(t))
        return place(t, () if spec is None else spec, mesh, path)

    return walk(tree, specs, "")


def gather_tree(tree, device="cpu"):
    """Every :class:`Sharded` leaf of ``tree`` gathered into a fresh
    logical tensor on ``device``, every other tensor copied there."""
    return _map(lambda x: x.gather(device) if isinstance(x, Sharded)
                else x.detach().to(device, copy=True)
                if torch.is_tensor(x) else x, tree,
                is_leaf=lambda x: isinstance(x, Sharded))


def mesh_of(tree):
    """The mesh ``tree``'s :class:`Sharded` leaves lie on, or None."""
    meshes = []
    _map(lambda x: meshes.append(x.mesh) if isinstance(x, Sharded)
         else None, tree, is_leaf=lambda x: isinstance(x, Sharded))
    return meshes[0] if meshes else None


def pieces_of(leaves):
    """A list of leaves with each :class:`Sharded` expanded into its
    pieces in position order."""
    return [t for x in leaves
            for t in (x.pieces if isinstance(x, Sharded) else (x,))]


def local(tree, position):
    """``tree`` with each :class:`Sharded` leaf replaced by ``position``'s
    piece."""
    return _map(lambda x: x.pieces[position] if isinstance(x, Sharded)
                else x, tree, is_leaf=lambda x: isinstance(x, Sharded))


def from_local(trees, like):
    """One tree of tensors per position → the tree of :class:`Sharded`
    leaves with ``like``'s layouts (the reverse of :func:`local`)."""
    return _map(lambda leaf, *pieces: Sharded(pieces, leaf.sharding,
                                              leaf.shape),
                like, *trees, is_leaf=lambda x: isinstance(x, Sharded))


def check_layout(tree, logical_tree, what):
    """Raise ``ValueError`` unless every leaf of ``tree`` is cut as the
    default rules cut ``logical_tree`` on its mesh (the layout the
    models' mesh forwards compute on)."""
    def check(leaf, spec):
        want = NamedSharding(leaf.mesh, tuple(spec)).dim_axes(len(leaf.shape))
        if leaf.sharding.dim_axes(len(leaf.shape)) != want:
            raise ValueError(
                f"{what}: a leaf of shape {leaf.shape} lies by spec "
                f"{leaf.spec}; its mesh forward needs the default rules' "
                f"{spec}")

    _map(check, tree, tree_specs(logical_tree),
         is_leaf=lambda x: isinstance(x, Sharded))
