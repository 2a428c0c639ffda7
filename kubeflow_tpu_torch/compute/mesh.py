"""Device meshes for the port's sharded serving and training.

Port of ``kubeflow_tpu/compute/mesh.py``: the canonical axis names and
their order (:97-110), ``MeshSpec`` (:113), ``make_mesh`` (:144),
``topology_chips`` (``api/tpuslice.py:30``), ``mesh_for_slice`` (:167)
and ``mesh_for_generation`` (:181). A JAX mesh is a grid of devices
that one controller drives through ``shard_map`` or XLA's partitioner;
here a :class:`Mesh` is the same grid of ``torch.device``s, and the one
controller is the generation engine (``compute/generate.py``) or the
train step (``compute/train.py``), which runs each position's share on
that position's device and moves tensors between them. A position's
coordinates (:meth:`Mesh.coords`) and the groups of positions along an
axis (:meth:`Mesh.along`) say which pieces a position holds and with
whom it reduces.

A mesh may name one device more than once: ``["cpu"] * 4`` is four CPU
shards, the counterpart of JAX's forced host-device mesh, and
``["cuda:0", "cuda:0"]`` is two shards on one card. ``devices=None``
means every CUDA card, and raises on a host without CUDA (there is no
silent fallback to the CPU; ``device.resolve``).

``device_slice_groups``, ``make_multislice_mesh``, ``multislice_layout``,
``distributed_env`` and ``initialize_distributed`` (multi-slice and
multi-process meshes) come with the port's slice worker.
"""

import dataclasses
import itertools
import math

import torch

from . import device as device_lib

DATA = "data"
PIPELINE = "pipeline"
FSDP = "fsdp"
SEQUENCE = "sequence"
TENSOR = "tensor"
EXPERT = "expert"

#: canonical axis order, outermost → innermost (the JAX package's)
AXIS_ORDER = (DATA, PIPELINE, FSDP, EXPERT, SEQUENCE, TENSOR)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes per parallelism axis; -1 on at most one axis means "fill with
    the remaining devices" (like a reshape wildcard)."""

    data: int = 1
    pipeline: int = 1
    fsdp: int = 1
    sequence: int = 1
    tensor: int = 1
    expert: int = 1

    def resolved(self, n_devices):
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis, got {wild}")
        known = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by {known}")
            sizes[wild[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {known} devices, have {n_devices}")
        return sizes


class Mesh:
    """A grid of devices over :data:`AXIS_ORDER`: ``devices`` in
    row-major order (the innermost axis, ``tensor``, fastest) and
    ``shape`` the size of each axis, size-1 axes kept, as JAX keeps
    them."""

    def __init__(self, devices, sizes):
        self.devices = tuple(devices)
        self.shape = {a: int(sizes[a]) for a in AXIS_ORDER}
        if math.prod(self.shape.values()) != len(self.devices):
            raise ValueError(f"mesh {self.shape} needs "
                             f"{math.prod(self.shape.values())} devices, "
                             f"have {len(self.devices)}")

    @property
    def size(self):
        return len(self.devices)

    def coords(self, position):
        """Position ``position`` (an index into ``devices``) → ``{axis:
        index}`` over :data:`AXIS_ORDER`, ``tensor`` fastest."""
        out = {}
        for axis in reversed(AXIS_ORDER):
            position, out[axis] = divmod(position, self.shape[axis])
        return {a: out[a] for a in AXIS_ORDER}

    def position(self, coords):
        """``{axis: index}`` (axes left out at 0) → the position."""
        p = 0
        for axis in AXIS_ORDER:
            p = p * self.shape[axis] + coords.get(axis, 0)
        return p

    def along(self, position, axes):
        """The positions that agree with ``position`` on every axis but
        ``axes``, in position order (``position`` among them): the group
        a reduction over ``axes`` runs in."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        base = self.coords(position)
        grid = [range(self.shape[a]) if a in axes else (base[a],)
                for a in AXIS_ORDER]
        return [self.position(dict(zip(AXIS_ORDER, c)))
                for c in itertools.product(*grid)]


def _devices(devices):
    """``None`` → every CUDA card in index order (raises without CUDA);
    otherwise each entry through ``device.resolve``."""
    if devices is None:
        device_lib.resolve(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device_lib.resolve(d) for d in devices]


def make_mesh(spec=None, devices=None, **axis_sizes):
    """A :class:`Mesh` from a ``MeshSpec`` (or axis sizes as kwargs) over
    ``devices`` (default: every CUDA card)."""
    if spec is None:
        spec = MeshSpec(**axis_sizes)
    devices = _devices(devices)
    return Mesh(devices, spec.resolved(len(devices)))


def topology_chips(topology):
    """'4x4' or '2x2x4' -> total chip count (a copy of the JAX package's
    ``api/tpuslice.py:30``, the one place topology is parsed)."""
    n = 1
    for d in topology.lower().split("x"):
        n *= int(d)
    return n


def mesh_for_slice(accelerator="", topology="", tensor=1, sequence=1,
                   fsdp=1, expert=1, devices=None):
    """Mesh for one slice: explicit inner axes, ``data`` fills the rest.
    ``accelerator`` and ``topology`` are advisory, as in JAX: the device
    count comes from ``devices`` (default: every CUDA card)."""
    return make_mesh(
        MeshSpec(data=-1, fsdp=fsdp, sequence=sequence, tensor=tensor,
                 expert=expert),
        devices=devices)


def mesh_for_generation(tensor=1, devices=None):
    """Serving mesh for the tensor-sharded ``GenerationEngine``: exactly
    ``tensor`` devices on the ``tensor`` axis, every other axis size 1.
    Takes the FIRST ``tensor`` devices in index order (``devices``
    default: the CUDA cards), as JAX takes the first in id order.
    ``tensor=1`` still builds a valid mesh, on which the engine
    reproduces the unsharded engine byte for byte."""
    devices = _devices(devices)
    tensor = int(tensor)
    if tensor < 1:
        raise ValueError(f"tensor must be >= 1, got {tensor}")
    if tensor > len(devices):
        raise ValueError(
            f"tensor={tensor} needs {tensor} devices, have "
            f"{len(devices)}")
    devices = sorted(devices, key=lambda d: d.index or 0)
    return make_mesh(MeshSpec(tensor=tensor), devices=devices[:tensor])
