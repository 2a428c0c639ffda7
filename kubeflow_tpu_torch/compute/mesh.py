"""Device meshes for the port's tensor-sharded serving.

Port of ``kubeflow_tpu/compute/mesh.py``: the canonical axis names and
their order (:97-110), ``MeshSpec`` (:113), ``make_mesh`` (:144) and
``mesh_for_generation`` (:181). A JAX mesh is a grid of devices that
one controller drives through ``shard_map``; here a :class:`Mesh` is
the same grid of ``torch.device``s, and the one controller is the
generation engine itself, which runs each shard's slice on that shard's
device and moves activations between them (``compute/generate.py``).

A mesh may name one device more than once: ``["cpu"] * 4`` is four CPU
shards, the counterpart of JAX's forced host-device mesh, and
``["cuda:0", "cuda:0"]`` is two shards on one card. ``devices=None``
means every CUDA card, and raises on a host without CUDA (there is no
silent fallback to the CPU; ``device.resolve``).

The slice meshes (``mesh_for_slice``, ``device_slice_groups``) and
multi-host initialization come with the port's training mesh and slice
worker.
"""

import dataclasses
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
