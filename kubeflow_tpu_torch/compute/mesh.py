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

A mesh may span processes (``make_mesh(group=)``, the slice worker's
gang): only its ``data`` axis crosses them, each process builds the mesh
over its own positions (its slice of ``data``, every other axis whole)
and :func:`global_sum` adds a loss term over the gang: every model's
mesh loss sums its loss and metric terms over the processes with it,
and ResNet's batch norm sums its moments with :func:`global_sum_synced`
(sync BN over the gang, whose backward sums too). ``pipeline.train_1f1b``
runs on such a mesh too: the gang joins the global batch and each
microbatch's last-stage outputs (JAX's global microbatches), every
process applies the loss to the whole microbatch, the aux statistics
and the layer gradients are summed over the gang, and each process gets
the global loss and gradients back. ``distributed_env``
and ``initialize_distributed`` (:300-332) join the gang from the env the
control plane injects; ``device_slice_groups``, ``make_multislice_mesh``
and ``multislice_layout`` (:206-272) are JAX's pure layout, a process
standing for a slice.
"""

import dataclasses
import itertools
import logging
import math
import os

import torch

from . import device as device_lib

log = logging.getLogger(__name__)

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
    them.

    On a gang of processes (``group``, a ``torch.distributed`` process
    group) the mesh is this process's part of the gang's: ``shape`` its
    own positions, process ``process_index`` of ``process_count``
    holding the gang's ``data`` coordinates ``[index·d, (index+1)·d)``
    (process-major, ``data`` outermost); :attr:`global_shape` is the
    gang's."""

    def __init__(self, devices, sizes, group=None, process_index=0,
                 process_count=1):
        self.devices = tuple(devices)
        self.shape = {a: int(sizes[a]) for a in AXIS_ORDER}
        if math.prod(self.shape.values()) != len(self.devices):
            raise ValueError(f"mesh {self.shape} needs "
                             f"{math.prod(self.shape.values())} devices, "
                             f"have {len(self.devices)}")
        self.group = group
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    @property
    def global_shape(self):
        """The gang's axis sizes (``shape`` with ``data`` times the
        processes)."""
        return {**self.shape, DATA: self.shape[DATA] * self.process_count}

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


def make_mesh(spec=None, devices=None, group=None, **axis_sizes):
    """A :class:`Mesh` from a ``MeshSpec`` (or axis sizes as kwargs) over
    ``devices`` (default: every CUDA card).

    With ``group`` (a process group, ``torch.distributed.group.WORLD``
    for the whole gang) ``devices`` are this process's positions and
    the spec is resolved over every process's (their count times the
    gang's size, as JAX resolves it over ``jax.devices()``); the mesh
    returned is this process's part. Only ``data`` may cross processes:
    a spec whose ``data`` does not divide over them raises
    ``ValueError`` naming the axes that would."""
    if spec is None:
        spec = MeshSpec(**axis_sizes)
    devices = _devices(devices)
    if group is None:
        return Mesh(devices, spec.resolved(len(devices)))
    import torch.distributed as dist
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    sizes = spec.resolved(len(devices) * world)
    if sizes[DATA] % world:
        inner = {a: n for a, n in sizes.items() if a != DATA and n > 1}
        raise ValueError(
            f"only the data axis may span processes: data={sizes[DATA]} "
            f"does not divide over {world} processes of {len(devices)} "
            f"positions, which would put {inner} across them")
    return Mesh(devices, {**sizes, DATA: sizes[DATA] // world},
                group=group, process_index=rank, process_count=world)


def global_sum(t, mesh):
    """``t`` summed over the processes of ``mesh``'s gang (itself on a
    one-process mesh). Every process gets the same total; under autograd
    its gradient reaches this process's own ``t`` alone, so each
    process's objective is its share of the gang's and the shares'
    gradients sum to the gang's gradient."""
    if mesh.process_count == 1:
        return t
    import torch.distributed as dist
    total = t.detach().clone()
    dist.all_reduce(total, group=mesh.group)
    return total + (t - t.detach()) if t.requires_grad else total


class _SyncedSum(torch.autograd.Function):
    """The psum and its transpose: ``all_reduce`` forward and backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        import torch.distributed as dist
        total = t.clone()
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        total = grad.contiguous().clone()
        dist.all_reduce(total, group=ctx.group)
        return total, None


def global_sum_synced(t, mesh):
    """``t`` summed over the processes of ``mesh``'s gang (itself on a
    one-process mesh), whose gradient is summed over them too: JAX's
    ``psum`` under a global ``jit``. Each process's input then gets
    the gradient of every process's objective through the total, the
    cross terms that :func:`global_sum` leaves out. That is right for a
    statistic that every process's outputs depend on (batch norm's
    moments), where :func:`global_sum` is right for a loss term. Every
    process must build the same graph, so that the backward's
    collectives come in the same order on each."""
    if mesh.process_count == 1:
        return t
    return _SyncedSum.apply(t, mesh.group)


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


# --------------------------------------------------- multi-slice layout

def device_slice_groups(devices=None):
    """Group devices (default: every CUDA card) by slice
    (``slice_index``; devices without one, a ``torch.device`` among
    them, form one group), ordered by slice index, each by ``id`` within
    (JAX ``device_slice_groups``, :206). The groups must be
    equal-sized: multislice meshes are rectangular. In the port a slice
    is a process of the gang."""
    if devices is None:
        devices = _devices(None)
    groups = {}
    for d in devices:
        groups.setdefault(getattr(d, "slice_index", 0), []).append(d)
    sizes = {len(g) for g in groups.values()}
    if len(sizes) > 1:
        raise ValueError(
            f"unequal slice sizes {sorted(sizes)}: multislice meshes "
            f"must be rectangular (got "
            f"{ {k: len(v) for k, v in groups.items()} })")
    return [sorted(groups[k], key=lambda d: getattr(d, "id", 0))
            for k in sorted(groups)]


def make_multislice_mesh(fsdp=1, sequence=1, tensor=1, expert=1,
                         devices=None):
    """A mesh whose ``data`` spans slices and whose model axes stay
    inside one (JAX ``make_multislice_mesh``, :230); one slice is a
    plain mesh."""
    groups = device_slice_groups(_devices(devices))
    ordered, spec = multislice_layout(groups, fsdp=fsdp, sequence=sequence,
                                      tensor=tensor, expert=expert)
    return make_mesh(spec, devices=ordered)


def multislice_layout(groups, fsdp=1, sequence=1, tensor=1, expert=1):
    """The pure layout of :func:`make_multislice_mesh` (JAX
    ``multislice_layout``, :247) → ``(ordered devices, MeshSpec)`` with
    ``data`` = slices × (per slice // the inner axes)."""
    for name, size in (("fsdp", fsdp), ("sequence", sequence),
                       ("tensor", tensor), ("expert", expert)):
        if size < 1:
            raise ValueError(
                f"{name}={size}: multislice inner axes must be >= 1 "
                f"(the -1 wildcard lives on data, which is computed)")
    per_slice = len(groups[0])
    inner = fsdp * sequence * tensor * expert
    if per_slice % inner:
        raise ValueError(
            f"slice of {per_slice} chips not divisible by inner axes "
            f"fsdp×sequence×tensor×expert = {inner}")
    data = len(groups) * (per_slice // inner)
    ordered = [d for g in groups for d in g]
    return ordered, MeshSpec(data=data, fsdp=fsdp, sequence=sequence,
                             tensor=tensor, expert=expert)


# ------------------------------------------------------ the gang

def distributed_env():
    """The worker env the control plane injects (JAX
    ``distributed_env``, :300): ``(coordinator, num_processes,
    process_id)``, or None outside a multi-worker slice. The names are
    the platform's (``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``,
    ``JAX_COORDINATOR_ADDRESS``); the coordinator defaults to the first
    host's port 8476."""
    worker_id = os.environ.get("TPU_WORKER_ID")
    hostnames = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if worker_id is None or not hostnames:
        return None
    hosts = [h.strip() for h in hostnames.split(",") if h.strip()]
    if coordinator is None:
        coordinator = f"{hosts[0]}:8476"
    return coordinator, len(hosts), int(worker_id)


def process_device(device=None, rank=0, world=1):
    """This process's device in a gang of ``world``: ``device`` when
    named (every process of the gang names the same one, so they share
    it), else a card: ``cuda:<rank>`` when there are at least as many
    cards as processes, else the cards in turn (raises without CUDA)."""
    if device is not None:
        return device_lib.resolve(device)
    device_lib.resolve(None)
    return torch.device("cuda", rank % torch.cuda.device_count())


def gang_backend(device=None, world=1):
    """The collective backend of a gang whose processes take
    ``process_device(device, ...)``: ``nccl`` when each process has a
    card of its own (``device`` unnamed and at least ``world`` cards),
    ``gloo`` on the CPU or where processes share a card (NCCL refuses
    two ranks on one card; gloo reduces a CUDA tensor through host
    copies)."""
    if device is None and torch.cuda.is_available() \
            and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def initialize_distributed(device=None):
    """Join the gang from :func:`distributed_env` (JAX
    ``initialize_distributed``, :316): ``torch.distributed.
    init_process_group(backend, init_method="tcp://<coordinator>",
    world_size, rank)``, the backend by :func:`gang_backend` for
    ``device`` (as :func:`process_device` takes it), logged. Without
    the env it does nothing and returns False; a backend this build of
    PyTorch lacks raises ``RuntimeError``."""
    env = distributed_env()
    if env is None:
        return False
    import torch.distributed as dist
    coordinator, world, rank = env
    backend = gang_backend(device, world)
    if not dist.is_backend_available(backend):
        raise RuntimeError(f"the {backend} backend is not available in "
                           f"this build of PyTorch")
    log.info("joining a gang of %d at %s as rank %d over %s", world,
             coordinator, rank, backend)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)
    return True
