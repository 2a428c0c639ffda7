"""MNIST MLP — the smallest end-to-end workload and the default StudyJob
trial objective. Port of ``kubeflow_tpu/compute/models/mlp.py``; the
params keep JAX's layout (``{"layers": [{"w", "b"}, ...]}``) and logical
axes (:28).

On a training mesh (:func:`loss_fn` given ``sharding.Sharded`` params)
every layer is column-sharded over ``tensor``: each position of a batch
piece computes its columns (``w`` gathered over ``fsdp``), and the
columns are joined on the piece's lead position before the next layer.
The loss and accuracy are the global batch's: summed over the pieces
(and, on a mesh across processes, over the gang), divided by the
gang's rows.
"""

import dataclasses
import functools

import torch
import torch.nn.functional as F

from .. import device as device_lib
from .. import mesh as mesh_lib
from .. import sharding


@dataclasses.dataclass(frozen=True)
class Config:
    in_dim: int = 784
    hidden: int = 512
    n_classes: int = 10
    n_layers: int = 2
    dtype: str = "float32"


def _dims(config):
    return ([config.in_dim] + [config.hidden] * config.n_layers
            + [config.n_classes])


def param_count(config):
    dims = _dims(config)
    return sum(d_in * d_out + d_out
               for d_in, d_out in zip(dims[:-1], dims[1:]))


def logical_axes(config):
    """Every layer ``w`` (embed, mlp), ``b`` (mlp) — JAX's."""
    return {"layers": [{"w": ("embed", "mlp"), "b": ("mlp",)}
                       for _ in range(config.n_layers + 1)]}


def init_params(config, generator=None, *, device=None):
    """fp32 weights N(0, 1) · fan-in^-1/2 and zero biases, drawn on the
    CPU from ``generator`` (a fresh one seeded 0 when None), on
    ``device`` (None → the card). JAX's scheme, not its numbers."""
    dev = device_lib.resolve(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dims = _dims(config)
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        layers.append({
            "w": (torch.randn((d_in, d_out), generator=generator,
                              dtype=torch.float32) * d_in ** -0.5).to(dev),
            "b": torch.zeros((d_out,), device=dev),
        })
    return {"layers": layers}


def _forward(x, layers, config):
    """The layer loop → logits. ``layers[i]`` is layer i's column
    pieces, ``[(w, b), ...]``: each piece's columns computed on its
    weight's device, joined on ``x``'s before the next layer. One piece
    a layer is the unsharded model."""
    dt = getattr(torch, config.dtype)
    x = x.reshape(x.shape[0], -1).to(dt)
    for i, cols in enumerate(layers):
        outs = []
        for w, b in cols:
            y = x.to(w.device) @ w.to(dt) + b.to(dt)
            outs.append((y if i == len(layers) - 1
                         else torch.relu(y)).to(x.device))
        x = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    return x


def apply(params, x, config):
    return _forward(x, [[(lp["w"], lp["b"])] for lp in params["layers"]],
                    config)


def _nll(logits, labels):
    return -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]


def loss_fn(params, batch, config):
    """Mean cross entropy and accuracy; on a mesh (params placed by
    ``train.init_state(mesh=)``) those of the global batch. On a mesh
    across processes the sums are the gang's (``mesh.global_sum``):
    every process reports the gang's loss and accuracy, and its
    gradient is its own share of the gang's."""
    mesh = sharding.mesh_of(params)
    if mesh is not None:
        return _mesh_loss(params, batch, config, mesh)
    logits = apply(params, batch["image"], config).float()
    labels = batch["label"].long()
    nll = _nll(logits, labels)
    loss = nll.mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def _mesh_loss(params, batch, config, mesh):
    tp = mesh.shape[mesh_lib.TENSOR]
    for name, value in (("hidden", config.hidden),
                        ("n_classes", config.n_classes)):
        if value % tp:
            raise ValueError(f"{name}={value} does not divide over the "
                             f"mesh's tensor axis of {tp}")
    sharding.check_layout(params, logical_axes(config), "the MLP")
    nll_sum, correct, rows = [], [], 0
    dev = mesh.devices[0]
    for lead in mesh.along(0, (mesh_lib.DATA, mesh_lib.FSDP)):
        layers = [[(lp["w"].gather_at(q, (mesh_lib.FSDP,)), lp["b"].pieces[q])
                   for q in mesh.along(lead, mesh_lib.TENSOR)]
                  for lp in params["layers"]]
        logits = _forward(batch["image"].pieces[lead], layers,
                          config).float()
        labels = batch["label"].pieces[lead].long()
        nll_sum.append(_nll(logits, labels).sum().to(dev))
        correct.append((logits.argmax(-1) == labels).float().sum().to(dev))
        rows += labels.shape[0]
    rows *= mesh.process_count
    loss = mesh_lib.global_sum(functools.reduce(torch.add, nll_sum),
                               mesh) / rows
    acc = mesh_lib.global_sum(functools.reduce(torch.add, correct),
                              mesh) / rows
    return loss, {"loss": loss, "accuracy": acc}
