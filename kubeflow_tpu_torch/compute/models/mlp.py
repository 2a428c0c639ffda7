"""MNIST MLP — the smallest end-to-end workload and the default StudyJob
trial objective. Port of ``kubeflow_tpu/compute/models/mlp.py``; the
params keep JAX's layout (``{"layers": [{"w", "b"}, ...]}``)."""

import dataclasses

import torch
import torch.nn.functional as F

from .. import device as device_lib


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


def apply(params, x, config):
    dt = getattr(torch, config.dtype)
    x = x.reshape(x.shape[0], -1).to(dt)
    *hidden, last = params["layers"]
    for lp in hidden:
        x = torch.relu(x @ lp["w"].to(dt) + lp["b"].to(dt))
    return x @ last["w"].to(dt) + last["b"].to(dt)


def loss_fn(params, batch, config):
    logits = apply(params, batch["image"], config).float()
    labels = batch["label"].long()
    nll = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    loss = nll.mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}
