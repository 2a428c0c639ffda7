"""The reference's first steps of training: the same initial float32
weights (drawn again from the seed), the same rows, the plain loss and
autograd, the plain AdamW."""

import torch

from ..inputs import weights
from . import model as ref_model
from .optim import AdamW


def follow(config, seed, rows, optimizer, device, precision="fp32",
           half_batch=False, block=512):
    """Steps the reference over ``rows`` (one ``[B, S + 1]`` int64
    batch a step) → ``{"loss": [float a step], "grad": {path: norm of
    the first step's clipped gradient}, "change": {path: ‖weights after
    the last step − initial weights‖}}``. ``optimizer`` holds
    ``lr``, ``b1``, ``b2``, ``eps``, ``weight_decay``, ``clip_norm`` and
    ``total_steps``."""
    m = ref_model.Model.of(config)
    params = weights.make(config, seed, device, torch.float32)
    flat = dict(weights.flat(params))
    for t in flat.values():
        t.requires_grad_(True)
    opt = AdamW(**optimizer)
    out = {"loss": [], "grad": None, "change": {}}
    with ref_model.fp32_matmuls():
        for r in rows:
            loss = ref_model.loss(params, r, m, precision, block, half_batch)
            grads = torch.autograd.grad(loss, list(flat.values()))
            norms = opt.step(flat, dict(zip(flat, grads)))
            del grads
            out["loss"].append(float(loss.detach()))
            if out["grad"] is None:
                out["grad"] = {k: float(v) for k, v in norms.items()}
    for path, t in flat.items():
        start = weights.make_leaf(config, path, seed, device, torch.float32)
        out["change"][path] = float(torch.linalg.vector_norm(
            t.detach() - start))
        del start
    return out
