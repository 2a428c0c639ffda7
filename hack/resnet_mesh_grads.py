"""ResNet's fp32 gradients on a ``data=2`` mesh and on one device, each
held against a float64 gradient of the same step.

    python3 hack/resnet_mesh_grads.py [--device cuda:0] [--width 64] \
        [--image 224] [--images 8]

The model is ResNet-50 (``chip_smoke.py``'s ``resnet_mesh`` fp32 check:
8 images of 224², classes 1000), at two sets of weights: the seed's
init (``resnet.init_params``; each block's last BN scale is 0) and every
BN randomised (``chip_smoke.resnet_weights``). For each, the gradient of
the loss at every leaf from:

- ``unsharded_f64`` — one device, the compute dtype float64; the port
  computes batch-norm statistics in fp32 (``x.float()``), so for this
  run ``torch.Tensor.float`` keeps a float64 tensor as it is;
- ``mesh_f64`` — the same on the mesh (two batch pieces, sync BN);
- ``unsharded_f32``, ``mesh_f32`` — the fp32 model as trained;
- ``unsharded_f32_reordered`` — one device, fp32, the batch's halves
  swapped: what a different summation order alone moves.

Prints the card's name and power limit (on a card), then one JSON line
per weight set and run: the worst leaf error against ``unsharded_f64``
(max |Δg| over the leaf's max |g|, ``chip_smoke._leaf_errors``), the leaf
it is on, and the grad norms. TF32 is off. On the CPU use a small
``--width``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kubeflow_tpu_torch.compute import data, mesh as mesh_lib  # noqa: E402
from kubeflow_tpu_torch.compute import device as device_lib  # noqa: E402
from kubeflow_tpu_torch.compute import train  # noqa: E402
from kubeflow_tpu_torch.compute.models import resnet  # noqa: E402

_float = torch.Tensor.float


def _keep_float64(self, *args, **kwargs):
    return self if self.dtype == torch.float64 else _float(self, *args,
                                                            **kwargs)


def leaf_names(tree, path=""):
    """``train.tree_leaves``' order, each leaf by its path."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                             f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{path}/{i}")]
    return [path]


def gradients(weights, host, dtype, on_mesh, dev, config):
    """Every leaf's gradient (float64, host) and the loss, one forward
    and backward of ``weights`` on ``host``."""
    cfg = resnet.Config(**{**config, "dtype": dtype})
    params, stats = weights
    if dtype == "float64":
        params = train.tree_map(lambda t: t.double(), params)
        torch.Tensor.float = _keep_float64
    try:
        opt = train.make_optimizer(1e-3, warmup_steps=0, total_steps=100)
        where = (dict(mesh=mesh_lib.make_mesh(data=2, devices=[dev] * 2),
                      logical_axes=resnet.logical_axes(cfg)[0])
                 if on_mesh else dict(device=dev))
        st = train.init_state(
            lambda g, device: train.tree_map(torch.clone, params), opt,
            extra=train.tree_map(torch.clone, stats), **where)
        loss = train.stateful_loss(resnet.loss_fn, cfg)
        if on_mesh:
            value, grads = cs.mesh_grads(st, loss, data.shard_batch(
                host, where["mesh"]))
        else:
            out = loss(st.params, st.extra, data.to_device(host, dev))[0]
            grads = train._grads(out, train.tree_leaves(st.params))
            value = float(out.detach())
    finally:
        torch.Tensor.float = _float
    return [g.detach().double().cpu() for g in grads], value


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--images", type=int, default=8)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device.startswith("cuda"):
        print(device_lib.card_identity())
    config = dict(depth=50, n_classes=1000, width=args.width)
    cfg32 = resnet.Config(**config, dtype="float32")
    host = next(data.synthetic_images(args.images, args.image, 1000,
                                      seed=16))
    half = args.images // 2
    order = list(range(half, args.images)) + list(range(half))
    reordered = {k: v[order] for k, v in host.items()}
    init = resnet.init_params(cfg32, torch.Generator().manual_seed(15),
                              device="cpu")
    randomised = [train.tree_map(lambda t: t.cpu(), w) for w in
                  cs.resnet_weights(cfg32, seed=15, device=args.device)]
    names = leaf_names(init[0])
    for label, weights in (("init", init), ("bn_randomised", randomised)):
        ref, ref_loss = gradients(weights, host, "float64", False,
                                  args.device, config)
        runs = {"mesh_f64": (host, "float64", True),
                "unsharded_f32": (host, "float32", False),
                "mesh_f32": (host, "float32", True),
                "unsharded_f32_reordered": (reordered, "float32", False)}
        for run, (batch, dtype, on_mesh) in runs.items():
            grads, value = gradients(weights, batch, dtype, on_mesh,
                                     args.device, config)
            errs = cs._leaf_errors(grads, ref)
            worst = max(range(len(errs)), key=errs.__getitem__)
            print(json.dumps({
                "weights": label, "run": run, "device": args.device,
                "width": args.width, "image": args.image,
                "images": args.images, "leaf_rel_max": errs[worst],
                "worst_leaf": names[worst],
                "loss": value, "loss_f64": ref_loss,
                "grad_norm": float(torch.sqrt(sum(
                    g.square().sum() for g in grads))),
                "grad_norm_f64": float(torch.sqrt(sum(
                    g.square().sum() for g in ref)))}))


if __name__ == "__main__":
    main()
