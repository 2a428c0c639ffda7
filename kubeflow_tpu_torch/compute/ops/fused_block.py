"""K8 — one identity ResNet bottleneck block in eval mode as a single
hand-written CUDA kernel (``csrc/fused_block.cu``) beside its plain
PyTorch version.

Replaces the Pallas TPU kernel of
``kubeflow_tpu/compute/ops/fused_block.py``: ``_kernel`` (:68, through
``_run`` :98 and ``fused_bottleneck_eval`` :121).

Eval-mode batch norm is affine, so :func:`fold_bn` folds it into the
conv weights and a bias and the block (conv1×1 → BN → relu → conv3×3 →
BN → relu → conv1×1 → BN → +residual → relu) becomes a chain of three
matrix products over the pixels of an NHWC activation::

    c1 = relu(X · W1 + b1)                    X: [N·H·W, C]
    c2 = relu(im2col₃ₓ₃(c1) · W2 + b2)        (K = 9M, taps dy major)
    y  = relu(c2 · W3 + b3 + X)

with fp32 sums, the biases and the residual added in fp32 and ``c1``,
``c2`` and ``y`` each rounded once to x's dtype. The kernel keeps ``c1``
and ``c2`` in shared memory: the block reads x once from device memory
and writes y once.

:func:`fused_bottleneck_eval` launches the kernel for CUDA tensors and
takes the plain version (:func:`fused_bottleneck_reference`) only for
CPU tensors; on a CUDA tensor it launches or raises, never falls back.
It counts its launches on itself (``fused_bottleneck_eval.launches``).
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's reduction step: on the card the block's widths (conv0's
#: input channels C and the bottleneck width M) must be multiples
WIDTH_MULTIPLE = 32
_libs = {}


def fold_bn(conv_w, bn_params, bn_stats, eps=1e-5):
    """Eval BN is affine: ``y = conv(x, w)·s + b`` with ``s =
    scale/sqrt(var+eps)``, ``b = bias − mean·s``. Returns ``(w·s, b)``
    (``s`` along the weights' last, output-channel dim) so that a kernel,
    or any conv, applies BN as a bias add."""
    s = bn_params["scale"] * torch.rsqrt(bn_stats["var"] + eps)
    b = bn_params["bias"] - bn_stats["mean"] * s
    return conv_w * s, b


def folded_operands(block_params, block_stats, dtype, eps=1e-5):
    """The block's seven matmul-chain operands ``(w1 [C, M], b1, w2 [9,
    M, M], b2, w3 [M, C], b3)``: BN folded in fp32, THEN the weights cast
    to ``dtype``; the biases stay fp32. Raises ``ValueError`` for a block
    that is not an identity bottleneck (a projection, kernel sizes other
    than 1×1 / 3×3 / 1×1, or an output width other than the input's)."""
    if "proj" in block_params:
        raise ValueError(
            "fused_bottleneck_eval takes identity blocks only: this block "
            "has a projection (the first block of a stage)")
    missing = [k for k in ("conv0", "conv1", "conv2") if k not in block_params]
    if missing:
        raise ValueError(f"fused_bottleneck_eval takes bottleneck blocks "
                         f"(conv0, conv1, conv2); this one lacks {missing}")
    shapes = [tuple(block_params[f"conv{i}"].shape) for i in range(3)]
    (k0h, k0w, c_in, m), (k1h, k1w, m_in, m_out), (k2h, k2w, m3, c_out) = shapes
    if (k0h, k0w, k1h, k1w, k2h, k2w) != (1, 1, 3, 3, 1, 1) \
            or not m == m_in == m_out == m3:
        raise ValueError(f"fused_bottleneck_eval takes a 1x1 / 3x3 / 1x1 "
                         f"bottleneck of one width, got conv shapes {shapes}")
    if c_out != c_in:
        raise ValueError(
            f"fused_bottleneck_eval adds the input as the residual: conv2 "
            f"must give conv0's {c_in} input channels, not {c_out}")
    folded = []
    for i in range(3):
        w, b = fold_bn(block_params[f"conv{i}"].float(),
                       {k: v.float() for k, v in
                        block_params[f"bn{i}"].items()},
                       {k: v.float() for k, v in
                        block_stats[f"bn{i}"].items()}, eps)
        folded += [w, b.float().contiguous()]
    w1, b1, w2, b2, w3, b3 = folded
    return (w1.reshape(c_in, m).to(dtype).contiguous(), b1,
            w2.reshape(9, m, m).to(dtype).contiguous(), b2,
            w3.reshape(m, c_in).to(dtype).contiguous(), b3)


def matmul_chain_reference(x, w1, b1, w2, b2, w3, b3):
    """The kernel's arithmetic in plain PyTorch on folded operands, on
    any device: fp32 products of x-dtype operands, bias and residual
    added in fp32, ``c1``/``c2``/``y`` rounded to x's dtype; the 3×3 as
    an im2col over a zero-padded ``c1``, nine shifted views concatenated
    ``dy`` major, ``dx`` minor."""
    n, h, w, c = x.shape
    m = w1.shape[1]
    dt = x.dtype
    xf = x.reshape(-1, c).float()
    c1 = torch.relu(xf @ w1.float() + b1).to(dt)
    pad = F.pad(c1.reshape(n, h, w, m), (0, 0, 1, 1, 1, 1))
    col = torch.cat([pad[:, dy:dy + h, dx:dx + w, :]
                     for dy in range(3) for dx in range(3)], dim=-1)
    c2 = torch.relu(col.reshape(-1, 9 * m).float()
                    @ w2.reshape(9 * m, m).float() + b2).to(dt)
    y = c2.float() @ w3.float() + b3 + xf
    return torch.relu(y).to(dt).reshape(n, h, w, c)


def fused_bottleneck_reference(x, block_params, block_stats, eps=1e-5):
    """Plain version of K8, on any device; arguments and result as
    :func:`fused_bottleneck_eval`."""
    _check_input(x, block_params)
    return matmul_chain_reference(
        x, *folded_operands(block_params, block_stats, x.dtype, eps))


def _check_input(x, block_params):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [N, H, W, C], got "
                         f"{tuple(x.shape)}")
    if "conv0" in block_params \
            and x.shape[3] != block_params["conv0"].shape[2]:
        raise ValueError(f"x has {x.shape[3]} channels, the block's conv0 "
                         f"takes {block_params['conv0'].shape[2]}")


def bind(lib):
    """Declare the C interface of a built ``fused_block`` library."""
    lib.kubeflow_fused_block.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.kubeflow_fused_block.restype = ctypes.c_int
    lib.kubeflow_fused_block_plan.argtypes = (
        [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    lib.kubeflow_fused_block_plan.restype = ctypes.c_int
    lib.kubeflow_fused_block_tiles.argtypes = (
        [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    lib.kubeflow_fused_block_tiles.restype = ctypes.c_int
    return lib


def _library():
    lib = _libs.get("fused_block")
    if lib is None:
        lib = _libs["fused_block"] = bind(_build.load("fused_block"))
    return lib


def launch_plan(h, w, c, m, dtype, band_rows=None):
    """What a launch at this shape uses → ``(band rows, dynamic shared
    memory in bytes, threads a block)``: one thread block computes
    ``band rows`` output rows of one image. Needs the built library (the
    card's host)."""
    plan = (ctypes.c_int * 3)()
    err = _library().kubeflow_fused_block_plan(
        h, w, c, m, band_rows or 0, _DTYPE_CODES[dtype], plan)
    if err:
        raise ValueError(
            f"the fused-block kernel does not take H {h}, W {w}, C {c}, "
            f"M {m}, band_rows {band_rows} in {dtype}: widths must be "
            f"multiples of {WIDTH_MULTIPLE} and one band of the c1 plane "
            f"must fit an SM's shared memory")
    return plan[0], plan[1], plan[2]


def tile_plan(h, w, c, m, dtype, band_rows=None):
    """The rest of a launch's plan, for measurement: ``{"block_m",
    "block_n", "depth"}`` — one thread block's output tile (rows ×
    columns of each of the three products) and the reduction depth of a
    staged weight step. Needs the built library (the card's host)."""
    launch_plan(h, w, c, m, dtype, band_rows)       # raises for no fit
    tiles = (ctypes.c_int * 3)()
    if _library().kubeflow_fused_block_tiles(
            h, w, c, m, band_rows or 0, _DTYPE_CODES[dtype], tiles):
        raise ValueError(f"no tile plan for H {h}, W {w}, C {c}, M {m}")
    return dict(zip(("block_m", "block_n", "depth"), tiles))


def fused_bottleneck_eval(x, block_params, block_stats, eps=1e-5, *,
                          stride=1, band_rows=None):
    """Run one identity bottleneck block (stride 1, no projection) in
    eval mode as a single fused kernel (K8).

    ``block_params``/``block_stats``: the per-block trees of
    ``models/resnet.py`` (conv0/bn0, conv1/bn1, conv2/bn2; conv weights
    HWIO). x: ``[N, H, W, C]`` NHWC, float32 or bfloat16, with C = conv0's
    input channels = conv2's output channels → the block's output in x's
    shape and dtype. ``band_rows`` fixes the output rows one thread block
    computes (None → of those that fit, the one that streams the fewest
    weight tiles over the image; the ``cuda`` tests fix it to drive the
    halo logic at every height, ``chip_smoke.py --k8-bands`` to time the
    heights). CPU tensors take the plain version.
    Raises ``ValueError`` for what the kernel does not take: a
    projection block, ``stride`` other than 1, mismatched widths, and on
    the card widths that are not multiples of 32 or ``band_rows`` whose
    ``c1`` plane does not fit an SM's shared memory."""
    if stride != 1:
        raise ValueError(f"fused_bottleneck_eval takes stride-1 blocks "
                         f"only, got stride {stride}")
    _check_input(x, block_params)
    if x.device.type == "cpu":
        return fused_bottleneck_reference(x, block_params, block_stats, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    ops = folded_operands(block_params, block_stats, x.dtype, eps)
    if any(t.device != x.device for t in ops):
        raise ValueError("x and the block's weights must be on one device")
    n, h, w, c = x.shape
    m = ops[0].shape[1]
    if c % WIDTH_MULTIPLE or m % WIDTH_MULTIPLE:
        raise ValueError(
            f"on the card the block's widths must be multiples of "
            f"{WIDTH_MULTIPLE} (the kernel's reduction step), got C {c}, "
            f"M {m}")
    if n == 0:
        return torch.empty_like(x)
    launch_plan(h, w, c, m, x.dtype, band_rows)   # raises for no fit
    x = x.contiguous()
    out = torch.empty_like(x)
    _build.check_aligned(x, out, *ops)
    with torch.cuda.device(x.device):
        err = _library().kubeflow_fused_block(
            x.data_ptr(), *(t.data_ptr() for t in ops), out.data_ptr(),
            n, h, w, c, m, band_rows or 0, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"fused_block kernel launch failed: CUDA error {err} (x "
            f"{tuple(x.shape)} {x.dtype}, M {m}, band_rows {band_rows})")
    fused_bottleneck_eval.launches += 1
    return out


fused_bottleneck_eval.launches = 0
