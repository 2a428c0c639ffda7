"""Kernel names → groups, as the port's ``compute/profiler.py`` grouped
them when this benchmark was written (``KERNEL_GROUPS``,
``kernel_group``), frozen here: the port's own kernels by symbol, then
library kernels by kind; the first group whose key is a substring of a
kernel's name takes it."""

KERNEL_GROUPS = (
    ("K1 paged_decode", ("paged_decode_kernel",
                         "paged_decode_combine_kernel")),
    ("K2 paged_chunk", ("paged_chunk_kernel", "paged_chunk_tc_kernel",
                        "paged_chunk_combine_kernel")),
    ("K3 flash_fwd", ("flash_fwd_kernel", "flash_fwd_tc_kernel")),
    ("K4 flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_tc_kernel")),
    ("K5 flash_bwd_dkv", ("flash_bwd_dkv_kernel",
                          "flash_bwd_dkv_tc_kernel")),
    ("K6 grouped_matmul", ("gmm_fwd_kernel", "gmm_fwd_wgmma_kernel")),
    ("K7 grouped_matmul_dw", ("gmm_dw_kernel", "gmm_dw_wgmma_kernel")),
    ("K8 fused_block", ("fused_block_kernel",)),
    ("convolution", ("fprop", "dgrad", "wgrad", "cudnn", "conv2d",
                     "implicit_gemm", "convolve")),
    ("pooling", ("pool",)),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")),
    ("reduction", ("reduce_kernel", "softmax", "norm_kernel")),
    ("index/scatter", ("index", "scatter", "gather", "embedding")),
    ("elementwise", ("elementwise_kernel", "copy", "cat_")),
)


def kernel_group(name):
    """The group of a device operation's name (``"other"`` when no
    key matches)."""
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"
