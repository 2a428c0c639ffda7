"""Each hand-written kernel's operations and bytes at given shapes, as
``chip_smoke.py``'s kernels phase counted them (``bound``,
``decode_yardsticks``, ``check_flash``, ``check_flash_bwd``,
``check_gmm``, ``check_gmm_dw``), frozen here. Every function returns
``(bytes_moved, flops)`` of one call: each input byte read once and each
output byte written once, and the work these inputs need (a causal
mask's pairs, the valid positions of a paged read, the rows routed to
the experts) rather than the most the kernel could do.

The least time the card could take is :func:`bound`'s: the larger of
bytes over the memory bandwidth and operations over the peak of the
dtype."""

from .peaks import BYTES_PER_S, PEAK_FLOPS


def bound(bytes_moved, flops, dtype, peaks=(PEAK_FLOPS, BYTES_PER_S)):
    """``(seconds, "bytes" | "operations")``: the least time of a call."""
    peak_flops, bytes_per_s = peaks
    t_bytes = bytes_moved / bytes_per_s
    t_ops = flops / peak_flops[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _pairs(batch, heads, seq, causal):
    return batch * heads * (seq * (seq + 1) // 2 if causal else seq * seq)


def flash_fwd(batch, seq, heads, kv_heads, head_dim, causal=True,
              itemsize=2):
    """K3: q read and out written, k and v read once, the fp32 row
    statistics written; QKᵀ and PV over the (causal) pairs."""
    q = batch * seq * heads * head_dim
    kv = batch * seq * kv_heads * head_dim
    stats = batch * heads * seq
    bytes_moved = (2 * q + 2 * kv) * itemsize + stats * 4
    return bytes_moved, 4 * head_dim * _pairs(batch, heads, seq, causal)


def flash_bwd_dq(batch, seq, heads, kv_heads, head_dim, causal=True,
                 itemsize=2):
    """K4: q, dO read and dq written; k, v read; both fp32 row
    statistics read; three products over the pairs."""
    q = batch * seq * heads * head_dim * itemsize
    kv = batch * seq * kv_heads * head_dim * itemsize
    stats = 2 * batch * heads * seq * 4
    return (3 * q + 2 * kv + stats,
            2 * 3 * head_dim * _pairs(batch, heads, seq, causal))


def flash_bwd_dkv(batch, seq, heads, kv_heads, head_dim, causal=True,
                  itemsize=2):
    """K5: q, dO read; k, v read and dk, dv written; both fp32 row
    statistics read; four products over the pairs."""
    q = batch * seq * heads * head_dim * itemsize
    kv = batch * seq * kv_heads * head_dim * itemsize
    stats = 2 * batch * heads * seq * 4
    return (2 * q + 4 * kv + stats,
            2 * 4 * head_dim * _pairs(batch, heads, seq, causal))


def paged_decode(positions, slots, heads, kv_heads, head_dim, table_len,
                 itemsize=2):
    """K1 over ``slots`` decoding rows that read ``positions`` valid
    positions between them: q read and out written, the K and V rows of
    every valid position read once, each row's block table and length;
    QKᵀ and PV over the positions read."""
    bytes_moved = (2 * slots * heads * head_dim * itemsize
                   + positions * 2 * kv_heads * head_dim * itemsize
                   + slots * (table_len * 4 + 4))
    return bytes_moved, 4 * positions * heads * head_dim


def gmm(rows, k, n, experts, block_m=128, itemsize=2):
    """K6 (``out[i] = x[i] @ w[expert of i]``) over ``rows`` rows: x
    read, every expert's weight read, out written, the per-tile expert
    ids; one product per row."""
    bytes_moved = ((rows * k + experts * k * n + rows * n) * itemsize
                   + -(-rows // block_m) * 4)
    return bytes_moved, 2 * rows * k * n


def gmm_dw(rows, k, n, experts, block_m=128, itemsize=2):
    """K7 (``dw[e] = Σ xᵀ dy`` over expert e's rows) over ``rows``
    rows: x and dy read, the fp32 weight gradient written, the three
    per-tile arrays; one product per row."""
    bytes_moved = (rows * (k + n) * itemsize + experts * k * n * 4
                   + 3 * -(-rows // block_m) * 4)
    return bytes_moved, 2 * rows * k * n
