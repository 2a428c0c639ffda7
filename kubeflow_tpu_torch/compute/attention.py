"""Plain attention reads: the dense reference, the decode and chunk
reads over a gathered cache, their block-streamed twins over the paged
KV pool, and ring attention over a mesh's sequence axis.

Torch twins of ``kubeflow_tpu/compute/attention.py`` (lines 24-385),
op for op: the same contractions, fp32 logits from operands in the
input dtype (JAX's ``preferred_element_type=float32`` — here the
operands are widened to fp32, which multiplies them exactly and sums in
fp32), fp32 softmax, probabilities cast to ``v.dtype`` before the value
product. These are the CPU references the hand-written kernels under
``ops/`` are graded against.

All functions take q, k, v as ``[batch, seq, heads, head_dim]``.
"""

import torch

from .quantize import kv_dequantize

NEG_INF = -1e30


def _scale(q, scale):
    # in q's own dtype, as the JAX reference scales (attention.py:24)
    return q * (scale if scale is not None else q.shape[-1] ** -0.5)


def repeat_kv(k, n_rep):
    """GQA: repeat kv heads to match query heads (head ``h`` reads kv
    head ``h // n_rep``, the ``jnp.repeat`` order)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _logits(q, k):
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def dense_attention(q, k, v, causal=True, scale=None, q_offset=0,
                    k_offset=0, window=0):
    """Reference attention; fp32 softmax. Offsets give global positions
    so blockwise callers can reuse the same masking logic. ``window``
    (causal only): each query reads its last ``window`` keys."""
    q = _scale(q, scale)
    logits = _logits(q, k)
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def decode_attention(q, k, v, lengths, scale=None):
    """Single-position attention over a gathered (padded) KV cache —
    ``q`` [B, 1, H, D], ``k``/``v`` [B, T, H, D] in logical order,
    ``lengths`` [B] valid positions per sequence (the query attends to
    ``k_pos < lengths[b]``, its own just-written token included).
    Mirrors :func:`dense_attention` op for op."""
    q = _scale(q, scale)
    logits = _logits(q, k)
    k_pos = torch.arange(k.shape[1], device=q.device)
    valid = k_pos[None, :] < lengths[:, None]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunk_attention(q, k, v, prefix_len, scale=None):
    """Attention for a contiguous chunk of new rows appended after a
    cached prefix (``attention.py:82-127``) — the read of the engine's
    cached partial prefill and, with a per-slot ``[B]`` prefix, of its
    speculative verify.

    ``q`` ``[B, S, H, D]`` are the chunk rows at positions
    ``prefix_len + arange(S)``; ``k``/``v`` ``[B, P+S, H, D]`` are the
    gathered prefix pages padded to a static ``P`` followed by the
    chunk's own K/V. Two-part mask: prefix columns are valid iff
    ``col < prefix_len`` (an int, a 0-d tensor, or a ``[B]`` tensor);
    chunk columns are causal within the chunk. Mirrors
    :func:`dense_attention` op for op."""
    q = _scale(q, scale)
    logits = _logits(q, k)
    S = q.shape[1]
    P = k.shape[1] - S
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(k.shape[1], device=q.device)[None, :]
    plen = torch.as_tensor(prefix_len, device=q.device).reshape(-1, 1, 1)
    valid = torch.where(cols < P, cols < plen, cols - P <= rows)  # [B|1,S,T]
    logits = torch.where(valid[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _dequant_block(pages, dtype):
    """One block of the pool at the paged read (``attention.py:130``):
    a float ``(k, v)`` pair as it is, or an int8 ``(k, v, k_scale,
    v_scale)`` quadruple (``quantize.kv_quantize``'s layout, one fp32
    scale per (position, head)) widened by ``quantize.kv_dequantize``, so
    the streamed read sees exactly the values of the gather path's
    whole-table dequant."""
    if len(pages) == 2:
        return pages
    k, v, ks, vs = pages
    return kv_dequantize(k, ks, dtype), kv_dequantize(v, vs, dtype)


def _stream_fold(carry, k, v, valid, q):
    """One masked online-softmax step over one block of keys: fp32
    ``(o, m, l)`` state, ``p`` zeroed by the mask explicitly so a fold
    that is entirely masked for a row adds no mass while ``m`` is still
    NEG_INF (``exp(NEG_INF - NEG_INF) = 1`` otherwise). ``q`` arrives
    pre-scaled; ``k``/``v`` are repeated to the query head count;
    ``valid`` is ``[B, Sq, T]``."""
    o, m, l = carry
    logits = _logits(q, k)
    mask = valid[:, None]
    logits = torch.where(mask, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o * corr.transpose(1, 2)[..., None] + pv
    return o, m_new, l


def _stream_finish(o, l, dtype):
    """Normalize the streamed accumulator; rows that never saw a valid
    column (``l == 0``) divide by 1 so they stay finite."""
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / safe.transpose(1, 2)[..., None]).to(dtype)


def paged_decode_attention(q, pages, tables, lengths, *, block_size,
                           n_rep=1, scale=None, dequant=_dequant_block,
                           window=0):
    """Single-position attention computed directly over the paged KV
    pool, one block-table column at a time, without materializing the
    gathered ``[S, T, heads, head_dim]`` context.

    ``q`` ``[S, 1, H, D]``; ``pages`` is one layer's ``(k, v)`` pool
    slice, each ``[num_blocks, block_size, kv_heads, D]``, or the int8
    quadruple ``(k, v, k_scale, v_scale)`` with scales ``[num_blocks,
    block_size, kv_heads, 1]``, widened block by block by ``dequant``
    (``(pages, dtype) → (k, v)``; :func:`_dequant_block` by default);
    ``tables`` ``[S, bps]`` maps logical block j of slot i to its
    physical page; ``lengths`` ``[S]`` counts valid positions. The loop
    runs ``ceil(max(lengths) / block_size)`` steps; shallower rows ride
    along as masked zero-mass folds. With a key ``window`` each row
    reads its last ``window`` positions, and the loop starts at the
    block of the lowest row's first."""
    q = _scale(q, scale)
    bs = int(block_size)
    bps = tables.shape[1]
    S, _, H, D = q.shape
    n_max = min(bps, -(-int(lengths.max()) // bs)) if S else 0
    lo = lengths - window      # each row's first position, with a window
    j0 = max(0, int(lo.min()) // bs) if S and window else 0
    o = torch.zeros((S, 1, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((S, H, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((S, H, 1), dtype=torch.float32, device=q.device)
    offs = torch.arange(bs, device=q.device)
    for j in range(j0, n_max):
        ids = tables[:, j].long()
        k, v = dequant(tuple(p[ids] for p in pages), q.dtype)
        k = repeat_kv(k, n_rep)
        v = repeat_kv(v, n_rep)
        pos = j * bs + offs[None, :]
        valid = pos < lengths[:, None]
        if window:
            valid = valid & (pos >= lo[:, None])
        o, m, l = _stream_fold((o, m, l), k, v, valid[:, None, :], q)
    return _stream_finish(o, l, q.dtype)


def paged_chunk_attention(q, pages, tables, prefix_len, k_chunk, v_chunk,
                          *, block_size, n_rep=1, scale=None,
                          dequant=_dequant_block, window=0):
    """Chunk-after-cached-prefix attention computed directly over the
    paged pool (``attention.py:252-310``), the block-streamed twin of
    :func:`chunk_attention`.

    ``q`` ``[B, S, H, D]``; ``pages``/``tables`` map the cached prefix
    as in :func:`paged_decode_attention` (int8 pages widened block by
    block by ``dequant``); ``prefix_len`` is an int or a
    ``[B]`` tensor; ``k_chunk``/``v_chunk`` ``[B, S, kv_heads, D]`` are
    the chunk's own (not repeated) K/V. The prefix streams one block
    per step for ``ceil(max(prefix_len) / block_size)`` steps, then the
    chunk folds in last under the causal within-chunk mask. With a key
    ``window`` the row at position ``p`` reads keys ``[p - window + 1,
    p]`` only, and the prefix loop starts at the block of the lowest
    first key."""
    q = _scale(q, scale)
    bs = int(block_size)
    bps = tables.shape[1]
    B, S, H, D = q.shape
    plen = torch.as_tensor(prefix_len, device=q.device).expand(B)
    n_max = min(bps, -(-int(plen.max()) // bs)) if B else 0
    rows = torch.arange(S, device=q.device)[:, None]
    # with a window, each row's first key as a global position [B, S, 1]
    lo = plen[:, None, None] + rows[None] - (window - 1)
    j0 = max(0, int(lo.min()) // bs) if B and S and window else 0
    o = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    offs = torch.arange(bs, device=q.device)
    for j in range(j0, n_max):
        ids = tables[:, j].long()
        k, v = dequant(tuple(p[ids] for p in pages), q.dtype)
        k = repeat_kv(k, n_rep)
        v = repeat_kv(v, n_rep)
        pos = j * bs + offs[None, None, :]
        valid = pos < plen[:, None, None]
        if window:
            valid = valid & (pos >= lo)
        o, m, l = _stream_fold((o, m, l), k, v, valid.expand(B, S, bs), q)
    cols = torch.arange(S, device=q.device)[None, :]
    valid = (cols <= rows)[None]
    if window:
        valid = valid & (plen[:, None, None] + cols[None] >= lo)
    valid = valid.expand(B, S, S)
    o, m, l = _stream_fold((o, m, l), repeat_kv(k_chunk, n_rep),
                           repeat_kv(v_chunk, n_rep), valid, q)
    return _stream_finish(o, l, q.dtype)


# ------------------------------------------------------------------ ring

def _block(carry, k, v, q, q_offset, k_offset, causal, scale):
    """One blockwise-softmax accumulation step (``attention.py:313``):
    fp32 ``(o, m, l)`` state, fp32 sums of q's-dtype products, the
    global causal mask from the blocks' offsets. A fully masked block
    adds no mass once ``m`` is finite, which hop 0 (the diagonal block)
    makes it."""
    o, m, l = carry
    logits = _logits(_scale(q, scale), k)
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        logits = torch.where(q_pos[:, None] >= k_pos[None, :], logits,
                             NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o * corr.transpose(1, 2)[..., None] + pv
    return o, m_new, l


def ring_attention(qs, ks, vs, causal=True, scale=None):
    """Sequence-parallel attention over a ring (``attention.py:332``).

    ``qs``, ``ks``, ``vs``: one ``[B, S/n, H, D]`` block per position of
    the ring, position ``i`` holding sequence block ``i`` on its device
    (k and v repeated to q's head count). At hop ``s`` position ``i``
    folds the K/V block that started on position ``(i - s) mod n`` into
    its running blockwise softmax, then every position hands its block
    on to the next (``.to()``, the ``ppermute`` ``i → i + 1``); the
    offsets and the causal mask are the global ones. A fully masked
    future block is folded all the same, as in JAX. → each position's
    output block in q's dtype. The backward is autograd through the
    folds and the hops."""
    n = len(qs)
    chunk = qs[0].shape[1]
    state = []
    for q, v in zip(qs, vs):
        B, S, H, _ = q.shape
        m = torch.full((B, H, S), NEG_INF, dtype=torch.float32,
                       device=q.device)
        state.append((torch.zeros((B, S, H, v.shape[-1]),
                                  dtype=torch.float32, device=q.device),
                      m, torch.zeros_like(m)))
    kv = list(zip(ks, vs))
    for s in range(n):
        state = [_block(state[i], *kv[i], qs[i], i * chunk,
                        ((i - s) % n) * chunk, causal, scale)
                 for i in range(n)]
        if s < n - 1:
            kv = [tuple(t.to(qs[i].device) for t in kv[(i - 1) % n])
                  for i in range(n)]
    return [(o / l.transpose(1, 2)[..., None]).to(q.dtype)
            for (o, _, l), q in zip(state, qs)]


def ring_attention_sharded(q, k, v, mesh, seq_axis="sequence", causal=True,
                           scale=None):
    """:func:`ring_attention` on whole ``[B, S, H, D]`` tensors
    (``attention.py:366``): S cut into ``mesh.shape[seq_axis]`` blocks
    and the heads into ``mesh.shape["tensor"]`` groups, block ``j`` of
    head group ``t`` on the device of the position at those coordinates
    (every other axis at 0); a ring over the blocks of each head group;
    the output joined on q's device."""
    n, tp = mesh.shape[seq_axis], mesh.shape["tensor"]
    for name, size, axis, parts in (("S", q.shape[1], seq_axis, n),
                                    ("heads", q.shape[2], "tensor", tp)):
        if size % parts:
            raise ValueError(f"{name}={size} does not divide over the "
                             f"mesh's {axis} axis of {parts}")
    c, h = q.shape[1] // n, q.shape[2] // tp
    groups = []
    for t in range(tp):
        devs = [mesh.devices[mesh.position({seq_axis: j, "tensor": t})]
                for j in range(n)]

        def cut(x):
            return [x[:, j * c:(j + 1) * c, t * h:(t + 1) * h].to(d)
                    for j, d in enumerate(devs)]

        outs = ring_attention(cut(q), cut(k), cut(v), causal, scale)
        groups.append(torch.cat([o.to(q.device) for o in outs], dim=1))
    return torch.cat(groups, dim=2)


def over_chunks(heads, n_chunks, whole, ring=None):
    """Attention over a sequence cut into ``n_chunks`` chunks, the
    chunks of one head group on that group's positions (a mesh's
    ``sequence`` axis beside its ``tensor`` axis). ``heads``: each
    shard's ``(q, k, v)``, chunk-major (chunk ``j`` of head group ``t``
    at ``j * groups + t``) → each shard's output. ``ring(qs, ks, vs) →
    outs`` runs a group's ring over its chunks; without one, a group's
    chunks are joined on its first chunk's device, ``whole(q, k, v)``
    attends over the whole sequence there (the gather XLA inserts for
    an unsharded attention) and the output is cut back."""
    groups = len(heads) // n_chunks
    outs = [None] * len(heads)
    for t in range(groups):
        idx = range(t, len(heads), groups)
        qs, ks, vs = zip(*(heads[i] for i in idx))
        if ring is not None:
            got = ring(list(qs), list(ks), list(vs))
        elif n_chunks == 1:
            got = [whole(qs[0], ks[0], vs[0])]
        else:
            dev = qs[0].device
            o = whole(*(torch.cat([x.to(dev) for x in xs], dim=1)
                        for xs in (qs, ks, vs)))
            got = [part.to(q.device) for part, q in
                   zip(o.split(qs[0].shape[1], dim=1), qs)]
        for i, o in zip(idx, got):
            outs[i] = o
    return outs
