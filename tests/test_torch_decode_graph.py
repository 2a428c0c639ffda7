"""The plain decode step's fixed shape, on the CPU: every slot's row is
in the step, and a row that is not decoding writes into the pool's sink
block, which the allocator never hands out and no table names.

The step that a card captures as a CUDA graph is this same step, so
these tests run the logic that the graph replays: the fixed-shape write
leaves the pool exactly as a write of the active rows alone would, over
a run where slots enter, prefill (in chunks too), take a fresh page
mid-decode, stop at eos or at their budget and leave, on a bf16 and an
int8 pool. The replay itself is held to this step on the card
(``tests/test_torch_decode_graph_cuda.py``).

CPU only, on a tiny TransformerLM (``device="cpu"``: the kernels' plain
versions)."""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute.models import transformer as tt

CFG = tt.Config(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, max_seq=64, dtype="bfloat16",
                attention="dense", remat=False)
#: prompts over two blocks of 8, budgets that cross a block mid-decode
PROMPTS = [([3, 9, 1, 22, 7, 15, 2], 12), ([5, 5, 44], 4),
           ([9] * 17, 9), ([2, 61, 30, 8], 6), ([1] * 11, 5),
           ([4, 8, 15, 16, 23, 42], 11)]


@pytest.fixture(scope="module")
def params():
    return tt.init_params(CFG, torch.Generator().manual_seed(7),
                          device="cpu")


def _engine(params, **kw):
    kw = {"max_slots": 3, "block_size": 8, "max_context": 64,
          "num_blocks": 20, "device": "cpu", **kw}
    return t_gen.GenerationEngine(params, CFG, **kw)


def _run(eng, eos_id=None):
    """Every prompt submitted while the engine thread waits (so each
    engine takes the same schedule) → ``(tokens, reason)`` of each, in
    order."""
    with eng._cond:
        handles = [eng.submit(p, max_tokens=m, eos_id=eos_id)
                   for p, m in PROMPTS]
    return [h.result(timeout=120) for h in handles]


def _watch(eng):
    """Record, after every plain decode step, a copy of the usable pool
    and the step's packed input → the list they go to."""
    seen, step = [], eng._decode_once

    def watched():
        step()
        seen.append(([c.clone() for c in eng._cache],
                     eng._step_np.copy()))
    eng._decode_once = watched
    return seen


def _variable_length_write(eng):
    """The decode write as the engine made it before its step had a
    fixed shape: the active rows alone, and no sink block."""
    write = eng._write_kv

    def active_rows_only(layer, phys, off, k, v, shard=0):
        keep = phys != eng.num_blocks
        write(layer, phys[keep], off[keep], k[keep], v[keep], shard)
    eng._write_kv = active_rows_only


@pytest.mark.parametrize("prefill_chunk", [None, 8],
                         ids=["monolithic", "chunked"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_fixed_shape_write_equals_the_active_rows_write(params, kv_dtype,
                                                        prefill_chunk):
    """The pool after every decode step, bit for bit, and the tokens
    equal those of the active-rows write; the sink block takes the idle
    rows' writes and nothing else of the pool changes for them."""
    kw = {"kv_dtype": kv_dtype, "prefill_chunk": prefill_chunk}
    probe = _engine(params, **kw)
    try:
        eos = _run(probe)[0][0][4]        # stops the first prompt early
    finally:
        probe.close()
    fixed, ref = _engine(params, **kw), _engine(params, **kw)
    _variable_length_write(ref)
    runs = []
    try:
        for eng in (fixed, ref):
            seen = _watch(eng)
            runs.append((_run(eng, eos), seen))
    finally:
        fixed.close()
        ref.close()
    (toks, seen), (ref_toks, ref_seen) = runs
    assert toks == ref_toks
    assert any(reason == "eos" for _, reason in toks)
    assert len(seen) == len(ref_seen) > 0
    for (pool, buf), (ref_pool, ref_buf) in zip(seen, ref_seen):
        assert np.array_equal(buf, ref_buf)
        for a, b in zip(pool, ref_pool):
            assert torch.equal(a, b)
    sink = fixed.num_blocks
    assert any(not p[:, sink].eq(q[:, sink]).all()
               for p, q in zip(fixed._shards[0].pool, ref._shards[0].pool))
    # idle rows write the sink; a prefilling slot rides idle too
    assert any((fixed._step_views(b)[5] == 0).any() for _, b in seen)
    if prefill_chunk:
        assert fixed.stats["prefill_chunks"] > fixed.stats["prefills"]


def test_sink_block_is_never_allocated_or_named(params):
    """The pool holds one block past ``num_blocks``; the allocator never
    hands it out, no table or step input names it as a page to read, the
    partition, the occupancy and the snapshot count ``num_blocks``, and
    no step on the CPU is a graph replay."""
    eng = _engine(params)
    sink = eng.num_blocks
    alloc, handed = eng._alloc_block_locked, []

    def counted():
        b = alloc()
        handed.append(b)
        return b
    eng._alloc_block_locked = counted
    seen = _watch(eng)
    try:
        _run(eng)
        _run(eng)            # the second pass reclaims cached pages
        view, snap, occ = eng.blocks_view(), eng.snapshot(), \
            eng.occupancy()
    finally:
        eng.close()
    assert all(p.shape[1] == sink + 1 for p in eng._shards[0].pool)
    assert all(c.shape[1] == sink for c in eng._cache)
    assert handed and sink not in handed
    assert sorted(view["free"] + view["cached"] + view["referenced"]) \
        == list(range(sink))
    assert len(view["refcounts"]) == sink and occ == 0
    assert snap["blocks"] == sink
    for _, buf in seen:
        tables, lengths, _, phys, off, live = eng._step_views(buf)
        assert (tables != sink).all()
        assert np.array_equal(phys == sink, live == 0)
        assert not lengths[live == 0].any() and not off[live == 0].any()
    st = eng.stats
    assert st["decode_steps"] == len(seen) > 0
    assert (st["decode_graph_replays"], st["decode_graph_captures"],
            st["decode_graph_capture_seconds_total"]) == (0, 0, 0.0)
    assert eng._graph is None and not eng._graphable


def test_step_input_packs_in_one_buffer(params):
    """``_step_views`` cuts one int32 buffer, numpy or torch, into the
    step's tables and five rows, all views; a blank buffer is all idle."""
    eng = _engine(params)
    eng.close()
    S, bps = eng.max_slots, eng.blocks_per_slot
    assert eng._step_in.dtype == torch.int32
    assert eng._step_np.shape == (S * bps + 5 * S,)
    buf = eng._blank_step(np.full_like(eng._step_np, 9))
    tables, *rows = eng._step_views(buf)
    assert tables.shape == (S, bps) and not tables.any()
    assert [r.shape for r in rows] == [(S,)] * 5
    assert list(rows[2]) == [eng.num_blocks] * S
    assert not any(r.any() for i, r in enumerate(rows) if i != 2)
    rows[1][0] = 5
    assert buf[S * bps + S] == 5
    t = eng._step_views(torch.from_numpy(buf))
    assert [tuple(v.shape) for v in t] == [(S, bps)] + [(S,)] * 5
    assert int(t[2][0]) == 5
