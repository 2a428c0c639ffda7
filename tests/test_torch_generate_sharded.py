"""The port's tensor-sharded ``GenerationEngine`` (``mesh=``) against the
JAX package's sharded engine and its own unsharded one.

Counterparts of ``tests/test_compute_generate_sharded.py``'s 24 tests
at its small config (vocab 64, d 32, 2 layers, 4 heads), on the port's
CPU mesh (``["cpu"] * N``: the same device named N times, as JAX's
forced host devices are one CPU), with JAX's weights carried across
through numpy. The contract:

- greedy tokens on a 4-shard mesh equal JAX's 4-chip engine's and the
  port's cache-free oracle's (itself held to JAX's in
  ``tests/test_torch_generate.py``) — fp32 and bf16, across a mid-batch
  eviction/admission boundary, prefix-cache hits and speculative
  rounds; tokens are compared exactly, as JAX's test does;
- a 1-shard mesh is the unsharded engine byte for byte (tokens and pool
  bytes), and the tp-4 engine's ``prefill_export`` bundle equals the
  unsharded engine's byte for byte;
- every shard's parameters and pool slice are the pieces JAX's engine
  holds on that device (parameters exactly; the pool within 1e-5 after
  the same request, both engines computing in fp32);
- ``row_shard`` passes ``conformance.assert_logits_close`` at JAX's
  tolerances (fp32 1e-3 / 1e-3; bf16 against the fp32 oracle 0.2 /
  0.1);
- shape errors are ``MeshShapeError`` at construction with JAX's texts,
  and a mesh engine refuses a page import (reason ``mesh``) at any size,
  ``tensor=1`` included.

Engines are module-scoped where the tests only read them.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.compute import generate as j_gen
from kubeflow_tpu.compute import mesh as j_mesh
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import conformance
from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute import mesh as t_mesh
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_from_jax


def _jcfg(dtype="float32", **kw):
    return jt.Config(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                     max_seq=64, dtype=dtype, attention="dense",
                     remat=False, scan_layers=True, **kw)


def _tcfg(dtype="float32", **kw):
    j = _jcfg(dtype, **kw)
    return tt.Config(**{f.name: getattr(j, f.name)
                        for f in dataclasses.fields(tt.Config)})


def _mesh(tp):
    return t_mesh.mesh_for_generation(tensor=tp, devices=["cpu"] * 8)


def _port(params, dtype="float32", cfg=None, **kw):
    for k, v in (("max_slots", 2), ("block_size", 8), ("max_context", 64),
                 ("name", "tshard-port")):
        kw.setdefault(k, v)
    if "mesh" not in kw:
        kw["device"] = "cpu"
    return t_gen.GenerationEngine(params, cfg or _tcfg(dtype), **kw)


@pytest.fixture(scope="module")
def jparams():
    return jt.init_params(_jcfg(), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def gqa():
    """(jax params, port params) of the GQA config (kv_heads 2)."""
    jp = jt.init_params(_jcfg(n_kv_heads=2), jax.random.PRNGKey(3))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def sharded(params):
    eng = _port(params, mesh=_mesh(4), name="tshard")
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def unsharded(params):
    eng = _port(params, name="tshard-nomesh")
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def jax_sharded(jparams):
    eng = j_gen.GenerationEngine(
        jparams, _jcfg(), max_slots=2, block_size=8, max_context=64,
        name="tshard-jax", mesh=j_mesh.mesh_for_generation(tensor=4))
    yield eng
    eng.close()


def _ref(params, prompt, max_tokens, dtype="float32", cfg=None):
    return t_gen.reference_greedy_decode(params, cfg or _tcfg(dtype),
                                         prompt, max_tokens)


MIXED = ([1, 2, 3], [5] * 8, list(range(1, 18)))


# ------------------------------------------------- sharded conformance

def test_token_identical_mixed_lengths_f32(params, sharded, jax_sharded,
                                           unsharded):
    # lengths straddle bucket AND block boundaries (3→8, 8→8, 17→32)
    for prompt in MIXED:
        got = sharded.generate(prompt, max_tokens=10)[0]
        assert got == jax_sharded.generate(prompt, max_tokens=10)[0]
        assert got == unsharded.generate(prompt, max_tokens=10)[0]
        assert got == _ref(params, prompt, 10), prompt


def test_shards_hold_jax_parameter_pieces(sharded, jax_sharded):
    """Shard i's parameters are the pieces JAX's engine holds on device
    i: wq/wk/wv and w_gate/w_up column-split, the rest replicated."""
    jdevs = list(jax_sharded.mesh.devices.reshape(-1))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax_sharded.params):
        keys = [k.key for k in path]
        by_dev = {s.device.id: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        for i, dev in enumerate(jdevs):
            got = sharded._shards[i].params
            for k in keys:
                got = got[k]
            np.testing.assert_array_equal(got.numpy(), by_dev[dev.id])


def test_pool_shards_hold_jax_heads(params, jparams):
    """After the same request, shard i's pool slice is the heads JAX's
    device i holds (within 1e-5: two fp32 engines), and the joined pool
    is the unsharded engine's within 1e-6. Not byte for byte: the one-row
    decode step takes the CPU BLAS's GEMV path, where a column slice
    rounds otherwise than the whole product (ROADMAP queue 3); the
    prefill's bucketed rows do not (the export test)."""
    prompt = list(range(3, 22))
    jeng = j_gen.GenerationEngine(
        jparams, _jcfg(), max_slots=1, block_size=8, max_context=64,
        num_blocks=4, prefix_cache=False, name="tshard-jpool",
        mesh=j_mesh.mesh_for_generation(tensor=4))
    teng = _port(params, max_slots=1, num_blocks=4, prefix_cache=False,
                 mesh=_mesh(4), name="tshard-pool")
    flat = _port(params, max_slots=1, num_blocks=4, prefix_cache=False,
                 name="tshard-pool1")
    try:
        for eng in (jeng, teng, flat):
            eng.generate(prompt, max_tokens=4)
        jdevs = list(jeng.mesh.devices.reshape(-1))
        for comp, jcomp in zip(range(2), jeng._cache):
            by_dev = {s.device.id: np.asarray(s.data)
                      for s in jcomp.addressable_shards}
            for i, dev in enumerate(jdevs):
                np.testing.assert_allclose(
                    teng._shards[i].cache[comp].numpy(), by_dev[dev.id],
                    rtol=1e-5, atol=1e-5)
        for a, b in zip(teng.joined_pool_copy(), flat._cache):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    finally:
        for eng in (jeng, teng, flat):
            eng.close()


def test_token_identical_across_evict_admit_boundary(params, sharded):
    """4 prompts into 2 slots, staggered budgets: sequences evict
    mid-batch while peers decode and queued prompts backfill."""
    specs = [([1, 2, 3], 16), ([5, 6, 7, 8, 9], 4), ([4] * 11, 9),
             ([60, 2], 12)]
    handles = [sharded.submit(p, max_tokens=m) for p, m in specs]
    for (prompt, m), handle in zip(specs, handles):
        out, reason = handle.result(timeout=120)
        assert out == _ref(params, prompt, m), prompt
        assert reason == "length"
    assert sharded.stats["decode_token_slots"] \
        > sharded.stats["decode_steps"]


def test_prefix_cache_hit_on_sharded_engine(params, sharded):
    shared = list(range(1, 17))               # 2 full blocks
    a, b = shared + [40, 41, 42], shared + [50, 51]
    assert sharded.generate(a, max_tokens=8)[0] == _ref(params, a, 8)
    h0 = sharded.stats["prefix_hits"]
    s0 = sharded.stats["prefix_tokens_skipped"]
    assert sharded.generate(b, max_tokens=8)[0] == _ref(params, b, 8)
    assert sharded.stats["prefix_hits"] == h0 + 1
    assert sharded.stats["prefix_tokens_skipped"] == s0 + 16


def test_chunked_prefill_on_sharded_engine(params):
    eng = _port(params, mesh=_mesh(4), prefill_chunk=8, name="tshard-chk")
    try:
        prompt = list(range(1, 30))
        assert eng.generate(prompt, max_tokens=6)[0] \
            == _ref(params, prompt, 6)
        assert eng.stats["prefill_chunks"] > eng.stats["prefills"]
    finally:
        eng.close()


def test_token_identical_bf16(params):
    """bf16, the dtype where a sum of partials would flip tokens: the
    gathered layout holds exactly, across a boundary and a prefix hit."""
    eng = _port(params, "bfloat16", mesh=_mesh(4), name="tshard16")
    try:
        specs = [([1, 2, 3], 12), ([5, 6, 7, 8, 9], 4), ([4] * 11, 8)]
        handles = [eng.submit(p, max_tokens=m) for p, m in specs]
        for (prompt, m), handle in zip(specs, handles):
            assert handle.result(timeout=120)[0] \
                == _ref(params, prompt, m, "bfloat16"), prompt
        shared = list(range(2, 18))
        for tail in ([40, 41], [50, 51, 52]):
            prompt = shared + tail
            assert eng.generate(prompt, max_tokens=8)[0] \
                == _ref(params, prompt, 8, "bfloat16")
        assert eng.stats["prefix_hits"] >= 1
    finally:
        eng.close()


def test_gqa_heads_shard_with_their_ratio(gqa):
    """kv_heads=2 over tp=2: 1 kv head and 2 q heads a shard, against
    JAX's tp-2 engine and the oracle."""
    jp, tp_ = gqa
    cfg = _tcfg(n_kv_heads=2)
    eng = _port(tp_, cfg=cfg, mesh=_mesh(2), name="tgqa")
    jeng = j_gen.GenerationEngine(
        jp, _jcfg(n_kv_heads=2), max_slots=2, block_size=8,
        max_context=64, name="tgqa-jax",
        mesh=j_mesh.mesh_for_generation(tensor=2))
    try:
        assert [sh.cache[0].shape[3] for sh in eng._shards] == [1, 1]
        for prompt in ([1, 2, 3], [9] * 10):
            got = eng.generate(prompt, max_tokens=8)[0]
            assert got == jeng.generate(prompt, max_tokens=8)[0]
            assert got == _ref(tp_, prompt, 8, cfg=cfg), prompt
    finally:
        eng.close()
        jeng.close()


# ----------------------------------------------------- degenerate mesh

def test_one_device_mesh_reproduces_unsharded_byte_for_byte(params):
    e1 = _port(params, mesh=_mesh(1), name="deg1")
    e0 = _port(params, name="deg0")
    try:
        for prompt, m in (([7, 8, 9, 10], 12), ([1] * 9, 6),
                          ([7, 8, 9, 10, 11], 4)):
            assert e1.generate(prompt, max_tokens=m)[0] \
                == e0.generate(prompt, max_tokens=m)[0], prompt
        for c1, c0 in zip(e1._cache, e0._cache):
            assert c1.numpy().tobytes() == c0.numpy().tobytes()
        assert e1.tp == 1
        assert e1.snapshot()["mesh"]["per_chip_blocks"] == e1.num_blocks
    finally:
        e1.close()
        e0.close()


def test_one_device_mesh_int8_pool_byte_for_byte(params):
    e1 = _port(params, mesh=_mesh(1), kv_dtype="int8", name="deg1-i8")
    e0 = _port(params, kv_dtype="int8", name="deg0-i8")
    try:
        for prompt in ([7, 8, 9, 10], [1] * 9):
            assert e1.generate(prompt, max_tokens=6)[0] \
                == e0.generate(prompt, max_tokens=6)[0]
        for c1, c0 in zip(e1._cache, e0._cache):
            assert c1.numpy().tobytes() == c0.numpy().tobytes()
    finally:
        e1.close()
        e0.close()


def test_int8_pool_splits_its_scales_per_shard(params):
    eng = _port(params, mesh=_mesh(4), kv_dtype="int8", name="tshard-i8")
    flat = _port(params, kv_dtype="int8", name="tshard-i8-1")
    try:
        prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
        assert eng.generate(prompt, max_tokens=8)[0] \
            == flat.generate(prompt, max_tokens=8)[0]
        shapes = [tuple(c.shape[3:]) for c in eng._shards[0].cache]
        assert shapes == [(1, 8), (1, 8), (1, 1), (1, 1)]
        for a, b in zip(eng.joined_pool_copy(), flat._cache):
            assert a.numpy().tobytes() == b.numpy().tobytes()
    finally:
        eng.close()
        flat.close()


# ---------------------------------------------------------- shape guard

def test_indivisible_heads_raise_named_error(params):
    with pytest.raises(t_gen.MeshShapeError, match="n_heads=4"):
        _port(params, mesh=_mesh(3), name="bad3")


def test_indivisible_kv_heads_raise_named_error(gqa):
    with pytest.raises(t_gen.MeshShapeError, match="kv_heads=2"):
        _port(gqa[1], cfg=_tcfg(n_kv_heads=2), mesh=_mesh(4), name="bad4")


def test_non_tensor_axes_refused(params):
    mesh = t_mesh.make_mesh(data=2, tensor=2, devices=["cpu"] * 4)
    with pytest.raises(t_gen.MeshShapeError, match="'tensor' axis"):
        _port(params, mesh=mesh, name="bad5")


def test_shape_errors_are_jax_texts(params, jparams, gqa):
    cases = [(params, jparams, {}, 3), (gqa[1], gqa[0],
                                        dict(n_kv_heads=2), 4)]
    for tparams, jp, kw, tp in cases:
        with pytest.raises(t_gen.MeshShapeError) as got:
            _port(tparams, cfg=_tcfg(**kw), mesh=_mesh(tp), name="badt")
        with pytest.raises(j_gen.MeshShapeError) as want:
            j_gen.GenerationEngine(
                jp, _jcfg(**kw), name="badj",
                mesh=j_mesh.mesh_for_generation(tensor=tp))
        assert str(got.value) == str(want.value)


def test_mesh_for_generation_validates():
    with pytest.raises(ValueError, match="tensor must be >= 1"):
        t_mesh.mesh_for_generation(tensor=0, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="needs 9 devices, have 8"):
        t_mesh.mesh_for_generation(tensor=9, devices=["cpu"] * 8)


def test_mesh_and_device_are_not_both_named(params):
    with pytest.raises(ValueError, match="leave device= unset"):
        t_gen.GenerationEngine(params, _tcfg(), mesh=_mesh(2),
                               device="cpu", name="both")


# ------------------------------------------------ in-place pool and view

def test_sharded_decode_writes_each_shard_in_place(sharded):
    """The port writes its pool in place where JAX donates it: every
    shard's buffers survive a decode step, and an idle step (nothing
    written) leaves the block partition as it was."""
    sharded.generate([1, 2], max_tokens=2)
    S, bps = sharded.max_slots, sharded.blocks_per_slot

    def ptrs():
        return [c.data_ptr() for sh in sharded._shards for c in sh.cache]

    view0, p0 = sharded.blocks_view(), ptrs()
    before = [c.clone() for sh in sharded._shards for c in sh.cache]
    with torch.no_grad():
        sharded._decode_step(np.zeros((S, bps), np.int32),
                             np.zeros((S,), np.int32),
                             np.zeros((S,), np.int64),
                             np.zeros((3, 0), np.int64))
    assert ptrs() == p0
    assert sharded.blocks_view() == view0
    after = [c for sh in sharded._shards for c in sh.cache]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_mesh_view_and_gauges(sharded):
    view = sharded.mesh_view()
    assert view["tensor"] == 4 and view["devices"] == 4
    assert view["per_chip_blocks"] == sharded.num_blocks // 4
    assert sharded.snapshot()["mesh"] == view
    assert t_gen._SHARD_MESH_DEVICES.value("tshard") == 4
    assert t_gen._SHARD_BLOCKS_PER_CHIP.value("tshard") \
        == sharded.num_blocks / 4
    assert sharded.mesh_header() == (
        f"tensor=4;per_chip_blocks={view['per_chip_blocks']}")
    assert [sh.cache[0].shape[1] for sh in sharded._shards] \
        == [sharded.num_blocks] * 4


def test_mesh_view_matches_jax_engine(sharded, jax_sharded):
    assert sharded.mesh_view() == jax_sharded.mesh_view()
    assert sharded.mesh_header() == jax_sharded.mesh_header()
    assert sharded.collective_bytes_per_step() \
        == jax_sharded.collective_bytes_per_step()


def test_head_partition_multiplies_pool_at_fixed_chip_budget(params):
    """At the same per-shard budget of 4 blocks, the 4-shard pool holds
    16 blocks and admits 4x the concurrent sequences."""
    budget = 4
    prompts = [([i + 1] * 9, 6) for i in range(8)]    # 2 blocks each
    peaks = {}
    for tp in (1, 4):
        kw = {"mesh": _mesh(4)} if tp == 4 else {}
        eng = _port(params, max_slots=8, num_blocks=budget * tp,
                    prefix_cache=False, name=f"cap{tp}", **kw)
        try:
            eng.generate([1, 2], max_tokens=2)
            eng.stats["peak_occupancy"] = 0
            handles = [eng.submit(p, max_tokens=m) for p, m in prompts]
            for h in handles:
                h.result(timeout=120)
            peaks[tp] = eng.stats["peak_occupancy"]
            assert eng.per_chip_blocks == budget
        finally:
            eng.close()
    assert peaks[1] == 2
    assert peaks[4] >= 3 * peaks[1]


# -------------------------------------------------- export and import

def test_export_from_sharded_pool_is_the_single_chip_bundle(sharded,
                                                            unsharded):
    prompt = list(range(5, 26))
    a = sharded.prefill_export(prompt, max_tokens=6, timeout=60)
    b = unsharded.prefill_export(prompt, max_tokens=6, timeout=60)
    assert a["meta"]["first_token"] == b["meta"]["first_token"]
    assert a["meta"]["kv_heads"] == 4
    for x, y in zip(a["pages"], b["pages"]):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert x.numpy().tobytes() == y.numpy().tobytes()
    assert a["meta"]["page_bytes"] == b["meta"]["page_bytes"]


def test_sharded_export_copies_only_its_blocks(params, monkeypatch):
    """An export reads its own blocks of each shard's pool, never a copy
    of the whole pool: no tensor the export joins is as large as one
    pool component, the pool being far larger than the prompt's
    activations here. A sharded engine has no single pool to read."""
    eng = _port(params, mesh=_mesh(4), max_slots=1, max_context=64,
                num_blocks=512, prefix_cache=False, name="tshard-copy")
    try:
        whole = sum(sh.cache[0].numel() * sh.cache[0].element_size()
                    for sh in eng._shards)
        with pytest.raises(RuntimeError, match="one pool per shard"):
            eng._cache
        joined = []
        cat = torch.cat

        def recording_cat(tensors, *a, **kw):
            out = cat(tensors, *a, **kw)
            joined.append(out.numel() * out.element_size())
            return out

        monkeypatch.setattr(torch, "cat", recording_cat)
        bundle = eng.prefill_export(list(range(3, 22)), max_tokens=4,
                                    timeout=60)
        monkeypatch.undo()
        assert bundle["meta"]["n_blocks"] == 3
        assert joined and max(joined) < whole // 8
        assert sum(p.numel() * p.element_size()
                   for p in bundle["pages"][:1]) < whole // 8
    finally:
        eng.close()


@pytest.mark.parametrize("tp", [1, 4])
def test_mesh_engine_refuses_imports_at_any_size(params, unsharded, tp):
    bundle = unsharded.prefill_export([1, 2, 3, 4], max_tokens=4,
                                      timeout=60)
    eng = _port(params, mesh=_mesh(tp), name=f"imp{tp}")
    try:
        before = t_gen._KV_IMPORT_REJECTIONS.value(f"imp{tp}", "mesh")
        with pytest.raises(t_gen.KVImportError, match="unsharded") as e:
            eng.import_bundle(bundle)
        assert e.value.reason == "mesh"
        assert t_gen._KV_IMPORT_REJECTIONS.value(f"imp{tp}", "mesh") \
            == before + 1
        assert eng.stats["kv_import_rejections"] == 1
    finally:
        eng.close()


# ------------------------------------------------------- speculative

def test_speculative_on_4_shard_mesh_incl_boundary(params):
    eng = _port(params, mesh=_mesh(4), name="tspec", draft_params=params,
                draft_config=_tcfg(), spec_k=3)
    try:
        specs = [([1, 2, 3], 12), ([5, 6, 7, 8, 9], 4), ([4] * 11, 8),
                 ([60, 2], 10)]
        handles = [eng.submit(p, max_tokens=m) for p, m in specs]
        for (prompt, m), h in zip(specs, handles):
            assert h.result(timeout=240)[0] == _ref(params, prompt, m)
        assert eng.stats["spec_proposed"] > 0
        assert eng.stats["spec_accepted"] == eng.stats["spec_proposed"]
    finally:
        eng.close()


def test_bf16_spec_on_mesh_token_identical(params):
    cfg_b = _tcfg("bfloat16")
    eng = _port(params, "bfloat16", mesh=_mesh(4), name="tspecb",
                draft_params=params, draft_config=cfg_b, spec_k=2)
    try:
        for prompt in ([1, 2, 3], [5] * 9):
            assert eng.generate(prompt, max_tokens=8)[0] \
                == _ref(params, prompt, 8, "bfloat16"), prompt
    finally:
        eng.close()


# -------------------------------------------------------- row sharding

ROW_SPECS = [([1, 2, 3], 10), ([5] * 8, 6), (list(range(1, 18)), 8),
             ([60, 2], 12)]


def test_row_f32_matches_replicated_sharded_engine(params, sharded):
    eng = _port(params, mesh=_mesh(4), row_shard=True, name="row-row")
    try:
        row = [h.result(timeout=120)[0] for h in
               [eng.submit(p, max_tokens=m) for p, m in ROW_SPECS]]
    finally:
        eng.close()
    rep = [h.result(timeout=120)[0] for h in
           [sharded.submit(p, max_tokens=m) for p, m in ROW_SPECS]]
    assert row == rep
    for (prompt, m), out in zip(ROW_SPECS, row):
        assert out == _ref(params, prompt, m), prompt


def test_row_f32_logits_within_tolerance_of_oracle(params):
    prompt, m = [3, 9, 1, 22, 7, 15, 2], 10
    toks, rows = conformance.reference_logits(params, _tcfg(), prompt, m)
    eng = _port(params, mesh=_mesh(4), row_shard=True, prefix_cache=False,
                debug_logits=True, name="row-tol")
    try:
        h = eng.submit(prompt, max_tokens=m)
        assert h.wait(timeout=120)
    finally:
        eng.close()
    assert h.out_tokens == toks
    report = conformance.assert_logits_close(
        h.logits, rows, atol=1e-3, rtol=1e-3,
        what="row-sharded f32 vs oracle")
    assert report["steps"] == m


def test_row_bf16_logits_within_documented_envelope(params):
    _toks, rows32 = conformance.reference_logits(params, _tcfg(),
                                                 [1, 2, 3], 8)
    eng = _port(params, "bfloat16", mesh=_mesh(4), row_shard=True,
                prefix_cache=False, debug_logits=True, name="row-bf16")
    try:
        h = eng.submit([1, 2, 3], max_tokens=8)
        assert h.wait(timeout=120)
    finally:
        eng.close()
    conformance.assert_logits_close(h.logits, rows32, atol=0.2, rtol=0.1,
                                    what="row-sharded bf16 vs fp32 oracle")


def test_row_prefix_hit_and_paged_kernel_compose(params):
    eng = _port(params, mesh=_mesh(4), row_shard=True,
                attn_backend="paged-kernel", name="row-px")
    shared = list(range(1, 17))
    try:
        for tail in ([40, 41, 42], [50, 51]):
            prompt = shared + tail
            assert eng.generate(prompt, max_tokens=6)[0] \
                == _ref(params, prompt, 6)
        assert eng.stats["prefix_hits"] >= 1
    finally:
        eng.close()


def test_gqa_row_shard_on_2_shard_mesh(gqa):
    cfg = _tcfg(n_kv_heads=2)
    eng = _port(gqa[1], cfg=cfg, mesh=_mesh(2), row_shard=True,
                name="row-gqa")
    try:
        for prompt in ([1, 2, 3], [9] * 10):
            assert eng.generate(prompt, max_tokens=8)[0] \
                == _ref(gqa[1], prompt, 8, cfg=cfg), prompt
    finally:
        eng.close()


def test_collective_share_measurable(params, unsharded):
    eng = _port(params, mesh=_mesh(4), row_shard=True, prefix_cache=False,
                name="row-share")
    try:
        share = eng.measure_collective_share(iters=2)
        assert eng.stats["collective_share"] == round(share, 4)
        assert t_gen._SHARD_COLLECTIVE_SHARE.value("row-share") == share
    finally:
        eng.close()
    assert 0.0 <= share < 1.0
    assert unsharded.measure_collective_share() == 0.0


def test_collective_bytes_per_layer_drop(params, sharded, unsharded):
    rep = sharded.collective_bytes_per_step()
    eng = _port(params, mesh=_mesh(4), row_shard=True, prefix_cache=False,
                name="row-bytes")
    try:
        row = eng.collective_bytes_per_step()
    finally:
        eng.close()
    assert row["per_layer"] < rep["per_layer"]
    assert rep["per_step"] == 0 and row["per_step"] > 0
    assert rep["total"] > 0 and row["total"] > 0
    assert unsharded.collective_bytes_per_step() \
        == {"per_layer": 0, "per_step": 0, "total": 0}


def test_row_shard_requires_mesh(params):
    with pytest.raises(ValueError, match="row_shard=True needs a mesh"):
        _port(params, row_shard=True)


def test_vocab_indivisible_raises_named_error():
    cfg = tt.Config(vocab_size=66, d_model=32, n_layers=2, n_heads=4,
                    max_seq=64, dtype="float32", attention="dense",
                    remat=False)
    pv = tt.init_params(cfg, torch.Generator().manual_seed(5),
                        device="cpu")
    with pytest.raises(t_gen.MeshShapeError, match="vocab_size=66"):
        t_gen.GenerationEngine(pv, cfg, max_slots=2, block_size=8,
                               name="row-bad", mesh=_mesh(4),
                               row_shard=True)
