"""KV-page migration on the port against the JAX package.

A prefill-role engine runs the prefill only and exports the prompt's
pages in the pool's native dtype with the first token; a decode-role
engine imports them into free blocks and decodes, and the continuation
is the colocated engine's. At the config of ``tests/test_kv_migration.py``
(vocab 64, d_model 32, 2 layers, block 8, 2 slots) with JAX's weights
carried across by ``params_from_jax``, every migration here rides the
real codec (``encode_kv_bundle`` → bytes → ``decode_kv_bundle``):

- the matrix {fp32, bf16, int8 on fp32} x {plain, prefix-cache hit on
  the exporter, chunked export, speculative importer, preempt-resume of
  the imported slot}, each cell held to JAX's ``reference_greedy_decode``
  in fp32 and to a port-colocated engine of the same pool in bf16 and
  int8 (quantized decode leaves the fp32 reference; migration must add
  nothing);
- byte compatibility for each pool: the port's codec writes JAX's bytes
  for the same pages and meta; a JAX prefill-role engine's bundle is
  imported by a port decode-role engine, and a port bundle goes through
  JAX's ``decode_kv_bundle`` and ``import_bundle``; the pages land bit
  for bit, fp32 continuations equal JAX's oracle and int8 ones JAX's
  int8 engine's but where its top-2 logit gap is below 1e-3;
- every codec defect (the same ``ValueError`` text as JAX's) and every
  ``KVImportError`` reason the port can reach (the same reason and text
  as JAX's engine for the same bundle), booked on the stats and on
  ``serving_kv_import_rejections_total``;
- the role knob, the ``exported``/``imported`` events and the
  ``snapshot()`` migration view against JAX's keys and values.

The JAX engines are module-scoped; each port engine lives for one test.
"""

import dataclasses
import functools
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.compute import generate as j_gen
from kubeflow_tpu.compute import serving as j_serving
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute import serving as t_serving
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.params import params_from_jax
from kubeflow_tpu_torch.obs import metrics as t_metrics

LIMIT = 120.0        # seconds any one wait of a test may take
PROMPT = [5, 9, 3, 7, 11, 2, 44, 17, 8, 23, 30, 6]   # 12 = 1.5 blocks
LONG = [(3 * j) % 63 + 1 for j in range(33)]          # 33: ragged chunks

#: the pools of the matrix: (label, model dtype, kv_dtype)
POOLS = [("fp32", "float32", None),
         ("bf16", "bfloat16", None),
         ("int8", "float32", "int8")]
POOL_IDS = [p[0] for p in POOLS]


def _jcfg(dtype="float32"):
    return jt.Config(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                     max_seq=128, dtype=dtype, attention="dense",
                     remat=False, scan_layers=True)


def _tcfg(dtype="float32"):
    j = _jcfg(dtype)
    return tt.Config(**{f.name: getattr(j, f.name)
                        for f in dataclasses.fields(tt.Config)})


def _kw(kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_context", 128)
    kw.setdefault("name", kw.get("role", "both"))
    return kw


@pytest.fixture(scope="module")
def jparams():
    return jt.init_params(_jcfg(), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _engine(params, dtype="float32", **kw):
    return t_gen.GenerationEngine(params, _tcfg(dtype), device="cpu",
                                  **_kw(kw))


def _jax_engine(jparams, dtype="float32", **kw):
    return j_gen.GenerationEngine(jparams, _jcfg(dtype), **_kw(kw))


@pytest.fixture(scope="module")
def jax_engines(jparams):
    """Per pool: a JAX prefill-role engine, a decode-role engine and a
    colocated ``debug_logits`` engine (the int8 oracle's logits)."""
    engines = {}
    for label, dtype, kv in POOLS:
        engines[label] = {
            "prefill": _jax_engine(jparams, dtype, kv_dtype=kv,
                                   role="prefill", name=f"j-pre-{label}"),
            "decode": _jax_engine(jparams, dtype, kv_dtype=kv,
                                  role="decode", name=f"j-dec-{label}"),
            "oracle": _jax_engine(jparams, dtype, kv_dtype=kv,
                                  prefix_cache=False, debug_logits=True,
                                  name=f"j-oracle-{label}")}
    yield engines
    for group in engines.values():
        for eng in group.values():
            eng.close()


@functools.lru_cache(maxsize=None)
def _jax_ref(prompt, max_tokens):
    params = jt.init_params(_jcfg(), jax.random.PRNGKey(0))
    return j_gen.reference_greedy_decode(params, _jcfg(), list(prompt),
                                         max_tokens)


def _wire(bundle, encode=t_serving.encode_kv_bundle,
          decode=t_serving.decode_kv_bundle):
    """A bundle through the x-tensor framing → the decoded bundle."""
    parts, headers, ctype = encode(bundle)
    assert ctype == "application/x-tensor"
    return decode(dict(headers), b"".join(bytes(p) for p in parts))


def _closing(*engines):
    class _Ctx:
        def __enter__(self):
            return engines

        def __exit__(self, *exc):
            for e in engines:
                e.close()
    return _Ctx()


def _oracle(params, dtype, kv_dtype, prompt, max_tokens, **kw):
    """fp32: JAX's cache-free greedy decode; bf16 and int8: a colocated
    port engine of the same pool."""
    if dtype == "float32" and kv_dtype is None:
        return _jax_ref(tuple(prompt), max_tokens)
    with _closing(_engine(params, dtype, kv_dtype=kv_dtype,
                          name="oracle", **kw)) as (col,):
        return col.generate(list(prompt), max_tokens=max_tokens)[0]


def _until(cond, what):
    deadline = time.monotonic() + LIMIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


def _bits(x):
    """A page's raw bytes (torch or numpy, bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _landing(engine, take):
    """An ``on_token`` that, at the first token (the slot just installed,
    no decode step yet), copies the occupied slot's prompt blocks out of
    every pool component with ``take(component, blocks)`` → (the dict
    it fills under ``"pages"``, the callback)."""
    got = {}

    def on_token(token, index):
        if index == 0:
            slot = next(s for s in engine._slots if s is not None)
            n = -(-len(slot.handle.prompt) // engine.block_size)
            got["pages"] = [take(comp, list(slot.blocks[:n]))
                            for comp in engine._cache]
    return got, on_token


def _port_take(comp, blocks):
    return comp[:, torch.tensor(blocks)].clone()


def _jax_take(comp, blocks):
    return np.asarray(comp[:, np.asarray(blocks)])


def _agree(got, want, logits, tol=1e-3):
    """``got`` equals ``want`` but where the engine that made ``want``
    had a top-2 logit gap below ``tol`` at the first mismatch."""
    n = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if n is None:
        assert len(got) == len(want)
        return
    top2 = np.sort(np.asarray(logits[n]).reshape(-1))[-2:]
    assert top2[1] - top2[0] < tol, (n, got, want, top2)


class TestMigrationMatrix:
    """Export on a prefill-role engine, the wire round trip, import on a
    decode-role engine; the continuation against the pool's oracle."""

    @pytest.mark.parametrize("label,dtype,kv_dtype", POOLS, ids=POOL_IDS)
    def test_plain(self, params, label, dtype, kv_dtype):
        with _closing(_engine(params, dtype, kv_dtype=kv_dtype,
                              role="prefill"),
                      _engine(params, dtype, kv_dtype=kv_dtype,
                              role="decode")) as (pre, dec):
            bundle = _wire(pre.prefill_export(list(PROMPT), max_tokens=16))
            meta = bundle["meta"]
            assert meta["n_blocks"] == 2 and meta["page_bytes"] > 0
            assert (meta["scale_bytes"] > 0) == (kv_dtype == "int8")
            handle = dec.import_bundle(bundle)
            toks, reason = handle.result(timeout=LIMIT)
            assert reason == "length"
            assert toks == _oracle(params, dtype, kv_dtype, PROMPT, 16)
            assert pre.stats["kv_exports"] == 1
            assert pre.stats["kv_bytes_migrated"] \
                == meta["page_bytes"] + meta["scale_bytes"]
            assert dec.stats["kv_imports"] == 1
            # no forward pass ran on the importer for the prompt
            assert dec.stats["prefills"] == 0
            assert handle.prefix_tokens_skipped == 0

    @pytest.mark.parametrize("label,dtype,kv_dtype", POOLS, ids=POOL_IDS)
    def test_prefix_cache_hit_export(self, params, label, dtype, kv_dtype):
        """The exporter's trie serves its second export; the pages it
        ships are still whole."""
        with _closing(_engine(params, dtype, kv_dtype=kv_dtype,
                              role="prefill"),
                      _engine(params, dtype, kv_dtype=kv_dtype,
                              role="decode")) as (pre, dec):
            first = pre.prefill_export(list(PROMPT), max_tokens=16)
            again = pre.prefill_export(list(PROMPT), max_tokens=16)
            assert first["meta"]["prefix_tokens_skipped"] == 0
            assert again["meta"]["prefix_tokens_skipped"] == 8
            for a, b in zip(first["pages"], again["pages"]):
                assert a.shape == b.shape
            toks, _ = dec.import_bundle(_wire(again)).result(timeout=LIMIT)
            assert toks == _oracle(params, dtype, kv_dtype, PROMPT, 16)

    @pytest.mark.parametrize("label,dtype,kv_dtype", POOLS, ids=POOL_IDS)
    def test_chunked_export(self, params, label, dtype, kv_dtype):
        with _closing(_engine(params, dtype, kv_dtype=kv_dtype,
                              role="prefill", prefill_chunk=8,
                              prefix_cache=False),
                      _engine(params, dtype, kv_dtype=kv_dtype,
                              role="decode")) as (pre, dec):
            bundle = _wire(pre.prefill_export(list(LONG), max_tokens=12))
            assert pre.stats["prefill_chunks"] >= 4      # 33 / 8
            assert bundle["meta"]["n_blocks"] == 5
            assert not any(e["event"] == "evicted"
                           for e in pre.timeline_view())
            toks, _ = dec.import_bundle(bundle).result(timeout=LIMIT)
            assert toks == _oracle(params, dtype, kv_dtype, LONG, 12)
            assert pre.occupancy() == 0
            assert pre.blocks_view()["referenced"] == []

    @pytest.mark.parametrize("label,dtype,kv_dtype", POOLS, ids=POOL_IDS)
    def test_speculative_importer(self, params, label, dtype, kv_dtype):
        """The importer drafts and verifies over the migrated pages."""
        with _closing(_engine(params, dtype, kv_dtype=kv_dtype,
                              role="prefill"),
                      _engine(params, dtype, kv_dtype=kv_dtype,
                              role="decode", draft_params=params,
                              draft_config=_tcfg(dtype), spec_k=3)
                      ) as (pre, dec):
            bundle = _wire(pre.prefill_export(list(PROMPT), max_tokens=16))
            toks, _ = dec.import_bundle(bundle).result(timeout=LIMIT)
            assert toks == _oracle(params, dtype, kv_dtype, PROMPT, 16)
            assert dec.stats["spec_rounds"] > 0

    @pytest.mark.parametrize("label,dtype,kv_dtype", POOLS, ids=POOL_IDS)
    def test_preempt_resume_of_the_imported_slot(self, params, label,
                                                 dtype, kv_dtype):
        """An imported batch-class slot suspends for an interactive
        arrival and resumes off the trie the import seeded."""
        with _closing(_engine(params, dtype, kv_dtype=kv_dtype,
                              role="prefill"),
                      _engine(params, dtype, kv_dtype=kv_dtype,
                              role="decode", max_slots=1)) as (pre, dec):
            bundle = _wire(pre.prefill_export(list(PROMPT), max_tokens=20))
            dec._step_sleep = 0.01
            try:
                batch = dec.import_bundle(bundle, qos_class="batch")
                _until(lambda: len(batch.out_tokens) >= 5,
                       "the imported stream never decoded")
                inter = dec.submit([4, 4, 8], max_tokens=4,
                                   qos_class="interactive")
                inter.result(timeout=LIMIT)
                batch.result(timeout=LIMIT)
            finally:
                dec._step_sleep = 0.0
            assert batch.preemptions >= 1
            assert batch.out_tokens == _oracle(params, dtype, kv_dtype,
                                               PROMPT, 20, max_slots=1)
            assert inter.out_tokens == _oracle(params, dtype, kv_dtype,
                                               [4, 4, 8], 4, max_slots=1)
            assert batch.prefix_tokens_skipped >= len(PROMPT)


class TestByteCompatibility:
    @pytest.mark.parametrize("label,dtype,kv_dtype", POOLS, ids=POOL_IDS)
    def test_the_port_writes_jaxs_bytes(self, jax_engines, params, label,
                                        dtype, kv_dtype):
        """The same pages and meta → the same parts, headers and content
        type: JAX's own numpy pages, those pages as torch tensors, and a
        port bundle's tensors beside their numpy copies."""
        jb = jax_engines[label]["prefill"].prefill_export(list(PROMPT),
                                                          max_tokens=8)
        want = j_serving.encode_kv_bundle(jb)
        for pages in (jb["pages"],
                      [t_serving.page_tensor(p) for p in jb["pages"]]):
            got = t_serving.encode_kv_bundle({"meta": jb["meta"],
                                              "pages": pages})
            assert [bytes(p) for p in got[0]] == [bytes(p) for p in want[0]]
            assert got[1:] == want[1:]
        with _closing(_engine(params, dtype, kv_dtype=kv_dtype,
                              role="prefill")) as (pre,):
            tb = pre.prefill_export(list(PROMPT), max_tokens=8)
        as_np = [p.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                 if p.dtype == torch.bfloat16 else p.numpy()
                 for p in tb["pages"]]
        got = t_serving.encode_kv_bundle(tb)
        want = j_serving.encode_kv_bundle({"meta": tb["meta"],
                                           "pages": as_np})
        assert [bytes(p) for p in got[0]] == [bytes(p) for p in want[0]]
        assert got[1:] == want[1:]
        assert set(tb["meta"]) == set(jb["meta"])
        for key in ("prompt", "first_token", "max_tokens", "block_size",
                    "n_blocks", "kv_dtype", "n_layers", "kv_heads",
                    "head_dim", "page_bytes", "scale_bytes"):
            if dtype == "float32" or key != "first_token":
                assert tb["meta"][key] == jb["meta"][key], key

    @pytest.mark.parametrize("label,dtype,kv_dtype", POOLS, ids=POOL_IDS)
    def test_a_jax_bundle_continues_on_the_port(self, jax_engines, params,
                                                label, dtype, kv_dtype):
        jeng = jax_engines[label]
        jb = jeng["prefill"].prefill_export(list(PROMPT), max_tokens=10)
        bundle = _wire(jb, encode=j_serving.encode_kv_bundle)
        with _closing(_engine(params, dtype, kv_dtype=kv_dtype,
                              role="decode")) as (dec,):
            landed, on_token = _landing(dec, _port_take)
            toks, reason = dec.import_bundle(
                bundle, on_token=on_token).result(timeout=LIMIT)
        assert reason == "length" and len(toks) == 10
        assert [_bits(p) for p in landed["pages"]] \
            == [_bits(p) for p in jb["pages"]]
        if kv_dtype == "int8":
            h = jeng["oracle"].submit(list(PROMPT), max_tokens=10)
            _agree(toks, h.result(timeout=LIMIT)[0], h.logits)
        else:
            assert toks == _oracle(params, dtype, None, PROMPT, 10)

    @pytest.mark.parametrize("label,dtype,kv_dtype", POOLS, ids=POOL_IDS)
    def test_a_port_bundle_continues_on_jax(self, jax_engines, params,
                                            label, dtype, kv_dtype):
        jeng = jax_engines[label]
        with _closing(_engine(params, dtype, kv_dtype=kv_dtype,
                              role="prefill")) as (pre,):
            tb = pre.prefill_export(list(PROMPT), max_tokens=10)
        bundle = _wire(tb, decode=j_serving.decode_kv_bundle)
        landed, on_token = _landing(jeng["decode"], _jax_take)
        toks, reason = jeng["decode"].import_bundle(
            bundle, on_token=on_token).result(timeout=LIMIT)
        assert reason == "length" and len(toks) == 10
        assert [_bits(p) for p in landed["pages"]] \
            == [_bits(p) for p in tb["pages"]]
        if kv_dtype == "int8":
            h = jeng["oracle"].submit(list(PROMPT), max_tokens=10)
            _agree(toks, h.result(timeout=LIMIT)[0], h.logits)
        elif dtype == "float32":
            assert toks == _jax_ref(tuple(PROMPT), 10)

    def test_numpy_pages_import_without_the_wire(self, jax_engines,
                                                 params):
        """JAX's numpy pages (bf16 through their int16 bits) handed to
        the port's ``import_bundle`` as they are."""
        jb = jax_engines["bf16"]["prefill"].prefill_export(list(PROMPT),
                                                           max_tokens=6)
        assert jb["pages"][0].dtype.name == "bfloat16"
        with _closing(_engine(params, "bfloat16", role="decode")) as (dec,):
            landed, on_token = _landing(dec, _port_take)
            toks, _ = dec.import_bundle(jb, on_token=on_token).result(
                timeout=LIMIT)
        assert [_bits(p) for p in landed["pages"]] \
            == [_bits(p) for p in jb["pages"]]
        assert toks == _oracle(params, "bfloat16", None, PROMPT, 6)


def _encoded(kv_dtype=None):
    pages = [np.arange(2 * 1 * 8 * 4 * 8, dtype=np.float32).reshape(
        2, 1, 8, 4, 8) for _ in range(2)]
    bundle = {"meta": {"block_size": 8, "n_layers": 2, "kv_heads": 4,
                       "head_dim": 8, "n_blocks": 1, "prompt": [1, 2],
                       "first_token": 3, "page_bytes": 0,
                       "scale_bytes": 0}, "pages": pages}
    parts, headers, _ = j_serving.encode_kv_bundle(bundle)
    return dict(headers), b"".join(bytes(p) for p in parts)


def _set(key, value):
    def mutate(h, b):
        return {**h, key: value}, b
    return mutate


def _drop(key):
    def mutate(h, b):
        return {k: v for k, v in h.items() if k != key}, b
    return mutate


def _meta_as(raw):
    """Replace the meta part with ``raw`` bytes."""
    def mutate(h, b):
        n = int(h["X-KV-Meta-Bytes"])
        return {**h, "X-KV-Meta-Bytes": str(len(raw))}, raw + b[n:]
    return mutate


DEFECTS = {
    "no-meta-bytes": _drop("X-KV-Meta-Bytes"),
    "meta-bytes-not-int": _set("X-KV-Meta-Bytes", "twelve"),
    "meta-bytes-zero": _set("X-KV-Meta-Bytes", "0"),
    "meta-bytes-past-body": _set("X-KV-Meta-Bytes", "99999999"),
    "meta-not-json": _meta_as(b"{not json"),
    "meta-not-object": _meta_as(b"[1, 2, 3]"),
    "count-mismatch": _set("X-Tensor-Shape", "2,1,8,4,8"),
    "no-dtypes": _drop("X-Tensor-Dtype"),
    "unlisted-dtype": _set("X-Tensor-Dtype", "float64,float64"),
    "shape-not-ints": _set("X-Tensor-Shape", "2,1,8,4,x;2,1,8,4,8"),
    "negative-dim": _set("X-Tensor-Shape", "2,1,8,4,-8;2,1,8,4,8"),
    "short-body": lambda h, b: (h, b[:-4]),
    "trailing-bytes": lambda h, b: (h, b + b"\0\0"),
}


class TestCodec:
    @pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16",
                                       "int8"])
    def test_round_trip_keeps_bytes_and_dtype(self, dtype):
        g = torch.Generator().manual_seed(0)
        pages = [torch.randint(-100, 100, (2, 1, 8, 4, 8), generator=g
                               ).to(getattr(torch, dtype))
                 for _ in range(2)]
        out = _wire({"meta": {"first_token": 3}, "pages": pages})
        assert out["meta"] == {"first_token": 3}
        assert out["_t_recv"] <= time.perf_counter()
        for a, b in zip(pages, out["pages"]):
            assert b.dtype == a.dtype and b.shape == a.shape
            assert _bits(a) == _bits(b)

    def test_pages_alias_a_writable_body(self):
        headers, body = _encoded()
        body = bytearray(body)
        out = t_serving.decode_kv_bundle(headers, body)
        n = int(headers["X-KV-Meta-Bytes"])
        body[n:n + 4] = np.float32(7.5).tobytes()
        assert out["pages"][0].reshape(-1)[0].item() == 7.5

    def test_an_empty_part_decodes(self):
        pages = [torch.zeros((2, 0, 8, 4, 8)), torch.ones((1, 2))]
        out = _wire({"meta": {}, "pages": pages})
        assert out["pages"][0].shape == (2, 0, 8, 4, 8)
        assert torch.equal(out["pages"][1], pages[1])

    @pytest.mark.parametrize("defect", sorted(DEFECTS))
    def test_a_defect_raises_jaxs_value_error(self, defect):
        headers, body = DEFECTS[defect](*_encoded())
        with pytest.raises(ValueError) as want:
            j_serving.decode_kv_bundle(headers, body)
        with pytest.raises(ValueError) as got:
            t_serving.decode_kv_bundle(headers, body)
        assert str(got.value) == str(want.value)


def _rejections(name, reason):
    return t_metrics.REGISTRY._by_name[
        "serving_kv_import_rejections_total"].value(name, reason)


def _meta(**kw):
    def mutate(bundle):
        return {**bundle, "meta": {**bundle["meta"], **kw}}
    return mutate


def _drop_meta(key):
    def mutate(bundle):
        return {**bundle, "meta": {k: v for k, v in bundle["meta"].items()
                                   if k != key}}
    return mutate


def _short_pages(bundle):
    return {**bundle, "pages": tuple(p[:, :, :4] for p in bundle["pages"])}


#: (engine kwargs, bundle mutation, import kwargs, reason)
REJECTIONS = {
    "role": (dict(role="prefill"), None, {}, "role"),
    "block-size": (dict(block_size=16), None, {}, "block_size"),
    "layers": ({}, _meta(n_layers=7), {}, "geometry"),
    "kv-heads": ({}, _meta(kv_heads=2), {}, "geometry"),
    "no-prompt": ({}, _drop_meta("prompt"), {}, "geometry"),
    "n-blocks": ({}, _meta(n_blocks=3), {}, "geometry"),
    "page-shape": ({}, _short_pages, {}, "geometry"),
    "dtype": (dict(kv_dtype="int8"), None, {}, "dtype"),
    "vocab": ({}, _meta(prompt=[1, 2, 9999] * 4), {}, "vocab"),
    "first-token": ({}, _meta(first_token=64), {}, "vocab"),
    "context": ({}, None, dict(max_tokens=200), "capacity"),
    "blocks": (dict(num_blocks=2, prefix_cache=False), None, {},
               "capacity"),
}


class TestImportRejections:
    @pytest.mark.parametrize("case", sorted(REJECTIONS))
    def test_each_reason_is_jaxs_and_booked(self, jax_engines, jparams,
                                            params, case):
        eng_kw, mutate, imp_kw, reason = REJECTIONS[case]
        jb = jax_engines["fp32"]["prefill"].prefill_export(list(PROMPT),
                                                           max_tokens=8)
        bundle = mutate(jb) if mutate else jb
        name = f"rej-{case}"
        jeng = _jax_engine(jparams, name=name,
                           **{"role": "decode", **eng_kw})
        teng = _engine(params, name=name, **{"role": "decode", **eng_kw})
        with _closing(jeng, teng):
            with pytest.raises(j_gen.KVImportError) as want:
                jeng.import_bundle(bundle, **imp_kw)
            before = _rejections(name, reason)
            with pytest.raises(t_gen.KVImportError) as got:
                teng.import_bundle(bundle, **imp_kw)
            assert isinstance(got.value, ValueError)
            assert (got.value.reason, str(got.value)) \
                == (want.value.reason, str(want.value)) == (
                    reason, str(want.value))
            assert teng.stats["kv_import_rejections"] == 1
            assert teng.snapshot()["migration"]["rejections"] == 1
            assert _rejections(name, reason) == before + 1
            assert teng.occupancy() == 0 and not teng.snapshot()["queued"]

    def test_a_draining_engine_refuses_an_import(self, jax_engines,
                                                 params):
        jb = jax_engines["fp32"]["prefill"].prefill_export(list(PROMPT),
                                                           max_tokens=8)
        with _closing(_engine(params, role="decode")) as (dec,):
            dec.begin_drain()
            with pytest.raises(t_gen.DrainingError):
                dec.import_bundle(jb)
            assert dec.stats["kv_import_rejections"] == 0


class TestRoleKnob:
    def test_an_invalid_role_raises(self, params):
        with pytest.raises(ValueError, match="role"):
            _engine(params, role="decoder")

    def test_both_is_the_default_and_capability_complete(self, params):
        with _closing(_engine(params)) as (eng,):
            assert eng.role == "both" and eng.snapshot()["role"] == "both"
            bundle = eng.prefill_export(list(PROMPT), max_tokens=6)
            toks, _ = eng.import_bundle(_wire(bundle)).result(timeout=LIMIT)
            assert toks == _jax_ref(tuple(PROMPT), 6)
            assert eng.generate([1, 2, 3], max_tokens=3)[0] \
                == _jax_ref((1, 2, 3), 3)

    @pytest.mark.parametrize("role", ["prefill", "decode", "both"])
    def test_the_role_shows_in_the_snapshot_and_the_gauge(self, params,
                                                          role):
        name = f"role-{role}"
        with _closing(_engine(params, role=role, name=name)) as (eng,):
            snap = eng.snapshot()
            assert snap["role"] == role and "queued_tokens" in snap
            gauge = t_metrics.REGISTRY._by_name["serving_generate_role"]
            assert {r: gauge.value(name, r) for r in t_gen.ROLES} == {
                r: float(r == role) for r in t_gen.ROLES}
            # a prefill replica still serves :generate (the router's
            # colocated fallback)
            assert eng.generate([1, 2, 3], max_tokens=2)[1] == "length"


class TestEventsAndSnapshot:
    def test_the_migration_views_are_jaxs(self, jparams, params):
        """The same export and import on JAX's engines and the port's:
        the ``exported``, ``admitted`` and ``imported`` events carry the
        same keys and counts, and the snapshot's migration view the same
        numbers."""
        views = {}
        for side, make in (("jax", functools.partial(_jax_engine, jparams)),
                           ("port", functools.partial(_engine, params))):
            pre = make(role="prefill", name=f"ev-pre-{side}")
            dec = make(role="decode", name=f"ev-dec-{side}")
            try:
                encode = (j_serving if side == "jax" else t_serving
                          ).encode_kv_bundle
                decode = (j_serving if side == "jax" else t_serving
                          ).decode_kv_bundle
                bundle = _wire(pre.prefill_export(list(PROMPT),
                                                  max_tokens=4),
                               encode=encode, decode=decode)
                handle = dec.import_bundle(bundle)
                assert handle.result(timeout=LIMIT)[1] == "length"
                views[side] = {
                    "pre": pre.snapshot()["migration"],
                    "dec": dec.snapshot()["migration"],
                    "exported": [e for e in pre.timeline_view()
                                 if e["event"] == "exported"],
                    "dec_events": [e for e in dec.timeline_view()
                                   if e["request"] == handle.seq]}
            finally:
                pre.close()
                dec.close()
        j, t = views["jax"], views["port"]
        assert t["pre"] == j["pre"] == {"exports": 1, "imports": 0,
                                        "bytes": 2 * 2 * 2 * 8 * 4 * 8 * 4,
                                        "rejections": 0}
        assert t["dec"] == j["dec"] == {"exports": 0, "imports": 1,
                                        "bytes": 0, "rejections": 0}

        def shape(events):
            return [(e["event"], sorted(e),
                     {k: e[k] for k in ("blocks", "bytes", "imported",
                                        "reason") if k in e})
                    for e in events]
        assert shape(t["exported"]) == shape(j["exported"])
        assert shape(t["dec_events"]) == shape(j["dec_events"])
        assert [e["event"] for e in t["dec_events"]][:3] == [
            "admitted", "imported", "first_token"]
