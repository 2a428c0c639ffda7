"""The port's int8 KV pool against the JAX reference.

The pool reads first, on the same int8 quadruple ``(k, v, k_scale,
v_scale)`` (``quantize.kv_quantize`` of one seeded draw, carried across
as numpy):

- the K1 and K2 plain versions (``ops.paged_attention``, what the
  wrappers run on CPU tensors) against the Pallas kernels' ``int8_pages``
  branches in interpret mode, both widening a page as ``(int8 → fp32) ×
  scale`` rounded once to q's dtype;
- the block-streamed ``attention.paged_decode_attention`` /
  ``paged_chunk_attention`` against JAX's XLA reads, both widening with
  ``kv_dequantize`` (scale cast to q's dtype, product in q's dtype);
- the two roundings equal in fp32 and at most one bf16 unit apart.

Then the engine with ``kv_dtype="int8"`` on ``device="cpu"`` (fp32, GQA,
2 slots, block size 8) against JAX's int8 engine on the same weights
(``params_from_jax``): tokens identical but where the JAX engine's top-2
logit gap is below 1e-3 (K/V that differ in the last fp32 bit before
quantization may round one code apart), logits within atol 1e-2 / rtol
1e-2, the same ``attn_bytes_read``; each engine within atol 0.08 / rtol
0.05 of the fp32 oracle and measurably off it (atol > 1e-5), as
``tests/test_compute_generate.py:1090`` pins JAX's; prefix cache and
chunked prefill on the int8 pool against JAX's (tokens and counters);
speculative int8 equal to plain int8 (``test_compute_generate.py:849``);
the ``kv_dtype`` knob, the snapshot and the pool's bytes.

Tolerances of the reads: fp32 1e-5 (reduction order only); bf16 0.02,
the paged-read tolerance of ``tests/test_paged_attention.py``.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.compute import attention as j_attn
from kubeflow_tpu.compute import conformance as j_conf
from kubeflow_tpu.compute import generate as j_gen
from kubeflow_tpu.compute import quantize as jq
from kubeflow_tpu.compute.models import transformer as jt
from kubeflow_tpu_torch.compute import attention as t_attn
from kubeflow_tpu_torch.compute import conformance as t_conf
from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.ops import paged_attention as t_paged
from kubeflow_tpu_torch.compute.params import params_from_jax

j_paged = importlib.import_module("kubeflow_tpu.compute.ops.paged_attention")

DTYPES = [("float32", 1e-5), ("bfloat16", 0.02)]
H = 4          # query heads; kv heads = H // n_rep
D = 16
BS = 8         # block size
BPS = 4        # blocks per slot
N = 12         # pool blocks
# inactive slot, one position, exact block multiple, the full table
LENGTHS = [0, 1, 2 * BS, BPS * BS]
PREFIXES = [0, 9, 2 * BS, [0, 9, 25]]
SQ = 5         # chunk rows


def _t(a):
    """A numpy / JAX array → a CPU tensor of the same dtype, bf16
    bit for bit (numpy's bfloat16 goes through its int16 bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        atol=tol, rtol=tol)


def _int8_pool(rng, kv, dtype):
    """An int8 quadruple quantized by JAX from a seeded draw in
    ``dtype``, in both frameworks."""
    kc, vc = (jnp.asarray(rng.normal(size=(N, BS, kv, D)) * 2, dtype)
              for _ in range(2))
    (kq, ks), (vq, vs) = jq.kv_quantize(kc), jq.kv_quantize(vc)
    jpages = (kq, vq, ks, vs)
    return jpages, tuple(_t(p) for p in jpages)


def _decode_case(dtype, n_rep, seed=0):
    rng = np.random.default_rng(seed)
    jdt = getattr(jnp, dtype)
    jpages, tpages = _int8_pool(rng, H // n_rep, jdt)
    q = jnp.asarray(rng.normal(size=(len(LENGTHS), 1, H, D)), jdt)
    tables = rng.integers(0, N, size=(len(LENGTHS), BPS)).astype(np.int32)
    lengths = np.asarray(LENGTHS, np.int32)
    return ((q, jpages, jnp.asarray(tables), jnp.asarray(lengths)),
            (_t(q), tpages, torch.from_numpy(tables),
             torch.from_numpy(lengths)))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_k1_i8_plain_matches_jax_kernel(dtype, tol, n_rep):
    """The K1 wrapper on CPU tensors (its plain version: no launch is
    counted, int8 or float) against the Pallas decode kernel's
    ``int8_pages`` branch in interpret mode; length 0 stays finite."""
    jargs, targs = _decode_case(dtype, n_rep)
    want = j_paged.paged_decode_attention(*jargs, block_size=BS,
                                          n_rep=n_rep)
    fn = t_paged.paged_decode_attention
    before = (fn.launches, fn.launches_i8)
    got = fn(*targs, block_size=BS, n_rep=n_rep)
    assert (fn.launches, fn.launches_i8) == before
    plain = t_paged.paged_decode_reference(*targs, block_size=BS,
                                           n_rep=n_rep)
    torch.testing.assert_close(got, plain, atol=0, rtol=0)
    assert got.dtype == getattr(torch, dtype)
    assert torch.isfinite(got.float()).all()
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_paged_decode_stream_i8_matches_jax(dtype, tol, n_rep):
    """The block-streamed read over int8 pages (``kv_dequantize``'s
    rounding) against JAX's XLA read."""
    jargs, targs = _decode_case(dtype, n_rep, seed=1)
    want = j_attn.paged_decode_attention(*jargs, block_size=BS,
                                         n_rep=n_rep)
    got = t_attn.paged_decode_attention(*targs, block_size=BS, n_rep=n_rep)
    _close(got, want, tol)


def _chunk_case(dtype, n_rep, prefix, seed=4):
    rng = np.random.default_rng(seed)
    jdt = getattr(jnp, dtype)
    B, kv = 3, H // n_rep
    jpages, tpages = _int8_pool(rng, kv, jdt)
    q = jnp.asarray(rng.normal(size=(B, SQ, H, D)), jdt)
    kch, vch = (jnp.asarray(rng.normal(size=(B, SQ, kv, D)), jdt)
                for _ in range(2))
    tables = rng.integers(0, N, size=(B, BPS)).astype(np.int32)
    if isinstance(prefix, list):
        jp = jnp.asarray(prefix, jnp.int32)
        tp = torch.tensor(prefix, dtype=torch.int32)
    else:
        jp = tp = prefix
    return ((q, jpages, jnp.asarray(tables), jp, kch, vch),
            (_t(q), tpages, torch.from_numpy(tables), tp, _t(kch), _t(vch)))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("prefix", PREFIXES)
def test_k2_i8_plain_matches_jax_kernel(dtype, tol, n_rep, prefix):
    """The K2 wrapper on CPU tensors against the Pallas chunk kernel's
    ``int8_pages`` branch in interpret mode: int8 prefix pages, the
    chunk's own K/V in q's dtype."""
    jargs, targs = _chunk_case(dtype, n_rep, prefix)
    want = j_paged.paged_chunk_attention(*jargs, block_size=BS, n_rep=n_rep)
    fn = t_paged.paged_chunk_attention
    before = (fn.launches, fn.launches_i8)
    got = fn(*targs, block_size=BS, n_rep=n_rep)
    assert (fn.launches, fn.launches_i8) == before
    plain = t_paged.paged_chunk_reference(*targs, block_size=BS,
                                          n_rep=n_rep)
    torch.testing.assert_close(got, plain, atol=0, rtol=0)
    assert torch.isfinite(got.float()).all()
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("prefix", PREFIXES)
def test_paged_chunk_stream_i8_matches_jax(dtype, tol, n_rep, prefix):
    jargs, targs = _chunk_case(dtype, n_rep, prefix, seed=5)
    want = j_attn.paged_chunk_attention(*jargs, block_size=BS, n_rep=n_rep)
    got = t_attn.paged_chunk_attention(*targs, block_size=BS, n_rep=n_rep)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_two_dequant_roundings(dtype):
    """The kernels' widening against ``kv_dequantize``'s: equal in fp32,
    within one unit of the last place in bf16 (and not always equal)."""
    rng = np.random.default_rng(6)
    _, (kq, vq, ks, vs) = _int8_pool(rng, 2, jnp.float32)
    dt = getattr(torch, dtype)
    kern = t_paged._dequant_kernel((kq, vq, ks, vs), dt)
    xla = t_attn._dequant_block((kq, vq, ks, vs), dt)
    for a, b in zip(kern, xla):
        assert a.dtype == b.dtype == dt
        if dtype == "float32":
            torch.testing.assert_close(a, b, atol=0, rtol=0)
        else:
            ulp = torch.finfo(dt).eps * b.float().abs()
            assert bool(((a.float() - b.float()).abs() <= ulp).all())
            assert bool((a != b).any())


# ------------------------------------------------------------ the engine

PROMPTS = [([3, 9, 1, 22, 7, 15, 2], 12), ([5, 5, 44], 4),
           ([9] * 17, 9), ([2, 61, 30, 8], 6), ([1] * 11, 5)]
KW = dict(max_slots=2, block_size=8, max_context=64)


def _jcfg(**kw):
    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, max_seq=64, dtype="float32",
                attention="dense", remat=False, scan_layers=True)
    base.update(kw)
    return jt.Config(**base)


def _tcfg(jcfg=None):
    jcfg = jcfg or _jcfg()
    return tt.Config(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(tt.Config)})


@pytest.fixture(scope="module")
def jparams():
    return jt.init_params(_jcfg(), jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def oracle(jparams):
    return [j_conf.reference_logits(jparams, _jcfg(), p, m)
            for p, m in PROMPTS]


def _churn(eng):
    """The five prompts over 2 slots: → ([(tokens, logits)], stats)."""
    try:
        handles = [eng.submit(p, max_tokens=m) for p, m in PROMPTS]
        outs = [(h.result(timeout=300)[0], h.logits) for h in handles]
        return outs, dict(eng.stats)
    finally:
        eng.close()


@pytest.fixture(scope="module")
def jax_int8(jparams):
    return _churn(j_gen.GenerationEngine(
        jparams, _jcfg(), prefix_cache=False, debug_logits=True,
        kv_dtype="int8", name="torch-int8-parity", **KW))


def _steps(got, want):
    """Steps of two token streams to compare: through the first where
    they part, or all."""
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             None)
    return len(want) if n is None else n + 1


def _assert_tokens(got, want, rows, tol=1e-3):
    """``got`` equals ``want`` but from a step where the top-2 gap of
    ``rows`` is below ``tol``; → the steps to compare logits over."""
    n = _steps(got, want)
    if got[:n] != want[:n]:
        top2 = np.sort(np.asarray(rows[n - 1]))[-2:]
        assert top2[1] - top2[0] < tol, (n - 1, got, want)
    return n


@pytest.mark.parametrize("backend", ["paged", "paged-kernel", "gather"])
def test_int8_engine_matches_jax_int8_engine(tparams, oracle, jax_int8,
                                             backend):
    outs, stats = _churn(t_gen.GenerationEngine(
        tparams, _tcfg(), prefix_cache=False, debug_logits=True,
        kv_dtype="int8", attn_backend=backend, device="cpu", **KW))
    jouts, jstats = jax_int8
    assert stats["prefills"] == len(PROMPTS)
    for (toks, logits), (jtoks, jlogits), (otoks, rows) in zip(
            outs, jouts, oracle):
        n = _assert_tokens(toks, jtoks, jlogits)
        t_conf.assert_logits_close(logits[:n], jlogits[:n], atol=1e-2,
                                   rtol=1e-2,
                                   what="port int8 engine vs JAX int8")
        # each within the int8 envelope of the fp32 oracle, through the
        # first token where it leaves the oracle's
        for got, gt in ((logits, toks), (jlogits, jtoks)):
            m = _steps(gt, otoks)
            t_conf.assert_logits_close(got[:m], rows[:m], atol=0.08,
                                       rtol=0.05, what="int8 vs oracle")
    if backend != "gather":
        assert stats["attn_bytes_read"] == jstats["attn_bytes_read"] > 0


def test_int8_engine_is_measurably_lossy(tparams, oracle):
    """The first prompt through the fp32 int8 engine: within atol 0.08 /
    rtol 0.05 of the oracle, and off it by more than fp32 noise
    (``test_compute_generate.py:1090-1102``)."""
    (prompt, m), (_, rows) = PROMPTS[0], oracle[0]
    outs, _ = _churn(t_gen.GenerationEngine(
        tparams, _tcfg(), prefix_cache=False, debug_logits=True,
        kv_dtype="int8", device="cpu", **KW))
    report = t_conf.assert_logits_close(outs[0][1], rows, atol=0.08,
                                        rtol=0.05, what="int8 vs oracle")
    assert report["steps"] == m and report["atol"] > 1e-5
    fp32, _ = _churn(t_gen.GenerationEngine(
        tparams, _tcfg(), prefix_cache=False, debug_logits=True,
        device="cpu", **KW))
    assert t_conf.assert_logits_close(fp32[0][1], rows, atol=1e-3,
                                      rtol=1e-3)["atol"] < report["atol"]


SHARED = list(range(20, 36))       # two full blocks of 8
PREFIX_STEPS = [(SHARED + [40, 41, 42], 6), (SHARED + [50, 51], 6),
                (SHARED + [60] * 13, 5), ([7, 8, 9], 4)]
STATS = ("prefix_hits", "prefix_tokens_skipped", "prefill_chunks",
         "decode_steps", "attn_bytes_read")


@pytest.mark.parametrize("chunk", [None, 8])
def test_int8_prefix_cache_matches_jax(jparams, tparams, chunk):
    """Sequential submissions on the int8 pool with the prefix cache
    (and chunked prefill): hits read int8 prefix pages through the chunk
    read, the suffix stays float, as in JAX: tokens and counters equal."""
    runs = []
    for eng in (j_gen.GenerationEngine(jparams, _jcfg(), kv_dtype="int8",
                                       prefill_chunk=chunk, name="i8-pc",
                                       **KW),
                t_gen.GenerationEngine(tparams, _tcfg(), kv_dtype="int8",
                                       prefill_chunk=chunk, device="cpu",
                                       **KW)):
        try:
            out = []
            for prompt, n in PREFIX_STEPS:
                toks, reason = eng.generate(prompt, max_tokens=n)
                assert reason == "length"
                out.append((toks, {k: eng.stats[k] for k in STATS}))
            runs.append(out)
        finally:
            eng.close()
    assert runs[1] == runs[0]
    assert runs[1][-1][1]["prefix_hits"] >= 2


def test_speculative_int8_equals_plain_int8(tparams):
    """The verify attends over quantize-dequantize round-tripped chunk
    K/V, the values plain decode reads back from the int8 pool: the
    speculative int8 engine emits the plain int8 engine's tokens."""
    cfg = _tcfg()
    plain = t_gen.GenerationEngine(tparams, cfg, kv_dtype="int8",
                                   device="cpu", **KW)
    spec = t_gen.GenerationEngine(tparams, cfg, kv_dtype="int8",
                                  draft_params=tparams, draft_config=cfg,
                                  spec_k=3, device="cpu", **KW)
    try:
        for prompt in ([1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [4] * 12):
            assert plain.generate(prompt, max_tokens=8)[0] \
                == spec.generate(prompt, max_tokens=8)[0], prompt
        assert spec.stats["spec_proposed"] > 0
        assert spec.snapshot()["kv_dtype"] == "int8"
    finally:
        plain.close()
        spec.close()


def test_kv_dtype_knob_snapshot_and_pool_bytes(tparams):
    with pytest.raises(ValueError, match="kv_dtype"):
        t_gen.GenerationEngine(tparams, _tcfg(), kv_dtype="fp8",
                               device="cpu")
    cfg = dataclasses.replace(_tcfg(), dtype="bfloat16")
    engines = {kv: t_gen.GenerationEngine(tparams, cfg, kv_dtype=kv,
                                          device="cpu", **KW)
               for kv in (None, "int8")}
    try:
        assert engines[None].snapshot()["kv_dtype"] == "bfloat16"
        assert engines["int8"].snapshot()["kv_dtype"] == "int8"
        pool = engines["int8"]._cache
        assert [p.dtype for p in pool] == [torch.int8] * 2 \
            + [torch.float32] * 2
        assert pool[2].shape == pool[0].shape[:-1] + (1,)
        assert bool((pool[2] == 1).all()) and not bool(pool[0].any())
        pages = sum(p.numel() * p.element_size() for p in pool[:2])
        bf16 = sum(p.numel() * p.element_size()
                   for p in engines[None]._cache)
        assert 2 * pages == bf16
        # JAX's per-block formula (generate.py:891-899)
        c = cfg
        assert engines["int8"]._block_read_bytes == (
            8 * c.kv_heads * c.head_dim * 2 + 8 * c.kv_heads * 4 * 2
        ) * c.n_layers
        out, _ = engines["int8"].generate([3, 9, 1, 22, 7], max_tokens=4)
        assert len(out) == 4 and all(0 <= t < 64 for t in out)
    finally:
        for eng in engines.values():
            eng.close()
