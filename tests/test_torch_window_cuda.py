"""The key window of K1, K2 and K3, and an AFMoE engine's decode step as
a CUDA graph replay, on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided
inside the fixture, never at import). On a GPU host run

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_window_cuda.py

Each windowed kernel (bf16 and fp32, float and int8 pages for K1 and
K2) against its plain version at windows that cut inside a block or
tile, on a block edge, wider than every row and of one position, over
ragged lengths, a split key walk and a prefix hit's, a chunk's and a
verify's shapes (tolerances as ``test_torch_kernels_cuda.py``'s: 1e-4
fp32, 2e-2 bf16, the order of the sums differing); a window wider than
every row gives the window-off output bit for bit (the window's code
path adds only masks that mask nothing); and an AFMoE engine (windowed
and global NoPE layers, dense and expert layers, the grouped matmul
K6) replaying its captured decode step gives the eager step's tokens
and fp32 logits bit for bit, with its expert tallies equal.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.compute import generate as t_gen
from kubeflow_tpu_torch.compute import quantize
from kubeflow_tpu_torch.compute.models import transformer as tt
from kubeflow_tpu_torch.compute.ops import flash_attention as flash_ops
from kubeflow_tpu_torch.compute.ops import paged_attention as paged_ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
WINDOWS = (1, 7, 16, 33, 64, 100)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pool(dtype, n_blocks, bs, kv, D, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((n_blocks, bs, kv, D), generator=g).to(
        "cuda", dtype) for _ in range(2))


def _int8(pages):
    (kq, ks), (vq, vs) = (quantize.kv_quantize(p) for p in pages)
    return kq, vq, ks, vs


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", WINDOWS)
def test_decode_window(dev, dtype, int8, window):
    kv, n_rep, D, bs, bps = 2, 8, 128, 16, 12
    lengths = [1, 5, 16, 17, 40, 64, 100, 150, 191, 0]
    S = len(lengths)
    pages = _pool(dtype, S * bps, bs, kv, D, 1)
    if int8:
        pages = _int8(pages)
    g = torch.Generator().manual_seed(2)
    q = torch.randn((S, 1, kv * n_rep, D), generator=g).to(dev, dtype)
    tables = torch.randperm(S * bps, generator=g).reshape(S, bps).to(
        dev, torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    want = paged_ops.paged_decode_reference(q, pages, tables, lens,
                                            block_size=bs, n_rep=n_rep,
                                            window=window)
    for split_heads in (None, 64):     # one split, and a split walk
        got = paged_ops.paged_decode_attention(
            q, pages, tables, lens, block_size=bs, n_rep=n_rep,
            window=window, split_heads=split_heads)
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("site", ["chunk", "hit", "verify"])
def test_chunk_window(dev, dtype, int8, window, site):
    kv, n_rep, D, bs, bps = 2, 8, 128, 16, 16
    B, S, plens = {"chunk": (1, 96, [130]), "hit": (1, 37, [64]),
                   "verify": (4, 5, [3, 48, 100, 200])}[site]
    pages = _pool(dtype, B * bps, bs, kv, D, 3)
    if int8:
        pages = _int8(pages)
    g = torch.Generator().manual_seed(4)
    q = torch.randn((B, S, kv * n_rep, D), generator=g).to(dev, dtype)
    kc = torch.randn((B, S, kv, D), generator=g).to(dev, dtype)
    vc = torch.randn((B, S, kv, D), generator=g).to(dev, dtype)
    tables = torch.randperm(B * bps, generator=g).reshape(B, bps).to(
        dev, torch.int32)
    plen = torch.tensor(plens, dtype=torch.int32, device=dev)
    want = paged_ops.paged_chunk_reference(q, pages, tables, plen, kc, vc,
                                           block_size=bs, n_rep=n_rep,
                                           window=window)
    got = paged_ops.paged_chunk_attention(q, pages, tables, plen, kc, vc,
                                          block_size=bs, n_rep=n_rep,
                                          window=window)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("S", [1, 63, 64, 65, 300])
def test_flash_window(dev, dtype, window, S):
    g = torch.Generator().manual_seed(5)
    q = torch.randn((2, S, 16, 128), generator=g).to(dev, dtype)
    k = torch.randn((2, S, 2, 128), generator=g).to(dev, dtype)
    v = torch.randn((2, S, 2, 128), generator=g).to(dev, dtype)
    want, want_lse = flash_ops.flash_attention_reference(q, k, v, True,
                                                         window=window)
    got, lse = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    _close(got, want, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


def test_wide_window_is_no_window_bit_for_bit(dev):
    """A window wider than every row walks from position 0 and masks
    nothing: its output is the window-off output to the bit."""
    dtype, kv, n_rep, D, bs, bps = torch.bfloat16, 4, 8, 128, 16, 32
    pages = _pool(dtype, 8 * bps, bs, kv, D, 6)
    g = torch.Generator().manual_seed(7)
    q = torch.randn((8, 1, kv * n_rep, D), generator=g).to(dev, dtype)
    tables = torch.randperm(8 * bps, generator=g).reshape(8, bps).to(
        dev, torch.int32)
    lens = torch.tensor([3, 90, 511, 512, 200, 17, 0, 64],
                        dtype=torch.int32, device=dev)
    wide = bps * bs + 1
    for int8 in (False, True):
        pg = _int8(pages) if int8 else pages
        a = paged_ops.paged_decode_attention(q, pg, tables, lens,
                                             block_size=bs, n_rep=n_rep)
        b = paged_ops.paged_decode_attention(q, pg, tables, lens,
                                             block_size=bs, n_rep=n_rep,
                                             window=wide)
        assert torch.equal(a, b)
        qc = torch.randn((2, 40, kv * n_rep, D), generator=g).to(dev, dtype)
        kc = torch.randn((2, 40, kv, D), generator=g).to(dev, dtype)
        plen = torch.tensor([100, 300], dtype=torch.int32, device=dev)
        a = paged_ops.paged_chunk_attention(qc, pg, tables[:2], plen, kc, kc,
                                            block_size=bs, n_rep=n_rep)
        b = paged_ops.paged_chunk_attention(qc, pg, tables[:2], plen, kc, kc,
                                            block_size=bs, n_rep=n_rep,
                                            window=wide)
        assert torch.equal(a, b)
    qf = torch.randn((1, 700, 32, 128), generator=g).to(dev, dtype)
    kf = torch.randn((1, 700, 4, 128), generator=g).to(dev, dtype)
    a = flash_ops.flash_attention(qf, kf, kf, causal=True)
    b = flash_ops.flash_attention(qf, kf, kf, causal=True, window=701)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


AFMOE = tt.PortConfig(
    vocab_size=512, d_model=256, n_layers=6, n_heads=8, n_kv_heads=1,
    d_head=64, d_ff=384, max_seq=512, dtype="bfloat16", attention="flash",
    remat=False, moe_experts=16, moe_top_k=4, moe_dropless=True,
    moe_gmm=True, norm_eps=1e-5, sliding_window=24, global_every=4,
    family="afmoe", moe_route_scale=2.826, moe_d_ff=64, moe_shared=1,
    moe_dense_layers=2)
MOE_KEYS = ("moe_calls", "moe_assignments_total", "moe_padded_rows_total",
            "moe_active_experts_total", "moe_decode_calls",
            "moe_decode_assignments_total",
            "moe_decode_active_experts_total")


def _serve(eng, reqs):
    with eng._cond:
        handles = [eng.submit(p, max_tokens=m) for p, m in reqs]
    out = [(h.result(timeout=600)[0], np.stack(h.logits)) for h in handles]
    torch.cuda.synchronize()
    return out


def test_afmoe_graph_replay_is_the_eager_step(dev):
    params = tt.init_params(AFMOE, torch.Generator().manual_seed(8),
                            device="cuda")
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, 512, int(rng.integers(5, 200))).tolist(),
             int(rng.integers(8, 40))) for _ in range(24)]
    got = {}
    for graph in (True, False):
        eng = t_gen.GenerationEngine(params, AFMOE, max_slots=8,
                                     block_size=16, max_context=256,
                                     prefix_cache=False, debug_logits=True,
                                     name="afmoe")
        eng._graphable = graph and eng._graphable
        got[graph] = (_serve(eng, reqs), {k: eng.stats[k] for k in
                                          MOE_KEYS + ("decode_steps",
                                                      "decode_graph_replays")})
        eng.close()
    (a, sa), (b, sb) = got[True], got[False]
    for (ta, la), (tb, lb) in zip(a, b):
        assert ta == tb
        np.testing.assert_array_equal(la, lb)
    assert sa["decode_graph_replays"] == sa["decode_steps"] - 1
    assert sb["decode_graph_replays"] == 0
    assert all(sa[k] == sb[k] for k in MOE_KEYS) and sa["moe_calls"] > 0
