"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided
inside the fixture, never at import). On a GPU host run

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which such a host
need not have). Covers what ``chip_smoke.py`` does not: every head_dim
template, GQA groups 1/2/4, block sizes that do not divide the kernel's
32-position tile, ragged and causal/full flash shapes, the launch
counters and the wrappers' refusals; K1-i8 and K2-i8 (int8 pages with
fp32 scales) over the same matrices and serving shapes, and the refusal
of malformed int8 quadruples; K1 and K1-i8's split key walk with the
split count forced (1, 2, 3, 17, 32 and 40 spans of a 32-tile table) x
the serving lengths, a lone 1024-token slot, all-zero lengths and 8 x
512 x fp32/bf16 x head_dim 128/64/32, the wrapper's own split count,
and five bf16 calls bit-identical; K1, K2 and their int8 entries
read by a head-partitioned shard (one KV head with its q heads) at
``split_heads`` = the whole pool's KV heads equal to the whole pool's
read of those heads bit for bit (the engine's tensor mesh); for K2 (the
chunk read) its three
serving shapes (a 256-row chunk behind a long prefix, a prefix hit's
suffix, an 8-slot verify with per-slot prefixes), prefix 0, one row
(S = 1) and a ragged last row tile, its matrix over GQA groups
1/2/3/4/8/16 and block sizes 1/8/12/16, and the bf16 K2 and K2-i8
(``mma.sync``, the key walk split over blocks, splits with no key
included) bit-identical on two calls; for K4 and K5 (the flash backward) every head_dim
template, GQA groups 1/2/4, ragged, causal and full shapes and the
train step's shape, each against the plain backward (K4 over GQA
groups 1/2/4/8, S in {1, 53, 63, 64, 65, 77, 100, 300, 1000}, causal,
full and full with Sk != S), plus the
autograd path (K3 forward, K4 + K5 backward, their launch counts)
against autograd through the plain dense attention; for K6 and K7 (the
grouped matmul of dropless MoE and its weight gradient) ragged k and n
(not multiples of the tiles, and not of the 16-byte copy width), weights
read transposed (the backward's dx), uniform routing, all rows on one
expert, an empty expert, a skewed routing and (K6) padding tiles that
name expert -1, K6 also at ragged widths past one tile (1000 x 1000,
72 x 136) and at the MoE step's four sites' widths, K7 also at the MoE
step's dw gate|up widths, ``block_m`` 64 and 128, the launch counters,
the autograd path (K6 forward, K6 + K7 backward) and the refusal of a
``block_m`` the kernels do not take; K3-K5 at the BERT step's shape
(16 x 512, 12 heads of 64, no causal mask); for K8 (the fused identity
bottleneck of ResNet's eval forward) the four ResNet-50 stage shapes at
a small batch, planes narrower than a 16-row fragment and odd ones,
widths with C other than 4 M, every band height from one row to the
whole image (the halo rows, the last ragged band) at widths whose bf16
steps are 64 and 32 deep, the bf16 kernel bit-identical across five
calls, randomised BN, the
unfused ``resnet._block`` as a second reference, the launch counter and
the refusals; for the bf16 K3, K4 and K5, which run on the tensor cores
(``mma.sync``) while fp32 stays on the CUDA cores, head_dim 32/64/128 x
GQA groups 1/2/4/8 x causal, full and full with Sk != S x S in {1, 7,
63, 64, 65, 300, 1000} (one tile, ragged tiles on either side of the
64-row tile), the train, MoE and BERT step shapes, K4 and K5
bit-identical on two calls, and the bf16 autograd path (one launch each
of K3, K4, K5) against the plain backward; the bf16 K6 and K7
(``wgmma``) bit-identical on two calls at the gate|up, dx and dw gate|up
widths under a skewed routing. Tolerances: fp32
1e-4, bf16 2e-2 (the kernels sum in another order than the plain
versions; bf16 outputs may round one unit apart); the backward's
relative to the plain gradient's max |value|, with an absolute floor
of the same size where the gradient itself is rounding noise (S = 1).
"""

import pytest
import torch

from kubeflow_tpu_torch.compute import quantize
from kubeflow_tpu_torch.compute.models import resnet
from kubeflow_tpu_torch.compute.ops import flash_attention as flash_ops
from kubeflow_tpu_torch.compute.ops import fused_block as block_ops
from kubeflow_tpu_torch.compute.ops import grouped_matmul as gmm_ops
from kubeflow_tpu_torch.compute.ops import paged_attention as paged_ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("bs", [8, 16, 12])
def test_paged_decode_matches_plain(dev, dtype, D, n_rep, bs):
    g = torch.Generator().manual_seed(D * 10 + n_rep)
    S, kv, bps, N = 5, 2, 6, 40
    kc = torch.randn((N, bs, kv, D), generator=g).to(dev, dtype)
    vc = torch.randn((N, bs, kv, D), generator=g).to(dev, dtype)
    q = torch.randn((S, 1, kv * n_rep, D), generator=g).to(dev, dtype)
    tables = torch.randint(0, N, (S, bps), generator=g).to(
        dev, torch.int32)
    lengths = torch.tensor([0, 1, bs, 33, bps * bs], dtype=torch.int32,
                           device=dev)
    kw = dict(block_size=bs, n_rep=n_rep)
    before = paged_ops.paged_decode_attention.launches
    got = paged_ops.paged_decode_attention(q, (kc, vc), tables, lengths,
                                           **kw)
    want = paged_ops.paged_decode_reference(q, (kc, vc), tables, lengths,
                                            **kw)
    torch.cuda.synchronize()
    assert paged_ops.paged_decode_attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("S,causal", [(1, True), (5, True), (64, True),
                                      (100, True), (77, False)])
def test_flash_fwd_matches_plain(dev, dtype, D, n_rep, S, causal):
    g = torch.Generator().manual_seed(S * 7 + D)
    B, kv = 2, 2
    q = torch.randn((B, S, kv * n_rep, D), generator=g).to(dev, dtype)
    k = torch.randn((B, S, kv, D), generator=g).to(dev, dtype)
    v = torch.randn((B, S, kv, D), generator=g).to(dev, dtype)
    before = flash_ops.flash_attention.launches
    out, lse = flash_ops.flash_attention(q, k, v, causal=causal)
    want, want_lse = flash_ops.flash_attention_reference(q, k, v,
                                                         causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


def _chunk_case(dev, dtype, B, S, prefix, n_rep=4, D=128, bs=16, bps=64,
                kv=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    N = B * bps
    kc = torch.randn((N, bs, kv, D), generator=g).to(dev, dtype)
    vc = torch.randn((N, bs, kv, D), generator=g).to(dev, dtype)
    q = torch.randn((B, S, kv * n_rep, D), generator=g).to(dev, dtype)
    kch = torch.randn((B, S, kv, D), generator=g).to(dev, dtype)
    vch = torch.randn((B, S, kv, D), generator=g).to(dev, dtype)
    tables = torch.randperm(N, generator=g).reshape(B, bps).to(
        dev, torch.int32)
    if not isinstance(prefix, int):
        prefix = torch.tensor(prefix, dtype=torch.int32, device=dev)
    return q, (kc, vc), tables, prefix, kch, vch


VERIFY_PREFIX = [0, 1, 17, 100, 333, 512, 777, 1019]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,prefix", [
    (1, 256, 768),            # a chunk behind a long prefix
    (1, 256, 0),              # a chunked prefill's first chunk
    (1, 40, 512),             # a prefix hit's suffix
    (1, 13, 32),              # a ragged last row tile
    (1, 1, 100),              # one row behind a prefix
    (1, 1, 0),                # one row, no prefix
    (8, 5, VERIFY_PREFIX)])   # the verify, per-slot prefixes
def test_paged_chunk_matches_plain(dev, dtype, B, S, prefix):
    q, pages, tables, plen, kch, vch = _chunk_case(dev, dtype, B, S, prefix)
    kw = dict(block_size=16, n_rep=4)
    before = paged_ops.paged_chunk_attention.launches
    got = paged_ops.paged_chunk_attention(q, pages, tables, plen, kch, vch,
                                          **kw)
    want = paged_ops.paged_chunk_reference(q, pages, tables, plen, kch, vch,
                                           **kw)
    torch.cuda.synchronize()
    assert paged_ops.paged_chunk_attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


def _matrix_table(bs):
    """Blocks a slot and per-slot prefixes of the matrix tests: no
    prefix, one that ends inside a block, one that ends 3 positions
    into the table's last block (the whole table for bs 1)."""
    bps = 6 if bs > 1 else 100
    return bps, [0, 9, (bps - 1) * bs + 3 % bs]


CHUNK_REPS = [1, 2, 4, 3, 8, 16]
CHUNK_BLOCKS = [8, 12, 1, 16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("n_rep", CHUNK_REPS)
@pytest.mark.parametrize("bs", CHUNK_BLOCKS)
def test_paged_chunk_matrix(dev, dtype, D, n_rep, bs):
    """Every head_dim template, GQA groups that do and do not divide the
    64-row tile, block sizes that do not divide the key tiles (one
    position a block too); in bf16 the split walk's slot with no prefix
    has splits with no key."""
    bps, prefix = _matrix_table(bs)
    q, pages, tables, plen, kch, vch = _chunk_case(
        dev, dtype, 3, 23, prefix, n_rep=n_rep, D=D, bs=bs, bps=bps,
        seed=D + n_rep)
    kw = dict(block_size=bs, n_rep=n_rep)
    got = paged_ops.paged_chunk_attention(q, pages, tables, plen, kch, vch,
                                          **kw)
    want = paged_ops.paged_chunk_reference(q, pages, tables, plen, kch, vch,
                                           **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


def _quantized(pages):
    """A float ``(k, v)`` pool → its int8 quadruple (kv_quantize)."""
    (kq, ks), (vq, vs) = (quantize.kv_quantize(p) for p in pages)
    return kq, vq, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("bs", [8, 16, 12])
def test_paged_decode_i8_matches_plain(dev, dtype, D, n_rep, bs):
    """K1-i8: int8 pages (16 codes a load; D 32 leaves half the threads
    of a tile without a word) with their fp32 scales, widened with the
    TPU kernel's rounding, against the plain version."""
    g = torch.Generator().manual_seed(D * 10 + n_rep + 1)
    S, kv, bps, N = 5, 2, 6, 40
    kc, vc = (torch.randn((N, bs, kv, D), generator=g).to(dev, dtype)
              for _ in range(2))
    pages = _quantized((kc, vc))
    q = torch.randn((S, 1, kv * n_rep, D), generator=g).to(dev, dtype)
    tables = torch.randint(0, N, (S, bps), generator=g).to(dev, torch.int32)
    lengths = torch.tensor([0, 1, bs, 33, bps * bs], dtype=torch.int32,
                           device=dev)
    kw = dict(block_size=bs, n_rep=n_rep)
    fn = paged_ops.paged_decode_attention
    before = (fn.launches, fn.launches_i8)
    got = fn(q, pages, tables, lengths, **kw)
    want = paged_ops.paged_decode_reference(q, pages, tables, lengths, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_i8) == (before[0], before[1] + 1)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,prefix", [
    (1, 256, 768), (1, 256, 0), (1, 40, 512), (1, 13, 32), (1, 1, 100),
    (1, 1, 0), (8, 5, VERIFY_PREFIX)])
def test_paged_chunk_i8_matches_plain(dev, dtype, B, S, prefix):
    """K2-i8 at the serving shapes: int8 prefix pages, the chunk's own
    K/V in q's dtype (a tile that straddles the prefix's end holds
    both)."""
    q, pages, tables, plen, kch, vch = _chunk_case(dev, dtype, B, S, prefix,
                                                   seed=1)
    pages = _quantized(pages)
    kw = dict(block_size=16, n_rep=4)
    fn = paged_ops.paged_chunk_attention
    before = (fn.launches, fn.launches_i8)
    got = fn(q, pages, tables, plen, kch, vch, **kw)
    want = paged_ops.paged_chunk_reference(q, pages, tables, plen, kch, vch,
                                           **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_i8) == (before[0], before[1] + 1)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("n_rep", CHUNK_REPS)
@pytest.mark.parametrize("bs", CHUNK_BLOCKS)
def test_paged_chunk_i8_matrix(dev, dtype, D, n_rep, bs):
    bps, prefix = _matrix_table(bs)
    q, pages, tables, plen, kch, vch = _chunk_case(
        dev, dtype, 3, 23, prefix, n_rep=n_rep, D=D, bs=bs, bps=bps,
        seed=D + n_rep + 1)
    pages = _quantized(pages)
    kw = dict(block_size=bs, n_rep=n_rep)
    got = paged_ops.paged_chunk_attention(q, pages, tables, plen, kch, vch,
                                          **kw)
    want = paged_ops.paged_chunk_reference(q, pages, tables, plen, kch, vch,
                                           **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B,S,prefix", [(1, 256, 768), (8, 5, VERIFY_PREFIX)])
def test_paged_chunk_bf16_is_deterministic(dev, int8, B, S, prefix):
    """The bf16 K2 at a split walk (the combine reads the splits in
    order, never in the order the blocks finished): two calls give the
    same bits."""
    q, pages, tables, plen, kch, vch = _chunk_case(dev, torch.bfloat16, B,
                                                   S, prefix, seed=2)
    assert paged_ops.chunk_splits(B, S, 2, 4, 16, 64, torch.cuda.
                                  get_device_properties(dev).
                                  multi_processor_count) > 1
    if int8:
        pages = _quantized(pages)
    kw = dict(block_size=16, n_rep=4)
    first = paged_ops.paged_chunk_attention(q, pages, tables, plen, kch,
                                            vch, **kw)
    second = paged_ops.paged_chunk_attention(q, pages, tables, plen, kch,
                                             vch, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# K1's lengths: the serving shape's ragged slots, a lone 1024-token slot
# (the longest walk alone), every slot empty, and the engine's decode
# step at 8 x 512
DECODE_LENGTHS = {"serving": [0, 1, 17, 100, 333, 512, 777, 1024],
                  "lone_1024": [1024], "all_zero": [0] * 8,
                  "all_512": [512] * 8}


def _decode_case(dev, dtype, lengths, int8=False, n_rep=4, D=128, kv=2,
                 bs=16, bps=64, seed=3):
    g = torch.Generator().manual_seed(seed)
    S = len(lengths)
    N = S * bps
    kc, vc = (torch.randn((N, bs, kv, D), generator=g).to(dev, dtype)
              for _ in range(2))
    q = torch.randn((S, 1, kv * n_rep, D), generator=g).to(dev, dtype)
    tables = torch.randperm(N, generator=g).reshape(S, bps).to(
        dev, torch.int32)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    pages = _quantized((kc, vc)) if int8 else (kc, vc)
    return q, pages, tables, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("lengths", sorted(DECODE_LENGTHS))
@pytest.mark.parametrize("splits", [1, 2, 3, 17, 32, 40])
@pytest.mark.parametrize("D,n_rep", [(128, 4), (64, 16), (32, 1)])
def test_paged_decode_split_matrix(dev, monkeypatch, dtype, int8, lengths,
                                   splits, D, n_rep):
    """K1 and K1-i8 with the key walk forced into ``splits`` spans of the
    table's 32 tiles: one split (the output written directly), spans of
    many tiles (longer than the ring), of one tile (32), and more splits
    than tiles (40: empty spans); splits wholly past a slot's length
    write the empty partial. One wrapper call, one launch."""
    monkeypatch.setattr(paged_ops, "decode_splits", lambda *a: splits)
    q, pages, tables, lens = _decode_case(dev, dtype, DECODE_LENGTHS[lengths],
                                          int8, n_rep=n_rep, D=D)
    fn = paged_ops.paged_decode_attention
    before = (fn.launches, fn.launches_i8)
    kw = dict(block_size=16, n_rep=n_rep)
    got = fn(q, pages, tables, lens, **kw)
    want = paged_ops.paged_decode_reference(q, pages, tables, lens, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_i8) == (
        (before[0], before[1] + 1) if int8 else (before[0] + 1, before[1]))
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    if lengths == "all_zero":
        assert not got.float().abs().max()


def test_paged_decode_splits_at_the_serving_shape(dev):
    """The wrapper's own split count: more than one at the serving
    shape and for a lone slot (one split a tile at most), one where 512
    blocks already fill the card."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    serving = paged_ops.decode_splits(8, 2, 16, 64, sms)
    assert 1 < serving <= 32 and 16 * serving >= sms
    assert paged_ops.decode_splits(1, 2, 16, 64, sms) == min(32, sms)
    assert paged_ops.decode_splits(64, 8, 16, 64, sms) == 1


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("lengths", ["serving", "lone_1024", "all_512"])
def test_paged_decode_bf16_is_deterministic(dev, int8, lengths):
    """K1 and K1-i8 at the wrapper's split walk (the combine reads the
    splits in order, never in the order the blocks finished): five calls
    give the same bits."""
    q, pages, tables, lens = _decode_case(dev, torch.bfloat16,
                                          DECODE_LENGTHS[lengths], int8,
                                          seed=4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert paged_ops.decode_splits(q.shape[0], 2, 16, 64, sms) > 1
    kw = dict(block_size=16, n_rep=4)
    outs = [paged_ops.paged_decode_attention(q, pages, tables, lens, **kw)
            for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("read", ["decode", "chunk", "hit"])
def test_a_head_shard_at_split_heads_reads_as_the_whole_pool(dev, dtype,
                                                             int8, read):
    """The engine's tensor mesh: a shard holding KV head h (and its q
    heads) reads, with ``split_heads`` the whole pool's KV-head count,
    exactly the whole pool's read of those heads — the split count is
    the unsharded engine's, and every (split, head, slot) block and the
    ordered combine are per-head."""
    n_rep, kv = 4, 2
    if read == "decode":
        q, pages, tables, lens = _decode_case(
            dev, dtype, DECODE_LENGTHS["serving"], int8, seed=5)
        fn, extra = paged_ops.paged_decode_attention, ()
    else:
        B, S, prefix = (1, 256, 768) if read == "chunk" else (1, 40, 512)
        q, pages, tables, lens, kch, vch = _chunk_case(dev, dtype, B, S,
                                                       prefix, seed=6)
        if int8:
            pages = _quantized(pages)
        fn, extra = paged_ops.paged_chunk_attention, (kch, vch)
    kw = dict(block_size=16, n_rep=n_rep)
    whole = fn(q, pages, tables, lens, *extra, **kw)
    for h in range(kv):
        heads = slice(h * n_rep, (h + 1) * n_rep)
        part = fn(q[:, :, heads].contiguous(),
                  tuple(p[:, :, h:h + 1].contiguous() for p in pages),
                  tables, lens,
                  *(t[:, :, h:h + 1].contiguous() for t in extra),
                  split_heads=kv, **kw)
        torch.cuda.synchronize()
        assert torch.equal(part, whole[:, :, heads]), (read, h)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 4, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 2, 64), device=dev)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_ops.flash_attention(q, q[:, :2], q[:, :2], causal=True)
    pages = torch.zeros((4, 8, 1, 64), device=dev)
    with pytest.raises(ValueError, match="pair or"):
        paged_ops.paged_decode_attention(
            torch.zeros((1, 1, 2, 64), device=dev), (pages,) * 3,
            torch.zeros((1, 2), dtype=torch.int32, device=dev),
            torch.ones((1,), dtype=torch.int32, device=dev),
            block_size=8, n_rep=2)


def _malformed_int8_pools(dev):
    """(what is wrong, the quadruple) for one [4, 8, 1, 64] pool."""
    codes = torch.zeros((4, 8, 1, 64), dtype=torch.int8, device=dev)
    scales = torch.ones((4, 8, 1, 1), device=dev)
    return [
        ("scale shape", ValueError, "scales must be",
         (codes, codes, scales[..., 0], scales)),
        ("scale per element", ValueError, "scales must be",
         (codes, codes, scales.expand(4, 8, 1, 64).contiguous(), scales)),
        ("bf16 scales", TypeError, "float32",
         (codes, codes, scales, scales.bfloat16())),
        ("float k, int8 v", TypeError, "int8",
         (codes.float(), codes, scales, scales)),
        ("int8 pair", TypeError, "dtype", (codes, codes)),
        ("float pair with scales", TypeError, "int8",
         (codes.float(), codes.float(), scales, scales)),
        ("strided scales", ValueError, "contiguous",
         (codes, codes, torch.ones((4, 8, 2, 1), device=dev)[:, :, :1],
          scales))]


@pytest.mark.parametrize("case", range(7))
def test_int8_wrappers_refuse_malformed_quadruples(dev, case):
    """A malformed int8 pool raises on the card and launches nothing,
    through both reads."""
    what, exc, match, pages = _malformed_int8_pools(dev)[case]
    tables = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    before = [(fn.launches, fn.launches_i8) for fn in (
        paged_ops.paged_decode_attention, paged_ops.paged_chunk_attention)]
    with pytest.raises(exc, match=match):
        paged_ops.paged_decode_attention(
            torch.zeros((1, 1, 2, 64), device=dev), pages, tables,
            torch.ones((1,), dtype=torch.int32, device=dev),
            block_size=8, n_rep=2)
    with pytest.raises(exc, match=match):
        paged_ops.paged_chunk_attention(
            torch.zeros((1, 3, 2, 64), device=dev), pages, tables, 0,
            torch.zeros((1, 3, 1, 64), device=dev),
            torch.zeros((1, 3, 1, 64), device=dev), block_size=8, n_rep=2)
    assert [(fn.launches, fn.launches_i8) for fn in (
        paged_ops.paged_decode_attention,
        paged_ops.paged_chunk_attention)] == before, what


def _bwd_case(dev, dtype, B, S, H, kv, D, causal, seed, Sk=None):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((B, S, H, D), generator=g).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn((B, S if Sk is None else Sk, kv, D),
                        generator=g).to(dev, dtype) for _ in range(2))
    out, lse = flash_ops.flash_attention(q, k, v, causal=causal)
    return q, k, v, do, lse, flash_ops.attention_delta(out, do)


def _assert_rel(got, want, tol):
    scale = max(float(want.float().abs().max()), 1.0)
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


# (S, mask): one tile, ragged tiles on either side of the 64-row tile,
# long walks; "full_sk" is the full mask with Sk != S
BWD_CASES = [(1, "causal"), (77, "causal"), (64, "causal"), (100, "full"),
             (53, "full")] + [(S, mask) for S in (63, 65, 300, 1000)
                              for mask in ("causal", "full", "full_sk")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("S,mask", BWD_CASES)
def test_flash_bwd_matches_plain(dev, dtype, D, n_rep, S, mask):
    kv = 2
    causal = mask == "causal"
    q, k, v, do, lse, delta = _bwd_case(dev, dtype, 2, S, kv * n_rep, kv,
                                        D, causal, S * 3 + D + n_rep,
                                        _seq_k(S, mask))
    n_dq = flash_ops.flash_attention_bwd_dq.launches
    n_dkv = flash_ops.flash_attention_bwd_dkv.launches
    dq = flash_ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               causal)
    want = flash_ops._bwd_reference(q, k, v, do, lse, delta, causal, None)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention_bwd_dq.launches == n_dq + 1
    assert flash_ops.flash_attention_bwd_dkv.launches == n_dkv + 1
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and torch.isfinite(got.float()).all()
        _assert_rel(got, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_at_the_train_shape(dev, dtype):
    q, k, v, do, lse, delta = _bwd_case(dev, dtype, 16, 1024, 8, 2, 128,
                                        True, 0)
    dq = flash_ops.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    want = flash_ops._bwd_reference(q, k, v, do, lse, delta, True, None)
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        _assert_rel(got, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_the_bert_shape(dev, dtype):
    """K3, K4 and K5 without a causal mask at head_dim 64: bert-base's
    16 x 512 step."""
    q, k, v, do, lse, delta = _bwd_case(dev, dtype, 16, 512, 12, 12, 64,
                                        False, 5)
    out, got_lse = flash_ops.flash_attention(q, k, v, causal=False)
    want_out, want_lse = flash_ops.flash_attention_reference(q, k, v,
                                                             causal=False)
    dq = flash_ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, False)
    dk, dv = flash_ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               False)
    want = flash_ops._bwd_reference(q, k, v, do, lse, delta, False, None)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want_out.float(),
                               atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(got_lse, want_lse, atol=1e-4, rtol=1e-5)
    for got, ref in zip((dq, dk, dv), want):
        _assert_rel(got, ref, TOL[dtype])


def test_flash_autograd_launches_k3_k4_k5(dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    from kubeflow_tpu_torch.compute import attention as attn
    g = torch.Generator().manual_seed(9)
    q = torch.randn((2, 96, 8, 64), generator=g).to(dev)
    k, v = (torch.randn((2, 96, 2, 64), generator=g).to(dev)
            for _ in range(2))
    do = torch.randn((2, 96, 8, 64), generator=g).to(dev)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = [fn.launches for fn in (flash_ops.flash_attention,
                                     flash_ops.flash_attention_bwd_dq,
                                     flash_ops.flash_attention_bwd_dkv)]
    flash_ops.flash_attention(*a, causal=True)[0].backward(do)
    attn.dense_attention(b[0], attn.repeat_kv(b[1], 4),
                         attn.repeat_kv(b[2], 4)).backward(do)
    torch.cuda.synchronize()
    assert [fn.launches for fn in (flash_ops.flash_attention,
                                   flash_ops.flash_attention_bwd_dq,
                                   flash_ops.flash_attention_bwd_dkv)] == [
        c + 1 for c in counts]
    for x, y in zip(a, b):
        _assert_rel(x.grad, y.grad, 1e-4)


BF16_SEQS = (1, 7, 63, 64, 65, 300, 1000)


def _attn_case(dev, B, S, Sk, H, kv, D, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((B, S, H, D), generator=g).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, kv, D), generator=g).to(dev, dtype)
            for _ in range(2))
    return q, k, v, do


def _seq_k(S, mask):
    """Sk for a mask case: S, or (``full_sk``) another length."""
    return S * 2 // 3 + 9 if mask == "full_sk" else S


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("mask", ["causal", "full", "full_sk"])
@pytest.mark.parametrize("S", BF16_SEQS)
def test_flash_fwd_bf16_tensor_cores_match_plain(dev, D, n_rep, mask, S):
    causal = mask == "causal"
    q, k, v, _ = _attn_case(dev, 2, S, _seq_k(S, mask), 2 * n_rep, 2, D,
                            S * 5 + D + n_rep)
    before = flash_ops.flash_attention.launches
    out, lse = flash_ops.flash_attention(q, k, v, causal=causal)
    want, want_lse = flash_ops.flash_attention_reference(q, k, v,
                                                         causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), want.float(),
                               atol=TOL[torch.bfloat16], rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("mask", ["causal", "full", "full_sk"])
@pytest.mark.parametrize("S", BF16_SEQS)
def test_flash_dkv_bf16_tensor_cores_match_plain(dev, D, n_rep, mask, S):
    causal = mask == "causal"
    q, k, v, do = _attn_case(dev, 2, S, _seq_k(S, mask), 2 * n_rep, 2, D,
                             S * 3 + D + n_rep)
    out, lse = flash_ops.flash_attention_reference(q, k, v, causal=causal)
    delta = flash_ops.attention_delta(out, do)
    before = flash_ops.flash_attention_bwd_dkv.launches
    dk, dv = flash_ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               causal)
    _, want_dk, want_dv = flash_ops._bwd_reference(q, k, v, do, lse, delta,
                                                   causal, None)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention_bwd_dkv.launches == before + 1
    for got, ref in ((dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        _assert_rel(got, ref, TOL[torch.bfloat16])


STEP_ATTN = {"train": (16, 1024, 8, 2, 128, True),
             "moe": (8, 1024, 8, 8, 128, True),
             "bert": (16, 512, 12, 12, 64, False)}


@pytest.mark.parametrize("step", sorted(STEP_ATTN))
def test_flash_bf16_tensor_cores_at_the_step_shapes(dev, step):
    """K3, K4 and K5 in bf16 at the train, MoE and BERT steps' shapes."""
    B, S, H, kv, D, causal = STEP_ATTN[step]
    q, k, v, do = _attn_case(dev, B, S, S, H, kv, D, 21)
    out, lse = flash_ops.flash_attention(q, k, v, causal=causal)
    want, want_lse = flash_ops.flash_attention_reference(q, k, v,
                                                         causal=causal)
    delta = flash_ops.attention_delta(want, do)
    dq = flash_ops.flash_attention_bwd_dq(q, k, v, do, want_lse, delta,
                                          causal)
    dk, dv = flash_ops.flash_attention_bwd_dkv(q, k, v, do, want_lse, delta,
                                               causal)
    want_dq, want_dk, want_dv = flash_ops._bwd_reference(
        q, k, v, do, want_lse, delta, causal, None)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(),
                               atol=TOL[torch.bfloat16], rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    _assert_rel(dq, want_dq, TOL[torch.bfloat16])
    _assert_rel(dk, want_dk, TOL[torch.bfloat16])
    _assert_rel(dv, want_dv, TOL[torch.bfloat16])


def test_flash_dkv_bf16_is_deterministic(dev):
    """No atomics: two calls give the same bits."""
    q, k, v, do = _attn_case(dev, 16, 1024, 1024, 8, 2, 128, 4)
    out, lse = flash_ops.flash_attention(q, k, v)
    delta = flash_ops.attention_delta(out, do)
    first = flash_ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    second = flash_ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_dq_bf16_is_deterministic(dev):
    """K4 in bf16: no atomics, two calls give the same bits."""
    q, k, v, do = _attn_case(dev, 16, 1024, 1024, 8, 2, 128, 6)
    out, lse = flash_ops.flash_attention(q, k, v)
    delta = flash_ops.attention_delta(out, do)
    first = flash_ops.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    second = flash_ops.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_flash_autograd_bf16_launches_k3_k4_k5(dev):
    """The bf16 autograd path: one launch each of K3, K4 and K5 (all on
    the tensor cores), gradients as the plain backward's."""
    q, k, v, do = _attn_case(dev, 2, 200, 200, 8, 2, 128, 13)
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = [fn.launches for fn in (flash_ops.flash_attention,
                                     flash_ops.flash_attention_bwd_dq,
                                     flash_ops.flash_attention_bwd_dkv)]
    out, lse = flash_ops.flash_attention(*x, causal=True)
    out.backward(do)
    want = flash_ops.flash_attention_bwd_reference(
        q, k, v, out.detach(), lse, do, causal=True)
    torch.cuda.synchronize()
    assert [fn.launches for fn in (flash_ops.flash_attention,
                                   flash_ops.flash_attention_bwd_dq,
                                   flash_ops.flash_attention_bwd_dkv)] == [
        c + 1 for c in counts]
    for t, ref in zip(x, want):
        assert t.grad.dtype == torch.bfloat16
        _assert_rel(t.grad, ref, TOL[torch.bfloat16])


def test_flash_bwd_refuses_what_the_kernels_do_not_take(dev):
    q, k, v, do, lse, delta = _bwd_case(dev, torch.float32, 1, 8, 4, 2,
                                        64, True, 1)
    with pytest.raises(ValueError, match="lse/delta"):
        flash_ops.flash_attention_bwd_dq(q, k, v, do, lse[:, :, :4], delta)
    with pytest.raises(ValueError, match="output gradient"):
        flash_ops.flash_attention_bwd_dkv(q, k, v, do.bfloat16(), lse,
                                          delta)



def _gmm_layout(dev, rows, e, block_m, routing, seed=0):
    g = torch.Generator().manual_seed(seed)
    if routing == "one_expert":
        key = torch.full((rows,), e - 1, dtype=torch.int32)
    elif routing == "skewed":              # expert 0 gets most rows
        key = torch.randint(0, e, (rows,), generator=g, dtype=torch.int32)
        key = torch.where(torch.rand((rows,), generator=g) < 0.8, 0, key)
    elif routing == "empty_expert":        # expert 1 gets no row
        key = torch.randint(0, e - 1, (rows,), generator=g, dtype=torch.int32)
        key = torch.where(key >= 1, key + 1, key)
    else:
        key = torch.randint(0, e, (rows,), generator=g, dtype=torch.int32)
    return gmm_ops.padded_group_layout(key.to(dev), e, block_m)


GMM_WIDTHS = [(128, 256), (100, 72), (33, 130)]   # k, n; ragged ones too
# K6 also: ragged widths past one 256-column tile and one 64-deep step,
# and the MoE flagship's four sites (gate|up, down, dx gate|up, dx down)
GMM_FWD_WIDTHS = GMM_WIDTHS + [(1000, 1000), (72, 136), (1024, 5632),
                               (2816, 1024), (5632, 1024), (1024, 2816)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_m", [64, 128])
@pytest.mark.parametrize("routing", ["uniform", "one_expert",
                                     "empty_expert", "skewed", "padding"])
@pytest.mark.parametrize("k,n", GMM_FWD_WIDTHS)
@pytest.mark.parametrize("trans", [False, True])
def test_grouped_matmul_matches_plain(dev, dtype, block_m, routing, k, n,
                                      trans):
    """``padding``: the last two tiles name expert -1, as padding tiles
    out of every expert's range, and their rows come out 0."""
    e = 4
    _, be, _, _, m_pad = _gmm_layout(
        dev, 300, e, block_m, "uniform" if routing == "padding" else routing,
        k + n)
    g = torch.Generator().manual_seed(k * n)
    x = torch.randn((m_pad, k), generator=g).to(dev, dtype)
    if trans:     # the backward's dx: w^T read through its strides
        w = torch.randn((e, n, k), generator=g).to(dev, dtype).transpose(1, 2)
    else:
        w = torch.randn((e, k, n), generator=g).to(dev, dtype)
    if routing == "padding":
        be = be.clone()
        be[-2:] = -1
    before = gmm_ops.grouped_matmul.launches
    got = gmm_ops.grouped_matmul(x, w, be, block_m)
    want = gmm_ops.grouped_matmul_reference(x, w, be.clamp(min=0), block_m)
    if routing == "padding":
        want[-2 * block_m:] = 0
    torch.cuda.synchronize()
    assert gmm_ops.grouped_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m_pad, n)
    assert torch.isfinite(got.float()).all()
    _assert_rel(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_m", [64, 128])
@pytest.mark.parametrize("routing", ["uniform", "one_expert",
                                     "empty_expert", "skewed"])
@pytest.mark.parametrize("k,n", GMM_WIDTHS + [(1024, 5632)])  # + gate|up
def test_grouped_matmul_dw_matches_plain(dev, dtype, block_m, routing, k,
                                         n):
    e = 4
    _, be, fst, lst, m_pad = _gmm_layout(dev, 300, e, block_m, routing,
                                         k * 3 + n)
    g = torch.Generator().manual_seed(k + 7 * n)
    # every row nonzero, padding and trailing tiles too: the kernel must
    # stay inside each expert's first..last tiles, as the plain version
    x = torch.randn((m_pad, k), generator=g).to(dev, dtype)
    dy = torch.randn((m_pad, n), generator=g).to(dev, dtype)
    before = gmm_ops.grouped_matmul_dw.launches
    got = gmm_ops.grouped_matmul_dw(x, dy, be, fst, lst, e, block_m)
    want = gmm_ops.grouped_matmul_dw_reference(x, dy, be, fst, lst, e,
                                               block_m)
    torch.cuda.synchronize()
    assert gmm_ops.grouped_matmul_dw.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (e, k, n)
    _assert_rel(got, want, TOL[dtype])
    if routing == "empty_expert":
        ranges = gmm_ops.expert_tiles(be, fst, lst, e)
        assert int(ranges[1, 1] - ranges[1, 0]) == 1   # its one padding tile
        x[ranges[1, 0] * block_m:ranges[1, 1] * block_m] = 0
        dw = gmm_ops.grouped_matmul_dw(x, dy, be, fst, lst, e, block_m)
        assert float(dw[1].abs().max()) == 0.0


def test_gmm_dw_bf16_is_deterministic(dev):
    """K7 in bf16 at the MoE step's dw gate|up widths under a skewed
    routing: no atomics, two calls give the same bits."""
    _, be, fst, lst, m_pad = _gmm_layout(dev, 2048, 8, 256, "skewed", 5)
    g = torch.Generator().manual_seed(8)
    x = torch.randn((m_pad, 1024), generator=g).to(dev, torch.bfloat16)
    dy = torch.randn((m_pad, 5632), generator=g).to(dev, torch.bfloat16)
    first = gmm_ops.grouped_matmul_dw(x, dy, be, fst, lst, 8, 256)
    second = gmm_ops.grouped_matmul_dw(x, dy, be, fst, lst, 8, 256)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("trans", [False, True])
def test_gmm_bf16_is_deterministic(dev, trans):
    """K6 in bf16 (wgmma) at the MoE step's gate|up widths (its dx
    widths with w read transposed) under a skewed routing: two calls
    give the same bits."""
    _, be, _, _, m_pad = _gmm_layout(dev, 2048, 8, 128, "skewed", 6)
    g = torch.Generator().manual_seed(9)
    k, n = (5632, 1024) if trans else (1024, 5632)
    x = torch.randn((m_pad, k), generator=g).to(dev, torch.bfloat16)
    if trans:
        w = torch.randn((8, n, k), generator=g).to(
            dev, torch.bfloat16).transpose(1, 2)
    else:
        w = torch.randn((8, k, n), generator=g).to(dev, torch.bfloat16)
    first = gmm_ops.grouped_matmul(x, w, be, 128)
    second = gmm_ops.grouped_matmul(x, w, be, 128)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_autograd_launches_k6_and_k7(dev, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    e, k, n, bm = 4, 96, 160, 64
    pos, be, fst, lst, m_pad = _gmm_layout(dev, 500, e, bm, "uniform")
    g = torch.Generator().manual_seed(3)
    x = torch.randn((m_pad, k), generator=g).to(dev, dtype).requires_grad_()
    w = torch.randn((e, k, n), generator=g).to(dev, dtype).requires_grad_()
    dout = torch.randn((m_pad, n), generator=g).to(dev, dtype)
    counts = (gmm_ops.grouped_matmul.launches,
              gmm_ops.grouped_matmul_dw.launches)
    gmm_ops.gmm(x, w, be, fst, lst, bm).backward(dout)
    torch.cuda.synchronize()
    assert (gmm_ops.grouped_matmul.launches,
            gmm_ops.grouped_matmul_dw.launches) == (counts[0] + 2,
                                                    counts[1] + 1)
    want_dx = gmm_ops.grouped_matmul_reference(dout, w.detach().transpose(
        1, 2), be, bm)
    want_dw = gmm_ops.grouped_matmul_dw_reference(x.detach(), dout, be, fst,
                                                  lst, e, bm).to(dtype)
    assert x.grad.dtype == dtype and w.grad.dtype == dtype
    _assert_rel(x.grad, want_dx, TOL[dtype])
    _assert_rel(w.grad, want_dw, TOL[dtype])


def test_gmm_wrappers_refuse_what_the_kernels_do_not_take(dev):
    _, be, fst, lst, m_pad = _gmm_layout(dev, 40, 2, 32, "uniform")
    x = torch.zeros((m_pad, 16), device=dev)
    w = torch.zeros((2, 16, 8), device=dev)
    with pytest.raises(ValueError, match="moe_gmm_block_m"):
        gmm_ops.grouped_matmul(x, w, be, 32)
    with pytest.raises(ValueError, match="moe_gmm_block_m"):
        gmm_ops.grouped_matmul_dw(x, x, be, fst, lst, 2, 32)
    _, be, _, _, m_pad = _gmm_layout(dev, 40, 2, 64, "uniform")
    x = torch.zeros((m_pad, 16), device=dev)
    with pytest.raises(TypeError, match="dtypes"):
        gmm_ops.grouped_matmul(x, w.bfloat16(), be, 64)
    with pytest.raises(ValueError, match="w must be"):
        gmm_ops.grouped_matmul(x, torch.zeros((2, 8, 8), device=dev), be, 64)


def _random_block(dev, c, m, seed):
    """An identity bottleneck's params and stats with every BN leaf
    random (at init the last BN scale is 0 and the block is relu(x))."""
    g = torch.Generator().manual_seed(seed)

    def conv(kh, kw, i, o):
        return (torch.randn((kh, kw, i, o), generator=g)
                * (2 / (kh * kw * i)) ** 0.5).to(dev)

    def bn(ch):
        r = [torch.rand((ch,), generator=g) for _ in range(4)]
        return ({"scale": (0.5 + r[0]).to(dev), "bias": (r[1] - 0.5).to(dev)},
                {"mean": (r[2] - 0.5).to(dev), "var": (0.5 + r[3]).to(dev)})

    params, stats = {}, {}
    for i, shape in enumerate([(1, 1, c, m), (3, 3, m, m), (1, 1, m, c)]):
        params[f"conv{i}"] = conv(*shape)
        params[f"bn{i}"], stats[f"bn{i}"] = bn(shape[-1])
    return params, stats


def _check_fused_block(dev, dtype, n, h, w, c, m, band_rows=None):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params, stats = _random_block(dev, c, m, h * 31 + w + c)
    g = torch.Generator().manual_seed(n + h + w)
    x = torch.randn((n, h, w, c), generator=g).to(dev, dtype)
    before = block_ops.fused_bottleneck_eval.launches
    got = block_ops.fused_bottleneck_eval(x, params, stats,
                                          band_rows=band_rows)
    want = block_ops.fused_bottleneck_reference(x, params, stats)
    torch.cuda.synchronize()
    assert block_ops.fused_bottleneck_eval.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    assert float(want.float().abs().max()) > 1.0     # not just relu(0)
    _assert_rel(got, want, TOL[dtype])
    return x, params, stats, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c,m", [(56, 256, 64), (28, 512, 128),
                                   (14, 1024, 256), (7, 2048, 512)])
def test_fused_block_at_the_resnet50_stages(dev, dtype, h, c, m):
    x, params, stats, got = _check_fused_block(dev, dtype, 3, h, h, c, m)
    if dtype == torch.float32:     # and the unfused block it stands for
        cfg = resnet.Config(depth=50, dtype="float32")
        want, _ = resnet._block(x, params, stats, cfg, 1, False)
        _assert_rel(got, want, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,m", [
    (1, 1, 1, 32, 32),        # one pixel: every tap but the centre is halo
    (2, 5, 9, 128, 32),       # odd plane, C = 4 M
    (2, 9, 5, 64, 64),        # C = M
    (1, 3, 17, 96, 160),      # C < M, widths not multiples of 64
    (5, 7, 7, 256, 64)])
def test_fused_block_odd_planes_and_widths(dev, dtype, n, h, w, c, m):
    _check_fused_block(dev, dtype, n, h, w, c, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("band_rows", [1, 2, 3, 5, 11])
@pytest.mark.parametrize("c,m,depth", [(64, 32, 32), (64, 64, 64),
                                       (96, 160, 32)])
def test_fused_block_every_band_height(dev, dtype, band_rows, c, m, depth):
    """The halo rows between bands and the ragged last band: 11 rows in
    bands of 1, 2, 3 (ragged), 5 (ragged) and the whole image; at C = M =
    64 the bf16 steps are 64 deep, at M 32 and at C 96 / M 160 (64 does
    not divide them) 32 deep."""
    _check_fused_block(dev, dtype, 2, 11, 6, c, m, band_rows=band_rows)
    rows, smem, threads = block_ops.launch_plan(11, 6, c, m, dtype,
                                                band_rows)
    assert rows == band_rows and 0 < smem <= 227 * 1024
    assert threads == 256
    tiles = block_ops.tile_plan(11, 6, c, m, dtype, band_rows)
    assert tiles["depth"] == (depth if dtype == torch.bfloat16 else 16)


@pytest.mark.parametrize("h,c,m", [(56, 256, 64), (7, 2048, 512),
                                   (5, 96, 160)])
def test_fused_block_bf16_is_bit_identical_across_calls(dev, h, c, m):
    """No atomics: five calls on the same input give the same bits."""
    params, stats = _random_block(dev, c, m, h + c)
    g = torch.Generator().manual_seed(h)
    x = torch.randn((3, h, h, c), generator=g).to(dev, torch.bfloat16)
    first = block_ops.fused_bottleneck_eval(x, params, stats)
    for _ in range(4):
        again = block_ops.fused_bottleneck_eval(x, params, stats)
        assert torch.equal(again, first)


def test_fused_block_refuses_what_the_kernel_does_not_take(dev):
    params, stats = _random_block(dev, 64, 32, 0)
    x = torch.zeros((1, 4, 4, 64), device=dev)
    with pytest.raises(ValueError, match="stride"):
        block_ops.fused_bottleneck_eval(x, params, stats, stride=2)
    with pytest.raises(ValueError, match="projection"):
        block_ops.fused_bottleneck_eval(
            x, dict(params, proj=params["conv0"]), stats)
    with pytest.raises(ValueError, match="channels"):
        block_ops.fused_bottleneck_eval(x[..., :32], params, stats)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        block_ops.fused_bottleneck_eval(x.half(), params, stats)
    narrow, nstats = _random_block(dev, 48, 24, 1)
    with pytest.raises(ValueError, match="multiples of 32"):
        block_ops.fused_bottleneck_eval(x[..., :48], narrow, nstats)
    wide = torch.zeros((1, 56, 56, 64), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        block_ops.fused_bottleneck_eval(wide, params, stats, band_rows=56)
    before = block_ops.fused_bottleneck_eval.launches
    with pytest.raises(ValueError):
        block_ops.fused_bottleneck_eval(wide, params, stats, band_rows=57)
    assert block_ops.fused_bottleneck_eval.launches == before
