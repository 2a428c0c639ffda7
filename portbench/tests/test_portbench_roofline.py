"""The frozen arithmetic against the bounds PERF.md's kernel table
records at the port's own kernel shapes (bf16, H100 peaks)."""

import pytest

from portbench.roofline import kernel_group, kernels
from portbench.roofline.model_flops import (Shape, decode_token_flops,
                                            prefill_flops, train_step_flops)


def ms(call, dtype="bfloat16"):
    return kernels.bound(*call, dtype)[0] * 1e3


@pytest.mark.parametrize("fn,want", [(kernels.flash_fwd, 0.0348),
                                     (kernels.flash_bwd_dq, 0.0522),
                                     (kernels.flash_bwd_dkv, 0.0696)])
def test_flash_bounds_at_the_train_shape(fn, want):
    # B 16, S 1024, 8 q / 2 kv heads of 128, causal: operations bound
    assert round(ms(fn(16, 1024, 8, 2, 128)), 4) == want
    assert kernels.bound(*fn(16, 1024, 8, 2, 128), "bfloat16")[1] \
        == "operations"


def test_grouped_matmul_bounds_at_the_moe_step():
    # K6 gate|up [17408, 1024] x [8, 1024, 5632]; K7 dw from 17024 rows
    assert round(ms(kernels.gmm(17408, 1024, 2 * 2816, 8)), 4) == 0.2030
    assert round(ms(kernels.gmm_dw(17024, 1024, 2 * 2816, 8)), 4) == 0.1985


def test_paged_decode_bound_is_the_bytes_read():
    # 8 slots, lengths 0…1024 (2764 positions), 8 q / 2 kv, 64-block tables
    nbytes, flops = kernels.paged_decode(2764, 8, 8, 2, 128, 64)
    t, by = kernels.bound(nbytes, flops, "bfloat16")
    assert by == "bytes" and round(t * 1e3, 6) == 0.000855


MIXTRAL = {"hidden_size": 4096, "num_hidden_layers": 2,
           "num_attention_heads": 32, "num_key_value_heads": 8,
           "intermediate_size": 14336, "vocab_size": 32000,
           "num_local_experts": 8, "num_experts_per_tok": 2}


def test_model_flops_of_the_moe_step():
    # two Mixtral layers at 8 x 4096: 187.4 TFLOP, attention 6.6 of it
    sh = Shape.of(MIXTRAL)
    assert round(train_step_flops(sh, 8, 4096) / 1e12, 1) == 187.4
    dense = 6 * (sh.body_params() + sh.head_params()) * 8 * 4096
    assert round((train_step_flops(sh, 8, 4096) - dense) / 1e12, 1) == 6.6
    # at 1 x 32768 the same tokens, attention 52.8 TFLOP
    assert round((train_step_flops(sh, 1, 32768) - dense) / 1e12, 1) == 52.8


def test_served_flops_count_one_head_row_a_prefill():
    sh = Shape.of(dict(MIXTRAL, num_local_experts=0, num_hidden_layers=32))
    one = prefill_flops(sh, 1)
    assert one == decode_token_flops(sh, 1)
    assert prefill_flops(sh, 2050) < 2050 * decode_token_flops(sh, 2050)


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, 128>",
     "K1 paged_decode"),
    ("flash_fwd_tc_kernel<128>", "K3 flash_fwd"),
    ("void gmm_dw_wgmma_kernel<8>(...)", "K7 grouped_matmul_dw"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("Memcpy DtoD (Device -> Device)", "other")])
def test_kernel_groups(name, group):
    assert kernel_group(name) == group
