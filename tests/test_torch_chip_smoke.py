"""``chip_smoke.py``'s build report: the kernels' names read from the
symbols ``nvcc -Xptxas -v`` prints on the card, and their registers and
spills. CPU only: the log is a fixed string in ptxas's format."""

import pytest

import chip_smoke

NS = "_ZN45_GLOBAL__N__5e7a0f37_12_flash_bwd_cu_3e1c50db"


@pytest.mark.parametrize("symbol,name", [
    (NS + "23flash_bwd_dkv_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_S3_"
     "PKfS5_PS1_S6_iiiiiif", "flash_bwd_dkv_tc_kernel<128>"),
    (NS + "19flash_bwd_dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_"
     "PS2_iiiiif", "flash_bwd_dq_kernel<bf16, 64>"),
    (NS + "20flash_bwd_dkv_kernelIfLi32EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_iiiiif",
     "flash_bwd_dkv_kernel<float, 32>"),
    ("_ZN12_GLOBAL__N_113decode_kernelI13__nv_bfloat16aLi128EEEvv",
     "decode_kernel<bf16, int8, 128>"),
    ("_ZN12_GLOBAL__N_16kernelEv", "kernel"),
    ("_ZN12_GLOBAL__N_16kernelILb1EEEvv", "kernel<true>"),
    ("_ZN12_GLOBAL__N_16kernelILb0ELi64EEEvv", "kernel<false, 64>"),
    ("_ZN12_GLOBAL__N_16kernelILl1EEEvv", "_ZN12_GLOBAL__N_16kernelILl1EEEvv"),
    ("kubeflow_flash_fwd", "kubeflow_flash_fwd"),
])
def test_demangle_names_the_kernel_and_its_template_arguments(symbol, name):
    assert chip_smoke._demangle(symbol) == name


def test_ptxas_entries_reads_registers_and_spills_per_kernel():
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{NS}19flash_fwd_tc_"
        "kernelILi128EEEvv' for 'sm_90a'",
        f"ptxas info    : Function properties for {NS}19flash_fwd_tc_kernel",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 197 registers, used 1 barriers, 400 bytes "
        "cmem[0]",
        f"ptxas info    : Compiling entry function '{NS}16flash_fwd_kernel"
        "IfLi64EEEvv' for 'sm_90a'",
        "    24 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
    ])
    entries = chip_smoke.ptxas_entries(log)
    assert list(entries) == ["flash_fwd_tc_kernel<128>",
                             "flash_fwd_kernel<float, 64>"]
    tc = entries["flash_fwd_tc_kernel<128>"]
    assert (tc["registers"], tc["spill_stores"], tc["spill_loads"]) == (
        197, 0, 0)
    assert len(tc["lines"]) == 2
    fp32 = entries["flash_fwd_kernel<float, 64>"]
    assert (fp32["registers"], fp32["spill_stores"], fp32["spill_loads"]) == (
        128, 24, 16)
    assert chip_smoke.ptxas_entries("") == {}


def test_serialized_wgmma_finds_ptxas_warning_c7515():
    """The build phase fails on these lines: a kernel whose wgmma ptxas
    serialized runs every product after the one before."""
    warning = (f"ptxas info    : (C7515) Potential Performance Loss: "
               f"wgmma.mma_async instructions are serialized due to the "
               f"presence of Extern calls in the function '{NS}_kernel'")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{NS}_kernel' for "
        "'sm_90a'", warning,
        "ptxas info    : Used 168 registers, used 1 barriers"])
    assert chip_smoke.serialized_wgmma(log) == [warning.strip()]
    assert chip_smoke.serialized_wgmma(log.replace(warning, "")) == []


def _stream_result(frames, ttft_ms, max_tokens=2):
    return {"status": 200, "max_tokens": max_tokens, "frames": frames,
            "head": {"content-type": "application/x-ndjson",
                     "x-ttft-ms": ttft_ms}}


GOOD = [{"token": 5, "index": 0}, {"token": 9, "index": 1},
        {"done": True, "reason": "length", "tokens": [5, 9],
         "ttft_s": 0.012345}]


def test_check_wire_takes_a_whole_stream():
    assert chip_smoke._check_wire([_stream_result(GOOD, "12.345")],
                                  vocab=16) == [[5, 9]]


@pytest.mark.parametrize("frames,ttft_ms,max_tokens", [
    (GOOD, "12.3", 2),                                  # X-TTFT-Ms off
    ([GOOD[1], GOOD[0], GOOD[2]], "12.345", 2),         # indices out of order
    ([GOOD[0], GOOD[2]], "12.345", 2),                  # a frame missing
    (GOOD, "12.345", 3),                                # budget not spent
    ([{"token": 99, "index": 0}, {"token": 9, "index": 1},
      dict(GOOD[2], tokens=[99, 9])], "12.345", 2),     # out of the vocab
], ids=["ttft", "order", "missing", "budget", "vocab"])
def test_check_wire_refuses_a_broken_stream(frames, ttft_ms, max_tokens):
    with pytest.raises(AssertionError):
        chip_smoke._check_wire(
            [_stream_result(frames, ttft_ms, max_tokens)], vocab=16)


def test_check_wire_refuses_an_error_status():
    with pytest.raises(AssertionError, match="503"):
        chip_smoke._check_wire([{"status": 503, "head": {},
                                 "error": "draining"}], vocab=16)


def test_first_mismatches():
    assert chip_smoke._first_mismatches(
        [[1, 2, 3], [1, 2], [4, 5]], [[1, 2, 3], [1, 2, 3], [4, 6]]) == [
        None, 2, 1]
