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
