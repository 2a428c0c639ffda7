"""The expert-mesh, 1F1B and multi-process phases of ``chip_smoke.py``
alone, with the same-run baselines they are read beside:

    python3 hack/expert_gang_smoke.py

device, build, ``train``, ``bert_train`` and ``resnet_train`` (the
one-device steps ``process_mesh`` reads beside its gang) and
``moe_apply``/``moe_train`` (the MoE flagship's), then ``moe_mesh``,
``moe_mesh_conformance``, ``pipeline_1f1b`` (on ``pipeline=2`` and on
``data=2 x pipeline=2``), ``process_mesh`` and ``slice_worker``, each
printing its JSON row; a ``total`` row with the five phases' seconds,
then the card's name and power limit. Needs one CUDA card.
"""

import pathlib
import sys
import time
import traceback

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main():
    import torch
    from kubeflow_tpu_torch.compute.ops import flash_attention as flash_ops
    from kubeflow_tpu_torch.compute.ops import grouped_matmul as gmm_ops
    t0 = time.perf_counter()
    info = cs.phase_device()
    cs.phase_build()
    kernel_fns = {"flash_fwd": flash_ops.flash_attention,
                  "flash_bwd_dq": flash_ops.flash_attention_bwd_dq,
                  "flash_bwd_dkv": flash_ops.flash_attention_bwd_dkv,
                  "grouped_matmul": gmm_ops.grouped_matmul,
                  "grouped_matmul_dw": gmm_ops.grouped_matmul_dw}
    one_rows = {"flagship": cs.phase_train(kernel_fns)}
    torch.cuda.empty_cache()
    one_rows["bert"] = cs.phase_bert_train(kernel_fns)
    torch.cuda.empty_cache()
    one_rows["resnet"] = cs.phase_resnet_train(kernel_fns)
    torch.cuda.empty_cache()
    _, moe_row = cs.phase_moe(kernel_fns)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cs.phase_moe_mesh(kernel_fns, moe_row)
    torch.cuda.empty_cache()
    cs.phase_moe_mesh_conformance(kernel_fns)
    torch.cuda.empty_cache()
    cs.phase_pipeline_1f1b(kernel_fns)
    torch.cuda.empty_cache()
    cs.phase_process_mesh(one_rows, list(kernel_fns))
    cs.phase_slice_worker()
    cs.emit({"phase": "total", "new_phases_s": time.perf_counter() - t1,
             "seconds": time.perf_counter() - t0})
    print(info["card"], flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
