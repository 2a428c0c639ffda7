"""The ``sequence`` and ``pipeline`` phases of ``chip_smoke.py`` alone,
with the same-run baselines they are read beside:

    python3 hack/mesh_axes_smoke.py

device, build, ``train`` and ``bert_train`` (the one-device steps), then
``ring_mesh``, ``ring_conformance``, ``bert_ring``, ``pipeline_mesh``,
``pipeline_conformance`` and ``pipeline_1f1b``, each printing its JSON
row; a ``total`` row with the six phases' seconds, then the card's name
and power limit. Needs one CUDA card; about a minute after the build.
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
    t0 = time.perf_counter()
    info = cs.phase_device()
    cs.phase_build()
    kernel_fns = {"flash_fwd": flash_ops.flash_attention,
                  "flash_bwd_dq": flash_ops.flash_attention_bwd_dq,
                  "flash_bwd_dkv": flash_ops.flash_attention_bwd_dkv}
    train_row = cs.phase_train(kernel_fns)
    torch.cuda.empty_cache()
    bert_row = cs.phase_bert_train(kernel_fns)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cs.phase_ring_mesh(kernel_fns)
    cs.phase_ring_conformance(kernel_fns)
    torch.cuda.empty_cache()
    cs.phase_bert_ring(kernel_fns, bert_row)
    torch.cuda.empty_cache()
    cs.phase_pipeline_mesh(kernel_fns, train_row)
    torch.cuda.empty_cache()
    cs.phase_pipeline_conformance(kernel_fns)
    torch.cuda.empty_cache()
    cs.phase_pipeline_1f1b(kernel_fns)
    cs.emit({"phase": "total", "new_phases_s": time.perf_counter() - t1,
             "seconds": time.perf_counter() - t0})
    print(info["card"], flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
