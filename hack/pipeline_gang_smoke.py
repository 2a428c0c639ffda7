"""The 1F1B phases of ``chip_smoke.py`` alone:

    python3 hack/pipeline_gang_smoke.py

device, build, ``pipeline_1f1b`` (on ``pipeline=2`` and on ``data=2 x
pipeline=2``: the one-process row the gang is read beside), then
``pipeline_1f1b_moe`` (the MoE aux through 1F1B on a cut microbatch) and
``pipeline_1f1b_gang`` (two gloo ranks on ``cuda:0``), each printing its
JSON row; a ``total`` row with the two new phases' seconds, then the
card's name and power limit. Needs one CUDA card.
"""

import pathlib
import sys
import time
import traceback

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main():
    import torch
    t0 = time.perf_counter()
    info = cs.phase_device()
    cs.phase_build()
    kernel_fns = cs.counted_kernels()
    one = cs.phase_pipeline_1f1b(kernel_fns)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cs.phase_pipeline_1f1b_moe(kernel_fns)
    torch.cuda.empty_cache()
    cs.phase_pipeline_1f1b_gang(one["data"], list(kernel_fns))
    cs.emit({"phase": "total", "new_phases_s": time.perf_counter() - t1,
             "seconds": time.perf_counter() - t0})
    print(info["card"], flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
