"""The serving phases of ``chip_smoke.py`` that run over both transports,
alone:

    python3 hack/transport_smoke.py

device, build (the kernels the flagship's serving path launches), then
``wire`` (the flagship's 12 streams over the threaded and then the async
transport, each beside the same engine in process), ``wire_cmd`` (an
async ``model-server`` replica and a threaded decode-role one),
``disagg_wire`` (the ``:prefill`` → ``:attach`` hop over each transport),
``predict`` (ResNet-50's unary traffic over each transport) and
``predict_cmd`` (unary replicas on both transports), each printing its
JSON rows; a ``total`` row with the phases' seconds, then the card's name
and power limit. Needs one CUDA card. ``--reverse`` runs the async
transport first in ``wire`` and ``predict``, to tell an order effect from
a transport's.
"""

import pathlib
import sys
import time
import traceback

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main():
    import torch
    from kubeflow_tpu_torch.compute.models import transformer
    if "--reverse" in sys.argv[1:]:
        cs.TRANSPORTS = tuple(reversed(cs.TRANSPORTS))
    t0 = time.perf_counter()
    info = cs.phase_device()
    cs.phase_build()
    t1 = time.perf_counter()
    params = transformer.init_params(
        cs.flagship_config(), torch.Generator().manual_seed(0),
        device="cuda")
    kernel_fns = cs.counted_kernels()
    seconds = {}
    for name, run in (("wire", lambda: cs.phase_wire(params, kernel_fns)),
                      ("wire_cmd", cs.phase_wire_cmd),
                      ("disagg_wire",
                       lambda: cs.phase_disagg_wire(params, kernel_fns)),
                      ("predict", lambda: cs.phase_predict(kernel_fns)),
                      ("predict_cmd", cs.phase_predict_cmd)):
        t = time.perf_counter()
        run()
        seconds[name] = time.perf_counter() - t
    cs.emit({"phase": "total", "order": list(cs.TRANSPORTS),
             "phases_s": seconds,
             "serving_s": time.perf_counter() - t1,
             "seconds": time.perf_counter() - t0})
    print(info["card"], flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
