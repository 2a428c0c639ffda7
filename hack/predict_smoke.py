"""The unary predict phases of ``chip_smoke.py`` alone:

    python3 hack/predict_smoke.py

device, then ``predict`` (ResNet-50 and its int8 variant over
``:predict`` and ``:predictStream``, counts zeroed just before the
traffic and read after), ``predict_residency`` and ``predict_cmd``, each
printing its JSON row; a ``total`` row with the three phases' seconds,
then the card's name and power limit. Builds no kernel: the path
launches none. Needs one CUDA card.
"""

import pathlib
import sys
import time
import traceback

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main():
    t0 = time.perf_counter()
    info = cs.phase_device()
    t1 = time.perf_counter()
    cs.phase_predict(cs.counted_kernels())
    cs.phase_predict_residency()
    cs.phase_predict_cmd()
    cs.emit({"phase": "total", "new_phases_s": time.perf_counter() - t1,
             "seconds": time.perf_counter() - t0})
    print(info["card"], flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
