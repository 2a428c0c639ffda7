"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output, and the numbers
that decided ``correct`` beside their limits as the last lines of
standard error. Exits non-zero, with no result, on a host without the
CUDA devices the cell asks for, or if a JAX module was loaded.

Every build and kernel cache of the run stays inside the checkout at a
fixed path (``build/``, where the port also builds its CUDA kernels):
``TRITON_CACHE_DIR``, ``TORCH_EXTENSIONS_DIR`` and ``CUDA_CACHE_PATH``
are set here before anything imports torch. The fleet telemetry
exporter is left off (``OBS_EXPORT_DIR`` empty), so nothing is written
outside the checkout and the run's ``HOME`` and ``TMPDIR``.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.monotonic()
ROOT = Path(__file__).resolve().parent.parent


def process_start():
    """The process's start on the monotonic clock (from its start time
    in ``/proc/self/stat``, in clock ticks since boot), else this
    module's import."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        since = time.clock_gettime(time.CLOCK_BOOTTIME) \
            - ticks / os.sysconf("SC_CLK_TCK")
        return min(T_START, time.monotonic() - since)
    except (OSError, ValueError, IndexError):
        return T_START


def pin_caches(root=ROOT):
    cache = root / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["OBS_EXPORT_DIR"] = ""


if __name__ == "__main__":
    start = process_start()
    pin_caches()
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], start))
