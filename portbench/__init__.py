"""The benchmark of the PyTorch and CUDA port (``kubeflow_tpu_torch``).

One run measures one cell of ``BENCHMARK.json`` once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:

- ``configs/<config>.json``: a model's published sizes, as run;
- ``traffic/<traffic>.json``: a traffic mix's parameters, read by the
  generator its ``kind`` names (``traffic/<kind>.py``);
- ``workloads/<cell>.json``: the cell's runner (``runners/<runner>.py``),
  its settings and the limits that decide ``correct``;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

The yardstick is frozen here: the traffic generators, the kernels'
operations and bytes (``roofline/``), the kernel grouping, the peaks,
the plain fp32 reference (``reference/``) and the comparisons. Nothing
in this package imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.
"""
