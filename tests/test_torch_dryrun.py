"""The port's multi-device dry run (``kubeflow_tpu_torch/dryrun.py``)
against the JAX package's ``__graft_entry__.dryrun_multichip``: the same
mesh factorization, and every pass's step on eight CPU positions."""

import pytest

import __graft_entry__ as j_entry
from kubeflow_tpu_torch import dryrun


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 32])
def test_factor_mesh_matches_jax(n):
    assert dryrun._factor_mesh(n) == j_entry._factor_mesh(n)


def test_dryrun_multichip_on_eight_cpu_positions():
    line = dryrun.dryrun_multichip(8, device="cpu")
    assert line.startswith("dryrun_multichip(8) on cpu: mesh data=2 fsdp=2 "
                           "sequence=1 tensor=1 pipeline=2")
    for part in ("ckpt-resume step 1→2", "moe mesh expert=2 dropless",
                 "pp mesh pipeline=2", "1f1b pipeline=2",
                 "sp mesh sequence=2", "multislice slices=2 data=4 "
                 "tensor=2", "— OK"):
        assert part in line
