"""The port stands alone: no module of ``kubeflow_tpu_torch/``, not
``chip_smoke.py`` and not the port's scripts under ``hack/`` (the
kernel A/B timings, the serving profile, the mesh-axes, the
expert/gang, the 1F1B and its CPU rehearsal, the unary predict, the
two-transport phases and the engine-iteration trace) imports JAX, its
ecosystem (``ml_dtypes`` included: the KV-bundle codec reads bf16
without it) or the JAX package, and none imports ``triton`` at module level (the CPU test host
has none; a kernel module imports it inside the function that
launches)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the port's package, its smoke run, and the scripts that time its kernels
# and serving steps on the card
FILES = sorted((ROOT / "kubeflow_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "hack").glob("*_ab.py")) + [
    ROOT / "hack" / "port_decode_profile.py",
    ROOT / "hack" / "mesh_axes_smoke.py",
    ROOT / "hack" / "expert_gang_smoke.py",
    ROOT / "hack" / "pipeline_gang_smoke.py",
    ROOT / "hack" / "pipeline_gang_cpu.py",
    ROOT / "hack" / "predict_smoke.py",
    ROOT / "hack" / "transport_smoke.py",
    ROOT / "hack" / "engine_iteration_trace.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "kubeflow_tpu")


def _imports(tree):
    """(module name, at module level?) for every import in ``tree``."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            yield name, id(node) in top


def test_the_port_has_files():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_and_no_module_level_triton(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top_level in _imports(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"
        assert not (root == "triton" and top_level), \
            f"{path.name} imports triton at module level"


@pytest.mark.parametrize("rel", [
    "kubeflow_tpu_torch/cmd/__init__.py", "kubeflow_tpu_torch/cmd/__main__.py",
    "kubeflow_tpu_torch/web/__init__.py", "kubeflow_tpu_torch/web/http.py",
    "kubeflow_tpu_torch/obs/tracing.py", "kubeflow_tpu_torch/obs/export.py",
    "kubeflow_tpu_torch/compute/serving.py",
    "kubeflow_tpu_torch/compute/serving_async.py",
    "kubeflow_tpu_torch/compute/mesh.py",
    "kubeflow_tpu_torch/compute/sharding.py",
    "kubeflow_tpu_torch/compute/pipeline.py",
    "kubeflow_tpu_torch/compute/slice_worker.py",
    "kubeflow_tpu_torch/dryrun.py",
    "kubeflow_tpu_torch/qos/__init__.py", "kubeflow_tpu_torch/qos/buckets.py"])
def test_the_scan_reaches_the_serving_plane(rel):
    assert ROOT / rel in FILES
