"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under ``portbench/`` (top-level names compared whole: the
port's name begins with the JAX package's), and nothing of the port in
the reference, directly or through another module of the benchmark."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "kubeflow_tpu"}


def _module_of(path):
    rel = path.relative_to(PKG.parent).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def imports(path):
    """The absolute module names a file imports (relative imports
    resolved against its package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    mod = _module_of(path)
    pkg = mod if path.name == "__init__.py" else mod.rpartition(".")[0]
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")
                base = base[:len(base) - node.level + 1]
                name = ".".join(base + ([node.module] if node.module else []))
            else:
                name = node.module
            out.append(name)
            out += [f"{name}.{a.name}" for a in node.names]
    return out


def sources():
    return sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    bad = [m for m in imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _file_of(module):
    rel = Path(*module.split("."))
    for cand in (PKG.parent / rel.with_suffix(".py"),
                 PKG.parent / rel / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def test_reference_imports_nothing_of_the_port():
    seen, todo = set(), [p for p in (PKG / "reference").glob("*.py")]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for m in imports(path):
            assert m.split(".")[0] not in FORBIDDEN | {"kubeflow_tpu_torch"}, \
                f"{path.relative_to(PKG)} imports {m}"
            if m.split(".")[0] == "portbench":
                f = _file_of(m)
                if f is not None:
                    todo.append(f)
    assert PKG / "reference" / "model.py" in seen
    # the reference reaches the weights it is handed and nothing else
    assert PKG / "inputs" / "weights.py" in seen


def test_the_scan_sees_whole_names():
    assert "kubeflow_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "kubeflow_tpu.compute".split(".")[0] in FORBIDDEN
