"""The port stands alone: no module of ``image_super_resolution_tpu_torch``
imports JAX, flax or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import image_super_resolution_tpu_torch

PKG = Path(image_super_resolution_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "image_super_resolution_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_jax_import_in_source():
    bad = []
    for path, _ in _modules():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                bad += [f"{path}: {a.name}" for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module or ""):
                    bad.append(f"{path}: {node.module}")
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    names = [name for _, name in _modules()]
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(names) >= 20
    # the multi-device serving modules are among them
    assert {f"{PKG.name}.core.mesh", f"{PKG.name}.parallel.spatial",
            f"{PKG.name}.parallel.tensor"} <= set(names)
