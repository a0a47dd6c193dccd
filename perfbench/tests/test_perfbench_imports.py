"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: the port's name begins with the JAX package's); the reference
imports nothing of the port; the command refuses to run without a card and
without the port."""

import ast
import json
import shutil
import subprocess
import sys

from conftest import ROOT

from perfbench.harness.guard import forbidden_loaded

SMOKE = r'''
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import run_cpu, tiny_cell
from perfbench.harness.guard import forbidden_loaded
r = run_cpu(tiny_cell({cell!r}, depth=1), trace=True)
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": r["correct"], "forbidden": forbidden_loaded(), "top": top}}))
'''


def test_guard_compares_whole_top_level_names():
    assert forbidden_loaded(["image_super_resolution_tpu_torch.models", "jaxtyping",
                             "flaxen.x"]) == []
    assert forbidden_loaded(["image_super_resolution_tpu.models.deploy", "jaxlib.xla",
                             "jax", "flax.linen"]) == ["flax", "image_super_resolution_tpu",
                                                       "jax", "jaxlib"]


def test_cpu_smoke_run_loads_no_jax():
    for cell in ("sr_x4.frames", "fast_x4_int8.photos"):
        code = SMOKE.format(root=str(ROOT), tests=str(ROOT / "perfbench" / "tests"), cell=cell)
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=300, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        r = json.loads(out.stdout.strip().splitlines()[-1])
        assert r["correct"] and r["forbidden"] == []
        assert "image_super_resolution_tpu_torch" in r["top"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    files = sorted((ROOT / "perfbench" / "reference").glob("*.py"))
    assert len(files) >= 4
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in ("image_super_resolution_tpu_torch", "jax",
                                              "flax", "image_super_resolution_tpu"), (f, name)


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    """Here there is no card, so both refuse; on the card the copy holding
    only BENCHMARK.json and perfbench/ fails when it builds the program."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    cmd = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    args = ["--workload", "sr_x4.frames", "--seed", str(2 ** 31 + 5), "--seconds", "1",
            "--trace", "0"]
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, *cmd[1:], *args], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from perfbench.harness.cell import run_cell;"
            "from perfbench.harness.spec import find_cell;"
            "run_cell(find_cell('sr_x4.frames'), 1, 0.1, False, time.perf_counter(), 'cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "image_super_resolution_tpu_torch" in out.stderr
