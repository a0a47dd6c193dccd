"""The port stands alone: no module of ``image_super_resolution_tpu_torch``,
no script that runs it on the card (``chip_smoke.py``, the quality
experiments, the severity sweep, GAN vs pixel) imports JAX, flax, the JAX package or a JAX script."""

import ast
import subprocess
import sys
from pathlib import Path

import image_super_resolution_tpu_torch

PKG = Path(image_super_resolution_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "image_super_resolution_tpu")
# what runs on the card's machine, which has no JAX, besides the package
CARD_SCRIPTS = (PKG.parent / "chip_smoke.py",
                PKG.parent / "scripts" / "torch_flagship_quality_experiment.py",
                PKG.parent / "scripts" / "torch_denoise_quality_experiment.py",
                PKG.parent / "scripts" / "torch_denoise_severity_sweep.py",
                PKG.parent / "scripts" / "torch_gan_vs_pixel_experiment.py")
# the JAX package's scripts (the port's own are torch_*)
JAX_SCRIPTS = tuple(p.stem for p in (PKG.parent / "scripts").glob("*.py")
                    if not p.stem.startswith("torch_"))


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN + JAX_SCRIPTS


def test_no_jax_import_in_source():
    assert {"flagship_quality_experiment", "denoise_quality_experiment"} <= set(JAX_SCRIPTS)
    bad = []
    for path in [p for p, _ in _modules()] + list(CARD_SCRIPTS):
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
    # the multi-device serving modules and those of data-parallel training
    # are among them
    assert {f"{PKG.name}.core.mesh", f"{PKG.name}.parallel.spatial",
            f"{PKG.name}.parallel.tensor", f"{PKG.name}.ops.conv",
            f"{PKG.name}.train.state", f"{PKG.name}.train.checkpoint",
            f"{PKG.name}.data.pipeline", f"{PKG.name}.utils.logging",
            f"{PKG.name}.losses.perceptual", f"{PKG.name}.cli.train"} <= set(names)


def test_torch_distributed_only_inside_functions():
    """No module imports ``torch.distributed`` at its top level: only the
    functions that use a process group reach it."""
    bad = []
    for path, _ in _modules():
        for node in ast.parse(path.read_text()).body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [f"{path}: {n}" for n in names if n.startswith("torch.distributed")]
    assert not bad, bad


def test_one_process_training_calls_nothing_of_torch_distributed(tmp_path, monkeypatch):
    """A one-process run of the training CLI on the CPU (pixel with --mean,
    BatchNorm, the gradient step, the checkpoint) with every
    ``torch.distributed`` entry point the port uses made to raise."""
    import json

    import numpy as np
    import torch.distributed as dist

    from image_super_resolution_tpu_torch.cli import train as cli_train
    from image_super_resolution_tpu_torch.utils.png import write_png

    def refusing(name):
        def boom(*a, **kw):
            raise AssertionError(f"torch.distributed.{name} called in one process")
        return boom

    for name in ("init_process_group", "all_reduce", "broadcast_object_list", "new_group",
                 "destroy_process_group"):
        monkeypatch.setattr(dist, name, refusing(name))
    for var in ("WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE", "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(var, raising=False)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        write_png(tmp_path / f"{i}.png", rng.integers(0, 256, (20, 20, 3), dtype=np.uint8))
        paths.append(str(tmp_path / f"{i}.png"))
    (tmp_path / "m.json").write_text(json.dumps(paths))
    history = cli_train.main(["--resnet", "--train_json", str(tmp_path / "m.json"),
                              "--work_dir", str(tmp_path / "w"), "--batch_size", "2",
                              "--shape", "16", "--rs_deep", "1", "--width", "8",
                              "--epochs", "1", "--mean", "--no_tensorboard",
                              "--device", "cpu"])
    assert np.isfinite(history[0]["mean_loss"])
