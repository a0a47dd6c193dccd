"""The port's export CLI against the JAX package's on the CPU: the ``.isr``
written from a checkpoint of either package (pixel or GAN phase, EMA or
raw weights) holds the same spec and fp16 params as the JAX export's, and
JAX's ``load_artifact`` serves it within 1 LSB of the port; ``--smoke``,
dims read from the checkpoint, the reference-layout state dicts and the
``torch.export`` program, and the refused formats."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_super_resolution_tpu.cli import export as jax_export
from image_super_resolution_tpu.models import SRGenerator as JaxSRGenerator
from image_super_resolution_tpu.models.deploy import load_artifact as jax_load_artifact
from image_super_resolution_tpu.train import checkpoint as jax_ckpt
from image_super_resolution_tpu.train.state import build_optimizer, create_train_state
from image_super_resolution_tpu.train.steps import (
    make_pixel_train_step as jax_make_pixel_train_step,
)
from image_super_resolution_tpu_torch.cli import export
from image_super_resolution_tpu_torch.cli import train as cli_train
from image_super_resolution_tpu_torch.models.deploy import load_artifact, read_artifact
from image_super_resolution_tpu_torch.models.generator import SRGenerator
from image_super_resolution_tpu_torch.ops.initializers import init_weights
from image_super_resolution_tpu_torch.train import checkpoint as ckpt
from image_super_resolution_tpu_torch.train.state import TrainState
from image_super_resolution_tpu_torch.train.steps import make_pixel_train_step
from image_super_resolution_tpu_torch.utils.general import flatten_tree
from image_super_resolution_tpu_torch.utils.png import write_png
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

MEAN, STD = (0.45, 0.44, 0.40), (0.23, 0.22, 0.21)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _jax_checkpoint(tmp_path):
    """A JAX pixel checkpoint (sr x2, depth 2, width 8, BN) after two steps,
    so that its EMA differs from its params."""
    tx = build_optimizer(lr=1e-2, total_steps=4)
    jstate = create_train_state(JaxSRGenerator(depth=2, width=8, scale=2, dtype=jnp.float32),
                                (1, 16, 16, 3), tx, jax.random.PRNGKey(0), ema_tau=4)
    step = jax_make_pixel_train_step(2)
    for i in range(2):
        jstate, _ = step(jstate, jnp.asarray(_u8((2, 16, 16, 3), i)))
    path = tmp_path / "jax.ckpt"
    jax_ckpt.save_checkpoint(path, jstate, 0, MEAN, STD, [0.3, 0.2])
    return path


def _port_checkpoint(tmp_path):
    state = TrainState(init_weights(SRGenerator(depth=2, width=8, scale=2, fused=False,
                                                device="cpu"), 1),
                       lr=1e-2, total_steps=4, ema_tau=4)
    step = make_pixel_train_step(2, mean=MEAN, std=STD)
    for i in range(2):
        step(state, torch.from_numpy(_u8((2, 16, 16, 3), i)))
    path = tmp_path / "port.ckpt"
    ckpt.save_checkpoint(path, state, 0, MEAN, STD, [0.3, 0.2])
    return path


def _gan_checkpoint(tmp_path):
    """The port CLI's GAN phase, one epoch at depth 2, width 8: a
    ``gen_*.ckpt`` carrying D beside G."""
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"img{i}.png"))
        write_png(paths[-1], _u8((40, 36, 3), i))
    (tmp_path / "m.json").write_text(json.dumps(paths))
    cli_train.main(["--train_json", str(tmp_path / "m.json"), "--work_dir", str(tmp_path),
                    "--batch_size", "2", "--shape", "16", "--device", "cpu",
                    "--no_tensorboard", "--rs_deep", "2", "--width", "8", "--epochs", "1"])
    return tmp_path / "gen_checkpoint_2_0.2.ckpt"


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """``checkpoint(source)``: the JAX, port or port GAN checkpoint, each
    made once for the module (the tests read them and write elsewhere)."""
    made, makers = {}, {"jax": _jax_checkpoint, "port": _port_checkpoint,
                        "port gan": _gan_checkpoint}

    def get(source):
        if source not in made:
            made[source] = makers[source](tmp_path_factory.mktemp(source.replace(" ", "_")))
        return made[source]

    return get


@pytest.mark.parametrize("no_ema", [False, True])
@pytest.mark.parametrize("source", ["jax", "port", "port gan"])
def test_export_matches_jax_export(source, no_ema, checkpoint, tmp_path):
    """Both CLIs export the same checkpoint with the same flags (depth and
    width read from it): the same spec (the checkpoint's mean/std baked in)
    and fp16 params equal bit for bit (EMA or, with --no_ema, raw weights,
    BN folded in the same fp32 order); JAX's load_artifact serves the
    port's file within 1 LSB of the port's own fp32 serving."""
    path = checkpoint(source)
    flags = ["--checkpoint", str(path), "--scale", "2"] + (["--no_ema"] if no_ema else [])
    ours, theirs = tmp_path / "port.isr", tmp_path / "jax.isr"
    export.main(flags + ["--out", str(ours), "--device", "cpu"])
    jax_export.main(flags + ["--out", str(theirs), "--compile_cache", "off"])
    spec, params = read_artifact(ours)
    jspec, jparams = read_artifact(theirs)
    assert spec == jspec and (spec.depth, spec.width) == (2, 8)
    if source != "port gan":
        assert spec.mean == MEAN and spec.std == STD
    a, b = flatten_tree(params), flatten_tree(jparams)
    assert sorted(a) == sorted(b) and not any("bn" in k for k in a)
    for k in a:
        assert a[k].dtype == np.float16 and np.array_equal(a[k], b[k]), k
    x = _u8((2, 20, 24, 3), 7)
    want = np.asarray(load_artifact(ours, dtype=torch.float32, device="cpu")(x))
    got = np.asarray(jax_load_artifact(ours, dtype=jnp.float32)(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 40, 48, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_export_no_ema_differs_and_smoke_serves(checkpoint, tmp_path, capsys):
    """--no_ema exports other weights than the default; --smoke serves the
    written file on the chosen device and prints its timing line; the
    parameter count line counts the fused params."""
    path = checkpoint("port")
    export.main(["--checkpoint", str(path), "--out", str(tmp_path / "a.isr"),
                 "--device", "cpu", "--smoke"])
    out = capsys.readouterr().out
    assert "smoke: (1, 96, 96, 3) uint8 -> (1, 192, 192, 3) torch.uint8" in out
    n = sum(v.size for v in flatten_tree(read_artifact(tmp_path / "a.isr")[1]).values())
    assert f"{n:,} parameters -> " in out and "mean loss: 0.25" in out
    export.main(["--checkpoint", str(path), "--out", str(tmp_path / "b.isr"),
                 "--device", "cpu", "--no_ema"])
    a = flatten_tree(read_artifact(tmp_path / "a.isr")[1])
    b = flatten_tree(read_artifact(tmp_path / "b.isr")[1])
    assert any(not np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("flag", ["--torch_state_dict", "--torch_discriminator", "--stablehlo"])
def test_export_writes_the_other_formats(flag, checkpoint, tmp_path):
    """--torch_state_dict and --torch_discriminator write the JAX export's
    file from the same checkpoint (a GAN checkpoint for D): the same keys
    in order, fp32 values bit for bit, the same meta. --stablehlo writes a
    torch.export program that loads and equals the eager model bit for
    bit, and --hlo_dynamic one that serves another shape too."""
    from image_super_resolution_tpu_torch.models.deploy import build_deployed, load_program

    path = checkpoint("port gan" if flag == "--torch_discriminator" else "port")
    ours, theirs = tmp_path / "ours.pt", tmp_path / "theirs.pt"
    flags = ["--checkpoint", str(path), "--scale", "2", "--out", str(tmp_path / "m.isr")]
    if flag == "--stablehlo":
        x = _u8((2, 12, 16, 3), 3)
        for dynamic in ([], ["--hlo_dynamic"]):
            spec = export.main(flags + ["--device", "cpu", flag, str(ours), "--hlo_shape",
                                        "2", "12", "16", *dynamic])
            program = load_program(ours)
            eager = build_deployed(ckpt.load_checkpoint(path), spec, device="cpu")[0]
            assert torch.equal(program(torch.from_numpy(x)), eager(x))
        y = _u8((1, 9, 7, 3), 4)
        assert tuple(program(torch.from_numpy(y)).shape) == (1, 18, 14, 3)
        assert torch.equal(program(torch.from_numpy(y)), eager(y))
        return
    export.main(flags + ["--device", "cpu", flag, str(ours)])
    jax_export.main(flags + ["--compile_cache", "off", flag, str(theirs)])
    a, b = torch.load(ours, weights_only=True), torch.load(theirs, weights_only=True)
    assert a["meta"] == b["meta"]
    assert list(a["state_dict"]) == list(b["state_dict"])
    for k, v in a["state_dict"].items():
        assert v.dtype == b["state_dict"][k].dtype and torch.equal(v, b["state_dict"][k]), k
    assert any(k.endswith("bn.running_var") for k in a["state_dict"])


@pytest.mark.parametrize("flag", ["--tf_saved_model", "fast --torch_state_dict"])
def test_export_refuses_formats_of_a_later_slice(flag, tmp_path):
    """--tf_saved_model needs jax2tf and TensorFlow, which the port does not
    depend on; the fast families have no reference class to take a
    --torch_state_dict. Both exit before reading the checkpoint."""
    family = ["--family", "fast"] if flag.startswith("fast") else []
    with pytest.raises(SystemExit, match="TensorFlow" if family == [] else "no reference"):
        export.main(["--checkpoint", str(tmp_path / "missing.ckpt"), flag.split()[-1],
                     str(tmp_path / "x"), "--device", "cpu", *family])


def test_export_checks_downshuffle_like_jax(checkpoint):
    path = checkpoint("port")
    for flags in (["--downshuffle", "2"], ["--family", "denoise_fast", "--downshuffle", "0"]):
        with pytest.raises(SystemExit, match="downshuffle"):
            export.main(["--checkpoint", str(path), "--device", "cpu", *flags])
