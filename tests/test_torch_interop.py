"""Reference interop, the demo and ``torch.export`` against the JAX package on
the CPU: every import and export mapper on the same state dicts (bit for
bit), ``save_torch_state_dict`` files, ``import_torchscript_artifact`` on
each family (the ``.isr`` byte for byte, the served output within 1 LSB),
a reference training checkpoint through a stand-in reference repo, the
``import_torch`` and ``demo`` CLIs of both packages on one artifact, K1's
registered op, and ``export_program`` beside JAX's ``export_stablehlo``.

Reference-layout TorchScript files come from seeded weights through
``tests/test_torch_reference_layout.py``. Small sizes: ``sr`` at depth 1,
width 64 (K1's plain version takes width 64 only), the denoisers at width 8.
"""

import importlib.util
import os
import re
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import export as jax_export_mod

from image_super_resolution_tpu import interop as jax_interop
from image_super_resolution_tpu.cli import demo as jax_demo
from image_super_resolution_tpu.cli import import_torch as jax_import_cli
from image_super_resolution_tpu.models.deploy import (
    DeployedModel as JaxDeployedModel,
    export_stablehlo,
)
from image_super_resolution_tpu_torch import interop
from image_super_resolution_tpu_torch.cli import demo, import_torch
from image_super_resolution_tpu_torch.interop.from_jax import variables_to_jax
from image_super_resolution_tpu_torch.models.denoiser import Denoiser
from image_super_resolution_tpu_torch.models.deploy import (
    DeployedModel,
    DeploySpec,
    export_program,
    init_fused_params,
    load_program,
)
from image_super_resolution_tpu_torch.models.discriminator import Discriminator
from image_super_resolution_tpu_torch.models.generator import SRGenerator
from image_super_resolution_tpu_torch.ops.kernels import channel_attention as k3
from image_super_resolution_tpu_torch.ops.kernels import flow_warp as k4
from image_super_resolution_tpu_torch.ops.kernels import fused_rdb as k1
from image_super_resolution_tpu_torch.ops.kernels import matmul as k2
from image_super_resolution_tpu_torch.ops.scatter import rdb_params_to_scatter
from image_super_resolution_tpu_torch.utils.general import flatten_tree
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

_spec = importlib.util.spec_from_file_location(
    "reference_layout", Path(__file__).with_name("test_torch_reference_layout.py"))
layout = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(layout)

MEAN, STD = (0.45, 0.44, 0.40), (0.23, 0.22, 0.21)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _random_tree(tree, seed):
    """Every leaf of a flax tree replaced by seeded values (variances > 0),
    so that no mapping hides behind init's zeros and ones."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        x = rng.standard_normal(np.shape(v)).astype(np.float32) * 0.1
        return np.abs(x) + 0.5 if path[-1].key == "var" else x

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, tree))


def _trees(module, seed=0):
    """(params, batch_stats) in the flax layout, of the port's module (the
    layout JAX's twin has, tests/test_torch_models.py), with seeded values."""
    params, stats = variables_to_jax(module.state_dict())
    return _random_tree(params, seed), _random_tree(stats, seed + 1)


def _generator(enchant=False, seed=0):
    return _trees(SRGenerator(depth=1, width=64, scale=2, enchant=enchant, fused=False,
                              device="cpu"), seed)


def _discriminator(seed=0):
    return _trees(Discriminator(channels=8, n_blocks=4, fc_size=16, device="cpu"), seed)


def _denoiser(seed=0):
    return _trees(Denoiser(depth=2, width=8, fused=False, device="cpu"), seed)


def _fused(family, seed=0, **dims):
    """Fused params at torch's default init scale (``init_fused_params``), so
    that bf16 serving stays in range."""
    return init_fused_params(DeploySpec(family=family, **dims), seed)


def _legacy(seed=0):
    return _fused("denoise_legacy", seed, depth=2, width=8, hidden=4)


def _assert_trees_equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


def _assert_state_dicts_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


# ------------------------------------------------------------- mappers --

def _import_cases():
    p, s = _generator()
    gen = jax_interop.export_generator_state(p, s)
    gan = jax_interop.export_generator_state(p, s, prefix="res_net.")
    pe, _ = _generator(enchant=True)
    dp, ds = _discriminator()
    np_, ns = _denoiser()
    return {
        "generator": ("import_generator_state", gen, {}),
        "generator res_net.": ("import_generator_state", gan, {"prefix": "res_net."}),
        "generator enchant": ("import_generator_state",
                              jax_interop.export_generator_state(pe), {}),
        "discriminator": ("import_discriminator_state",
                          jax_interop.export_discriminator_state(dp, ds), {}),
        "denoiser": ("import_denoiser_state", jax_interop.export_denoiser_state(np_, ns), {}),
        "legacy denoiser": ("import_legacy_denoiser_state",
                            layout.legacy_denoiser_state(_legacy()), {}),
    }


@pytest.mark.parametrize("case", ["generator", "generator res_net.", "generator enchant",
                                  "discriminator", "denoiser", "legacy denoiser"])
def test_import_mappers_match_jax(case):
    """Each import mapper gives the JAX mapper's trees and config, bit for
    bit, on one reference-layout state dict (the discriminator's fc1 with
    its CHW -> HWC input permutation)."""
    name, sd, kw = _import_cases()[case]
    ours, theirs = getattr(interop, name)(sd, **kw), getattr(jax_interop, name)(sd, **kw)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if isinstance(a, dict) and any(isinstance(v, dict) for v in a.values()):
            _assert_trees_equal(a, b)
        else:
            assert a == b or (not a and not b)


def test_linear_permutation_round_trips():
    """linear_to_flax / linear_to_torch: the CHW -> HWC permutation of a
    flattened feature map, equal to JAX's and inverse to each other."""
    w = np.random.default_rng(0).standard_normal((5, 4 * 3 * 2)).astype(np.float32)
    f = interop.linear_to_flax(w, (3, 2, 4))
    assert np.array_equal(f, jax_interop.linear_to_flax(w, (3, 2, 4)))
    assert np.array_equal(interop.linear_to_torch(f, (3, 2, 4)), w)
    assert np.array_equal(interop.linear_to_torch(f, (3, 2, 4)),
                          jax_interop.linear_to_torch(f, (3, 2, 4)))
    k = np.random.default_rng(1).standard_normal((3, 3, 4, 6)).astype(np.float32)
    assert np.array_equal(interop.conv_kernel_to_torch(k), jax_interop.conv_kernel_to_torch(k))
    assert np.array_equal(interop.conv_kernel_to_flax(interop.conv_kernel_to_torch(k)), k)


@pytest.mark.parametrize("family", ["sr", "sr res_net.", "discriminator", "denoise"])
def test_export_mappers_match_jax_and_invert_the_imports(family):
    """Each export mapper's dict equals JAX's (keys in order, values and
    dtypes, num_batches_tracked 0), and import(export(p)) is p."""
    prefix = "res_net." if family.endswith("res_net.") else ""
    p, s = {"sr": _generator, "discriminator": _discriminator,
            "denoise": _denoiser}[family.split()[0]]()
    name = {"sr": "generator", "discriminator": "discriminator",
            "denoise": "denoiser"}[family.split()[0]]
    ours = getattr(interop, f"export_{name}_state")(p, s, prefix=prefix)
    _assert_state_dicts_equal(ours, getattr(jax_interop, f"export_{name}_state")(p, s, prefix=prefix))
    assert all(int(v) == 0 for k, v in ours.items() if k.endswith("num_batches_tracked"))
    back = getattr(interop, f"import_{name}_state")(ours, prefix=prefix)
    _assert_trees_equal(back[0], p)
    _assert_trees_equal(back[1], s)


@pytest.mark.parametrize("family", ["sr", "denoise", "discriminator"])
def test_save_torch_state_dict_matches_jax_file(family, tmp_path):
    """Both packages' files load to the same keys, fp32 values and meta."""
    p, s = {"sr": _generator, "denoise": _denoiser, "discriminator": _discriminator}[family]()
    meta = {"family": family, "scale": 2}
    interop.save_torch_state_dict(tmp_path / "a.pt", p, s, meta=meta, family=family)
    jax_interop.save_torch_state_dict(tmp_path / "b.pt", p, s, meta=meta, family=family)
    a, b = (torch.load(tmp_path / n, weights_only=True) for n in ("a.pt", "b.pt"))
    assert a["meta"] == b["meta"] == meta
    assert list(a["state_dict"]) == list(b["state_dict"])
    for k, v in a["state_dict"].items():
        assert v.dtype == b["state_dict"][k].dtype and torch.equal(v, b["state_dict"][k]), k
        assert v.dtype in (torch.float32, torch.int64)
    with pytest.raises(ValueError, match="unknown family"):
        interop.save_torch_state_dict(tmp_path / "c.pt", p, s, family="fast")


def test_reference_checkpoint_through_a_stand_in_reference_repo(tmp_path, monkeypatch):
    """A training checkpoint that pickles a whole fp16 module of the
    reference's ``utils.models`` unpickles through ``reference_root`` (a
    stand-in repo here) into the same fp32 state dict in both packages,
    and leaves sys.path as it found it."""
    root = tmp_path / "reference"
    (root / "utils").mkdir(parents=True)
    (root / "utils" / "__init__.py").write_text("")
    (root / "utils" / "models.py").write_text(
        "import torch\n"
        "class Net(torch.nn.Module):\n"
        "    def __init__(self):\n"
        "        super().__init__()\n"
        "        self.conv0 = torch.nn.Conv2d(3, 4, 3)\n"
        "        self.bn = torch.nn.BatchNorm2d(4)\n")
    monkeypatch.syspath_prepend(str(root))
    from utils.models import Net  # the stand-in reference class

    torch.manual_seed(0)
    net = Net().half()
    torch.save({"ema": net, "gen_net": Net().half()}, tmp_path / "gen_1.pt")
    for mod in [m for m in sys.modules if m.split(".")[0] == "utils"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(sys, "path", [p for p in sys.path if p != str(root)])
    path_before = list(sys.path)
    ours = interop.state_dict_from_reference_checkpoint(tmp_path / "gen_1.pt", root)
    assert sys.path == path_before
    theirs = jax_interop.state_dict_from_reference_checkpoint(tmp_path / "gen_1.pt", root)
    _assert_state_dicts_equal(ours, theirs)
    assert ours["conv0.weight"].dtype == np.float32
    assert np.array_equal(ours["conv0.weight"], net.conv0.weight.float().detach().numpy())
    assert ours["bn.num_batches_tracked"].dtype == np.int64


# ------------------------------------------------------ artifacts, CLIs --

def _sr_artifact(tmp_path, scale=4, enchant=False):
    p = _fused("sr", depth=1, width=64, scale=scale, enchant=enchant)
    return layout.save_sr_artifact(tmp_path / f"sr{scale}.pt",
                                   interop.export_generator_state(p), MEAN, STD, enchant)


def _denoise_artifact(tmp_path):
    sd = interop.export_denoiser_state(_fused("denoise", depth=2, width=8))
    return layout.save_state_artifact(tmp_path / "denoise.pt", sd, MEAN, STD,
                                      store_bn=["conv1"])


def _legacy_artifact(tmp_path):
    return layout.save_state_artifact(tmp_path / "legacy.pt",
                                      layout.legacy_denoiser_state(_legacy()), MEAN, STD)


ARTIFACTS = {"sr x4": _sr_artifact,
             "sr x2 enchant": lambda t: _sr_artifact(t, scale=2, enchant=True),
             "denoise": _denoise_artifact, "denoise_legacy": _legacy_artifact}


@pytest.mark.parametrize("kind", list(ARTIFACTS))
def test_import_torchscript_artifact_matches_jax(kind, tmp_path):
    """The family and spec read from the key layout and the Normalize
    buffers; the ``.isr`` written from either import is the same file, byte
    for byte; the served uint8 output agrees with JAX's within 1 LSB in fp32,
    and in bf16 within the bounds of tests/test_torch_deploy.py (sr, 1 LSB)
    and tests/test_torch_denoiser.py (1 LSB on under 10% of values)."""
    from image_super_resolution_tpu.models.deploy import save_artifact as jax_save
    from image_super_resolution_tpu_torch.models.deploy import PORT_ONLY_FIELDS, save_artifact

    path = ARTIFACTS[kind](tmp_path)
    deployed, spec, params = interop.import_torchscript_artifact(path, torch.float32, "cpu")
    jdeployed, jspec, jparams = jax_interop.import_torchscript_artifact(path, jnp.float32)
    family = kind.split()[0]
    assert spec.family == jspec.family == family
    # every field of JAX's spec equal; rcan's port-only sizes at their defaults
    assert {k: v for k, v in asdict(spec).items() if k not in PORT_ONLY_FIELDS} == asdict(jspec)
    assert {k: getattr(spec, k) for k in PORT_ONLY_FIELDS} == PORT_ONLY_FIELDS
    assert spec.mean == pytest.approx(MEAN, abs=1e-7)
    assert spec.enchant == kind.endswith("enchant")
    _assert_trees_equal(params, jax.tree_util.tree_map(np.asarray, jparams))
    save_artifact(tmp_path / "ours.isr", spec, params)
    jax_save(tmp_path / "theirs.isr", jspec, jparams)
    assert (tmp_path / "ours.isr").read_bytes() == (tmp_path / "theirs.isr").read_bytes()

    x = _u8((2, 16, 12, 3), 3)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        if dt is torch.bfloat16:
            deployed = interop.import_torchscript_artifact(path, dt, "cpu")[0]
            jdeployed = jax_interop.import_torchscript_artifact(path, jdt)[0]
        diff = np.abs(deployed(x).numpy().astype(int) - np.asarray(jdeployed(x)).astype(int))
        assert diff.max() <= 1, (dt, diff.max())
        if dt is torch.bfloat16 and family != "sr":
            assert (diff > 0).mean() < 0.1


def test_import_refuses_an_unknown_layout(tmp_path):
    path = layout.save_state_artifact(tmp_path / "x.pt", {"head.weight": np.zeros(3)}, MEAN, STD)
    with pytest.raises(ValueError, match="unrecognized TorchScript layout"):
        interop.import_torchscript_artifact(path, device="cpu")


def test_import_torch_cli_matches_jax(tmp_path, capsys):
    """Both CLIs on one sr x4 artifact write the same ``.isr`` file;
    ``--smoke`` serves the seeded (1, 96, 96, 3) batch in bf16 against the
    TorchScript forward in fp32, and returns what it prints: the port
    within BF16_MAX_LSB - 1 (its CPU bound at depth 16), within 1 LSB of
    the JAX CLI's own figure."""
    from image_super_resolution_tpu_torch.models.deploy import BF16_MAX_LSB

    path = _sr_artifact(tmp_path)
    spec, (worst, share) = import_torch.main(["--src", str(path), "--out",
                                              str(tmp_path / "ours.isr"), "--smoke",
                                              "--device", "cpu"])
    ours = capsys.readouterr().out
    jax_import_cli.main(["--src", str(path), "--out", str(tmp_path / "theirs.isr"), "--smoke"])
    theirs = capsys.readouterr().out
    assert (tmp_path / "ours.isr").read_bytes() == (tmp_path / "theirs.isr").read_bytes()
    assert (spec.family, spec.depth, spec.scale) == ("sr", 1, 4)
    assert f"uint8 max diff: {worst} (mismatching pixels: {share:.2%})" in ours
    assert ours.split(" -> ")[0] == theirs.split(" -> ")[0]  # "N parameters (sr, depth 1)"
    jworst = int(re.search(r"max diff: (\d+)", theirs).group(1))
    assert worst <= BF16_MAX_LSB - 1 and abs(worst - jworst) <= 1
    assert import_torch.main(["--src", str(path), "--out", str(tmp_path / "a.isr"),
                              "--device", "cpu"])[1] is None
    with pytest.raises(SystemExit, match="library API"):
        import_torch.main(["--src", str(path), "--reference_root", str(tmp_path),
                           "--device", "cpu"])


def _psnrs(out: str):
    return [float(v) for v in re.search(r"PSNR vs clean: .* ([-\d.]+) dB, restored "
                                        r"([-\d.]+) dB", out).groups()]


@pytest.mark.parametrize("kind", ["sr x4", "denoise_legacy"])
def test_demo_matches_jax(kind, tmp_path, capsys, monkeypatch):
    """Both demos on one artifact: the same test card and degraded (or
    downscaled) input, restored PNGs within 1 LSB (both bf16), PSNRs within
    0.01 dB; ``--src`` restores a given image."""
    from PIL import Image

    monkeypatch.setenv("ISR_COMPILE_CACHE", "off")
    path = ARTIFACTS[kind](tmp_path)
    out = demo.main(["--model_pt", str(path), "--out_dir", str(tmp_path / "ours"),
                     "--device", "cpu"])
    ours = capsys.readouterr().out
    jax_demo.main(["--model_pt", str(path), "--out_dir", str(tmp_path / "theirs")])
    theirs = capsys.readouterr().out
    load = lambda d, n: np.asarray(Image.open(tmp_path / d / n))
    for name in ("clean.png", "input.png"):
        assert np.array_equal(load("ours", name), load("theirs", name)), name
    a, b = load("ours", "restored.png"), load("theirs", "restored.png")
    assert out == tmp_path / "ours" / "restored.png" and a.shape == (192, 192, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert np.allclose(_psnrs(ours), _psnrs(theirs), atol=0.01)
    assert np.array_equal(demo.make_test_card(), jax_demo.make_test_card())

    src = tmp_path / "photo.png"
    Image.fromarray(_u8((30, 26, 3), 5)).save(src)
    got = demo.main(["--model_pt", str(path), "--out_dir", str(tmp_path / "ours"),
                     "--src", str(src), "--device", "cpu"])
    s = 4 if kind == "sr x4" else 1
    assert got.name == "photo_restored.png"
    assert np.asarray(Image.open(got)).shape == (30 * s, 26 * s, 3)


def test_demo_finds_its_model(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="pass --model_pt"):
        demo.find_model_pt(None)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        demo.find_model_pt("missing.pt")
    (tmp_path / "model.pt").write_bytes(b"")
    assert demo.find_model_pt(None) == Path("model.pt")


# ------------------------------------------------ K1's op, torch.export --

def _k1_inputs(shape=(2, 5, 7, 64)):
    spec = DeploySpec(family="sr", depth=1, width=64, scale=4)
    mats = k1.scatter_params_to_matmul(
        rdb_params_to_scatter(init_fused_params(spec, 0)["rrdb0"]["rdb0"]))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape, np.float32))
    return x.bfloat16(), mats


def test_k1_op_cpu_and_fake_implementations():
    """The registered op ``isr::scatter_rdb``: its CPU implementation is the
    plain version, bit for bit, and counts no launch; its fake one gives
    the output's shape and dtype without data (torch.library.opcheck runs
    the schema, fake-tensor and dispatch checks)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, mats = _k1_inputs()
    before = k1.scatter_rdb.launches
    got = torch.ops.isr.scatter_rdb(x, *mats, 0.2, 0.01)
    assert torch.equal(got, k1.scatter_rdb_reference(x, *mats))
    assert k1.scatter_rdb.launches == before
    torch.library.opcheck(torch.ops.isr.scatter_rdb.default, (x, *mats, 0.2, 0.01))
    with FakeTensorMode() as mode:
        fx, fm = mode.from_tensor(x), [mode.from_tensor(t) for t in mats]
        out = torch.ops.isr.scatter_rdb(fx, *fm, 0.2, 0.01)
    assert out.shape == x.shape and out.dtype == torch.bfloat16


def _launch_counts():
    return (k1.scatter_rdb.launches, k1.scatter_rdb.tiles, k1.scatter_rdb.blocks,
            k2.matmul.launches, k2.conv3x3_int8.launches,
            dict(k2.conv3x3_int8.launches_by_variant),
            dict(k2.conv3x3_int8.launches_by_epilogue), dict(k3.ca_residual.launches_by_pass),
            dict(k4.flow_warp.launches_by_mode), dict(k4.flow_warp.launches_by_shape))


def _op_cases(name):
    """(op arguments, the plain version's output) of each ``isr::`` op at a
    small size on the CPU."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    def i8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))

    if name == "scatter_rdb":
        x, mats = _k1_inputs()
        return (x, *mats, 0.2, 0.01), k1.scatter_rdb_reference(x, *mats)
    if name == "matmul":
        a, b = i8(5, 64), i8(64, 7)
        return (a, b), k2.matmul_reference(a, b)
    if name == "conv3x3_int8":
        x, w_q, deq, bias = f32(1, 5, 6, 32, scale=20.0), i8(288, 8), f32(8) ** 2 / 100, f32(8)
        res = f32(1, 5, 6, 8)
        want = k2.conv3x3_int8_reference(x, w_q, deq, bias, True, 0.5, 0.25, res, 0.2, True)
        return ((x, w_q, deq, bias, True, 0.5, 0.25, k2.weights_k_major(w_q), res, 0.2, True),
                list(want))
    if name == "flow_warp":
        x, flow, frame = f32(2, 5, 6, 16), f32(2, 5, 6, 2, scale=3.0), f32(2, 5, 6, 8)
        return (x, flow, "zeros", frame), k4.flow_warp_reference(x, flow, "zeros", frame)
    x, r = f32(2, 5, 6, 32), f32(2, 5, 6, 32)
    params = (f32(32), f32(2, 32), f32(2), f32(32, 2), f32(32))
    return (x, r, *params), k3.ca_residual_reference(x, r, *params)


@pytest.mark.parametrize("name", ["scatter_rdb", "conv3x3_int8", "matmul", "ca_residual",
                                  "flow_warp"])
def test_isr_op_cpu_implementation_is_the_plain_version(name):
    """Each hand-written kernel's op ``isr::<name>``, registered the one way
    (``ops/kernels/_build.register``): on CPU tensors it is the plain version
    bit for bit and counts no launch; ``torch.library.opcheck`` runs its
    schema, fake-tensor and dispatch checks."""
    op = getattr(torch.ops.isr, name).default
    args, want = _op_cases(name)
    before = _launch_counts()
    got = op(*args)
    assert _launch_counts() == before
    if isinstance(want, list):
        assert len(got) == len(want) and all(map(torch.equal, got, want))
    else:
        assert torch.equal(got, want)
    torch.library.opcheck(op, args)


def test_sr_forward_imports_no_dynamo():
    """A fresh process that builds a depth-1 sr ``DeployedModel`` on the CPU
    and calls it (K1's op on its first call) never imports ``torch._dynamo``:
    a first call of a plain ``torch.library`` op costs no set-up."""
    code = (
        "import sys, numpy as np, torch\n"
        "from image_super_resolution_tpu_torch.models.deploy import (DeployedModel,"
        " DeploySpec, init_fused_params)\n"
        "spec = DeploySpec(family='sr', depth=1, width=64, scale=4)\n"
        "d = DeployedModel(spec, init_fused_params(spec, 0), torch.float32, 'cpu')\n"
        "assert d(np.zeros((1, 8, 8, 3), np.uint8)).shape == (1, 32, 32, 3)\n"
        "print('torch._dynamo' in sys.modules)\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def _warm(eager):
    """One eager call before a bit-for-bit comparison: the first conv of a
    CPU process now and then sums in another order than the later ones
    (measured: 1 LSB in 1 of 8 fresh processes, whichever of the two models
    ran first; none in 16 after one warm-up call)."""
    eager(np.zeros((1, 8, 8, 3), np.uint8))


@pytest.mark.parametrize("polymorphic", [False, True])
def test_export_program_round_trip_matches_eager_and_jax(polymorphic, tmp_path):
    """export_program -> load_program on the CPU (fp32 sr x4): K1 is one node
    per RDB of the graph; the program equals the eager DeployedModel bit
    for bit (the dynamic one at two more shapes, batch 1 among them) and
    lies within 1 LSB of the JAX export_stablehlo program deserialized and
    called on the CPU."""
    spec = DeploySpec(family="sr", depth=1, width=64, scale=4, mean=MEAN, std=STD)
    params = init_fused_params(spec, 0)
    eager = DeployedModel(spec, params, torch.float32, "cpu")
    _warm(eager)
    export_program(eager, 2, 12, 16, tmp_path / "p.pt2", polymorphic=polymorphic)
    program = torch.export.load(str(tmp_path / "p.pt2"))
    nodes = [n for n in program.graph.nodes if n.target is torch.ops.isr.scatter_rdb.default]
    assert len(nodes) == 3 * spec.depth
    jeager = JaxDeployedModel(spec, jax.tree_util.tree_map(jnp.asarray, params), jnp.float32)
    export_stablehlo(jeager, 2, 12, 16, tmp_path / "p.hlo", polymorphic=polymorphic)
    jprogram = jax_export_mod.deserialize(bytearray((tmp_path / "p.hlo").read_bytes()))
    loaded = load_program(tmp_path / "p.pt2")
    for shape in [(2, 12, 16)] + ([(1, 9, 11), (3, 16, 8)] if polymorphic else []):
        x = _u8((*shape, 3), sum(shape))
        got = loaded(torch.from_numpy(x))
        assert got.dtype == torch.uint8 and tuple(got.shape) == (shape[0], 4 * shape[1],
                                                                 4 * shape[2], 3)
        assert torch.equal(got, eager(x))
        want = np.asarray(jprogram.call(jnp.asarray(x)))
        assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    if not polymorphic:
        with pytest.raises(Exception):
            loaded(torch.from_numpy(_u8((1, 12, 16, 3), 0)))


def test_export_program_constrains_factor_dims(tmp_path):
    """Dynamic export of a downshuffle-2 artifact (and of the Denoiser, whose
    stride-2 trunk needs even sizes) takes H and W that are multiples of 2
    and equals the eager model there."""
    for spec in (DeploySpec(family="denoise_fast", depth=2, width=16, downshuffle=2),
                 DeploySpec(family="denoise", depth=2, width=8)):
        eager = DeployedModel(spec, init_fused_params(spec, 0), torch.float32, "cpu")
        _warm(eager)
        export_program(eager, 1, 9, 9, tmp_path / "d.pt2", polymorphic=True)
        loaded = load_program(tmp_path / "d.pt2")
        for shape in [(1, 10, 14, 3), (2, 8, 6, 3)]:
            x = _u8(shape, 1)
            assert torch.equal(loaded(torch.from_numpy(x)), eager(x))
        with pytest.raises(Exception):
            loaded(torch.from_numpy(_u8((1, 9, 14, 3), 1)))
