"""Reference-layout TorchScript artifacts, made from seeded weights, and the
tests of the helpers that make them.

The reference's deployment artifact is a TorchScript file of ``Normalize``
(buffers ``net.0.mean``, ``net.0.std``) -> the inner net (``net.1``) ->
uint8 out, taking and giving uint8 NCHW. No such file is in the
repository, so the interop tests and ``chip_smoke.py`` build their own:

- ``save_sr_artifact``: a generator with a real forward, ``SRTwin``, written
  from the JAX package's ``SRGenerator`` (fused, NCHW) under the
  reference's names (``conv0``, ``residual.{i}.net.{j}.conv{k}.conv``,
  ``.conv.conv``, ``conv1``, ``scaler.{s}.net.0.conv``, ``conv2``). A
  generator that is not ``enchant`` carries the vestigial ``store_bn`` of
  the reference's ``fuse()`` on every conv that had a BatchNorm, which is
  how an import tells the two apart;
- ``save_state_artifact``: any state dict under ``net.1`` with an identity
  forward, for the denoisers (the importers read the keys only);
- ``legacy_denoiser_state``: the inverse of ``import_legacy_denoiser_state``.

This file imports no JAX at module level: ``chip_smoke.py`` loads it by
path on a machine without JAX. Its tests import JAX where they use it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Iterable

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

ADD_RATE = 0.2


class _Normalize(nn.Module):
    def __init__(self, mean, std):
        super().__init__()
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32).reshape(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32).reshape(1, 3, 1, 1))

    def forward(self, x):
        return (x.float() / 255.0 - self.mean) / self.std


class _ToUint8(nn.Module):
    def forward(self, y):
        return torch.round(torch.clamp((y + 1.0) / 2.0 * 255.0, 0.0, 255.0)).to(torch.uint8)


class _Artifact(nn.Module):
    def __init__(self, inner: nn.Module, mean, std):
        super().__init__()
        self.net = nn.Sequential(_Normalize(mean, std), inner, _ToUint8())

    def forward(self, x):
        return self.net(x)


class _Conv(nn.Module):
    """A fused reference Conv: ``conv`` with a bias, and ``store_bn`` where
    the unfused conv had a BatchNorm."""

    def __init__(self, cin: int, cout: int, k: int, store_bn: bool):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2)
        if store_bn:
            self.store_bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return self.conv(x)


class _RDB(nn.Module):
    def __init__(self, c: int, bn: bool):
        super().__init__()
        g = c // 2
        for i in range(4):
            self.add_module(f"conv{i}", _Conv(c + i * g, g, 3, bn))
        self.conv = _Conv(c + 4 * g, c, 3, bn)

    def forward(self, x):
        feats = [x]
        for conv in (self.conv0, self.conv1, self.conv2, self.conv3):
            feats.append(F.leaky_relu(conv(torch.cat(feats, 1)), 0.01))
        return self.conv(torch.cat(feats, 1)) * ADD_RATE + x


class _RRDB(nn.Module):
    def __init__(self, c: int, bn: bool):
        super().__init__()
        self.net = nn.ModuleList([_RDB(c, bn) for _ in range(3)])

    def forward(self, x):
        h = x
        for rdb in self.net:
            h = rdb(h)
        return h * ADD_RATE + x


class _Scaler(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.net = nn.Sequential(_Conv(c, 4 * c, 3, False), nn.PixelShuffle(2),
                                 nn.LeakyReLU(0.01))

    def forward(self, x):
        return self.net(x)


class SRTwin(nn.Module):
    """The fused ``SRGenerator`` in NCHW under the reference's names: 9x9
    head, ``depth`` RRDBs, 3x3 trunk conv and global skip, ``scale // 2``
    x2 sub-pixel stages, 9x9 tail, tanh. fp32 in, [-1, 1] out."""

    def __init__(self, depth: int, width: int, scale: int, enchant: bool = False):
        super().__init__()
        bn = not enchant
        self.head_slope = 0.01 if enchant else 0.2
        self.conv0 = _Conv(3, width, 9, False)
        self.residual = nn.ModuleList([_RRDB(width, bn) for _ in range(depth)])
        self.conv1 = _Conv(width, width, 3, bn)
        self.scaler = nn.ModuleList([_Scaler(width) for _ in range(scale // 2)])
        self.conv2 = _Conv(width, 3, 9, False)

    def forward(self, x):
        x = F.leaky_relu(self.conv0(x), self.head_slope)
        h = x
        for rrdb in self.residual:
            h = rrdb(h)
        x = x + self.conv1(h)
        for up in self.scaler:
            x = up(x)
        return torch.tanh(self.conv2(x))


def sr_twin(sd: Dict[str, np.ndarray], enchant: bool = False) -> SRTwin:
    """``SRTwin`` holding a fused reference-layout generator state dict
    (``interop.export_generator_state`` of fused params)."""
    depth = sum(1 for k in sd if k.endswith(".net.0.conv0.conv.weight"))
    scale = 2 ** sum(1 for k in sd if k.startswith("scaler.") and k.endswith(".conv.weight"))
    twin = SRTwin(depth, sd["conv0.conv.weight"].shape[0], scale, enchant).eval()
    missing, unexpected = twin.load_state_dict(
        {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}, strict=False)
    if unexpected or any(".store_bn." not in k for k in missing):
        raise ValueError(f"not a fused generator layout: missing {missing}, "
                         f"unexpected {unexpected}")
    return twin


def _save(module: nn.Module, path: Path) -> Path:
    traced = torch.jit.trace(module.eval(), torch.zeros(1, 3, 16, 16, dtype=torch.uint8),
                             check_trace=False)
    torch.jit.save(traced, str(path))
    return Path(path)


def save_sr_artifact(path, sd: Dict[str, np.ndarray], mean, std, enchant: bool = False) -> Path:
    """A reference TorchScript artifact of a fused generator state dict."""
    return _save(_Artifact(sr_twin(sd, enchant), mean, std), path)


class _State(nn.Module):
    """Buffers at the given dotted names; identity forward."""

    def forward(self, x):
        return x


def save_state_artifact(path, sd: Dict[str, np.ndarray], mean, std,
                        store_bn: Iterable[str] = ()) -> Path:
    """A reference TorchScript artifact whose ``net.1`` holds ``sd`` (plus a
    vestigial ``store_bn`` under each prefix of ``store_bn``), with an
    identity net: the importers read its keys, nothing runs it."""
    sd = dict(sd)
    for prefix in store_bn:
        c = sd[f"{prefix}.conv.weight"].shape[0]
        for name, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                            ("running_var", 1.0)):
            sd[f"{prefix}.store_bn.{name}"] = np.full(c, value, np.float32)
    inner = _State()
    for key, value in sd.items():
        *path_, leaf = key.split(".")
        node = inner
        for part in path_:
            if not hasattr(node, part):
                node.add_module(part, _State())
            node = getattr(node, part)
        node.register_buffer(leaf, torch.from_numpy(np.array(value)))
    return _save(_Artifact(inner, mean, std), path)


def legacy_denoiser_state(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """LegacyDenoiser params (fused) -> the bundled model.pt's state-dict
    layout, the inverse of ``import_legacy_denoiser_state``."""
    sd: Dict[str, np.ndarray] = {}

    def emit(prefix, node):
        k = np.asarray(node["conv"]["kernel"], np.float32)
        sd[f"{prefix}.conv.weight"] = np.ascontiguousarray(k.transpose(3, 2, 0, 1))
        sd[f"{prefix}.conv.bias"] = np.asarray(node["conv"]["bias"], np.float32)

    emit("conv0.0", params["head"])
    depth = 0
    while f"res{depth}" in params:
        for k in range(2):
            emit(f"residual.{depth}.m.{k}", params[f"res{depth}"][f"conv{k}"])
        depth += 1
    emit("conv1", params["trunk_conv"])
    emit("conv2.0", params["tail"])
    return sd


# ------------------------------------------------------------------ tests --

MEAN, STD = (0.45, 0.44, 0.40), (0.23, 0.22, 0.21)


def _fused_params(family="sr", seed=0, **dims):
    """Seeded fused params at torch's default init (every bias non-zero)."""
    from image_super_resolution_tpu_torch.models.deploy import DeploySpec, init_fused_params

    return init_fused_params(DeploySpec(family=family, **dims), seed)


@pytest.mark.parametrize("scale,enchant", [(2, False), (4, False), (2, True)])
def test_sr_twin_matches_the_jax_generator(scale, enchant):
    """SRTwin under the reference names computes the JAX SRGenerator (fused,
    fp32) on the same weights, within 1e-5."""
    import jax
    import jax.numpy as jnp

    from image_super_resolution_tpu.interop import export_generator_state
    from image_super_resolution_tpu.models import SRGenerator

    params = _fused_params(depth=1, width=64, scale=scale, enchant=enchant)
    model = SRGenerator(depth=1, width=64, scale=scale, enchant=enchant, fused=True,
                        dtype=jnp.float32)
    twin = sr_twin(export_generator_state(params), enchant)
    x = np.random.default_rng(1).standard_normal((2, 12, 10, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = twin(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == (2, 3, 12 * scale, 10 * scale)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("enchant", [False, True])
def test_sr_artifact_has_the_reference_layout(enchant, tmp_path):
    """The saved file loads with torch.jit.load alone: its state dict is the
    given one under net.1, the Normalize buffers, and store_bn exactly on
    the trunk convs of a non-enchant generator; it maps uint8 NCHW to uint8
    NCHW through the twin's forward."""
    from image_super_resolution_tpu.interop import export_generator_state

    sd = export_generator_state(_fused_params(depth=1, width=64, scale=2, enchant=enchant))
    path = save_sr_artifact(tmp_path / "g.pt", sd, MEAN, STD, enchant)
    loaded = torch.jit.load(str(path), map_location="cpu")
    got = {k: v.numpy() for k, v in loaded.state_dict().items()}
    for k, v in sd.items():
        np.testing.assert_array_equal(got[f"net.1.{k}"], v)
    np.testing.assert_allclose(got["net.0.mean"].reshape(-1), MEAN, rtol=1e-7)
    store_bn = {k.split(".store_bn.")[0] for k in got if ".store_bn." in k}
    trunk = {k[len("net.1."):].rsplit(".conv.", 1)[0] for k in got
             if k.endswith(".conv.weight") and (".residual." in k or k.startswith("net.1.conv1"))}
    assert {s[len("net.1."):] for s in store_bn} == (set() if enchant else trunk)
    x = np.random.default_rng(2).integers(0, 256, (1, 3, 20, 18), dtype=np.uint8)
    with torch.no_grad():
        out = loaded(torch.from_numpy(x))
        twin = sr_twin(sd, enchant)(_Normalize(MEAN, STD)(torch.from_numpy(x)))
    assert out.dtype == torch.uint8 and tuple(out.shape) == (1, 3, 40, 36)
    assert torch.equal(out, _ToUint8()(twin))


def test_state_artifact_and_legacy_layout(tmp_path):
    """A state-only artifact keeps every buffer (and the store_bn marks) at
    its dotted name; legacy_denoiser_state inverts the JAX
    import_legacy_denoiser_state bit for bit."""
    import jax

    from image_super_resolution_tpu.interop import import_legacy_denoiser_state

    params = _fused_params("denoise_legacy", depth=2, width=8, hidden=4)
    sd = legacy_denoiser_state(params)
    back, cfg = import_legacy_denoiser_state(sd)
    assert cfg == {"depth": 2, "width": 8, "hidden": 4}
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))
    a, b = flat(back), flat(params)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    path = save_state_artifact(tmp_path / "d.pt", sd, MEAN, STD, store_bn=["conv1"])
    got = torch.jit.load(str(path), map_location="cpu").state_dict()
    assert set(got) == ({f"net.1.{k}" for k in sd} | {"net.0.mean", "net.0.std"}
                        | {f"net.1.conv1.store_bn.{n}" for n in
                           ("weight", "bias", "running_mean", "running_var")})
    for k, v in sd.items():
        np.testing.assert_array_equal(got[f"net.1.{k}"].numpy(), v)
