"""The eval CLI and what it computes, the port against the JAX package on
the CPU: the texture metrics, ``upscale`` and the general ``downscale``
against ``jax.image.resize``, and ``cli.evaluate.main`` of both packages on
one shared ``.isr`` and manifest."""

import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import image_super_resolution_tpu.native as jax_native
from image_super_resolution_tpu.cli import evaluate as jax_evaluate
from image_super_resolution_tpu.data import degrade as jax_degrade
from image_super_resolution_tpu.utils import metrics as jm
from image_super_resolution_tpu_torch import native as port_native
from image_super_resolution_tpu_torch.cli import evaluate
from image_super_resolution_tpu_torch.data import degrade
from image_super_resolution_tpu_torch.data.transforms import y_channel
from image_super_resolution_tpu_torch.models.deploy import (
    DeploySpec,
    init_fused_params,
    save_artifact,
)
from image_super_resolution_tpu_torch.utils import metrics
from image_super_resolution_tpu_torch.utils.png import write_png
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)


def _pair(seed=0, shape=(3, 40, 36, 3)):
    """An output/ground-truth pair with flat regions (exact gradient ties
    at 0) and a flat image."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    b[:, :20, :20] = 0.5
    a[0] = 0.25
    return a, b


# ----------------------------------------------------------- texture metrics --

@pytest.mark.parametrize("max_grad,bins", [(0.5, 32), (0.3, 7), (1.0, 100)])
def test_histogram_edges_equal_jnp_linspace_bit_for_bit(max_grad, bins):
    want = np.asarray(jnp.linspace(0.0, max_grad, bins + 1))
    got = metrics.histogram_edges(max_grad, bins, "cpu").numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gradient_histograms_equal_jnp_histogram(seed):
    """The same gradient magnitudes binned by both: equal counts (right-open
    bins, the last closed, values at max_grad in it); then the histograms of
    each package's own gradients, equal too."""
    a, b = _pair(seed)
    yb = jm.y_channel(jnp.asarray(b), 4) / 255.0
    g = np.clip(np.asarray(jm._grad_mag(yb)), 0, 0.5).ravel()
    g[:5] = [0.0, 0.5, 0.25, 0.5 / 32, 31 * 0.5 / 32]  # on edges
    edges = jnp.linspace(0.0, 0.5, 33)
    want = np.asarray(jnp.histogram(jnp.asarray(g), bins=edges)[0]).astype(np.int64)
    got = metrics._histogram(torch.from_numpy(g), metrics.histogram_edges(0.5, 32, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    ours = torch.clamp(metrics._grad_mag(y_channel(torch.from_numpy(b), 4) / 255.0), 0, 0.5)
    got = metrics._histogram(ours.reshape(-1), metrics.histogram_edges(0.5, 32, "cpu"))
    want = np.asarray(jnp.histogram(jnp.asarray(np.clip(np.asarray(jm._grad_mag(yb)), 0, 0.5)
                                                .ravel()), bins=edges)[0])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["sharpness", "hf_energy_ratio", "gradient_hist_distance",
                                  "psnr_y_per_image"])
def test_texture_metric_matches_jax(name, seed):
    """Within 1e-6 relative (measured: 0 for grad_dist, 5.4e-7 for the
    hf ratio, 2.9e-7 for per-image PSNR-Y, whose means sum in another
    order)."""
    a, b = _pair(seed)
    args = (a,) if name == "sharpness" else (a, b)
    want = np.asarray(getattr(jm, name)(*map(jnp.asarray, args)))
    got = getattr(metrics, name)(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ------------------------------------------------------------------- resize --

def _x01(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 24, 20, 3), (2, 48, 40, 3), (1, 25, 37, 3)])
@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("method,antialias", [("bilinear", False), ("bilinear", True),
                                              ("bicubic", False), ("bicubic", True)])
def test_downscale_matches_jax_image_resize(shape, scale, method, antialias):
    """Every downscale mode, sizes divisible by the factor or not (the
    general path): within 1e-6 of ``jax.image.resize`` (measured 6.6e-7;
    torch's own bicubic without antialias is 0.1 off, so the port builds
    the weights itself)."""
    x = _x01(shape, scale)
    want = np.asarray(jax_degrade.downscale(jnp.asarray(x), scale, method, antialias))
    got = degrade.downscale(torch.from_numpy(x), scale, method, antialias).numpy()
    assert got.shape == want.shape == (shape[0], shape[1] // scale, shape[2] // scale, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 24, 20, 3), (2, 48, 40, 3), (1, 25, 37, 3)])
@pytest.mark.parametrize("scale", [2, 3, 4])
def test_upscale_matches_jax_image_resize(shape, scale):
    """Bicubic x2/x4 within 5e-7 of ``jax.image.resize`` (measured 2.4e-7).
    At x3 the weights are not dyadic and JAX's einsum lies 1.6e-6 from a
    float64 product of its own weights, so x3 is held within 2e-6 of JAX
    (measured 1.5e-6) and within 5e-7 of that float64 product (measured
    1.9e-7)."""
    x = _x01(shape, scale)
    n, h, w, c = shape
    want = np.asarray(jax_degrade.upscale(jnp.asarray(x), scale))
    got = degrade.upscale(torch.from_numpy(x), scale).numpy()
    assert got.shape == want.shape == (n, h * scale, w * scale, c)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 if scale == 3 else 5e-7)
    wh = degrade.resize_weights(h, h * scale, "bicubic", False).double().numpy()
    ww = degrade.resize_weights(w, w * scale, "bicubic", False).double().numpy()
    exact = np.einsum("nhwc,hu,wv->nuvc", x.astype(np.float64), wh, ww)
    np.testing.assert_allclose(got, exact, rtol=0, atol=5e-7)


def test_resize_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="unknown resize method"):
        degrade.downscale(torch.zeros(1, 8, 8, 3), 2, "lanczos3")


# ----------------------------------------------------------------- eval CLI --

@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    """Six smooth, slightly noisy 64x64 PNGs and their manifest."""
    tmp = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:64, 0:64] / 64
    paths = []
    for i in range(6):
        img = np.zeros((64, 64, 3))
        for _ in range(3):
            fy, fx, ph = rng.uniform(1, 8), rng.uniform(1, 8), rng.uniform(0, 6.3, 3)
            img += np.sin(2 * np.pi * (fy * yy + fx * xx)[..., None] + ph) * rng.uniform(10, 40)
        img += rng.normal(0, 6, img.shape)
        p = tmp / f"{i}.png"
        write_png(p, np.clip(img + 128, 0, 255).astype(np.uint8))
        paths.append(str(p))
    m = tmp / "val.json"
    m.write_text(json.dumps(paths))
    return tmp, m


def _artifact(tmp, name, seed=3, **kw):
    spec = DeploySpec(**kw)
    path = tmp / f"{name}.isr"
    save_artifact(path, spec, init_fused_params(spec, seed))
    return path


# Tolerances of the CLIs' keys, both in bf16 (the CLI's dtype) on the same
# crops: the two bf16 graphs round differently (sr: within 1 LSB on 1.6-1.8%
# of values), which moves the model's metrics a little; the baseline and the
# HR-only keys see no model and differ only by the 4-decimal rounding.
# Measured on this set: PSNR/PSNR-Y 0.0016 dB, per-image PSNR-Y 0.0052 dB,
# SSIM 3e-4, grad_dist 1.5e-3, sharpness and hf_ratio 1e-4.
EVAL_ATOL = {"psnr": 0.02, "psnr_y": 0.02, "psnr_y_min": 0.03, "psnr_y_max": 0.03,
             "psnr_y_median": 0.03, "psnr_y_std": 0.03, "ssim": 2e-3, "grad_dist": 6e-3,
             "hf_ratio": 2e-3, "sharpness": 2e-3}
EXACT_KEYS = ("n_images", "n_batches", "hr_crop", "scale")


@pytest.mark.parametrize("name,kw,extra", [
    ("sr_x2", dict(family="sr", depth=1, width=8, scale=2), []),
    ("fast_x4", dict(family="fast", depth=2, width=8, scale=4), []),
    ("fast_x4_int8", dict(family="fast", depth=2, width=8, scale=4), ["--int8"]),
    ("sr_x2_defaults", dict(family="sr", depth=1, width=8, scale=2), []),
])
def test_eval_cli_matches_jax_key_by_key(val_set, name, kw, extra, monkeypatch, capsys):
    """Both CLIs on one .isr and manifest: the same keys; the counts equal;
    every other key within EVAL_ATOL, or 2e-4 where the model is not
    involved (bicubic_* and sharpness_hr). Both loaders are held to their
    Python backend, but in ``sr_x2_defaults``, where each CLI runs at its
    defaults (``auto``: the C++ loader, which builds here) and the two must
    still score the same crops."""
    tmp, m = val_set
    if name != "sr_x2_defaults":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(port_native, "available", lambda: False)
    isr = _artifact(tmp, name, **kw)
    argv = ["--model", str(isr), "--val_json", str(m), "--shape", "32", "--batch_size", "2",
            *extra]
    want = jax_evaluate.main(argv)
    got = evaluate.main(argv + ["--device", "cpu", "--json_out", str(tmp / f"{name}.json")])
    assert list(got) == list(want)
    assert json.loads((tmp / f"{name}.json").read_text()) == got
    assert got["n_images"] == 6 and got["n_batches"] == 3
    for k in got:
        if k in EXACT_KEYS:
            assert got[k] == want[k], k
        else:
            assert abs(got[k] - want[k]) <= EVAL_ATOL.get(k, 2e-4), (k, got[k], want[k])
    backend = "python" if name != "sr_x2_defaults" else "native"
    assert capsys.readouterr().out.count(f"PatchLoader backend: {backend}\n") == 2


@pytest.fixture(scope="module")
def denoiser(val_set):
    tmp, _ = val_set
    return _artifact(tmp, "denoise", seed=5, family="denoise", depth=2, width=8)


def test_denoise_eval_keys_and_severity_order(val_set, denoiser):
    """--denoise_eval on an x1 artifact: the noisy_* baseline keys, every
    value finite, and the noisy input's PSNR falling light > default > heavy
    (the noise differs from the JAX CLI's stream, so these are its checks)."""
    _, m = val_set
    base = ["--model", str(denoiser), "--val_json", str(m), "--shape", "32",
            "--batch_size", "2", "--device", "cpu", "--denoise_eval"]
    res = {sev: evaluate.main(base + ["--severity", sev])
           for sev in ("light", "default", "heavy")}
    for r in res.values():
        assert {"noisy_psnr", "noisy_psnr_y", "noisy_hf_ratio", "psnr", "ssim",
                "grad_dist", "hf_ratio", "psnr_y_std"} <= set(r)
        assert not any(k.startswith("bicubic") for k in r)
        assert all(math.isfinite(v) for v in r.values())
        assert r["scale"] == 1 and r["n_images"] == 6
    assert (res["light"]["noisy_psnr"] > res["default"]["noisy_psnr"]
            > res["heavy"]["noisy_psnr"])
    plain = evaluate.main(base[:-1])
    assert "bicubic_psnr" in plain  # no --denoise_eval: the clean input, a bicubic key


@pytest.mark.parametrize("argv,match", [
    (["--data_devices", "3"], "must be divisible by --data_devices 3"),
    (["--denoise_eval"], "needs an x1 artifact"),
    (["--int8"], "fast families only"),
])
def test_eval_cli_refusals(val_set, argv, match):
    tmp, m = val_set
    isr = _artifact(tmp, "sr_refuse", family="sr", depth=1, width=8, scale=2)
    with pytest.raises(SystemExit, match=match):
        evaluate.main(["--model", str(isr), "--val_json", str(m), "--shape", "32",
                       "--batch_size", "2", "--device", "cpu", *argv])


def test_eval_cli_defaults_to_cuda(val_set, monkeypatch):
    tmp, m = val_set
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    isr = _artifact(tmp, "sr_cuda", family="sr", depth=1, width=8, scale=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(["--model", str(isr), "--val_json", str(m)])
