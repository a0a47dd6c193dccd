"""Transforms, pixel shuffle and activations of the port against the JAX
package, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_super_resolution_tpu.data.transforms import (
    normalize as jax_normalize,
    tanh_to_uint8 as jax_tanh_to_uint8,
)
from image_super_resolution_tpu.ops.activations import apply_act as jax_apply_act
from image_super_resolution_tpu.ops.activations import is_prelu as jax_is_prelu
from image_super_resolution_tpu.ops.pixel_shuffle import (
    pixel_shuffle as jax_pixel_shuffle,
    pixel_unshuffle as jax_pixel_unshuffle,
)
from image_super_resolution_tpu_torch.data.transforms import normalize, tanh_to_uint8
from image_super_resolution_tpu_torch.ops.activations import apply_act, is_prelu
from image_super_resolution_tpu_torch.ops.pixel_shuffle import (
    pixel_shuffle,
    pixel_unshuffle,
)
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)


def test_tanh_to_uint8_bit_exact_with_ties():
    """Random values plus every exact .5 tie of (x+1)/2*255 (x = (2k+1)/255
    - 1 lands on k + 0.5): both round half to even."""
    rng = np.random.default_rng(0)
    ties = (np.arange(255, dtype=np.float32) * 2 + 1) / 255.0 - 1.0
    x = np.concatenate([rng.uniform(-1.2, 1.2, 5000).astype(np.float32), ties,
                        np.float32([-1, 1, 0, -2, 2])])
    got = tanh_to_uint8(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_tanh_to_uint8(jnp.asarray(x)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    half = ((torch.from_numpy(ties) + 1.0) / 2.0 * 255.0).numpy()
    assert (half % 1 == 0.5).sum() > 100  # the ties really are ties


def test_normalize_matches_jax():
    x = np.random.default_rng(1).integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    mean, std = (0.4, 0.5, 0.6), (0.2, 0.25, 0.3)
    for kw in ({}, {"mean": mean, "std": std}):
        got = normalize(torch.from_numpy(x), **kw).numpy()
        want = np.asarray(jax_normalize(jnp.asarray(x), **kw))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_roundtrip_exact(r):
    x = np.random.default_rng(r).standard_normal((2, 4, 5, 3 * r * r)).astype(np.float32)
    got = pixel_shuffle(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pixel_shuffle(jnp.asarray(x), r)))
    back = pixel_unshuffle(torch.from_numpy(got), r).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jax_pixel_unshuffle(jnp.asarray(got), r)))
    np.testing.assert_array_equal(back, x)
    # torch's NCHW PixelShuffle is the same map
    nchw = torch.nn.functional.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), r)
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), got)


@pytest.mark.parametrize("act", [
    None, ("leaky_relu", 0.2), "leaky_relu", "relu", "tanh", "silu", "sigmoid",
    "gelu", "elu", "relu6", "hardswish", "hardsigmoid", "softsign", "softplus",
    "softmax", True,
])
def test_apply_act_matches_jax(act):
    spec = ("leaky_relu", 0.01) if act == "leaky_relu" else act
    x = np.random.default_rng(2).uniform(-6, 6, (2, 3, 4, 5)).astype(np.float32)
    got = apply_act(torch.from_numpy(x), spec).numpy()
    want = np.asarray(jax_apply_act(jnp.asarray(x), spec))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_apply_act_rejects_unknown_and_unported():
    """An unknown name raises; "prelu" is learnable, so as in the JAX
    package it is no plain activation (ConvBlock applies it as a module)."""
    with pytest.raises(ValueError):
        apply_act(torch.zeros(1), "swish2")
    for spec in ("prelu", ("prelu", 4)):
        with pytest.raises(ValueError):
            apply_act(torch.zeros(1), spec)
        with pytest.raises(ValueError):
            jax_apply_act(jnp.zeros(1), spec)
        assert is_prelu(spec) and jax_is_prelu(spec)
    assert not is_prelu(("leaky_relu", 0.2)) and not jax_is_prelu(("leaky_relu", 0.2))


@pytest.mark.parametrize("shape", [(23, 17, 3), (40, 64, 3), (9, 11)])
def test_png_codec_agrees_with_opencv(shape, tmp_path):
    """The fallback PNG codec reads what OpenCV writes (libpng picks its
    row filters adaptively, so all five get exercised on a smooth + noisy
    image) and OpenCV reads what it writes."""
    import cv2

    from image_super_resolution_tpu_torch.utils.png import read_png, write_png

    rng = np.random.default_rng(len(shape) * 10 + shape[0])
    ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1])).astype(np.uint8)
    img = ramp.reshape(*shape[:2], *(1,) * (len(shape) - 2)) + rng.integers(
        0, 8, shape, dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "cv.png"), img if img.ndim == 2 else img[..., ::-1])
    rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    np.testing.assert_array_equal(read_png(tmp_path / "cv.png"), rgb)
    write_png(tmp_path / "ours.png", rgb)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ours.png"))[..., ::-1], rgb)


@pytest.mark.parametrize("act", [("leaky_relu", 0.01), None])
def test_conv_block_bf16_bit_exact_with_jax(act):
    """ConvBlock in bf16 against the JAX ConvBlock in bf16, bit for bit.
    Small-integer inputs and weights make every product and every fp32 sum
    of the conv exact (|sum| <= 9 * 128 * 7 * 3), so the conv itself is the
    same number on both sides; its magnitudes (hundreds) are not all bf16
    values, and the biases k/256 have fractional bits, so rounding conv +
    bias once differs from rounding the conv and then adding the bias in
    bf16, which is what flax does (and the leaky slope is bf16(0.01))."""
    from image_super_resolution_tpu.ops.conv import ConvBlock as JaxConvBlock
    from image_super_resolution_tpu_torch.interop.from_jax import conv_kernel_to_torch
    from image_super_resolution_tpu_torch.ops.conv import ConvBlock

    rng = np.random.default_rng(12)
    cin = cout = 128
    x = rng.integers(-7, 8, (2, 12, 12, cin)).astype(np.float32)
    w = rng.integers(-3, 4, (3, 3, cin, cout)).astype(np.float32)
    b = (rng.integers(-255, 256, cout) / 256).astype(np.float32)
    jblock = JaxConvBlock(cout, 3, act=act, use_bn=False, dtype=jnp.bfloat16)
    want = jblock.apply({"params": {"conv": {"kernel": jnp.asarray(w),
                                             "bias": jnp.asarray(b)}}}, jnp.asarray(x))
    block = ConvBlock(cin, cout, 3, act=act, dtype=torch.bfloat16, device="cpu")
    block.conv.weight.data.copy_(torch.from_numpy(conv_kernel_to_torch(w)))
    block.conv.bias.data.copy_(torch.from_numpy(b))
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
