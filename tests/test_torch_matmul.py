"""K2's plain versions against the JAX package on the CPU: the GEMM against
the Pallas kernel ``pallas_matmul`` (run in interpret mode), and the int8
3x3 conv site against the JAX int8 conv and its epilogue. The CUDA kernel
itself is checked against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from image_super_resolution_tpu.models.quantized import _conv as jax_conv
from image_super_resolution_tpu_torch.ops.kernels.matmul import (
    conv3x3_int8,
    conv3x3_int8_accumulators,
    conv3x3_int8_reference,
    matmul,
    matmul_reference,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pallas_matmul():
    spec = importlib.util.spec_from_file_location(
        "bench_int8_pallas", ROOT / "scripts" / "bench_int8_pallas.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.pallas_matmul


def test_matmul_int8_exact_against_pallas(pallas_matmul):
    """int8 (256, 1152) x (1152, 128), the trunk conv's K and N: the plain
    version equals the Pallas kernel (interpret mode) bit for bit."""
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, (256, 1152), dtype=np.int8)
    b = rng.integers(-127, 128, (1152, 128), dtype=np.int8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_matmul(jnp.asarray(a), jnp.asarray(b),
                                        tm=128, tk=384, tn=128))
    got = matmul_reference(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    np.testing.assert_array_equal(matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  want)


def test_matmul_bf16_against_pallas(pallas_matmul):
    """bf16 (256, 512) x (512, 128): the Pallas kernel sums in fp32, the
    plain version in float64; they agree within 1e-5 relative (measured
    1.04e-5 absolute at values of order 20)."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((256, 512), np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((512, 128), np.float32)).to(torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_matmul(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                                        jnp.asarray(b.float().numpy(), jnp.bfloat16),
                                        tm=128, tk=256, tn=128))
    got = matmul_reference(a, b)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _site(width, hw, seed):
    rng = np.random.default_rng(seed)
    x8 = rng.integers(-127, 128, (2, *hw, width), dtype=np.int8)
    w_q = rng.integers(-127, 128, (3, 3, width, width), dtype=np.int8)
    deq = (rng.uniform(1e-4, 1e-3, width)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, width).astype(np.float32)
    return x8, w_q, deq, bias


@pytest.mark.parametrize("width,hw", [(128, (7, 9)), (16, (5, 11))])
def test_conv3x3_int8_accumulators_exact(width, hw):
    """The int32 sums of the plain int8 conv equal the JAX int8 conv
    (``preferred_element_type=int32``) exactly, on an odd spatial size
    (zero padding at every border)."""
    x8, w_q, _, _ = _site(width, hw, seed=width)
    # an interior pixel with every tap at 127 against a column of 127s (one
    # 126): 9 * Cin * 127^2 - 127 is odd and, at Cin 128, above 2^24
    x8[0] = 127
    w_q[..., 1] = 127
    w_q[0, 0, 0, 1] = 126
    want = np.asarray(jax_conv(jnp.asarray(x8), jnp.asarray(w_q), preferred=jnp.int32))
    got = conv3x3_int8_accumulators(torch.from_numpy(x8),
                                    torch.from_numpy(w_q.reshape(9 * width, width)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    peak = 9 * width * 127 * 127 - 127
    assert want[0, 1, 1, 1] == peak
    if width == 128:  # not an fp32 value: fp32 sums could not be exact
        assert peak > 2 ** 24 and float(np.float32(peak)) != peak


@pytest.mark.parametrize("leaky", [True, False])
def test_conv3x3_int8_epilogue_matches_jax(leaky):
    """After the epilogue (``float(acc) * deq + bias``, leaky on conv0
    sites), the plain version matches the JAX int8 site
    (``models/quantized.py`` ``int8_forward``'s ``quant``) within 1 fp32
    ulp; the CPU wrapper is the plain version, fed the same int8 values as
    an fp32 stream with scale 1 (requantization leaves them unchanged)."""
    width = 128
    x8, w_q, deq, bias = _site(width, (5, 7), seed=3)
    y = jax_conv(jnp.asarray(x8), jnp.asarray(w_q), preferred=jnp.int32)
    y = y.astype(jnp.float32) * jnp.asarray(deq) + jnp.asarray(bias)
    if leaky:
        y = jax.nn.leaky_relu(y, negative_slope=0.01)
    want = np.asarray(y)
    args = (torch.from_numpy(x8), torch.from_numpy(w_q.reshape(9 * width, width)),
            torch.from_numpy(deq), torch.from_numpy(bias))
    got = conv3x3_int8_reference(*args, leaky=leaky).numpy()
    assert got.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    stream = (args[0].float(), *args[1:])
    np.testing.assert_array_equal(conv3x3_int8(*stream, leaky=leaky, inv_x=1.0).numpy(), got)


def test_wrappers_refuse_other_devices():
    a = torch.zeros(4, 32, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        matmul(a, a.t())
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3_int8(torch.zeros(1, 2, 2, 32, device="meta"), a, a, a, leaky=False,
                     inv_x=1.0)
