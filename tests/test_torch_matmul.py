"""K2's plain versions against the JAX package on the CPU: the GEMM against
the Pallas kernel ``pallas_matmul`` (run in interpret mode), and the int8
3x3 conv site against the JAX int8 conv and its epilogue. The CUDA kernel
itself is checked against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from image_super_resolution_tpu.models.quantized import _conv as jax_conv
from image_super_resolution_tpu_torch.models.fast import scale_residual
from image_super_resolution_tpu_torch.ops.kernels.matmul import (
    MAX_CHUNK,
    N_TILE,
    RECT_H,
    RECT_W,
    bind_conv,
    conv3x3_int8,
    conv3x3_int8_accumulators,
    conv3x3_int8_reference,
    conv_epilogues,
    conv_plan,
    conv_variant,
    matmul,
    matmul_reference,
    requantize,
    weights_k_major,
)
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

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


def _torch_site(b, h, w, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x8 = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (9 * cin, cout), dtype=np.int8))
    deq = torch.from_numpy(rng.uniform(1e-4, 1e-3, cout).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, cout).astype(np.float32))
    return x8, w_q, deq, bias


@pytest.mark.parametrize("leaky", [True, False])
def test_conv3x3_int8_int8_output_is_the_requantized_fp32_output(leaky):
    """out_inv_x: the site's fp32 output requantized with that scale, which
    is what the next site would do on load (the conv0 -> conv1 hand-off);
    checked through the CPU wrapper, fed an fp32 stream with its scale."""
    x8, w_q, deq, bias = _torch_site(2, 7, 9, 64, 48, seed=11)
    h = torch.from_numpy(np.random.default_rng(12).standard_normal((2, 7, 9, 64),
                                                                   dtype=np.float32) * 30)
    y = conv3x3_int8_reference(h, w_q, deq, bias, leaky, inv_x=0.25)
    for out_inv_x in (0.37, 40.0):  # the second puts some outputs past +-127
        got = conv3x3_int8(h, w_q, deq, bias, leaky, inv_x=0.25, out_inv_x=out_inv_x)
        assert got.dtype == torch.int8
        assert torch.equal(got, requantize(y, out_inv_x))
    assert 0 < int((got.abs() == 127).sum()) < got.numel()


@pytest.mark.parametrize("out_inv_x", [None, 0.5])
def test_conv3x3_int8_int8_input_equals_fp32_input_at_scale_one(out_inv_x):
    """int8 x with inv_x=None is taken as it is: the same as its values fed
    as the fp32 stream with scale 1."""
    x8, w_q, deq, bias = _torch_site(1, 5, 11, 32, 40, seed=13)
    got = conv3x3_int8(x8, w_q, deq, bias, True, None, out_inv_x)
    want = conv3x3_int8(x8.float(), w_q, deq, bias, True, 1.0, out_inv_x)
    assert got.dtype == want.dtype == (torch.float32 if out_inv_x is None else torch.int8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rate", [0.2, 1.0])
@pytest.mark.parametrize("out", ["fp32", "int8", "both"])
@pytest.mark.parametrize("residual", [True, False])
def test_conv3x3_int8_residual_epilogue_is_the_unfused_composition(residual, out, rate):
    """With ``res`` the epilogue finishes the residual block: its fp32
    output is ``res + scale_residual(y, rate)`` of the site's output ``y``
    without it, bit for bit (two rounded ops, as the torch ops that the
    int8 forward ran before), and its int8 output that sum requantized with
    out_inv_x, what the next site would do on load; with ``keep_fp32`` both
    at once. Through the plain version and the CPU wrapper, an int8 input
    (a conv1 site) and an fp32 one (``trunk_conv`` without a hand-off)."""
    x8, w_q, deq, bias = _torch_site(2, 7, 9, 64, 48, seed=21)
    rng = np.random.default_rng(22)
    res = torch.from_numpy(rng.standard_normal((2, 7, 9, 48), dtype=np.float32) * 3)
    out_inv_x = None if out == "fp32" else 30.0  # some of the sums past +-127 steps
    kw = dict(out_inv_x=out_inv_x, keep_fp32=out == "both")
    if residual:
        kw.update(res=res, rate=rate)
    for x, inv_x in ((x8, None), (x8.float() * 0.5, 2.0)):
        y = conv3x3_int8_reference(x, w_q, deq, bias, False, inv_x)
        h = res + scale_residual(y, rate) if residual else y
        want = {"fp32": h, "int8": requantize(h, 30.0), "both": (h, requantize(h, 30.0))}[out]
        for fn in (conv3x3_int8_reference, conv3x3_int8):
            got = fn(x, w_q, deq, bias, False, inv_x, **kw)
            if out == "both":
                assert isinstance(got, tuple) and len(got) == 2
                assert got[0].dtype == torch.float32 and got[1].dtype == torch.int8
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            else:
                assert got.dtype == want.dtype and torch.equal(got, want)
    if out != "fp32":
        q = want[1] if out == "both" else want
        assert 0 < int((q.abs() == 127).sum()) < q.numel()


def test_conv3x3_int8_keep_fp32_needs_an_int8_output():
    x8, w_q, deq, bias = _torch_site(1, 2, 2, 32, 8, seed=23)
    with pytest.raises(ValueError, match="keep_fp32"):
        conv3x3_int8(x8, w_q, deq, bias, False, keep_fp32=True)


def test_conv3x3_int8_refuses_mixed_input_and_scale():
    x8, w_q, deq, bias = _torch_site(1, 2, 2, 32, 8, seed=14)
    with pytest.raises(TypeError, match="inv_x"):
        conv3x3_int8(x8, w_q, deq, bias, False, inv_x=0.5)
    with pytest.raises(TypeError, match="inv_x"):
        conv3x3_int8(x8.float(), w_q, deq, bias, False)


@pytest.mark.parametrize("cin,cout", [(32, 8), (128, 128), (64, 130)])
def test_weights_k_major_round_trip(cin, cout):
    """The kernel's K-major copy: (Npad, 9 Cin), Npad = Cout rounded up to
    N_TILE; its first Cout rows transposed back give w_q, and the padded
    rows are zero, so the outputs they produce are zero."""
    x8, w_q, _, _ = _torch_site(1, 4, 5, cin, cout, seed=cin + cout)
    w_k = weights_k_major(w_q)
    npad = -(-cout // N_TILE) * N_TILE
    assert w_k.dtype == torch.int8 and tuple(w_k.shape) == (npad, 9 * cin)
    assert w_k.is_contiguous()
    assert torch.equal(w_k[:cout].t(), w_q)
    acc = conv3x3_int8_accumulators(x8, w_k.t())
    assert torch.equal(acc[..., :cout], conv3x3_int8_accumulators(x8, w_q))
    assert not acc[..., cout:].any()


@pytest.mark.parametrize("shape,sms,want", [
    ((256, 24, 24, 128, 128), 132,  # fast x4 serving: 768 rectangles, one block per SM
     dict(cc=128, chunks=1, rects_h=1, rects_w=3, rects=768, n_tiles=1, grid_x=132)),
    ((2, 48, 48, 128, 128), 132,  # denoise_fast t96 after the downshuffle
     dict(cc=128, chunks=1, rects_h=2, rects_w=6, rects=24, n_tiles=1, grid_x=24)),
    ((1, 93, 93, 128, 128), 132,  # a ragged CLI tile
     dict(cc=128, chunks=1, rects_h=4, rects_w=12, rects=48, n_tiles=1, grid_x=48)),
    ((1, 1, 1, 32, 8), 132, dict(cc=32, chunks=1, rects_h=1, rects_w=1, rects=1, n_tiles=1,
                                 grid_x=1)),
    ((1, 5, 3, 64, 130), 132, dict(cc=64, chunks=1, rects_h=1, rects_w=1, rects=1, n_tiles=2,
                                   grid_x=1)),
    ((4, 30, 40, 160, 256), 132,  # K chunks of 32; two N tiles share the SMs
     dict(cc=32, chunks=5, rects_h=2, rects_w=5, rects=40, n_tiles=2, grid_x=40)),
    ((1, 24, 24, 192, 128), 132, dict(cc=96, chunks=2, rects_h=1, rects_w=3, rects=3,
                                      n_tiles=1, grid_x=3)),
    ((8, 24, 24, 256, 64), 10, dict(cc=128, chunks=2, rects_h=1, rects_w=3, rects=24,
                                    n_tiles=1, grid_x=10)),
])
def test_conv_plan(shape, sms, want):
    assert conv_plan(*shape, sms) == want


def test_conv_plan_refuses_cin_not_a_multiple_of_32():
    with pytest.raises(ValueError, match="multiple of 32"):
        conv_plan(1, 8, 8, 48, 64, 132)


def _emulate_kernel(x8, w_k, cout, plan):
    """The conv kernel's walk in int64 numpy, indexed as csrc/matmul.cu
    indexes: per N tile, each of grid_x blocks takes rectangles grid_x
    apart; a rectangle's (RECT_H + 2) x (RECT_W + 2) halo patch (zeros
    outside the image), summed over K chunks of cc channels and the nine
    taps against w_k[n, tap * Cin + c0 + c]; the ragged edge is dropped.
    Also returns how often each output pixel was written."""
    b, h, w, cin = x8.shape
    cc = plan["cc"]
    xp = np.zeros((b, plan["rects_h"] * RECT_H + 2, plan["rects_w"] * RECT_W + 2, cin),
                  np.int64)
    xp[:, 1:h + 1, 1:w + 1] = x8.numpy()
    wk = w_k.numpy().astype(np.int64)
    out = np.zeros((b, h, w, plan["n_tiles"] * N_TILE), np.int64)
    written = np.zeros((b, h, w), int)
    for nt in range(plan["n_tiles"]):
        for bx in range(plan["grid_x"]):
            for r in range(bx, plan["rects"], plan["grid_x"]):
                w0 = (r % plan["rects_w"]) * RECT_W
                h0 = (r // plan["rects_w"] % plan["rects_h"]) * RECT_H
                img = r // (plan["rects_w"] * plan["rects_h"])
                patch = xp[img, h0:h0 + RECT_H + 2, w0:w0 + RECT_W + 2]
                acc = np.zeros((RECT_H, RECT_W, N_TILE), np.int64)
                for ch in range(plan["chunks"]):
                    c0 = ch * cc
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        a = patch[dy:dy + RECT_H, dx:dx + RECT_W, c0:c0 + cc]
                        wt = wk[nt * N_TILE:(nt + 1) * N_TILE,
                                tap * cin + c0:tap * cin + c0 + cc]
                        acc += a @ wt.T
                hh, ww = min(RECT_H, h - h0), min(RECT_W, w - w0)
                out[img, h0:h0 + hh, w0:w0 + ww, nt * N_TILE:(nt + 1) * N_TILE] = \
                    acc[:hh, :ww]
                if nt == 0:
                    written[img, h0:h0 + hh, w0:w0 + ww] += 1
    return out[..., :cout], written


@pytest.mark.parametrize("shape,sms", [((2, 17, 29, 64, 40), 5), ((1, 9, 20, 160, 130), 3),
                                       ((3, 24, 24, 128, 128), 4)])
def test_conv_plan_emulation_covers_every_pixel_once(shape, sms):
    """The plan, walked as the kernel walks it (rectangles, K chunks, the
    K-major weights), writes every output pixel exactly once with the exact
    int32 sums of the plain version: ragged rectangles, K chunks (Cin 160)
    and two N tiles (Cout 130)."""
    b, h, w, cin, cout = shape
    x8, w_q, _, _ = _torch_site(b, h, w, cin, cout, seed=sum(shape))
    plan = conv_plan(b, h, w, cin, cout, sms)
    got, written = _emulate_kernel(x8, weights_k_major(w_q), cout, plan)
    assert (written == 1).all()
    np.testing.assert_array_equal(got, conv3x3_int8_accumulators(x8, w_q).numpy())


class _StandInLibrary:
    """Stands in for the built ctypes library on the CPU: every function
    returns 0, and isr_conv3x3_int8_tiling reports ``tiling``."""

    def __init__(self, tiling):
        self.tiling = tiling

    def __getattr__(self, name):
        def fn(*args):
            if name == "isr_conv3x3_int8_tiling":
                for i, v in enumerate(self.tiling):
                    args[0][i] = v
            return 0

        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("tiling,takes", [((RECT_H, RECT_W, N_TILE, MAX_CHUNK), True),
                                          ((16, RECT_W, N_TILE, MAX_CHUNK), False),
                                          ((RECT_H, RECT_W, 64, MAX_CHUNK), False)])
def test_library_refuses_a_build_of_another_tiling(monkeypatch, tiling, takes):
    """The launch plan's constants are read back from the built library
    (isr_conv3x3_int8_tiling: RH, RW, NT, MAX_CC) when it is loaded; a
    library built with another tiling is refused before its first launch."""
    from image_super_resolution_tpu_torch.ops.kernels import _build
    from image_super_resolution_tpu_torch.ops.kernels import matmul as k2

    monkeypatch.setattr(_build, "load", lambda name: _StandInLibrary(tiling))
    k2._library.cache_clear()
    try:
        if takes:
            lib = k2._library()
            assert bind_conv(lib) == tiling
            assert lib.isr_conv3x3_int8.argtypes[-3:] == [ctypes.c_int, ctypes.c_int,
                                                          ctypes.c_void_p]
        else:
            with pytest.raises(RuntimeError, match="tiling"):
                k2._library()
    finally:
        k2._library.cache_clear()


@pytest.mark.parametrize("x_dtype,out_dtype,want", [
    (torch.float32, torch.float32, "fp32 -> fp32"), (torch.float32, torch.int8, "fp32 -> int8"),
    (torch.int8, torch.float32, "int8 -> fp32"), (torch.int8, torch.int8, "int8 -> int8")])
def test_conv_variant_names(x_dtype, out_dtype, want):
    assert conv_variant(x_dtype, out_dtype) == want


@pytest.mark.parametrize("residual,int8_out,want", [
    (False, False, ()), (False, True, ()), (True, False, ("residual",)),
    (True, True, ("residual", "int8 copy"))])
def test_conv_epilogue_names(residual, int8_out, want):
    """What launches_by_epilogue counts a launch under: a residual, and an
    int8 copy of the residual sum for the next site."""
    assert conv_epilogues(residual, int8_out) == want
