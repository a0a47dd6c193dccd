"""The fused RDB kernel's plain version and launch plan against the JAX package.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py); here its plain version, which the wrapper takes for CPU
tensors, is held against the Pallas kernel in interpret mode and against
the JAX ScatterRDB and RDB, and a float64 emulation of the kernel's dense
form, driven by the same launch plan the kernel is given, is held against
both.
"""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from image_super_resolution_tpu.ops.blocks import RDB as JaxRDB
from image_super_resolution_tpu.ops.pallas.fused_rdb import (
    scatter_params_to_matmul as jax_scatter_params_to_matmul,
    scatter_rdb_pallas,
)
from image_super_resolution_tpu.ops.scatter import (
    ScatterRDB as JaxScatterRDB,
    rdb_params_to_scatter as jax_rdb_params_to_scatter,
)
from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import (
    COUTS,
    KERNEL_ATOL,
    KERNEL_RTOL,
    MAX_GROUPS,
    RECT,
    _plan_ints,
    dense_plan,
    scatter_params_to_matmul,
    scatter_rdb,
    scatter_rdb_reference,
    tile_schedule,
)
from image_super_resolution_tpu_torch.ops.kernels import _build
from image_super_resolution_tpu_torch.ops.kernels import fused_rdb as k1
from image_super_resolution_tpu_torch.ops.scatter import (
    ScatterRDB,
    rdb_params_to_scatter,
)
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

C, G = 64, 32  # the kernel's real widths


@pytest.fixture(scope="module")
def rdb_case():
    """Standard RDB params (JAX init) and an input tile batch B=4, T=8."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 8, 8, C)) * 0.5).astype(np.float32)
    rdb = JaxRDB(growth=G, act=("leaky_relu", 0.01), add_rate=0.2,
                 use_bn=False, dtype=jnp.float32)
    params = rdb.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    want = np.asarray(rdb.apply({"params": params}, jnp.asarray(x)))
    return x, params, want


def test_rdb_params_to_scatter_matches_jax(rdb_case):
    _, params, _ = rdb_case
    ours = rdb_params_to_scatter(params)
    theirs = jax_rdb_params_to_scatter(params)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))


def test_scatter_params_to_matmul_matches_jax(rdb_case):
    _, params, _ = rdb_case
    scatter = rdb_params_to_scatter(params)
    ours = scatter_params_to_matmul(scatter)
    theirs = jax_scatter_params_to_matmul(jax_rdb_params_to_scatter(params))
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    assert ours[0].dtype == torch.bfloat16 and ours[-1].dtype == torch.float32


def test_reference_bf16_matches_pallas_kernel(rdb_case):
    """bf16 inputs at the real widths: the plain version rounds where the
    Pallas kernel rounds (each y_i and the output) and keeps fp32 sums in
    between; only the order of the fp32 sums inside each conv may differ.
    Such a difference can flip a bf16 rounding of some y_i, which moves the
    output by about one bf16 ulp of a unit-scale value: allow 2^-5 + 2^-7|x|
    (a few bf16 ulps), the tolerance the card's check uses too."""
    x, params, _ = rdb_case
    jax_scatter = jax_rdb_params_to_scatter(params)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = scatter_rdb_pallas(
            x16, *jax_scatter_params_to_matmul(jax_scatter), tiles_per_block=2)
    want = np.asarray(want, np.float32)
    xt = torch.from_numpy(np.array(x16.astype(jnp.float32))).to(torch.bfloat16)
    got = scatter_rdb_reference(xt, *scatter_params_to_matmul(rdb_params_to_scatter(params)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    # Rounding in the same places: measured bit-identical here, while a
    # version that skips the bf16 rounding of each y_i differs on 3% of the
    # outputs (by one ulp, inside the tolerance above).
    assert (got.float().numpy() != want).mean() < 0.01


def test_reference_fp32_matches_jax_scatter_and_rdb(rdb_case):
    """In fp32 the plain version is the JAX ScatterRDB (same sums, another
    conv implementation: rtol/atol 1e-5) and the standard RDB up to
    reassociation (1e-5 too, as tests/test_optimized.py holds them)."""
    x, params, want_rdb = rdb_case
    jax_scatter = jax_rdb_params_to_scatter(params)
    want = np.asarray(JaxScatterRDB(features=C, dtype=jnp.float32).apply(
        {"params": jax_scatter}, jnp.asarray(x)))
    mats = scatter_params_to_matmul(rdb_params_to_scatter(params), torch.float32)
    got = scatter_rdb_reference(torch.from_numpy(x), *mats).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_rdb, rtol=1e-5, atol=1e-5)


def test_scatter_rdb_module_on_cpu_takes_plain_version(rdb_case):
    """ScatterRDB on a CPU tensor runs the plain version, not the kernel:
    the launch count stays where it was."""
    x, params, want = rdb_case
    mod = ScatterRDB(C, dtype=torch.float32, device="cpu")
    names = ("sx", "s0", "s1", "s2", "s3", "bias")
    mats = scatter_params_to_matmul(rdb_params_to_scatter(params), torch.float32)
    mod.load_state_dict(dict(zip(names, mats)))
    before = scatter_rdb.launches
    got = mod(torch.from_numpy(x)).numpy()
    assert scatter_rdb.launches == before == 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,w", [(1, 1, 1), (3, 5, 9)])
def test_reference_ragged_shapes(b, h, w):
    """Any batch and any H, W (whole-image mode sends non-square images);
    the plain version keeps the shape and zero-pads at the border, so a
    1x1 image sees only the centre taps."""
    rng = np.random.default_rng(b * 100 + h)
    x = torch.from_numpy(rng.standard_normal((b, h, w, C)).astype(np.float32))
    shapes = [(9 * C, 4 * G + C), (9 * G, 3 * G + C), (9 * G, 2 * G + C),
              (9 * G, G + C), (9 * G, C)]
    mats = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.05)
            for s in shapes]
    bias = torch.zeros(1, 4 * G + C)
    out = scatter_rdb_reference(x, *mats, bias)
    assert out.shape == x.shape and torch.isfinite(out).all()
    if h == w == 1:  # only tap (1, 1), rows [4*Cin, 5*Cin), reaches the pixel
        centre = [m[4 * m.shape[0] // 9:5 * m.shape[0] // 9] for m in mats]
        zeroed = [torch.zeros_like(m) for m in mats]
        for z, m, c in zip(zeroed, mats, centre):
            z[4 * m.shape[0] // 9:5 * m.shape[0] // 9] = c
        torch.testing.assert_close(scatter_rdb_reference(x, *zeroed, bias), out)


# ------------------------------------------------- the kernel's launch plan --

def emulate_dense(x, mats, add_rate=0.2, slope=0.01, round_to=None, plan=None):
    """float64 emulation of the CUDA kernel: each launch of ``dense_plan``
    sums its source groups in the plan's order, each through the weight
    rows and columns the kernel reads, then adds the bias; y_i and the
    output are rounded to ``round_to`` where the kernel rounds (not at all
    for None). x NHWC; mats = (sx, s0..s3, bias)."""
    x = x.double()
    weights = [m.double() for m in mats[:5]]
    bias = mats[5].double().reshape(-1)
    b, h, w, _ = x.shape
    y = torch.full((b, h, w, 4 * G), float("nan"), dtype=torch.float64)
    sources = {"x": x, "y": y}

    def rnd(v):
        return v if round_to is None else v.to(round_to).double()

    out = None
    for launch in plan or dense_plan():
        n = launch["n"]
        acc = torch.zeros(b, h, w, n, dtype=torch.float64)
        for src, c0, wi, wc0, col0 in launch["groups"]:
            cin = weights[wi].shape[0] // 9
            rows = [tap * cin + wc0 + c for tap in range(9) for c in range(G)]
            k = weights[wi][rows][:, col0:col0 + n]
            k = k.reshape(3, 3, G, n).permute(3, 2, 0, 1)
            v = sources[src][..., c0:c0 + G].permute(0, 3, 1, 2)
            acc += F.conv2d(v, k, padding=1).permute(0, 2, 3, 1)
        acc += bias[launch["bias0"]:launch["bias0"] + n]
        if launch["dst"] == "y":
            y[..., launch["dst_c0"]:launch["dst_c0"] + n] = rnd(F.leaky_relu(acc, slope))
        else:
            out = rnd(acc * add_rate + x)
    return out


def test_dense_emulation_fp32_matches_plain_version_and_jax(rdb_case):
    """In fp32 the dense form is the same function as the scatter form and
    the JAX ScatterRDB: only the order of the sums differs (1e-5)."""
    x, params, _ = rdb_case
    mats = scatter_params_to_matmul(rdb_params_to_scatter(params), torch.float32)
    got = emulate_dense(torch.from_numpy(x), mats).numpy()
    want = scatter_rdb_reference(torch.from_numpy(x), *mats).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want_jax = np.asarray(JaxScatterRDB(features=C, dtype=jnp.float32).apply(
        {"params": jax_rdb_params_to_scatter(params)}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-5)


def test_dense_emulation_bf16_matches_plain_version(rdb_case):
    """bf16 inputs and weights, y_i and the output rounded to bf16 where the
    kernel rounds: within the tolerance the card holds the kernel to, and
    equal on nearly every value (a differently ordered fp32 sum flips a
    bf16 rounding of some y_i now and then)."""
    x, params, _ = rdb_case
    mats = scatter_params_to_matmul(rdb_params_to_scatter(params))
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    got = emulate_dense(x16, mats, round_to=torch.bfloat16)
    want = scatter_rdb_reference(x16, *mats).double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    assert (got != want).double().mean() < 0.01


def test_dense_emulation_fails_on_a_wrong_column_slice(rdb_case):
    """The emulation reads the plan: one group of one launch shifted by one
    column block moves the fp32 output 100x past the 1e-5 that the right
    plan meets."""
    x, params, _ = rdb_case
    mats = scatter_params_to_matmul(rdb_params_to_scatter(params), torch.float32)
    want = scatter_rdb_reference(torch.from_numpy(x), *mats)
    plan = dense_plan()
    src, c0, w, wc0, col0 = plan[2]["groups"][2]
    plan[2]["groups"][2] = (src, c0, w, wc0, col0 + G)
    got = emulate_dense(torch.from_numpy(x), mats, plan=plan)
    assert float((got - want.double()).abs().max()) > 100 * 1e-5


@pytest.mark.parametrize("i", range(5))
def test_dense_plan_launch_reads_every_source_once(i):
    """Launch i reads x (two 32-channel groups) and y_0..y_{i-1} once each,
    through a column slice inside its weight, and writes y_i (or the
    output) with the bias slice of the same columns as sx's slice."""
    launch = dense_plan()[i]
    n = G if i < 4 else C
    assert launch["n"] == n and len(launch["groups"]) == 2 + i <= MAX_GROUPS
    seen = sorted((src, c0) for src, c0, *_ in launch["groups"])
    assert seen == sorted([("x", 0), ("x", G)] + [("y", j * G) for j in range(i)])
    for src, c0, w, wc0, col0 in launch["groups"]:
        assert 0 <= col0 and col0 + n <= COUTS[w]
        if src == "x":
            assert w == 0 and wc0 == c0 and col0 == launch["bias0"] == i * G
        else:
            j = c0 // G
            assert w == j + 1 and wc0 == 0 and col0 == (i - j - 1) * G
    assert launch["dst"] == ("out" if i == 4 else "y")
    assert launch["dst_c0"] == (0 if i == 4 else i * G)


def test_plan_ints_encode_the_plan():
    """The integers the kernel reads: 5 + 5 * MAX_GROUPS per launch, the
    launch header then each group, unused group slots zero."""
    ints = _plan_ints()
    per = 5 + 5 * MAX_GROUPS
    assert len(ints) == 5 * per
    for i, launch in enumerate(dense_plan()):
        q = ints[i * per:(i + 1) * per]
        assert q[:5] == [len(launch["groups"]), launch["n"], launch["bias0"],
                         int(launch["dst"] == "out"), launch["dst_c0"]]
        for k, (src, c0, w, wc0, col0) in enumerate(launch["groups"]):
            assert q[5 + 5 * k:10 + 5 * k] == [int(src == "y"), c0, w, wc0, col0]
        assert not any(q[5 + 5 * len(launch["groups"]):])


# ------------------------------------------------ the kernel's persistent grid --

H100_SMS = 132
# (b, h, w, rectangles): the cells' frame batches (8 and 32 frames of
# 270 x 480), the photo cells' tile batch (8 x 96 x 96), the serving tiles
# (b256 t24), one more and one fewer rectangle than SMs, and ragged images.
SCHEDULE_SHAPES = [(8, 270, 480, 1920), (32, 270, 480, 7680), (8, 96, 96, 128),
                   (256, 24, 24, 256), (133, 24, 24, 133), (131, 20, 17, 131),
                   (1, 97, 131, 30), (3, 25, 23, 6), (1, 1, 1, 1)]


def block_rectangles(b, h, w, sms):
    """The kernel's walk: for each block k, the rectangles it computes in
    order, as (image, first row, first column). Block k takes rectangle
    indices k, k + grid, ...; index t is column t % tiles_w, then row, then
    image (``origin`` in csrc/fused_rdb.cu)."""
    tiles, grid = tile_schedule(b, h, w, sms)
    tiles_h, tiles_w = -(-h // RECT[0]), -(-w // RECT[1])
    return [[(t // (tiles_h * tiles_w), t // tiles_w % tiles_h * RECT[0], t % tiles_w * RECT[1])
             for t in range(k, tiles, grid)] for k in range(grid)]


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("b,h,w,tiles", SCHEDULE_SHAPES)
def test_block_walk_covers_every_rectangle_once(b, h, w, tiles, sms):
    """The grid the kernel is given is min(rectangles, SMs), and its blocks'
    walks (rectangles k, k + grid, ...) cover every rectangle of every image
    exactly once, each block at least one and none more than one above
    another."""
    assert tile_schedule(b, h, w, sms) == (tiles, min(tiles, sms))
    walk = block_rectangles(b, h, w, sms)
    assert len(walk) == min(tiles, sms)
    seen = [r for block in walk for r in block]
    want = {(i, r, c) for i in range(b) for r in range(0, h, RECT[0])
            for c in range(0, w, RECT[1])}
    assert len(seen) == len(want) == tiles
    assert set(seen) == want
    sizes = [len(block) for block in walk]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_block_walk_follows_the_kernel_index_order():
    """Block k's i-th rectangle is index k + i * grid, read as column, then
    row, then image (the order of the kernel's ``origin``), so neighbouring
    blocks start on neighbouring rectangles of one image."""
    walk = block_rectangles(2, 50, 70, 4)  # 3 x 3 rectangles an image, 18 in all
    assert walk[0] == [(0, 0, 0), (0, 24, 24), (0, 48, 48), (1, 24, 0), (1, 48, 24)]
    assert [block[0] for block in walk] == [(0, 0, 0), (0, 0, 24), (0, 0, 48), (0, 24, 0)]
    assert walk[3] == [(0, 24, 0), (0, 48, 24), (1, 0, 48), (1, 48, 0)]


@pytest.mark.parametrize("b,h,w,tiles", SCHEDULE_SHAPES + [(0, 24, 24, 0)])
def test_counters_of_rectangles_and_blocks(b, h, w, tiles, monkeypatch):
    """One counted RDB call adds 1 to ``launches`` and, for its five
    launches, 5 x rectangles to ``tiles`` and 5 x blocks to ``blocks``: their
    ratio is the rectangles each block's load ring runs on across (14.5 at
    the frames shape on an H100, 1.0 on the photo tile batch). An empty
    input launches nothing. The launch itself is stubbed: this is the
    wrapper's arithmetic, on a meta tensor."""
    monkeypatch.setattr(k1, "_launch", lambda x, *a, **kw: (x, None))
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(scatter_rdb, "launches", 0)
    monkeypatch.setattr(scatter_rdb, "tiles", 0)
    monkeypatch.setattr(scatter_rdb, "blocks", 0)
    x = torch.empty((b, h, w, C), dtype=torch.bfloat16, device="meta")
    k1._cuda_forward(x, None, None, None, None, None, None, 0.2, 0.01)
    blocks = min(tiles, H100_SMS)
    assert (scatter_rdb.launches, scatter_rdb.tiles, scatter_rdb.blocks) == (
        1, 5 * tiles, 5 * blocks)
    if (b, h, w) == (8, 270, 480):
        assert scatter_rdb.tiles / scatter_rdb.blocks == pytest.approx(14.545, abs=1e-3)
    if (b, h, w) == (8, 96, 96):
        assert scatter_rdb.tiles == scatter_rdb.blocks


# ------------------------------------------------- the kernel's row tiles --

PW = RECT[1] + 2  # halo patch width
PIX_BYTES = 2 * k1.G  # a patch pixel: one group's 32 channels, bf16


def tile_row_pixel(wg, m, r):
    """Rectangle pixel (row, column) of row r of warpgroup wg's row tile m:
    the 8 x 8 square of rows 8m.., columns 8wg.. (``consume`` in
    csrc/fused_rdb.cu)."""
    return 8 * m + r // 8, 8 * wg + r % 8


def test_row_tiles_cover_the_rectangle_once():
    """Three warpgroups of three 64-row tiles hold each of the rectangle's
    24 x 24 pixels once."""
    pixels = [tile_row_pixel(wg, m, r) for wg in range(3) for m in range(3) for r in range(64)]
    assert sorted(pixels) == [(i, j) for i in range(RECT[0]) for j in range(RECT[1])]


@pytest.mark.parametrize("tap", range(9))
def test_tile_descriptor_reads_each_rows_tap_pixel(tap):
    """wgmma reads row i of core matrix j of a K-major operand at the
    descriptor's start + j * SBO + i * (a row's bytes), and 16-byte chunk c
    of the row c * 16 bytes on. With the start at the tile's tap pixel
    (8m + dy) * PW + 8wg + dx (plus 32 bytes at the second k16 step) and SBO
    one patch row, row r = 8j + i reads chunk 2 ks + c of the patch pixel of
    its own output pixel moved by the tap: the patch pixel (oh + dy) * PW +
    ow + dx, where TMA wrote it. (The swizzle then applies to this address,
    as it did to TMA's.)"""
    dy, dx = divmod(tap, 3)
    sbo = PW * PIX_BYTES
    for wg, m, ks, r, c in itertools.product(range(3), range(3), range(2), range(64), range(2)):
        start = ((8 * m + dy) * PW + 8 * wg + dx) * PIX_BYTES + 32 * ks
        got = start + (r // 8) * sbo + (r % 8) * PIX_BYTES + 16 * c
        oh, ow = tile_row_pixel(wg, m, r)
        assert got == ((oh + dy) * PW + ow + dx) * PIX_BYTES + 16 * (2 * ks + c)


def test_epilogue_rows_are_the_tile_rows():
    """wgmma's accumulator rows: warp q of the warpgroup holds rows 16q +
    lane / 4 + 8h, which the epilogue stores at rectangle pixel (8m + 2q +
    h, 8wg + lane / 4)."""
    for wg, m, q, lane, h in itertools.product(range(3), range(3), range(4), range(32), range(2)):
        assert tile_row_pixel(wg, m, 16 * q + lane // 4 + 8 * h) == (
            8 * m + 2 * q + h, 8 * wg + lane // 4)
