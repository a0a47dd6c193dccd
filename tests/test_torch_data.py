"""The port's training data path against the JAX package on the CPU: the
degradations, the patch loader, the batch functions and the prefetcher.

``jax.random`` and ``torch.Generator`` are different streams, so the noise
terms are compared by their statistics; everything deterministic is
compared by value."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_super_resolution_tpu.data import degrade as jax_degrade
from image_super_resolution_tpu.data.pipeline import (
    LoaderConfig as JaxLoaderConfig,
    PatchLoader as JaxPatchLoader,
    make_sr_batch_fn as jax_make_sr_batch_fn,
)
from image_super_resolution_tpu_torch.data import degrade
from image_super_resolution_tpu_torch.data.manifest import load_manifest
from image_super_resolution_tpu_torch.data.pipeline import (
    DevicePrefetcher,
    LoaderConfig,
    PatchLoader,
    make_denoise_batch_fn,
    make_sr_batch_fn,
)
from image_super_resolution_tpu_torch.utils.general import ground_up, intersect_trees
from image_super_resolution_tpu_torch.utils.png import write_png
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)


def _x01(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_downscale_bit_exact(scale):
    x = _x01((2, 24, 36, 3), scale)
    want = np.asarray(jax_degrade.downscale(jnp.asarray(x), scale))
    got = degrade.downscale(torch.from_numpy(x), scale).numpy()
    assert got.shape == (2, 24 // scale, 36 // scale, 3)
    np.testing.assert_array_equal(got, want)


def test_downscale_refuses_what_has_no_closed_form():
    """Sizes the factor does not divide have no closed form: they take the
    general path, ``jax.image.resize``'s weights, within 1e-6 of it
    (tests/test_torch_eval.py holds every mode)."""
    for shape, scale in (((1, 10, 10, 3), 3), ((1, 8, 9, 3), 2)):
        x = _x01(shape, scale)
        want = np.asarray(jax_degrade.downscale(jnp.asarray(x), scale))
        got = degrade.downscale(torch.from_numpy(x), scale).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("quality", [10.0, 50.0, 75.0, 90.0])
@pytest.mark.parametrize("shape", [(4, 21, 19, 3), (1, 32, 32, 3)])
def test_jpeg_compress_matches_jax_at_a_fixed_quality(quality, shape):
    """At quality_range (q, q) the round trip is deterministic: equal to the
    JAX package's within 1e-6 (measured 2.4e-7: the DCT's sums in another
    order, no quantization step flipped), also on sizes that are not
    multiples of 8 (edge padding)."""
    x = _x01(shape, int(quality))
    want = np.asarray(jax_degrade.jpeg_compress(jax.random.PRNGKey(0), jnp.asarray(x),
                                                (quality, quality)))
    got = degrade.jpeg_compress(torch.Generator(), torch.from_numpy(x),
                                (quality, quality)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got - x).mean() > 1e-3  # it did compress


def _residual_stats(jax_fn, torch_fn, x, n_draws=4):
    """Per-draw std and mean |.| of (noisy - clean) for both packages."""
    ours, theirs = [], []
    for i in range(n_draws):
        a = np.asarray(jax_fn(jax.random.PRNGKey(i), jnp.asarray(x))) - x
        b = torch_fn(torch.Generator().manual_seed(i), torch.from_numpy(x)).numpy() - x
        theirs.append((a.std(), np.abs(a).mean()))
        ours.append((b.std(), np.abs(b).mean()))
    return np.asarray(ours), np.asarray(theirs)


def test_gaussian_noise_statistics():
    """Variance drawn per image on the 0-255 scale: with a fixed variance v
    the residual's std is sqrt(v)/255 in both packages (within 2% on 2^17
    values per image; mid-grey input, so nothing clips), and with the
    default range each image's std lies in [sqrt(10), sqrt(50)]/255."""
    x = np.full((4, 128, 128, 3), 0.5, np.float32)
    for v in (10.0, 40.0):
        ours, theirs = _residual_stats(
            lambda k, a: jax_degrade.gaussian_noise(k, a, (v, v)),
            lambda g, a: degrade.gaussian_noise(g, a, (v, v)), x)
        np.testing.assert_allclose(ours[:, 0], np.sqrt(v) / 255, rtol=0.02)
        np.testing.assert_allclose(theirs[:, 0], np.sqrt(v) / 255, rtol=0.02)
    g = torch.Generator().manual_seed(0)
    r = degrade.gaussian_noise(g, torch.from_numpy(x)).numpy() - x
    per_image = r.reshape(4, -1).std(1) * 255
    assert (per_image > np.sqrt(10) * 0.98).all() and (per_image < np.sqrt(50) * 1.02).all()


def test_iso_noise_statistics():
    """Shot noise ~ sqrt(luma) plus a chroma shift, each scale drawn per
    image: with the ranges pinned, the residual's std in the port is within
    3% of the JAX package's on the same image (a smooth ramp, 2^14 pixels);
    with the default ranges, the means over 8 draws within 15%."""
    yy, xx = np.mgrid[0:128, 0:128]
    ramp = np.stack([0.2 + 0.6 * xx / 127, 0.3 + 0.4 * yy / 127, 0.5 + 0 * xx], -1)
    x = np.broadcast_to(ramp, (4, 128, 128, 3)).astype(np.float32).copy()
    ours, theirs = _residual_stats(
        lambda k, a: jax_degrade.iso_noise(k, a, (0.03, 0.03), (0.3, 0.3)),
        lambda g, a: degrade.iso_noise(g, a, (0.03, 0.03), (0.3, 0.3)), x)
    np.testing.assert_allclose(ours[:, 0], theirs[:, 0], rtol=0.03)
    ours, theirs = _residual_stats(jax_degrade.iso_noise, degrade.iso_noise, x, 8)
    np.testing.assert_allclose(ours[:, 0].mean(), theirs[:, 0].mean(), rtol=0.15)


def test_denoise_degradation_statistics():
    """The whole chain (gauss -> ISO -> JPEG) at each named severity: the
    mean |noisy - clean| over 8 draws of a smooth image within 15% of the
    JAX package's, and ordered light < default < heavy in both."""
    yy, xx = np.mgrid[0:64, 0:64]
    img = np.stack([0.5 + 0.3 * np.sin(xx / 6 + c) * np.cos(yy / 9) for c in range(3)], -1)
    x = np.broadcast_to(img, (4, 64, 64, 3)).astype(np.float32).copy()
    means = {}
    for name, (var, inten, q) in degrade.DENOISE_SEVERITIES.items():
        assert jax_degrade.DENOISE_SEVERITIES[name] == (var, inten, q)
        ours, theirs = _residual_stats(
            lambda k, a: jax_degrade.denoise_degradation(k, a, q, var, inten),
            lambda g, a: degrade.denoise_degradation(g, a, q, var, inten), x, 8)
        means[name] = ours[:, 1].mean()
        np.testing.assert_allclose(means[name], theirs[:, 1].mean(), rtol=0.15)
    assert means["light"] < means["default"] < means["heavy"]


def test_degradations_draw_from_the_generator():
    x = torch.from_numpy(_x01((2, 16, 16, 3)))
    a = degrade.denoise_degradation(torch.Generator().manual_seed(3), x)
    b = degrade.denoise_degradation(torch.Generator().manual_seed(3), x)
    c = degrade.denoise_degradation(torch.Generator().manual_seed(4), x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


# ------------------------------------------------------------ the loader --

@pytest.fixture
def images(tmp_path):
    """Five PNGs, two of them smaller than the patch (reflect padding)."""
    rng = np.random.default_rng(1)
    paths = []
    for i, hw in enumerate([(40, 52), (33, 31), (20, 50), (64, 64), (12, 14)]):
        p = tmp_path / f"{i}.png"
        write_png(p, rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
        paths.append(str(p))
    m = tmp_path / "train.json"
    m.write_text(json.dumps(paths))
    return m, paths


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("scale,patch,batch,steps", [(2, 24, 2, 2), (3, 16, 2, 2), (1, 30, 2, 2),
                                                     (2, 24, 8, 1)])
def test_patch_loader_cuts_the_jax_loaders_patches(images, scale, patch, batch, steps, backend):
    """Same manifest, seed and epoch, each package on the same backend: the
    same order and the same crops, bit for bit, as the JAX package's
    loader, over two epochs, in full batches (the last sample left over at
    batch 2; at batch 8, more than the 5 samples, one batch filled by
    cycling them), including images smaller than the patch; the patch is
    rounded up to a multiple of the scale (ground_up). The native backend
    is tests/test_torch_native.py's; here it must build, as it does
    wherever g++, libjpeg-turbo and libpng are installed."""
    m, _ = images
    kw = dict(batch_size=batch, patch_size=patch, scale=scale, workers=2, seed=7,
              backend=backend)
    ours = PatchLoader(m, LoaderConfig(**kw))
    theirs = JaxPatchLoader(m, JaxLoaderConfig(**kw))
    assert ours.uses_native == theirs.uses_native == (backend == "native")
    assert len(ours) == len(theirs) == steps and ours.patch == theirs.patch
    assert ours.patch == ground_up(patch, scale)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == steps
        for a, b in zip(got, want):
            assert a.dtype == np.uint8 and a.shape == (batch, ours.patch, ours.patch, 3)
            np.testing.assert_array_equal(a, b)
        assert ours.substituted == 0


def test_patch_loader_substitutes_and_counts_unreadable_files(images, tmp_path):
    """A file no decoder reads becomes a black patch (as in the JAX
    package) and is counted once per use, anew each epoch."""
    _, paths = images
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG broken")
    loader = PatchLoader(paths[:3] + [str(bad)], LoaderConfig(batch_size=4, patch_size=8,
                                                              scale=2, seed=0))
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        (batch,) = list(loader)
        assert loader.substituted == 1
        assert sum(not b.any() for b in batch) == 1


def test_calculate_stats_matches_jax(images):
    m, _ = images
    ours = PatchLoader(m, LoaderConfig()).calculate_stats()
    theirs = JaxPatchLoader(m, JaxLoaderConfig(backend="python")).calculate_stats()
    np.testing.assert_allclose(ours, theirs, rtol=1e-12)


def test_load_manifest(tmp_path):
    (tmp_path / "m.json").write_text(json.dumps(["a.png", "b.png"]))
    assert load_manifest(tmp_path / "m.json") == ["a.png", "b.png"]
    (tmp_path / "bad.json").write_text(json.dumps({"a": 1}))
    with pytest.raises(ValueError):
        load_manifest(tmp_path / "bad.json")
    with pytest.raises(ValueError, match="empty"):
        PatchLoader([], LoaderConfig())


@pytest.mark.parametrize("scale", [2, 4])
def test_sr_batch_fn_matches_jax(scale):
    """uint8 crops -> (hr, lr): lr = normalize(downscale), hr = tanh(x),
    with a dataset mean/std: within 1e-6 (fp32 normalize)."""
    u8 = np.random.default_rng(2).integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)
    mean, std = (0.4, 0.45, 0.5), (0.2, 0.25, 0.3)
    want = jax_make_sr_batch_fn(scale, "tanh", mean, std)(jnp.asarray(u8))
    got = make_sr_batch_fn(scale, mean, std)(torch.from_numpy(u8))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert got[1].shape == (2, 24 // scale, 24 // scale, 3)


def test_denoise_batch_fn_pairs():
    """hr = tanh(x) exactly; lr = normalize(degradation(x)) with the
    degradation drawn from the generator it is given."""
    u8 = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 16, 16, 3),
                                                            dtype=np.uint8))
    fn = make_denoise_batch_fn((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))
    hr, lr = fn(u8, torch.Generator().manual_seed(0))
    torch.testing.assert_close(hr, u8.float() / 255.0 * 2 - 1, rtol=0, atol=0)
    noisy = degrade.denoise_degradation(torch.Generator().manual_seed(0), u8.float() / 255.0)
    torch.testing.assert_close(lr, (noisy - 0.5) / 0.25, rtol=0, atol=1e-6)


def test_device_prefetcher_passes_batches_and_errors():
    batches = [np.full((1, 2, 2, 3), i, np.uint8) for i in range(5)]
    with DevicePrefetcher(iter(batches), torch.device("cpu")) as pf:
        got = [b.clone() for b in pf]
    assert [int(b[0, 0, 0, 0]) for b in got] == list(range(5))

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    with DevicePrefetcher(broken(), torch.device("cpu")) as pf:
        next(pf)
        with pytest.raises(RuntimeError, match="producer") as err:
            next(pf)
    assert isinstance(err.value.__cause__, OSError)


def test_intersect_trees_and_ground_up_match_jax():
    from image_super_resolution_tpu.utils.general import (
        ground_up as jax_ground_up,
        intersect_trees as jax_intersect_trees,
    )

    src = {"a": {"k": np.ones((2, 3))}, "b": np.zeros(4), "c": np.ones(1)}
    tgt = {"a": {"k": np.zeros((2, 3))}, "b": np.ones(5), "d": np.ones(2)}
    ours, theirs = intersect_trees(src, tgt), jax_intersect_trees(src, tgt)
    assert ours[1:] == theirs[1:] == (1, 3)
    np.testing.assert_array_equal(ours[0]["a"]["k"], theirs[0]["a"]["k"])
    for v, s in ((96, 2), (97, 4), (5, 1), (0, 3)):
        assert ground_up(v, s) == jax_ground_up(v, s)


def test_sr_batch_fn_norm_mode_matches_jax():
    """hr_mode="norm" (the GAN phase): HR normalized with the dataset
    mean/std, LR as in the tanh mode; within 1e-6 of JAX's."""
    u8 = np.random.default_rng(4).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    mean, std = (0.4, 0.5, 0.6), (0.2, 0.25, 0.3)
    want = jax_make_sr_batch_fn(2, "norm", mean, std)(jnp.asarray(u8))
    got = make_sr_batch_fn(2, mean, std, hr_mode="norm")(torch.from_numpy(u8))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="hr_mode"):
        make_sr_batch_fn(2, hr_mode="01")


def test_gan_transforms_match_jax():
    """tanh_to_01, tanh_to_norm and the BT.601 y_channel (border 4, and
    none): within 1e-6 (1e-4 for Y, in [16, 235]) of JAX's."""
    from image_super_resolution_tpu.data import transforms as jt
    from image_super_resolution_tpu_torch.data import transforms as tt

    x = np.random.default_rng(5).uniform(-1, 1, (2, 12, 10, 3)).astype(np.float32)
    mean, std = (0.4, 0.5, 0.6), (0.2, 0.25, 0.3)
    pairs = [(tt.tanh_to_01(torch.from_numpy(x)), jt.tanh_to_01(jnp.asarray(x)), 1e-6),
             (tt.tanh_to_norm(torch.from_numpy(x), mean, std),
              jt.tanh_to_norm(jnp.asarray(x), mean, std), 1e-6)]
    x01 = (x + 1) / 2
    for border in (4, 0):
        pairs.append((tt.y_channel(torch.from_numpy(x01), border),
                      jt.y_channel(jnp.asarray(x01), border), 1e-4))
    for got, want, atol in pairs:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_create_json_matches_jax(tmp_path, capsys):
    """cli/create_json over nested folders holding good PNGs, one smaller
    than --shape, one that no decoder reads and a non-image file: the same
    train and val lists as the JAX package's (sorted, recursive), the small
    and the unreadable files skipped and counted, and nothing deleted."""
    from image_super_resolution_tpu.data.manifest import create_data_lists as jax_lists
    from image_super_resolution_tpu_torch.cli import create_json

    rng = np.random.default_rng(6)
    train, val = tmp_path / "train", tmp_path / "val"
    (train / "sub").mkdir(parents=True)
    val.mkdir()
    for path, hw in ((train / "b.png", (40, 36)), (train / "sub" / "a.png", (32, 50)),
                     (train / "small.png", (20, 40)), (val / "v.png", (33, 33))):
        write_png(path, rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    (train / "broken.png").write_bytes(b"not an image")
    (train / "notes.txt").write_text("not an image either")
    before = sorted(p.name for p in tmp_path.rglob("*"))
    out_t, out_v = create_json.main(["--train_dirs", str(train), "--val_dirs", str(val),
                                     "--shape", "32", "--output", str(tmp_path / "ours")])
    printed = capsys.readouterr().out
    assert "There are 2 images in the training data (2 skipped)." in printed
    assert "There are 1 images in the validating data (0 skipped)." in printed
    jt, jv = jax_lists([train], [val], 32, tmp_path / "theirs")
    assert json.loads(out_t.read_text()) == json.loads(jt.read_text()) == [
        (train / "b.png").as_posix(), (train / "sub" / "a.png").as_posix()]
    assert json.loads(out_v.read_text()) == json.loads(jv.read_text())
    assert load_manifest(out_t) == json.loads(jt.read_text())
    assert sorted(p.name for p in tmp_path.rglob("*") if p.parent.name not in
                  ("ours", "theirs") and p.name not in ("ours", "theirs")) == before
