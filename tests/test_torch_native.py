"""The port's C++ patch loader (``native/``) against the JAX package's on the
CPU: decodes, batched crops and ``PatchLoader``'s native backend bit for bit,
the ROI JPEG decode against a full decode at the offsets a Python
splitmix64 draws, ``auto``'s choice, the refusal of ``native`` where the
library is unavailable, and two processes building it at once.

Every test but the last two needs the library and skips (inside the ``lib``
fixture) where it cannot build; it builds wherever g++, libjpeg-turbo and
libpng's headers are installed."""

import ctypes
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

import image_super_resolution_tpu.native as jax_native
from image_super_resolution_tpu.data.pipeline import (
    LoaderConfig as JaxLoaderConfig,
    PatchLoader as JaxPatchLoader,
)
from image_super_resolution_tpu_torch import native
from image_super_resolution_tpu_torch.data.pipeline import LoaderConfig, PatchLoader
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip(f"the C++ loader does not build here: {native.build_error()}")
    if not jax_native.available():
        pytest.skip("the JAX package's C++ loader does not build here")


@pytest.fixture
def no_native(monkeypatch):
    """Both libraries disabled by ISR_NO_NATIVE, read afresh; the port's
    cached load is cleared again afterwards."""
    monkeypatch.setenv("ISR_NO_NATIVE", "1")
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)
    native._load_once.cache_clear()
    yield
    native._load_once.cache_clear()


def _photo(h, w, seed):
    """Smooth waves plus noise, like a photograph's mix of flat areas and
    texture (what chroma subsampling and the ROI decode must keep exact)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = 128 + 60 * np.sin(2 * np.pi * (3 * yy + 2 * xx)[..., None] + rng.uniform(0, 6, 3))
    return np.clip(img + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def _write(tmp_path, name, kind, h=45, w=61, seed=0):
    """One file of ``kind``; returns its path and the RGB it must decode to
    (None for lossy JPEGs)."""
    img = _photo(h, w, seed)
    p = tmp_path / name
    if kind == "png_rgb":
        Image.fromarray(img).save(p)
        return p, img
    if kind == "png_grey":
        Image.fromarray(img[..., 0]).save(p)
        return p, np.repeat(img[..., :1], 3, -1)
    if kind == "png_palette":
        pal = Image.fromarray(img).quantize(64)
        pal.save(p)
        return p, np.asarray(pal.convert("RGB"))
    if kind == "png_16bit":
        deep = img.astype(np.uint16) * 257 + np.uint16(seed % 200)
        cv2.imwrite(str(p), deep[..., ::-1])  # BGR
        return p, (deep >> 8).astype(np.uint8)  # libpng strips the low byte
    if kind == "png_rgba":
        alpha = np.full((h, w, 1), 128, np.uint8)
        Image.fromarray(np.concatenate([img, alpha], -1)).save(p)
        return p, img
    if kind == "jpeg_420":
        Image.fromarray(img).save(p, quality=90, subsampling=2)
        return p, None
    if kind == "jpeg_444":
        Image.fromarray(img).save(p, quality=90, subsampling=0)
        return p, None
    if kind == "bmp":
        Image.fromarray(img).save(p)
        return p, img
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["png_rgb", "png_grey", "png_palette", "png_16bit",
                                  "png_rgba", "jpeg_420", "jpeg_444"])
def test_decode_rgb_equals_jax(lib, tmp_path, kind):
    """Every PNG flavour normalized to 8-bit RGB as libpng does, equal to
    what it must decode to; JPEGs within the JAX test's bound of PIL (mean
    difference under 1); and both bit-equal to the JAX binding."""
    p, want = _write(tmp_path, f"x.{'jpg' if 'jpeg' in kind else 'png'}", kind)
    got = native.decode_rgb(str(p))
    assert got.dtype == np.uint8 and got.shape == (45, 61, 3)
    np.testing.assert_array_equal(got, jax_native.decode_rgb(str(p)))
    if want is None:
        ref = np.asarray(Image.open(p).convert("RGB")).astype(int)
        assert np.abs(got.astype(int) - ref).mean() < 1.0
    else:
        np.testing.assert_array_equal(got, want)
    assert native.decode_rgb(str(tmp_path / "missing.png")) is None


@pytest.mark.parametrize("threads", [1, 4])
def test_load_patches_equals_jax(lib, tmp_path, threads):
    """A batch mixing a JPEG (ROI decode), a PNG (prefix decode), a JPEG
    smaller than the patch (reflect pad), a BMP (decoded again in Python)
    and a missing file (a zero patch, counted, with the JAX warning): bit-equal
    to the JAX binding, whatever the thread count."""
    files = [_write(tmp_path, "a.jpg", "jpeg_420", 120, 150, 1)[0],
             _write(tmp_path, "b.png", "png_rgb", 90, 100, 2)[0],
             _write(tmp_path, "c.jpg", "jpeg_444", 20, 30, 3)[0],
             _write(tmp_path, "d.bmp", "bmp", 50, 70, 4)[0],
             tmp_path / "missing.png"]
    paths = [str(p) for p in files]
    seeds = [11, 2**63 + 5, 7, 2**64 - 1, 3]
    with pytest.warns(UserWarning, match="1 image.s. unreadable by both"):
        got, substituted = native.load_patches(paths, 32, seeds, threads=threads)
    with pytest.warns(UserWarning, match="1 image.s. unreadable by both"):
        want = jax_native.load_patches(paths, 32, seeds, threads=threads)
    assert got.shape == (5, 32, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert substituted == 1 and not got[4].any() and all(g.any() for g in got[:4])
    small = native.decode_rgb(paths[2])
    np.testing.assert_array_equal(got[2], np.pad(small, ((0, 12), (0, 2), (0, 0)),
                                                 mode="reflect"))


@pytest.mark.parametrize("quality", [70, 92])
def test_roi_crop_equals_full_decode(lib, tmp_path, quality):
    """The ROI decode (iMCU-aligned skip, one iMCU column of margin) cuts
    exactly the full decode's pixels at the offsets ``crop_offsets`` draws
    (a Python splitmix64 + Lemire), on 4:2:0 and 4:4:4 JPEGs whose sides
    are not multiples of the MCU."""
    for sub, (h, w) in ((2, (203, 157)), (0, (141, 250))):
        p = tmp_path / f"q{quality}s{sub}.jpg"
        Image.fromarray(_photo(h, w, quality + sub)).save(p, quality=quality, subsampling=sub)
        full = native.decode_rgb(str(p))
        seeds = list(range(12))
        crops, substituted = native.load_patches([str(p)] * 12, 48, seeds)
        assert substituted == 0
        tops = []
        for seed, crop in zip(seeds, crops):
            top, left = native.crop_offsets(h, w, 48, seed)
            tops.append(top)
            np.testing.assert_array_equal(crop, full[top:top + 48, left:left + 48])
        assert max(tops) >= 32  # some crops skip whole iMCU rows


def _mixed_set(tmp_path, n=7):
    paths = []
    for i in range(n):
        kind = ("jpeg_420", "png_rgb", "jpeg_444")[i % 3]
        h, w = [(70, 90), (41, 37), (30, 66), (64, 64), (25, 22), (99, 51), (48, 80)][i]
        paths.append(str(_write(tmp_path, f"{i}.{'png' if 'png' in kind else 'jpg'}",
                                kind, h, w, i)[0]))
    m = tmp_path / "train.json"
    m.write_text(json.dumps(paths))
    return m


def test_patch_loader_native_equals_jax(lib, tmp_path, capsys):
    """``PatchLoader(backend="native")`` over JPEGs and PNGs, some smaller
    than the patch: the same batches as the JAX package's native loader,
    batch by batch, over epochs 0 and 1, nothing substituted."""
    m = _mixed_set(tmp_path)
    kw = dict(batch_size=3, patch_size=30, scale=2, workers=2, seed=5, prefetch=2)
    ours = PatchLoader(m, LoaderConfig(backend="native", **kw))
    theirs = JaxPatchLoader(m, JaxLoaderConfig(backend="native", **kw))
    assert ours.uses_native and theirs.uses_native
    assert capsys.readouterr().out.count("PatchLoader backend: native") == 2
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.shape == (3, 30, 30, 3)
            np.testing.assert_array_equal(a, b)
        assert ours.substituted == 0
    assert not np.array_equal(got[0], list(PatchLoader(m, LoaderConfig(backend="python",
                                                                        **kw)))[0])


@pytest.mark.parametrize("case,want", [("mostly_jpeg", "native"), ("mostly_bmp", "python"),
                                       ("no_native", "python")])
def test_auto_chooses_as_jax(tmp_path, request, case, want, capsys):
    """``auto``: native where the library loads and at least half the
    manifest is JPEG/PNG; python for a mostly-BMP manifest and under
    ISR_NO_NATIVE; both packages print the same choice."""
    if case == "no_native":
        request.getfixturevalue("no_native")
    else:
        request.getfixturevalue("lib")
    kinds = ["jpeg_420", "jpeg_420", "bmp"] if case != "mostly_bmp" else ["jpeg_420", "bmp",
                                                                           "bmp"]
    paths = [str(_write(tmp_path, f"{i}.{'bmp' if k == 'bmp' else 'jpg'}", k, 40, 40, i)[0])
             for i, k in enumerate(kinds)]
    ours = PatchLoader(paths, LoaderConfig(batch_size=3, patch_size=16))
    theirs = JaxPatchLoader(paths, JaxLoaderConfig(batch_size=3, patch_size=16))
    assert ours.uses_native == theirs.uses_native == (want == "native")
    assert capsys.readouterr().out == f"PatchLoader backend: {want}\n" * 2
    np.testing.assert_array_equal(next(iter(ours)), next(iter(theirs)))


def test_native_backend_raises_when_unavailable(no_native, tmp_path):
    """``backend="native"`` where the library is unavailable raises the JAX
    package's RuntimeError, with the reason appended."""
    paths = [str(_write(tmp_path, "a.jpg", "jpeg_420")[0])]
    assert not native.available() and native.build_error() == "ISR_NO_NATIVE is set"
    assert native.decode_rgb(paths[0]) is None
    assert native.load_patches(paths, 16, [0]) is None
    with pytest.raises(RuntimeError, match="did not build on this host") as theirs:
        list(JaxPatchLoader(paths, JaxLoaderConfig(batch_size=1, backend="native")))
    with pytest.raises(RuntimeError, match="ISR_NO_NATIVE is set") as ours:
        list(PatchLoader(paths, LoaderConfig(batch_size=1, backend="native")))
    assert str(ours.value).startswith(str(theirs.value))
    with pytest.raises(ValueError, match="backend must be one of"):
        PatchLoader(paths, LoaderConfig(backend="turbo")).uses_native


def test_build_failure_keeps_the_compilers_message(tmp_path, monkeypatch):
    broken = tmp_path / "loader.cpp"
    broken.write_text("int isr_version() { return 2 }\n")  # missing ';'
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._load_once.cache_clear()
    try:
        assert not native.available()
        assert "error" in native.build_error() and "loader.cpp" in native.build_error()
        assert not list((tmp_path / "build").glob("*"))  # no library, no temp file
    finally:
        native._load_once.cache_clear()


def test_two_processes_build_one_loadable_library(tmp_path):
    """Two processes that find no library build it at once, each into its
    own temp file moved into place: one library results, no temp file is
    left, and it loads with the expected version."""
    code = ("import sys; from pathlib import Path; "
            "from image_super_resolution_tpu_torch import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); "
            "print(native.available(), native.library_path(), native.build_error())")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop("ISR_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = {o[0].strip() for o in outs}
    assert len(lines) == 1, lines
    ok, path = lines.pop().split()[:2]
    if ok != "True":
        pytest.skip(f"the C++ loader does not build here: {outs[0][0]}")
    assert [f.name for f in tmp_path.iterdir()] == [Path(path).name]
    assert ctypes.CDLL(path).isr_version() == native.VERSION


def test_port_and_jax_sources_differ_only_in_the_header_comment():
    """The port's loader.cpp is a copy of the JAX package's: every line from
    the first #include on is the same."""
    ours = native.SRC.read_text().splitlines()
    theirs = (Path(jax_native.__file__).with_name("loader.cpp")).read_text().splitlines()
    start = ours.index("#include <atomic>")
    assert ours[start:] == theirs[theirs.index("#include <atomic>"):]
