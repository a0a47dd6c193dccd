"""The video path of the port against the JAX package on the CPU: the
reader (OpenCV, and the ffmpeg pipe through a stand-in ``ffmpeg`` and
``ffprobe``), the recorder, the three-stage pipeline of ``rs`` and the
``rs`` video path end to end."""

import json
import os
import sys

import cv2
import numpy as np
import pytest


from image_super_resolution_tpu.cli import rs as jax_rs
from image_super_resolution_tpu.infer.engine import TiledUpscaler as JaxTiledUpscaler
from image_super_resolution_tpu.models.deploy import load_artifact as jax_load_artifact
from image_super_resolution_tpu.video import recorder as jax_recorder
from image_super_resolution_tpu.video.reader import VideoSource as JaxVideoSource
from image_super_resolution_tpu_torch.cli import rs
from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
from image_super_resolution_tpu_torch.models.deploy import (
    DeploySpec,
    init_fused_params,
    load_artifact,
    save_artifact,
)
from image_super_resolution_tpu_torch.video import reader as reader_mod
from image_super_resolution_tpu_torch.video import recorder
from image_super_resolution_tpu_torch.video.reader import VideoSource
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)


def _write_clip(path, n_frames=10, w=64, h=48, fps=10):
    """A cv2 mp4v clip (as the JAX package's video tests write one)."""
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert writer.isOpened(), "cv2 mp4v encoder unavailable"
    rng = np.random.default_rng(0)
    for i in range(n_frames):
        frame = np.full((h, w, 3), i * 20 % 255, np.uint8)
        frame[:10, :10] = rng.integers(0, 255, (10, 10, 3), dtype=np.uint8)
        writer.write(frame)
    writer.release()
    return path


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("video")
    return tmp, _write_clip(tmp / "in.mp4")


@pytest.fixture(scope="module")
def sr_x2(clip):
    tmp, _ = clip
    spec = DeploySpec(family="sr", depth=1, width=8, scale=2)
    path = tmp / "sr.isr"
    save_artifact(path, spec, init_fused_params(spec, 0))
    return path


def _frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return np.stack(out)


# ------------------------------------------------------------------- reader --

def test_reader_batches_fixed_shape_equal_to_jax(clip):
    """cv2 backend: the JAX reader's metadata and frames; batches of a fixed
    shape, the tail padded with its last frame."""
    _, path = clip
    ours, theirs = VideoSource(path), JaxVideoSource(path)
    assert ours.backend == "cv2"
    assert (ours.width, ours.height, ours.fps, ours.total_frames) == (
        theirs.width, theirs.height, theirs.fps, theirs.total_frames) == (64, 48, 10.0, 10)
    got, want = list(ours.batches(4)), list(theirs.batches(4))
    ours.close()
    theirs.close()
    assert [n for _, n in got] == [n for _, n in want] == [4, 4, 2]
    for (a, _), (b, _) in zip(got, want):
        assert a.shape == (4, 48, 64, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[-1][0][2], got[-1][0][1])  # padded tail
    np.testing.assert_array_equal(got[-1][0][3], got[-1][0][1])


def _stub_decoder(tmp_path, frames, fps="10/1", with_ffprobe=True, fail=False):
    """A stand-in ``ffmpeg`` that writes ``frames`` as raw rgb24 to stdout
    when asked for rawvideo (or fails), and a stand-in ``ffprobe`` that
    prints the stream's JSON. Returns the directory to put first on PATH."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    n, h, w, _ = frames.shape
    raw = tmp_path / "frames.raw"
    raw.write_bytes(np.ascontiguousarray(frames).tobytes())
    (bin_dir / "ffmpeg").write_text(
        "#!/bin/sh\n"
        "for a in \"$@\"; do\n"
        "  if [ \"$a\" = \"rawvideo\" ]; then\n"
        + ("    echo 'decode error' >&2; exit 3\n" if fail else f"    cat '{raw}'; exit 0\n")
        + "  fi\n"
        "done\n"
        "exit 1\n")
    (bin_dir / "ffmpeg").chmod(0o755)
    if with_ffprobe:
        meta = {"streams": [{"width": w, "height": h, "r_frame_rate": fps, "nb_frames": str(n)}]}
        (bin_dir / "ffprobe").write_text(f"#!/bin/sh\necho '{json.dumps(meta)}'\n")
        (bin_dir / "ffprobe").chmod(0o755)
    return bin_dir


def test_reader_ffmpeg_pipe_backend(tmp_path, monkeypatch, clip):
    """Without cv2: frames from the ffmpeg pipe, metadata from ffprobe; the
    same batches as the cv2 reader gives for the same frames."""
    _, path = clip
    src = VideoSource(path)
    frames = np.stack(list(src.frames()))
    src.close()
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    stub = _stub_decoder(tmp_path, frames)
    monkeypatch.setenv("PATH", f"{stub}{os.pathsep}{os.environ['PATH']}")
    src = VideoSource(path)
    assert src.backend == "ffmpeg"
    assert (src.width, src.height, src.fps) == (64, 48, 10.0)
    assert src.total_frames == 10
    got = list(src.batches(4))
    src.close()
    assert [n for _, n in got] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate([b[:n] for b, n in got]), frames)
    assert all(b.shape == (4, 48, 64, 3) for b, _ in got)


def test_reader_ffmpeg_without_ffprobe_refuses(tmp_path, monkeypatch, clip):
    """The pipe takes its metadata from ffprobe alone: ffmpeg without it
    is no decoder."""
    _, path = clip
    monkeypatch.setitem(sys.modules, "cv2", None)
    stub = _stub_decoder(tmp_path, np.zeros((2, 48, 64, 3), np.uint8), with_ffprobe=False)
    monkeypatch.setenv("PATH", str(stub))
    with pytest.raises(RuntimeError, match="ffmpeg and ffprobe"):
        VideoSource(path)


def test_reader_ffmpeg_failure_raises(tmp_path, monkeypatch, clip):
    _, path = clip
    monkeypatch.setitem(sys.modules, "cv2", None)
    stub = _stub_decoder(tmp_path, np.zeros((2, 48, 64, 3), np.uint8), fail=True)
    monkeypatch.setenv("PATH", f"{stub}{os.pathsep}{os.environ['PATH']}")
    src = VideoSource(path)
    with pytest.raises(IOError, match="decode error"):
        list(src.frames())
    src.close()


def test_reader_without_a_decoder_names_both(tmp_path, monkeypatch, clip):
    _, path = clip
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="cv2.*ffmpeg"):
        VideoSource(path)
    assert reader_mod.shutil.which("ffmpeg") is None


# ----------------------------------------------------------------- recorder --

def _stub_encoder(tmp_path, listed, working):
    """A stand-in ffmpeg: an encoder table for -encoders; a test encode
    (-c:v CODEC) exits 0 iff CODEC is in ``working``."""
    rows = "\n".join(f" V....D {name}" for name in listed)
    script = tmp_path / "ffmpeg"
    script.write_text(
        "#!/bin/sh\n"
        "for a in \"$@\"; do\n"
        f"  [ \"$a\" = \"-encoders\" ] && printf '{rows}\\n' && exit 0\n"
        "done\n"
        "prev=\"\"; codec=\"\"\n"
        "for a in \"$@\"; do\n"
        "  [ \"$prev\" = \"-c:v\" ] && codec=\"$a\"\n"
        "  prev=\"$a\"\n"
        "done\n"
        f"case \"$codec\" in {'|'.join(working) or 'NONE'}) exit 0;; esac\n"
        "exit 1\n")
    script.chmod(0o755)
    return str(script)


@pytest.mark.parametrize("listed,working", [
    (["hevc_nvenc", "hevc_vaapi", "libx264"], ["hevc_vaapi", "libx264"]),
    (["hevc_nvenc", "hevc_vaapi", "libx264"], []),
    (["libx264"], []),
    (["hevc_nvenc", "hevc_amf"], ["hevc_nvenc", "hevc_amf"]),
])
def test_probe_encoder_matches_jax(tmp_path, listed, working):
    exe = _stub_encoder(tmp_path, listed, working)
    got = recorder.probe_encoder(exe)
    assert got == jax_recorder.probe_encoder(exe)
    assert recorder._probe_cache[exe] == got  # cached per binary


def test_timecode_and_subtitles_match_jax(tmp_path):
    for x in (0, 0.04, 1.5, 59.999, 61.25, 3661.5):
        assert recorder.second_to_timecode(x) == jax_recorder.second_to_timecode(x)
    recs = []
    for mod, name in ((recorder, "ours"), (jax_recorder, "theirs")):
        rec = mod.FFMPEGRecorder(str(tmp_path / f"{name}.mp4"), video_dimensions=(64, 48),
                                 fps=10)
        for i in range(12):
            rec.write_frame(np.full((48, 64, 3), i * 20, np.uint8))
            rec.writeSubtitle(f"frame {i}" if i % 3 else "")
        rec.stop_recorder()
        assert rec.add_subtitle() is None  # no ffmpeg here: the .srt sidecar only
        recs.append(rec)
    ours, theirs = recs
    assert ours.subtitle_content == theirs.subtitle_content
    assert ((tmp_path / "ours.srt").read_text() == (tmp_path / "theirs.srt").read_text())
    assert (ours.bit_rate, ours.backend, ours.codec) == (theirs.bit_rate, "cv2", "mp4v")
    assert len(_frames(tmp_path / "ours.mp4")) == 12
    assert recorder.FFMPEG_recorder is recorder.FFMPEGRecorder
    assert recorder.FFMPEGRecorder.stopRecorder is recorder.FFMPEGRecorder.stop_recorder


def test_recorder_auto_codec_uses_the_probe(tmp_path, monkeypatch):
    exe = _stub_encoder(tmp_path, ["hevc_nvenc", "hevc_vaapi"], ["hevc_nvenc"])
    monkeypatch.setattr(recorder, "_ffmpeg_exe", lambda: exe)
    rec = recorder.FFMPEGRecorder(str(tmp_path / "o.mp4"), video_dimensions=(8, 8), fps=5,
                                  codec="auto")
    assert rec.backend == "ffmpeg" and rec.codec == "hevc_nvenc"
    rec.stop_recorder()


# ----------------------------------------------------------------- pipeline --

class _Capture:
    """A stand-in recorder that keeps the frames it is given (BGR)."""

    frames: list = []

    def __init__(self, save_path, video_dimensions=(0, 0), fps=30.0, codec=None):
        self.dimension = tuple(video_dimensions)
        _Capture.frames = []

    def write_frame(self, image):
        assert image.shape == (self.dimension[1], self.dimension[0], 3)
        _Capture.frames.append(np.array(image))

    def stop_recorder(self):
        pass

    def add_audio(self, src):
        return 0


def test_pipeline_equals_the_serial_loop_bit_for_bit(clip, sr_x2):
    """video_pipeline's frames equal a serial loop of upscale_batch over
    the same batches, bit for bit, and in order."""
    _, path = clip
    engine = TiledUpscaler(load_artifact(sr_x2, device="cpu"), batch_size=4)
    src = VideoSource(path)
    batches = list(src.batches(4))
    src.close()
    got = []
    assert rs.video_pipeline(engine, iter(batches), got.append) == 10
    serial = [f for b, n in batches for f in engine.upscale_batch(b)[:n]]
    assert len(got) == len(serial) == 10
    for a, b in zip(got, serial):
        np.testing.assert_array_equal(a, b)


def test_rs_video_frames_match_jax_upscale_batch(clip, sr_x2, tmp_path, monkeypatch):
    """rs on the clip through a stand-in recorder: every frame within 1 LSB
    of the JAX engine's ``upscale_batch`` on the same decoded batches (both
    in bf16, whose graphs round differently)."""
    _, path = clip
    monkeypatch.setattr(recorder, "FFMPEGRecorder", _Capture)
    rs.main(["--model", str(sr_x2), "--src", str(path), "--save_dir",
             str(tmp_path / "up.mp4"), "--batch_size", "4", "--device", "cpu"])
    got = np.stack(_Capture.frames)[..., ::-1]
    engine = JaxTiledUpscaler(jax_load_artifact(sr_x2), batch_size=4)
    src = JaxVideoSource(path)
    want = np.concatenate([engine.upscale_batch(b)[:n] for b, n in src.batches(4)])
    src.close()
    assert got.shape == want.shape == (10, 96, 128, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_rs_video_path(clip, sr_x2, tmp_path):
    """decode -> x2 -> encode through the CLI (cv2 here): dimensions and
    frame count of the written file."""
    _, path = clip
    out = rs.main(["--model", str(sr_x2), "--src", str(path), "--save_dir",
                   str(tmp_path / "up"), "--batch_size", "4", "--device", "cpu"])
    assert out == tmp_path / "up.mp4" and out.exists()
    cap = cv2.VideoCapture(str(out))
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == 128
    assert int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == 96
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 10
    cap.release()


def test_rs_video_int8_calibrates_on_the_first_frames(clip, tmp_path):
    """--int8 on a video: the calibration batch is the first 4 frames, as
    the JAX CLI's; then the int8 fast x2 path writes every frame."""
    tmp, path = clip
    got, want = rs._int8_calib_batches(path, 96), jax_rs._int8_calib_batches(path, 96)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (4, 48, 64, 3)
    spec = DeploySpec(family="fast", depth=2, width=8, scale=2)
    isr = tmp / "fast.isr"
    save_artifact(isr, spec, init_fused_params(spec, 1))
    out = rs.main(["--model", str(isr), "--src", str(path), "--save_dir",
                   str(tmp_path / "q.mp4"), "--batch_size", "4", "--device", "cpu", "--int8"])
    assert _frames(out).shape == (10, 96, 128, 3)


def test_video_stop_recorder_failure_propagates_inside_handler(clip, sr_x2, tmp_path,
                                                               monkeypatch):
    """A dead encoder at stop_recorder means a truncated file: the error
    propagates on the success path, also inside a caller's except block."""
    _, path = clip
    real_stop = recorder.FFMPEGRecorder.stop_recorder

    def dying_stop(self):
        real_stop(self)  # still release the writer
        raise BrokenPipeError("encoder died at stop")

    monkeypatch.setattr(recorder.FFMPEGRecorder, "stop_recorder", dying_stop)
    try:
        raise KeyError("outer handled exception")
    except KeyError:
        with pytest.raises(BrokenPipeError, match="encoder died"):
            rs.main(["--model", str(sr_x2), "--src", str(path), "--save_dir",
                     str(tmp_path / "up.mp4"), "--batch_size", "4", "--device", "cpu"])


def test_pipeline_surfaces_decode_and_compute_failures(clip, sr_x2):
    """A decoder failure reaches the caller after the frames before it; a
    compute failure stops and drains the decoder thread."""
    engine = TiledUpscaler(load_artifact(sr_x2, device="cpu"), batch_size=2)

    def broken():
        yield np.zeros((2, 8, 8, 3), np.uint8), 2
        raise ValueError("bad packet")

    got = []
    with pytest.raises(RuntimeError, match="video decode failed") as e:
        rs.video_pipeline(engine, broken(), got.append)
    assert isinstance(e.value.__cause__, ValueError) and len(got) == 2

    def endless():
        while True:
            yield np.zeros((2, 8, 8, 3), np.uint8), 2

    class Failing:
        deployed = engine.deployed

        def upscale_batch_device(self, batch, n_valid=None):
            raise MemoryError("device full")

    with pytest.raises(MemoryError):
        rs.video_pipeline(Failing(), endless(), got.append)
