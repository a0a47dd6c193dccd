"""Video encode backend (counterpart of the JAX package's
``video/recorder.py``, which imports no JAX; copied so that the port stands
alone).

The reference's ``FFMPEG_recorder`` surface: ``FFMPEGRecorder(save_path,
video_dimensions, fps)`` with ``write_frame`` (BGR uint8 HWC),
``stop_recorder``, ``add_audio``, ``write_subtitle`` / ``add_subtitle``;
snake_case is the native spelling and the reference's camelCase names are
aliases. By default the hardware HEVC encoders (hevc_nvenc, hevc_amf,
hevc_vaapi, in the reference's order) are probed functionally (listed in
``ffmpeg -encoders`` and able to encode one test frame), else libx264;
``codec=`` pins one. Without an ffmpeg binary, OpenCV's VideoWriter (mp4v);
else a clear error. Bitrate: 20 Mbps scaled by megapixels / (3840 x 2160)
and by fps / 30.
"""

from __future__ import annotations

import math
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def _ffmpeg_exe() -> Optional[str]:
    return shutil.which("ffmpeg")


# The reference's hardware-encoder preference order.
_HW_ENCODER_CANDIDATES = ("hevc_nvenc", "hevc_amf", "hevc_vaapi")
_probe_cache: dict = {}


def probe_encoder(exe: str) -> str:
    """Pick the best available video encoder for this host.

    The first candidate from ``_HW_ENCODER_CANDIDATES`` that both appears in
    ``ffmpeg -encoders`` and successfully encodes one synthetic test frame
    wins; otherwise libx264 (the reference's fallback, ffmpeg.py:52). Being
    listed does not imply a usable device — hevc_vaapi is compiled into most
    ffmpeg builds but needs a render node — hence the functional encode.
    Result is cached per binary path for the life of the process.
    """
    cached = _probe_cache.get(exe)
    if cached is not None:
        return cached
    try:
        listed = subprocess.run(
            [exe, "-hide_banner", "-encoders"],
            capture_output=True, text=True, timeout=15,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        listed = ""
    choice = "libx264"
    for cand in _HW_ENCODER_CANDIDATES:
        if cand not in listed:
            continue
        try:
            test = subprocess.run(
                [exe, "-v", "error", "-f", "lavfi",
                 "-i", "color=c=black:s=64x64:d=0.1", "-frames:v", "1",
                 "-c:v", cand, "-f", "null", "-"],
                capture_output=True, timeout=30,
            )
        except (OSError, subprocess.SubprocessError):
            continue
        if test.returncode == 0:
            choice = cand
            break
    _probe_cache[exe] = choice
    return choice


def second_to_timecode(x: float = 0.0) -> str:
    hour, x = divmod(x, 3600)
    minute, x = divmod(x, 60)
    second, x = divmod(x, 1)
    return "%.2d:%.2d:%.2d,%.3d" % (hour, minute, second, int(x * 1000.0))


class FFMPEGRecorder:
    """Streaming video encoder; frames are BGR uint8 HWC (cv2 convention)."""

    def __init__(
        self,
        save_path: str,
        video_dimensions: Tuple[int, int] = (1280, 720),
        fps: float = 30.0,
        codec: Optional[str] = None,
    ):
        save_path = str(save_path).replace(" ", "_")
        self.save_path = save_path
        self.dimension = tuple(video_dimensions)  # (width, height)
        self.fps = fps
        self.count_frame = 0
        self.start_time = 0.0
        self.subtitle_content = ""
        mpx = math.prod(self.dimension)
        self.bit_rate = round(
            20 * (mpx / (3840 * 2160)) * max(1.0, round(fps / 30, 3)), 3
        )
        self._proc: Optional[subprocess.Popen] = None
        self._cv2_writer = None

        exe = _ffmpeg_exe()
        if exe is not None:
            if codec in (None, "auto"):
                codec = probe_encoder(exe)
            self.codec = codec
            cmd = [
                exe, "-v", "quiet", "-y",
                "-s", f"{self.dimension[0]}x{self.dimension[1]}",
                "-pixel_format", "bgr24", "-f", "rawvideo",
                "-r", f"{self.fps}", "-i", "pipe:",
                "-vcodec", self.codec, "-pix_fmt", "yuv420p",
                "-b:v", f"{self.bit_rate}M", save_path,
            ]
            self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
            self.backend = "ffmpeg"
        else:
            try:
                import cv2

                fourcc = cv2.VideoWriter_fourcc(*"mp4v")
                self._cv2_writer = cv2.VideoWriter(
                    save_path, fourcc, fps, self.dimension
                )
                if not self._cv2_writer.isOpened():
                    raise RuntimeError("cv2.VideoWriter failed to open")
                self.codec = "mp4v"
                self.backend = "cv2"
            except Exception as exc:
                raise RuntimeError(
                    "no video encoder available: ffmpeg binary not found and "
                    f"OpenCV VideoWriter failed ({exc})"
                ) from exc
        print(
            f"Using video backend: {self.backend} ({self.codec}), "
            f"{self.dimension[0]}x{self.dimension[1]} @ {fps} fps"
        )

    # -- frames ------------------------------------------------------------
    def write_frame(self, image: np.ndarray) -> None:
        """image: BGR uint8 HWC with shape (height, width, 3)."""
        if self._proc is not None:
            self._proc.stdin.write(np.ascontiguousarray(image).tobytes())
        else:
            self._cv2_writer.write(np.ascontiguousarray(image))

    # -- subtitles ----------------------------------------------------------
    def write_subtitle(self, title: str = "", fps: Optional[float] = None) -> None:
        fps = fps or self.fps
        step = 1.0 / fps
        t0 = second_to_timecode(self.start_time)
        t1 = second_to_timecode(self.start_time + step)
        self.start_time += step
        title = title or "UTC2"
        self.subtitle_content += f"{self.count_frame}\n{t0} --> {t1}\n{title}\n\n"
        self.count_frame += 1

    def add_subtitle(self, hard_subtitle: bool = False) -> Optional[int]:
        sub_file = Path(self.save_path).with_suffix(".srt")
        sub_file.write_text(self.subtitle_content)
        exe = _ffmpeg_exe()
        if exe is None:
            print(f"ffmpeg unavailable: wrote sidecar subtitles to {sub_file}")
            return None
        out = str(Path(self.save_path).with_name(Path(self.save_path).stem + "_sub.mp4"))
        if hard_subtitle:
            cmd = [exe, "-hide_banner", "-y", "-i", self.save_path,
                   "-vf", f"subtitles={sub_file}", out]
        else:
            cmd = [exe, "-hide_banner", "-y", "-i", self.save_path, "-i", str(sub_file),
                   "-c:v", "copy", "-c:s", "mov_text",
                   "-metadata:s:s:0", "language=eng", out]
        return subprocess.run(cmd).returncode

    # -- audio ----------------------------------------------------------------
    def add_audio(self, audio_src: str | Path) -> int:
        """Remux the source's audio track into the encoded video (ffmpeg.py:121-134)."""
        audio_src = Path(audio_src)
        exe = _ffmpeg_exe()
        if not audio_src.is_file():
            return 0
        if exe is None:
            print("ffmpeg unavailable: skipping audio remux")
            return 0
        out = self.save_path.replace(".mp4", "_audio.mp4")
        cmd = [exe, "-y", "-i", self.save_path, "-i", audio_src.as_posix(),
               "-c:v", "copy", "-map", "0:v", "-map", "1:a", out]
        subprocess.run(cmd)
        return 1

    def stop_recorder(self) -> None:
        if self._proc is not None:
            try:
                self._proc.stdin.close()  # can raise on a dead ffmpeg pipe
            finally:
                self._proc.wait()  # always reap — no zombie child
        if self._cv2_writer is not None:
            self._cv2_writer.release()

    # reference-compatible camelCase aliases
    writeFrame = write_frame
    writeSubtitle = write_subtitle
    addSubtitle = add_subtitle
    addAudio = add_audio
    stopRecorder = stop_recorder


FFMPEG_recorder = FFMPEGRecorder  # reference-compatible name
