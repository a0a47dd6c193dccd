"""Streaming video frame source (counterpart of the JAX package's
``video/reader.py``).

A generator yields fixed-size RGB uint8 batches: one batch shape for the
whole stream, the tail batch padded with its last frame and trimmed after
inference. Frames are decoded by OpenCV where ``cv2`` imports, as in the
JAX package; otherwise by an ``ffmpeg`` pipe (raw ``rgb24`` on its stdout,
the metadata from ``ffprobe``). Without cv2 and without both binaries,
opening a source raises and names them.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import tempfile
from fractions import Fraction
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np


def _ffprobe_meta(exe: str, src: Path) -> Tuple[float, int, int, int]:
    """(fps, width, height, frame count or 0) of the first video stream."""
    out = subprocess.run(
        [exe, "-v", "error", "-select_streams", "v:0", "-show_entries",
         "stream=width,height,r_frame_rate,nb_frames", "-of", "json", str(src)],
        capture_output=True, text=True, timeout=60)
    streams = json.loads(out.stdout or "{}").get("streams") or []
    if out.returncode or not streams:
        raise IOError(f"cannot open video: {src} (ffprobe: {out.stderr.strip()[:200]})")
    st = streams[0]
    rate = Fraction(st.get("r_frame_rate") or "0")
    n = st.get("nb_frames", "0")
    return (float(rate) or 30.0, int(st["width"]), int(st["height"]),
            int(n) if str(n).isdigit() else 0)


class VideoSource:
    """Sequential frame reader with metadata (``fps``, ``width``,
    ``height``, ``total_frames``; 0 frames when the container does not
    say)."""

    def __init__(self, src: str | Path):
        self.src = Path(src)
        self._cap = self._proc = None
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            self.backend = "cv2"
            self._cap = cv2.VideoCapture(str(src))
            if not self._cap.isOpened():
                raise IOError(f"cannot open video: {src}")
            self.fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0
            self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self.total_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
            return
        exe, probe = shutil.which("ffmpeg"), shutil.which("ffprobe")
        if exe is None or probe is None:
            raise RuntimeError("no video decoder: OpenCV (cv2) does not import and "
                               "ffmpeg and ffprobe are not both on PATH")
        if not self.src.is_file():
            raise IOError(f"cannot open video: {src}")
        self.backend = "ffmpeg"
        self.fps, self.width, self.height, self.total_frames = _ffprobe_meta(probe, self.src)
        self._err = tempfile.TemporaryFile()  # a file, so a chatty decoder never blocks
        self._proc = subprocess.Popen(
            [exe, "-v", "error", "-i", str(self.src), "-f", "rawvideo", "-pix_fmt", "rgb24",
             "-"], stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=self._err)

    def frames(self) -> Iterator[np.ndarray]:
        """Yield RGB uint8 HWC frames."""
        if self._cap is not None:
            while True:
                ok, frame = self._cap.read()
                if not ok:
                    return
                yield frame[..., ::-1]  # BGR -> RGB
        size = self.width * self.height * 3
        while True:
            buf = self._proc.stdout.read(size)
            if len(buf) < size:
                break
            yield np.frombuffer(buf, np.uint8).reshape(self.height, self.width, 3)
        if self._proc.wait() != 0:
            self._err.seek(0)
            raise IOError(f"ffmpeg failed decoding {self.src} (exit {self._proc.returncode}): "
                          f"{self._err.read().decode(errors='replace').strip()[:300]}")

    def batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield (RGB uint8 NHWC batch, n_valid) with a fixed batch size: the
        tail batch repeats its last frame."""
        buf = []
        for frame in self.frames():
            buf.append(frame)
            if len(buf) == batch_size:
                yield np.stack(buf), batch_size
                buf = []
        if buf:
            n_valid = len(buf)
            while len(buf) < batch_size:
                buf.append(buf[-1])
            yield np.stack(buf), n_valid

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()
        if self._proc is not None:
            if self._proc.poll() is None:
                self._proc.kill()
            self._proc.stdout.close()
            self._proc.wait()
            self._err.close()
