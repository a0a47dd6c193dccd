"""Inference CLI ("rs" = resolution scaler) for images, folders and video
(counterpart of the JAX package's ``cli/rs.py``).

    python -m image_super_resolution_tpu_torch.cli.rs --model a.isr --src img.png

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``). Image
path: load artifact -> overlap-tiled batched upscale -> PNG. A folder is
served image by image with one loaded model. A video is decoded, upscaled
in fixed-size frame batches and encoded, three stages overlapped
(``video_pipeline``), and its audio is remuxed. ``--int8`` serves a
fast-family artifact with its trunk in int8, calibrated on crops of the
input itself (on a video, its first frames). ``--profile_dir`` writes a
``torch.profiler`` trace of the whole run. ``--data_devices``,
``--spatial_devices``, ``--spatial_grid`` and ``--tp_devices`` serve over
several devices (one sharding axis at a time): on ``--device cuda`` the
distinct local cards, and asking for more than there are exits; on
``--device cpu`` the CPU stands for as many shards as asked.
"""

from __future__ import annotations

import argparse
import contextlib
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..utils.general import IMG_FORMATS, VID_FORMATS
from ..utils.image_io import read_image_rgb as _read_image_rgb
from ..utils.profiling import annotate, trace

# A sequence model's default segment: BasicSR's inference_basicvsr.py runs a
# video in separate segments of --interval 15 frames.
SEGMENT = 15


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Tiled SR inference (image, folder or video)")
    parser.add_argument("--model", type=str, required=True, help="deployed artifact (.isr)")
    parser.add_argument("--src", type=str, required=True)
    parser.add_argument("--save_dir", type=str, default="result.png")
    parser.add_argument("--window_size", type=int, default=96,
                        help="tile size; 0 = whole-image (untiled) inference")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="frames or tiles a forward (default 8); for a sequence "
                             "model (basicvsr) the video segment length, default 15")
    parser.add_argument("--worker", type=int, default=4, help="accepted for parity; unused")
    parser.add_argument("--overlap", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--spatial_devices", type=int, default=1,
                        help="shard large images over N devices (halo exchange); "
                             "applies to the single-image/folder path — for "
                             "video/batch throughput use --data_devices")
    parser.add_argument("--spatial_grid", type=int, nargs=2, default=None,
                        metavar=("NY", "NX"),
                        help="2-D generalization of --spatial_devices: shard "
                             "one image over an NYxNX device grid with halo "
                             "exchange in both dimensions (less halo overhead "
                             "than 1-D row bands at 8+ devices)")
    parser.add_argument("--data_devices", type=int, default=1,
                        help="shard tile/frame batches over N devices (data "
                             "axis) — multi-device serving throughput for the "
                             "tiled image, folder, and video paths; 0 = all "
                             "local devices. Mutually exclusive with "
                             "--spatial_devices")
    parser.add_argument("--tp_devices", type=int, default=1,
                        help="tensor parallelism: channel-shard the fast "
                             "families' trunk over N local devices (0 = "
                             "all), one reduction per residual block — the "
                             "latency-bound serving axis for single images "
                             "when the batch is too small for "
                             "--data_devices. Covers fast AND denoise_fast "
                             "(downshuffle front + refine tail included); "
                             "the sr/denoise reference topologies serve via "
                             "--data_devices/--spatial_devices. The four "
                             "sharding flags count the distinct local cards "
                             "on --device cuda; on --device cpu the CPU "
                             "stands for as many devices as asked")
    parser.add_argument("--int8", action="store_true",
                        help="serve the fast-family trunk in int8 (PTQ "
                             "self-calibrated on the input; fast and "
                             "denoise_fast artifacts only)")
    parser.add_argument("--int8_percentile", type=float, default=None,
                        help="with --int8: calibrate activation scales to "
                             "this percentile of |x| (0 < p <= 100, e.g. "
                             "99.99) instead of the max")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the whole run (host "
                             "ops and the card's kernels) into this directory")
    parser.add_argument("--compile_cache", type=str, default=None,
                        help="accepted for parity; the port compiles no XLA programs")
    parser.add_argument("--codec", type=str, default=None,
                        help="ffmpeg video encoder (e.g. libx264, hevc_nvenc); default "
                             "'auto' probes the hardware HEVC encoders, then libx264")
    return parser


def main(argv=None):
    kwargs = vars(build_parser().parse_args(argv))
    profile_dir = kwargs.pop("profile_dir")
    with trace(profile_dir) if profile_dir else contextlib.nullcontext():
        result = run(**kwargs)
    if profile_dir:
        print(f"profiler trace written to {profile_dir}")
    return result


def _check_sharding_flags(spatial_devices, data_devices, spatial_grid, tp_devices,
                          int8, int8_percentile) -> bool:
    """The JAX CLI's checks of the sharding and int8 flags, made before the
    artifact loads; returns whether tensor parallelism is asked for."""
    if tp_devices < 0:
        raise SystemExit(
            f"--tp_devices must be >= 0 (0 = all local devices), got {tp_devices}")
    use_tp = tp_devices == 0 or tp_devices > 1
    # != 1, not > 1: 0 means "all local devices" for both axes and must
    # conflict too
    if use_tp and (spatial_devices != 1 or data_devices != 1 or spatial_grid):
        raise SystemExit("--tp_devices is mutually exclusive with --spatial_devices/"
                         "--spatial_grid/--data_devices: pick ONE sharding axis")
    if int8 and use_tp:
        raise SystemExit("--int8 is mutually exclusive with --tp_devices (the "
                         "TP wrapper shards the bf16 graph; an int8-TP path "
                         "is not built)")
    if int8 and (spatial_devices != 1 or spatial_grid):
        # requantization at every conv input turns the halo's sub-LSB
        # differences into whole int8 steps; --data_devices stays allowed
        # (the same per-shard shapes: bit-equal)
        raise SystemExit("--int8 is mutually exclusive with --spatial_devices/"
                         "--spatial_grid: requantization amplifies "
                         "band-boundary differences; use --data_devices for "
                         "multi-chip int8 serving")
    if int8_percentile is not None:
        from ..models.quantized import check_percentile

        try:
            check_percentile(int8_percentile)
        except ValueError as e:
            raise SystemExit(f"--int8_percentile: {e}") from None
    return use_tp


def run(
    model: str,
    src: str,
    save_dir: str = "result.png",
    window_size: int = 96,
    batch_size: int | None = None,
    overlap: int = 8,
    worker: int = 4,
    device: str = "cuda",
    spatial_devices: int = 1,
    data_devices: int = 1,
    spatial_grid=None,
    tp_devices: int = 1,
    int8: bool = False,
    int8_percentile: float | None = None,
    codec: str | None = None,
    compile_cache: str | None = None,
) -> Path:
    from ..infer.engine import TiledUpscaler
    from ..models.deploy import load_artifact

    src_path = Path(src)
    out_path = Path(save_dir)
    use_tp = _check_sharding_flags(spatial_devices, data_devices, spatial_grid,
                                   tp_devices, int8, int8_percentile)
    deployed = load_artifact(model, device=device)
    sequence = getattr(deployed.model, "sequence", False)
    if sequence and not (src_path.is_file() and src_path.suffix.lower() in VID_FORMATS):
        raise SystemExit(f"a {deployed.spec.family} artifact is a sequence model: "
                         f"--src must be a video")
    if batch_size is None:
        batch_size = SEGMENT if sequence else 8
    if (spatial_devices != 1 or spatial_grid) and (deployed.spec.downshuffle or 1) > 1:
        raise SystemExit(
            "--spatial_devices/--spatial_grid cannot serve a downshuffle>1 "
            "artifact (denoise_fast): band offsets shift the model's "
            "space_to_depth grid, so the output would depend on the device "
            "count; use --data_devices (x1 images are small per-tile anyway)"
        )
    if int8:
        from ..models.quantized import quantize_deployed

        try:  # quantize_deployed owns the family whitelist
            deployed = quantize_deployed(
                deployed, _int8_calib_batches(src_path, window_size),
                percentile=int8_percentile)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    if use_tp:
        # channel-shard the model itself; the engine tiles through it
        from ..core.mesh import local_devices
        from ..parallel.tensor import TPFastUpscaler

        local = local_devices(device, tp_devices)
        n_tp = tp_devices or len(local)
        if n_tp > len(local):
            raise SystemExit(f"--tp_devices {n_tp}: only {len(local)} local devices")
        try:
            deployed = TPFastUpscaler(deployed, local[:n_tp])
        except ValueError as e:
            raise SystemExit(str(e))
    try:
        engine = TiledUpscaler(deployed, window=window_size, overlap=overlap,
                               batch_size=batch_size, spatial_devices=spatial_devices,
                               data_devices=data_devices, spatial_grid=spatial_grid)
    except ValueError as e:
        # mode exclusivity, device counts, downshuffle grid alignment
        raise SystemExit(str(e))
    if src_path.is_dir():
        return _run_folder(engine, src_path, out_path)
    if src_path.suffix.lower() in VID_FORMATS:
        # the engine's batch: under --data_devices a multiple of the devices
        return _run_video(engine, src_path, out_path, engine.batch_size, codec=codec)
    return _run_image(engine, src_path, out_path)


def _output_names(images) -> list:
    """Outputs are always .png; photo.jpg and photo.png share a stem, so
    duplicate stems fold the whole source name in, and any remaining
    collision gets a numeric suffix."""
    stem_counts = Counter(p.stem for p in images)
    bases = [
        p.name[: -len(p.suffix)] if stem_counts[p.stem] == 1
        else p.name.replace(".", "_")
        for p in images
    ]
    used: set = set()
    out_names = []
    for base in bases:
        name, k = f"{base}.png", 1
        while name in used:
            name = f"{base}_{k}.png"
            k += 1
        used.add(name)
        out_names.append(name)
    return out_names


def _run_folder(engine, src_path: Path, out_path: Path) -> Path:
    """One loaded model serves every image; a small IO pool reads the next
    image and writes the previous result while the device upscales."""
    images = sorted(p for p in src_path.iterdir() if p.suffix.lower() in IMG_FORMATS)
    if not images:
        raise FileNotFoundError(f"no images in {src_path}")
    out_path.mkdir(parents=True, exist_ok=True)
    failed = []

    def fail(name, e):
        import warnings

        failed.append(name)
        warnings.warn(f"skipping {name}: {type(e).__name__}: {e}")

    items = list(zip(images, _output_names(images)))
    with ThreadPoolExecutor(max_workers=2) as io_pool:
        depth = 2
        reads = deque(
            (p, name, io_pool.submit(_read_image_rgb, p)) for p, name in items[:depth]
        )
        next_i = len(reads)
        writes = []
        while reads:
            p, out_name, fut = reads.popleft()
            if next_i < len(items):
                p2, n2 = items[next_i]
                reads.append((p2, n2, io_pool.submit(_read_image_rgb, p2)))
                next_i += 1
            try:  # one bad file must not kill the batch
                image = fut.result()
                print("input shape", image.shape, p.name)
                result = engine.upscale_image(image)
                writes.append(
                    (p.name, io_pool.submit(_write_png, out_path / out_name, result))
                )
            except Exception as e:
                fail(p.name, e)
        for name, wf in writes:
            try:
                wf.result()
            except Exception as e:
                fail(name, e)
    if failed:
        print(f"batch done with {len(failed)} failure(s): {failed[:5]}")
        if len(failed) == len(images):
            raise RuntimeError("every image in the batch failed")
    return out_path


def _grid_crops(img: np.ndarray, c: int, ny: int, nx: int) -> list:
    h, w = img.shape[:2]
    c = max(1, min(c, h, w))  # images smaller than the crop: use them whole
    ys = np.linspace(0, h - c, ny, dtype=int)
    xs = np.linspace(0, w - c, nx, dtype=int)
    return [img[y:y + c, x:x + c] for y in ys for x in xs]


def _int8_calib_batches(src_path: Path, window: int) -> list:
    """PTQ calibration data from the input itself, as one uint8 batch.
    Activation scales are per-tensor scalars, so any crop size serves any
    serving shape. A folder gives crops of up to 8 images spread across it
    (skipping unreadable ones), at one common crop size; a single image
    gives a 2 x 4 grid of crops; a video its first 4 frames."""
    if src_path.suffix.lower() in VID_FORMATS and src_path.is_file():
        from ..video.reader import VideoSource

        source = VideoSource(src_path)
        try:
            batch, n_valid = next(iter(source.batches(4)))
            return [batch[:n_valid]]
        finally:
            source.close()
    c = window or 96
    if src_path.is_dir():
        images = sorted(p for p in src_path.iterdir() if p.suffix.lower() in IMG_FORMATS)
        if not images:
            raise FileNotFoundError(f"no images in {src_path}")
        sel = images[:: max(1, len(images) // 8)][:8]
        imgs = []
        for p in sel:
            try:
                imgs.append(_read_image_rgb(p))
            except Exception as e:
                print(f"int8 calibration: skipping unreadable {p}: {e}")
        if not imgs:
            raise FileNotFoundError(
                f"no readable calibration images among {len(sel)} sampled "
                f"from {src_path}")
        c = max(1, min([c] + [min(i.shape[:2]) for i in imgs]))
        crops = [crop for i in imgs
                 for crop in _grid_crops(i, c, 1, max(1, 8 // len(imgs)))]
    else:
        img = _read_image_rgb(src_path)
        c = max(1, min(c, *img.shape[:2]))
        crops = _grid_crops(img, c, 2, 4)
    return [np.stack(crops)]


def _write_png(out: Path, result_rgb: np.ndarray) -> Path:
    out.parent.mkdir(parents=True, exist_ok=True)
    try:
        import cv2
    except ImportError:
        from ..utils.png import write_png

        write_png(out, result_rgb)
    else:
        if not cv2.imwrite(str(out), result_rgb[..., ::-1]):
            raise IOError(f"failed to write {out}")
    print("output shape", result_rgb.shape, str(out))
    return out


def _run_image(engine, src: Path, out: Path) -> Path:
    image = _read_image_rgb(src)
    print("input shape", image.shape)
    result = engine.upscale_image(image)
    if out.suffix.lower() != ".png":  # append, never replace: "a.v2" is a
        out = out.parent / (out.name + ".png")  # stem, not a suffix to drop
    return _write_png(out, result)


def _fetch_async(out):
    """Enqueue the device -> host copy of a result behind its compute (into
    pinned memory, without blocking) and return a function that waits for
    that copy alone and gives the frames as numpy. Launched before the next
    batch, the copy does not wait for that batch's compute. ``out`` is a
    tensor, or the shards of a batch split over several devices (each
    copied behind its own device's compute, concatenated in order)."""
    import torch

    shards = [out] if isinstance(out, torch.Tensor) else list(out)
    copies = []
    for s in shards:
        if s.device.type != "cuda":
            copies.append((s, None))
            continue
        host = s.to("cpu", non_blocking=True)  # pinned: the copy is asynchronous
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(s.device))
        copies.append((host, copied))

    def wait():
        for _, copied in copies:
            if copied is not None:
                copied.synchronize()
        frames = [host.numpy() for host, _ in copies]
        return frames[0] if len(frames) == 1 else np.concatenate(frames)

    return wait


def video_pipeline(engine, batches, write_frame) -> int:
    """Upscale (batch, n_valid) items from ``batches`` and hand every valid
    output frame (RGB uint8 HWC) to ``write_frame``, in order; returns the
    number of frames written. Three stages overlap:

    - a thread decodes the next batches (bounded queue of 2);
    - the device computes batch k (``upscale_batch_device``, no fetch);
    - this thread writes batch k-1, whose copy to the host was enqueued
      right after k-1's compute and before k was launched, so waiting for
      it does not wait for k.

    The frames equal a serial loop of ``upscale_batch`` bit for bit. The
    decoder thread is stopped and drained also when a stage raises. In a
    ``--profile_dir`` trace this thread's two stages are the regions
    ``video/upscale`` and ``video/write`` (the profiler does not follow the
    decoder thread)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=2)
    done = object()
    stop = threading.Event()
    producer_exc: list = []

    def put(item) -> bool:
        # a bounded put that gives up once the consumer stopped
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def decode():
        try:
            for item in batches:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, never swallowed
            producer_exc.append(e)
        finally:
            put(done)

    producer = threading.Thread(target=decode, daemon=True)
    producer.start()
    n = 0
    pending = None  # (fetch, n_valid) of the previous batch

    def write(fetch, n_valid):
        nonlocal n
        for frame in fetch()[:n_valid]:
            write_frame(frame)
            n += 1

    try:
        while True:
            item = q.get()
            if item is done:
                break
            batch, n_valid = item
            with annotate("video/upscale"):
                out, _ = engine.upscale_batch_device(batch, n_valid)
                fetch = _fetch_async(out)
            if pending is not None:  # batch k-1, while batch k computes
                with annotate("video/write"):
                    write(*pending)
            pending = (fetch, n_valid)
        if pending is not None:
            with annotate("video/write"):
                write(*pending)
        if producer_exc:
            raise RuntimeError("video decode failed") from producer_exc[0]
    finally:
        stop.set()
        while True:  # drain so a put-blocked producer sees the stop
            try:
                q.get_nowait()
            except queue.Empty:
                break
        producer.join(timeout=30)
    return n


def _run_video(engine, src: Path, out: Path, batch_size: int,
               codec: str | None = None) -> Path:
    """Decode -> upscale -> encode through ``video_pipeline``, then remux the
    source's audio. The artifact owns all normalization."""
    from ..video.reader import VideoSource
    from ..video.recorder import FFMPEGRecorder

    source = VideoSource(src)
    out = out.with_suffix(".mp4")
    out.parent.mkdir(parents=True, exist_ok=True)
    scale = engine.deployed.spec.output_scale
    try:
        recorder = FFMPEGRecorder(str(out), video_dimensions=(source.width * scale,
                                                              source.height * scale),
                                  fps=source.fps, codec=codec)
    except BaseException:
        source.close()
        raise
    body_ok = False
    try:
        n = video_pipeline(engine, source.batches(batch_size),
                           lambda frame: recorder.write_frame(frame[..., ::-1]))  # to BGR
        body_ok = True
    finally:
        # Always release the encoder and the decoder. stop_recorder can raise
        # on a dead ffmpeg pipe: that must not mask an error in flight, but on
        # the success path it propagates, since the file is then truncated
        # (a local flag, not sys.exc_info(), which also sees a caller's
        # handled exception).
        stop_err = None
        try:
            recorder.stop_recorder()
        except Exception as e:
            stop_err = e
        source.close()
        if stop_err is not None and body_ok:
            raise stop_err
    recorder.add_audio(src)
    print(f"wrote {n} frames -> {out}")
    return out


if __name__ == "__main__":
    main()
