"""One-command demo: reference weights -> restored image (counterpart of the
JAX package's ``cli/demo.py``).

It converts a reference TorchScript artifact (the reference repo's bundled
``model.pt``, the legacy denoiser, reference utils/models.py:801-802) into
an ``.isr`` artifact and serves it on a sample image:

    python -m image_super_resolution_tpu_torch.cli.demo --model_pt model.pt
    python -m image_super_resolution_tpu_torch.cli.demo --src my_photo.png

With no ``--src`` the demo draws a clean test card, degrades it the way the
denoiser was trained to expect (gaussian noise + JPEG, reference
utils/datasets.py:374-376 defaults), restores it and prints the PSNR of
input and output. A generator-family ``.pt`` works too: the demo then
downscales the test card and upscales it back, against a bicubic baseline.
``--device`` (default ``cuda``) is where the model serves. The reference's
``model.pt`` is not in this repository: pass ``--model_pt``.
"""

from __future__ import annotations

import argparse
import io
from pathlib import Path

import numpy as np
import torch

# The JAX demo also searches one absolute path of its build host; the port
# searches relative to the working directory only.
_SEARCH = ("model.pt", "reference/model.pt")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Out-of-box demo on bundled weights")
    parser.add_argument("--model_pt", type=str, default=None,
                        help="reference TorchScript artifact; default: search "
                             + ", ".join(_SEARCH))
    parser.add_argument("--src", type=str, default=None,
                        help="image to restore; default: synthesized test card")
    parser.add_argument("--out_dir", type=str, default="demo_out")
    parser.add_argument("--window_size", type=int, default=96)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


def find_model_pt(explicit: str | None) -> Path:
    if explicit:
        p = Path(explicit)
        if not p.exists():
            raise FileNotFoundError(f"--model_pt {p} does not exist")
        return p
    for cand in _SEARCH:
        p = Path(cand)
        if p.exists():
            return p
    raise FileNotFoundError(
        "no bundled model.pt found (searched " + ", ".join(_SEARCH)
        + ") — pass --model_pt pointing at the reference repo's model.pt")


def make_test_card(size: int = 192, seed: int = 0) -> np.ndarray:
    """Clean uint8 RGB test card: gradients, edges and fine texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    r = 255 * x
    g = 255 * y
    b = 255 * (0.5 + 0.5 * np.sin(14 * np.pi * (x + y) / 2))  # diagonal bars
    img = np.stack([r, g, b], axis=-1)
    # checker patch (hard edges) and a smooth disc (gradients)
    q = size // 4
    checker = (((np.arange(q)[:, None] // 6) + (np.arange(q)[None, :] // 6)) % 2)
    img[q: 2 * q, q: 2 * q] = 255 * checker[..., None]
    cy, cx = 3 * size // 4, size // 2
    d2 = (y * (size - 1) - cy) ** 2 + (x * (size - 1) - cx) ** 2
    disc = np.clip(1 - d2 / (size / 5) ** 2, 0, 1)
    img[..., 1] = np.clip(img[..., 1] + 120 * disc, 0, 255)
    img += rng.normal(0, 2.0, img.shape)  # fine film-grain texture
    return np.clip(img, 0, 255).astype(np.uint8)


def degrade_like_training(clean: np.ndarray, seed: int = 1, sigma: float = 7.0,
                          jpeg_quality: int = 60) -> np.ndarray:
    """Gaussian noise + a JPEG round trip (PIL), the denoise phase's
    degradation family at defaults inside its training ranges (GaussNoise
    var 10-50 -> sigma <= 7.1; ImageCompression quality 50-75)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    noisy = clean.astype(np.float32) + rng.normal(0, sigma, clean.shape)
    noisy = np.clip(noisy, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(noisy).save(buf, format="JPEG", quality=jpeg_quality)
    return np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    """``utils.metrics.psnr`` on uint8 arrays, the eval CLI's metric."""
    from ..utils.metrics import psnr

    return float(psnr(torch.tensor(a), torch.tensor(b), max_val=255.0))


def main(argv=None) -> Path:
    """Run the demo; returns the restored image's path."""
    opt = build_parser().parse_args(argv)

    from ..infer.engine import TiledUpscaler
    from ..interop.torch_import import import_torchscript_artifact
    from ..models.deploy import save_artifact
    from ..utils.general import flatten_tree

    model_pt = find_model_pt(opt.model_pt)
    out_dir = Path(opt.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    deployed, spec, params = import_torchscript_artifact(model_pt, device=opt.device)
    artifact = out_dir / "demo.isr"
    save_artifact(artifact, spec, params)
    n = sum(np.asarray(leaf).size for leaf in flatten_tree(params).values())
    print(f"{model_pt} -> {artifact} ({spec.family}, {n:,} parameters, x{spec.output_scale})")

    engine = TiledUpscaler(deployed, window=opt.window_size)

    if opt.src:  # a user image: restore it, no ground truth to score against
        from .rs import _read_image_rgb, _write_png

        image = _read_image_rgb(Path(opt.src))
        result = engine.upscale_image(image)
        out = out_dir / (Path(opt.src).stem + "_restored.png")
        _write_png(out, result)
        print(f"restored {opt.src} {image.shape} -> {out} {result.shape}")
        return out

    from PIL import Image

    clean = make_test_card()
    scale = spec.output_scale
    if scale == 1:  # denoiser demo: noisy in, denoised out
        inp = degrade_like_training(clean)
        baseline_name, baseline = "degraded input", inp
    else:  # generator demo: downscale in, SR out vs bicubic baseline
        lr = Image.fromarray(clean).resize(
            (clean.shape[1] // scale, clean.shape[0] // scale), Image.BILINEAR)
        inp = np.asarray(lr)
        baseline_name, baseline = "bicubic upscale", np.asarray(
            lr.resize((clean.shape[1], clean.shape[0]), Image.BICUBIC))

    result = engine.upscale_image(inp)
    Image.fromarray(clean).save(out_dir / "clean.png")
    Image.fromarray(inp).save(out_dir / "input.png")
    out = out_dir / "restored.png"
    Image.fromarray(result).save(out)

    p_in, p_out = _psnr(baseline, clean), _psnr(result, clean)
    print(f"PSNR vs clean: {baseline_name} {p_in:.2f} dB, "
          f"restored {p_out:.2f} dB ({p_out - p_in:+.2f} dB; restored "
          "quality is bounded by the artifact itself)")
    print(f"wrote clean/input/restored PNGs -> {out_dir}")
    return out


if __name__ == "__main__":
    main()
