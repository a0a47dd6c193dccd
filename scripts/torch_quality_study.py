#!/usr/bin/env python
"""Two studies of the quality experiments' readings, on their val split
(``make_dataset`` with its 240 training images, so the same 24 images as
the JAX package's readings).

``spread``: how far the denoise protocol's noise draw moves its baseline,
the ``noisy_psnr_y`` of the eval CLIs' ``--denoise_eval`` (the default
severity), drawn from several noise seeds by each package.

    JAX_PLATFORMS=cpu python scripts/torch_quality_study.py spread [--seeds 12]
    python scripts/torch_quality_study.py spread --device cuda   # on a GPU

The images come in the eval CLI's batches (its loader at seed 0, batch 2,
192 crops). Seed s draws batch i's noise from
``torch.Generator().manual_seed(1000 s + i)`` on ``--device`` in the port
(s = 0 is the port's eval CLI there) and from ``fold_in(PRNGKey(s), i)`` in
JAX on the CPU (s = 0 is JAX's eval CLI). Each line is one seed's mean over
the batches of each package's ``psnr_y``; the last line gives each
package's mean and standard deviation over the seeds. The streams differ by
package and by device, so a single reading of one can match another only
in distribution; this says how wide that distribution is. ``--device cpu``
(the default) runs both packages in one process; ``--device cuda`` draws
the port's noise on the card and runs no JAX (the card's machine has none).

``rescore``: the artifacts of a quality experiment run (the ``.isr`` files
its work dir holds, e.g. copied back from the card) scored on the CPU by
both packages' eval CLIs.

    JAX_PLATFORMS=cpu python scripts/torch_quality_study.py rescore DIR \
        [--denoise_eval] [--out scores.json]

Every ``DIR/*.isr`` is scored by the JAX package's ``cli.evaluate`` and by
the port's (``--device cpu``) with the experiments' eval flags (192 crops,
batch 2; ``--denoise_eval`` for the denoise protocol), and again with
``--int8`` where the family has an int8 path. Under ``--denoise_eval`` each
CLI draws its own noise (JAX: ``fold_in(PRNGKey(0), i)``; the port on the
CPU: a CPU ``torch.Generator`` seeded ``i``), so one set of weights is read
under two more draws beside the card's; at x2/x4 the two CLIs score the
same inputs. Prints and returns, per artifact and eval, PSNR-Y and the
baseline of each CLI.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

INT8_FAMILIES = ("fast", "denoise_fast")


def spread(val_json: Path, seeds: int, device_name: str) -> dict:
    import torch

    from image_super_resolution_tpu_torch.core.device import resolve_device
    from image_super_resolution_tpu_torch.data import degrade
    from image_super_resolution_tpu_torch.data.manifest import load_manifest
    from image_super_resolution_tpu_torch.data.pipeline import LoaderConfig, PatchLoader
    from image_super_resolution_tpu_torch.utils.metrics import psnr_y

    device = resolve_device(device_name)
    var, iso, q = degrade.DENOISE_SEVERITIES["default"]
    with_jax = device.type == "cpu"
    if with_jax:
        import jax
        import jax.numpy as jnp

        from image_super_resolution_tpu.data import degrade as jax_degrade
        from image_super_resolution_tpu.utils.metrics import psnr_y as jax_psnr_y

        jax_chain = jax.jit(lambda key, x: jnp.clip(jax_degrade.denoise_degradation(
            key, x, quality_range=q, var_range=var, intensity=iso), 0.0, 1.0))
    batches = list(PatchLoader(load_manifest(str(val_json)), LoaderConfig(
        batch_size=2, patch_size=192, scale=1, workers=4, seed=0)))
    port, ref = [], []
    for s in range(seeds):
        a, b = [], []
        for i, hb in enumerate(batches):
            hr = torch.from_numpy(hb).to(device).float() / 255.0
            gen = torch.Generator(device=device).manual_seed(1000 * s + i)
            noisy = torch.clamp(degrade.denoise_degradation(
                gen, hr, quality_range=q, var_range=var, intensity=iso), 0.0, 1.0)
            a.append(float(psnr_y(noisy, hr)))
            if with_jax:
                jhr = jnp.asarray(hb, jnp.float32) / 255.0
                key = jax.random.fold_in(jax.random.PRNGKey(s), i)
                b.append(float(jax_psnr_y(jax_chain(key, jhr), jhr)))
        port.append(float(np.mean(a)))
        ref += [float(np.mean(b))] if with_jax else []
        print(f"seed {s}: port on {device.type} {port[-1]:.4f} dB"
              + (f", JAX {ref[-1]:.4f} dB" if with_jax else ""), flush=True)
    out = {"device": device.type, "port_mean": float(np.mean(port)),
           "port_sd": float(np.std(port, ddof=1)),
           "images": int(sum(len(b) for b in batches)), "seeds": seeds}
    if with_jax:
        out.update(jax_mean=float(np.mean(ref)), jax_sd=float(np.std(ref, ddof=1)))
    print(f"noisy_psnr_y over {out['images']} images and {seeds} seeds: port on "
          f"{device.type} mean {out['port_mean']:.4f} SD {out['port_sd']:.4f}"
          + (f"; JAX mean {out['jax_mean']:.4f} SD {out['jax_sd']:.4f}" if with_jax else ""))
    return out


def rescore(val_json: Path, artifacts: Path, denoise_eval: bool) -> dict:
    from image_super_resolution_tpu.cli import evaluate as jax_evaluate
    from image_super_resolution_tpu_torch.cli import evaluate
    from image_super_resolution_tpu_torch.models.deploy import read_artifact

    base = "noisy" if denoise_eval else "bicubic"
    scores = {}
    for isr in sorted(artifacts.glob("*.isr")):
        int8 = read_artifact(isr)[0].family in INT8_FAMILIES
        for flags in ([], ["--int8"]) if int8 else ([],):
            tag = isr.stem + ("_int8" if flags else "")
            argv = ["--model", str(isr), "--val_json", str(val_json),
                    "--shape", "192", "--batch_size", "2", *flags,
                    *(["--denoise_eval"] if denoise_eval else [])]
            with contextlib.redirect_stdout(io.StringIO()):
                ref = jax_evaluate.main(argv)
                got = evaluate.main(argv + ["--device", "cpu"])
            scores[tag] = {f"{side}_{k}": r[k] for side, r in (("jax_cpu", ref),
                                                               ("port_cpu", got))
                           for k in ("psnr_y", f"{base}_psnr_y")}
            print(f"{tag}: " + ", ".join(f"{k} {v}" for k, v in scores[tag].items()),
                  flush=True)
    return scores


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    studies = parser.add_subparsers(dest="study", required=True)
    sp = studies.add_parser("spread", help="the denoise baseline over noise seeds")
    sp.add_argument("--seeds", type=int, default=12)
    sp.add_argument("--device", type=str, default="cpu",
                    help="where the port draws its noise: cpu (and JAX beside it) or cuda")
    rs = studies.add_parser("rescore", help="a run's .isr files by both eval CLIs")
    rs.add_argument("dir", help="a directory of .isr artifacts")
    rs.add_argument("--denoise_eval", action="store_true")
    rs.add_argument("--out", type=str, default=None, help="also write the scores here")
    opt = parser.parse_args(argv)

    from torch_flagship_quality_experiment import make_dataset

    with tempfile.TemporaryDirectory() as tmp:
        make_dataset(Path(tmp))
        val_json = Path(tmp) / "val_images.json"
        if opt.study == "spread":
            return spread(val_json, opt.seeds, opt.device)
        scores = rescore(val_json, Path(opt.dir), opt.denoise_eval)
    if opt.out:
        Path(opt.out).write_text(json.dumps(scores, indent=2))
    return scores


if __name__ == "__main__":
    main()
