"""Where an fp32 GAN step parts between the card and the CPU: each network
of the step, alone, against a float64 run on the CPU.

    python3 scripts/torch_gan_card_probe.py          # on a machine with a GPU

For G (sr x2 BN, depth 2, width 64), D (3-64-8-1024) and VGG19 (5, 4) on
random weights from fixed seeds, in train mode where they have BN, at the
shapes of ``chip_smoke.py``'s three-step check (4x24x24 in, 4x48x48 for D
and VGG): one forward and the backward of the mean square of the output,
in fp32 on the card and on the CPU and in float64 on the CPU. It prints the
torch precision settings, then for each network and each fp32 side the
largest error of the output (a fraction of the largest float64 output),
of the input gradient and of the weight gradients (fractions of the
largest float64 gradient), first with TF32 off by the legacy flags and
then with every fp32 precision setting torch has set to "ieee".
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from image_super_resolution_tpu_torch.models.discriminator import Discriminator  # noqa: E402
from image_super_resolution_tpu_torch.models.generator import SRGenerator  # noqa: E402
from image_super_resolution_tpu_torch.models.vgg import TruncatedVGG19, init_random_vgg  # noqa: E402
from image_super_resolution_tpu_torch.ops.initializers import init_weights  # noqa: E402

NETS = {
    "G": (lambda dev: init_weights(SRGenerator(depth=2, width=64, scale=2, fused=False,
                                               param_dtype=torch.float32, device=dev), 0),
          (4, 24, 24, 3)),
    "D": (lambda dev: init_weights(Discriminator(dtype=torch.float32, device=dev), 1),
          (4, 48, 48, 3)),
    "VGG": (lambda dev: init_random_vgg(TruncatedVGG19(dtype=torch.float32, device=dev)),
            (4, 48, 48, 3)),
}


def _settings() -> str:
    out = []
    for name in ("torch.backends.cudnn.allow_tf32", "torch.backends.cuda.matmul.allow_tf32",
                 "torch.backends.fp32_precision", "torch.backends.cudnn.fp32_precision",
                 "torch.backends.cudnn.conv.fp32_precision",
                 "torch.backends.cuda.matmul.fp32_precision",
                 "torch.backends.mkldnn.fp32_precision"):
        obj = torch
        try:
            for part in name.split(".")[1:]:
                obj = getattr(obj, part)
        except AttributeError:
            obj = "absent"
        out.append(f"{name}={obj}")
    return ", ".join(out) + f", float32_matmul_precision={torch.get_float32_matmul_precision()}"


def _run(net, x, dtype):
    """Output, input gradient and weight gradients of mean(out^2)."""
    net.train()
    x = x.clone().to(dtype).requires_grad_(True)
    as_float = torch.Tensor.float  # float64 runs keep float64 through the closing casts
    if dtype == torch.float64:
        torch.Tensor.float = lambda t, *a, **k: (
            t if t.dtype == torch.float64 else as_float(t, *a, **k))
    try:
        y = net(x)
    finally:
        torch.Tensor.float = as_float
    (y.double() ** 2).mean().backward()
    grads = {k: p.grad.detach().double().cpu() for k, p in net.named_parameters()
             if p.grad is not None}
    return y.detach().double().cpu(), x.grad.detach().double().cpu(), grads


def _to64(net):
    net = net.double()
    for m in net.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return net


def _probe(title: str) -> None:
    print(f"== {title}: {_settings()}", flush=True)
    for name, (build, shape) in NETS.items():
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(shape, dtype=np.float32))
        ref = _run(_to64(build("cpu")), x, torch.float64)
        for side, dev in (("card", "cuda"), ("CPU", "cpu")):
            got = _run(build(dev), x.to(dev), torch.float32)
            out = float((got[0] - ref[0]).abs().max() / ref[0].abs().max())
            dx = float((got[1] - ref[1]).abs().max() / ref[1].abs().max())
            weights = "frozen"
            if ref[2]:
                scale = max(float(g.abs().max()) for g in ref[2].values())
                errs = {k: float((got[2][k] - g).abs().max()) / scale for k, g in ref[2].items()}
                worst = max(errs, key=errs.get)
                weights = f"{errs[worst]:.2e} ({worst})"
            print(f"  {name:3s} {side:4s} fp32 vs CPU float64: output {out:.2e}, input grad "
                  f"{dx:.2e}, weight grads {weights}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _probe("TF32 off by the legacy flags")
    for name in ("fp32_precision", "cudnn.fp32_precision", "cudnn.conv.fp32_precision",
                 "cuda.matmul.fp32_precision", "mkldnn.fp32_precision"):
        obj = torch.backends
        *parents, leaf = name.split(".")
        try:
            for part in parents:
                obj = getattr(obj, part)
            if hasattr(obj, leaf):
                setattr(obj, leaf, "ieee")
        except (AttributeError, RuntimeError, ValueError) as e:
            print(f"could not set {name}: {e}")
    _probe("every fp32_precision set to ieee")
    return 0


if __name__ == "__main__":
    sys.exit(main())
