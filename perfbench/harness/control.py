"""The control: the plain reference, computed in the precision below the
one the configuration states (bfloat16 -> float8, int8 -> int4), put in the
program's place. A run with it must come out not correct; the benchmark's
own runs never build it."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .spec import load_reference


class ReferenceSystem:
    """A reference ``apply`` with the deployed model's call surface, so the
    engine and the traffic drive it as they drive the port."""

    def __init__(self, apply, scale: int, downshuffle: int, device: torch.device):
        self.apply, self.device = apply, device
        self.spec = SimpleNamespace(output_scale=scale, downshuffle=downshuffle)

    def __call__(self, u8_batch) -> torch.Tensor:
        x = u8_batch.cpu().numpy() if isinstance(u8_batch, torch.Tensor) else np.asarray(u8_batch)
        return torch.from_numpy(self.apply(x)).to(self.device)


def build(config: dict, weights, calibration, device: torch.device) -> ReferenceSystem:
    ref = load_reference(config)
    return ReferenceSystem(ref.make(weights, config, calibration, device, control=True),
                           config["scale"], config.get("downshuffle", 1), device)
