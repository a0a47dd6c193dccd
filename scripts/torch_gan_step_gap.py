"""How closely the port's GAN step follows the JAX package's, on the CPU, in
the setup of ``tests/test_torch_gan.py::test_three_gan_steps_match_jax``
(G: sr x2 depth 2 width 8 BN; D width 8; VGG (2, 2) with feature_norm;
fp32; three uint8 batches of 2x24x24).

    JAX_PLATFORMS=cpu python scripts/torch_gan_step_gap.py

Three runs of three steps each:
- synced: before each step the port's state is set to JAX's, so each
  step's difference is that step's own (what the test holds);
- free: both run on from the same start;
- float64: the port's free run again in float64 (every module's compute
  dtype, the VGG and the fp32 casts), the reference for the free runs.
It prints each step's loss gaps (relative), the number of param elements
more than 2e-6 apart and the largest gap of the rest, and, for the free
runs, each side's largest gap from float64 after three steps.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
from test_torch_gan import _flat, _gan_states, _np, _sync, _u8  # noqa: E402

from image_super_resolution_tpu.train.steps import make_gan_train_step as jax_gan_step  # noqa: E402
from image_super_resolution_tpu_torch.interop.from_jax import variables_to_jax  # noqa: E402
from image_super_resolution_tpu_torch.losses.perceptual import PerceptualLoss  # noqa: E402
from image_super_resolution_tpu_torch.train.state import TrainState  # noqa: E402
from image_super_resolution_tpu_torch.train.steps import make_gan_train_step  # noqa: E402

ATOL = 2e-6


def _params(state):
    return _flat(variables_to_jax(state.model.state_dict())[0])


def _gap(a, b):
    n = sum(int((np.abs(a[k] - b[k]) > ATOL).sum()) for k in a)
    rest = max(float(np.where(np.abs(a[k] - b[k]) > ATOL, 0, np.abs(a[k] - b[k])).max())
               for k in a)
    top = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    return n, rest, top


def _float64(g_state, d_state, perc):
    """The same states computing in float64."""
    out = []
    for st in (g_state, d_state):
        m = st.model.double()
        for mod in m.modules():
            if isinstance(getattr(mod, "dtype", None), torch.dtype):
                mod.dtype = torch.float64
        out.append(TrainState(m, lr=1e-3, total_steps=30, ema_tau=30,
                              with_ema=st.ema is not None))
    vgg = perc.vgg.double()
    vgg.dtype = torch.float64
    return (*out, PerceptualLoss(vgg, feature_norm=True))


def main() -> None:
    for mode in ("synced", "free"):
        jg, jd, jperc, g_state, d_state, perc = _gan_states()
        jstep, step = jax_gan_step(2, jperc), make_gan_train_step(2, perc)
        if mode == "free":
            _, _, _, g64, d64, perc64 = _gan_states()
            g64, d64, perc64 = _float64(g64, d64, perc64)
            step64 = make_gan_train_step(2, perc64)
        print(f"== {mode}")
        for i in range(3):
            if mode == "synced":
                _sync(g_state, jg)
                _sync(d_state, jd)
            u8 = _u8((2, 24, 24, 3), i)
            jg, jd, want = jstep(jg, jd, jnp.asarray(u8))
            got = step(g_state, d_state, torch.from_numpy(u8))
            gaps = ", ".join(f"{k} {abs(float(got[k]) - float(want[k])) / abs(float(want[k])):.2e}"
                             for k in sorted(want))
            print(f"  step {i}: losses {gaps} relative")
            for name, st, jt in (("G", g_state, jg), ("D", d_state, jd)):
                n, rest, top = _gap(_params(st), _flat(_np(jt.params)))
                print(f"    {name} params vs JAX: {n} elements > {ATOL}, the rest within "
                      f"{rest:.2e}; largest {top:.2e}")
            if mode == "free":
                as_float = torch.Tensor.float  # keep float64 through the models' casts
                torch.Tensor.float = lambda t, *a, **k: (
                    t if t.dtype == torch.float64 else as_float(t, *a, **k))
                try:
                    step64(g64, d64, torch.from_numpy(u8))
                finally:
                    torch.Tensor.float = as_float
        if mode == "free":
            for name, st, jt, ref in (("G", g_state, jg, g64), ("D", d_state, jd, d64)):
                r = _params(ref)
                print(f"  {name} after 3 steps, largest gap from float64: port "
                      f"{_gap(_params(st), r)[2]:.2e}, JAX {_gap(_flat(_np(jt.params)), r)[2]:.2e}")


if __name__ == "__main__":
    main()
