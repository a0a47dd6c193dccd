"""How far fp32 training steps of the JAX package and of the PyTorch port
each lie from a float64 run of the same step, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_train_fp64_gap.py

For the models and inputs of ``tests/test_torch_train.py`` (the Denoiser
depth 2 width 8 of the denoise tests, the BN ``sr`` x2 depth 1 width 8 and
the ``fast`` x2 depth 1 width 8 of the pixel tests), it computes one step's
loss and gradients three ways: the port in fp32, JAX in fp32, and the port
in float64 (the reference). It prints, per model, each fp32 side's largest
gradient error as a fraction of the model's largest float64 gradient, the
largest single tensor's share, the port-JAX gap on the same scale, and the
three losses' relative gaps. An order-of-sum difference puts both fp32
sides about equally far from float64, spread over the tensors; a defect in
one side puts that side far off, on a few tensors.

Then the same in bf16 for the denoise experiment's W configuration (the
fast denoiser with its trunk at full resolution, depth 2, width 16, as
``test_three_fast_denoise_steps_match_bf16_jax``), where the CLIs train:
each bf16 side (fp32 params, bf16 compute) against the float64 port, the
share of step-1 gradient elements whose sign differs from float64 (an
Adam update that may part by up to 2 lr), and the port-JAX gaps.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from image_super_resolution_tpu.data.pipeline import make_sr_batch_fn as jax_sr_batch_fn
from image_super_resolution_tpu.data.transforms import normalize as jax_normalize
from image_super_resolution_tpu.data.transforms import to_tanh as jax_to_tanh
from image_super_resolution_tpu.losses import mse_loss as jax_mse_loss
from image_super_resolution_tpu.models import Denoiser as JaxDenoiser
from image_super_resolution_tpu.models import SRGenerator as JaxSRGenerator
from image_super_resolution_tpu.models.fast import FastDenoiser as JaxFastDenoiser
from image_super_resolution_tpu.models.fast import FastSRGenerator as JaxFastSRGenerator
from image_super_resolution_tpu.train.state import build_optimizer, create_train_state
from image_super_resolution_tpu.train.steps import _apply_train
from image_super_resolution_tpu_torch.data.pipeline import make_sr_batch_fn
from image_super_resolution_tpu_torch.data.transforms import normalize, to_tanh
from image_super_resolution_tpu_torch.interop.from_jax import params_from_jax, variables_from_jax
from image_super_resolution_tpu_torch.models.denoiser import Denoiser
from image_super_resolution_tpu_torch.models.fast import FastDenoiser, FastSRGenerator
from image_super_resolution_tpu_torch.models.generator import SRGenerator
from image_super_resolution_tpu_torch.train.state import TrainState


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _cases():
    """(name, JAX model, port model factory, batches): ``batches(i)`` is
    step i's (lr, hr) as numpy, as the tests build them."""
    def denoise_batches(i, rng=np.random.default_rng(9)):
        u8 = _u8((2, 16, 16, 3), 10 + i)
        noisy = np.clip(u8 / 255.0 + rng.normal(0, 0.05, u8.shape), 0, 1).astype(np.float32)
        return (np.asarray(jax_normalize(jnp.asarray(noisy))),
                np.asarray(jax_to_tanh(jnp.asarray(u8))))

    def sr_batches(i):
        hr, lr = jax_sr_batch_fn(2)(jnp.asarray(_u8((2, 16, 16, 3), i)))
        return np.asarray(lr), np.asarray(hr)

    yield ("denoise d2 w8", JaxDenoiser(depth=2, width=8, dtype=jnp.float32),
           lambda dt: Denoiser(depth=2, width=8, fused=False, dtype=dt, param_dtype=dt,
                               device="cpu"), denoise_batches, 2000.0)
    yield ("sr x2 d1 w8 BN", JaxSRGenerator(depth=1, width=8, scale=2, dtype=jnp.float32),
           lambda dt: SRGenerator(depth=1, width=8, scale=2, fused=False, dtype=dt,
                                  param_dtype=dt, device="cpu"), sr_batches, 30)
    yield ("fast x2 d1 w8", JaxFastSRGenerator(depth=1, width=8, scale=2, refine_blocks=1,
                                               refine_width=4, dtype=jnp.float32),
           lambda dt: FastSRGenerator(depth=1, width=8, scale=2, refine_blocks=1,
                                      refine_width=4, dtype=dt, param_dtype=dt, device="cpu"),
           sr_batches, 30)


def _port_model(model, dtype):
    """``model`` computing in ``dtype``, and a getter of its last block's
    output: in float64 the loss must not see the model's closing
    ``.float()``."""
    model = model.to(dtype).train()
    for m in model.modules():
        if hasattr(m, "dtype") and isinstance(m.dtype, torch.dtype):
            m.dtype = dtype
    seen = {}
    list(model.children())[-1].register_forward_hook(
        lambda m, i, o: seen.__setitem__("y", o))
    return model, lambda: seen["y"]


def _mse(y, hr):
    return torch.mean((y - torch.from_numpy(hr).to(y.dtype)) ** 2)


def main() -> None:
    tx = build_optimizer(lr=1e-3, total_steps=30)
    for name, jmodel, factory, batches, tau in _cases():
        jstate = create_train_state(jmodel, (1, 16, 16, 3), tx, jax.random.PRNGKey(0),
                                    ema_tau=tau)
        sd = variables_from_jax(_np(jstate.params), _np(jstate.batch_stats))
        ports = {}
        for dt in (torch.float32, torch.float64):
            model = factory(torch.float32)
            model.load_state_dict(sd)
            ports[dt] = (*_port_model(model, dt), None)
            ports[dt] = (ports[dt][0], ports[dt][1],
                         TrainState(ports[dt][0], lr=1e-3, total_steps=30, ema_tau=tau))
        losses = {"port": [], "jax": [], "f64": []}
        for i in range(3):
            lr, hr = batches(i)

            def jloss(params, s=jstate):
                out, stats = _apply_train(s, params, jnp.asarray(lr))
                return jax_mse_loss(out, jnp.asarray(hr)), stats

            (l_jax, stats), g_jax = jax.value_and_grad(jloss, has_aux=True)(jstate.params)
            losses["jax"].append(float(l_jax))
            grads = {}
            for dt, key in ((torch.float32, "port"), (torch.float64, "f64")):
                model, out, state = ports[dt]
                model(torch.from_numpy(lr).to(dt))
                loss = _mse(out(), hr)
                loss.backward()
                losses[key].append(float(loss))
                grads[key] = {k: p.grad.double().clone() for k, p in model.named_parameters()}
                state.clip_and_adam()
                state.commit_and_ema()
            if i == 0:
                _report_grads(name, grads["port"], grads["f64"],
                              {k: v.double() for k, v in params_from_jax(_np(g_jax)).items()})
            jstate = jstate.apply_gradients(g_jax, stats)
        for key in ("port", "jax"):
            rel = [abs(a - b) / b for a, b in zip(losses[key], losses["f64"])]
            print(f"  {key} fp32 loss vs float64, steps 1-3: "
                  + ", ".join(f"{r:.3e}" for r in rel) + " relative")
        rel = [abs(a - b) / b for a, b in zip(losses["port"], losses["jax"])]
        print("  port vs JAX fp32 loss, steps 1-3:   "
              + ", ".join(f"{r:.3e}" for r in rel) + " relative")


def bf16_w_case() -> None:
    """The W configuration in bf16 (module docstring)."""
    kw = dict(depth=2, width=16, downshuffle=1, refine_blocks=0, refine_width=16)
    tx = build_optimizer(lr=1e-3, total_steps=30)
    jstate = create_train_state(JaxFastDenoiser(**kw, dtype=jnp.bfloat16), (1, 16, 16, 3), tx,
                                jax.random.PRNGKey(0), ema_tau=2000.0)
    sd = variables_from_jax(_np(jstate.params), _np(jstate.batch_stats))
    models = []
    for _ in range(2):
        model = FastDenoiser(**kw, dtype=torch.bfloat16, param_dtype=torch.float32,
                             device="cpu")
        model.load_state_dict(sd)
        models.append(model.train())
    m64, out64 = _port_model(models[1], torch.float64)
    # (model, its output as the loss sees it, compute dtype, state) per side
    ports = {key: (m, out, dt, TrainState(m, lr=1e-3, total_steps=30, ema_tau=2000.0))
             for key, m, out, dt in (("port", models[0], lambda y: y, torch.bfloat16),
                                     ("f64", m64, lambda y: out64(), torch.float64))}
    denoise_batches = next(_cases())[3]
    losses = {"port": [], "jax": [], "f64": []}
    for i in range(3):
        lr, hr = denoise_batches(i)

        def jloss(params, s=jstate):
            out, stats = _apply_train(s, params, jnp.asarray(lr))
            return jax_mse_loss(out, jnp.asarray(hr)), stats

        (l_jax, stats), g_jax = jax.value_and_grad(jloss, has_aux=True)(jstate.params)
        losses["jax"].append(float(l_jax))
        grads = {}
        for key, (model, out, dt, state) in ports.items():
            loss = _mse(out(model(torch.from_numpy(lr).to(dt))), hr)
            loss.backward()
            losses[key].append(float(loss))
            grads[key] = {k: p.grad.double().clone() for k, p in model.named_parameters()}
            state.clip_and_adam()
            state.commit_and_ema()
        if i == 0:
            g_j = {k: v.double() for k, v in params_from_jax(_np(g_jax)).items()}
            _report_grads("fast denoise W d2 w16 (full resolution), bf16", grads["port"],
                          grads["f64"], g_j, "bf16")
            for side, g in (("port bf16", grads["port"]), ("JAX bf16 ", g_j)):
                flips = sum(int((torch.sign(g[k]) != torch.sign(grads["f64"][k])).sum())
                            for k in g)
                n = sum(v.numel() for v in g.values())
                print(f"  {side} vs float64: gradient signs differ on {flips} of {n} "
                      f"elements ({flips / n:.3e})")
        jstate = jstate.apply_gradients(g_jax, stats)
    for key in ("port", "jax"):
        rel = [abs(a - b) / b for a, b in zip(losses[key], losses["f64"])]
        print(f"  {key} bf16 loss vs float64, steps 1-3: "
              + ", ".join(f"{r:.3e}" for r in rel) + " relative")
    rel = [abs(a - b) / b for a, b in zip(losses["port"], losses["jax"])]
    print("  port vs JAX bf16 loss, steps 1-3:   "
          + ", ".join(f"{r:.3e}" for r in rel) + " relative")


def _report_grads(name, g32, g64, g_jax, kind="fp32") -> None:
    scale = max(float(g.abs().max()) for g in g64.values())

    def worst(g):
        errs = {k: float((g[k] - g64[k]).abs().max()) for k in g64}
        k = max(errs, key=errs.get)
        return errs[k] / scale, k, sorted(errs.values())[len(errs) // 2] / scale

    print(f"== {name}: {len(g64)} tensors, largest float64 gradient {scale:.4g}")
    for side, g in ((f"port {kind}", g32), (f"JAX {kind} ", g_jax)):
        w, k, med = worst(g)
        print(f"  {side} vs float64: gradients max {w:.3e} of the largest ({k}), "
              f"median tensor {med:.3e}")
    gap = max(float((g32[k] - g_jax[k]).abs().max()) for k in g64) / scale
    print(f"  port vs JAX {kind}:   gradients max {gap:.3e} of the largest")


if __name__ == "__main__":
    main()
    bf16_w_case()
