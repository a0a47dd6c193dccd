"""Training CLI (counterpart of the JAX package's ``cli/train.py``).

    python -m image_super_resolution_tpu_torch.cli.train --resnet --train_json m.json

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; ``cpu``
only when asked). Phases: ``--train_denoise`` (``Denoiser``, or with
``--family fast`` the ``FastDenoiser``; ``--preset denoise_fullres``),
``--resnet`` (the pixel pretrain of ``sr`` -- ``--enchant`` for EResNet --
or ``fast``) and, with neither flag, the GAN fine-tune: the generator
warm-started from the pixel phase's checkpoint in the same ``--work_dir``,
``Discriminator(3, 64, 8, 1024)``, and ``TruncatedVGG19(5, 4)`` on the
``--vgg_weights`` file, else on random features with the perceptual loss's
``feature_norm``. Checkpoints are the JAX package's files (the GAN one with
D's params and optimizer), so ``--resume`` continues a run of either
package. Each epoch dispatches its steps without reading anything back,
then fetches the epoch's losses at once and prints the mean loss
(``loss/content`` in the GAN phase), patches/s and the number of patches
substituted for files that could not be decoded. ``--loader_backend``
(``auto``, the default; ``native``, the C++ loader; ``python``) picks the
host loader as the JAX CLI does; the choice is printed once, and ``native``
raises where the C++ loader does not build. ``--eval_every N`` with
``--eval_json`` logs PSNR, PSNR-Y and SSIM of the EMA model over 8 batches
every N epochs as ``eval/*``. A run that does not resume first logs the
first 10 hr/lr batches as images (``images/hr``, ``images/lr``; not in the
denoise phase). ``--profile_dir`` writes a ``torch.profiler`` trace of
steps 2-4 (closed early if the run has fewer steps).

Several cards: one process per card, started by torchrun,

    python -m torch.distributed.run --nproc_per_node 8 \
        -m image_super_resolution_tpu_torch.cli.train --resnet --train_json m.json

(on several nodes, torchrun's ``--nnodes``/``--node_rank``/``--master_addr``
as usual). ``--batch_size`` is per node, as it is per host in the JAX CLI:
each node loads an equal stripe of the manifest and each of its ranks
``batch_size / ranks`` rows of every node batch, so the global batch is
``batch_size x nodes``. BatchNorm statistics, gradients and the epoch's
losses are reduced over the data group, every rank adopts rank 0's state
after a resume or warm start, and only rank 0 logs, dumps images,
profiles and saves. On one node a ``--batch_size`` that does not divide
by the ranks shrinks the data group as the JAX CLI shrinks its mesh; the
ranks left out exit. One process that sees several cards exits with the
torchrun command; ``--device cuda:0`` trains on one card. In the denoise
phase rank 0 draws the one-process noise stream and every other rank its
own.

``--ckpt_backend orbax`` exits: the port reads and writes msgpack
checkpoints only; ``scripts/orbax_to_msgpack.py`` (run under JAX) rewrites
a JAX Orbax checkpoint as the msgpack file ``--resume`` reads.
"""

from __future__ import annotations

import argparse
import random
import shlex
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.mesh import (all_reduce_, broadcast_object, distributed_init, local_mesh,
                         shrink_data_group)
from ..data import degrade
from ..data.pipeline import DevicePrefetcher, LoaderConfig, PatchLoader
from ..losses.perceptual import PerceptualLoss
from ..models.denoiser import Denoiser
from ..models.deploy import family_defaults
from ..models.discriminator import Discriminator
from ..models.fast import FastDenoiser, FastSRGenerator
from ..models.generator import SRGenerator
from ..models.vgg import TruncatedVGG19, init_vgg_params
from ..ops.initializers import init_weights
from ..train.checkpoint import (checkpoint_exists, checkpoint_name, discriminator_payload,
                                load_checkpoint, load_state_payload, resume_discriminator,
                                resume_state, save_checkpoint, state_payload,
                                warm_start_generator)
from ..train.state import TrainState
from ..train.steps import (make_denoise_train_step, make_eval_step, make_gan_train_step,
                           make_pixel_train_step)
from ..utils.logging import MetricsLogger
from ..utils.profiling import trace

ORBAX = ("--ckpt_backend orbax is not supported: the port reads and writes msgpack "
         "checkpoints only (--ckpt_backend msgpack); rewrite a JAX Orbax checkpoint "
         "directory as one with `python scripts/orbax_to_msgpack.py DIR FILE` under JAX")
EVAL_BATCHES = 8
IMAGE_BATCHES = 10  # hr/lr batches logged as images at the start of a run
PROFILE_STEPS = (2, 5)  # --profile_dir traces steps [2, 5), past the first


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train SR / denoise models")
    parser.add_argument("--resnet", action="store_true", help="pixel-loss pretrain phase")
    parser.add_argument("--scale", type=int, default=2)
    parser.add_argument("--train_denoise", action="store_true")
    parser.add_argument("--worker", type=int, default=2, help="host decode threads")
    parser.add_argument("--loader_backend", type=str, default="auto",
                        choices=["auto", "native", "python"],
                        help="host patch loader: auto picks native (the C++ loader) "
                             "where it builds and most of the manifest is JPEG/PNG")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--work_dir", type=str, default="./")
    parser.add_argument("--momentum", type=float, default=0.999, help="Adam beta2")
    parser.add_argument("--weight_decay", type=float, default=0.0,
                        help="coupled L2, as torch.optim.Adam")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--epochs", type=int, default=300)
    parser.add_argument("--dml", action="store_true", help="ignored")
    parser.add_argument("--mean", action="store_true", help="compute dataset mean/std")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--L1_loss", action="store_true")
    parser.add_argument("--rs_deep", type=int, default=None,
                        help="trunk depth (default: 16 for the reference "
                             "families, 14 for --family fast)")
    parser.add_argument("--shape", type=int, default=96, help="HR patch size")
    parser.add_argument("--save_name", type=str, default="checkpoint")
    parser.add_argument("--lr2", type=float, default=0.01, help="final lr factor")
    parser.add_argument("--seed", type=int, default=100)
    parser.add_argument("--add_rate", type=float, default=0.2)
    parser.add_argument("--enchant", action="store_true")
    parser.add_argument("--tpu", action="store_true", help="ignored")
    parser.add_argument("--family", type=str, default="sr", choices=["sr", "fast"])
    parser.add_argument("--downshuffle", type=int, default=None,
                        help="fast denoiser's sub-pixel front factor (default 2)")
    parser.add_argument("--width", type=int, default=None,
                        help="generator trunk width (default: 64 for sr, 128 for fast)")
    parser.add_argument("--refine_blocks", type=int, default=0,
                        help="fast family only: full-resolution refinement blocks")
    parser.add_argument("--refine_width", type=int, default=32)
    parser.add_argument("--preset", type=str, default=None, choices=["denoise_fullres"],
                        help="denoise_fullres = --train_denoise --family fast "
                             "--downshuffle 1 --rs_deep 6; explicit flags win")
    parser.add_argument("--train_json", type=str, default="./train_images.json")
    parser.add_argument("--vgg_weights", type=str, default=None,
                        help="GAN phase: a local VGG19 npz or torchvision .pth/.pt "
                             "(default: random features)")
    parser.add_argument("--eval_json", type=str, default=None)
    parser.add_argument("--eval_every", type=int, default=0, help="epochs between evals")
    parser.add_argument("--no_tensorboard", action="store_true")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each block's activations in backward")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of steps 2-4 here")
    parser.add_argument("--ckpt_every", type=int, default=1,
                        help="epochs between checkpoint saves")
    parser.add_argument("--ckpt_backend", type=str, default="msgpack",
                        choices=["msgpack", "orbax"], help="orbax: not supported")
    parser.add_argument("--compile_cache", type=str, default=None,
                        help="accepted for parity; the port compiles no XLA programs")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> list:
    """Parse the flags, train; returns one dict per epoch run (this rank's
    view; the losses are the data group's means)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    opt = build_parser().parse_args(argv)
    opt.argv = argv
    return Run(opt).train()


def _phase(opt) -> str:
    return "denoise" if opt.train_denoise else ("pixel" if opt.resnet else "gan")


def check_options(opt) -> None:
    """The JAX CLI's checks and presets, and the Orbax refusal. Mutates
    ``opt`` as the JAX CLI does."""
    if opt.preset == "denoise_fullres":
        opt.train_denoise = True
        opt.family = "fast"
        if opt.downshuffle is None:
            opt.downshuffle = 1
        if opt.rs_deep is None:
            opt.rs_deep = 6
    opt.rs_deep, opt.width = family_defaults(opt.family, opt.rs_deep, opt.width)
    if opt.ckpt_backend == "orbax":
        raise SystemExit(ORBAX)
    if opt.family == "fast" and opt.enchant:
        raise SystemExit("--enchant is a reference-topology variant (EResNet); the fast "
                         "family is BN-free by construction -- drop one of the flags")
    if opt.downshuffle is not None and not (opt.train_denoise and opt.family == "fast"):
        raise SystemExit("--downshuffle applies to the fast DENOISER only "
                         "(--train_denoise --family fast)")
    if opt.downshuffle is not None and opt.downshuffle < 1:
        raise SystemExit(f"--downshuffle must be >= 1, got {opt.downshuffle}")
    if opt.refine_blocks and opt.family != "fast":
        raise SystemExit("--refine_blocks applies to the fast family only (--family fast)")
    if opt.refine_blocks < 0:
        raise SystemExit(f"--refine_blocks must be >= 0, got {opt.refine_blocks}")


def check_launch(opt) -> None:
    """One process (no torchrun) that sees several cards trains on none:
    it exits with the command that trains on all of them, one process per
    card (the JAX CLI runs one process over all local devices instead)."""
    if (not local_mesh().initialized and opt.device == "cuda"
            and torch.cuda.is_available() and torch.cuda.device_count() > 1):
        k = torch.cuda.device_count()
        raise SystemExit(
            f"{k} CUDA devices: train on all of them with one process per card,\n"
            f"  python -m torch.distributed.run --nproc_per_node {k} -m "
            f"{__package__}.train {shlex.join(getattr(opt, 'argv', []))}\n"
            f"or pass --device cuda:0 to train on one")


def build_model(opt, device: torch.device):
    """The phase's model (the generator in the GAN phase) in bf16 compute
    with fp32 master params, its weights drawn from ``--seed``."""
    kw = dict(dtype=torch.bfloat16, param_dtype=torch.float32, device=device)
    if opt.train_denoise and opt.family == "fast":
        model = FastDenoiser(depth=opt.rs_deep, add_rate=opt.add_rate, width=opt.width,
                             downshuffle=opt.downshuffle or 2,
                             refine_blocks=opt.refine_blocks,
                             refine_width=opt.refine_width, remat=opt.remat, **kw)
    elif opt.train_denoise:
        model = Denoiser(depth=opt.rs_deep, fused=False, **kw)
    elif opt.family == "fast":
        model = FastSRGenerator(depth=opt.rs_deep, add_rate=opt.add_rate,
                                scale=opt.scale, width=opt.width,
                                refine_blocks=opt.refine_blocks,
                                refine_width=opt.refine_width, remat=opt.remat, **kw)
    else:
        model = SRGenerator(depth=opt.rs_deep, add_rate=opt.add_rate, scale=opt.scale,
                            width=opt.width, enchant=opt.enchant, fused=False,
                            remat=opt.remat, **kw)
    return init_weights(model, opt.seed)


def build_gan(opt, device: torch.device, total_steps: int):
    """The GAN phase's discriminator state (``--seed`` + 1, no EMA, the
    generator's optimizer chain) and its perceptual loss."""
    kw = dict(dtype=torch.bfloat16, param_dtype=torch.float32, device=device)
    d_model = init_weights(Discriminator(3, 64, 8, 1024, **kw), opt.seed + 1)
    d_state = TrainState(d_model, lr=opt.lr, lr2=opt.lr2, total_steps=total_steps,
                         weight_decay=opt.weight_decay, b2=opt.momentum, with_ema=False)
    vgg = TruncatedVGG19(i=5, j=4, before_act=opt.enchant, dtype=torch.bfloat16,
                         device=device)
    vgg, loaded = init_vgg_params(vgg, opt.vgg_weights, with_status=True)
    if local_mesh().initialized:  # rank 0's weights and choice: one loss program
        loaded, weights = broadcast_object(
            (loaded, {k: t.cpu() for k, t in vgg.state_dict().items()}))
        vgg.load_state_dict(weights)
    # random features: RMS-normalized, so loss/content keeps its scale
    return d_state, PerceptualLoss(vgg, feature_norm=not loaded)


def denoise_seed(seed: int, rank: int) -> int:
    """The denoise phase's noise seed: ``seed + 2`` on rank 0 (the one
    process's stream), one drawn from (seed + 2, rank) on every other rank,
    so that ranks draw independent noise."""
    if rank == 0:
        return seed + 2
    return int(np.random.SeedSequence([seed + 2, rank]).generate_state(1)[0])


class Run:
    """Everything one training run holds: the loader, the train state(s),
    the phase's step and where its checkpoint goes; ``train`` runs the
    epochs."""

    def __init__(self, opt):
        check_options(opt)
        mesh = distributed_init(opt.device)  # before anything touches the card
        check_launch(opt)
        n_data = shrink_data_group(opt.batch_size)
        if mesh.initialized and mesh.nodes == 1 and n_data != mesh.world:
            print(f"Train: batch_size={opt.batch_size} not divisible by {mesh.world} "
                  f"devices; using a {n_data}-device data mesh")
            if mesh.rank >= n_data:
                print(f"Train: rank {mesh.rank} is outside the data mesh; exiting")
                raise SystemExit(0)
        self.mesh = mesh = local_mesh()
        random.seed(opt.seed)
        np.random.seed(opt.seed)
        torch.manual_seed(opt.seed)
        self.opt = opt
        self.device = mesh.device if mesh.initialized else resolve_device(opt.device)
        self.phase = _phase(opt)
        self.work_dir = Path(opt.work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.ckpt_path = self.work_dir / checkpoint_name(self.phase, opt.save_name,
                                                         opt.rs_deep, opt.add_rate)
        scale = 1 if self.phase == "denoise" else opt.scale
        self.loader_config = LoaderConfig(
            batch_size=opt.batch_size, patch_size=opt.shape, scale=scale,
            workers=opt.worker, seed=opt.seed, backend=opt.loader_backend)
        self.loader = PatchLoader(opt.train_json, self.loader_config,
                                  process_index=mesh.node, process_count=mesh.nodes,
                                  local_rank=mesh.local_rank,
                                  local_world=mesh.ranks_per_node)
        if opt.mean:
            self.loader.calculate_stats()
        self.mean, self.std = list(self.loader.mean), list(self.loader.std)
        steps_per_epoch = len(self.loader)
        total_steps = opt.epochs * steps_per_epoch
        self.global_batch = opt.batch_size * mesh.nodes
        print(f"Train: {len(self.loader.samples)} images, {steps_per_epoch} steps/epoch, "
              f"phase={self.phase}, device={self.device}, loader={self.loader.backend}")
        if mesh.nodes > 1:
            print(f"Train: multi-host {mesh.nodes} processes, global batch "
                  f"{self.global_batch}")
        model = build_model(opt, self.device)
        self.state = TrainState(
            model, lr=opt.lr, lr2=opt.lr2, total_steps=total_steps,
            weight_decay=opt.weight_decay, b2=opt.momentum,
            ema_tau=2000.0 if self.phase == "denoise" else total_steps)
        self.d_state, self.gen = None, None
        if self.phase == "denoise":
            self.step_fn = make_denoise_train_step(self.mean, self.std)
            self.gen = torch.Generator(self.device).manual_seed(
                denoise_seed(opt.seed, mesh.rank))
        elif self.phase == "gan":
            self.d_state, perceptual = build_gan(opt, self.device, total_steps)
            self.step_fn = make_gan_train_step(opt.scale, perceptual, self.mean, self.std)
        else:
            pixel_loss = "l1" if (opt.enchant or opt.L1_loss) else "mse"
            self.step_fn = make_pixel_train_step(opt.scale, pixel_loss, self.mean, self.std)
        self.loss_key = "loss/content" if self.phase == "gan" else "loss"
        self.global_step = 0  # steps this process ran, for --profile_dir
        self.profiler = None
        self.eval_fn = self.eval_loader = None
        if opt.eval_every and opt.eval_json:
            self.eval_fn = make_eval_step(scale, self.mean, self.std)
            self.eval_loader = PatchLoader(opt.eval_json, self.loader_config)

    def step(self, batch_u8: torch.Tensor):
        """One step: the loss as a device tensor (the GAN phase: its metrics
        dict)."""
        if self.phase == "gan":
            return self.step_fn(self.state, self.d_state, batch_u8)
        if self.gen is not None:
            return self.step_fn(self.state, batch_u8, self.gen)
        return self.step_fn(self.state, batch_u8)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def resume(self) -> int:
        """``--resume``: the phase's checkpoint, if there is one, by the
        reference's per-phase epoch rule (the GAN phase also restores D);
        without it the GAN generator starts from the pixel phase's
        checkpoint. Returns the first epoch to run."""
        if not (self.opt.resume and checkpoint_exists(self.ckpt_path)):
            if self.phase == "gan":
                warm_start_generator(self.state, self.work_dir / checkpoint_name(
                    "pixel", self.opt.save_name, self.opt.rs_deep, self.opt.add_rate))
            return 0
        print(f"load from {self.ckpt_path}")
        ckpt = load_checkpoint(self.ckpt_path)
        policy = {"pixel": "matched", "denoise": "opt", "gan": "always"}[self.phase]
        _, start_epoch = resume_state(self.state, ckpt, epoch_policy=policy)
        if self.d_state is not None:
            resume_discriminator(self.d_state, ckpt)
        return start_epoch

    def adopt_first_rank(self, start_epoch: int) -> int:
        """Every rank takes rank 0's state and first epoch (nodes need not
        share a file system, so a resume or warm start may have loaded
        different files, or none); returns the first epoch."""
        if not self.mesh.initialized:
            return start_epoch
        states = [self.state] + ([self.d_state] if self.d_state is not None else [])
        payload = broadcast_object(
            (start_epoch, [state_payload(st) for st in states])
            if self.mesh.rank == 0 else None)
        if self.mesh.rank != 0:
            for st, pl in zip(states, payload[1]):
                load_state_payload(st, pl)
        return payload[0]

    def save(self, epoch: int, losses, final: bool) -> None:
        """Rank 0 writes the checkpoint; the other ranks write nothing."""
        if self.mesh.rank != 0:
            return
        extra = (discriminator_payload(self.d_state, final)
                 if self.d_state is not None else None)
        save_checkpoint(self.ckpt_path, self.state, epoch, self.mean, self.std, losses,
                        final=final, extra=extra)

    def train(self) -> list:
        """Run the epochs; returns one dict per epoch (mean loss, losses,
        patches/s, substituted patches, and the eval metrics of an epoch
        that ran the eval)."""
        opt = self.opt
        first = self.mesh.rank == 0
        logger = MetricsLogger(self.work_dir, opt.save_name,
                               use_tensorboard=not opt.no_tensorboard, enabled=first)
        history = []
        try:
            start_epoch = self.adopt_first_rank(self.resume())
            if not opt.resume and self.phase != "denoise" and first:
                self.log_images(logger)
            n_params = sum(p.numel() for p in self.state.params)
            print(f"Train: {opt.epochs} epochs, {n_params:,} parameters")
            for epoch in range(start_epoch, opt.epochs):
                history.append(self._epoch(epoch, logger))
                final = epoch == opt.epochs - 1
                if final or (epoch + 1) % max(opt.ckpt_every, 1) == 0:
                    self.save(epoch, history[-1]["losses"], final)
                if self.eval_fn is not None and (epoch + 1) % opt.eval_every == 0:
                    history[-1]["eval"] = self.evaluate(epoch, logger)
        finally:
            if self.profiler is not None:  # the run ended before step 5
                self._stop_profile()
            logger.close()
        return history

    def log_images(self, logger) -> None:
        """The first IMAGE_BATCHES batches of hr patches and their LR
        (downscaled on the host, truncated to uint8) as images, a visual
        check of the input pipeline."""
        scale = self.loader_config.scale
        for idx, batch in zip(range(IMAGE_BATCHES), self.loader):
            logger.images("images/hr", batch, idx)
            lr = degrade.downscale(torch.from_numpy(batch).float() / 255.0, scale)
            logger.images("images/lr", torch.clamp(lr * 255.0, 0, 255).to(torch.uint8).numpy(),
                          idx)

    def _stop_profile(self) -> None:
        self.sync()
        self.profiler.__exit__(None, None, None)
        self.profiler = None
        print(f"profiler trace written to {self.opt.profile_dir}")

    def evaluate(self, epoch: int, logger) -> dict:
        """The eval metrics averaged over the eval loader's first
        ``EVAL_BATCHES`` batches, logged as ``eval/*``. In data-parallel
        training every rank runs it on the same unstriped batches in
        lockstep, and rank 0 logs it."""
        ms = [self.eval_fn(self.state, torch.from_numpy(b).to(self.device))
              for _, b in zip(range(EVAL_BATCHES), iter(self.eval_loader))]
        agg = {k: float(torch.stack([m[k] for m in ms]).mean()) for k in ms[0]}
        logger.scalars({f"eval/{k}": v for k, v in agg.items()}, self.state.step)
        print(f"Eval [{epoch}] " + " ".join(f"{k}={v:.3f}" for k, v in agg.items()))
        return agg

    def _epoch(self, epoch: int, logger) -> dict:
        self.loader.set_epoch(epoch)
        start_step = self.state.step
        pending, t0 = [], None
        with DevicePrefetcher(iter(self.loader), self.device) as batches:
            for batch in batches:
                if (self.opt.profile_dir and self.global_step == PROFILE_STEPS[0]
                        and self.mesh.rank == 0):
                    self.profiler = trace(self.opt.profile_dir)
                    self.profiler.__enter__()
                out = self.step(batch)
                pending.append(out if isinstance(out, dict) else {self.loss_key: out})
                self.global_step += 1
                if self.profiler is not None and self.global_step == PROFILE_STEPS[1]:
                    self._stop_profile()
                if t0 is None:  # time from the first step's end
                    self.sync()
                    t0 = time.perf_counter()
        if not pending:
            raise RuntimeError("epoch produced zero training batches: the input "
                               "pipeline is broken")
        keys = list(pending[0])
        fetched = torch.stack([torch.stack([m[k] for k in keys]) for m in pending])
        if self.mesh.initialized:  # the data group's mean losses, once per epoch
            fetched = all_reduce_(fetched).div_(self.mesh.size)
        fetched = fetched.cpu().tolist()  # the epoch's one fetch
        elapsed = max(time.perf_counter() - t0, 1e-9)
        bs = self.global_batch
        pps = (len(pending) - 1) * bs / elapsed if len(pending) > 1 else bs / elapsed
        for i, row in enumerate(fetched):
            logger.scalars(dict(zip(keys, row)), start_step + i + 1)
        losses = [row[keys.index(self.loss_key)] for row in fetched]
        logger.scalar("throughput/patches_per_sec", pps, self.state.step)
        substituted = self.loader.substituted
        print(f"Epoch [{epoch}] mean loss {np.mean(losses):.5f} ({pps:.1f} patches/s, "
              f"{substituted} substituted patches)")
        if not np.all(np.isfinite(losses)):
            print("WARNING: non-finite loss encountered this epoch -- check lr / data; "
                  "checkpoint still saved")
        return {"epoch": epoch, "mean_loss": float(np.mean(losses)), "losses": losses,
                "metrics": {k: [row[j] for row in fetched] for j, k in enumerate(keys)},
                "patches_per_sec": pps, "substituted": substituted}


if __name__ == "__main__":
    main()
