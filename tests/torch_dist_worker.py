"""One rank of a data-parallel run of the port, for
tests/test_torch_distributed.py (on the CPU) and tests/test_torch_cuda.py
(on the card). It imports the port only (no JAX).

    RANK=r WORLD_SIZE=n LOCAL_RANK=l LOCAL_WORLD_SIZE=k MASTER_ADDR=127.0.0.1 \
        MASTER_PORT=p python tests/torch_dist_worker.py plan.json

``plan.json`` lists phases run in turn in this one process (one process
group for all of them, as torchrun gives one):

- ``{"phase": "pixel" | "gan" | "denoise", "args": [...]}``: the training
  CLI (``cli.train.Run``) with ``args``, ``{rank}`` replaced by this rank.
  Prints ``WORKER r PHASE name DONE saves=k hash=h``: the checkpoints this
  rank wrote and a sha256 of its final params (G's, then D's).
- ``{"phase": "steps", "spec": path, "out": dir, ...}``: library-level
  steps on this rank's rows of the batches in ``spec`` (``torch.save``d by
  the test, which may write it while earlier phases run; ``run_steps``,
  which the test also runs in its own process for the one-process
  result), on the CPU or the card (``steps_phase``); dumps losses, the
  gradients the optimizers took, params, BN statistics and EMA to
  ``out/rank{r}.pt``.

Prints ``WORKER r DONE`` at the end.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from image_super_resolution_tpu_torch.cli import train as cli_train
from image_super_resolution_tpu_torch.core.mesh import distributed_init
from image_super_resolution_tpu_torch.losses.perceptual import PerceptualLoss
from image_super_resolution_tpu_torch.models.discriminator import Discriminator
from image_super_resolution_tpu_torch.models.generator import SRGenerator
from image_super_resolution_tpu_torch.models.vgg import TruncatedVGG19, init_random_vgg
from image_super_resolution_tpu_torch.ops.initializers import init_weights
from image_super_resolution_tpu_torch.train.state import TrainState
from image_super_resolution_tpu_torch.train.steps import (
    make_gan_train_step,
    make_pixel_train_step,
)

RANK = int(os.environ.get("RANK", 0))
REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300  # seconds for a group of processes


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


class Group:
    """``world`` worker processes, ``local_world`` per node, running
    ``plan`` in turn; ``outs()`` waits for them (killing them all after
    TIMEOUT) and returns their return codes and outputs."""

    def __init__(self, tmp: Path, name: str, plan: list, world: int, local_world: int):
        (tmp / f"{name}.json").write_text(json.dumps(plan))
        port = _free_port()
        self.procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank % local_world),
                       LOCAL_WORLD_SIZE=str(local_world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=port, OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
            env.pop("TORCHELASTIC_RUN_ID", None)
            self.procs.append(subprocess.Popen(
                [sys.executable, __file__, str(tmp / f"{name}.json")], env=env,
                cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        self._result = None

    def outs(self):
        if self._result is None:
            outs = []
            for p in self.procs:
                try:
                    outs.append(p.communicate(timeout=TIMEOUT)[0])
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    outs.append(p.communicate()[0] + "\nTIMEOUT")
            self._result = [p.returncode for p in self.procs], outs
        return self._result


def params_hash(states) -> str:
    h = hashlib.sha256()
    for st in states:
        for p in st.params:
            h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def cli_phase(name: str, args) -> None:
    argv = ["--resnet"] * (name == "pixel") + ["--train_denoise"] * (name == "denoise")
    argv += [a.replace("{rank}", str(RANK)) for a in args]
    saves = []
    orig = cli_train.save_checkpoint
    cli_train.save_checkpoint = lambda *a, **kw: (saves.append(1), orig(*a, **kw))
    try:
        opt = cli_train.build_parser().parse_args(argv)
        opt.argv = argv
        run = cli_train.Run(opt)
        run.train()
    finally:
        cli_train.save_checkpoint = orig
    states = [run.state] + ([run.d_state] if run.d_state is not None else [])
    print(f"WORKER {RANK} PHASE {name} DONE saves={len(saves)} hash={params_hash(states)}",
          flush=True)


def took(state: TrainState, out: list):
    """Record the gradients ``state``'s optimizer takes (averaged over the
    data group and clipped), at each of its steps."""
    orig = state.optimizer.step

    def step(*a, **kw):
        out.append({k: p.grad.clone() for k, p in state.model.named_parameters()})
        return orig(*a, **kw)

    state.optimizer.step = step


def halves(shape, seed):
    """A uint8 batch whose first half is dark (0-95) and second half bright
    (160-255): each rank of two holds one half, so per-rank BatchNorm
    statistics would be far from the batch's."""
    rng = np.random.default_rng(seed)
    n = shape[0] // 2
    return np.concatenate([rng.integers(0, 96, (n, *shape[1:])),
                           rng.integers(160, 256, (shape[0] - n, *shape[1:]))]).astype(np.uint8)


def seeded_spec(width: int = 8, seed: int = 0) -> dict:
    """A spec from the port's own seeded weights (where JAX is absent, as
    on the card's machine): G sr x2 depth 2 at ``width`` with BN, D
    3-8-8-16, VGG (2, 2) on random features, and the batches."""
    g = init_weights(SRGenerator(depth=2, width=width, scale=2, fused=False, device="cpu"),
                     seed)
    d = init_weights(Discriminator(3, 8, 8, 16, dtype=torch.float32, device="cpu"), seed + 1)
    vgg = init_random_vgg(TruncatedVGG19(2, 2, dtype=torch.float32, device="cpu"), seed + 2)
    return {"lr": 1e-3, "total": 30, "width": width, "g": g.state_dict(),
            "d": d.state_dict(), "vgg": vgg.state_dict(),
            "pixel": [torch.from_numpy(halves((4, 16, 16, 3), i)) for i in range(3)],
            "gan": torch.from_numpy(halves((4, 24, 24, 3), 7))}


def run_steps(spec: dict, rows: slice, device="cpu",
              parts=("pixel", "remat", "gan")) -> dict:
    """Three pixel steps of the BN generator (sr x2 depth 2, fp32) on
    ``rows`` of each of ``spec["pixel"]``'s batches, without ("pixel") and
    with ("remat") remat, then one GAN step ("gan"; D width 8, VGG (2, 2)
    with feature_norm) on ``rows`` of ``spec["gan"]``, each from the spec's
    weights, on ``device``: the ``parts`` asked for, dumped on the host. In
    one process (no data group) it is the port's one-process run."""
    lr, total, width = spec["lr"], spec["total"], spec.get("width", 8)
    host = lambda sd: {k: t.cpu() for k, t in sd.items()}  # noqa: E731
    dump = {}
    for remat in [r for r in (False, True) if ("remat" if r else "pixel") in parts]:
        g = SRGenerator(depth=2, width=width, scale=2, fused=False, remat=remat,
                        device=device)
        g.load_state_dict(spec["g"])
        st = TrainState(g, lr=lr, total_steps=total, ema_tau=total)
        grads = []
        took(st, grads)
        step = make_pixel_train_step(2)
        losses = [float(step(st, b[rows].to(device))) for b in spec["pixel"]]
        dump["remat" if remat else "pixel"] = {
            "losses": losses, "grads": [host(g_) for g_ in grads],
            "model": host(g.state_dict()), "ema": host(st.ema.state_dict()), "step": st.step}
    if "gan" not in parts:
        return dump
    g = SRGenerator(depth=2, width=width, scale=2, fused=False, device=device)
    g.load_state_dict(spec["g"])
    d = Discriminator(3, 8, 8, 16, dtype=torch.float32, device=device)
    d.load_state_dict(spec["d"])
    vgg = TruncatedVGG19(2, 2, dtype=torch.float32, device=device)
    vgg.load_state_dict(spec["vgg"])
    g_st = TrainState(g, lr=lr, total_steps=total, ema_tau=total)
    d_st = TrainState(d, lr=lr, total_steps=total, with_ema=False)
    g_grads, d_grads = [], []
    took(g_st, g_grads)
    took(d_st, d_grads)
    metrics = make_gan_train_step(2, PerceptualLoss(vgg, feature_norm=True))(
        g_st, d_st, spec["gan"][rows].to(device))
    dump["gan"] = {"losses": {k: float(v) for k, v in metrics.items()},
                   "g_grads": host(g_grads[0]), "d_grads": host(d_grads[0]),
                   "g": host(g.state_dict()), "g_ema": host(g_st.ema.state_dict()),
                   "d": host(d.state_dict())}
    return dump


def steps_phase(item: dict) -> None:
    """``item``: ``spec`` and ``out`` paths, and optionally ``device``
    ("cpu"), ``backend`` (the device's default) and ``shared`` (every
    local rank on ``cuda:0``, which only gloo allows)."""
    while not os.path.exists(item["spec"]):  # the test writes it while ranks train
        time.sleep(0.05)
    spec = torch.load(item["spec"])
    env = os.environ
    device = item.get("device", "cpu")
    local_world = int(env["LOCAL_WORLD_SIZE"])
    shared = [torch.device("cuda", 0)] * local_world if item.get("shared") else None
    mesh = distributed_init(device, item.get("backend"), rank=RANK,
                            world_size=int(env["WORLD_SIZE"]),
                            local_rank=int(env["LOCAL_RANK"]), local_world_size=local_world,
                            devices=shared)
    n = spec["pixel"][0].shape[0] // mesh.size
    dump = run_steps(spec, slice(mesh.rank * n, (mesh.rank + 1) * n), mesh.device)
    dump["device"] = str(mesh.device)
    torch.save(dump, os.path.join(item["out"], f"rank{RANK}.pt"))
    print(f"WORKER {RANK} PHASE steps DONE", flush=True)


def main() -> None:
    torch.set_num_threads(1)
    # fp32 steps held against fp32 steps: no TF32 on the card
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with open(sys.argv[1]) as f:
        plan = json.load(f)
    for item in plan:
        if item["phase"] == "steps":
            steps_phase(item)
        else:
            cli_phase(item["phase"], item["args"])
    print(f"WORKER {RANK} DONE", flush=True)


if __name__ == "__main__":
    main()
