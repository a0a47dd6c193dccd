"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without an NVIDIA GPU (the check runs
inside the ``card`` fixture, never at import). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from image_super_resolution_tpu_torch.models.deploy import (
    DeployedModel,
    DeploySpec,
    init_fused_params,
)
from image_super_resolution_tpu_torch.ops.kernels import fused_rdb as k1
from image_super_resolution_tpu_torch.ops.scatter import rdb_params_to_scatter

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a); the CPU tests cover the plain versions")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mats(card):
    spec = DeploySpec(family="sr", depth=1, width=64, scale=4)
    scatter = rdb_params_to_scatter(init_fused_params(spec, seed=0)["rrdb0"]["rdb1"])
    return [t.to(card) for t in k1.scatter_params_to_matmul(scatter)]


@pytest.mark.parametrize("b,h,w", [(1, 1, 1), (2, 8, 8), (3, 17, 29), (1, 33, 130)])
def test_fused_rdb_matches_plain_version(card, mats, b, h, w):
    """Any batch and any H, W, including blocks of 128 pixels that straddle
    images and a ragged last block. Tolerance: KERNEL_ATOL + KERNEL_RTOL|want|
    (a few bf16 ulps; the two sum each conv in another order)."""
    rng = np.random.default_rng(b * 1000 + h * 10 + w)
    x = torch.from_numpy(rng.standard_normal((b, h, w, k1.C), np.float32))
    x = x.to(card, torch.bfloat16)
    before = k1.scatter_rdb.launches
    got = k1.scatter_rdb(x, *mats)
    torch.cuda.synchronize()
    assert k1.scatter_rdb.launches == before + 1
    want = k1.scatter_rdb_reference(x, *mats)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), atol=k1.KERNEL_ATOL,
                               rtol=k1.KERNEL_RTOL)


def test_fused_rdb_rejects_what_it_does_not_take(card, mats):
    x = torch.zeros(1, 4, 4, k1.C, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        k1.scatter_rdb(x.float(), *mats)
    with pytest.raises(ValueError):
        k1.scatter_rdb(torch.zeros(1, 4, 4, 32, device=card, dtype=torch.bfloat16), *mats)
    with pytest.raises(TypeError):
        k1.scatter_rdb(x, mats[0].float(), *mats[1:])
    with pytest.raises(ValueError):
        k1.scatter_rdb(x, *mats[:-1], mats[-1].cpu())


def test_deployed_model_on_card_launches_three_per_rrdb(card):
    """bf16 DeployedModel on the card: every RDB goes through the kernel, and
    the uint8 output stays within BF16_MAX_LSB of the port's fp32 CPU path."""
    from image_super_resolution_tpu_torch.models.deploy import BF16_MAX_LSB

    spec = DeploySpec(family="sr", depth=2, width=64, scale=4)
    params = init_fused_params(spec, seed=3)
    x = np.random.default_rng(3).integers(0, 256, (2, 24, 20, 3), dtype=np.uint8)
    before = k1.scatter_rdb.launches
    got = DeployedModel(spec, params, dtype=torch.bfloat16, device="cuda")(x)
    assert k1.scatter_rdb.launches - before == 3 * spec.depth
    want = DeployedModel(spec, params, dtype=torch.float32, device="cpu")(x)
    diff = (got.cpu().int() - want.int()).abs()
    assert got.shape == (2, 96, 80, 3)
    assert diff.max().item() <= BF16_MAX_LSB
