"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each kernel's public entry point is an op ``isr::<name>``, registered by
``_build.register``: ``scatter_rdb`` (K1, ``fused_rdb``), ``conv3x3_int8``
and ``matmul`` (K2, ``matmul``), ``ca_residual`` (K3,
``channel_attention``), ``flow_warp`` (K4, ``flow_warp``). Its CPU implementation is the plain version, its
CUDA one the kernel's launch or an error; any other device raises. Each
wrapper counts its launches in plain integer attributes
(``scatter_rdb.launches``). Importing this package registers every op, as
reading a ``torch.export`` program of the port needs.
"""

from . import channel_attention, flow_warp, fused_rdb, matmul  # noqa: F401  registers the isr:: ops
