"""PyTorch/CUDA port of ``image_super_resolution_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's module paths, so each counterpart is
found by name (``models/deploy.py`` here ports ``models/deploy.py`` there).
It imports torch, numpy and msgpack, and nothing of JAX or of the JAX
package. Public functions keep the JAX layout: uint8/float NHWC.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``. A CUDA tensor goes through the hand-written kernels under
``ops/kernels``; a CPU tensor goes through their plain PyTorch versions.
"""

__version__ = "0.1.0"
