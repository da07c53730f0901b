"""faldoi_tpu_torch — the PyTorch/CUDA port of ``faldoi_tpu`` for one NVIDIA H100.

The JAX package ``faldoi_tpu`` stays the reference; this package mirrors its
layout (``ops/``, ``core/``, ``cli/``) and its function names, and is held
against it module by module on the CPU (``tests/test_torch_*.py``).

This slice ports the TV-L1 main path: ``core.preprocess.prepare_pair`` ->
``core.match_growing.match_growing`` (method 0, seeds from ``.flo``) ->
``core.global_step.tvl2_global``.  Three kernels are written by hand in CUDA
C++ for ``sm_90a`` (``csrc/``): the batched patch gather (K0, the port of the
repo's one Pallas kernel), per-point bicubic sampling (K4) and one global
primal-dual iteration (K5).  Each has a plain PyTorch twin beside its wrapper;
a wrapper runs the twin only for CPU tensors and launches the kernel (or
raises) for CUDA tensors.

Every public entry point takes an explicit ``device``; nothing here imports
``jax``.
"""

from faldoi_tpu_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
