"""faldoi_tpu_torch — the PyTorch/CUDA port of ``faldoi_tpu`` for one NVIDIA H100.

The JAX package ``faldoi_tpu`` stays the reference; this package mirrors its
layout (``ops/``, ``core/``, ``cli/``) and its function names, and is held
against it module by module on the CPU (``tests/test_torch_*.py``).

It runs methods 0 (TV-L1) and 1 (weighted TV-L1) from two frames to the
final flow: ``cli.faldoi_sift`` / ``cli.faldoi_deep`` (host matchers,
``core.sparse``) -> ``core.preprocess.prepare_pair`` ->
``core.match_growing.match_growing`` -> ``core.global_step.tvl2_global``.
Kernels written by hand in CUDA C++ for ``sm_90a`` (``csrc/``): the batched
patch gather (K0, the port of the Pallas kernel of ``ops/pallas_sweep.py``),
per-point bicubic sampling (K4), one global primal-dual iteration (K5), and
the three Pallas probes of ``scripts/`` (P1-P3, ``ops/probes.py``, run by
``cli.kernel_probe``).  Each has a plain PyTorch twin beside its wrapper; a
wrapper runs the twin only for CPU tensors and launches the kernel (or
raises) for CUDA tensors.

Every public entry point takes an explicit ``device``; nothing here imports
``jax``.
"""

from faldoi_tpu_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
