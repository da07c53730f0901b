"""faldoi_tpu_torch — the PyTorch/CUDA port of ``faldoi_tpu`` for one NVIDIA H100.

The JAX package ``faldoi_tpu`` stays the reference; this package mirrors its
layout (``ops/``, ``core/``, ``cli/``) and its function names, and is held
against it module by module on the CPU (``tests/test_torch_*.py``).

It runs all nine methods from two frames (four for method 8) to the final
flow: ``cli.faldoi_sift`` / ``cli.faldoi_deep`` / ``cli.faldoi_deep_occ``
(host matchers, ``core.sparse``) -> ``core.preprocess.prepare_pair`` (or
``prepare_quad``) -> ``core.match_growing.match_growing`` -> the method's
global step (``models.global_refine``): ``core.global_step.tvl2_global``
(methods 0, 1), ``core.global_step_nltv.nltvl1_global`` (2, 3),
``core.global_step_csad`` (4-7) or ``core.occlusion.tvl2_occ_global`` (8).
Kernels written by hand in CUDA C++ for ``sm_90a`` (``csrc/``): the batched
patch gather (K0, the port of the Pallas kernel of ``ops/pallas_sweep.py``),
bicubic sampling (K4), the global TV-L1 primal-dual loop (K5), the global
and the patch NLTV primal-dual loops (K6, K7), the CSAD median prox and its
patch loop (K8), the occlusion primal-dual loop (K9), and the three Pallas
probes of ``scripts/`` (P1-P3, ``ops/probes.py``, run by
``cli.kernel_probe``).  Each has a plain PyTorch twin beside its wrapper; a
wrapper runs the twin only for CPU tensors and launches the kernel (or
raises) for CUDA tensors.

Every public entry point takes an explicit ``device``; nothing here imports
``jax``.
"""

from faldoi_tpu_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
