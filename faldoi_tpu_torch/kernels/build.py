"""Build and load the hand-written CUDA kernels (``faldoi_tpu_torch/csrc``).

nvcc compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, for ``sm_90a`` only, at first use::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
        -shared -Xcompiler -fPIC -o <build>/libfaldoi_kernels_<hash>.so csrc/*.cu

The library goes into ``faldoi_tpu_torch/_build/`` (gitignored), named by a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one loads at once.  It is loaded with ``ctypes``; every pointer and the
stream go over as ``c_void_p``.  Each C entry point enqueues its kernels on
the stream it is given and returns ``cudaGetLastError()``; ``check`` raises
on anything but 0.  Each wrapper keeps its own launch count, a plain integer
attribute ``launches`` that it raises by one after a launch returned 0.

``--fmad=false`` keeps nvcc from contracting a*b+c into one FMA, so each
kernel rounds exactly as its plain PyTorch twin does (PyTorch runs every
elementwise op as its own kernel).  That keeps the CUDA path and the CPU path
that the tests hold against JAX bit-comparable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# name -> argtypes of the C entry points (all return int = cudaError_t)
_SIGNATURES = {
    # stack, oy, ox, out, hp, wp, c, b, p, stream
    "faldoi_gather_patches": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # planes, uu, vv, out, c, h, w, npts, border_out, stream
    "faldoi_bicubic_sample": (_P, _P, _P, _P, _I, _I, _I, _L, _I, _P),
    # u1 u2 u1_ u2_ xi11 xi12 xi21 xi22 i1wx i1wy grad rho_c err,
    # h, w, l_t, theta, tau, stream
    "faldoi_global_pd_iteration": (_P,) * 13 + (_I, _I, _F, _F, _F, _P),
}

_state = {"lib": None}


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfaldoi_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this source hash has no library yet."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sources()]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp_out), *cu]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}")
        if verbose and (res.stdout or res.stderr):
            print(res.stdout + res.stderr)
        os.replace(tmp_out, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    if _state["lib"] is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _state["lib"] = lib
    return _state["lib"]


def check(code: int, name: str) -> None:
    """Raise unless the C entry point returned cudaSuccess (0)."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_tensor(t, name: str, dtype, device=None, shape=None):
    """Validate a tensor handed to a kernel: on CUDA, dtype, contiguity and
    (optionally) device and shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
