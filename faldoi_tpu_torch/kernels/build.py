"""Build and load the hand-written CUDA kernels (``faldoi_tpu_torch/csrc``).

nvcc compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, for ``sm_90a`` only, at first use: one nvcc per source, all
started together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
        -Xcompiler -fPIC -c -o <tmp>/<name>.o csrc/<name>.cu     # each, at once
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
        -o <build>/libfaldoi_kernels_<hash>.so <tmp>/*.o

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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
                           "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
# name -> argtypes of the C entry points (all return int = cudaError_t)
_SIGNATURES = {
    # stack, oy, ox, out, hp, wp, c, b, p, stream
    "faldoi_gather_patches": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # planes (host array of C pointers), c, int32-plane mask, oy, ox, out,
    # h, w, b, p, stream
    "faldoi_gather_plane_patches": (_P, _I, _U, _P, _P, _P, _I, _I, _I, _I, _P),
    # planes, uu, vv, out, c, h, w, npts, border_out, stream
    "faldoi_bicubic_sample": (_P, _P, _P, _P, _I, _I, _I, _L, _I, _P),
    # planes, u, v, out, c, h, w, u's and v's strides, border_out, stream
    "faldoi_bicubic_warp_planes": (_P,) * 4 + (_I,) * 3 + (_L,) * 4 + (_I, _P),
    # planes, oy, ox, ph, pw, u1, u2, out, c, h, w, b, p, stream
    "faldoi_bicubic_sample_patches": (_P,) * 8 + (_I,) * 5 + (_P,),
    # u1 u2 u1_ u2_ xi11 xi12 xi21 xi22 i1wx i1wy grad rho_c scratch,
    # h, w, l_t, theta, tau, tol2, max_iters, stream
    "faldoi_global_pd_loop": (_P,) * 13 + (_I, _I, _F, _F, _F, _F, _I, _P),
    # x, y, out, n, stream
    "faldoi_probe_axpy": (_P, _P, _P, _L, _P),
    # x, out, rows, cols, lanes, stream
    "faldoi_probe_roll4": (_P, _P, _I, _I, _I, _P),
    # planes, oy8, cb, table, out, c, h, w, b, stream
    "faldoi_probe_window_fetch": (_P,) * 5 + (_I,) * 4 + (_P,),
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ("-shared",)).encode())
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        try:
            for src in sources():
                obj = str(Path(tmp) / f"{src.stem}.o")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj,
                       str(src)]
                if verbose:
                    cmd.insert(1, "-Xptxas=-v")
                objs.append(obj)
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            for cmd, proc in procs:
                _finish(cmd, proc.communicate()[0], proc.returncode, verbose)
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp_out = Path(tmp) / out.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_out), *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _finish(cmd, res.stdout + res.stderr, res.returncode, verbose)
        os.replace(tmp_out, out)
    return out


def _finish(cmd, output: str, code: int, verbose: bool) -> None:
    """Raise with nvcc's output if it failed; print it when verbose."""
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{output}")
    if verbose and output:
        print(output)


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
