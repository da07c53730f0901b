"""Build and load the hand-written CUDA kernels (``faldoi_tpu_torch/csrc``).

nvcc compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, for ``sm_90a`` only, at first use: one nvcc per source, all
started together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
        -Xcompiler -fPIC -c -o <tmp>/<name>.o csrc/<name>.cu     # each, at once
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
        -o <build>/libfaldoi_kernels_<hash>.so <tmp>/*.o

The library goes into ``faldoi_tpu_torch/_build/`` (gitignored), named by a
hash of the sources, the headers they share (``csrc/*.cuh``) and the flags,
so an edited source rebuilds and an unchanged one loads at once.  It is
loaded with ``ctypes``; every pointer and the stream go over as
``c_void_p``.  Each C entry point enqueues its kernels on the stream it is
given and returns ``cudaGetLastError()``; ``check`` raises on anything but
0.  Each wrapper keeps its own launch count, a plain integer attribute
``launches`` that it raises by one after a launch returned 0.

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
    # stack, oy, ox, lane (or null), out, hp, wp, c, b, p, stream
    "faldoi_gather_patches": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # planes (host array of C pointers), lane strides (host array of C long
    # longs, or null), c, int32-plane mask, oy, ox, lane (or null), out, h,
    # w, b, p, stream
    "faldoi_gather_plane_patches": (_P, _P, _I, _U, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _P),
    # planes, uu, vv, out, c, h, w, point rows, point cols, border_out,
    # stream
    "faldoi_bicubic_sample": (_P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _P),
    # planes, u, v, out, c, h, w, u's and v's strides, border_out, stream
    "faldoi_bicubic_warp_planes": (_P,) * 4 + (_I,) * 3 + (_L,) * 4 + (_I, _P),
    # planes, oy, ox, ph, pw, u1, u2, lane (or null), lane stride, out, c, h,
    # w, b, p, stream
    "faldoi_bicubic_sample_patches": (_P,) * 8 + (_L, _P) + (_I,) * 5 + (_P,),
    # u1 u2 u1_ u2_ xi11 xi12 xi21 xi22 i1wx i1wy grad rho_c scratch,
    # h, w, l_t, theta, tau, tol2, max_iters, stream
    "faldoi_global_pd_loop": (_P,) * 13 + (_I, _I, _F, _F, _F, _F, _I, _P),
    # u1 u2 u1_ u2_ wt i1wx i1wy grad rho_c sc_p sc_q wp, h, w, l_t, theta,
    # tau, max_iters, stream
    "faldoi_nltv_global_loop": (_P,) * 12 + (_I, _I, _F, _F, _F, _I, _P),
    # u1 u2 v1 v2 i1wx i1wy grad rho_c wp wt lt scal ph pw duals_in, u1o u2o
    # v1o v2o iters duals_out, b, p, lt_cells, max_iters, stream
    "faldoi_nltv_patch_loop": (_P,) * 21 + (_I,) * 4 + (_P,),
    # u1 u2 b i1wx i1wy denom lt, lt_val, lt_cells, v1 v2, h, w, stream
    "faldoi_csad_vstep_global": (_P,) * 7 + (_F, _I, _P, _P, _I, _I, _P),
    # u1 u2 b i1wx i1wy denom lt, lt_val, lt_cells, ph pw v1 v2, b, p, stream
    "faldoi_csad_vstep_patch": (_P,) * 7 + (_F, _I) + (_P,) * 4 + (_I, _I, _P),
    # u1 u2 v1 v2 b i1wx i1wy denom lt scal ph pw, u1o u2o v1o v2o iters, b,
    # p, lt_cells, max_iters, stream
    "faldoi_csad_patch_loop": (_P,) * 17 + (_I,) * 4 + (_P,),
    # u1 u2 u1b u2b xi11 xi12 xi21 xi22 b i1wx i1wy grad part state rb ok,
    # h, w, l_t, theta, tau, tol2, max_iters, stream
    "faldoi_tvcsad_global_loop": (_P,) * 16 + (_I, _I, _F, _F, _F, _F, _I, _P),
    # u1 u2 u1b u2b wt i1wx i1wy den grad sc_p sc_q wp b rb ok, h, w, l_t,
    # theta, tau, max_iters, stream
    "faldoi_nltvcsad_global_loop": (_P,) * 15 + (_I, _I, _F, _F, _F, _I, _P),
    # u1 u2 v1 v2 b i1wx i1wy denom wp wt lt scal ph pw duals_in, u1o u2o v1o
    # v2o iters duals_out, b, p, lt_cells, max_iters, stream
    "faldoi_nltvcsad_patch_loop": (_P,) * 21 + (_I,) * 4 + (_P,),
    # st wc g ph pw scal out iters, b, p, max_iters, stream
    "faldoi_occ_patch_loop": (_P,) * 8 + (_I,) * 3 + (_P,),
    # h, w, out (8 long longs)
    "faldoi_occ_global_loop_plan": (_I, _I, _P),
    # st wc g scal scratch, scratch floats, h, w, max_iters, stream
    "faldoi_occ_global_loop": (_P,) * 5 + (_L, _I, _I, _I, _P),
    # st wc g scal scratch, scratch floats, h, w, max_iters, n_kernels (int*)
    "faldoi_occ_global_loop_kernels": (_P,) * 5 + (_L, _I, _I, _I, _P),
    # x, out, seed_a, seed_b, lanes, c, h, w, smooth_iters, timestep, stream
    "faldoi_dense_fill": (_P,) * 4 + (_I,) * 5 + (_F, _P),
    # colour, spatial (25 floats on the host), keep, u1, u2, o1, o2, lanes,
    # h, w, iters, stream
    "faldoi_bilateral_filter": (_P,) * 7 + (_I,) * 4 + (_P,),
    # x0, x1 (or null), o0, o1 (or null), ph, pw (int64), b, planes, p,
    # sides (host array of ints), levels, timestep, niter, exact, stream
    "faldoi_poisson_fill": (_P,) * 6 + (_I,) * 3 + (_P, _I, _F, _I, _I, _P),
    # i0pad i1_stack ci cj oy ox ph pw lane (or null) u1 u2 lam theta tau tol
    # w1d (or null) u1o u2o ener, hp, wp, h, w, b, p, wr, warps, max_iters,
    # stream
    "faldoi_tvl1_patch_solve": (_P,) * 19 + (_I,) * 9 + (_P,),
    # cand_e fixed ene owned lanes (or nulls), lane stride, relax, margin,
    # bias, words cand work e_pop idx queue, lanes, n, cap, stream
    "faldoi_select": (_P,) * 5 + (_L, _I, _F, _F) + (_P,) * 6 + (_I, _L, _I, _P),
    # e_pop queue band_min valid_in (or nulls), delta, delta_rel, floor,
    # floor_scale, floor_scale_hi, queue_hi, band floor_dyn valid order
    # counts total, lanes, cap, stream
    "faldoi_accept": (_P,) * 4 + (_F, _F) + (_L,) * 4 + (_P,) * 6 + (_I, _I, _P),
    # is_min, key_out t0 t1 t2 q key ok pos v0 v1 v2 words, m, stream
    "faldoi_scatter_payload": (_I,) + (_P,) * 12 + (_L, _P),
    # key_out wu wv wchi su sv schi ener oy ox inbox base words, w, k, p,
    # stream
    "faldoi_wflow_scatter": (_P,) * 13 + (_L, _I, _I, _P),
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


def headers():
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ("-shared",)).encode())
    for src in sources() + headers():
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


MAX_CANVAS_CELLS = 1024   # P * P of the largest canvas a patch kernel takes


def check_canvas_side(p: int, name: str) -> None:
    """Refuse a patch side whose P * P cells would not fit the one block
    that each patch kernel (K7, K8's loop, K9's patch form, K12, K13, K16)
    gives a canvas."""
    if p * p > MAX_CANVAS_CELLS:
        raise ValueError(f"{name}: patch side {p}: the kernel takes P*P <= "
                         f"{MAX_CANVAS_CELLS}")


def int64_vector(t, name: str, b: int, device):
    """A (B,) integer vector as the int64 a kernel reads (a copy only where
    it holds another integer dtype), on ``device``; raise on anything
    else."""
    import torch

    if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
        raise TypeError(f"{name}: dtype {t.dtype}, expected an integer")
    if tuple(t.shape) != (b,):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected ({b},)")
    t = t.to(torch.int64).contiguous()
    require_cuda_tensor(t, name, torch.int64, device)
    return t


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
