"""Algorithm constants and run-time parameters of the port.

A copy of ``faldoi_tpu/params.py``, so that the port (and ``chip_smoke.py``)
imports nothing of the JAX package; ``tests/test_torch_slice.py`` holds the
two equal.  Mirrors the reference's compile-time defaults
(``src/parameters.h``) and its three-tier config system
(``src/utils_preprocess.cpp:37-157``): compiled defaults, CLI flags, and an
optional 9-line energy-params text file whose non-positive entries mean
"keep the default".
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# --- Functionals (reference: src/parameters.h:5-13) ---
M_TVL1 = 0
M_TVL1_W = 1
M_NLTVL1 = 2
M_NLTVL1_W = 3
M_TVCSAD = 4
M_TVCSAD_W = 5
M_NLTVCSAD = 6
M_NLTVCSAD_W = 7
M_TVL1_OCC = 8

METHOD_NAMES = {
    M_TVL1: "TV-l2 coupled",
    M_TVL1_W: "TV-l2 coupled Weights",
    M_NLTVL1: "NLTV-L1",
    M_NLTVL1_W: "NLTV-L1 Weights",
    M_TVCSAD: "TV-CSAD",
    M_TVCSAD_W: "TV-CSAD Weights",
    M_NLTVCSAD: "NLTV-CSAD",
    M_NLTVCSAD_W: "NLTV-CSAD Weights",
    M_TVL1_OCC: "TV-l2 occlusions",
}

# --- Image parameters (src/parameters.h:16) ---
PRESMOOTHING_SIGMA = 0.90

# --- Optical-flow parameters (src/parameters.h:20-31) ---
PAR_DEFAULT_LAMBDA = 40.0
PAR_DEFAULT_THETA = 0.3
PAR_DEFAULT_TAU = 0.125
PAR_DEFAULT_BETA = 0.025
PAR_DEFAULT_ALPHA = 0.0706776435878
PAR_DEFAULT_TAU_U = 0.0739776273913
PAR_DEFAULT_TAU_ETA = 0.0839911992024
PAR_DEFAULT_TAU_CHI = 0.134077646787
PAR_DEFAULT_MU = 1.4058686732
PAR_DEFAULT_TOL_D = 0.01
PAR_DEFAULT_VERBOSE = 0
PAR_DEFAULT_GAMMA = 0.05

MAX_ITERATIONS_LOCAL = 4
MAX_ITERATIONS_GLOBAL = 400

GRAD_IS_ZERO = 1e-8
GRAD_IS_ZERO_GLOBAL = 1e-10

PAR_DEFAULT_NWARPS_LOCAL = 1
PAR_DEFAULT_NWARPS_GLOBAL = 5

ITER_XI = 25
ITER_CHI = 25
THRESHOLD_DELTA = 0.6

GLOBAL_STEP = 1
LOCAL_STEP = 0

# --- FALDOI / pruning parameters (src/parameters.h:61-64) ---
LOCAL_ITER = 3
TU_TOL = 0.01
FB_TOL = 2.0
PAR_DEFAULT_WINSIZE = 5  # default patch window radius

# --- Partitioning (src/parameters.h:67-70) ---
PARTITIONING = 0
HOR_PARTS = 3
VER_PARTS = 2

# --- Bilateral filter (src/parameters.h:73-76) ---
PATCH_BILATERAL_FILTER = 2
SIGMA_BILATERAL_DIST = 4.0
SIGMA_BILATERAL_COLOR = 0.08
ITER_BILATERAL_FILTER = 10

# --- NLTV neighbourhood (src/parameters.h:80-83) ---
NL_SPATIAL = 2
NL_INTENSITY = 2
NL_BETA = 2
NL_DUAL_VAR = (2 * NL_BETA + 1) * (2 * NL_BETA + 1) - 1  # 24 (5x5-1)

# --- CSAD neighbourhood (src/parameters.h:86-87) ---
DT_R = 3
DT_NEI = (2 * DT_R + 1) * (2 * DT_R + 1) - 1  # 48 (7x7-1)

MAX_PATCH = 50


@dataclasses.dataclass
class Parameters:
    """Run-time parameter block (reference: ``energy_structures.h:60-86``)."""

    # energy parameters
    lambda_: float = PAR_DEFAULT_LAMBDA
    theta: float = PAR_DEFAULT_THETA
    tau: float = PAR_DEFAULT_TAU
    beta: float = PAR_DEFAULT_BETA
    alpha: float = PAR_DEFAULT_ALPHA
    tau_u: float = PAR_DEFAULT_TAU_U
    tau_eta: float = PAR_DEFAULT_TAU_ETA
    tau_chi: float = PAR_DEFAULT_TAU_CHI
    mu: float = PAR_DEFAULT_MU
    tol_OF: float = PAR_DEFAULT_TOL_D

    # geometry / bookkeeping
    w: int = 0
    h: int = 0
    pd: int = 1
    w_radio: int = PAR_DEFAULT_WINSIZE
    val_method: int = M_TVL1
    step_algorithm: int = LOCAL_STEP

    # iteration counts
    warps: int = PAR_DEFAULT_NWARPS_LOCAL
    iterations_of: int = LOCAL_ITER
    max_iter_patch: int = MAX_ITERATIONS_LOCAL

    # pruning
    epsilon: float = FB_TOL

    # partitioning
    split_img: int = 0
    h_parts: int = HOR_PARTS
    v_parts: int = VER_PARTS

    # misc
    part_res: int = 0
    verbose: bool = False


def init_params(file_params: Optional[str], step_alg: int) -> Parameters:
    """Parse the 9-line energy-params file with the reference's clamping rules
    (``utils_preprocess.cpp:37-157``): a value <= 0 (or tau-like > 0.25) falls
    back to the compiled default."""
    p = Parameters()
    p.step_algorithm = step_alg
    p.warps = (
        PAR_DEFAULT_NWARPS_LOCAL if step_alg == LOCAL_STEP else PAR_DEFAULT_NWARPS_GLOBAL
    )
    if not file_params:
        return p

    with open(file_params) as fh:
        lines = [ln.strip() for ln in fh.readlines()]

    def val(i: int) -> float:
        return float(lines[i].split()[0])

    v = val(0)
    p.lambda_ = v if v > 0 else PAR_DEFAULT_LAMBDA
    v = val(1)
    p.theta = v if v > 0 else PAR_DEFAULT_THETA
    v = val(2)
    p.tau = v if 0 < v <= 0.25 else PAR_DEFAULT_TAU
    v = val(3)
    p.beta = v if v > 0 else PAR_DEFAULT_BETA
    v = val(4)
    p.alpha = v if v > 0 else PAR_DEFAULT_ALPHA
    v = val(5)
    p.tau_u = v if 0 < v <= 0.25 else PAR_DEFAULT_TAU_U
    v = val(6)
    p.tau_eta = v if 0 < v <= 0.25 else PAR_DEFAULT_TAU_ETA
    v = val(7)
    p.tau_chi = v if 0 < v <= 0.25 else PAR_DEFAULT_TAU_CHI
    v = val(8)
    p.mu = v if v > 0 else PAR_DEFAULT_MU
    return p
