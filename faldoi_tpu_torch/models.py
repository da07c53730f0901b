"""Functional registry of the port — methods 0 (TV-L1), 1 (weighted
TV-L1), 2 (NLTV-L1), 3 (weighted NLTV-L1), 4 (TV-CSAD), 5 (weighted
TV-CSAD), 6 (NLTV-CSAD), 7 (weighted NLTV-CSAD) and 8 (TV-L1 with
occlusions).

Port of ``faldoi_tpu/models/__init__.py``: the per-method hardcoded
(lambda, theta, tau) of the local step (energy_model.cpp:704-800), those of
the global step (global_faldoi.cpp:2132-2158) and its dispatch
(global_faldoi.cpp:2132-2167).  The weighted methods' global steps are the
unweighted ones: TV-L1 with the params file's (lambda, theta, tau) for
methods 0 and 1, and with the hardcoded ones NLTV-L1 for methods 2 and 3,
TV-CSAD for 4 and 5, NLTV-CSAD for 6 and 7; method 8's is the occlusion
step ``core.occlusion.tvl2_occ_global``, which also returns chi.
"""

from __future__ import annotations

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch.ops.gaussian import gaussian1d_weight


def method_local_params(method: int, w_radio: int = P.PAR_DEFAULT_WINSIZE):
    """Hardcoded per-method (lambda, theta, tau) of the LOCAL step."""
    lam, theta, tau = P.PAR_DEFAULT_LAMBDA, P.PAR_DEFAULT_THETA, P.PAR_DEFAULT_TAU
    if method == P.M_NLTVL1:
        lam, theta, tau = 2.0, 0.3, 0.1
    elif method in (P.M_TVCSAD, P.M_NLTVCSAD):
        lam, theta, tau = 0.85, 0.3, 0.1
    elif method == P.M_TVL1_W:
        central = float(gaussian1d_weight(w_radio)[w_radio + 1])
        lam = P.PAR_DEFAULT_LAMBDA / (central * central)
    elif method in (P.M_NLTVCSAD_W, P.M_NLTVL1_W, P.M_TVCSAD_W):
        central = float(gaussian1d_weight(w_radio)[w_radio + 1])
        lam, theta, tau = 0.85 / (central * central), 0.3, 0.1
    return lam, theta, tau


def method_global_params(method: int, prm: P.Parameters):
    """Per-method (lambda, theta, tau) of the GLOBAL step: the TV-L1 methods
    take the params file; the others are hardcoded."""
    if method in (P.M_TVL1, P.M_TVL1_W, P.M_TVL1_OCC):
        return prm.lambda_, prm.theta, prm.tau
    if method in (P.M_NLTVCSAD, P.M_NLTVCSAD_W, P.M_NLTVL1, P.M_NLTVL1_W):
        lam = 2.0 if method in (P.M_NLTVL1, P.M_NLTVL1_W) else 0.85
        return lam, 0.3, 0.1
    if method in (P.M_TVCSAD, P.M_TVCSAD_W):
        return 0.85, 0.3, 0.125
    raise ValueError(f"unknown method {method}")


def global_refine(method: int, i0n, i1n, u1, u2, prm: P.Parameters,
                  stats=None, i0_planes=None, i_1n=None, occ_init=None):
    """Dispatch the global step; returns the refined (u1, u2, chi), chi None
    but for method 8 (as JAX's ``global_refine``).  The NLTV
    methods (2, 3, 6, 7) need I0's raw (pd, h, w) colour planes,
    ``i0_planes``; method 8 needs the frame I-1, ``i_1n`` (normalized with
    I0 and I1), and takes the input occlusion mask ``occ_init`` (None: chi
    starts at 0)."""
    if method not in range(P.M_TVL1_OCC + 1):
        raise ValueError(f"unknown method {method} (the methods are 0-8)")
    if method == P.M_TVL1_OCC:
        from faldoi_tpu_torch.core.occlusion import tvl2_occ_global

        if i_1n is None:
            raise ValueError("method 8 needs the frame I-1 (i_1n)")
        return tvl2_occ_global(i0n, i1n, i_1n, u1, u2, occ_init, prm,
                               stats=stats)
    return (*_refine(method, i0n, i1n, u1, u2, prm, stats, i0_planes), None)


def _refine(method, i0n, i1n, u1, u2, prm, stats, i0_planes):
    """The global step of methods 0-7; returns (u1, u2)."""
    lam, theta, tau = method_global_params(method, prm)
    nltv = method in (P.M_NLTVL1, P.M_NLTVL1_W, P.M_NLTVCSAD, P.M_NLTVCSAD_W)
    if nltv and i0_planes is None:
        raise ValueError(f"method {method} (NLTV) needs I0's colour planes "
                         "(i0_planes)")
    if method in (P.M_NLTVL1, P.M_NLTVL1_W):
        from faldoi_tpu_torch.core.global_step_nltv import nltvl1_global

        return nltvl1_global(i0n, i1n, i0_planes, u1, u2, lam, theta, tau,
                             prm.warps, stats=stats)
    if method in (P.M_TVCSAD, P.M_TVCSAD_W):
        from faldoi_tpu_torch.core.global_step_csad import tvcsad_global

        return tvcsad_global(i0n, i1n, u1, u2, lam, theta, tau, prm.tol_OF,
                             prm.warps, stats=stats)
    if method in (P.M_NLTVCSAD, P.M_NLTVCSAD_W):
        from faldoi_tpu_torch.core.global_step_csad import nltvcsad_global

        return nltvcsad_global(i0n, i1n, i0_planes, u1, u2, lam, theta, tau,
                               prm.warps, stats=stats)
    from faldoi_tpu_torch.core.global_step import tvl2_global

    return tvl2_global(i0n, i1n, u1, u2, lam, theta, tau, prm.tol_OF,
                       prm.warps, stats=stats)
