"""Functional registry of the port — methods 0 (TV-L1) and 1 (weighted
TV-L1) in this slice.

Port of ``faldoi_tpu/models/__init__.py``: the per-method hardcoded
(lambda, theta, tau) of the local step (energy_model.cpp:704-800), those of
the global step (global_faldoi.cpp:2132-2158) and its dispatch
(global_faldoi.cpp:2132-2167).  The weighted method's global step is the
unweighted TV-L1 one with the params file's (lambda, theta, tau).
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
                  stats=None):
    """Dispatch the global step; returns the refined (u1, u2)."""
    if method not in (P.M_TVL1, P.M_TVL1_W):
        raise NotImplementedError(f"method {method} not ported yet")
    from faldoi_tpu_torch.core.global_step import tvl2_global

    lam, theta, tau = method_global_params(method, prm)
    return tvl2_global(i0n, i1n, u1, u2, lam, theta, tau, prm.tol_OF,
                       prm.warps, stats=stats)
