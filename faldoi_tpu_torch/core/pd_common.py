"""Shared primal-dual building blocks of the TV-L1 solvers.

Port of ``faldoi_tpu/core/pd_common.py`` (reference ``tvl2_model.cpp:82-391``,
``global_faldoi.cpp:307-381``), in the same operation order so that the
float32 results agree with JAX's.
"""

from __future__ import annotations

import torch

from faldoi_tpu_torch.params import GRAD_IS_ZERO


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device: PyTorch's CUDA
    ``sqrt`` of float32 is not correctly rounded (measured on an H100), its
    float64 one is, and rounding that to float32 is exact for sqrt."""
    return x.double().sqrt().to(x.dtype)


def hypot(x, y):
    """``jnp.hypot``'s formula, max * sqrt(1 + (min/max)^2) with a correctly
    rounded sqrt (``torch.hypot`` rounds otherwise), so that it rounds as in
    the JAX reference on every device; +inf where either is infinite."""
    if not isinstance(y, torch.Tensor):
        y = torch.full_like(x, y)
    a, b = x.abs(), y.abs()
    is_inf = torch.isposinf(a) | torch.isposinf(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    q = lo / safe
    r = torch.where(hi == 0, hi, hi * sqrt_rn(1 + q * q))
    return torch.where(is_inf, torch.full_like(r, float("inf")), r)


def tvl1_threshold(u1, u2, rho_c, i1wx, i1wy, grad, l_t):
    """TH operator (tvl2_model.cpp:364-391): v = u + d, d from the three-way
    threshold on rho.  ``l_t`` may be a scalar or a per-cell tensor."""
    rho = rho_c + i1wx * u1 + i1wy * u2
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    fi = torch.where(grad < GRAD_IS_ZERO, zero,
                     -rho / torch.where(grad == 0, torch.ones_like(grad), grad))
    lo = rho < -l_t * grad
    hi = rho > l_t * grad
    d1 = torch.where(lo, l_t * i1wx, torch.where(hi, -l_t * i1wx, fi * i1wx))
    d2 = torch.where(lo, l_t * i1wy, torch.where(hi, -l_t * i1wy, fi * i1wy))
    return u1 + d1, u2 + d2


def tvl2_getD(xi11, xi12, xi21, xi22, u1x, u1y, u2x, u2y, tau):
    """Dual ascent + projection by the OLD xi norm (tvl2_model.cpp:82-118)."""
    xi_n = sqrt_rn(xi11 * xi11 + xi12 * xi12 + xi21 * xi21 + xi22 * xi22)
    xi_n = torch.clamp(xi_n, min=1.0)
    return ((xi11 + tau * u1x) / xi_n, (xi12 + tau * u1y) / xi_n,
            (xi21 + tau * u2x) / xi_n, (xi22 + tau * u2y) / xi_n)


def tvl2_getP(u1, u2, v1, v2, div_xi1, div_xi2, theta, tau):
    """Primal descent (tvl2_model.cpp:122-172).  Returns the new u and the
    per-cell squared update."""
    nu1 = u1 - tau * (-div_xi1 + (u1 - v1) / theta)
    nu2 = u2 - tau * (-div_xi2 + (u2 - v2) / theta)
    d1 = nu1 - u1
    d2 = nu2 - u2
    return nu1, nu2, d1 * d1 + d2 * d2


def warp_constants(i0, i1w, i1wx, i1wy, u1, u2):
    """Per-warp constants (tvl2_model.cpp:334-346): |grad I1w|^2 and the
    constant part of rho."""
    grad = i1wx * i1wx + i1wy * i1wy
    rho_c = i1w - i1wx * u1 - i1wy * u2 - i0
    return grad, rho_c
