"""Joint min-max image normalization (``src/utils.cpp:679-781``).

Port of ``faldoi_tpu/ops/normalize.py``: the frames are normalised jointly to
[0, 1]; ``image_normalization_3`` keeps the reference's min-selection quirk
(``utils.cpp:763`` takes the larger of the two candidate minima);
``image_normalization_4`` normalises the four frames of the occlusion method.
"""

from __future__ import annotations

import torch


def _apply(ims, mx, mn):
    den = mx - mn
    safe = den > 0
    d = torch.where(safe, den, torch.ones_like(den))
    return tuple(torch.where(safe, (im - mn) / d, im) for im in ims)


def image_normalization(i0: torch.Tensor, i1: torch.Tensor):
    """Normalize two images jointly to [0, 1] (utils.cpp:703-734)."""
    mx = torch.maximum(i0.max(), i1.max())
    mn = torch.minimum(i0.min(), i1.min())
    return _apply((i0, i1), mx, mn)


def image_normalization_3(i1: torch.Tensor, i2: torch.Tensor, i0: torch.Tensor):
    """Normalize three images jointly (utils.cpp:743-781), arguments in the C
    signature's order (I1, I2, I0); min = max(min(I0, I1), min(I2)) (sic)."""
    mx = torch.maximum(torch.maximum(i0.max(), i1.max()), i2.max())
    min01 = torch.minimum(i0.min(), i1.min())
    mn = torch.maximum(i2.min(), min01)
    return _apply((i1, i2, i0), mx, mn)


def image_normalization_4(i0: torch.Tensor, i1: torch.Tensor, i_1: torch.Tensor,
                          i2: torch.Tensor):
    """Normalize four images jointly (utils.cpp:790-836): the frames I0, I1,
    I-1, I2 of method 8, returned in that order."""
    mx = torch.maximum(torch.maximum(i_1.max(), i0.max()),
                       torch.maximum(i1.max(), i2.max()))
    mn = torch.minimum(torch.minimum(i_1.min(), i0.min()),
                       torch.minimum(i1.min(), i2.min()))
    return _apply((i0, i1, i_1, i2), mx, mn)
