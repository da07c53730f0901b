"""Frame preprocessing shared by the local and global steps.

Port of ``faldoi_tpu/core/preprocess.py`` (``energy_model.cpp:276-688``,
``global_faldoi.cpp:2049-2068``): RGB -> gray (ITU 601, accumulated in
float64 like the C code), joint min-max normalization, Gaussian presmoothing
with sigma 0.9.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from faldoi_tpu_torch.params import PRESMOOTHING_SIGMA
from faldoi_tpu_torch.device import resolve_device
from faldoi_tpu_torch.ops.gaussian import gaussian_smooth
from faldoi_tpu_torch.ops.normalize import (
    image_normalization, image_normalization_3, image_normalization_4,
)


def rgb_to_gray(planes: np.ndarray) -> np.ndarray:
    """(pd, h, w) planar RGB(A) -> (h, w) gray (energy_model.cpp:45-54)."""
    r = planes[0].astype(np.float64)
    g = planes[1].astype(np.float64)
    b = planes[2].astype(np.float64)
    return (0.299 * r + 0.587 * g + 0.114 * b).astype(np.float32)


def to_gray(planes: np.ndarray) -> np.ndarray:
    return planes[0] if planes.shape[0] == 1 else rgb_to_gray(planes)


def _gray(planes, dev):
    return torch.as_tensor(np.ascontiguousarray(to_gray(np.asarray(planes)),
                                                dtype=np.float32), device=dev)


def prepare_pair(i0_planes: np.ndarray, i1_planes: np.ndarray, device="cuda"):
    """Gray + joint-normalize + presmooth a frame pair (the local/global TV-L1
    path, energy_model.cpp:660-687).  Returns two (h, w) float32 tensors."""
    dev = resolve_device(device)
    a, b = image_normalization(_gray(i0_planes, dev), _gray(i1_planes, dev))
    return (gaussian_smooth(a, PRESMOOTHING_SIGMA),
            gaussian_smooth(b, PRESMOOTHING_SIGMA))


def prepare_triple(i0_planes, i1_planes, i_1_planes, device="cuda"):
    """The global binary's 3-frame preprocessing (global_faldoi.cpp:2049-2068):
    normalization_3 called as (i0, i1, i_1) with its min quirk."""
    dev = resolve_device(device)
    ims = image_normalization_3(_gray(i0_planes, dev), _gray(i1_planes, dev),
                                _gray(i_1_planes, dev))
    return tuple(gaussian_smooth(im, PRESMOOTHING_SIGMA) for im in ims)


def prepare_quad(i0_planes, i1_planes, i_1_planes, i2_planes, device="cuda"):
    """The occlusion method's 4-frame preprocessing (energy_model.cpp:
    609-658): gray, joint normalization of I0, I1, I-1, I2, presmoothing.
    Returns four (h, w) float32 tensors in that order."""
    dev = resolve_device(device)
    ims = image_normalization_4(*(_gray(p, dev) for p in
                                  (i0_planes, i1_planes, i_1_planes, i2_planes)))
    return tuple(gaussian_smooth(im, PRESMOOTHING_SIGMA) for im in ims)


def read_frame_list(path: str):
    """Read an ims.txt frame list: 2 frames (I0, I1) or 4 (I0, I1, I-1, I2)
    (local_faldoi.cpp:1826-1860).  Relative entries that do not resolve from
    the working directory are tried against the list's directory and a few of
    its ancestors, as ``faldoi_tpu.core.preprocess.read_frame_list`` does."""
    with open(path) as fh:
        names = [ln.strip() for ln in fh if ln.strip()]
    if len(names) == 3:
        raise ValueError("3 images given; expected 2 (I0, I1) or 4 (I0, I1, I-1, I2)")
    bases = [os.path.dirname(os.path.abspath(path))]
    for _ in range(3):
        parent = os.path.dirname(bases[-1])
        if parent == bases[-1]:
            break
        bases.append(parent)
    out = []
    for f in names:
        if not os.path.isabs(f) and not os.path.exists(f):
            for b in bases:
                alt = os.path.normpath(os.path.join(b, f))
                if os.path.exists(alt):
                    f = alt
                    break
        out.append(f)
    return out
