"""Built-in SIFT matcher — the SIFT driver's seed source where the vendored
``sift_cli``/``match_cli`` binaries cannot run.

Port of ``faldoi_tpu/matchers/sift.py`` (numpy/scipy, host code, held equal
by a test): a compact SIFT (DoG pyramid, 3D extrema, orientation histogram,
4x4x8 descriptor) with symmetric ratio-test matching.  It produces seeds for
the growing, not IPOL's bit-identical output.  Frames are read with the
port's ``read_image_split`` (PNG or ``.npy``) and turned gray with PIL's
exact integer formula (``io.image.pil_gray``), so PIL is not needed.

Output files use the already-cut 4-column ``x0 y0 x1 y1`` format.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.ndimage as ndi

from faldoi_tpu_torch.io.image import pil_gray, read_image_split


def _gaussian_pyramid(img, n_octaves, nspo, sigma0=1.6, sigma_in=0.5):
    """Scale space with nspo scales per octave (+3 auxiliary)."""
    pyr = []
    base = img.astype(np.float32)
    add = math.sqrt(max(sigma0 * sigma0 - sigma_in * sigma_in, 1e-6))
    cur = ndi.gaussian_filter(base, add)
    k = 2.0 ** (1.0 / nspo)
    for _ in range(n_octaves):
        octave = [cur]
        sigma = sigma0
        for s in range(1, nspo + 3):
            target = sigma0 * (k ** s)
            add = math.sqrt(max(target * target - sigma * sigma, 1e-8))
            octave.append(ndi.gaussian_filter(octave[-1], add))
            sigma = target
        pyr.append(np.stack(octave))
        cur = octave[nspo][::2, ::2]
    return pyr


def _keypoints_from_octave(gauss, o, peak_thresh=0.015, edge_thresh=10.0):
    """26-neighbour DoG extrema above ``peak_thresh`` that pass the edge
    test: [(octave, scale, y, x)]."""
    dog = gauss[1:] - gauss[:-1]
    kps = []
    interior = dog[1:-1, 1:-1, 1:-1]
    mx = ndi.maximum_filter(dog, size=3)[1:-1, 1:-1, 1:-1]
    mn = ndi.minimum_filter(dog, size=3)[1:-1, 1:-1, 1:-1]
    cand = ((interior == mx) | (interior == mn)) & (np.abs(interior) > peak_thresh)
    ss, ys, xs = np.nonzero(cand)
    for si, yi, xi in zip(ss + 1, ys + 1, xs + 1):
        d = dog[si]
        dxx = d[yi, xi + 1] + d[yi, xi - 1] - 2 * d[yi, xi]
        dyy = d[yi + 1, xi] + d[yi - 1, xi] - 2 * d[yi, xi]
        dxy = 0.25 * (
            d[yi + 1, xi + 1] - d[yi + 1, xi - 1] - d[yi - 1, xi + 1] + d[yi - 1, xi - 1]
        )
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        if det <= 0 or tr * tr / det >= (edge_thresh + 1) ** 2 / edge_thresh:
            continue
        kps.append((o, si, yi, xi))
    return kps


def _descriptor(gimg, y, x, scale_pix, n_hist=4, n_ori=8, lam=3.0):
    """The 128-float descriptor at (y, x), or None near the border or on a
    flat patch."""
    h, w = gimg.shape
    rad = int(round(lam * scale_pix * (n_hist + 1) / 2.0 * math.sqrt(2)))
    if y - rad < 1 or x - rad < 1 or y + rad + 1 >= h or x + rad + 1 >= w:
        return None
    patch = gimg[y - rad : y + rad + 1, x - rad : x + rad + 1]
    gy, gx = np.gradient(patch)
    mag = np.hypot(gx, gy)
    ang = np.arctan2(gy, gx) % (2 * math.pi)

    # dominant orientation
    win = np.exp(
        -((np.mgrid[-rad : rad + 1, -rad : rad + 1] ** 2).sum(0))
        / (2 * (1.5 * scale_pix) ** 2)
    )
    hist = np.histogram(ang, bins=36, range=(0, 2 * math.pi), weights=mag * win)[0]
    theta = (np.argmax(hist) + 0.5) * 2 * math.pi / 36

    # rotated grid histograms
    yy, xx = np.mgrid[-rad : rad + 1, -rad : rad + 1]
    ct, st = math.cos(theta), math.sin(theta)
    xr = (ct * xx + st * yy) / (lam * scale_pix)
    yr = (-st * xx + ct * yy) / (lam * scale_pix)
    ok = (np.abs(xr) < n_hist / 2) & (np.abs(yr) < n_hist / 2)
    bx = np.clip((xr + n_hist / 2).astype(int), 0, n_hist - 1)
    by = np.clip((yr + n_hist / 2).astype(int), 0, n_hist - 1)
    bo = ((ang - theta) % (2 * math.pi) / (2 * math.pi) * n_ori).astype(int) % n_ori
    desc = np.zeros((n_hist, n_hist, n_ori), np.float32)
    np.add.at(desc, (by[ok], bx[ok], bo[ok]), (mag * win)[ok])
    v = desc.ravel()
    nrm = np.linalg.norm(v)
    if nrm < 1e-8:
        return None
    v = np.minimum(v / nrm, 0.2)
    v /= np.linalg.norm(v) + 1e-12
    return v


def sift_keypoints(img: np.ndarray, nspo: int = 3, max_kp: int = 5000):
    """Returns (positions (n,2) as x,y in input pixels, descriptors (n,128))."""
    img = img.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    n_oct = max(1, int(math.log2(min(img.shape) / 16)))
    pyr = _gaussian_pyramid(img, n_oct, nspo)
    pos, descs = [], []
    for o, gauss in enumerate(pyr):
        for (_, si, yi, xi) in _keypoints_from_octave(gauss, o):
            scale_pix = 1.6 * (2.0 ** (si / nspo))
            d = _descriptor(gauss[si], yi, xi, scale_pix)
            if d is None:
                continue
            f = 2.0 ** o
            pos.append((xi * f, yi * f))
            descs.append(d)
            if len(descs) >= max_kp:
                break
        if len(descs) >= max_kp:
            break
    if not descs:
        return np.zeros((0, 2), np.float32), np.zeros((0, 128), np.float32)
    return np.asarray(pos, np.float32), np.asarray(descs, np.float32)


def match_descriptors(p0, d0, p1, d1, ratio=0.8):
    """Lowe ratio-test matching, both directions must agree (symmetric)."""
    if len(d0) == 0 or len(d1) == 0:
        return np.zeros((0, 4), np.float32)
    sim = d0 @ d1.T
    dist = np.sqrt(np.maximum(0.0, 2.0 - 2.0 * sim))
    nn1 = np.argmin(dist, axis=1)
    part = np.partition(dist, 1, axis=1)
    ok0 = part[:, 0] < ratio * (part[:, 1] + 1e-12)
    nn0_back = np.argmin(dist, axis=0)
    mutual = nn0_back[nn1] == np.arange(len(d0))
    sel = ok0 & mutual
    return np.concatenate([p0[sel], p1[nn1[sel]]], axis=1).astype(np.float32)


def sift_matches_files(im0_path, im1_path, out_fwd, out_bwd, nspo=3):
    """Compute fwd/bwd match files in 4-column format; returns their paths."""
    g0 = pil_gray(read_image_split(im0_path)).astype(np.float32)
    g1 = pil_gray(read_image_split(im1_path)).astype(np.float32)
    p0, d0 = sift_keypoints(g0, nspo=min(nspo, 5))
    p1, d1 = sift_keypoints(g1, nspo=min(nspo, 5))
    fwd = match_descriptors(p0, d0, p1, d1)
    bwd = match_descriptors(p1, d1, p0, d0)
    for path, m in ((out_fwd, fwd), (out_bwd, bwd)):
        with open(path, "w") as fh:
            for x0, y0, x1, y1 in m:
                fh.write(f"{x0} {y0} {x1} {y1}\n")
    return out_fwd, out_bwd
