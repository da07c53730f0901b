"""Image I/O for the CLIs, with the reference's iio semantics.

Imaging libraries are imported inside the functions that need them, so that
importing the port (or its CLIs) pulls in neither PIL nor imageio; a run that
reads only ``.flo`` / ``.npy`` inputs never needs them, and float TIFFs (the
energy map) are written without them.
"""

from __future__ import annotations

import numpy as np


def read_image_split(path: str) -> np.ndarray:
    """Read an image as float32 planar channels, shape (pd, h, w), in the
    file's native value range (0..255 for 8-bit PNG)."""
    if path.endswith(".flo"):
        from faldoi_tpu_torch.io.flo import read_flo

        return np.ascontiguousarray(read_flo(path).transpose(2, 0, 1))
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
    elif path.endswith((".tif", ".tiff")):
        import imageio.v3 as iio

        arr = np.asarray(iio.imread(path)).astype(np.float32)
    else:
        from PIL import Image

        arr = np.asarray(Image.open(path)).astype(np.float32)
    if arr.ndim == 2:
        return arr[None]
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def to_rgb8(planes: np.ndarray) -> np.ndarray:
    """(pd, h, w) planes -> (h, w, 3) uint8, as PIL's ``convert("RGB")``
    holds a frame: one plane is repeated, a fourth (alpha) is dropped, and
    values are rounded and clipped to 0..255 (a no-op for 8-bit files)."""
    planes = np.asarray(planes)
    rgb = np.repeat(planes[:1], 3, axis=0) if planes.shape[0] == 1 else planes[:3]
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8).transpose(1, 2, 0)


def pil_gray(planes: np.ndarray) -> np.ndarray:
    """(pd, h, w) planes -> (h, w) uint8 gray, bit for bit PIL's
    ``convert("L")`` of the 8-bit frame: ``(R*19595 + G*38470 + B*7471 +
    0x8000) >> 16`` on 0..255 integers (a single plane passes through)."""
    if np.asarray(planes).shape[0] == 1:
        return np.clip(np.rint(planes[0]), 0, 255).astype(np.uint8)
    rgb = to_rgb8(planes).astype(np.int64)
    gray = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
            + 0x8000) >> 16
    return gray.astype(np.uint8)


def write_tiff_float(path: str, img: np.ndarray) -> None:
    """Write an (h, w) float32 image as a baseline little-endian TIFF: one
    uncompressed strip, one sample of IEEE float per pixel.  Needs no
    imaging library (the card's machine has none)."""
    img = np.ascontiguousarray(img, dtype="<f4")
    h, w = img.shape
    data = img.tobytes()
    short, long_ = 3, 4
    tags = [(256, long_, w), (257, long_, h), (258, short, 32), (259, short, 1),
            (262, short, 1), (273, long_, 8), (277, short, 1),
            (278, long_, h), (279, long_, len(data)), (284, short, 1),
            (339, short, 3)]       # 339 SampleFormat = IEEE float
    ifd = [np.array([len(tags)], "<u2").tobytes()]
    for tag, typ, val in tags:
        ifd.append(np.array([tag, typ], "<u2").tobytes()
                   + np.array([1, val], "<u4").tobytes())
    ifd.append(np.array([0], "<u4").tobytes())            # no next IFD
    with open(path, "wb") as fh:
        fh.write(b"II*\x00" + np.array([8 + len(data)], "<u4").tobytes())
        fh.write(data)
        fh.write(b"".join(ifd))


def save_image_float(path: str, img: np.ndarray) -> None:
    """Save a float image (the energy map; single-channel TIFF)."""
    img = np.asarray(img, dtype=np.float32)
    if path.endswith(".npy"):
        np.save(path, img)
    elif path.endswith((".tif", ".tiff")):
        write_tiff_float(path, img)
    else:
        from PIL import Image

        Image.fromarray(img).save(path)


def save_image_int(path: str, img: np.ndarray) -> None:
    """Save an int image (occlusion masks as PNG)."""
    from PIL import Image

    arr = np.asarray(img)
    arr = arr.astype(np.uint8) if arr.max(initial=0) <= 255 else arr.astype(np.int32)
    Image.fromarray(arr).save(path)
