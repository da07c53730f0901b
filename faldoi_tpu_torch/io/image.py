"""Image I/O for the CLIs, with the reference's iio semantics.

Imaging libraries are imported inside the functions that need them, so that
importing the port (or its CLIs) pulls in neither PIL nor imageio; a run that
reads only ``.flo`` / ``.npy`` inputs never needs them.
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


def save_image_float(path: str, img: np.ndarray) -> None:
    """Save a float image (the energy map; single-channel TIFF)."""
    img = np.asarray(img, dtype=np.float32)
    if path.endswith(".npy"):
        np.save(path, img)
    elif path.endswith((".tif", ".tiff")):
        import imageio.v3 as iio

        iio.imwrite(path, img)
    else:
        from PIL import Image

        Image.fromarray(img).save(path)


def save_image_int(path: str, img: np.ndarray) -> None:
    """Save an int image (occlusion masks as PNG)."""
    from PIL import Image

    arr = np.asarray(img)
    arr = arr.astype(np.uint8) if arr.max(initial=0) <= 255 else arr.astype(np.int32)
    Image.fromarray(arr).save(path)
