"""Input images for the CLIs.

Port of ``load_rgba`` from ``dreamgaussian_tpu/cli/process.py`` for RGBA
PNG inputs: decoded by the port's ``utils/png.py`` (no cv2, no PIL) and
resized by area averaging as ``cv2.INTER_AREA`` shrinks an image. Inputs
that need matting (RGB or grey) wait for the port of the background
removal (slice F, the apps) and raise.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.png import read_png


def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of area averaging: output cell d covers source
    coordinates [d * s, (d + 1) * s) with s = src / dst; each source pixel
    weighs by its overlap, over s."""
    scale = src / dst
    lo = np.arange(dst)[:, None] * scale
    hi = lo + scale
    pix = np.arange(src)[None, :]
    overlap = np.clip(np.minimum(hi, pix + 1) - np.maximum(lo, pix), 0.0, None)
    return overlap / scale


def resize_area(img: np.ndarray, size: int) -> np.ndarray:
    """Shrink a uint8 [H, W, C] image to [size, size, C] by area averaging
    (``cv2.INTER_AREA``). As in OpenCV, block means of an integer factor
    round half up and the general path rounds half to even."""
    h, w = img.shape[:2]
    if size > h or size > w:
        raise NotImplementedError(
            f"enlarging a {h}x{w} input to {size}^2 is not ported (cv2.INTER_AREA "
            "upscaling); give an image at least as large as ref_size")
    wy, wx = _area_weights(h, size), _area_weights(w, size)
    out = np.einsum("ys,sxc->yxc", wy, np.einsum("xt,stc->sxc", wx, img.astype(np.float64)))
    out = np.floor(out + 0.5) if h % size == 0 and w % size == 0 else np.rint(out)
    return np.clip(out, 0, 255).astype(np.uint8)


def load_rgba(path: str, size: int | None = None) -> np.ndarray:
    """Load an RGBA PNG as float32 RGBA in [0, 1], shrunk to ``size``^2
    when it is larger."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if not path.lower().endswith(".png"):
        raise NotImplementedError(
            f"{path}: only RGBA PNG inputs are ported; other formats and the "
            "background matting wait for the apps slice")
    rgba = read_png(path)
    if rgba.shape[-1] != 4:
        raise NotImplementedError(
            f"{path} has no alpha channel: background matting (remove_background, "
            "U2Net/GrabCut) is not ported yet; pass an RGBA PNG")
    if size is not None and rgba.shape[0] != size:
        rgba = resize_area(rgba, size)
    return rgba.astype(np.float32) / 255.0
