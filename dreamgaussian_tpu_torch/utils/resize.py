"""Image resizes of the port, equal to OpenCV's (no cv2 on the card machine).

- ``resize_area``: ``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)``
  on uint8, uint16 and float32 images, in both directions, bit for bit
  (float32 by the float paths below, unrounded; its integer-factor
  shrink sums each block four samples at a time):
  - both factors integers (a shrink): block sums times ``1.f / area`` in
    float32, rounded half to even, except 2x2 blocks, which OpenCV's
    vector path rounds half up (``(sum + 2) >> 2``);
  - other shrinks: OpenCV's area table (each source pixel weighed by its
    overlap, float32 weights), accumulated in float32 in OpenCV's order,
    rows after columns, rounded half to even;
  - enlarging (or enlarging one axis): OpenCV's "area" bilinear, whose
    coefficient is ``(d + 1) - (s + 1) / scale`` folded into [0, 1), in
    11-bit fixed point, with the vertical pass of its vector code
    (``(((D0 >> 4) * b0) >> 16) + (((D1 >> 4) * b1) >> 16) + 2) >> 2``);
    uint16 images take OpenCV's float path instead: the same coefficients
    in float32, rows then columns, rounded half to even.
- ``resize_linear``: ``cv2.INTER_LINEAR`` on float32 maps (half-pixel
  centres, clamped borders), in float64 and returned as float32, as
  OpenCV's IPP path computes it to within 1e-7.
"""

from __future__ import annotations

import numpy as np

_COEF_SCALE = 2048   # OpenCV's INTER_RESIZE_COEF_SCALE: 11-bit coefficients


def _area_table(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``computeResizeAreaTab``: per output cell its source
    indices and float32 weights in order, padded with weight 0 ([dst, K])."""
    scale = 1.0 / (dst / src)        # as OpenCV derives it from dsize / ssize
    cells = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        width = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        cell = []
        if s1 - f1 > 1e-3:
            cell.append((s1 - 1, (s1 - f1) / width))
        cell += [(s, 1.0 / width) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            cell.append((s2, min(f2 - s2, 1.0, width) / width))
        cells.append(cell)
    k = max(len(c) for c in cells)
    idx = np.zeros((dst, k), np.int64)
    wt = np.zeros((dst, k), np.float32)
    for d, cell in enumerate(cells):
        for j, (s, a) in enumerate(cell):
            idx[d, j], wt[d, j] = s, a
    return idx, wt


def _shrink_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """OpenCV's general area shrink in float32 (adding a 0-weight pad term
    leaves a sum unchanged), unrounded."""
    xi, xw = _area_table(img.shape[1], w)
    yi, yw = _area_table(img.shape[0], h)
    src = img.astype(np.float32)
    rows = np.zeros((img.shape[0], w, img.shape[2]), np.float32)
    for j in range(xi.shape[1]):
        rows = rows + src[:, xi[:, j]] * xw[None, :, j, None]
    out = yw[:, 0, None, None] * rows[yi[:, 0]]
    for j in range(1, yi.shape[1]):
        out = out + yw[:, j, None, None] * rows[yi[:, j]]
    return out


def _area_linear_coefs(src: int, dst: int):
    """OpenCV's bilinear coefficients in area mode, 11-bit fixed point:
    (first source index, second, weight of the first, of the second)."""
    inv = dst / src
    scale = 1.0 / inv
    d = np.arange(dst)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    edge = s >= src - 1
    f[edge], s[edge] = 0, src - 1
    a0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    a1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return s, np.minimum(s + 1, src - 1), a0, a1


def _enlarge_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    x0, x1, a0, a1 = _area_linear_coefs(img.shape[1], w)
    y0, y1, b0, b1 = _area_linear_coefs(img.shape[0], h)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    return (((rows[y0] >> 4) * b0 >> 16) + ((rows[y1] >> 4) * b1 >> 16) + 2) >> 2


def _linear_area_float(src: int, dst: int):
    """The same coefficients in float32, as OpenCV keeps them for 16-bit
    images: (first index, second, weight of the first, of the second)."""
    inv = dst / src
    d = np.arange(dst)
    s = np.floor(d * (1.0 / inv)).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    edge = s >= src - 1
    f[edge], s[edge] = 0, src - 1
    return s, np.minimum(s + 1, src - 1), np.float32(1) - f, f


def _enlarge_area_float(img: np.ndarray, h: int, w: int) -> np.ndarray:
    x0, x1, a0, a1 = _linear_area_float(img.shape[1], w)
    y0, y1, b0, b1 = _linear_area_float(img.shape[0], h)
    src = img.astype(np.float32)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    return rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]


def _fast_area_float(img: np.ndarray, iy: int, ix: int) -> np.ndarray:
    """OpenCV's ``resizeAreaFast_`` on float32: each block's samples summed
    in row-major order, four at a time (((a + b) + c) + d) onto the running
    sum, times ``1.f / area``; 2x2 blocks of 1 or 4 channels by its vector
    code, ((r00 + r01) + (r10 + r11)) * 0.25 (for 1 channel, all but the
    last width % 4 outputs of a row)."""
    h, w, c = img.shape[0] // iy, img.shape[1] // ix, img.shape[2]
    blocks = img[:h * iy, :w * ix].reshape(h, iy, w, ix, c)
    terms = [blocks[:, ky, :, kx] for ky in range(iy) for kx in range(ix)]
    total = np.zeros((h, w, c), np.float32)
    for k in range(0, len(terms) - len(terms) % 4, 4):
        total = total + (((terms[k] + terms[k + 1]) + terms[k + 2]) + terms[k + 3])
    for t in terms[len(terms) - len(terms) % 4:]:
        total = total + t
    out = total * np.float32(1.0 / (ix * iy))
    if (iy, ix) == (2, 2) and c in (1, 4):
        vec = ((terms[0] + terms[1]) + (terms[2] + terms[3])) * np.float32(0.25)
        n = w if c == 4 else w // 4 * 4
        out[:, :n] = vec[:, :n]
    return out


def resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8, uint16 or float32 [H, W, C] -> the same dtype [h, w, C], as
    ``cv2.INTER_AREA`` (float32 by the same float paths, unrounded)."""
    if img.dtype not in (np.uint8, np.uint16, np.float32) or img.ndim != 3:
        raise ValueError("resize_area takes a uint8, uint16 or float32 [H, W, C] image")
    sy, sx = 1.0 / (h / img.shape[0]), 1.0 / (w / img.shape[1])
    iy, ix = round(sy), round(sx)
    eps = np.finfo(np.float64).eps
    if img.dtype == np.float32:
        if (h, w) == img.shape[:2]:
            return img.copy()
        if sx < 1 or sy < 1:
            return _enlarge_area_float(img, h, w)
        if abs(sx - ix) < eps and abs(sy - iy) < eps:
            return _fast_area_float(img, iy, ix)
        return _shrink_area(img, h, w)
    top = np.iinfo(img.dtype).max
    if sx < 1 or sy < 1:
        out = (_enlarge_area(img, h, w) if img.dtype == np.uint8
               else np.rint(_enlarge_area_float(img, h, w)))
    elif abs(sx - ix) < eps and abs(sy - iy) < eps:
        sums = img.astype(np.int64).reshape(h, iy, w, ix, -1).sum(axis=(1, 3))
        out = ((sums + 2) >> 2 if (ix, iy) == (2, 2)
               else np.rint(sums.astype(np.float32) * np.float32(1.0 / (ix * iy))))
    else:
        out = np.rint(_shrink_area(img, h, w))
    return np.clip(out, 0, top).astype(img.dtype)


def _linear_coefs(src: int, dst: int):
    d = np.arange(dst)
    f = (d + 0.5) * (src / dst) - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    low, high = s < 0, s >= src - 1
    f[low], s[low] = 0.0, 0
    f[high], s[high] = 0.0, src - 1
    return s, np.minimum(s + 1, src - 1), 1.0 - f, f


def resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """float [H, W] or [H, W, C] -> float32 [h, w(, C)], as ``cv2.INTER_LINEAR``."""
    x0, x1, a0, a1 = _linear_coefs(img.shape[1], w)
    y0, y1, b0, b1 = _linear_coefs(img.shape[0], h)
    src = np.asarray(img, np.float64)
    extra = (None,) * (src.ndim - 2)
    rows = src[:, x0] * a0[(None, slice(None), *extra)] + src[:, x1] * a1[(None, slice(None), *extra)]
    out = rows[y0] * b0[(slice(None), None, *extra)] + rows[y1] * b1[(slice(None), None, *extra)]
    return out.astype(np.float32)
