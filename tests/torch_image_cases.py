"""Inputs of the port's image tests, shared by the CPU and the card tests
(no JAX, no cv2: the card's machine has neither)."""

from pathlib import Path

import numpy as np

from chip_smoke import alpha_iou as iou  # noqa: F401  (the card run's measure)

JPEG_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "port_jpeg"
JPEG_VARIANT_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "port_jpeg_variants"
IMAGE_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "port_images"
TIFF_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "port_tiff"
JP2_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "port_jp2"
JP2_ARCHIVAL_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "port_jp2_archival"
HDR_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "port_hdr"
TIFF_CODEC_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "port_tiff_codecs"

# GrabCut's test photos: an object on a background that differs from it.
SCENES = ("disc", "ellipse", "box", "textured")


def scene(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    """uint8 [h, w, 3]: a striped warm object (a centred disc, a tall
    ellipse, an off-centre box, or a disc on a noisy background) on a
    smoothly varying cool background, with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    bg = np.stack([40 + 30 * np.sin(xx / 9.0) + 20 * np.cos(yy / 7.0),
                   90 + 25 * np.cos(xx / 13.0), 60 + 30 * np.sin((xx + yy) / 11.0)], -1)
    if kind == "disc":
        inside = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (0.3 * min(h, w)) ** 2
    elif kind == "ellipse":
        inside = ((yy - 0.45 * h) / (0.35 * h)) ** 2 + ((xx - 0.5 * w) / (0.22 * w)) ** 2 < 1
    elif kind == "box":
        inside = (yy > 0.3 * h) & (yy < 0.8 * h) & (xx > 0.2 * w) & (xx < 0.6 * w)
    elif kind == "textured":
        inside = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (0.32 * min(h, w)) ** 2
        bg = bg + rng.normal(0, 25, (h, w, 3))
    else:
        raise ValueError(kind)
    fg = np.stack([200 + 20 * np.sin(yy / 5.0), 170 + 0 * xx, 60 + 10 * np.cos(xx / 4.0)], -1)
    img = np.where(inside[..., None], fg, bg) + rng.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)
