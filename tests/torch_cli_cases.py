"""Inputs of the port's CLI tests, shared by the CPU and the card tests
(no JAX, no PyYAML: the card's machine has neither)."""

from pathlib import Path

import numpy as np

from dreamgaussian_tpu_torch.utils.config import load
from dreamgaussian_tpu_torch.utils.png import write_png

IMAGE_YAML = Path(__file__).resolve().parents[1] / "configs" / "image.yaml"


def disc_png(path, size=64):
    """The golden run's input: a coloured disc with an off-centre spot."""
    yy, xx = np.mgrid[0:size, 0:size]
    c = (size - 1) / 2
    disc = ((xx - c) ** 2 + (yy - c) ** 2) < (size * 0.3) ** 2
    spot = ((xx - c - 7) ** 2 + (yy - c + 5) ** 2) < (size * 0.08) ** 2
    rgba = np.zeros((size, size, 4), np.uint8)
    rgba[disc] = [230, 60, 40, 255]
    rgba[spot & disc] = [40, 80, 220, 255]
    write_png(str(path), rgba)
    return str(path)


def image_options() -> dict:
    """configs/image.yaml's keys, read by the port's config reader (which
    needs no PyYAML)."""
    return dict(load(str(IMAGE_YAML)))
