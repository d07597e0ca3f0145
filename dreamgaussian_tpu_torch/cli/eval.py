"""Image metrics between a result and its input view.

Port of ``dreamgaussian_tpu/cli/eval.py``. Renders 8 orbit views of the
result (``cli/render.py``: a gaussian PLY or a mesh) and reports:

- PSNR and MAE of the front view (azimuth 0) against the input composited
  on white (always);
- CLIP similarity, the mean cosine between the input's and each view's
  image embedding, when ``--clip_ckpt`` names a
  ``CLIPVisionModelWithProjection`` folder (the port's own tower,
  ``guidance/clip.py``, loaded strictly; images resized bilinearly with
  antialiasing, as ``jax.image.resize``);
- LPIPS of the front view when ``--vgg_ckpt`` names a torchvision VGG16
  ``.pth`` (``utils/lpips.py``; ``--lpips_ckpt`` adds the lpips lins).

    python -m dreamgaussian_tpu_torch.cli.eval data/name_rgba.png logs/name.obj \\
        [--clip_ckpt <dir>] [--vgg_ckpt vgg16.pth [--lpips_ckpt vgg.pth]] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from .. import resolve_device


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a - b) ** 2))
    return 99.0 if mse == 0 else -10.0 * math.log10(mse)


@torch.no_grad()
def clip_similarity(ckpt_dir: str, image: np.ndarray, views: list, device="cuda") -> float:
    """Mean cosine similarity between the CLIP image embedding of ``image``
    and of each view (RGB [H, W, 3] in [0, 1])."""
    from ..guidance.clip import clip_pixel_values, load_clip_vision

    device = resolve_device(device)
    enc = load_clip_vision(ckpt_dir, device)

    def embed(img):
        e = enc(clip_pixel_values(img, enc.config.image_size, device))[0].double().cpu().numpy()
        return e / (np.linalg.norm(e) + 1e-8)

    ref = embed(image)
    return float(np.mean([float(ref @ embed(v)) for v in views]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="dreamgaussian_tpu_torch result metrics")
    ap.add_argument("input", help="reference RGBA image")
    ap.add_argument("result", help=".ply gaussians or .obj/.glb mesh")
    ap.add_argument("--clip_ckpt", default=None)
    ap.add_argument("--vgg_ckpt", default=None, help="torchvision vgg16 .pth for LPIPS")
    ap.add_argument("--lpips_ckpt", default=None, help="lpips vgg.pth linear weights")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--elevation", type=float, default=0.0)
    ap.add_argument("--radius", type=float, default=2.0)
    ap.add_argument("--fovy", type=float, default=49.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .process import load_rgba
    from .render import orbit_frames

    device = resolve_device(args.device)
    rgba = load_rgba(args.input, size=args.size, device=device)
    ref = rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:])
    views = orbit_frames(args.result, 8, args.size, args.elevation, args.radius,
                         math.radians(args.fovy), device)
    front = views[4]                                   # azimuth 0 is the middle of 8
    metrics = {"front_psnr": psnr(ref, front), "front_mae": float(np.mean(np.abs(ref - front)))}
    print(f"front_psnr: {metrics['front_psnr']:.3f} dB")
    print(f"front_mae: {metrics['front_mae']:.5f}")
    if args.clip_ckpt:
        metrics["clip_sim"] = clip_similarity(args.clip_ckpt, ref, views, device)
        print(f"clip_sim: {metrics['clip_sim']:.4f}")
    if args.vgg_ckpt:
        from ..utils.lpips import LPIPS

        metric = LPIPS(args.vgg_ckpt, args.lpips_ckpt, device=device)
        metrics["front_lpips"] = float(metric(ref[None], front[None])[0])
        print(f"front_lpips: {metrics['front_lpips']:.4f}")
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
