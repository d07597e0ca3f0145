"""Text-to-image samplers of the three text priors, as a command.

Port of ``dreamgaussian_tpu/cli/dream.py``:

- ``--mode sd``: text to one image at the prior's size (512^2 for SD 2.1);
- ``--mode mvdream``: text to 4 views denoised jointly, written as a 2x2
  grid;
- ``--mode imagedream``: an RGBA image and text to 4 views, a 2x2 grid.

Each runs the prior's ``sample_fn``: DDIM through every step from pure
noise drawn from ``--seed``, with CFG (``--scale``; 7.5 for SD and MVDream,
5 for ImageDream), ``--steps`` (50 for SD, 30 otherwise). The 4 views sit
on an orbit at ``--elevation`` and ``--radius`` from ``--azimuth-start``
in steps of 90 degrees. ``--fake`` runs the tiny random denoiser in place
of weights (a 64^2 image or 4 views of 64^2: the whole pipeline, no
prior). ``--device`` picks the card (default) or the CPU.

    python -m dreamgaussian_tpu_torch.cli.dream "a photo of an icecream" \\
        --mode sd --ckpt <SD 2.1-base diffusers snapshot>
    python -m dreamgaussian_tpu_torch.cli.dream "an astronaut" --mode mvdream \\
        --ckpt <sd-v2.1-base-4view.pt>
    python -m dreamgaussian_tpu_torch.cli.dream "a plush toy" --mode imagedream \\
        --image x.png --ckpt <sd-v2.1-base-4view-ipmv.pt>

The PNG (``--out``, default ``dream_<mode>.png``) is written with
``utils/png.py``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import resolve_device


def grid2x2(imgs: np.ndarray) -> np.ndarray:
    """[4, H, W, 3] -> [2H, 2W, 3]: views 0 and 1 above, 2 and 3 below."""
    return np.concatenate([np.concatenate([imgs[0], imgs[1]], axis=1),
                           np.concatenate([imgs[2], imgs[3]], axis=1)], axis=0)


def load_guidance(args, device):
    """The prior of ``--mode`` from ``--ckpt``, or its fake with ``--fake``."""
    ref_rgb = None
    if args.mode == "imagedream":
        if not args.image:
            raise SystemExit("--mode imagedream needs --image")
        from .process import load_rgba

        rgba = load_rgba(args.image, size=256, device=device)
        ref_rgb = rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:])
    if args.ckpt:
        from ..guidance import loader

        if args.mode == "sd":
            return loader.load_stable_diffusion(args.ckpt, args.prompt,
                                                negative_prompt=args.negative, device=device)
        if args.mode == "mvdream":
            return loader.load_mvdream(args.ckpt, args.prompt, negative_prompt=args.negative,
                                       device=device)
        return loader.load_imagedream(args.ckpt, ref_rgb, args.prompt,
                                      negative_prompt=args.negative, device=device)
    if args.fake:
        from ..guidance import fake

        make = {"sd": fake.fake_sd_guidance, "mvdream": fake.fake_mvdream_guidance,
                "imagedream": fake.fake_imagedream_guidance}[args.mode]
        return make(image_size=64, device=device)
    raise SystemExit("need --ckpt <path> (or --fake for a smoke run)")


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="dreamgaussian_tpu_torch text-to-image samplers")
    ap.add_argument("prompt")
    ap.add_argument("--negative", default="")
    ap.add_argument("--mode", default="sd", choices=("sd", "mvdream", "imagedream"))
    ap.add_argument("--image", default=None, help="identity image (imagedream only)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--fake", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--scale", type=float, default=None,
                    help="CFG scale (defaults: sd/mvdream 7.5, imagedream 5)")
    ap.add_argument("--elevation", type=float, default=0.0)
    ap.add_argument("--azimuth-start", type=float, default=0.0)
    ap.add_argument("--radius", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    steps = args.steps if args.steps is not None else (50 if args.mode == "sd" else 30)
    scale = args.scale if args.scale is not None else (5.0 if args.mode == "imagedream" else 7.5)
    g = load_guidance(args, device)
    fn = g.sample_fn(steps=steps, guidance_scale=scale)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def draw(name, shape, dist):
        return torch.randn(shape, generator=gen, device=device)

    if args.mode == "sd":
        img = fn(draw)[0].cpu().numpy()
    else:
        from ..utils.camera import orbit_camera

        poses = np.stack([orbit_camera(args.elevation, args.azimuth_start + 90.0 * i, args.radius)
                          for i in range(4)]).astype(np.float32)
        img = grid2x2(fn(torch.from_numpy(poses).to(device), draw).cpu().numpy())

    if not np.isfinite(img).all():
        raise RuntimeError(f"the {args.mode} sampler gave non-finite pixels")
    from ..utils.png import write_png

    path = args.out or f"dream_{args.mode}.png"
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
    print(f"[INFO] wrote {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
