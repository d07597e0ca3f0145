"""Zero123 novel-view synthesis from one input view.

Port of ``dreamgaussian_tpu/cli/novel_view.py``: samples views of an RGBA
input at (delta elevation, delta azimuth) offsets with the Zero123 prior,
through ``Zero123Guidance.refine_fn`` at strength 0 (DDIM from noise over
all ``--steps``), conditioned on ``vers`` / ``hors`` and radius 0. The
prior loads from a local snapshot (``--ckpt``, ``load_zero123``) or is the
tiny random denoiser (``--fake``: the pipeline, no prior). Each view is
written to ``<out>_nv_v{ver}_h{hor}.png`` (``utils/png.py``).

    python -m dreamgaussian_tpu_torch.cli.novel_view data/name_rgba.png \\
        --ckpt <zero123-xl diffusers snapshot> --hors -30 30 90 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .. import resolve_device


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="dreamgaussian_tpu_torch Zero123 novel views")
    ap.add_argument("input")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--fake", action="store_true")
    ap.add_argument("--vers", type=float, nargs="*", default=[0.0])
    ap.add_argument("--hors", type=float, nargs="*", default=[30.0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils.png import write_png
    from .process import load_rgba

    device = resolve_device(args.device)
    rgba = load_rgba(args.input, size=256, device=device)
    rgb = rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:])
    if args.ckpt:
        from ..guidance.loader import load_zero123

        g = load_zero123(args.ckpt, ref_image=rgb, device=device)
    elif args.fake:
        from ..guidance.fake import fake_zero123_guidance

        g = fake_zero123_guidance(image_size=256, device=device)
    else:
        raise SystemExit("need --ckpt <dir> (or --fake for a smoke run)")

    vers = args.vers if len(args.vers) == len(args.hors) else args.vers * len(args.hors)
    n = len(args.hors)
    images = torch.from_numpy(np.ascontiguousarray(rgb)).to(device)[None].expand(n, -1, -1, -1)
    cond = {"vers": torch.tensor(vers, dtype=torch.float32, device=device),
            "hors": torch.tensor(args.hors, dtype=torch.float32, device=device),
            "radii": torch.zeros(n, device=device)}
    gen = torch.Generator(device=device).manual_seed(0)

    def draw(name, shape, dist):
        return torch.randn(shape, generator=gen, device=device)

    out = g.refine_fn(steps=args.steps)(images, cond, 0.0, draw).cpu().numpy()
    base = args.out or os.path.splitext(args.input)[0]
    paths = []
    for i, (v, h) in enumerate(zip(vers, args.hors)):
        p = f"{base}_nv_v{v:g}_h{h:g}.png"
        write_png(p, (np.clip(out[i], 0, 1) * 255).astype(np.uint8))
        print(f"[INFO] wrote {p}")
        paths.append(p)
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
