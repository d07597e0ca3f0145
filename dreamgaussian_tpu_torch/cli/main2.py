"""Stage-2 CLI: refine the stage-1 mesh's texture.

Port of ``dreamgaussian_tpu/cli/main2.py``:

    python -m dreamgaussian_tpu_torch.cli.main2 --config configs/image.yaml \\
        input=x.png save_path=name zero123_ckpt=<local diffusers snapshot> \\
        [device=cpu] [key=value ...]

finds the stage-1 mesh at ``<outdir>/<save_path>_mesh.<mesh_format>``
unless ``mesh=<path>`` is given, refines it for ``iters_refine`` steps
with the same guidance as ``cli.main`` (Zero123, SD 2.1, MVDream or
ImageDream, from a checkpoint or the fake) and writes
``<outdir>/<save_path>.<mesh_format>``; the target render's size follows
the largest refine image size (512^2 for SD). A mesh without UVs is
unwrapped (``auto_uv``, ``auto_normal``), one without a texture starts
from 0.5 grey. ``mesh`` is the stage-1 mesh's path here, and ``resume`` /
``checkpoint_every`` are stage 1's keys, which stage 2 does not read (as
in the JAX CLI).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import resolve_device
from .main import load_reference, text_guidance, zero123_guidance


def build_refiners(opt, ref_rgb, device="cuda"):
    """((weight, refine fn) entries, the largest refine image_size or None):
    Zero123, then SD, MVDream or ImageDream."""
    steps = opt.get("refine_steps", 50)
    entries, sizes = [], []
    for weight, g in ((opt.get("lambda_zero123", 0), zero123_guidance(opt, ref_rgb, device)),
                      (opt.get("lambda_sd", 0), text_guidance(opt, ref_rgb, device))):
        if g is not None:
            entries.append((weight, g.refine_fn(steps=steps)))
            sizes.append(g.image_size)
    return tuple(entries), (max(sizes) if sizes else None)


def find_mesh(opt) -> str:
    """``opt.mesh``, or the stage-1 mesh where ``cli.main`` wrote it."""
    if opt.get("mesh", None):
        return opt.mesh
    default = os.path.join(opt.get("outdir", "logs"),
                           f"{opt.save_path}_mesh.{opt.get('mesh_format', 'obj')}")
    if not os.path.exists(default):
        raise FileNotFoundError(f"cannot find stage-1 mesh at {default}; pass mesh=<path>")
    return default


def run(opt, refiners=None, draw=None) -> dict:
    """Stage 2. ``refiners`` (``build_refiners``'s pair, in place of the
    config's) and ``draw`` (the trainer's random numbers) let a test inject
    another package's weights and samples; neither is a config key."""
    from ..meshing.mesh import Mesh
    from ..train import Stage2Trainer

    device = resolve_device(opt.get("device", "cuda"))
    ref_rgb, ref_mask = load_reference(opt)
    refine_fns, refine_image_size = refiners or build_refiners(opt, ref_rgb, device)
    mesh = Mesh.load(find_mesh(opt), resize=False)
    if mesh.vt is None:
        mesh.auto_uv()
        mesh.auto_normal()
    if mesh.albedo is None:
        mesh.albedo = np.full((opt.get("texture_size", 1024),) * 2 + (3,), 0.5, np.float32)
    trainer = Stage2Trainer(opt, mesh, ref_rgb=ref_rgb, ref_mask=ref_mask,
                            refine_fns=refine_fns, refine_image_size=refine_image_size,
                            seed=opt.get("seed", 0), device=device, draw=draw)
    stats = trainer.train(opt.get("iters_refine", 50))
    print(f"[INFO] stage 2 done: {stats}")

    outdir = opt.get("outdir", "logs")
    os.makedirs(outdir, exist_ok=True)
    out_path = os.path.join(outdir, f"{opt.save_path}.{opt.get('mesh_format', 'obj')}")
    trainer.export_mesh(out_path)
    print(f"[INFO] saved refined mesh to {out_path}")
    stats["mesh_path"] = out_path
    return stats


def main(argv=None) -> dict:
    from ..utils.config import load_with_cli

    ap = argparse.ArgumentParser(description="dreamgaussian_tpu_torch stage 2 (texture refinement)")
    ap.add_argument("--config", required=True)
    args, extras = ap.parse_known_args(argv)
    return run(load_with_cli(args.config, extras))


if __name__ == "__main__":
    main(sys.argv[1:])
