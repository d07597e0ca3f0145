"""Stage-1 CLI: image or text -> 3D gaussians -> textured mesh.

Port of ``dreamgaussian_tpu/cli/main.py``:

    python -m dreamgaussian_tpu_torch.cli.main --config configs/image.yaml \\
        input=x.png save_path=name zero123_ckpt=<local diffusers snapshot> \\
        [checkpoint_dir=ckpt checkpoint_every=100 [resume=True]] [device=cpu] [key=value ...]
    python -m dreamgaussian_tpu_torch.cli.main --config configs/text.yaml \\
        prompt="a hamburger" save_path=name sd_ckpt=<SD 2.1 diffusers snapshot>
    python -m dreamgaussian_tpu_torch.cli.main --config configs/text_mv.yaml \\
        prompt="a hamburger" save_path=name sd_ckpt=<sd-v2.1-base-4view.pt or MVDream snapshot>
    python -m dreamgaussian_tpu_torch.cli.main --config configs/imagedream.yaml \\
        input=x.png [prompt="a plush toy"] save_path=name sd_ckpt=<sd-v2.1-base-4view-ipmv.pt>

takes the same YAML keys and dotlist overrides (read without PyYAML) and
writes ``<outdir>/<save_path>_model.ply`` and, unless ``save_mesh=False``,
``<outdir>/<save_path>_mesh.<mesh_format>``. The config key ``device``
(default ``cuda``) picks the card or the CPU.

Guidance: Zero123 on an input image (``lambda_zero123``), from a
Zero123-XL or Stable-Zero123 diffusers snapshot (``zero123_ckpt``,
``stable_zero123``); SD 2.1, or MVDream with ``mvdream``, on the
``prompt`` (``lambda_sd``), from ``sd_ckpt`` (an SD 2.1 diffusers snapshot;
for MVDream the single LDM file with a ``tokenizer/`` beside it, or a
diffusers snapshot); ImageDream with ``imagedream`` on the input image and
the prompt, which may be empty (``lambda_sd``), from ``sd_ckpt``, the
single ipmv LDM file with ``tokenizer/`` and ``image_encoder/`` beside it.
``fake_guidance=True`` puts a tiny random denoiser in place of a missing
checkpoint; with neither, a prior warns and is left out. Checkpoints: with
``checkpoint_dir`` and ``checkpoint_every`` the full train state is saved
every that many steps; ``resume=True`` continues from ``checkpoint_dir``
when it exists (else trains from step 0) up to ``iters`` steps in all. A
``mesh`` device spec (sharding) is not ported and raises
NotImplementedError.
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import resolve_device


def zero123_guidance(opt, ref_rgb, device):
    """Zero123 guidance for the reference view from ``zero123_ckpt`` or the
    fake, or None (with a warning) when there is neither."""
    if not (opt.get("lambda_zero123", 0) > 0 and ref_rgb is not None):
        return None
    ckpt = opt.get("zero123_ckpt", None)
    if ckpt:
        from ..guidance.loader import load_zero123

        return load_zero123(ckpt, ref_image=ref_rgb, stable=opt.get("stable_zero123", False),
                            default_elevation=opt.get("elevation", 0), device=device)
    if not opt.get("fake_guidance", False):
        print("[WARN] lambda_zero123 > 0 but no zero123_ckpt given and "
              "fake_guidance=False; skipping zero123 guidance")
        return None
    from ..guidance.fake import fake_zero123_guidance

    return fake_zero123_guidance(stable=opt.get("stable_zero123", False),
                                 default_elevation=opt.get("elevation", 0), device=device)


def text_guidance(opt, ref_rgb, device):
    """SD, MVDream (``mvdream``) or ImageDream (``imagedream``, on the
    reference image, with or without a prompt) guidance from ``sd_ckpt`` or
    the fake, or None (with a warning) when there is neither."""
    imagedream = opt.get("imagedream", False)
    if not (opt.get("lambda_sd", 0) > 0 and (opt.get("prompt", None) or imagedream)):
        return None
    mvdream = opt.get("mvdream", False)
    ckpt = opt.get("sd_ckpt", None)
    negative = opt.get("negative_prompt", None) or ""
    if ckpt:
        from ..guidance import loader

        if imagedream:
            return loader.load_imagedream(ckpt, ref_rgb, opt.get("prompt", None) or "",
                                          negative_prompt=negative, device=device)
        return loader.load_stable_diffusion(ckpt, prompt=opt.prompt, negative_prompt=negative,
                                            mvdream=mvdream, device=device)
    if not opt.get("fake_guidance", False):
        print("[WARN] imagedream needs sd_ckpt or fake_guidance" if imagedream else
              "[WARN] mvdream needs sd_ckpt or fake_guidance" if mvdream else
              "[WARN] lambda_sd > 0 but no sd_ckpt given and fake_guidance=False; "
              "skipping SD guidance")
        return None
    from ..guidance import fake

    if imagedream:
        return fake.fake_imagedream_guidance(device=device)
    return (fake.fake_mvdream_guidance if mvdream else fake.fake_sd_guidance)(device=device)


def build_guidances(opt, ref_rgb, device="cuda") -> tuple:
    """(weight, guidance fn) entries for the stage-1 trainer: Zero123, then
    SD, MVDream or ImageDream."""
    entries = []
    for weight, g in ((opt.get("lambda_zero123", 0), zero123_guidance(opt, ref_rgb, device)),
                      (opt.get("lambda_sd", 0), text_guidance(opt, ref_rgb, device))):
        if g is not None:
            entries.append((weight, g.guidance_fn()))
    return tuple(entries)


def load_reference(opt):
    """(rgb composited on white, mask) of ``opt.input`` at ref_size, or
    (None, None) without an input."""
    if not opt.get("input", None):
        return None, None
    from .process import load_rgba

    rgba = load_rgba(opt.input, size=opt.get("ref_size", 256))
    return rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:]), rgba[..., 3]


def run(opt) -> dict:
    from ..train import Stage1Trainer

    device = resolve_device(opt.get("device", "cuda"))
    if opt.get("mesh", None) not in (None, "", 0, False):
        raise NotImplementedError(
            f"mesh={opt.mesh!r}: device meshes (data/tile sharding) are not ported yet")
    ref_rgb, ref_mask = load_reference(opt)
    guidance_fns = build_guidances(opt, ref_rgb, device)
    trainer = Stage1Trainer(opt, ref_rgb=ref_rgb, ref_mask=ref_mask,
                            guidance_fns=guidance_fns, capacity=opt.get("capacity", 16384),
                            seed=opt.get("seed", 0), device=device)
    ckpt_dir = opt.get("checkpoint_dir", None)
    if opt.get("resume", False) and ckpt_dir and os.path.exists(ckpt_dir):
        trainer.load_checkpoint(ckpt_dir)
        print(f"[INFO] resumed from {ckpt_dir} at step {trainer.step}")
    stats = trainer.train(max(0, opt.get("iters", 500) - trainer.step),
                          checkpoint_every=opt.get("checkpoint_every", 0),
                          checkpoint_dir=ckpt_dir)
    print(f"[INFO] stage 1 done: {stats}")

    outdir = opt.get("outdir", "logs")
    os.makedirs(outdir, exist_ok=True)
    ply_path = os.path.join(outdir, f"{opt.save_path}_model.ply")
    n = trainer.save_ply(ply_path)
    print(f"[INFO] saved {n} gaussians to {ply_path}")

    if opt.get("save_mesh", True):
        from ..meshing.export import export_textured_mesh

        mesh_path = os.path.join(outdir, f"{opt.save_path}_mesh.{opt.get('mesh_format', 'obj')}")
        export_textured_mesh(
            trainer.params, trainer.aux.alive, lambda cam: trainer.render_view(cam).image,
            mesh_path, fovy=trainer.fovy, radius=trainer.radius,
            density_thresh=opt.get("density_thresh", 1.0),
            texture_size=opt.get("texture_size", 1024),
            bake_resolution=opt.get("bake_resolution", 512),
            mc_resolution=opt.get("mc_resolution", 128),
            decimate_target=opt.get("decimate_target", 100_000),
            uv_cache_path=mesh_path, device=device,
        )
        print(f"[INFO] saved textured mesh to {mesh_path}")
        stats["mesh_path"] = mesh_path
    stats["ply_path"] = ply_path
    return stats


def main(argv=None) -> dict:
    from ..utils.config import load_with_cli

    ap = argparse.ArgumentParser(description="dreamgaussian_tpu_torch stage 1 (gaussians)")
    ap.add_argument("--config", required=True)
    args, extras = ap.parse_known_args(argv)
    return run(load_with_cli(args.config, extras))


if __name__ == "__main__":
    main(sys.argv[1:])
