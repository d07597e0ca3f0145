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
when it exists (else trains from step 0) up to ``iters`` steps in all.

Sharding: ``mesh=8``, ``mesh=data8`` or ``mesh=data4xtile2`` trains on a
(data, tile) mesh of ranks, one process each, started by ``torchrun``:

    torchrun --standalone --nproc-per-node 2 -m dreamgaussian_tpu_torch.cli.main \
        --config configs/image.yaml input=x.png save_path=name mesh=data2 batch_size=2

or over several nodes, one ``torchrun`` per node at one rendezvous:

    torchrun --nnodes 2 --node-rank {0,1} --nproc-per-node 2 --master-addr <node 0> \
        --master-port <port> -m dreamgaussian_tpu_torch.cli.main ... mesh=data2xtile2

The mesh's size must equal the number of processes; a tile group is a run
of consecutive ranks, so with ``--nproc-per-node`` a multiple of the tile
size it stays on one node. Ranks use their node's cards
(``cuda:{LOCAL_RANK % cards}``) or run on the CPU with ``device=cpu``; the
backend is NCCL when no two ranks share a card, else gloo
(``parallel/multihost.py``). Rank 0 writes the PLY, the mesh and the
checkpoints, and the other ranks wait for it at a barrier. On a mesh,
``resume=True`` is rank 0's decision: it alone looks for ``checkpoint_dir``
and reads it, and every rank resumes from its state, so the other nodes
need no copy of the folder (``utils/checkpoint.py``).
"""

from __future__ import annotations

import argparse
import os
import re
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


def load_reference(opt, device=None):
    """(rgb composited on white, mask) of ``opt.input`` at ref_size, or
    (None, None) without an input; an RGB input is matted on ``device``
    (the config's by default)."""
    if not opt.get("input", None):
        return None, None
    from .process import load_rgba

    rgba = load_rgba(opt.input, size=opt.get("ref_size", 256),
                     device=device or opt.get("device", "cuda"))
    return rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:]), rgba[..., 3]


def parse_mesh_spec(spec) -> dict | None:
    """The ``mesh`` config value as axis sizes: ``8`` and ``"data8"`` give
    {"data": 8}, ``"data4xtile2"`` {"data": 4, "tile": 2}; None when unset."""
    if spec in (None, "", 0, False):
        return None
    if isinstance(spec, int) or (isinstance(spec, str) and spec.isdigit()):
        return {"data": int(spec)}
    axes = {}
    for part in str(spec).split("x"):
        m = re.fullmatch(r"(data|tile)(\d+)", part.strip())
        if not m or m.group(1) in axes or int(m.group(2)) < 1:
            raise ValueError(f"bad mesh spec {spec!r}: use e.g. 8, 'data8', 'data4xtile2'")
        axes[m.group(1)] = int(m.group(2))
    return axes


def build_mesh(opt):
    """The (data, tile) mesh of the ``mesh`` config key over this run's
    ranks (``torchrun``'s environment), or None when the key is unset. The
    mesh's size must equal the world size."""
    axes = parse_mesh_spec(opt.get("mesh", None))
    if axes is None:
        return None
    from ..parallel.multihost import initialize_multihost, make_mesh_2d

    world = int(os.environ.get("WORLD_SIZE", 1))
    total = axes.get("data", 1) * axes.get("tile", 1)
    if total != world:
        raise ValueError(f"mesh {opt.mesh!r} needs {total} ranks, this run has {world} "
                         "(start it with torchrun --nproc-per-node N)")
    device = opt.get("device", "cuda")
    backend = initialize_multihost(device=device)
    mesh = make_mesh_2d(axes.get("data", 1), axes.get("tile", 1), device=device)
    if mesh.rank == 0:
        print(f"[shard] rank 0 of {world}, backend {backend or 'none (one process)'}, "
              f"device {mesh.device}")
    if backend is not None:
        tile = [mesh.data.index * mesh.tile.size + t for t in range(mesh.tile.size)]
        print(f"[shard] rank {mesh.rank}: node {os.environ.get('GROUP_RANK', 0)}, local rank "
              f"{os.environ.get('LOCAL_RANK', 0)}, device {mesh.device}, tile group {tile}",
              flush=True)
    return mesh


def resume_checkpoint(opt, trainer) -> bool:
    """``resume=True``: continue ``trainer`` from ``checkpoint_dir`` when it
    exists. On a mesh rank 0 alone looks and every rank takes its answer
    and, through ``load_checkpoint``, its state, whatever the rank's own
    disk holds (a host without the shared folder). Returns whether the run
    resumed."""
    ckpt_dir = opt.get("checkpoint_dir", None)
    found = bool(opt.get("resume", False) and ckpt_dir and os.path.exists(ckpt_dir))
    mesh = trainer.mesh
    if mesh is not None and mesh.backend is not None:
        import torch
        import torch.distributed as dist

        flag = torch.tensor([found], dtype=torch.int64, device=mesh.device)
        dist.broadcast(flag, 0)   # NCCL takes CUDA tensors only, gloo either
        found = bool(flag.item())
    if found:
        trainer.load_checkpoint(ckpt_dir)
        who = "" if mesh is None else f" (rank {mesh.rank})"
        print(f"[INFO] resumed from {ckpt_dir} at step {trainer.step}{who}")
    return found


def run(opt, guidance_fns=None, draw=None) -> dict:
    """Stage 1 and the export. ``guidance_fns`` (in place of the config's)
    and ``draw`` (the trainer's random numbers) let a test inject another
    package's weights and samples; neither is a config key."""
    device = resolve_device(opt.get("device", "cuda"))
    mesh = build_mesh(opt)
    try:
        return _run(opt, device, mesh, guidance_fns, draw)
    finally:
        if mesh is not None and mesh.backend is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(opt, device, mesh, guidance_fns=None, draw=None) -> dict:
    from ..train import Stage1Trainer

    if mesh is not None:
        device = mesh.device
        if mesh.rank == 0:
            print(f"[INFO] training on a {mesh.describe()} device mesh")
    ref_rgb, ref_mask = load_reference(opt, device)
    if guidance_fns is None:
        guidance_fns = build_guidances(opt, ref_rgb, device)
    if mesh is not None and mesh.rank == 0 and mesh.data.size > 1 \
            and any(getattr(fn, "sums_views", False) for _, fn in guidance_fns):
        print(f"[shard] note: Zero123's guidance returns the sum over its views and each data "
              f"rank's share is divided by data={mesh.data.size}, so the Zero123 term weighs "
              f"1/{mesh.data.size} of what it weighs in one process at the same batch_size "
              "(kept as the JAX package has it)")
    trainer = Stage1Trainer(opt, ref_rgb=ref_rgb, ref_mask=ref_mask,
                            guidance_fns=guidance_fns, capacity=opt.get("capacity", 16384),
                            seed=opt.get("seed", 0), device=device, mesh=mesh, draw=draw)
    ckpt_dir = opt.get("checkpoint_dir", None)
    resume_checkpoint(opt, trainer)
    stats = trainer.train(max(0, opt.get("iters", 500) - trainer.step),
                          checkpoint_every=opt.get("checkpoint_every", 0),
                          checkpoint_dir=ckpt_dir)
    print(f"[INFO] stage 1 done: {stats}")

    outdir = opt.get("outdir", "logs")
    ply_path = os.path.join(outdir, f"{opt.save_path}_model.ply")
    stats["ply_path"] = ply_path
    if not trainer.is_writer:
        # Rank 0 writes the files; the others wait for it and leave.
        import torch.distributed as dist

        dist.barrier()
        return stats
    os.makedirs(outdir, exist_ok=True)
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
    if mesh is not None and mesh.backend is not None:
        import torch.distributed as dist

        dist.barrier()
    return stats


def main(argv=None) -> dict:
    from ..utils.config import load_with_cli

    ap = argparse.ArgumentParser(description="dreamgaussian_tpu_torch stage 1 (gaussians)")
    ap.add_argument("--config", required=True)
    args, extras = ap.parse_known_args(argv)
    return run(load_with_cli(args.config, extras))


if __name__ == "__main__":
    main(sys.argv[1:])
