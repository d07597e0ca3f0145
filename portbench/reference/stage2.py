"""Plain PyTorch stage-2 step of DreamGaussian (texture refinement), the
benchmark's reference.

One step, as the published trainer (main2.py) takes it on a fixed mesh
with a trainable UV albedo (logits, sigmoid after filtering):

1. from the run's numpy generator: the SSAA factor of the novel render (one
   of 0.25, 0.75, 1.25, 1.75, the reference's jitter in four equal bins),
   then per batch entry an elevation offset and an azimuth as in stage 1;
2. the target: the novel view rendered at the refine's input side (the
   render resolution times image_size / render resolution), refined by the
   prior's img2img at strength ``0.8 + 0.15 step / iters_refine`` (float32)
   and resized back to the render resolution; no gradient;
3. the loss: the known view at ``ref_size`` (elevation 0, azimuth 0)
   ``mean(((image - ref) valid)^2)`` with ``valid = (alpha > 0) & (viewcos
   > 0.5)``, plus ``lambda mean((image - target)^2)`` of the novel view
   rendered at its SSAA side;
4. the gradient, NaN-zeroed, and Adam (as stage 1) at ``texture_lr``.

The refine noise is the benchmark's draw, handed to both sides. Imports
nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import mesh as mesh_ops
from . import render
from .stage1 import ADAM_B1, adam

SSAA_CHOICES = (0.25, 0.75, 1.25, 1.75)


def pose_rotation(view) -> torch.Tensor:
    """Camera-to-world rotation from a GS view matrix: the rectified
    world-to-camera rows 1:3 negated back, transposed."""
    w2c = view[:3, :3].clone()
    w2c[1:3] *= -1
    return w2c.T


class Stage2:
    """The reference's stage-2 state: ``mesh`` (v, f, vn, vt, ft tensors),
    the albedo logits, Adam's moments. ``refine`` is a
    ``guidance.Refine``; ``draws`` yields the benchmark's draws."""

    def __init__(self, opt: dict, mesh: dict, albedo, ref_rgb, refine, weight: float,
                 rng: np.random.Generator, draws, refine_image_size: int):
        self.opt, self.mesh, self.refine, self.weight, self.rng = opt, mesh, refine, weight, rng
        self.raw_albedo = mesh_ops.trunc_rev_sigmoid(albedo)
        self.ref_rgb, self.draws = ref_rgb, draws
        self.refine_image_size = refine_image_size
        self.mu, self.nu = torch.zeros_like(self.raw_albedo), torch.zeros_like(self.raw_albedo)
        self.count = 0
        self.step = 0
        self.fovy = math.radians(opt.get("fovy", 49.1))
        self.size = opt.get("novel_resolution", 512)

    def cameras(self):
        """This step's draws from the numpy generator: (ssaa, vers, hors,
        poses)."""
        ssaa = SSAA_CHOICES[int(self.rng.integers(0, len(SSAA_CHOICES)))]
        vers, hors, poses = render.sample_orbit(self.rng, self.opt,
                                                self.opt.get("batch_size", 1), 1)
        return ssaa, vers, hors, poses

    def _cam(self, pose):
        dev = self.raw_albedo.device
        cam = {k: torch.from_numpy(v).to(dev)
               for k, v in render.camera_arrays(pose, self.fovy).items()}
        return cam, pose_rotation(cam["view"])

    def _draw(self, name: str):
        got, tensor = next(self.draws)
        if got != name:
            raise RuntimeError(f"the reference wants the draw {name!r}, the run made {got!r}")
        return tensor

    def target_ssaa(self) -> float:
        return min(1.0, self.refine_image_size / self.size)

    def train_step(self) -> float:
        opt, dev = self.opt, self.raw_albedo.device
        self.step += 1
        ratio = min(1.0, self.step / opt.get("iters_refine", 50))
        ssaa, vers, hors, poses = self.cameras()
        strength = np.float32(ratio * 0.15 + 0.8)
        cond = {"vers": torch.from_numpy(vers).to(dev), "hors": torch.from_numpy(hors).to(dev),
                "radii": torch.zeros(len(vers), device=dev), "poses": torch.from_numpy(poses).to(dev)}
        cams = [self._cam(p) for p in poses]
        with torch.no_grad():
            images = torch.stack([mesh_ops.render(self.mesh, self.raw_albedo, c, r, self.size,
                                                  self.target_ssaa())["image"] for c, r in cams])
            noise = self._draw("refine_noise")
            target = mesh_ops.scale_img(self.refine(images, cond, strength, noise),
                                        self.size, self.size)
        raw = self.raw_albedo.detach().requires_grad_(True)
        loss = torch.zeros((), device=dev)
        if self.ref_rgb is not None:
            cam, rot = self._cam(render.orbit_pose(opt.get("elevation", 0.0), 0.0,
                                                   opt.get("radius", 2.0)))
            out = mesh_ops.render(self.mesh, raw, cam, rot, opt.get("ref_size", 256), 1.0)
            valid = ((out["alpha"] > 0) & (out["viewcos"] > 0.5)).float()
            loss = loss + torch.mean(((out["image"] - self.ref_rgb) * valid) ** 2)
        for b, (cam, rot) in enumerate(cams):
            image = mesh_ops.render(self.mesh, raw, cam, rot, self.size, ssaa)["image"]
            loss = loss + self.weight * torch.mean((image - target[b]) ** 2)
        loss.backward()
        grad = torch.nan_to_num(raw.grad)
        self.count += 1
        mu, nu = {"raw_albedo": self.mu}, {"raw_albedo": self.nu}
        new = adam({"raw_albedo": self.raw_albedo}, {"raw_albedo": grad}, mu, nu, self.count,
                   {"raw_albedo": opt.get("texture_lr", 0.2)})
        self.raw_albedo, self.mu, self.nu = new["raw_albedo"], mu["raw_albedo"], nu["raw_albedo"]
        return float(loss.detach())

    def first_gradient(self):
        return self.mu / (1.0 - ADAM_B1)
