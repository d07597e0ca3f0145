"""Plain PyTorch score distillation (SDS) of the benchmark's priors.

The reference's guidance: the images are resized to the prior's input
side (bilinear, antialiased), mapped to [-1, 1] and encoded by the VAE
(posterior mean times the scaling factor); the timestep anneals with the
step ratio, ``round((1 - ratio) * 1000)`` clipped to [20, 980]; the
latents are noised with the scaled-linear DDPM table (betas 0.00085 to
0.012 over 1000 steps) and the UNet predicts the noise with classifier-free
guidance; the SDS gradient ``grad = w(t) (eps_hat - noise)`` enters as
``0.5 ||latents - sg(latents - grad)||^2`` over the batch. Per prior:

- Zero123 (zero123_utils.py of the published DreamGaussian): CFG 5, the
  8-channel input (noisy latent next to the reference view's latent, zeros
  in the negative half), context from a linear projection of [CLIP
  embedding, (polar, sin az, cos az, radius)], ``w = 1 - alpha_t``, the
  mean over views times the views;
- MVDream (mvdream_utils.py): groups of 4 views denoised jointly, the
  normalised 16-dim camera, CFG 100, no ``w(t)``, the batch mean.

``Refine`` is stage 2's img2img: the render encoded, noised to the DDIM
step the strength picks and denoised with deterministic DDIM (eta 0,
leading spacing) under CFG, then decoded. Imports nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NUM_TRAIN = 1000


def alphas_cumprod(device) -> torch.Tensor:
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, NUM_TRAIN, dtype=np.float64) ** 2
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32)).to(device)


def resize(images, size: int):
    """Bilinear, antialiased resize of NHWC images."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def anneal_t(step_ratio: float) -> int:
    t = np.round((np.float32(1.0) - np.float32(step_ratio)) * np.float32(NUM_TRAIN))
    return int(np.clip(t, int(NUM_TRAIN * 0.02), int(NUM_TRAIN * 0.98)))


def mvdream_camera(poses):
    """[B, 4, 4] camera-to-world -> MVDream's [B, 16] camera: rows 1 and 2
    swapped, the new row 1 negated, the translation normalised."""
    cam = poses.float()[:, [0, 2, 1, 3]].clone()
    cam[:, 1] = -cam[:, 1]
    t = cam[:, :3, 3]
    cam[:, :3, 3] = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-8)
    return cam.reshape(cam.shape[0], 16)


class SDS:
    """``loss(images [B,H,W,3] in [0,1], cond, step_ratio, noise)`` of one
    prior. ``inputs`` holds the seeded states (Zero123: clip_emb,
    vae_latent, cam_proj_w, cam_proj_b; MVDream: text_pos, text_neg)."""

    def __init__(self, kind: str, unet, vae, inputs: dict, image_size: int):
        self.kind, self.unet, self.vae = kind, unet, vae
        self.inputs = inputs
        self.image_size = image_size
        self.alphas = alphas_cumprod(next(unet.parameters()).device)
        self.scale = 5.0 if kind == "zero123" else 100.0

    def latents(self, images):
        return self.vae.encode(resize(images, self.image_size) * 2.0 - 1.0)

    def loss(self, images, cond: dict, step_ratio: float, noise):
        b = images.shape[0]
        latents = self.latents(images)
        t = torch.full((b,), anneal_t(step_ratio), dtype=torch.int64, device=images.device)
        with torch.no_grad():
            a = self.alphas[t].reshape(b, 1, 1, 1)
            noisy = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
            eps_cond, eps_uncond = self.eps(noisy, t, cond).chunk(2)
            eps_hat = eps_uncond + self.scale * (eps_cond - eps_uncond)
            grad = eps_hat - noise
            if self.kind == "zero123":
                grad = (1.0 - a) * grad
            grad = torch.nan_to_num(grad)
        target = (latents - grad).detach()
        loss = 0.5 * torch.sum((latents - target) ** 2) / b
        return loss * b if self.kind == "zero123" else loss

    def eps(self, noisy, t, cond):
        """The UNet's noise prediction on [cond, uncond] halves."""
        inp = self.inputs
        b = noisy.shape[0]
        if self.kind == "zero123":
            d2r = math.pi / 180.0
            cam = torch.stack([d2r * cond["vers"], torch.sin(d2r * cond["hors"]),
                               torch.cos(d2r * cond["hors"]), cond["radii"]], -1)[:, None]
            clip = inp["clip_emb"][None].expand(b, 1, inp["clip_emb"].shape[-1])
            cc = torch.cat([clip, cam], -1) @ inp["cam_proj_w"] + inp["cam_proj_b"]
            ctx = torch.cat([cc, torch.zeros_like(cc)])
            ref = inp["vae_latent"].expand((b,) + tuple(inp["vae_latent"].shape[1:]))
            x = torch.cat([torch.cat([noisy] * 2), torch.cat([ref, torch.zeros_like(ref)])], -1)
            return self.unet(x, torch.cat([t] * 2), ctx)
        cam = mvdream_camera(cond["poses"])
        ctx = torch.cat([inp["text_pos"][None].expand(b, -1, -1),
                         inp["text_neg"][None].expand(b, -1, -1)])
        return self.unet(torch.cat([noisy] * 2), torch.cat([t] * 2), ctx,
                         camera=torch.cat([cam] * 2))


def ddim_step(alphas, eps, t: int, x, spacing: int):
    """Deterministic DDIM update x_t -> x_{t - spacing} (eta 0; past t = 0
    it lands on alpha[0])."""
    a_t = alphas[t]
    a_prev = alphas[t - spacing] if t - spacing >= 0 else alphas[0]
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def refine_start(steps: int, strength) -> int:
    """First DDIM step of img2img: clip(floor(steps * strength), 0, steps - 1)
    in float32."""
    return int(np.clip(np.floor(np.float32(steps) * np.float32(strength)), 0, steps - 1))


class Refine:
    """Zero123's img2img refine (stage 2): encode, noise to the DDIM step
    that ``strength`` picks (leading spacing over ``steps``), denoise to t
    = 0 with CFG 5, decode, clamp to [0, 1]. ``calls`` counts UNet calls."""

    def __init__(self, sds: SDS, steps: int = 50, scale: float = 5.0):
        self.sds, self.steps, self.scale = sds, steps, scale
        self.calls = 0

    @torch.no_grad()
    def __call__(self, images, cond: dict, strength, noise):
        sds = self.sds
        b = images.shape[0]
        latents = sds.latents(images)
        spacing = NUM_TRAIN // self.steps
        start = refine_start(self.steps, strength)
        t0 = (self.steps - 1 - start) * spacing
        a = sds.alphas[t0]
        x = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
        for i in range(start, self.steps):
            t = (self.steps - 1 - i) * spacing
            tt = torch.full((b,), t, dtype=torch.int64, device=images.device)
            eps_cond, eps_uncond = sds.eps(x, tt, cond).chunk(2)
            self.calls += 1
            x = ddim_step(sds.alphas, eps_uncond + self.scale * (eps_cond - eps_uncond), t, x,
                          spacing)
        return torch.clamp(sds.vae.decode(x) * 0.5 + 0.5, 0.0, 1.0)
