"""Zero123 score distillation sampling in torch.

Port of the Zero123 part of ``dreamgaussian_tpu/guidance/sds.py``
(reference zero123_utils.py): CFG 5, camera-conditioned tokens through a
linear projection, 8-channel UNet input (noisy latent ⊕ reference VAE
latent), ``w = 1 - alpha_t``, timestep annealed with the step ratio.

Guidance-fn contract (consumed by train/stage1.py):
``fn(images [B,H,W,3] in [0,1], cond dict, step_ratio, draw) -> scalar``,
differentiable w.r.t. the images. ``draw(name, shape, dist)`` supplies the
random numbers (the SDS noise as "sds_noise", NHWC latent shape), so tests
can feed both packages the same samples. The UNet runs under no_grad; the
gradient reaches the images through the VAE encode of the render.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .scheduler import DDIMScheduler


def _resize(images, size: int):
    """Bilinear resize of NHWC images, antialiased when downsampling (as
    ``jax.image.resize(..., "bilinear")``)."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def sds_grad_loss(latents, grad, divide_by_batch: bool):
    """loss = 0.5*||latents - sg(latents - grad)||^2_sum (/ B)."""
    target = (latents - grad).detach()
    loss = 0.5 * torch.sum((latents - target) ** 2)
    if divide_by_batch:
        loss = loss / latents.shape[0]
    return loss


def anneal_t(step_ratio: float, num_train: int, t_min: int, t_max: int) -> int:
    """round((1 - step_ratio) * N) clipped to [t_min, t_max], in float32."""
    t = np.round((np.float32(1.0) - np.float32(step_ratio)) * np.float32(num_train))
    return int(np.clip(t, t_min, t_max))


def zero123_cam_embed(vers, hors, radii):
    """[B,4] camera conditioning of zero123-xl (zero123_utils.py:66-73)."""
    d2r = math.pi / 180.0
    return torch.stack([d2r * vers, torch.sin(d2r * hors), torch.cos(d2r * hors), radii], -1)


class Zero123Guidance:
    """Image-conditioned novel-view SDS (zero123-xl conditioning).

    ``clip_emb``: [1, 768] CLIP image embedding of the reference view.
    ``vae_latent``: [1, h, w, 4] UNSCALED posterior mean of the reference
    view. ``cam_proj``: (w [772, 768], b [768]) linear projection. The
    timestep is annealed with the step ratio, CFG scale 5; the random
    timestep and stable-zero123's conditioning wait for a later slice.
    """

    guidance_scale = 5.0

    def __init__(self, unet, vae, clip_emb, vae_latent, cam_proj, image_size: int = 256):
        self.unet = unet
        self.vae = vae
        self.scheduler = DDIMScheduler(device=clip_emb.device)
        self.num_train = self.scheduler.num_train_timesteps
        self.t_min = int(self.num_train * 0.02)
        self.t_max = int(self.num_train * 0.98)
        self.image_size = image_size
        self.clip_emb = clip_emb
        self.vae_latent = vae_latent
        self.cam_proj = cam_proj

    def num_parameters(self) -> int:
        return sum(p.numel() for m in (self.unet, self.vae) for p in m.parameters())

    def _cond_tokens(self, vers, hors, radii, b):
        cam = zero123_cam_embed(vers, hors, radii)[:, None, :]          # [B,1,4]
        clip = self.clip_emb[None].expand(b, 1, self.clip_emb.shape[-1])
        w, bias = self.cam_proj
        return torch.cat([clip, cam], -1) @ w + bias                     # [B,1,768]

    def guidance_fn(self):
        alphas = self.scheduler.alphas_np

        def fn(images, cond, step_ratio, draw):
            dev = images.device
            b = images.shape[0]
            imgs = _resize(images, self.image_size) * 2.0 - 1.0
            latents = self.vae.encode(imgs)
            t = anneal_t(step_ratio, self.num_train, self.t_min, self.t_max)
            t_b = torch.full((b,), t, dtype=torch.int64, device=dev)
            noise = draw("sds_noise", tuple(latents.shape), "normal").to(dev)
            with torch.no_grad():
                latents_noisy = self.scheduler.add_noise(latents.detach(), noise, t_b)
                cc = self._cond_tokens(cond["vers"], cond["hors"], cond["radii"], b)
                ctx = torch.cat([cc, torch.zeros_like(cc)])
                vae_emb = self.vae_latent.expand((b,) + tuple(self.vae_latent.shape[1:]))
                vae_in = torch.cat([vae_emb, torch.zeros_like(vae_emb)])
                x_in = torch.cat([torch.cat([latents_noisy] * 2), vae_in], dim=-1)
                eps = self.unet(x_in, torch.cat([t_b] * 2), ctx)
                eps_cond, eps_uncond = eps.chunk(2)
                eps_hat = eps_uncond + self.guidance_scale * (eps_cond - eps_uncond)
                w = float(np.float32(1.0) - alphas[t])
                grad = torch.nan_to_num(w * (eps_hat - noise))
            # Mean over views times B: the reference's unscaled sum at B=1.
            return sds_grad_loss(latents, grad, divide_by_batch=True) * b

        return fn
