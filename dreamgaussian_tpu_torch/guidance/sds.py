"""Score distillation sampling, img2img refine and text-to-image sampling in torch.

Port of ``dreamgaussian_tpu/guidance/sds.py``:

- Zero123 (reference zero123_utils.py): CFG 5, camera-conditioned tokens
  through a linear projection, 8-channel UNet input (noisy latent ⊕
  reference VAE latent), ``w = 1 - alpha_t``;
- SD 2.1 (sd_utils.py): CFG 100, ``w = 1 - alpha_t``, the prompt picked per
  view by azimuth (front, side, back), the batch-mean loss;
- MVDream (mvdream_utils.py): groups of 4 views denoised jointly, the raw
  normalised 16-dim camera into the UNet, CFG 100, one timestep per step
  and no ``w(t)``;
- ImageDream (imagedream_utils.py): MVDream's groups of 4 with a fifth,
  identity view padded in for every UNet call (zero latent and camera,
  the timestep repeated; the UNet writes the reference image's latent
  ``ip_img`` into it) and stripped from the prediction; the CLIP image
  tokens ``ip`` through the UNet's resampler, zeros for the negative half;
  CFG 5, no ``w(t)``.

Each anneals the timestep with the step ratio or draws it at random;
each clips it to [0.02, 0.98] of the schedule.

Guidance-fn contract (consumed by train/stage1.py):
``fn(images [B,H,W,3] in [0,1], cond dict, step_ratio, draw) -> scalar``,
differentiable w.r.t. the images. ``draw(name, shape, dist)`` supplies the
random numbers (the SDS noise as "sds_noise", NHWC latent shape; the
random timestep as ``draw("sds_t", (), "randint", t_min, t_max + 1)``),
so tests can feed both packages the same samples. The UNet runs under
no_grad; the gradient reaches the images through the VAE encode of the
render.

Refine-fn contract (consumed by train/stage2.py):
``fn(images, cond, strength, draw) -> refined images [B,S,S,3] in [0,1]``
without gradient: encode, noise to the DDIM step that ``strength`` picks
("refine_noise"), denoise to t = 0 with CFG, decode. The CFG batch is
[cond, uncond] in SDS and in SD's refine, [uncond, cond] in MVDream's
refine and in everything ImageDream does (the reference's orders); the
multi-view halves each keep the groups of views whole.

Sample-fn contract (consumed by cli/dream.py): ``sample_fn(steps,
guidance_scale)`` of a text prior returns ``fn(draw)`` (SD: one image [1, S, S,
3]) or ``fn(poses [4, 4, 4], draw)`` (MVDream, ImageDream: 4 views), in
[0, 1]: DDIM through every step of the leading-spaced schedule from pure
noise ("sample_noise", the NHWC latent shape), CFG 7.5 (SD: [pos, neg],
int timesteps; MVDream: [neg, pos]) or 5 (ImageDream: float timesteps).
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


def zero123_cam_embed(vers, hors, radii, default_elevation: float = 0.0,
                      stable: bool = False):
    """[B,4] camera conditioning (zero123_utils.py:66-73). stable-zero123
    puts the polar angle of the reference view where zero123-xl has the
    radius."""
    d2r = math.pi / 180.0
    last = torch.full_like(vers, d2r * (90.0 + default_elevation)) if stable else radii
    return torch.stack([d2r * vers, torch.sin(d2r * hors), torch.cos(d2r * hors), last], -1)


def refine_init_step(steps: int, strength) -> int:
    """First DDIM step of an img2img run: clip(floor(steps * strength), 0,
    steps - 1) in float32, as the JAX package traces it (at 50 steps, the
    float32 strengths 0.86 and 0.92 give 43 and 46)."""
    start = np.floor(np.float32(steps) * np.float32(strength))
    return int(np.clip(start, 0, steps - 1))


def ddim_img2img(sch: DDIMScheduler, steps: int, latents, strength, noise, denoise):
    """img2img DDIM tail: noise ``latents`` to the timestep of step
    ``refine_init_step(steps, strength)``, then denoise through steps
    init_step .. steps-1 with t = (steps - 1 - i) * spacing.
    ``denoise(latents, t) -> eps_hat``."""
    spacing = sch.num_train_timesteps // steps
    init_step = refine_init_step(steps, strength)
    t0 = (steps - 1 - init_step) * spacing
    b = latents.shape[0]
    latents = sch.add_noise(latents, noise, torch.full((b,), t0, dtype=torch.int64,
                                                       device=latents.device))
    for i in range(init_step, steps):
        t = (steps - 1 - i) * spacing
        latents = sch.step_with_spacing(denoise(latents, t), t, latents, spacing)
    return latents


def full_ddim_sample(sch: DDIMScheduler, steps: int, latents, denoise):
    """Text-to-image DDIM from pure-noise ``latents``: every step i of the
    leading-spaced schedule, t = (steps - 1 - i) * spacing.
    ``denoise(latents, t) -> eps_hat``."""
    spacing = sch.num_train_timesteps // steps
    for i in range(steps):
        t = (steps - 1 - i) * spacing
        latents = sch.step_with_spacing(denoise(latents, t), t, latents, spacing)
    return latents


class Zero123Guidance:
    """Image-conditioned novel-view SDS (zero123-xl conditioning).

    ``clip_emb``: [1, 768] CLIP image embedding of the reference view.
    ``vae_latent``: [1, h, w, 4] UNSCALED posterior mean of the reference
    view. ``cam_proj``: (w [772, 768], b [768]) linear projection. ``vae``
    has ``encode`` and (for refine) ``decode``. CFG scale 5. With
    ``anneal`` the SDS timestep follows the step ratio; without it, it is
    drawn uniformly from [t_min, t_max] through the trainer's ``draw``
    ("sds_t", randint).
    """

    guidance_scale = 5.0

    def __init__(self, unet, vae, clip_emb, vae_latent, cam_proj, image_size: int = 256,
                 stable: bool = False, default_elevation: float = 0.0, anneal: bool = True):
        self.unet = unet
        self.vae = vae
        self.scheduler = DDIMScheduler(device=clip_emb.device)
        self.num_train = self.scheduler.num_train_timesteps
        self.t_min = int(self.num_train * 0.02)
        self.t_max = int(self.num_train * 0.98)
        self.image_size = image_size
        self.anneal = anneal
        self.clip_emb = clip_emb
        self.vae_latent = vae_latent
        self.cam_proj = cam_proj
        self.stable = stable
        self.default_elevation = default_elevation

    def num_parameters(self) -> int:
        return sum(p.numel() for m in (self.unet, self.vae) for p in m.parameters())

    def _cond_tokens(self, vers, hors, radii, b):
        cam = zero123_cam_embed(vers, hors, radii, self.default_elevation,
                                self.stable)[:, None, :]                 # [B,1,4]
        clip = self.clip_emb[None].expand(b, 1, self.clip_emb.shape[-1])
        w, bias = self.cam_proj
        return torch.cat([clip, cam], -1) @ w + bias                     # [B,1,768]

    def guidance_fn(self):
        alphas = self.scheduler.alphas_cumprod

        def fn(images, cond, step_ratio, draw):
            dev = images.device
            b = images.shape[0]
            imgs = _resize(images, self.image_size) * 2.0 - 1.0
            latents = self.vae.encode(imgs)
            if self.anneal:
                t = anneal_t(step_ratio, self.num_train, self.t_min, self.t_max)
            else:
                t = draw("sds_t", (), "randint", self.t_min, self.t_max + 1)
            t_b = torch.as_tensor(t, device=dev).to(torch.int64).expand(b)
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
                w = (1.0 - alphas[t_b]).reshape(b, 1, 1, 1)
                grad = torch.nan_to_num(w * (eps_hat - noise))
            # Mean over views times B: the reference's unscaled sum at B=1.
            return sds_grad_loss(latents, grad, divide_by_batch=True) * b

        # A sum over the views, not the mean the trainers' contract asks
        # for: the data-parallel step weighs it 1/data (cli.main says so).
        fn.sums_views = True
        return fn

    def refine_fn(self, steps: int = 50, guidance_scale: float = 5.0):
        """img2img refine (see the module's refine-fn contract); cond needs
        vers/hors/radii."""
        sch = self.scheduler

        @torch.no_grad()
        def fn(images, cond, strength, draw):
            dev = images.device
            b = images.shape[0]
            latents = self.vae.encode(_resize(images, self.image_size) * 2.0 - 1.0)
            cc = self._cond_tokens(cond["vers"], cond["hors"], cond["radii"], b)
            ctx = torch.cat([cc, torch.zeros_like(cc)])
            vae_emb = self.vae_latent.expand((b,) + tuple(self.vae_latent.shape[1:]))
            vae_in = torch.cat([vae_emb, torch.zeros_like(vae_emb)])

            def denoise(lat, t):
                t_in = torch.full((2 * b,), t, dtype=torch.int64, device=dev)
                eps = self.unet(torch.cat([torch.cat([lat] * 2), vae_in], dim=-1), t_in, ctx)
                eps_cond, eps_uncond = eps.chunk(2)
                return eps_uncond + guidance_scale * (eps_cond - eps_uncond)

            noise = draw("refine_noise", tuple(latents.shape), "normal").to(dev)
            latents = ddim_img2img(sch, steps, latents, strength, noise, denoise)
            return torch.clamp(self.vae.decode(latents) * 0.5 + 0.5, 0.0, 1.0)

        return fn



class _TextGuidance:
    """What SD and MVDream share: the nets, the text states, the schedule."""

    guidance_scale = 100.0

    def __init__(self, unet, vae, embeddings: dict, image_size: int, anneal: bool):
        self.unet = unet
        self.vae = vae
        self.emb = embeddings
        self.scheduler = DDIMScheduler(device=embeddings["pos"].device)
        self.num_train = self.scheduler.num_train_timesteps
        self.t_min = int(self.num_train * 0.02)
        self.t_max = int(self.num_train * 0.98)
        self.image_size = image_size
        self.anneal = anneal

    def num_parameters(self) -> int:
        return sum(p.numel() for m in (self.unet, self.vae) for p in m.parameters())

    def _timestep(self, step_ratio, draw):
        if self.anneal:
            return anneal_t(step_ratio, self.num_train, self.t_min, self.t_max)
        return draw("sds_t", (), "randint", self.t_min, self.t_max + 1)

    def _batch(self, name: str, b: int):
        return self.emb[name][None].expand((b,) + tuple(self.emb[name].shape))

    @property
    def latent_size(self) -> int:
        return self.vae.latent_side(self.image_size)

    def _sample(self, b: int, steps: int, denoise, draw):
        """``full_ddim_sample`` from drawn noise (the VAE's 4 latent
        channels), decoded to [0, 1]."""
        s = self.latent_size
        noise = draw("sample_noise", (b, s, s, 4), "normal")
        latents = full_ddim_sample(self.scheduler, steps, noise.to(self.emb["pos"].device),
                                   denoise)
        return torch.clamp(self.vae.decode(latents) * 0.5 + 0.5, 0.0, 1.0)


class StableDiffusionGuidance(_TextGuidance):
    """SD 2.1 SDS. ``embeddings``: [77, D] text states under 'pos', 'neg'
    and, for the directional prompts, 'front', 'side', 'back'."""

    def __init__(self, unet, vae, embeddings: dict, image_size: int = 512, anneal: bool = True):
        super().__init__(unet, vae, embeddings, image_size, anneal)

    def _directional_embeds(self, hors, b: int):
        """Per view by azimuth: |hor| < 60 front, < 120 side, else back."""
        if "front" not in self.emb:
            return self._batch("pos", b)
        stack = torch.stack([self.emb["front"], self.emb["side"], self.emb["back"]])
        ah = hors.abs()
        return stack[torch.where(ah < 60, 0, torch.where(ah < 120, 1, 2))]

    def _context(self, cond, b: int, dev):
        hors = cond.get("hors") if cond else None
        hors = torch.zeros(b, device=dev) if hors is None else hors.to(dev)
        return torch.cat([self._directional_embeds(hors, b), self._batch("neg", b)])

    def guidance_fn(self):
        alphas = self.scheduler.alphas_cumprod

        def fn(images, cond, step_ratio, draw):
            dev = images.device
            b = images.shape[0]
            latents = self.vae.encode(_resize(images, self.image_size) * 2.0 - 1.0)
            t = self._timestep(step_ratio, draw)
            t_b = torch.as_tensor(t, device=dev).to(torch.int64).expand(b)
            noise = draw("sds_noise", tuple(latents.shape), "normal").to(dev)
            with torch.no_grad():
                latents_noisy = self.scheduler.add_noise(latents.detach(), noise, t_b)
                eps = self.unet(torch.cat([latents_noisy] * 2), torch.cat([t_b] * 2),
                                self._context(cond, b, dev))
                eps_cond, eps_uncond = eps.chunk(2)
                eps_hat = eps_uncond + self.guidance_scale * (eps_cond - eps_uncond)
                w = (1.0 - alphas[t_b]).reshape(b, 1, 1, 1)
                grad = torch.nan_to_num(w * (eps_hat - noise))
            return sds_grad_loss(latents, grad, divide_by_batch=True)

        return fn

    def refine_fn(self, steps: int = 50):
        """img2img refine (the module's refine-fn contract); the prompt per
        view from cond's hors, the front one without them."""
        sch = self.scheduler

        @torch.no_grad()
        def fn(images, cond, strength, draw):
            dev = images.device
            b = images.shape[0]
            latents = self.vae.encode(_resize(images, self.image_size) * 2.0 - 1.0)
            ctx = self._context(cond, b, dev)

            def denoise(lat, t):
                t_in = torch.full((2 * b,), t, dtype=torch.int64, device=dev)
                eps_cond, eps_uncond = self.unet(torch.cat([lat] * 2), t_in, ctx).chunk(2)
                return eps_uncond + self.guidance_scale * (eps_cond - eps_uncond)

            noise = draw("refine_noise", tuple(latents.shape), "normal").to(dev)
            latents = ddim_img2img(sch, steps, latents, strength, noise, denoise)
            return torch.clamp(self.vae.decode(latents) * 0.5 + 0.5, 0.0, 1.0)

        return fn

    def sample_fn(self, steps: int = 50, guidance_scale: float = 7.5):
        """Text-to-image sampler (sd_utils.py prompt_to_img): ``fn(draw) ->
        [1, S, S, 3]``, CFG [pos, neg] with int timesteps."""

        @torch.no_grad()
        def fn(draw):
            dev = self.emb["pos"].device
            ctx = torch.cat([self._batch("pos", 1), self._batch("neg", 1)])

            def denoise(lat, t):
                t_in = torch.full((2,), t, dtype=torch.int64, device=dev)
                eps_cond, eps_uncond = self.unet(torch.cat([lat] * 2), t_in, ctx).chunk(2)
                return eps_uncond + guidance_scale * (eps_cond - eps_uncond)

            return self._sample(1, steps, denoise, draw)

        return fn


def mvdream_camera(poses):
    """[B, 4, 4] OpenGL camera-to-world -> MVDream's [B, 16] camera
    (mvdream_utils.py:125-128): rows 1 and 2 swapped, the new row 1
    negated, the translation normalised."""
    cam = poses.float()[:, [0, 2, 1, 3]].clone()
    cam[:, 1] = -cam[:, 1]
    t = cam[:, :3, 3]
    cam[:, :3, 3] = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-8)
    return cam.reshape(cam.shape[0], 16)


class MVDreamGuidance(_TextGuidance):
    """4-view joint SDS (no w(t)). ``embeddings``: [77, D] states 'pos' and
    'neg'. The images come in groups of ``num_views`` consecutive views
    with their poses in ``cond["poses"]``; the raw 16-dim camera goes into
    the UNet, which embeds it."""

    num_views = 4

    def __init__(self, unet, vae, embeddings: dict, image_size: int = 256, anneal: bool = True):
        super().__init__(unet, vae, embeddings, image_size, anneal)

    def guidance_fn(self):
        def fn(images, cond, step_ratio, draw):
            dev = images.device
            b = images.shape[0]          # num_views x groups
            latents = self.vae.encode(_resize(images, self.image_size) * 2.0 - 1.0)
            t = self._timestep(step_ratio, draw)
            t_b = torch.as_tensor(t, device=dev).to(torch.int64).expand(b)
            noise = draw("sds_noise", tuple(latents.shape), "normal").to(dev)
            with torch.no_grad():
                latents_noisy = self.scheduler.add_noise(latents.detach(), noise, t_b)
                cam = mvdream_camera(cond["poses"].to(dev))
                ctx = torch.cat([self._batch("pos", b), self._batch("neg", b)])
                eps = self.unet(torch.cat([latents_noisy] * 2), torch.cat([t_b] * 2), ctx,
                                camera=torch.cat([cam] * 2))
                eps_cond, eps_uncond = eps.chunk(2)
                eps_hat = eps_uncond + self.guidance_scale * (eps_cond - eps_uncond)
                grad = torch.nan_to_num(eps_hat - noise)
            return sds_grad_loss(latents, grad, divide_by_batch=True)

        return fn

    def refine_fn(self, steps: int = 50):
        """4-view joint img2img refine; cond needs the poses."""
        sch = self.scheduler

        @torch.no_grad()
        def fn(images, cond, strength, draw):
            dev = images.device
            b = images.shape[0]
            latents = self.vae.encode(_resize(images, self.image_size) * 2.0 - 1.0)
            cam = torch.cat([mvdream_camera(cond["poses"].to(dev))] * 2)
            ctx = torch.cat([self._batch("neg", b), self._batch("pos", b)])

            def denoise(lat, t):
                t_in = torch.full((2 * b,), t, dtype=torch.int64, device=dev)
                eps_uncond, eps_cond = self.unet(torch.cat([lat] * 2), t_in, ctx,
                                                 camera=cam).chunk(2)
                return eps_uncond + self.guidance_scale * (eps_cond - eps_uncond)

            noise = draw("refine_noise", tuple(latents.shape), "normal").to(dev)
            latents = ddim_img2img(sch, steps, latents, strength, noise, denoise)
            return torch.clamp(self.vae.decode(latents) * 0.5 + 0.5, 0.0, 1.0)

        return fn

    def sample_fn(self, steps: int = 30, guidance_scale: float = 7.5):
        """Text-to-multiview sampler (mvdream_utils.py prompt_to_img): ``fn(poses
        [4, 4, 4], draw) -> [4, S, S, 3]``, one group denoised jointly, CFG
        [neg, pos]."""
        b = self.num_views

        @torch.no_grad()
        def fn(poses, draw):
            dev = self.emb["pos"].device
            cam = torch.cat([mvdream_camera(poses.to(dev))] * 2)
            ctx = torch.cat([self._batch("neg", b), self._batch("pos", b)])

            def denoise(lat, t):
                t_in = torch.full((2 * b,), t, dtype=torch.int64, device=dev)
                eps_uncond, eps_cond = self.unet(torch.cat([lat] * 2), t_in, ctx,
                                                 camera=cam).chunk(2)
                return eps_uncond + guidance_scale * (eps_cond - eps_uncond)

            return self._sample(b, steps, denoise, draw)

        return fn


class ImageDreamGuidance(_TextGuidance):
    """Image+text SDS over groups of 4 views with the identity view
    (imagedream_utils.py). ``embeddings``: [77, D] text states 'pos' and
    'neg'. ``image_embeddings``: 'pos', the reference image's CLIP tokens
    [L, D_ip], and 'ip_img', its VAE latent [h, w, 4] (the negatives are
    zeros). The images come in groups of 4 consecutive views with their
    poses in ``cond["poses"]``; every UNet call pads each group with the
    identity view and strips it from the prediction. CFG 5, no w(t)."""

    guidance_scale = 5.0
    num_views = 4

    def __init__(self, unet, vae, embeddings: dict, image_embeddings: dict, image_size: int = 256,
                 anneal: bool = True):
        super().__init__(unet, vae, embeddings, image_size, anneal)
        self.img_emb = image_embeddings

    def _pad_views(self, x, repeat: bool = False):
        """[rB*4, ...] -> [rB*5, ...]: each group gains a fifth view, zeros or
        (``repeat``) a copy of its first."""
        g = x.reshape((-1, self.num_views) + tuple(x.shape[1:]))
        pad = g[:, :1] if repeat else torch.zeros_like(g[:, :1])
        return torch.cat([g, pad], 1).reshape((-1,) + tuple(x.shape[1:]))

    def _strip_views(self, x):
        g = x.reshape((-1, self.num_views + 1) + tuple(x.shape[1:]))
        return g[:, :self.num_views].reshape((-1,) + tuple(x.shape[1:]))

    def _denoiser(self, poses, guidance_scale: float):
        """``denoise(latents [rB*4, h, w, C], t) -> eps_hat`` for the groups
        of ``poses``: one UNet call on [uncond, cond] halves of rB*5 views
        (zero ip tokens and identity latent in the uncond half), t repeated
        into the identity view, the prediction stripped back to 4 views."""
        dev = poses.device
        rb = poses.shape[0] // self.num_views
        n5 = rb * (self.num_views + 1)
        cam = torch.cat([self._pad_views(mvdream_camera(poses))] * 2)
        ctx = torch.cat([self._batch("neg", n5), self._batch("pos", n5)])
        tokens = self.img_emb["pos"]
        ip_pos = tokens[None].expand((n5,) + tuple(tokens.shape))
        ip = torch.cat([torch.zeros_like(ip_pos), ip_pos])
        latent = self.img_emb["ip_img"]
        ip_img_pos = latent[None].expand((rb,) + tuple(latent.shape))
        ip_img = torch.cat([torch.zeros_like(ip_img_pos), ip_img_pos])

        def denoise(lat, t):
            t_in = torch.as_tensor(t, device=dev).float().expand(lat.shape[0])
            t_in = torch.cat([self._pad_views(t_in, repeat=True)] * 2)
            eps = self.unet(torch.cat([self._pad_views(lat)] * 2), t_in, ctx, camera=cam, ip=ip,
                            ip_img=ip_img)
            eps_uncond, eps_cond = (self._strip_views(e) for e in eps.chunk(2))
            return eps_uncond + guidance_scale * (eps_cond - eps_uncond)

        return denoise

    def guidance_fn(self):
        def fn(images, cond, step_ratio, draw):
            dev = images.device
            b = images.shape[0]          # num_views x groups
            latents = self.vae.encode(_resize(images, self.image_size) * 2.0 - 1.0)
            t = self._timestep(step_ratio, draw)
            t_b = torch.as_tensor(t, device=dev).to(torch.int64).expand(b)
            noise = draw("sds_noise", tuple(latents.shape), "normal").to(dev)
            with torch.no_grad():
                latents_noisy = self.scheduler.add_noise(latents.detach(), noise, t_b)
                denoise = self._denoiser(cond["poses"].to(dev), self.guidance_scale)
                grad = torch.nan_to_num(denoise(latents_noisy, t) - noise)
            return sds_grad_loss(latents, grad, divide_by_batch=True)

        return fn

    def refine_fn(self, steps: int = 50):
        """4(+1)-view img2img refine; cond needs the poses."""
        sch = self.scheduler

        @torch.no_grad()
        def fn(images, cond, strength, draw):
            dev = images.device
            latents = self.vae.encode(_resize(images, self.image_size) * 2.0 - 1.0)
            denoise = self._denoiser(cond["poses"].to(dev), self.guidance_scale)
            noise = draw("refine_noise", tuple(latents.shape), "normal").to(dev)
            latents = ddim_img2img(sch, steps, latents, strength, noise, denoise)
            return torch.clamp(self.vae.decode(latents) * 0.5 + 0.5, 0.0, 1.0)

        return fn

    def sample_fn(self, steps: int = 30, guidance_scale: float = 5.0):
        """Image+text-to-multiview sampler (imagedream_utils.py prompt_to_img):
        ``fn(poses [4, 4, 4], draw) -> [4, S, S, 3]``, the identity view
        padded in at every step as in the refine."""

        @torch.no_grad()
        def fn(poses, draw):
            denoise = self._denoiser(poses.to(self.emb["pos"].device), guidance_scale)
            return self._sample(self.num_views, steps, denoise, draw)

        return fn
