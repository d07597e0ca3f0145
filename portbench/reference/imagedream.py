"""Plain PyTorch score distillation of ImageDream, the reference of the
``imagedream`` cells.

ImageDream (Wang and Shi, arXiv 2312.02201; DreamGaussian's
``guidance/imagedream_utils.py``, ``train_step``) conditions an SD
2.1-base UNet with 4-view joint attention on a text prompt and on one
image. Each group of 4 rendered views becomes 5 in the UNet's batch: a
fifth, identity view is appended (a zero latent and a zero camera,
:162-165 and :186-189, the group's timestep repeated into it, :184-185),
the UNet writes the image's latent ``ip_img`` into that slot, and the
CLIP image tokens ``ip`` reach every cross-attention through the UNet's
Resampler. Classifier-free guidance runs on [uncond, cond] halves: the
negative text states with zero image tokens and a zero ``ip_img``, then
the positive ones with the image's. The identity view is stripped from
the prediction (:202-204); CFG 5, no ``w(t)``, and the SDS gradient
``eps_hat - noise``, NaN-zeroed, enters as ``0.5 ||latents - sg(latents -
grad)||^2`` over the batch, as in ``guidance.SDS``.

Departures from ``imagedream_utils.py``:

- float32 throughout with TF32 off (the caller's), where the published
  code runs its networks in reduced precision;
- the render is resized to the UNet's input side bilinearly with
  antialiasing (``guidance.resize``, the port's and the JAX package's
  resize), where the published code calls ``F.interpolate`` without it;
- the noise comes in from the benchmark's draws, not ``randn_like``;
- the timesteps enter the UNet as floats of the same values, as the
  port's and the JAX package's guidance hand them;
- the image states are the run's seeded draws (``inputs``): the CLIP
  ViT-H/14 tower and the image's VAE encode are not run.

The UNet is ``reference/unet.py``'s with ImageDream's Resampler (``nets``):
the IP-Adapter-Plus perceiver that ImageDream's ``MultiViewUNetModel``
builds, ``Resampler(dim=context_dim, depth=4, dim_head=64, heads=12,
num_queries=ip_dim, embedding_dim=1280, output_dim=context_dim)``, whose
attention is 12 x 64 = 768 wide at width 1024. ``reference/unet.py``'s
Resampler ties that width to the Resampler's own, so ``nets`` gives each
layer's ``to_q``, ``to_kv`` and ``to_out`` the width of
``ip_resampler_heads`` heads of ``ip_resampler_dim_head``.

Imports nothing of the port.
"""

from __future__ import annotations

import torch
from torch import nn

from . import guidance
from . import unet as ref_unet
from . import vae as ref_vae

VIEWS = 4           # rendered views in a group; the UNet sees VIEWS + 1
SCALE = 5.0         # imagedream_utils.py's guidance_scale


def nets(arch: dict, device="meta"):
    """The reference UNet, with ImageDream's Resampler, and VAE of a
    configuration's ``unet`` and ``vae`` widths, on ``device`` (float32)."""
    cfg = dict(arch["unet"])
    dim_head = cfg.pop("ip_resampler_dim_head")
    dim, heads = cfg["ip_resampler_dim"], cfg["ip_resampler_heads"]
    with torch.device(device):
        unet = ref_unet.UNet(ref_unet.UNetConfig(**cfg))
        for i in range(cfg["ip_resampler_depth"]):
            attn = getattr(unet.image_embed, f"layers_{i}_attn")
            attn.to_q = nn.Linear(dim, heads * dim_head, bias=False)
            attn.to_kv = nn.Linear(dim, 2 * heads * dim_head, bias=False)
            attn.to_out = nn.Linear(heads * dim_head, dim, bias=False)
        return unet, ref_vae.AutoencoderKL(ref_vae.VAEConfig(**arch["vae"]))


def pad_views(x):
    """[G*4, ...] -> [G*5, ...]: each group of 4 gains a fifth entry of
    zeros."""
    g = x.reshape((-1, VIEWS) + tuple(x.shape[1:]))
    return torch.cat([g, torch.zeros_like(g[:, :1])], 1).reshape((-1,) + tuple(x.shape[1:]))


def strip_views(x):
    """[G*5, ...] -> [G*4, ...]: the identity view of each group dropped."""
    g = x.reshape((-1, VIEWS + 1) + tuple(x.shape[1:]))
    return g[:, :VIEWS].reshape((-1,) + tuple(x.shape[1:]))


class SDS:
    """``loss(images [B,H,W,3] in [0,1], cond, step_ratio, noise)`` of
    ImageDream over B = 4 G views, their poses in ``cond["poses"]``.
    ``inputs`` holds the seeded states: ``text_pos``, ``text_neg`` [77,
    D], ``clip_tokens`` [L, D_ip] and ``ip_img`` [h, w, 4]."""

    def __init__(self, unet, vae, inputs: dict, image_size: int):
        self.unet, self.vae, self.inputs = unet, vae, inputs
        self.image_size = image_size
        self.alphas = guidance.alphas_cumprod(next(unet.parameters()).device)

    def latents(self, images):
        return self.vae.encode(guidance.resize(images, self.image_size) * 2.0 - 1.0)

    def loss(self, images, cond: dict, step_ratio: float, noise):
        b = images.shape[0]
        latents = self.latents(images)
        t = guidance.anneal_t(step_ratio)
        with torch.no_grad():
            a = self.alphas[t]
            noisy = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
            eps_uncond, eps_cond = self.eps(noisy, t, cond["poses"]).chunk(2)
            grad = torch.nan_to_num(eps_uncond + SCALE * (eps_cond - eps_uncond) - noise)
        target = (latents - grad).detach()
        return 0.5 * torch.sum((latents - target) ** 2) / b

    def eps(self, noisy, t: int, poses):
        """The UNet's noise prediction on the [uncond, cond] halves, each
        stripped back to the rendered views: [2 B, h, w, 4]."""
        inp = self.inputs
        groups = noisy.shape[0] // VIEWS
        n = groups * (VIEWS + 1)
        x = pad_views(noisy)
        cam = pad_views(guidance.mvdream_camera(poses))
        tt = torch.full((n,), float(t), device=noisy.device)
        text = lambda k: inp[k][None].expand((n,) + tuple(inp[k].shape))  # noqa: E731
        tokens = inp["clip_tokens"][None].expand((n,) + tuple(inp["clip_tokens"].shape))
        image = inp["ip_img"][None].expand((groups,) + tuple(inp["ip_img"].shape))
        out = self.unet(torch.cat([x, x]), torch.cat([tt, tt]),
                        torch.cat([text("text_neg"), text("text_pos")]),
                        camera=torch.cat([cam, cam]),
                        ip=torch.cat([torch.zeros_like(tokens), tokens]),
                        ip_img=torch.cat([torch.zeros_like(image), image]))
        return strip_views(out)
