"""LPIPS perceptual distance on a VGG16 trunk (PyTorch).

Port of ``dreamgaussian_tpu/utils/lpips.py``. The VGG16 trunk loads from a
torchvision ``vgg16.features`` state dict (``features.N.weight`` keys, the
file ``vgg16-397923af.pth``), the linear calibration from the lpips
project's ``vgg.pth`` (``lin{k}.model.1.weight``). Without the lin file
each tapped layer weighs its channels by 1/C (the JAX class's documented
deviation, still a relative metric).

The forward of ``lpips.LPIPS(net='vgg')``: inputs mapped to [-1, 1] and
through the lpips scaling layer, the relu outputs of the 2nd, 4th, 7th,
10th and 13th convolutions tapped, channels unit-normalised, the weighted
squared difference summed over channels and averaged over space, then
summed over the five taps. The convolutions are ``F.conv2d`` in float32
(TF32 off on the card: the metric is compared with the CPU's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import resolve_device

_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_POOL_BEFORE = {5, 10, 17, 24}                   # a 2x2 max pool precedes these convs
_TAP_AFTER = {2: 0, 7: 1, 14: 2, 21: 3, 28: 4}  # conv index -> lpips tap
CHANNELS = [64, 128, 256, 512, 512]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def load_vgg16_features(path: str, device="cpu") -> list:
    """torchvision state dict -> [(weight [O, I, 3, 3], bias [O])] per conv."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return [(sd[f"features.{i}.weight"].float().to(device), sd[f"features.{i}.bias"].float().to(device))
            for i in _CONV_IDX]


def load_lpips_lins(path: str, device="cpu") -> list:
    """lpips vgg.pth -> [w [C]] per tap (the 1x1 convolutions squeezed)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return [sd[f"lin{k}.model.1.weight"][0, :, 0, 0].float().to(device) for k in range(5)]


def _taps(params: list, x: torch.Tensor) -> list:
    """x [B, 3, H, W] scaled -> the five tapped feature maps."""
    taps = [None] * 5
    for (w, b), i in zip(params, _CONV_IDX):
        if i in _POOL_BEFORE:
            x = F.max_pool2d(x, 2)
        x = F.relu(F.conv2d(x, w, b, padding=1))
        if i in _TAP_AFTER:
            taps[_TAP_AFTER[i]] = x
    return taps


def _unit_norm(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(1, keepdim=True) + eps)


class LPIPS:
    """lpips(img0, img1): [B, H, W, 3] in [0, 1] -> [B] distances."""

    def __init__(self, vgg_ckpt: str, lpips_ckpt: str | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.params = load_vgg16_features(vgg_ckpt, self.device)
        self.lins = (load_lpips_lins(lpips_ckpt, self.device) if lpips_ckpt else
                     [torch.full((c,), 1.0 / c, device=self.device) for c in CHANNELS])
        self.shift = torch.tensor(_SHIFT, device=self.device).view(1, 3, 1, 1)
        self.scale = torch.tensor(_SCALE, device=self.device).view(1, 3, 1, 1)

    @torch.no_grad()
    def __call__(self, img0, img1) -> torch.Tensor:
        def scaled(img):
            x = torch.as_tensor(img, dtype=torch.float32, device=self.device).permute(0, 3, 1, 2)
            return (x * 2.0 - 1.0 - self.shift) / self.scale

        total = torch.zeros((), device=self.device)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            pairs = zip(_taps(self.params, scaled(img0)), _taps(self.params, scaled(img1)))
            for (a, b), w in zip(pairs, self.lins):
                d = (_unit_norm(a) - _unit_norm(b)) ** 2
                total = total + (d * w.view(1, -1, 1, 1)).sum(1).mean(dim=(1, 2))
        return total
