"""U2Net salient-object matting, loading the official weights.

Port of ``dreamgaussian_tpu/preprocess/u2net.py``: the published U^2-Net
(Qin et al. 2020, nested U-structure of residual U-blocks) with module
names that load the official ``u2net.pth`` (``FULL_CFG``) or ``u2netp.pth``
(``SMALL_CFG``) state dicts strictly; the variant is read from the file.
It runs on the port's device in float32 (TF32 off on the card).

The matting protocol is rembg's: resize to 320^2 (``cv2.INTER_AREA``, the
port's ``utils/resize.py``), divide by the image's maximum, ImageNet
normalisation, the side output ``d0``, min-max to [0, 1], and back to the
input's size (``cv2.INTER_LINEAR``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..utils.resize import resize_area, resize_linear


class REBNCONV(nn.Module):
    def __init__(self, in_ch, out_ch, dirate=1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch)
        self.relu_s1 = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.relu_s1(self.bn_s1(self.conv_s1(x)))


def _up_to(x, ref):
    return F.interpolate(x, size=ref.shape[2:], mode="bilinear", align_corners=False)


class RSU(nn.Module):
    """Residual U-block of a given height (RSU7: height 7)."""

    def __init__(self, height, in_ch, mid_ch, out_ch):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", REBNCONV(mid_ch, mid_ch))
        setattr(self, f"rebnconv{height}", REBNCONV(mid_ch, mid_ch, dirate=2))
        for i in range(height - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", REBNCONV(mid_ch * 2, mid_ch))
        self.rebnconv1d = REBNCONV(mid_ch * 2, out_ch)
        self.pool = nn.MaxPool2d(2, stride=2, ceil_mode=True)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        encs = [self.rebnconv1(hxin)]
        h = encs[0]
        for i in range(2, self.height):
            h = getattr(self, f"rebnconv{i}")(self.pool(h))
            encs.append(h)
        top = getattr(self, f"rebnconv{self.height}")(h)
        d = getattr(self, f"rebnconv{self.height - 1}d")(torch.cat((top, encs[-1]), 1))
        for i in range(self.height - 2, 0, -1):
            d = getattr(self, f"rebnconv{i}d")(torch.cat((_up_to(d, encs[i - 1]), encs[i - 1]), 1))
        return d + hxin


class RSU4F(nn.Module):
    """The dilated variant (no pooling)."""

    def __init__(self, in_ch, mid_ch, out_ch):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, dirate=1)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, dirate=2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, dirate=4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, dirate=8)
        self.rebnconv3d = REBNCONV(mid_ch * 2, mid_ch, dirate=4)
        self.rebnconv2d = REBNCONV(mid_ch * 2, mid_ch, dirate=2)
        self.rebnconv1d = REBNCONV(mid_ch * 2, out_ch, dirate=1)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        d3 = self.rebnconv3d(torch.cat((h4, h3), 1))
        d2 = self.rebnconv2d(torch.cat((d3, h2), 1))
        return self.rebnconv1d(torch.cat((d2, h1), 1)) + hxin


class U2NET(nn.Module):
    """The full (u2net.pth) or small (u2netp.pth) variant, by its channels."""

    def __init__(self, cfg):
        super().__init__()
        (s1, s2, s3, s4, s5, s6), (m5, m4, m3, m2, m1) = cfg
        self.stage1 = RSU(7, *s1)
        self.stage2 = RSU(6, *s2)
        self.stage3 = RSU(5, *s3)
        self.stage4 = RSU(4, *s4)
        self.stage5 = RSU4F(*s5)
        self.stage6 = RSU4F(*s6)
        o1, o2, o3, o4, o5, o6 = (s[2] for s in (s1, s2, s3, s4, s5, s6))
        self.stage5d = RSU4F(o6 + o5, m5, o4)
        self.stage4d = RSU(4, o4 + o4, m4, o3)
        self.stage3d = RSU(5, o3 + o3, m3, o2)
        self.stage2d = RSU(6, o2 + o2, m2, o1)
        self.stage1d = RSU(7, o1 + o1, m1, o1)
        self.side1 = nn.Conv2d(o1, 1, 3, padding=1)
        self.side2 = nn.Conv2d(o1, 1, 3, padding=1)
        self.side3 = nn.Conv2d(o2, 1, 3, padding=1)
        self.side4 = nn.Conv2d(o3, 1, 3, padding=1)
        self.side5 = nn.Conv2d(o4, 1, 3, padding=1)
        self.side6 = nn.Conv2d(o6, 1, 3, padding=1)
        self.outconv = nn.Conv2d(6, 1, 1)
        self.pool = nn.MaxPool2d(2, stride=2, ceil_mode=True)

    def forward(self, x):
        h1 = self.stage1(x)
        h2 = self.stage2(self.pool(h1))
        h3 = self.stage3(self.pool(h2))
        h4 = self.stage4(self.pool(h3))
        h5 = self.stage5(self.pool(h4))
        h6 = self.stage6(self.pool(h5))
        d5 = self.stage5d(torch.cat((_up_to(h6, h5), h5), 1))
        d4 = self.stage4d(torch.cat((_up_to(d5, h4), h4), 1))
        d3 = self.stage3d(torch.cat((_up_to(d4, h3), h3), 1))
        d2 = self.stage2d(torch.cat((_up_to(d3, h2), h2), 1))
        d1 = self.stage1d(torch.cat((_up_to(d2, h1), h1), 1))
        s1 = self.side1(d1)
        sides = [s1] + [_up_to(side(d), s1) for side, d in
                        ((self.side2, d2), (self.side3, d3), (self.side4, d4), (self.side5, d5),
                         (self.side6, h6))]
        return torch.sigmoid(self.outconv(torch.cat(sides, 1)))


# ((in_ch, mid_ch, out_ch) per encoder stage, decoder mids 5d..1d): the
# official U2NET / U2NETP constructors.
FULL_CFG = (
    ((3, 32, 64), (64, 32, 128), (128, 64, 256), (256, 128, 512), (512, 256, 512), (512, 256, 512)),
    (256, 128, 64, 32, 16),
)
SMALL_CFG = (
    ((3, 16, 64), (64, 16, 64), (64, 16, 64), (64, 16, 64), (64, 16, 64), (64, 16, 64)),
    (16, 16, 16, 16, 16),
)


def load_u2net(ckpt_path: str, device="cuda") -> U2NET:
    """The variant of the official state dict at ``ckpt_path``, loaded
    strictly, in eval mode on ``device``."""
    device = resolve_device(device)
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    full = sd["stage2.rebnconvin.conv_s1.weight"].shape[0] == 128   # the full variant's width
    model = U2NET(FULL_CFG if full else SMALL_CFG)
    model.load_state_dict(sd)
    return model.eval().requires_grad_(False).to(device)


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def u2net_alpha(rgb: np.ndarray, ckpt_path: str, size: int = 320, device="cuda") -> np.ndarray:
    """RGB [H, W, 3] (uint8, uint16 or float32, normalised by its max) ->
    alpha float32 [H, W] in [0, 1] (rembg's protocol)."""
    device = resolve_device(device)
    model = load_u2net(ckpt_path, device)
    h, w = rgb.shape[:2]
    im = resize_area(rgb, size, size).astype(np.float32)
    im = im / max(1e-6, float(im.max()))
    im = (im - IMAGENET_MEAN) / IMAGENET_STD
    x = torch.from_numpy(np.ascontiguousarray(im.transpose(2, 0, 1)[None])).to(device)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        pred = model(x)[0, 0].cpu().numpy()
    mn, mx = float(pred.min()), float(pred.max())
    pred = (pred - mn) / max(1e-8, mx - mn)
    return resize_linear(pred, h, w)
