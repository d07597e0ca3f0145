"""The lower-precision control of the reference networks.

The configurations state bfloat16 for the guidance networks; the next
precision down, the step that would tempt a later change, is fp8.
``fp8_control`` turns a float32 reference network into that control in
place: every linear and convolution weight is rounded once to float8
e4m3 with a per-tensor scale (its largest magnitude onto e4m3's 448), and
every input of a linear layer or convolution is rounded the same way as
it enters, so each product of the network sees fp8 operands and keeps a
float32 accumulation, as an fp8 GEMM does. Normalisations, softmax and
the attention products stay in float32.
"""

from __future__ import annotations

import torch
from torch import nn

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale, back in its
    dtype; the gradient passes straight through the rounding."""
    with torch.no_grad():
        scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
        rounded = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (rounded - x).detach()


def _round_input(module, args):
    return (fp8_round(args[0]),) + tuple(args[1:])


@torch.no_grad()
def fp8_control(net: nn.Module) -> nn.Module:
    for mod in net.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            mod.weight.copy_(fp8_round(mod.weight))
            mod.register_forward_pre_hook(_round_input)
    return net
