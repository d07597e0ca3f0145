"""The FLOP and roofline arithmetic against hand counts: a one-level UNet
counted layer by layer, and compositing pairs on one 32^2 tile."""

import pytest
import torch

from portbench import work
from portbench.reference import render

B, SIDE, C, HEADS, CTX, CIN = 2, 8, 32, 2, 16, 4
TINY = {"image_size": SIDE * 8, "context_tokens": 1, "unet": {
    "in_channels": CIN, "out_channels": 4, "block_out_channels": [C], "layers_per_block": 1,
    "cross_attention_dim": CTX, "num_attention_heads": HEADS,
    "down_block_types": ["CrossAttnDownBlock2D"], "up_block_types": ["CrossAttnUpBlock2D"]},
    "vae": {}}


def conv(k, cin, cout, hw):
    return 2 * k * k * cin * cout * hw * B


def linear(cin, cout, tokens):
    return 2 * cin * cout * tokens * B


def resnet(cin, cout, hw, temb):
    return (conv(3, cin, cout, hw) + linear(temb, cout, 1) + conv(3, cout, cout, hw)
            + (conv(1, cin, cout, hw) if cin != cout else 0))


def transformer(ch, hw, m):
    attn1 = 4 * linear(ch, ch, hw) + 2 * 2 * hw * hw * ch * B
    attn2 = 2 * linear(ch, ch, hw) + 2 * linear(CTX, ch, m) + 2 * 2 * hw * m * ch * B
    ff = linear(ch, 8 * ch, hw) + linear(4 * ch, ch, hw)
    return 2 * conv(1, ch, ch, hw) + attn1 + attn2 + ff


def test_unet_flops_match_a_hand_count():
    hw, temb = SIDE * SIDE, 4 * C
    hand = (linear(C, temb, 1) + linear(temb, temb, 1) + conv(3, CIN, C, hw)
            + resnet(C, C, hw, temb) + transformer(C, hw, 1)
            + resnet(C, C, hw, temb) + transformer(C, hw, 1) + resnet(C, C, hw, temb)
            + 2 * (resnet(2 * C, C, hw, temb) + transformer(C, hw, 1))
            + conv(3, C, 4, hw))
    assert work.unet_flops(TINY, B, camera=False) == hand


def flat_gaussians(opacities):
    """Gaussians far wider than a 32^2 tile (alpha = opacity on every
    pixel), one behind the other."""
    n = len(opacities)
    return render.Projected(
        mean2d=torch.full((n, 2), 15.5), depth=torch.arange(1.0, n + 1),
        conic=torch.tensor([[1e-9, 0.0, 1e-9]] * n), color=torch.full((n, 3), 0.5),
        opacity=torch.tensor(opacities), radius=torch.full((n,), 100, dtype=torch.int32))


@pytest.mark.parametrize("opacities, contrib, stops, slots", [
    ([0.5, 0.5], 2 * 1024, 0, 2),
    # alpha 0.98: T 0.02, 4e-4, then 8e-6 < 1e-4: the third stops every pixel.
    ([0.98, 0.98, 0.98], 2 * 1024, 1024, 2),
])
def test_pair_counts_and_bounds_match_a_hand_count(opacities, contrib, stops, slots):
    c = render.counts_of(flat_gaussians(opacities), 32)
    assert c == {"contributing_pairs": contrib, "stopping_pixels": stops,
                 "feature_slots": slots, "pixels": 1024}
    k1_ops = contrib * 26 + stops * 12
    k1_bytes = slots * 40 + 1024 * 24
    assert work.k1_bound_s(c) == max(k1_ops / 67e12, k1_bytes / 3.35e12)
    assert work.k2_bound_s(c) == max(contrib * 52 / 67e12, (2 * slots * 40 + 1024 * 44) / 3.35e12)
