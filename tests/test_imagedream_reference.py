"""ImageDream's plain reference of the benchmark (``portbench/reference/``)
against the port, on the CPU at seeded tiny widths: a 2-level UNet of
64/128 channels and the Resampler cut to width 64, its attention 32 wide
as ImageDream's is narrower than its width (GroupNorm over single
channels, at 32 channels and fewer, would normalise the time embedding
and the uncond half's zero identity view away).

- the port's ``UNet`` against ``reference/unet.py`` on the ipmv path
  (camera, image tokens, identity latent), float32;
- ``ImageDreamGuidance.guidance_fn``'s loss and image gradient against
  ``reference/imagedream.py`` on the same draws;
- the cell's runner (``portbench/stage1_ipmv.py``): its compared steps
  read gaps under the cell's limits, and the port with the image tokens
  dropped from the positive half, with the identity latent not spliced, or
  with CFG 100 in place of 5 reads gaps over them.

The file imports no JAX."""

import numpy as np
import pytest
import torch

from dreamgaussian_tpu_torch.guidance import sds as port_sds
from dreamgaussian_tpu_torch.guidance import unet as port_unet
from portbench import harness, run, stage1_ipmv
from portbench.reference import imagedream as ref_imagedream
from portbench.reference import render
from portbench.reference import unet as ref_unet
from portbench.tests import tiny
from torch_cpu_cases import one_torch_thread  # noqa: F401

BENCH = harness.benchmark()
CELL = harness.cell(BENCH, "imagedream_sd21_ipmv.stage1_512")
LIMITS = harness.limits(CELL["name"])
SEED = 2**33 + 5


def tiny_config() -> dict:
    """The cell's configuration at a CPU's size, the networks in float32:
    ``tiny.config``'s cut with 64/128-channel levels of 16-wide heads, a
    Resampler of width 64 (2 layers, 4 heads of width 8) over 9 tokens of
    width 64."""
    cfg = tiny.config(CELL["config"])
    cfg["precision"]["guidance_networks"] = "float32"
    cfg["arch"]["clip_tokens"] = 9
    cfg["arch"]["unet"].update(block_out_channels=[64, 128], num_attention_heads=None,
                               attention_head_dim=16, ip_embed_dim=64, ip_resampler_dim=64,
                               ip_resampler_depth=2, ip_resampler_heads=4,
                               ip_resampler_dim_head=8)
    return cfg


def nets(arch: dict):
    """The port's and the reference's UNet and VAE on the same seeded
    weights, float32."""
    from dreamgaussian_tpu_torch.guidance.vae import AutoencoderKL, VAEConfig

    weights = stage1_ipmv.guidance_weights(arch, SEED, "cpu")
    port = (port_unet.UNet(port_unet.UNetConfig(**arch["unet"])),
            AutoencoderKL(VAEConfig(**arch["vae"])))
    ref = ref_imagedream.nets(arch, device="cpu")
    for (unet, vae) in (port, ref):
        unet.load_state_dict({k: v.float() for k, v in weights["unet"].items()})
        vae.load_state_dict({k: v.float() for k, v in weights["vae"].items()})
        unet.eval().requires_grad_(False)
        vae.eval().requires_grad_(False)
    return port, ref


def test_port_unet_matches_the_reference_on_the_ipmv_path():
    arch = tiny_config()["arch"]
    (unet, _), (ref, _) = nets(arch)
    assert isinstance(ref, ref_unet.UNet)
    # The Resampler's attention is 4 heads of width 8, narrower than its 64.
    for net in (unet, ref):
        assert tuple(net.image_embed.layers_0_attn.to_kv.weight.shape) == (64, 64)
    gen = torch.Generator().manual_seed(1)
    side, groups = arch["image_size"] // 8, 2
    n = groups * 5
    args = (torch.randn(n, side, side, 4, generator=gen), torch.full((n,), 431.0),
            torch.randn(n, arch["context_tokens"], arch["unet"]["cross_attention_dim"],
                        generator=gen))
    kw = dict(camera=torch.randn(n, 16, generator=gen),
              ip=torch.randn(n, arch["clip_tokens"], arch["unet"]["ip_embed_dim"], generator=gen),
              ip_img=torch.randn(groups, side, side, 4, generator=gen))
    with torch.no_grad():
        got, want = unet(*args, **kw), ref(*args, **kw)
        without_ip = ref(*args, **dict(kw, ip=None))
    # The same float32 operations in the same order: equal to float32
    # rounding over the network's depth (1e-5 of the largest entry).
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    # The IP path is part of what is compared.
    assert float((without_ip - want).abs().max()) > 1e-2 * scale


def test_guidance_fn_matches_the_reference_sds():
    arch = tiny_config()["arch"]
    (unet, vae), (ref_net, ref_vae) = nets(arch)
    st = stage1_ipmv.image_states(arch, SEED, "cpu")
    port = port_sds.ImageDreamGuidance(unet, vae, {"pos": st["text_pos"], "neg": st["text_neg"]},
                                       {"pos": st["clip_tokens"], "ip_img": st["ip_img"]},
                                       image_size=arch["image_size"])
    ref = ref_imagedream.SDS(ref_net, ref_vae, st, arch["image_size"])
    rng = np.random.default_rng(3)
    _, _, poses = render.sample_orbit(rng, {"min_ver": -5, "max_ver": 0, "radius": 2.5}, 2, 4)
    cond = {"poses": torch.from_numpy(poses)}
    gen = torch.Generator().manual_seed(4)
    images = torch.rand(8, 48, 48, 3, generator=gen)
    side = arch["image_size"] // 8
    noise = torch.randn(8, side, side, 4, generator=gen)
    draws = []

    def draw(name, shape, dist):
        draws.append((name, shape, dist))
        return noise

    got_x = images.clone().requires_grad_(True)
    got = port.guidance_fn()(got_x, cond, 0.7, draw)
    got.backward()
    want_x = images.clone().requires_grad_(True)
    want = ref.loss(want_x, cond, 0.7, noise)
    want.backward()
    assert draws == [("sds_noise", tuple(noise.shape), "normal")]
    # float32 on both sides, the noise schedule's arithmetic in another
    # order: the loss to 1e-5 of itself, the image gradient to 1e-4 of its
    # largest entry (the VAE's backward in float32).
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-5 * abs(want)
    g, w = got_x.grad, want_x.grad
    assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def tiny_run(cfg: dict) -> dict:
    return run.run_cell(BENCH, CELL, cfg, tiny.traffic(CELL["traffic"]), SEED, 0.2, False,
                        device="cpu")


def test_the_runners_compared_steps_read_correct():
    line = tiny_run(tiny_config())
    assert line["correct"], line["checks"]
    # Both sides in float32: the gaps are rounding, a tenth of the limits
    # (set for the port's bfloat16 networks on the card) at most.
    for k, c in line["checks"].items():
        assert c["limit"] == LIMITS[k] and c["value"] < LIMITS[k] / 10, (k, c)


def _ip_left_out_of_the_positive_half(forward):
    def mutant(self, sample, timesteps, context, camera=None, ip=None, ip_img=None):
        halves = [x.chunk(2) for x in (sample, timesteps, context, camera, ip, ip_img)]
        first = [h[0] for h in halves]
        second = [h[1] for h in halves]
        second[4] = None
        return torch.cat([forward(self, *first), forward(self, *second)])
    return mutant


def _identity_latent_left_out(forward):
    def mutant(self, sample, timesteps, context, camera=None, ip=None, ip_img=None):
        return forward(self, sample, timesteps, context, camera, ip, None)
    return mutant


@pytest.mark.parametrize("mutant", ["ip_dropped_in_the_positive_half",
                                    "identity_latent_not_spliced", "cfg_100"])
def test_the_ipmv_mathematics_left_out_reads_incorrect(monkeypatch, mutant):
    if mutant == "cfg_100":
        monkeypatch.setattr(port_sds.ImageDreamGuidance, "guidance_scale", 100.0)
    else:
        wrap = (_ip_left_out_of_the_positive_half if mutant.startswith("ip")
                else _identity_latent_left_out)
        monkeypatch.setattr(port_unet.UNet, "forward", wrap(port_unet.UNet.forward))
    line = tiny_run(tiny_config())
    # The cell's own limits: at least one gap over its limit.
    assert not line["correct"], line["checks"]
