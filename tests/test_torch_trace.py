"""The port's spans and counters (``utils/trace.py``) on the CPU: nothing
recorded while off, the step's spans nested under ``stage1.step`` and
``stage2.step`` with their step numbers, one ``host_read`` per render, the
UNet calls of the DDIM schedule, ImageDream's identity-view spans, and a
span's times on the clock of the profiler's trace."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dreamgaussian_tpu_torch.guidance.sds import (ImageDreamGuidance, Zero123Guidance,
                                                  refine_init_step)
from dreamgaussian_tpu_torch.guidance.unet import TinyUNet, UNet, UNetConfig
from dreamgaussian_tpu_torch.guidance.vae import AutoencoderKL, VAEConfig
from dreamgaussian_tpu_torch.meshing.mesh import Mesh
from dreamgaussian_tpu_torch.train import Stage1Trainer, Stage2Trainer
from dreamgaussian_tpu_torch.utils import trace
from torch_cpu_cases import one_torch_thread  # noqa: F401

SIZE = 32           # guidance image side; the tiny VAE's latents are 4x4
REFINE_STEPS = 10


@pytest.fixture(autouse=True)
def tracing_left_off():
    """Every test starts and ends with tracing off and no records."""
    trace.disable()
    trace.records()
    yield
    trace.disable()
    trace.records()


def guidance():
    """Zero123 guidance on a one-level UNet and a four-level VAE, both the
    port's own classes (their spans are the ones under test)."""
    torch.manual_seed(0)
    unet = UNet(UNetConfig(in_channels=8, block_out_channels=(8,), layers_per_block=1,
                           cross_attention_dim=16, num_attention_heads=2,
                           down_block_types=("CrossAttnDownBlock2D",),
                           up_block_types=("CrossAttnUpBlock2D",))).eval()
    vae = AutoencoderKL(VAEConfig(block_out_channels=(4, 4, 4, 8), layers_per_block=1)).eval()
    side = vae.latent_side(SIZE)
    return Zero123Guidance(unet.requires_grad_(False), vae.requires_grad_(False),
                           clip_emb=torch.randn(1, 24) * 0.1,
                           vae_latent=torch.randn(1, side, side, 4) * 0.1,
                           cam_proj=(torch.randn(28, 16) * 0.05, torch.zeros(16)),
                           image_size=SIZE)


def disc(size):
    yy, xx = np.mgrid[0:size, 0:size]
    inside = ((xx - (size - 1) / 2) ** 2 + (yy - (size - 1) / 2) ** 2) < (size * 0.3) ** 2
    rgb = np.ones((size, size, 3), np.float32)
    rgb[inside] = [0.9, 0.2, 0.1]
    return rgb, inside.astype(np.float32)


def stage1_trainer():
    """One known view and one novel view a step; densify on step 2, the
    opacity reset on step 3."""
    opt = dict(iters=10, ref_size=SIZE, num_pts=128, sh_degree=0, batch_size=1,
               novel_resolutions=[SIZE, SIZE, SIZE], density_start_iter=1,
               density_end_iter=10, densification_interval=2, opacity_reset_interval=3)
    rgb, mask = disc(SIZE)
    return Stage1Trainer(opt, ref_rgb=rgb, ref_mask=mask,
                         guidance_fns=((1.0, guidance().guidance_fn()),), capacity=256, seed=0,
                         device="cpu")


def sphere(n_lat=8, n_lon=12, tex=32):
    """A latitude-longitude sphere of radius 0.5 with its UVs."""
    la, lo = np.meshgrid(np.linspace(0, np.pi, n_lat + 1), np.linspace(0, 2 * np.pi, n_lon + 1),
                         indexing="ij")
    v = (np.stack([np.sin(la) * np.sin(lo), np.cos(la), np.sin(la) * np.cos(lo)], -1) * 0.5)
    vt = np.stack([lo / (2 * np.pi), 1.0 - la / np.pi], -1).reshape(-1, 2)
    idx = np.arange((n_lat + 1) * (n_lon + 1)).reshape(n_lat + 1, n_lon + 1)
    a, b, c, d = (idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(), idx[1:, :-1].ravel(),
                  idx[1:, 1:].ravel())
    f = np.concatenate([np.stack([a, c, d], 1), np.stack([a, d, b], 1)])
    v = v.reshape(-1, 3)
    area = np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]), axis=1)
    f = f[area > 1e-9].astype(np.int32)
    mesh = Mesh(v=v.astype(np.float32), f=f, vt=vt.astype(np.float32), ft=f,
                albedo=np.full((tex, tex, 3), 0.5, np.float32))
    mesh.auto_normal()
    return mesh


def chrome_trace(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)


def test_off_records_nothing_and_opens_no_profiler_range(tmp_path):
    assert trace.span("a") is trace.span("b")
    tr = stage1_trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_step()
    trace.count("host_read")
    names = {e.get("name") for e in chrome_trace(prof, tmp_path)["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert not names & {"stage1.step", "stage1.render", "unet", "host_read", "vae.encode"}
    assert trace.records() == {"spans": [], "counters": {}}


def test_stage1_spans_nest_under_the_step_with_its_number():
    tr = stage1_trainer()
    trace.enable()
    for _ in range(3):
        tr.train_step()
    rec = trace.records()
    spans = rec["spans"]
    names = {s["name"] for s in spans}
    assert names == {"stage1.step", "stage1.cameras", "stage1.render", "stage1.guidance",
                     "stage1.backward", "stage1.update", "stage1.densify",
                     "stage1.opacity_reset", "unet", "vae.encode", "host_read"}

    def ancestors(s):
        while s["parent"] is not None:
            s = spans[s["parent"]]
            yield s

    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["name"] == "stage1.step":
            assert s["parent"] is None
            continue
        top = list(ancestors(s))[-1]
        assert top["name"] == "stage1.step" and s["step"] == top["step"]
        outer = spans[s["parent"]]
        assert outer["start_ns"] <= s["start_ns"] and s["end_ns"] <= outer["end_ns"]
    parent = {s["name"]: spans[s["parent"]]["name"] for s in spans if s["parent"] is not None}
    assert parent["host_read"] == "stage1.render"
    assert parent["unet"] == parent["vae.encode"] == "stage1.guidance"
    assert parent["stage1.densify"] == parent["stage1.backward"] == "stage1.step"
    steps = [s["step"] for s in spans if s["name"] == "stage1.step"]
    assert steps == [1, 2, 3]
    by_step = lambda name: [s["step"] for s in spans if s["name"] == name]  # noqa: E731
    assert by_step("stage1.densify") == [2] and by_step("stage1.opacity_reset") == [3]
    # One host read per render: the known view and one novel view a step.
    assert by_step("host_read") == [1, 1, 2, 2, 3, 3]
    assert rec["counters"] == {"host_read": 6, "unet.calls": 3, "densify": 1}
    # No card: a device span carries no stream time.
    assert all("device_ms" not in s for s in spans)
    assert trace.records() == {"spans": [], "counters": {}}


def test_stage2_counts_the_ddim_schedules_unet_calls():
    g = guidance()
    opt = dict(iters_refine=5, ref_size=SIZE, novel_resolution=64, batch_size=1)
    rgb, _ = disc(SIZE)
    tr = Stage2Trainer(opt, sphere(), ref_rgb=rgb, refine_fns=((1.0, g.refine_fn(REFINE_STEPS)),),
                       refine_image_size=SIZE, seed=0, device="cpu")
    trace.enable()
    for step in range(1, 4):
        tr.train_step()
        rec = trace.records()
        strength = np.float32(step / opt["iters_refine"] * 0.15 + 0.8)
        calls = REFINE_STEPS - refine_init_step(REFINE_STEPS, strength)
        # Target, known and novel renders each read the pair total once.
        assert rec["counters"] == {"unet.calls": calls, "host_read": 3}
        spans = rec["spans"]
        count = {}
        for s in spans:
            count[s["name"]] = count.get(s["name"], 0) + 1
            assert s["step"] == step
        assert count == {"stage2.step": 1, "stage2.cameras": 1, "stage2.target": 1,
                         "stage2.grad": 1, "stage2.backward": 1, "stage2.update": 1,
                         "unet": calls, "vae.encode": 1, "vae.decode": 1, "host_read": 3}
        parent = lambda s: spans[s["parent"]]["name"]  # noqa: E731
        for s in spans:
            if s["name"] in ("unet", "vae.encode", "vae.decode"):
                assert parent(s) == "stage2.target"
            if s["name"] in ("stage2.backward", "stage2.update"):
                assert parent(s) == "stage2.grad"


def imagedream_guidance():
    """ImageDream guidance on a one-level 4+1-view UNet with a one-layer
    Resampler (2 image tokens, 2 heads of width 6), the port's own classes."""
    torch.manual_seed(0)
    unet = UNet(UNetConfig(in_channels=4, block_out_channels=(8,), layers_per_block=1,
                           cross_attention_dim=16, num_attention_heads=2,
                           use_linear_projection=True, num_views=5, ip_dim=2, ip_embed_dim=8,
                           ip_resampler_dim=8, ip_resampler_depth=1, ip_resampler_heads=2,
                           ip_resampler_dim_head=6, down_block_types=("CrossAttnDownBlock2D",),
                           up_block_types=("CrossAttnUpBlock2D",))).eval()
    unet.image_embed.latents.data.normal_()
    vae = AutoencoderKL(VAEConfig(block_out_channels=(4, 4, 4, 8), layers_per_block=1)).eval()
    side = vae.latent_side(SIZE)
    return ImageDreamGuidance(unet.requires_grad_(False), vae.requires_grad_(False),
                              {"pos": torch.randn(3, 16), "neg": torch.zeros(3, 16)},
                              {"pos": torch.randn(5, 8), "ip_img": torch.randn(side, side, 4)},
                              image_size=SIZE)


def imagedream_sds_call(g, groups=2):
    """One SDS call on ``groups`` groups of 4 views."""
    poses = torch.eye(4).repeat(4 * groups, 1, 1)
    poses[:, :3, 3] = torch.tensor([0.0, 0.0, 2.5])
    images = torch.rand(4 * groups, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(1))
    noise = lambda name, shape, dist: torch.zeros(shape)  # noqa: E731
    return g.guidance_fn()(images, {"poses": poses}, 0.5, noise)


def test_imagedream_spans_off_record_nothing():
    imagedream_sds_call(imagedream_guidance())
    assert trace.records() == {"spans": [], "counters": {}}


def test_imagedream_views_spans_around_the_unet_call():
    g = imagedream_guidance()
    trace.enable()
    imagedream_sds_call(g, groups=2)
    rec = trace.records()
    spans = rec["spans"]
    # Two groups, one CFG call on 2 x 2 x 5 views.
    assert rec["counters"] == {"unet.calls": 1}
    assert [s["name"] for s in spans] == ["vae.encode", "imagedream.views", "unet",
                                          "imagedream.views"]
    pad, unet, strip = spans[1:]
    # The padding closes before the UNet call opens, the strip opens after
    # it closes.
    assert pad["end_ns"] <= unet["start_ns"] and unet["end_ns"] <= strip["start_ns"]
    assert pad["parent"] is strip["parent"] is unet["parent"] is None
    # The refine's DDIM loop pads and strips around each of its calls.
    rgb = torch.rand(4, SIZE, SIZE, 3)
    poses = torch.eye(4).repeat(4, 1, 1)
    poses[:, :3, 3] = torch.tensor([0.0, 0.0, 2.5])
    draw = lambda name, shape, dist: torch.zeros(shape)  # noqa: E731
    g.refine_fn(REFINE_STEPS)(rgb, {"poses": poses}, 0.8, draw)
    rec = trace.records()
    calls = REFINE_STEPS - refine_init_step(REFINE_STEPS, 0.8)
    assert rec["counters"] == {"unet.calls": calls}
    names = [s["name"] for s in rec["spans"]]
    assert names.count("imagedream.views") == 2 * calls


def test_tiny_unet_calls_are_spans_too():
    unet = TinyUNet(in_channels=4, channels=16, context_dim=32)
    trace.enable()
    unet(torch.zeros(1, 8, 8, 4), torch.zeros(1), torch.zeros(1, 2, 32))
    rec = trace.records()
    assert [s["name"] for s in rec["spans"]] == ["unet"]
    assert rec["counters"] == {"unet.calls": 1}


def test_span_sits_in_the_profilers_trace_on_its_clock(tmp_path):
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in ("warm", "probe"):
            with trace.span(name):
                torch.ones(64).sum()
                time.sleep(0.002)
    rec = {s["name"]: s for s in trace.records()["spans"]}
    data = chrome_trace(prof, tmp_path)
    base_us = data.get("baseTimeNanoseconds", 0) / 1e3
    got = [e for e in data["traceEvents"]
           if e.get("cat") == "user_annotation" and e.get("name") == "probe"]
    assert len(got) == 1
    start_us, end_us = got[0]["ts"] + base_us, got[0]["ts"] + got[0]["dur"] + base_us
    assert abs(rec["probe"]["start_ns"] / 1e3 - start_us) < 100
    assert abs(rec["probe"]["end_ns"] / 1e3 - end_us) < 100
