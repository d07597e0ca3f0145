"""Tiny configurations of the benchmark's cells for the CPU tests: the same
keys and code paths as ``portbench/configs`` and ``portbench/traffic``, at
widths and sizes a CPU run holds."""

from __future__ import annotations

import copy

from portbench import harness

UNET = {"block_out_channels": [32, 64], "layers_per_block": 1, "cross_attention_dim": 32,
        "num_attention_heads": 2, "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
        "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"]}
VAE = {"block_out_channels": [16, 16, 32, 32], "layers_per_block": 1}


def config(name: str) -> dict:
    """The configuration ``name`` cut to a CPU's size: a 2-level UNet, a
    small VAE, 64^2 guidance, 256 gaussians, 64^2 renders, 5-step refine
    jobs on a 384-face mesh."""
    cfg = copy.deepcopy(harness.config(name))
    cfg["arch"]["image_size"] = 64
    cfg["arch"]["unet"].update(UNET)
    if cfg["arch"]["kind"] == "mvdream":
        cfg["arch"]["unet"].update(num_attention_heads=None, attention_head_dim=16)
    cfg["arch"]["vae"].update(VAE)
    cfg["trainer"].update(capacity=256, ref_size=64, novel_resolutions=[64, 64, 64],
                          novel_resolution=64, iters_refine=5)
    if "mesh" in cfg:
        cfg["mesh"] = {"lat": 12, "lon": 16, "texture": 64}
    return cfg


def traffic(name: str) -> dict:
    t = copy.deepcopy(harness.traffic(name))
    t.update(warmup_steps=1, trace_steps=2)
    if t["kind"] == "refine":
        t.update(min_jobs=1, trace_from=2)
    return t
