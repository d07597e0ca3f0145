"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

1. builds the port's CUDA kernels (one nvcc per source, all at once) and
   prints the toolchain;
2. runs stage-1 image-to-3D with full-width Zero123 guidance (random bf16
   weights) through ``Stage1Trainer`` with ``configs/image.yaml``'s
   options at capacity 16384: steps 1-3 at the 128 rung, step 200 (256,
   densify) and step 300 (512, densify), checking finite losses and that
   every step launched K1 and K2; saves the PLY and loads it back;
3. holds K1 and K2 against their plain PyTorch versions on the card at
   the main path's 512^2 shape, and times kernel and plain version;
4. exports a textured mesh at ``configs/image.yaml``'s sizes (16384
   gaussians that fill a solid shape, field 128^3, remesh 0.015, decimate
   to 100,000 faces, texture 1024^2, 26 bake views at 512^2) through
   ``export_textured_mesh`` with the trainer's ``render_view`` as the
   bake's renderer, once as OBJ and the write alone as GLB; reads both
   back and checks them; prints the seconds of each stage, the peak memory
   and the mesh's sizes; checks that the export launched K3 26 times and K1
   at least 26 times;
5. holds K3 against its plain version on the exported mesh under one of the
   26 bake cameras (ids equal on every pixel, z to 1e-6) and times both;
6. prints the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

Needs a CUDA card; exits non-zero without one, and on any failed check.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# configs/image.yaml's options, as a dict: the card machine has no PyYAML.
IMAGE_OPTIONS = {
    "input": None, "prompt": None, "negative_prompt": None, "mesh": None,
    "elevation": 0, "ref_size": 256, "density_thresh": 1, "outdir": "logs",
    "mesh_format": "obj", "save_path": "???", "mvdream": False,
    "imagedream": False, "stable_zero123": False, "lambda_sd": 0,
    "lambda_zero123": 1, "warmup_rgb_loss": True, "batch_size": 1,
    "iters": 500, "anneal_timestep": True, "iters_refine": 50, "radius": 2,
    "fovy": 49.1, "min_ver": -30, "max_ver": 30, "load": None,
    "train_geo": False, "invert_bg_prob": 0.5, "gui": False, "H": 800,
    "W": 800, "num_pts": 5000, "sh_degree": 0, "position_lr_init": 0.001,
    "position_lr_final": 0.00002, "position_lr_delay_mult": 0.02,
    "position_lr_max_steps": 500, "feature_lr": 0.01, "opacity_lr": 0.05,
    "scaling_lr": 0.005, "rotation_lr": 0.005, "percent_dense": 0.01,
    "density_start_iter": 100, "density_end_iter": 3000,
    "densification_interval": 100, "opacity_reset_interval": 700,
    "densify_grad_threshold": 0.01, "geom_lr": 0.0001, "texture_lr": 0.2,
    "capacity": 16384, "fake_guidance": False, "sd_ckpt": None,
    "zero123_ckpt": None, "texture_size": 1024, "seed": 0,
}

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32
# FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f32 operations per (gaussian, pixel) pair that contributes: K1 evaluates
# the quadratic (10), exp/min/skip tests (4), the stop test (3) and
# accumulates rgb+depth (9); K2 adds the T rebuild, colour dot, d_alpha,
# suffix sum and the 10 gradient terms. A pair that is evaluated and
# skipped (or stops the pixel) costs the quadratic and the two skip tests.
K1_FLOPS_PER_PAIR = 26
K2_FLOPS_PER_PAIR = 52
SKIP_FLOPS_PER_PAIR = 12
# K2 against its plain version, elementwise in each gradient row:
# |kernel - plain| <= K2_RTOL |plain| + K2_ATOL * max |plain row|. The rows
# differ in scale by orders of magnitude (the conic rows carry squared
# offsets), so each is held to its own. The sums run over a tile's pixels
# in another order and T is rebuilt by division step by step against a
# suffix product; the kernel uses under a tenth of this tolerance, and a
# relative error of 1e-3 in the terms of the pairs deep in a pixel's list
# exceeds it (the printed share per row shows the margin).
K2_RTOL = 1e-4
K2_ATOL = 1e-5
# K3's bound counts, for each (triangle, tile) slot, the pixels of the tile
# whose centre lies in the triangle's bounding box: a box test needs no
# arithmetic on the pixel, and inside the box the three edge functions (15
# operations) and the inside test (3: two min or max and a compare) must be
# evaluated to decide coverage. A covering pair adds the three barycentric
# products, the z sum and the depth compare (3 + 5 + 2).
K3_FLOPS_PER_BOX_PAIR = 18
K3_FLOPS_PER_COVER_PAIR = 10
# The view of the 26 bake cameras that K3 is held at: elevation -45, azimuth 45.
K3_BAKE_VIEW = 9
# Least share of the 1024^2 albedo that the 26 views must cover before the
# inpaint. The charts' bounding boxes fill about 0.7 of the texture by the
# packer's design, a chart fills part of its box, and texels that face no
# camera within the viewcos limit stay for the inpaint; the seeded cloud
# gives 0.23.
MIN_COVERED_SHARE = 0.15
EXPORT_SIZES = {"mc_resolution": 128, "decimate_target": 100_000, "remesh_size": 0.015,
                "texture_size": 1024, "bake_resolution": 512}
GRAD_ROWS = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "log_opacity",
             "rgb_r", "rgb_g", "rgb_b", "depth")
# Steps driven on the main path: eight at each rung of the ladder, those
# at 256^2 and 512^2 starting with a densify step (density_start 100,
# interval 100); one more 512^2 step runs under torch.profiler. The step
# time of a rung is the median of its steps that are neither the run's
# first (one-time set-up) nor a densify step.
RUNG_STEPS = {128: range(1, 9), 256: range(200, 208), 512: range(300, 308)}
STEPS = tuple(s for r in RUNG_STEPS.values() for s in r) + (308,)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def disc_rgba(size: int, seed: int):
    """Reference RGBA image from the seed: a shaded disc on a transparent
    background, composited on white -> (rgb [S,S,3], mask [S,S])."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    c = (size - 1) / 2.0
    r = size * rng.uniform(0.25, 0.35)
    d2 = ((xx - c) ** 2 + (yy - c) ** 2) / (r * r)
    mask = (d2 < 1.0).astype(np.float32)
    shade = np.sqrt(np.clip(1.0 - d2, 0.0, 1.0))[..., None]
    base = rng.uniform(0.2, 0.9, size=3).astype(np.float32)
    rgb = base * (0.4 + 0.6 * shade)
    rgb = rgb * mask[..., None] + (1.0 - mask[..., None])
    return rgb.astype(np.float32), mask


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_slice(seed: int) -> dict:
    """Drive Stage1Trainer through the ladder; returns per-rung numbers."""
    import torch

    from dreamgaussian_tpu_torch.guidance.realarch import random_zero123_guidance
    from dreamgaussian_tpu_torch.ops.rasterize_cuda import LAUNCHES
    from dreamgaussian_tpu_torch.scene import load_ply
    from dreamgaussian_tpu_torch.train import Stage1Trainer
    from dreamgaussian_tpu_torch.utils.config import Config

    opt = Config(IMAGE_OPTIONS)
    rgb, mask = disc_rgba(opt["ref_size"], seed)
    t0 = time.perf_counter()
    guidance = random_zero123_guidance(image_size=256, seed=seed, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_weights = guidance.num_parameters()
    trainer = Stage1Trainer(
        opt, ref_rgb=rgb, ref_mask=mask, capacity=opt["capacity"], seed=seed,
        guidance_fns=((opt["lambda_zero123"], guidance.guidance_fn()),),
        device="cuda",
    )
    print(f"[slice] guidance built in {build_s:.1f} s ({n_weights} weights, "
          f"bf16); trainer at capacity {trainer.capacity}")
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for step in STEPS:
        trainer.step = step - 1
        before = dict(LAUNCHES)
        if step == STEPS[-1]:
            loss, ms, breakdown = profiled_step(trainer)
        else:
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = float(trainer.train_step())
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        grew = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        size = trainer.novel_size_for(step)
        print(f"[slice] step {step} novel {size}^2 loss {loss:.4f} "
              f"{ms:.1f} ms launches {grew}")
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss at step {step}")
        if min(grew.values()) < 1:
            raise RuntimeError(f"step {step} did not launch every kernel: {grew}")
        rows.append({"step": step, "size": size, "ms": ms, "loss": loss})
    launches = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stage1.ply")
        n_saved = trainer.save_ply(path)
        params, aux, _ = load_ply(path, capacity=trainer.capacity, device="cuda")
        alive = trainer.aux.alive
        if int(aux.alive.sum()) != n_saved or n_saved != int(alive.sum()):
            raise RuntimeError("PLY round trip lost gaussians")
        for k, v in params.items():
            if not torch.equal(v[:n_saved], trainer.params[k][alive]):
                raise RuntimeError(f"PLY round trip changed {k}")
    print(f"[slice] PLY round trip ok ({n_saved} gaussians); peak memory "
          f"{peak_gib:.2f} GiB")
    render = trainer.render_view(trainer.fixed_cam)
    if not bool(torch.isfinite(render.image).all()) or tuple(render.image.shape) != (256, 256, 3):
        raise RuntimeError("render_view of the trained cloud is not a finite 256^2 image")
    return {"steps": rows, "launches": launches, "peak_gib": peak_gib,
            "breakdown": breakdown}


def device_ms_by_name(prof) -> dict:
    """Device activity of a profile (kernels, copies, fills) in ms by name."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return by_name


def profiled_step(trainer):
    """One train step under torch.profiler: (loss, wall ms, breakdown) with
    device busy time by kernel name (CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        loss = float(trainer.train_step())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    by_name = device_ms_by_name(prof)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(((ev.key, ev.self_cpu_time_total / 1e3, ev.count)
                   for ev in prof.key_averages()), key=lambda r: -r[1])[:10]
    breakdown = {
        "wall_ms": ms, "device_busy_ms": busy,
        "idle_share_under_profiler": 1.0 - busy / ms if ms > 0 else None,
        "composite_fwd_ms": sum(v for k, v in by_name.items() if "composite_fwd" in k),
        "composite_bwd_ms": sum(v for k, v in by_name.items() if "composite_bwd" in k),
        "top": [(k[:60], round(v, 3)) for k, v in top],
        "host_self_ms_top": [(k[:40], round(v, 2), n) for k, v, n in host],
    }
    print(f"[profile] {json.dumps(breakdown)}")
    return loss, ms, breakdown


def main_path_scene(seed: int, n: int = 16384, size: int = 512):
    """A scene covering a 512^2 frame, made from the seed, binned as the
    main path bins it: (dup_feat, chunk_starts, n_chunks, grid_x, T)."""
    import numpy as np
    import torch

    from dreamgaussian_tpu_torch.ops.binning import bin_gaussians
    from dreamgaussian_tpu_torch.ops.project import project_gaussians
    from dreamgaussian_tpu_torch.ops.rasterize import build_feature_cols
    from dreamgaussian_tpu_torch.utils.camera import Camera, orbit_camera

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    u = rng.uniform(size=(n, 3)).astype(np.float32)
    r = 0.9 * np.cbrt(u[:, 0])
    phi, cos_t = 2 * np.pi * u[:, 1], 2 * u[:, 2] - 1
    sin_t = np.sqrt(1 - cos_t ** 2)
    xyz = np.stack([r * sin_t * np.cos(phi), r * sin_t * np.sin(phi), r * cos_t], 1)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    scale = t(np.exp(rng.uniform(-4.0, -2.5, size=(n, 3))))
    quat = t(rng.normal(size=(n, 4)))
    opacity = t(rng.uniform(0.1, 0.9, size=n))
    shs = t(rng.normal(size=(n, 1, 3)) * 0.5)
    cam = Camera.from_pose(orbit_camera(0.0, 0.0, 2.0), size, size,
                           math.radians(49.1), math.radians(49.1))
    a = {k: t(v) for k, v in cam.arrays().items()}
    proj = project_gaussians(t(xyz), scale, quat, opacity, shs, a["view"],
                             a["full_proj"], a["campos"], a["tanfov"], size, size)
    tile, chunk = 32, 128
    bins = bin_gaussians(proj.mean2d, proj.depth, proj.radius, size, size,
                         chunk=chunk, tile=tile, conic=proj.conic,
                         log_opacity=torch.log(proj.opacity))
    feat = build_feature_cols(proj.mean2d, proj.depth, proj.conic, proj.color,
                              proj.opacity)
    dup_feat = feat.index_select(1, bins.dup_map).contiguous()
    return dup_feat, bins, size // tile, (size // tile) ** 2


def pair_work(dup_feat, bins, fwd_out, *, grid_x, num_tiles, chunk, tile):
    """Pairs this run's data makes each kernel evaluate, by the plain
    version's rules: (contributing pairs, pairs K1 evaluates and skips,
    pairs K2 evaluates and skips, feature slots K1 reads, slots K2 reads).

    The contributors of a pixel are its pairs before n_contrib with
    alpha > 0 (what K2 masks on). K2 walks every pair before n_contrib. K1
    walks on to the pixel's stopping pair, which is the first later pair
    with alpha > 0, or else to the end of the tile's real (unpadded) list.
    A tile reads the features of its slots up to its pixels' furthest walk.
    """
    import torch

    from dreamgaussian_tpu_torch.ops import rasterize_cuda as rc

    dev = dup_feat.device
    cs, nc = bins.chunk_starts, bins.n_chunks
    cx, cy = rc._tile_centers(num_tiles, grid_x, tile, dev)
    x, y = rc._pixel_coords(tile, dev)
    n_contrib = fwd_out[:, 5].long()                                  # [T, PIX]
    sub = torch.arange(chunk, device=dev)
    never = torch.iinfo(torch.int64).max
    stop = torch.full_like(n_contrib, never)
    real = torch.zeros(num_tiles, dtype=torch.int64, device=dev)
    contrib = 0
    for j in range(int(nc.max())):
        f, active, _ = rc._chunk_features(dup_feat, cs, nc, j, chunk)
        alpha, _, _ = rc._chunk_alpha(f, cx, cy, x, y)
        hit = (alpha > 0.0) & active[:, None, None]                  # [T, C, PIX]
        gpos = (j * chunk + sub)[None, :, None]
        contrib += int((hit & (gpos < n_contrib[:, None])).sum())
        later = torch.where(hit & (gpos >= n_contrib[:, None]), gpos, never)
        stop = torch.minimum(stop, later.amin(1))
        real += ((f[5] > rc.Q_SENTINEL / 2) & active[:, None]).sum(1)
    k1_walk = torch.where(stop < never, stop + 1, real[:, None])
    k1_pairs, k2_pairs = int(k1_walk.sum()), int(n_contrib.sum())
    return (contrib, k1_pairs - contrib, k2_pairs - contrib,
            int(k1_walk.amax(1).sum()), int(n_contrib.amax(1).sum()))


def grad_rows_agree(d_k, d_r, rtol: float, atol: float) -> bool:
    """K2's gradient rows against the plain version's, elementwise with a
    tolerance scaled to each row's own magnitude; prints each row's error
    beside its median and largest |grad|. Rows 10-15 must be zero."""
    ok = not bool(d_k[len(GRAD_ROWS):].any())
    for i, name in enumerate(GRAD_ROWS):
        mag = d_r[i].abs()
        err = (d_k[i] - d_r[i]).abs()
        tol = rtol * mag + atol * float(mag.max())
        nonzero = mag[mag > 0]
        median = float(nonzero.median()) if nonzero.numel() else 0.0
        used = float((err / tol.clamp_min(1e-30)).max())
        ok = ok and bool((err <= tol).all())
        print(f"[kernels] K2 row {name}: max abs err {float(err.max()):.3e}, median "
              f"|grad| {median:.3e}, max |grad| {float(mag.max()):.3e}, share of "
              f"tolerance used {used:.3f}")
    return ok


def check_kernels(seed: int) -> list:
    """K1 and K2 against their plain versions at the 512^2 main-path shape."""
    import torch

    from dreamgaussian_tpu_torch.ops import rasterize_cuda as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dup_feat, bins, grid_x, num_tiles = main_path_scene(seed)
    geo = dict(grid_x=grid_x, num_tiles=num_tiles, chunk=128, tile=32)
    cs, nc = bins.chunk_starts, bins.n_chunks

    out = rc.composite_forward(dup_feat, cs, nc, **geo)
    ref = rc.composite_forward_ref(dup_feat, cs, nc, **geo)
    torch.cuda.synchronize()
    fwd_err = float((out[:, :5] - ref[:, :5]).abs().max())
    nc_mismatch = float((out[:, 5] != ref[:, 5]).float().mean())
    pix_covered = float((ref[:, 5] > 0).float().mean())
    print(f"[kernels] K1 at 512^2: {int(bins.num_dups)} duplicates, "
          f"{int(nc.sum())} chunks, pixels covered {pix_covered:.3f}, "
          f"max abs err {fwd_err:.3e}, n_contrib mismatch share {nc_mismatch:.2e}")
    # f32 with another association of the transmittance product (cumprod
    # against the sequential walk): outputs agree to 1e-3, and a pixel's
    # stop may move by one pair only at the 1e-4 threshold.
    if not fwd_err <= 1e-3 or nc_mismatch > 1e-3:
        raise RuntimeError("K1 disagrees with its plain version")

    g = torch.Generator(device="cuda").manual_seed(seed)
    g_out = torch.randn(out.shape, device="cuda", generator=g)
    d_k = rc.composite_backward(dup_feat, cs, nc, ref, g_out, **geo)
    d_r = rc.composite_backward_ref(dup_feat, cs, nc, ref, g_out, **geo)
    torch.cuda.synchronize()
    bwd_err = float((d_k - d_r).abs().max())
    print(f"[kernels] K2 at 512^2: max abs err {bwd_err:.3e}; tolerance per element "
          f"{K2_RTOL:g} |grad| + {K2_ATOL:g} max |grad| of its row")
    # Sums over a tile's pixels in another order, T rebuilt by division
    # step by step against a suffix product.
    if not grad_rows_agree(d_k, d_r, K2_RTOL, K2_ATOL):
        raise RuntimeError("K2 disagrees with its plain version")

    fwd_ms = cuda_ms(lambda: rc.composite_forward(dup_feat, cs, nc, **geo), 20)
    fwd_plain = cuda_ms(lambda: rc.composite_forward_ref(dup_feat, cs, nc, **geo), 3, 1)
    bwd_ms = cuda_ms(lambda: rc.composite_backward(dup_feat, cs, nc, ref, g_out, **geo), 20)
    bwd_plain = cuda_ms(
        lambda: rc.composite_backward_ref(dup_feat, cs, nc, ref, g_out, **geo), 3, 1)

    # Bounds from this run's data: the pairs each kernel must evaluate and
    # the 10 feature rows (40 B) of each slot a tile must read, once.
    contrib, k1_skip, k2_skip, k1_slots, k2_slots = pair_work(dup_feat, bins, ref, **geo)
    print(f"[kernels] pairs: {contrib} contributing; evaluated and skipped "
          f"{k1_skip} by K1, {k2_skip} by K2; feature slots read {k1_slots} by K1, "
          f"{k2_slots} by K2")
    tiles_bytes = num_tiles * rc.OUT_CH * 1024 * 4
    k1_bytes = k1_slots * 40 + 8 * num_tiles + tiles_bytes
    k2_bytes = k2_slots * 40 + 8 * num_tiles + 2 * tiles_bytes + dup_feat.numel() * 4
    rows = []
    for name, src, line, ms, plain, byts, flops in (
        ("composite_fwd", "dreamgaussian_tpu_torch/csrc/composite_fwd.cu",
         "dreamgaussian_tpu/ops/rasterize_pallas.py:211", fwd_ms, fwd_plain,
         k1_bytes, contrib * K1_FLOPS_PER_PAIR + k1_skip * SKIP_FLOPS_PER_PAIR),
        ("composite_bwd", "dreamgaussian_tpu_torch/csrc/composite_bwd.cu",
         "dreamgaussian_tpu/ops/rasterize_pallas.py:323", bwd_ms, bwd_plain,
         k2_bytes, contrib * K2_FLOPS_PER_PAIR + k2_skip * SKIP_FLOPS_PER_PAIR),
    ):
        t_bytes = byts / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": line,
            "launches": None, "max_abs_err": fwd_err if name == "composite_fwd" else bwd_err,
            "ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        print(f"[kernels] {name}: {ms:.4f} ms, plain {plain:.3f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms ({rows[-1]['bound_by']})")
    return rows


def surface_cloud(seed: int, n: int = 16384):
    """A cloud with a surface at density 1, from the seed: ``n`` gaussians
    filling a solid bumpy blob of radius about 0.6 (it fits the bake
    cameras' frame), with scales that overlap (a few times the point
    spacing's third) and opacities of 0.6 to 0.95; colours vary smoothly
    with position. Returns the numpy parameter dict of the PLY layout."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(n, 3))
    phi, cos_t = 2 * np.pi * u[:, 1], 2 * u[:, 2] - 1
    sin_t = np.sqrt(1 - cos_t ** 2)
    d = np.stack([sin_t * np.cos(phi), cos_t, sin_t * np.sin(phi)], 1)
    bumps = 1.0 + 0.15 * np.sin(3 * phi) * sin_t ** 2 + 0.1 * np.cos(4 * np.arccos(cos_t))
    xyz = d * (0.58 * np.cbrt(u[:, 0]) * bumps)[:, None] * np.array([1.0, 0.85, 0.9])
    rgb = 0.5 + 0.45 * np.sin(4.0 * xyz + np.array([0.0, 1.0, 2.0]))
    opacity = rng.uniform(0.6, 0.95, size=(n, 1))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "xyz": f32(xyz),
        "f_dc": f32((rgb - 0.5) / 0.28209479177387814)[:, None, :],
        "f_rest": np.zeros((n, 0, 3), np.float32),
        "opacity": f32(np.log(opacity / (1 - opacity))),
        "scaling": f32(np.log(rng.uniform(0.035, 0.055, size=(n, 3)))),
        "rotation": f32(rng.normal(size=(n, 4))),
    }


def run_export(seed: int, card: str) -> dict:
    """Export a textured mesh from a seeded cloud through the trainer and
    ``export_textured_mesh`` at full sizes; returns the mesh, the stage
    seconds and the kernels' launch counts of the export."""
    import numpy as np
    import torch

    from dreamgaussian_tpu_torch.meshing.export import export_textured_mesh
    from dreamgaussian_tpu_torch.meshing.mesh import Mesh
    from dreamgaussian_tpu_torch.ops import mesh_raster_cuda, rasterize_cuda
    from dreamgaussian_tpu_torch.scene import GaussianAux, save_ply
    from dreamgaussian_tpu_torch.train import Stage1Trainer
    from dreamgaussian_tpu_torch.utils.config import Config
    from dreamgaussian_tpu_torch.weights import cloud_from_numpy

    cloud = surface_cloud(seed)
    n = cloud["xyz"].shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        # The cloud enters the trainer as a user's would: as a PLY it loads.
        ply = os.path.join(tmp, "cloud.ply")
        params, alive = cloud_from_numpy(cloud, np.ones(n, bool), device="cuda")
        zeros = torch.zeros(n, device="cuda")
        save_ply(ply, params, GaussianAux(alive=alive, max_radii2d=zeros, grad_accum=zeros,
                                          denom=zeros))
        opt = Config({**IMAGE_OPTIONS, "load": ply})
        trainer = Stage1Trainer(opt, capacity=opt["capacity"], seed=seed, device="cuda")
        if trainer.capacity != n or int(trainer.aux.alive.sum()) != n:
            raise RuntimeError("the trainer did not take the whole cloud")

        for counts in (rasterize_cuda.LAUNCHES, mesh_raster_cuda.LAUNCHES):
            for k in counts:
                counts[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats: dict = {}
        obj = os.path.join(tmp, "mesh.obj")
        t0 = time.perf_counter()
        mesh = export_textured_mesh(
            trainer.params, trainer.aux.alive,
            lambda cam: trainer.render_view(cam).image, obj,
            fovy=trainer.fovy, radius=trainer.radius,
            density_thresh=opt["density_thresh"], uv_cache_path=obj,
            device="cuda", stats=stats, **EXPORT_SIZES,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**rasterize_cuda.LAUNCHES, **mesh_raster_cuda.LAUNCHES}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        t0 = time.perf_counter()
        glb = os.path.join(tmp, "mesh.glb")
        mesh.write(glb)
        glb_s = time.perf_counter() - t0
        sizes = {os.path.basename(f): os.path.getsize(os.path.join(tmp, f))
                 for f in sorted(os.listdir(tmp))}
        back_obj = Mesh.load(obj, resize=False)
        back_glb = Mesh.load(glb, resize=False)

    uv = mesh.vt[mesh.ft]                                          # [F, 3, 2]
    e1, e2 = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
    atlas = float(0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).sum())
    stage_names = ("field_s", "isosurface_s", "clean_remesh_decimate_s", "uv_s", "bake_s",
                   "inpaint_s", "write_s")
    stages = {k: round(stats[k], 3) for k in stage_names}
    print(f"[export] {wall:.1f} s in all; stages {json.dumps(stages)}; GLB write "
          f"{glb_s:.2f} s; bake share of the export {stats['bake_s'] / wall:.3f}; "
          f"peak memory {peak_gib:.2f} GiB; card '{card}'")
    print(f"[export] field max {stats['occ_max']:.1f}, isosurface {stats['isosurface_faces']} "
          f"faces -> mesh {stats['vertices']} vertices, {stats['faces']} faces, "
          f"{stats['uv_vertices']} uv vertices; albedo covered before the inpaint "
          f"{stats['covered_share']:.3f} of the texture (floor {MIN_COVERED_SHARE}); sum of the "
          f"uv triangles' areas {atlas:.3f} of the unit square; files {json.dumps(sizes)}; "
          f"launches {launches}")

    nf = len(mesh.f)
    if not 0 < nf <= EXPORT_SIZES["decimate_target"]:
        raise RuntimeError(f"the mesh has {nf} faces")
    if mesh.ft.min() < 0 or mesh.ft.max() >= len(mesh.vt) or mesh.f.max() >= len(mesh.v):
        raise RuntimeError("a face index is out of range")
    if mesh.vt.min() < 0.0 or mesh.vt.max() > 1.0:
        raise RuntimeError("a uv coordinate lies outside [0, 1]")
    size = EXPORT_SIZES["texture_size"]
    if mesh.albedo.shape != (size, size, 3) or not np.isfinite(mesh.albedo).all():
        raise RuntimeError("the albedo is not a finite texture of the asked size")
    if stats["covered_share"] < MIN_COVERED_SHARE:
        raise RuntimeError(f"the bake covered {stats['covered_share']:.3f} of the albedo")
    if launches["ztest"] != 26 or launches["composite_fwd"] < 26:
        raise RuntimeError(f"the export did not go through the kernels: {launches}")
    # OBJ prints six decimals and stores v flipped; GLB keeps float32 bits.
    flipped = np.stack([mesh.vt[:, 0], 1.0 - mesh.vt[:, 1]], 1)
    for name, back, vt, atol in (("OBJ", back_obj, flipped, 1e-6), ("GLB", back_glb, mesh.vt, 0.0)):
        if not (np.array_equal(back.f, mesh.f)
                and np.abs(back.v - mesh.v).max() <= atol
                and np.abs(back.vt - vt).max() <= atol
                and np.abs(back.albedo - np.clip(mesh.albedo, 0, 1)).max() <= 1 / 255):
            raise RuntimeError(f"the {name} did not read back as written")
    print(f"[export] OBJ and GLB read back: v, f, vt equal (OBJ to 1e-6), albedo within 1/255")
    profiled_bake(mesh, trainer)
    return {"mesh": mesh, "stats": stats, "launches": launches, "wall_s": wall,
            "peak_gib": peak_gib}


def profiled_bake(mesh, trainer) -> None:
    """The 26-view bake once more under torch.profiler (no inpaint): wall
    time against device busy time, with the kernels' shares."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dreamgaussian_tpu_torch.meshing.export import bake_texture

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        bake_texture(mesh, lambda cam: trainer.render_view(cam).image, fovy=trainer.fovy,
                     radius=trainer.radius, texture_size=EXPORT_SIZES["texture_size"],
                     render_resolution=EXPORT_SIZES["bake_resolution"],
                     min_resolution=min(256, EXPORT_SIZES["texture_size"] // 4),
                     inpaint=False, device="cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    by_name = device_ms_by_name(prof)
    busy = sum(by_name.values())
    launched = sum(ev.count for ev in prof.key_averages() if ev.key == "cudaLaunchKernel")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print("[profile] " + json.dumps({
        "bake_wall_ms_under_profiler": ms, "device_busy_ms": busy,
        "idle_share_under_profiler": 1.0 - busy / ms if ms > 0 else None,
        "ztest_ms": sum(v for k, v in by_name.items() if "ztest" in k),
        "composite_fwd_ms": sum(v for k, v in by_name.items() if "composite_fwd" in k),
        "kernels_launched": launched,
        "top": [(k[:60], round(v, 3)) for k, v in top],
    }))


def ztest_pair_work(dup_feat, bins, *, grid_x, num_tiles, chunk, tile):
    """Work this run's data gives K3: (real slots, (pixel, triangle) pairs
    with the pixel centre inside the triangle's bounding box and the tile,
    covering pairs by the plain version's inside test)."""
    import torch

    from dreamgaussian_tpu_torch.ops import mesh_raster_cuda as mr

    dev = dup_feat.device
    n_slots = int(bins.n_chunks.sum()) * chunk
    f = dup_feat[:, :n_slots]
    real = f[9] > 0.0
    tile_of = torch.repeat_interleave(torch.arange(num_tiles, device=dev), bins.n_chunks.long() * chunk,
                                      output_size=n_slots)
    ty = tile_of // grid_x
    tx = tile_of - ty * grid_x

    def span(lo, hi, origin):
        # integer pixel centres in [lo, hi], clipped to the tile's [origin, origin + tile - 1]
        first = torch.maximum(torch.ceil(lo), (origin * tile).float())
        last = torch.minimum(torch.floor(hi), (origin * tile + tile - 1).float())
        return torch.clamp_min(last - first + 1.0, 0.0)

    xs, ys = f[0:6:2], f[1:6:2]
    box = span(xs.amin(0), xs.amax(0), tx) * span(ys.amin(0), ys.amax(0), ty)
    box_pairs = int(torch.where(real, box, torch.zeros_like(box)).sum())
    px, py = mr._pixel_centres(num_tiles, grid_x, tile, dev)
    cover = 0
    for j in range(int(bins.n_chunks.max())):
        valid, _, _ = mr._chunk_coverage(dup_feat, bins.chunk_starts, bins.n_chunks, j, chunk, px, py)
        cover += int(valid.sum())
    return int(real.sum()), box_pairs, cover


def check_ztest(mesh, fovy: float, radius: float) -> dict:
    """K3 against its plain version at the bake's shape: the exported mesh
    under one of the 26 bake cameras at 512^2, tile 32, chunk 128."""
    import numpy as np
    import torch

    from dreamgaussian_tpu_torch.meshing.export import BAKE_HORS, BAKE_VERS
    from dreamgaussian_tpu_torch.ops import mesh_raster_cuda as mr
    from dreamgaussian_tpu_torch.ops.binning import bin_rects
    from dreamgaussian_tpu_torch.ops.mesh_raster import triangle_features
    from dreamgaussian_tpu_torch.utils.camera import Camera, orbit_camera

    dev = torch.device("cuda")
    size, tile, chunk = EXPORT_SIZES["bake_resolution"], 32, 128
    grid_x, num_tiles = size // tile, (size // tile) ** 2
    cam = Camera.from_pose(orbit_camera(BAKE_VERS[K3_BAKE_VIEW], BAKE_HORS[K3_BAKE_VIEW], radius),
                           size, size, fovy, fovy)
    v = torch.as_tensor(mesh.v, dtype=torch.float32, device=dev)
    v_h = torch.cat([v, torch.ones((v.shape[0], 1), device=dev)], dim=1)
    v_clip = v_h @ torch.as_tensor(cam.arrays()["full_proj"], device=dev).T
    faces = torch.as_tensor(np.asarray(mesh.f), dtype=torch.int64, device=dev)
    feat_cols, xmin, ymin, xmax, ymax, ok = triangle_features(v_clip, faces, size, size, tile)
    bins = bin_rects(xmin, ymin, xmax, ymax, ok, grid_x=grid_x, num_tiles=num_tiles, chunk=chunk)
    dup_feat = feat_cols.index_select(1, bins.dup_map).contiguous()
    geo = dict(grid_x=grid_x, num_tiles=num_tiles, chunk=chunk, tile=tile)
    cs, nc = bins.chunk_starts, bins.n_chunks

    before = mr.LAUNCHES["ztest"]
    ids, z = mr.ztest(dup_feat, cs, nc, **geo)
    r_ids, r_z = mr.ztest_ref(dup_feat, cs, nc, **geo)
    torch.cuda.synchronize()
    if mr.LAUNCHES["ztest"] != before + 1:
        raise RuntimeError("the K3 wrapper did not count its launch")
    differing = int((ids != r_ids).sum())
    z_err = float((z - r_z).abs().max())
    covered = float((r_ids > 0).float().mean())
    print(f"[kernels] K3 at {size}^2 on {faces.shape[0]} faces (bake view {K3_BAKE_VIEW}): "
          f"{int(bins.num_dups)} duplicates, {int(nc.sum())} chunks (longest tile "
          f"{int(nc.max())}), pixels covered {covered:.3f}, pixels with another id "
          f"{differing}, max abs z err {z_err:.3e}")
    if differing != 0 or not z_err <= 1e-6 or covered < 0.05:
        raise RuntimeError("K3 disagrees with its plain version")

    ms = cuda_ms(lambda: mr.ztest(dup_feat, cs, nc, **geo), 20)
    plain = cuda_ms(lambda: mr.ztest_ref(dup_feat, cs, nc, **geo), 3, 1)
    slots, box_pairs, cover_pairs = ztest_pair_work(dup_feat, bins, **geo)
    byts = slots * 40 + 8 * num_tiles + num_tiles * tile * tile * 8
    flops = box_pairs * K3_FLOPS_PER_BOX_PAIR + cover_pairs * K3_FLOPS_PER_COVER_PAIR
    t_bytes = byts / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    all_pairs = slots * tile * tile
    print(f"[kernels] K3 work: {slots} real slots, {box_pairs} (pixel, triangle) pairs inside "
          f"a bounding box of {all_pairs} in the tiles' lists, {cover_pairs} covering; "
          f"{byts} bytes, {flops} operations")
    print(f"[kernels] ztest: {ms:.4f} ms, plain {plain:.3f} ms, bound "
          f"{max(t_bytes, t_ops):.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'})")
    return {
        "name": "ztest", "route": "cuda", "source": "dreamgaussian_tpu_torch/csrc/ztest.cu",
        "replaces": "dreamgaussian_tpu/ops/mesh_raster_pallas.py:48", "launches": None,
        "max_abs_err": z_err, "ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from dreamgaussian_tpu_torch.ops import cuda_build

    nvcc = subprocess.run([cuda_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()[-1]
    card = card_line()
    print(f"[toolchain] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{nvcc}' card '{card}'")
    t0 = time.perf_counter()
    cuda_build.build(["composite_fwd", "composite_bwd", "ztest"], verbose=True)
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s")
    from dreamgaussian_tpu_torch import native

    t0 = time.perf_counter()
    print(f"[build] mesh tools {native.build().name} ready in {time.perf_counter() - t0:.1f} s")

    result = run_slice(args.seed)
    by_step = {row["step"]: row["ms"] for row in result["steps"]}
    rungs = {}
    for size, steps in RUNG_STEPS.items():
        plain = [by_step[s] for s in steps if s != 1 and s % 100 != 0]
        rungs[size] = {"median_ms": statistics.median(plain),
                       "min_ms": min(plain), "max_ms": max(plain),
                       "densify_ms": [round(by_step[s], 1) for s in steps if s % 100 == 0]}
    busy = result["breakdown"]["device_busy_ms"]
    print(f"[slice] ms per step by rung {json.dumps(rungs)}; first step "
          f"{by_step[1]:.1f} ms; device busy {busy:.1f} ms of a profiled 512^2 "
          f"step, idle share against the 512^2 median "
          f"{1.0 - busy / rungs[512]['median_ms']:.3f}; peak "
          f"{result['peak_gib']:.2f} GiB; card '{card}'")

    kernels = check_kernels(args.seed)
    for row in kernels:
        row["launches"] = result["launches"][row["name"]]

    export = run_export(args.seed, card)
    k3 = check_ztest(export["mesh"], math.radians(IMAGE_OPTIONS["fovy"]), IMAGE_OPTIONS["radius"])
    k3["launches"] = export["launches"]["ztest"]
    kernels[0]["launches_export"] = export["launches"]["composite_fwd"]
    kernels.append(k3)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
