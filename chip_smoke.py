"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

1. builds the port's CUDA kernels (one nvcc per source, all at once) and
   prints the toolchain;
2. runs stage-1 image-to-3D with full-width Zero123 guidance (random bf16
   weights) through ``Stage1Trainer`` with ``configs/image.yaml``'s
   options at capacity 16384: steps 1-3 at the 128 rung, step 200 (256,
   densify) and step 300 (512, densify), checking finite losses and that
   every step launched K1 and K2; saves the PLY and loads it back;
3. holds K1 and K2 against their plain PyTorch versions on the card and
   times kernel and plain version: on a synthetic scene that covers a
   512^2 frame, and on the trainer's own cloud after the ladder under the
   known view (256^2) and one novel camera at 128^2, 256^2 and 512^2;
4. exports a textured mesh at ``configs/image.yaml``'s sizes (16384
   gaussians that fill a solid shape, field 128^3, remesh 0.015, decimate
   to 100,000 faces, texture 1024^2, 26 bake views at 512^2) through
   ``export_textured_mesh`` with the trainer's ``render_view`` as the
   bake's renderer, once as OBJ and the write alone as GLB; reads both
   back and checks them; prints the seconds of each stage, the peak memory
   and the mesh's sizes; checks that the export launched K3 26 times and K1
   at least 26 times;
5. holds K3 against its plain version on the exported mesh under each of
   the 26 bake cameras (ids and z equal on every pixel), with the launched
   grid, time and bound per view; at view 9 also times the plain version,
   the build without the sift (in turns with the shipped one) and the
   launch with every list empty;
6. refines the exported mesh's texture with ``Stage2Trainer`` at
   ``configs/image.yaml``'s stage-2 keys (novel views 512^2, refine 50
   DDIM steps) on the stage-1 phase's Zero123 guidance with its VAE
   decoder: eight steps with 10, 7 and 3 UNet calls, two under
   torch.profiler (lines ``[stage2]``, ``[profile] stage2``), checking
   finite losses, 3 K3 launches and the expected UNet calls per step, a
   changed texture and the refined OBJ read back;
7. holds K3 against its plain version at the stage-2 shapes, reached
   through ``render_mesh``: the known view at 256^2 and a novel view at
   every SSAA choice (128^2, 384^2, 640^2, 896^2), with grid, graph time
   and bound (lines ``[kernels] K3 stage 2``);
8. runs ``python -m dreamgaussian_tpu_torch.cli.main --config
   configs/image.yaml`` and then ``cli.main2`` through their ``main(argv)``
   on the card with the fake guidance on a disc RGBA PNG (30 stage-1
   steps, the export at a 256^2 texture, 3 stage-2 steps) and reads the PLY
   and both meshes back (lines ``[cli]``, with each run's kernel launches,
   counted from 0 at its start); then holds every K1, K2 and K3 call the
   CLIs made against the plain version on the same inputs (the fake
   guidance's 64^2 target render among them), with K3's grid, graph time
   and bound at each render size (lines ``[kernels] ... in the CLI's``);
9. the weights day: writes a full-width Zero123 snapshot (the UNet, the
   KL-VAE, CLIP ViT-L/14 and the camera projection, about 1.25 B values)
   as fp16 safetensors, loads it with ``load_zero123`` (every UNet and VAE
   parameter equal to its snapshot tensor cast to bf16, no key left over;
   the CLIP tower on the card against the CPU), then runs the documented
   commands on it: stage 1 to its first checkpoint, stage 1 resumed from
   it (the restored state equal to the saved one, both random states
   included) with the export at ``configs/image.yaml``'s sizes, stage 2,
   and ``configs/image_sai.yaml`` (stable-zero123) for a few steps; reads
   the outputs back and holds every K1, K2 and K3 call of these runs
   against the plain version (lines ``[weights]``, ``[cli]`` and
   ``[kernels] ... in the weights-day``);
10. the text day: writes a full-width SD 2.1-base diffusers snapshot (the
   UNet, the KL-VAE, the 23-layer CLIP text tower, a tokenizer) as fp16
   safetensors and a full-width single-file MVDream LDM checkpoint (the
   4-view UNet with its camera MLP, the VAE, the 24-block OpenCLIP ViT-H
   text tower) with ``torch.save``; loads both (seconds, device peak, the
   MVDream load's host peak RSS in a process of its own; every UNet and VAE
   weight equal to its file tensor cast to bf16; the text states on the
   card against the CPU's); times stage-1 steps on each rung for each prior
   (the 512^2 step under torch.profiler, one UNet call of each by CUDA
   events); then runs ``cli.main`` (8 steps, the export at the configs'
   sizes) and ``cli.main2`` (2 steps) on ``configs/text.yaml`` with the SD
   snapshot and on ``configs/text_mv.yaml`` with the MVDream file, reads the
   outputs back, gates the UNet calls and K3 launches per run, and holds
   every K1, K2 and K3 call against the plain version (lines ``[text]``,
   ``[cli]`` and ``[kernels] ... in the text-day``);
11. the ImageDream day: writes a full-width single-file ImageDream checkpoint
   (the 4+1-view ipmv UNet with its camera MLP, resampler and ip
   projections, the VAE, the OpenCLIP text tower: about 1.41 B values) with
   a CLIP ViT-H/14 ``image_encoder/`` folder beside it (0.63 B values), fp16;
   loads it with ``load_imagedream`` on a disc reference (seconds, device
   peak, the host peak RSS rise in a process of its own; every UNet and VAE
   weight equal to its file tensor cast to bf16; the text states and the
   CLIP tokens on the card against the CPU's); times stage-1 steps on each
   rung (the 512^2 step under torch.profiler, one UNet call of batch 10 at
   32^2 by the profiler and by CUDA events); runs ``cli.main`` (8 steps, the
   export) and ``cli.main2`` (2 steps) on ``configs/imagedream.yaml`` with
   the disc RGBA PNG and the file, reads the outputs back, gates the UNet
   calls and K3 launches, holds every K1, K2 and K3 call against the plain
   version; then runs ``cli.dream`` at 10 steps in its three modes on the
   text day's SD snapshot and MVDream file and on the ipmv file, reads each
   PNG back and checks its shape and the UNet calls (lines
   ``[imagedream]``, ``[cli]``, ``[kernels] ... in the imagedream-day``);
12. prints the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

Needs a CUDA card; exits non-zero without one, and on any failed check.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


def image_options() -> dict:
    """configs/image.yaml's options, read by the port's config reader (the
    card's machine has no PyYAML, and the reader needs none)."""
    from dreamgaussian_tpu_torch.utils.config import load

    return dict(load(os.path.join(CONFIGS, "image.yaml")))


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
# The bake view whose K3 numbers make the kernel's row: elevation -45, azimuth 45.
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
# The novel camera (elevation offset, azimuth in degrees) under which K1 and
# K2 are held and timed on the trainer's cloud.
NOVEL_VIEW = (-15.0, 60.0)
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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured into one CUDA
    graph and replayed, so that no host work sits between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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

    opt = Config(image_options())
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
            "breakdown": breakdown, "trainer": trainer, "guidance": guidance}


def device_ms_by_name(prof) -> dict:
    """Device activity of a profile (kernels, copies, fills) in ms by name;
    the device-side copies of ``record_function`` ranges are not activity."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
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


def bin_cloud(xyz, scale, quat, opacity, shs, cam, size: int, alive=None,
              tile: int = 32, chunk: int = 128):
    """Project a cloud (activated parameters, on the card) through ``cam`` at
    ``size``^2 and bin it as ``render_gaussians`` does: (dup_feat, bins, geo)
    with geo the kernels' grid_x / num_tiles / chunk / tile."""
    import torch

    from dreamgaussian_tpu_torch.ops.binning import bin_gaussians
    from dreamgaussian_tpu_torch.ops.project import project_gaussians
    from dreamgaussian_tpu_torch.ops.rasterize import build_feature_cols

    a = {k: torch.as_tensor(v, dtype=torch.float32, device=xyz.device)
         for k, v in cam.arrays().items()}
    proj = project_gaussians(xyz, scale, quat, opacity, shs, a["view"], a["full_proj"],
                             a["campos"], a["tanfov"], size, size, alive=alive)
    bins = bin_gaussians(proj.mean2d, proj.depth, proj.radius, size, size,
                         chunk=chunk, tile=tile, conic=proj.conic,
                         log_opacity=torch.log(proj.opacity))
    feat = build_feature_cols(proj.mean2d, proj.depth, proj.conic, proj.color,
                              proj.opacity)
    dup_feat = feat.index_select(1, bins.dup_map).contiguous()
    geo = dict(grid_x=size // tile, num_tiles=(size // tile) ** 2, chunk=chunk, tile=tile)
    return dup_feat, bins, geo


def main_path_scene(seed: int, n: int = 16384, size: int = 512):
    """A scene covering a 512^2 frame, made from the seed, binned as the
    main path bins it: (dup_feat, bins, geo)."""
    import numpy as np
    import torch

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
    return bin_cloud(t(xyz), scale, quat, opacity, shs, cam, size)


def trainer_shapes(trainer) -> list:
    """The trainer's cloud as its step renders it: under the known view at
    ``ref_size``^2 and under one novel camera at each rung of the ladder.
    Returns [(label, dup_feat, bins, geo)]."""
    import torch

    from dreamgaussian_tpu_torch.utils.camera import Camera, orbit_camera

    p = trainer.params
    cloud = (p["xyz"], torch.exp(p["scaling"]), p["rotation"],
             torch.sigmoid(p["opacity"][:, 0]), torch.cat([p["f_dc"], p["f_rest"]], dim=1))
    with torch.no_grad():
        shapes = [(f"known view {trainer.ref_size}^2",
                   *bin_cloud(*cloud, trainer.fixed_cam, trainer.ref_size,
                              alive=trainer.aux.alive))]
        for size in (128, 256, 512):
            cam = Camera.from_pose(orbit_camera(trainer.elevation + NOVEL_VIEW[0], NOVEL_VIEW[1],
                                                trainer.radius),
                                   size, size, trainer.fovy, trainer.fovx)
            shapes.append((f"novel view {size}^2",
                           *bin_cloud(*cloud, cam, size, alive=trainer.aux.alive)))
    return shapes


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


def grad_rows_agree(d_k, d_r, rtol: float, atol: float, verbose: bool = True) -> bool:
    """K2's gradient rows against the plain version's, elementwise with a
    tolerance scaled to each row's own magnitude; ``verbose`` prints each
    row's error beside its median and largest |grad|. Rows 10-15 must be
    zero."""
    ok = not bool(d_k[len(GRAD_ROWS):].any())
    for i, name in enumerate(GRAD_ROWS):
        mag = d_r[i].abs()
        err = (d_k[i] - d_r[i]).abs()
        tol = rtol * mag + atol * float(mag.max())
        ok = ok and bool((err <= tol).all())
        if not verbose:
            continue
        nonzero = mag[mag > 0]
        median = float(nonzero.median()) if nonzero.numel() else 0.0
        used = float((err / tol.clamp_min(1e-30)).max())
        print(f"[kernels] K2 row {name}: max abs err {float(err.max()):.3e}, median "
              f"|grad| {median:.3e}, max |grad| {float(mag.max()):.3e}, share of "
              f"tolerance used {used:.3f}")
    return ok


def check_shape(label: str, dup_feat, bins, geo: dict, seed: int, plain_reps: int) -> dict:
    """K1 and K2 against their plain versions on one binned scene, with
    their times and bounds; raises where a kernel fails its gate."""
    import torch

    from dreamgaussian_tpu_torch.ops import rasterize_cuda as rc

    cs, nc = bins.chunk_starts, bins.n_chunks
    num_tiles, tile = geo["num_tiles"], geo["tile"]

    out = rc.composite_forward(dup_feat, cs, nc, **geo)
    ref = rc.composite_forward_ref(dup_feat, cs, nc, **geo)
    torch.cuda.synchronize()
    fwd_err = float((out[:, :5] - ref[:, :5]).abs().max())
    nc_mismatch = float((out[:, 5] != ref[:, 5]).float().mean())
    pix_covered = float((ref[:, 5] > 0).float().mean())
    print(f"[kernels] {label}: {int(bins.num_dups)} duplicates, {int(nc.sum())} chunks "
          f"(longest tile {int(nc.max())}), pixels covered {pix_covered:.3f}; K1 max abs err "
          f"{fwd_err:.3e}, n_contrib mismatch share {nc_mismatch:.2e}")
    # f32 with another association of the transmittance product (cumprod
    # against the sequential walk): outputs agree to 1e-3, and a pixel's
    # stop may move by one pair only at the 1e-4 threshold.
    if not fwd_err <= 1e-3 or nc_mismatch > 1e-3:
        raise RuntimeError(f"K1 disagrees with its plain version ({label})")

    g = torch.Generator(device="cuda").manual_seed(seed)
    g_out = torch.randn(out.shape, device="cuda", generator=g)
    d_k = rc.composite_backward(dup_feat, cs, nc, ref, g_out, **geo)
    d_r = rc.composite_backward_ref(dup_feat, cs, nc, ref, g_out, **geo)
    torch.cuda.synchronize()
    bwd_err = float((d_k - d_r).abs().max())
    print(f"[kernels] {label}: K2 max abs err {bwd_err:.3e}; tolerance per element "
          f"{K2_RTOL:g} |grad| + {K2_ATOL:g} max |grad| of its row")
    # Sums over a tile's pixels in another order, T rebuilt by a reciprocal
    # step by step against a suffix product.
    if not grad_rows_agree(d_k, d_r, K2_RTOL, K2_ATOL):
        raise RuntimeError(f"K2 disagrees with its plain version ({label})")

    fwd_ms = cuda_ms(lambda: rc.composite_forward(dup_feat, cs, nc, **geo), 20)
    fwd_plain = cuda_ms(lambda: rc.composite_forward_ref(dup_feat, cs, nc, **geo),
                        plain_reps, min(1, plain_reps - 1))
    bwd_ms = cuda_ms(lambda: rc.composite_backward(dup_feat, cs, nc, ref, g_out, **geo), 20)
    bwd_plain = cuda_ms(
        lambda: rc.composite_backward_ref(dup_feat, cs, nc, ref, g_out, **geo),
        plain_reps, min(1, plain_reps - 1))

    # Bounds from this scene's data: the pairs each kernel must evaluate and
    # the 10 feature rows (40 B) of each slot a tile must read, once.
    contrib, k1_skip, k2_skip, k1_slots, k2_slots = pair_work(dup_feat, bins, ref, **geo)
    print(f"[kernels] {label}: pairs {contrib} contributing; evaluated and skipped "
          f"{k1_skip} by K1, {k2_skip} by K2; feature slots read {k1_slots} by K1, "
          f"{k2_slots} by K2")
    tiles_bytes = num_tiles * rc.OUT_CH * tile * tile * 4
    k1_bytes = k1_slots * 40 + 8 * num_tiles + tiles_bytes
    k2_bytes = k2_slots * 40 + 8 * num_tiles + 2 * tiles_bytes + dup_feat.numel() * 4
    result = {"label": label, "duplicates": int(bins.num_dups), "chunks": int(nc.sum()),
              "longest_tile_chunks": int(nc.max()), "tiles": num_tiles}
    for name, ms, plain, err, byts, flops in (
        ("composite_fwd", fwd_ms, fwd_plain, fwd_err, k1_bytes,
         contrib * K1_FLOPS_PER_PAIR + k1_skip * SKIP_FLOPS_PER_PAIR),
        ("composite_bwd", bwd_ms, bwd_plain, bwd_err, k2_bytes,
         contrib * K2_FLOPS_PER_PAIR + k2_skip * SKIP_FLOPS_PER_PAIR),
    ):
        t_bytes = byts / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        # The grid that the library gave the kernel's last launch (the timed
        # ones above, at this shape).
        blocks = rc.LAST_GRID[name]
        if tile == 32 and blocks <= num_tiles:
            raise RuntimeError(f"{name} launched {blocks} blocks for {num_tiles} tiles")
        result[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "max_abs_err": err, "blocks": blocks}
        print(f"[kernels] {label}: {name} {blocks} blocks, {ms:.4f} ms, plain {plain:.3f} ms, "
              f"bound {bound:.4f} ms ({result[name]['bound_by']}), share of the bound "
              f"{bound / ms:.3f}")
    return result


def check_kernels(seed: int, trainer) -> list:
    """K1 and K2 against their plain versions: on the synthetic 512^2 scene
    (the kernels' rows of the ``kernels`` line) and on the trainer's cloud at
    the shapes its step renders (the rows' ``shapes`` lists)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    synthetic = check_shape("synthetic 512^2", *main_path_scene(seed), seed, plain_reps=3)
    shapes = [check_shape(*shape, seed, plain_reps=1) for shape in trainer_shapes(trainer)]
    rows = []
    for name, line in (("composite_fwd", "dreamgaussian_tpu/ops/rasterize_pallas.py:211"),
                       ("composite_bwd", "dreamgaussian_tpu/ops/rasterize_pallas.py:323")):
        own = {k: v for k, v in synthetic[name].items() if k != "blocks"}
        rows.append({
            "name": name, "route": "cuda",
            "source": f"dreamgaussian_tpu_torch/csrc/{name}.cu", "replaces": line,
            "launches": None, **own, "library_ms": None, "blocks": synthetic[name]["blocks"],
            "shapes": [{**{k: v for k, v in sh.items() if not k.startswith("composite_")},
                        **sh[name]} for sh in shapes],
        })
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
        opt = Config({**image_options(), "load": ply})
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


def bake_view_inputs(mesh, fovy: float, radius: float, view: int):
    """The exported mesh under bake camera ``view`` at the bake's shape
    (512^2, tile 32, chunk 128), binned as ``rasterize`` bins it:
    (dup_feat, bins, geo)."""
    import numpy as np
    import torch

    from dreamgaussian_tpu_torch.meshing.export import BAKE_HORS, BAKE_VERS
    from dreamgaussian_tpu_torch.ops.binning import bin_rects
    from dreamgaussian_tpu_torch.ops.mesh_raster import triangle_features
    from dreamgaussian_tpu_torch.utils.camera import Camera, orbit_camera

    dev = torch.device("cuda")
    size, tile, chunk = EXPORT_SIZES["bake_resolution"], 32, 128
    grid_x, num_tiles = size // tile, (size // tile) ** 2
    cam = Camera.from_pose(orbit_camera(BAKE_VERS[view], BAKE_HORS[view], radius),
                           size, size, fovy, fovy)
    v = torch.as_tensor(mesh.v, dtype=torch.float32, device=dev)
    v_h = torch.cat([v, torch.ones((v.shape[0], 1), device=dev)], dim=1)
    v_clip = v_h @ torch.as_tensor(cam.arrays()["full_proj"], device=dev).T
    faces = torch.as_tensor(np.asarray(mesh.f), dtype=torch.int64, device=dev)
    feat_cols, xmin, ymin, xmax, ymax, ok = triangle_features(v_clip, faces, size, size, tile)
    bins = bin_rects(xmin, ymin, xmax, ymax, ok, grid_x=grid_x, num_tiles=num_tiles, chunk=chunk)
    dup_feat = feat_cols.index_select(1, bins.dup_map).contiguous()
    return dup_feat, bins, dict(grid_x=grid_x, num_tiles=num_tiles, chunk=chunk, tile=tile)


def ztest_bound_ms(dup_feat, bins, geo: dict) -> tuple:
    """K3's bound from this view's data: (ms, "bytes" or "operations",
    bytes, operations, real slots, box pairs, covering pairs)."""
    slots, box_pairs, cover_pairs = ztest_pair_work(dup_feat, bins, **geo)
    num_tiles, tile = geo["num_tiles"], geo["tile"]
    byts = slots * 40 + 8 * num_tiles + num_tiles * tile * tile * 8
    flops = box_pairs * K3_FLOPS_PER_BOX_PAIR + cover_pairs * K3_FLOPS_PER_COVER_PAIR
    t_bytes = byts / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", byts, flops,
            slots, box_pairs, cover_pairs)


def ztest_built_with(extra: tuple):
    """K3 through its wrapper, with the library built with ``extra`` flags
    (a timing variant) in the shipped one's place."""
    import functools

    from dreamgaussian_tpu_torch.ops import cuda_build
    from dreamgaussian_tpu_torch.ops import mesh_raster_cuda as mr

    load = functools.partial(cuda_build.load, extra=extra)

    def run(*args, **geo):
        shipped = cuda_build.load
        cuda_build.load = load
        try:
            return mr.ztest(*args, **geo)
        finally:
            cuda_build.load = shipped
    return run


def check_ztest(mesh, fovy: float, radius: float) -> dict:
    """K3 against its plain version at the bake's shape under each of the 26
    bake cameras: ids and z equal on every pixel, the launched grid, time
    and bound per view. At view 9 also the plain version's time, the build
    without the sift against the shipped one (in turns: a, b, b, a) and the
    empty-list floor (the same launch with every list empty). K3's times are
    device times (``graph_ms``): back to back through the wrapper a launch
    this short is timed by the host's work between launches."""
    import torch

    from dreamgaussian_tpu_torch.meshing.export import BAKE_VERS
    from dreamgaussian_tpu_torch.ops import mesh_raster_cuda as mr

    views = []
    for view in range(len(BAKE_VERS)):
        dup_feat, bins, geo = bake_view_inputs(mesh, fovy, radius, view)
        cs, nc = bins.chunk_starts, bins.n_chunks
        before = mr.LAUNCHES["ztest"]
        mr.LAST_GRID["ztest"] = 0
        ids, z = mr.ztest(dup_feat, cs, nc, **geo)
        blocks = mr.LAST_GRID["ztest"]
        r_ids, r_z = mr.ztest_ref(dup_feat, cs, nc, **geo)
        torch.cuda.synchronize()
        if mr.LAUNCHES["ztest"] != before + 1:
            raise RuntimeError("the K3 wrapper did not count its launch")
        differing = int((ids != r_ids).sum())
        z_differing = int((z != r_z).sum())
        covered = float((r_ids > 0).float().mean())
        ms = graph_ms(lambda: mr.ztest(dup_feat, cs, nc, **geo))
        bound, bound_by, byts, flops, slots, box_pairs, cover_pairs = ztest_bound_ms(
            dup_feat, bins, geo)
        print(f"[kernels] K3 view {view}: {int(bins.num_dups)} duplicates, {int(nc.sum())} "
              f"chunks (longest tile {int(nc.max())}), grid {blocks} blocks, pixels covered "
              f"{covered:.3f}, pixels with another id {differing}, with another z "
              f"{z_differing}; {ms:.4f} ms, bound {bound:.5f} ms ({bound_by}), share of the "
              f"bound {bound / ms:.4f}")
        if differing or z_differing or blocks <= 0:
            raise RuntimeError(f"K3 disagrees with its plain version at bake view {view}")
        views.append({"view": view, "duplicates": int(bins.num_dups), "chunks": int(nc.sum()),
                      "longest_tile_chunks": int(nc.max()), "blocks": blocks, "ms": ms,
                      "bound_ms": bound, "share": bound / ms})
        if view != K3_BAKE_VIEW:
            continue
        if covered < 0.05:
            raise RuntimeError(f"bake view {view} covers {covered:.3f} of the frame")
        row = {"ms": ms, "bound_ms": bound, "bound_by": bound_by, "blocks": blocks}
        row["plain_ms"] = cuda_ms(lambda: mr.ztest_ref(dup_feat, cs, nc, **geo), 3, 1)
        no_sift = ztest_built_with(("-DZTEST_SIFT=0",))
        if not all(torch.equal(a, b) for a, b in zip(no_sift(dup_feat, cs, nc, **geo), (ids, z))):
            raise RuntimeError("K3 built without the sift gives other bits")
        turns = []
        for fn in (mr.ztest, no_sift, no_sift, mr.ztest):
            turns.append(graph_ms(lambda: fn(dup_feat, cs, nc, **geo)))
        row["shipped_ms_turns"] = [turns[0], turns[3]]
        row["no_sift_ms_turns"] = [turns[1], turns[2]]
        empty = torch.zeros_like(nc)
        e_ids, e_z = mr.ztest(dup_feat, cs, empty, **geo)
        if bool(e_ids.any()) or bool(e_z.any()):
            raise RuntimeError("K3 with empty lists wrote a winner")
        row["empty_ms"] = graph_ms(lambda: mr.ztest(dup_feat, cs, empty, **geo))
        # Back to back through the wrapper, host work between the launches
        # included: what the bake's loop pays per call.
        row["wrapper_ms"] = cuda_ms(lambda: mr.ztest(dup_feat, cs, nc, **geo), 20)
        print(f"[kernels] K3 work at view {view}: {slots} real slots, {box_pairs} (pixel, "
              f"triangle) pairs inside a bounding box of {slots * geo['tile'] ** 2} in the "
              f"tiles' lists, {cover_pairs} covering; {byts} bytes, {flops} operations")
        print(f"[kernels] ztest at view {view}: {ms:.4f} ms, plain {row['plain_ms']:.3f} ms, "
              f"bound {bound:.5f} ms ({bound_by}); in turns shipped / without the sift / "
              f"without / shipped {turns[0]:.4f} / {turns[1]:.4f} / {turns[2]:.4f} / "
              f"{turns[3]:.4f} ms; empty lists {row['empty_ms']:.4f} ms; through the wrapper "
              f"back to back {row['wrapper_ms']:.4f} ms; LAST_GRID {json.dumps(mr.LAST_GRID)}")
    return {
        "name": "ztest", "route": "cuda", "source": "dreamgaussian_tpu_torch/csrc/ztest.cu",
        "replaces": "dreamgaussian_tpu/ops/mesh_raster_pallas.py:48", "launches": None,
        "max_abs_err": 0.0, **row, "library_ms": None, "views": views,
    }


# Stage-2 steps driven on the full-width mesh (iters_refine 50, refine_steps
# 50): steps 1-4 start the DDIM tail at step 40 (10 UNet calls), step 25 at
# 43 (7), steps 47-49 at 47 (3). Steps 4 and 49 run under torch.profiler.
STAGE2_OPTIONS = {"novel_resolution": 512, "refine_steps": 50, "phase_timing": True}
STAGE2_STEPS = (1, 2, 3, 4, 25, 47, 48, 49)
STAGE2_PROFILED = (4, 49)
# The stage-2 z-test shapes: the known view at ref_size (and the target
# render, 256^2 as well: SSAA 0.5 of 512) and the novel view at each SSAA choice.
STAGE2_NOVEL_VIEW = (-15.0, 60.0)
# The CLIs' run: a few tens of stage-1 steps on the fake guidance, the
# export at the smoke run's sizes but a 256^2 texture and bake, 3 stage-2 steps.
CLI_OVERRIDES = {"iters": 30, "iters_refine": 3, "fake_guidance": True, "density_thresh": 0.2,
                 "mc_resolution": 128, "decimate_target": 100_000, "texture_size": 256,
                 "bake_resolution": 256}


def labelled(fn, name: str):
    """``fn`` inside a ``torch.profiler`` range called ``name``."""
    from torch.profiler import record_function

    def run(*args, **kw):
        with record_function(name):
            return fn(*args, **kw)
    return run


def range_device_ms(prof, names) -> dict:
    """Device time of the kernels launched inside each named range, in ms."""
    from torch.autograd import DeviceType

    out = {n: 0.0 for n in names}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in out:
            out[ev.name] += ev.device_time_total / 1e3
    return out


def kernel_groups(by_name: dict) -> dict:
    """Device ms of a profile's kernels in the groups the stage-2 step is
    read by (a kernel in no group counts as other)."""
    groups = {"ztest (K3)": ("ztest",), "resize (upsample)": ("upsample",),
              "texture scatter (index_add)": ("indexfunclargeindex", "indexfuncsmallindex"),
              "gathers": ("gather", "index_elementwise"),
              "layout transposes": ("nchwtonhwc", "nhwctonchw", "tensortransform"),
              "conv/gemm": ("conv", "gemm", "xmma", "cutlass", "cudnn", "sm90"),
              "group norm": ("moments", "norm"), "elementwise and casts": ("elementwise",)}
    out = {g: 0.0 for g in groups}
    out["other"] = 0.0
    for name, ms in by_name.items():
        low = name.lower()
        group = next((g for g, keys in groups.items() if any(k in low for k in keys)), "other")
        out[group] += ms
    return {k: round(v, 3) for k, v in out.items()}


def run_stage2(seed: int, card: str, mesh, guidance) -> dict:
    """Stage2Trainer at configs/image.yaml's stage-2 keys on the exported
    mesh with the stage-1 phase's full-width Zero123 guidance (UNet, VAE
    encoder and decoder): the steps of STAGE2_STEPS, two of them profiled,
    then the refined mesh written as OBJ and read back."""
    import copy

    import numpy as np
    import torch

    from dreamgaussian_tpu_torch.guidance.sds import refine_init_step
    from dreamgaussian_tpu_torch.meshing.mesh import Mesh
    from dreamgaussian_tpu_torch.ops import mesh_raster_cuda, rasterize_cuda
    from dreamgaussian_tpu_torch.train import Stage2Trainer
    from dreamgaussian_tpu_torch.train.stage2 import SSAA_CHOICES
    from dreamgaussian_tpu_torch.utils.config import Config

    opt = Config({**image_options(), **STAGE2_OPTIONS})
    rgb, mask = disc_rgba(opt["ref_size"], seed)
    unet_calls = [0]
    hook = guidance.unet.register_forward_hook(lambda *_: unet_calls.__setitem__(0, unet_calls[0] + 1))
    guidance.unet.forward = labelled(guidance.unet.forward, "unet")
    guidance.vae.encode = labelled(guidance.vae.encode, "vae_encode")
    guidance.vae.decode = labelled(guidance.vae.decode, "vae_decode")
    entry = (opt["lambda_zero123"], guidance.refine_fn(steps=opt["refine_steps"]))
    trainer = Stage2Trainer(opt, copy.deepcopy(mesh), ref_rgb=rgb, ref_mask=mask,
                            refine_fns=(entry,), refine_image_size=guidance.image_size,
                            seed=seed, device="cuda")
    trainer._targets = labelled(trainer._targets, "target_phase")
    # The renderer's stages as ranges too (their forward kernels only: the
    # backward runs on autograd's thread, outside any range).
    from dreamgaussian_tpu_torch.render import mesh_renderer
    stages = ("rasterize", "sample_texture_mip", "antialias", "scale_img")
    shipped = {name: getattr(mesh_renderer, name) for name in stages}
    for name in stages:
        setattr(mesh_renderer, name, labelled(shipped[name], name))
    raw0 = trainer.params["raw_albedo"].clone()
    for counts in (rasterize_cuda.LAUNCHES, mesh_raster_cuda.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, profiles = [], []
    for step in STAGE2_STEPS:
        trainer.step = step - 1
        before = mesh_raster_cuda.LAUNCHES["ztest"]
        unet_calls[0] = 0
        # The SSAA factor the step draws first from its generator.
        ssaa = SSAA_CHOICES[int(copy.deepcopy(trainer.rng).integers(0, len(SSAA_CHOICES)))]
        torch.cuda.synchronize()
        t = time.perf_counter()
        if step in STAGE2_PROFILED:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                loss = float(trainer.train_step())
                torch.cuda.synchronize()
        else:
            loss = float(trainer.train_step())
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        target_s, grad_s = trainer.phase_times[-1]
        k3 = mesh_raster_cuda.LAUNCHES["ztest"] - before
        strength = np.float32(min(1.0, step / opt["iters_refine"]) * 0.15 + 0.8)
        expected_calls = opt["refine_steps"] - refine_init_step(opt["refine_steps"], strength)
        row = {"step": step, "ssaa": ssaa, "unet_calls": unet_calls[0],
               "target_ms": target_s * 1e3, "grad_ms": grad_s * 1e3, "ms": ms, "loss": loss,
               "k3_launches": k3}
        print(f"[stage2] step {step}: SSAA {row['ssaa']}, UNet calls {unet_calls[0]}, target "
              f"phase {row['target_ms']:.1f} ms, grad phase {row['grad_ms']:.1f} ms, step "
              f"{ms:.1f} ms, loss {loss:.6f}, K3 launches {k3}")
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite stage-2 loss at step {step}")
        if k3 != 3:
            raise RuntimeError(f"stage-2 step {step} launched K3 {k3} times, not 3")
        if unet_calls[0] != expected_calls:
            raise RuntimeError(f"stage-2 step {step} ran the UNet {unet_calls[0]} times, "
                               f"not {expected_calls}")
        rows.append(row)
        if step in STAGE2_PROFILED:
            by_name = device_ms_by_name(prof)
            busy = sum(by_name.values())
            ranges = range_device_ms(prof, ("unet", "vae_encode", "vae_decode", "target_phase")
                                     + stages)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
            launched = sum(ev.count for ev in prof.key_averages() if ev.key == "cudaLaunchKernel")
            report = {"step": step, "wall_ms_under_profiler": ms, "device_busy_ms": busy,
                      "idle_share_under_profiler": 1.0 - busy / ms,
                      "target_phase_device_ms": ranges["target_phase"],
                      "grad_phase_device_ms": busy - ranges["target_phase"],
                      "unet_ms": ranges["unet"], "vae_encode_ms": ranges["vae_encode"],
                      "vae_decode_ms": ranges["vae_decode"],
                      "render_forward_ms": {k: ranges[k] for k in stages},
                      "groups": kernel_groups(by_name),
                      "kernels_launched": launched,
                      "top": [(k[:60], round(v, 3)) for k, v in top]}
            print(f"[profile] stage2 {json.dumps(report)}")
            kernels = sorted(((k[:100], round(v, 4)) for k, v in by_name.items()),
                             key=lambda kv: -kv[1])
            print(f"[profile] stage2 step {step} kernels {json.dumps(kernels)}")
            profiles.append(report)
    hook.remove()
    for name in stages:
        setattr(mesh_renderer, name, shipped[name])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(mesh_raster_cuda.LAUNCHES)
    changed = float((trainer.params["raw_albedo"] - raw0).abs().max())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "refined.obj")
        out = trainer.export_mesh(path)
        back = Mesh.load(path, resize=False)
    if not (np.array_equal(back.f, out.f) and np.abs(back.v - out.v).max() <= 1e-6
            and np.abs(back.albedo - np.clip(out.albedo, 0, 1)).max() <= 1 / 255):
        raise RuntimeError("the refined OBJ did not read back as written")
    if not changed > 0:
        raise RuntimeError("stage 2 did not change the texture")
    medians = {k: statistics.median(r[k] for r in rows[1:]) for k in ("target_ms", "grad_ms", "ms")}
    print(f"[stage2] {len(rows)} steps on the exported mesh ({len(out.v)} vertices, "
          f"{len(out.f)} faces, texture {out.albedo.shape[0]}^2); medians without the first "
          f"step {json.dumps({k: round(v, 1) for k, v in medians.items()})}; largest texture "
          f"logit change {changed:.4f}; K3 launches {launches['ztest']}; peak memory "
          f"{peak_gib:.2f} GiB; refined OBJ read back; card '{card}'")
    return {"steps": rows, "profiles": profiles, "peak_gib": peak_gib,
            "launches": launches["ztest"], "trainer": trainer}


def stage2_ztest_inputs(trainer) -> list:
    """The z-test inputs of the stage-2 renders at each shape, taken from
    ``render_mesh`` itself: the known view at ref_size^2 and one novel view
    at every SSAA choice. Returns [(label, dup_feat, bins, geo)]."""
    import types

    import torch

    from dreamgaussian_tpu_torch.ops import mesh_raster
    from dreamgaussian_tpu_torch.train.stage2 import SSAA_CHOICES
    from dreamgaussian_tpu_torch.utils.camera import Camera, orbit_camera

    seen = []
    shipped = mesh_raster.ztest

    def capture(dup_feat, chunk_starts, n_chunks, **geo):
        seen.append((dup_feat, types.SimpleNamespace(chunk_starts=chunk_starts,
                                                     n_chunks=n_chunks), geo))
        return shipped(dup_feat, chunk_starts, n_chunks, **geo)

    size = trainer.render_resolution
    novel = Camera.from_pose(orbit_camera(trainer.elevation + STAGE2_NOVEL_VIEW[0],
                                          STAGE2_NOVEL_VIEW[1], trainer.radius),
                             size, size, trainer.fovy, trainer.fovy)
    shapes = [("known view", trainer.fixed_cam, trainer.ref_size, 1.0)]
    shapes += [(f"novel view SSAA {s}", novel, size, s) for s in SSAA_CHOICES]
    mesh_raster.ztest = capture
    try:
        out = []
        for label, cam, sz, ssaa in shapes:
            with torch.no_grad():
                trainer._render(cam, sz, ssaa)
            dup_feat, bins, geo = seen[-1]
            side = int(round(math.sqrt(geo["num_tiles"]))) * geo["tile"]
            out.append((f"{label} {side}^2", dup_feat, bins, geo))
    finally:
        mesh_raster.ztest = shipped
    return out


def check_ztest_stage2(trainer) -> list:
    """K3 against its plain version at the five stage-2 shapes: ids and z
    equal on every pixel, the grid, device ms from a CUDA graph, the bound."""
    import torch

    from dreamgaussian_tpu_torch.ops import mesh_raster_cuda as mr

    rows = []
    for label, dup_feat, bins, geo in stage2_ztest_inputs(trainer):
        cs, nc = bins.chunk_starts, bins.n_chunks
        mr.LAST_GRID["ztest"] = 0
        ids, z = mr.ztest(dup_feat, cs, nc, **geo)
        blocks = mr.LAST_GRID["ztest"]
        r_ids, r_z = mr.ztest_ref(dup_feat, cs, nc, **geo)
        torch.cuda.synchronize()
        differing, z_differing = int((ids != r_ids).sum()), int((z != r_z).sum())
        covered = float((r_ids > 0).float().mean())
        ms = graph_ms(lambda: mr.ztest(dup_feat, cs, nc, **geo))
        bound, bound_by, byts, flops, slots, box_pairs, cover_pairs = ztest_bound_ms(
            dup_feat, bins, geo)
        quads = geo["num_tiles"] * (geo["tile"] // 16) ** 2
        print(f"[kernels] K3 stage 2 {label}: {geo['num_tiles']} tiles, {quads} quadrants, "
              f"{int(nc.sum())} chunks (longest tile {int(nc.max())}), {slots} real slots, "
              f"grid {blocks} blocks, pixels covered {covered:.3f}, pixels with another id "
              f"{differing}, with another z {z_differing}; {ms:.4f} ms, bound {bound:.5f} ms "
              f"({bound_by}), share of the bound {bound / ms:.4f}")
        if differing or z_differing or blocks <= 0:
            raise RuntimeError(f"K3 disagrees with its plain version at stage-2 shape {label}")
        rows.append({"label": label, "tiles": geo["num_tiles"], "chunks": int(nc.sum()),
                     "longest_tile_chunks": int(nc.max()), "blocks": blocks, "ms": ms,
                     "bound_ms": bound, "bound_by": bound_by, "share": bound / ms})
    return rows


def write_disc_png(path: str, size: int, seed: int) -> None:
    """The disc reference as an RGBA PNG (alpha from the mask)."""
    import numpy as np

    from dreamgaussian_tpu_torch.utils.png import write_png

    rgb, mask = disc_rgba(size, seed)
    rgba = np.concatenate([rgb, mask[..., None]], -1)
    write_png(path, np.round(np.clip(rgba, 0, 1) * 255).astype(np.uint8))


@contextlib.contextmanager
def tapped(module, name: str, calls: list, last_grid: dict, key: str):
    """``module.<name>``, a kernel's wrapper as its caller imported it,
    keeps each call's arguments, result and launched grid in ``calls``
    (references: the main path's tensors, held after it has run)."""
    shipped = getattr(module, name)

    def run(*args, **geo):
        out = shipped(*args, **geo)
        calls.append({"args": args, "geo": geo, "out": out, "blocks": last_grid[key]})
        return out
    setattr(module, name, run)
    try:
        yield
    finally:
        setattr(module, name, shipped)


def render_side(geo: dict) -> int:
    return int(round(math.sqrt(geo["num_tiles"]))) * geo["tile"]


def hold_composite_calls(phase: str, fwd: list, bwd: list) -> dict:
    """K1 and K2 at every call a CLI made, against their plain versions on
    the same inputs, with check_shape's gates; one row per kernel and
    render size: calls and the largest error."""
    import torch

    from dreamgaussian_tpu_torch.ops import rasterize_cuda as rc

    rows: dict = {"composite_fwd": {}, "composite_bwd": {}}
    for name, calls in (("composite_fwd", fwd), ("composite_bwd", bwd)):
        for c in calls:
            side = render_side(c["geo"])
            args, out = [a.detach() for a in c["args"]], c["out"].detach()
            with torch.no_grad():
                if name == "composite_fwd":
                    ref = rc.composite_forward_ref(*args, **c["geo"])
                    err = float((out[:, :5] - ref[:, :5]).abs().max())
                    ok = err <= 1e-3 and float((out[:, 5] != ref[:, 5]).float().mean()) <= 1e-3
                else:
                    ref = rc.composite_backward_ref(*args, **c["geo"])
                    err = float((out - ref).abs().max())
                    ok = grad_rows_agree(out, ref, K2_RTOL, K2_ATOL, verbose=False)
            if not ok:
                raise RuntimeError(f"{name} disagrees with its plain version at a {side}^2 "
                                   f"call of the CLI's {phase}")
            row = rows[name].setdefault(side, {"phase": phase, "label": f"{side}^2", "calls": 0,
                                               "max_abs_err": 0.0, "blocks": c["blocks"]})
            row["calls"] += 1
            row["max_abs_err"] = max(row["max_abs_err"], err)
    return {k: list(v.values()) for k, v in rows.items()}


def hold_ztest_calls(phase: str, calls: list) -> list:
    """K3 at every call a CLI made, against its plain version: ids and z
    equal at every pixel. One row per render size: calls, and at its first
    call the grid, device ms from a CUDA graph and the bound."""
    import types

    import torch

    from dreamgaussian_tpu_torch.ops import mesh_raster_cuda as mr

    rows: dict = {}
    for c in calls:
        (dup_feat, cs, nc), geo, (ids, z) = c["args"], c["geo"], c["out"]
        r_ids, r_z = mr.ztest_ref(dup_feat, cs, nc, **geo)
        side = render_side(geo)
        if not (torch.equal(ids, r_ids) and torch.equal(z, r_z)):
            raise RuntimeError(f"K3 disagrees with its plain version at a {side}^2 call of the "
                               f"CLI's {phase}")
        if side in rows:
            rows[side]["calls"] += 1
            continue
        ms = graph_ms(lambda: mr.ztest(dup_feat, cs, nc, **geo))
        bins = types.SimpleNamespace(chunk_starts=cs, n_chunks=nc)
        bound, bound_by, *_ = ztest_bound_ms(dup_feat, bins, geo)
        rows[side] = {"phase": phase, "label": f"{side}^2", "calls": 1, "max_abs_err": 0.0,
                      "tiles": geo["num_tiles"],
                      "chunks": int(nc.sum()), "longest_tile_chunks": int(nc.max()),
                      "blocks": c["blocks"], "ms": ms, "bound_ms": bound, "bound_by": bound_by,
                      "share": bound / ms}
    return list(rows.values())


def drive_cli(label: str, cli, argv: list, runs: dict) -> dict:
    """``cli.main(argv)`` with every kernel count set to 0 just before it and
    read just after, and every kernel call kept (``tapped``); records the
    run's calls, launches and seconds in ``runs[label]`` and returns the
    CLI's stats."""
    import torch

    from dreamgaussian_tpu_torch.ops import mesh_raster, mesh_raster_cuda, rasterize, rasterize_cuda

    fwd, bwd, zt = [], [], []
    for counts in (rasterize_cuda.LAUNCHES, mesh_raster_cuda.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    with (tapped(rasterize, "composite_forward", fwd, rasterize_cuda.LAST_GRID, "composite_fwd"),
          tapped(rasterize, "composite_backward", bwd, rasterize_cuda.LAST_GRID, "composite_bwd"),
          tapped(mesh_raster, "ztest", zt, mesh_raster_cuda.LAST_GRID, "ztest")):
        stats = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {**rasterize_cuda.LAUNCHES, **mesh_raster_cuda.LAUNCHES}
    if [len(fwd), len(bwd), len(zt)] != [launches[k] for k in
                                          ("composite_fwd", "composite_bwd", "ztest")]:
        raise RuntimeError(f"the CLI run {label} launched a kernel outside its caller")
    runs[label] = {"calls": (fwd, bwd, zt), "launches": launches, "wall_s": wall}
    print(f"[cli] {label}: {wall:.1f} s, launches {json.dumps(launches)}")
    return stats


def hold_cli_calls(runs: dict, tag: str) -> dict:
    """Every K1, K2 and K3 call of the CLI runs in ``runs`` held against its
    plain version (``hold_composite_calls``, ``hold_ztest_calls``); prints a
    line per kernel and render size and returns the rows per kernel."""
    shapes: dict = {"composite_fwd": [], "composite_bwd": [], "ztest": []}
    for label, run in runs.items():
        fwd, bwd, zt = run["calls"]
        for k, rows in hold_composite_calls(label, fwd, bwd).items():
            shapes[k] += rows
        shapes["ztest"] += hold_ztest_calls(label, zt)
    for k, rows in shapes.items():
        for row in rows:
            extra = (f", grid {row['blocks']} blocks, {row['chunks']} chunks (longest tile "
                     f"{row['longest_tile_chunks']}), {row['ms']:.4f} ms, bound "
                     f"{row['bound_ms']:.5f} ms ({row['bound_by']}), share of the bound "
                     f"{row['share']:.4f}" if k == "ztest" else f", grid {row['blocks']} blocks")
            print(f"[kernels] {k} in the {tag} {row['phase']} at {row['label']}: {row['calls']} "
                  f"calls held against the plain version, max abs err "
                  f"{row['max_abs_err']:.3e}{extra}")
    return shapes


def read_outputs(outdir: str, save_path: str, texture_size: int, capacity: int) -> tuple:
    """The stage-1 PLY and both meshes of a CLI pair read back and checked:
    (gaussians, stage-1 mesh faces)."""
    import numpy as np
    import torch

    from dreamgaussian_tpu_torch.meshing.mesh import Mesh
    from dreamgaussian_tpu_torch.scene import load_ply

    params, aux, _ = load_ply(os.path.join(outdir, f"{save_path}_model.ply"), capacity=capacity,
                              device="cuda")
    n = int(aux.alive.sum())
    if n == 0 or not all(bool(torch.isfinite(v[:n]).all()) for v in params.values()):
        raise RuntimeError(f"the CLI's {save_path} PLY did not read back as a finite cloud")
    meshes = {f: Mesh.load(os.path.join(outdir, f), resize=False)
              for f in (f"{save_path}_mesh.obj", f"{save_path}.obj")}
    for f, m in meshes.items():
        if (len(m.f) == 0 or not np.isfinite(m.v).all() or m.albedo is None
                or m.albedo.shape != (texture_size,) * 2 + (3,)):
            raise RuntimeError(f"the CLI's {f} did not read back as a textured mesh")
    stage1, refined = meshes.values()
    if not np.array_equal(refined.f, stage1.f):
        raise RuntimeError("stage 2 changed the stage-1 mesh's faces")
    return n, len(stage1.f)


def run_cli(seed: int, card: str) -> dict:
    """``python -m dreamgaussian_tpu_torch.cli.main --config configs/image.yaml``
    and then ``cli.main2`` (through their ``main(argv)``) on the card with the
    fake guidance on a disc RGBA PNG; reads every output back. Every kernel
    call the CLIs make is kept and, after both have run, held against its
    plain version; returns the launch counts of the two runs and the rows of
    the shapes the CLIs gave each kernel."""
    from dreamgaussian_tpu_torch.cli import main as cli1
    from dreamgaussian_tpu_torch.cli import main2 as cli2

    runs: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "disc.png")
        write_disc_png(png, 512, seed)
        argv = ["--config", os.path.join(CONFIGS, "image.yaml"), f"input={png}",
                "save_path=smoke", f"outdir={tmp}", f"seed={seed}",
                *(f"{k}={v}" for k, v in CLI_OVERRIDES.items())]
        drive_cli("main", cli1, argv, runs)
        drive_cli("main2", cli2, argv, runs)
        n, faces = read_outputs(tmp, "smoke", CLI_OVERRIDES["texture_size"],
                                image_options()["capacity"])
        files = sorted(os.listdir(tmp))
    launches = {k: v["launches"] for k, v in runs.items()}
    # main: the stage-1 steps (K1, K2) and the export's 26 bake views (K1,
    # K3); main2: three renders (K3) per stage-2 step.
    k3_main2 = 3 * CLI_OVERRIDES["iters_refine"]
    if (min(launches["main"].values()) < 1 or launches["main"]["ztest"] != 26
            or launches["main2"]["ztest"] != k3_main2):
        raise RuntimeError(f"the CLIs did not go through the kernels: {launches}")
    walls = {k: v["wall_s"] for k, v in runs.items()}
    print(f"[cli] main {walls['main']:.1f} s, main2 {walls['main2']:.1f} s; {n} gaussians in "
          f"the PLY; stage-1 mesh {faces} faces; files {json.dumps(files)}; card '{card}'")
    shapes = hold_cli_calls(runs, "CLI's")
    total = {k: sum(v[k] for v in launches.values()) for k in launches["main"]}
    return {"wall_s": walls, "gaussians": n, "faces": faces, "launches": total,
            "shapes": shapes}


# The weights-day run: a full-width Zero123 snapshot (ZERO123_CONFIG's UNet,
# the KL-VAE, the CLIP ViT-L/14 vision tower and the 772 -> 768 camera
# projection: about 1.25 B values) written as fp16 safetensors and loaded
# strictly; then the documented commands on it: stage 1 stopped at its first
# checkpoint (step 8, after the densify at step 4), resumed to step 12 with
# the export at configs/image.yaml's sizes, stage 2 for two steps, and
# configs/image_sai.yaml (stable-zero123) for four steps without the export.
WEIGHTS_STOP, WEIGHTS_ITERS, WEIGHTS_REFINE, SAI_ITERS = 8, 12, 2, 4
WEIGHTS_ARGS = ["density_start_iter=4", "densification_interval=4"]
# CLIP image_embeds on the card against the CPU on the same weights and image:
# float32 on both (the patch embedding is a matmul: no TF32 convolution), 24
# blocks summed in other orders; largest |difference| over the largest
# |embedding|. Sound float32 runs differ by about 1.2e-6 of it; a TF32 matmul
# or convolution would miss by about 1e-3.
CLIP_REL_TOL = 1e-5


# A loader alone in a process of its own, started when chip_smoke.py is still
# small: a child's peak RSS (getrusage) starts at its parent's RSS when it is
# started, so the measurement cannot be started from a phase. It imports torch,
# then waits for its arguments on stdin, one a line: "zero123", the snapshot,
# the reference PNG and ref_size; "mvdream", the LDM file and the prompt; or
# "imagedream", the ipmv file, the reference PNG and ref_size. It starts CUDA,
# cuBLAS and cuDNN (a convolution and a matmul in both dtypes), loads, and
# prints its peak RSS before and after the load as one JSON line.
LOAD_ALONE = """
import json, resource, sys, time
import torch
from dreamgaussian_tpu_torch.cli.main import load_reference
from dreamgaussian_tpu_torch.guidance import loader
from dreamgaussian_tpu_torch.utils.config import Config
kind, *args = sys.stdin.read().splitlines()
for dt in (torch.float32, torch.bfloat16):
    x = torch.ones(1, 4, 8, 8, device="cuda", dtype=dt)
    torch.nn.functional.conv2d(x, x[:, :, :3, :3].expand(4, 4, 3, 3))
    x.reshape(16, 16) @ x.reshape(16, 16)
if kind == "zero123":
    rgb, _ = load_reference(Config(input=args[1], ref_size=int(args[2])))
    load = lambda: loader.load_zero123(args[0], ref_image=rgb, device="cuda")
elif kind == "imagedream":
    rgb, _ = load_reference(Config(input=args[1], ref_size=int(args[2])))
    load = lambda: loader.load_imagedream(args[0], rgb, "", device="cuda")
else:
    load = lambda: loader.load_mvdream(args[0], args[1], device="cuda")
torch.cuda.synchronize()
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
t = time.perf_counter()
g = load()
torch.cuda.synchronize()
print(json.dumps({"load_s": time.perf_counter() - t, "peak_before": before,
                  "peak_after": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
                  "unet_fp32": 4 * sum(p.numel() for p in g.unet.parameters())}))
"""


@contextlib.contextmanager
def load_alone_process():
    """``LOAD_ALONE`` started now, and stopped on leaving."""
    proc = subprocess.Popen([sys.executable, "-c", LOAD_ALONE], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def load_host_peak(proc: subprocess.Popen, args: list) -> dict:
    """``LOAD_ALONE``'s reading for ``args`` (its stdin lines); fails if the
    load raised its peak RSS by as much as a float32 copy of the UNet."""
    out, _ = proc.communicate("\n".join(args) + "\n", timeout=600)
    if proc.returncode:
        raise RuntimeError(f"{args[0]} load in a process of its own exited {proc.returncode}")
    r = json.loads(out.strip().splitlines()[-1])
    r["rise"] = r["peak_after"] - r["peak_before"]
    if r["rise"] >= r["unet_fp32"]:
        raise RuntimeError(f"the {args[0]} load raised the host's peak RSS by {r['rise']} bytes, "
                           f"as much as a float32 copy of the UNet ({r['unet_fp32']} bytes)")
    return r


def trainer_state(trainer) -> dict:
    """A host copy of everything a stage-1 checkpoint holds."""
    state = {f"{group}_{k}": v.detach().cpu().clone()
             for group, tensors in (("p", trainer.params), ("mu", trainer.adam.mu),
                                    ("nu", trainer.adam.nu), ("aux", trainer.aux._asdict()))
             for k, v in tensors.items()}
    state.update(step=trainer.step, adam_count=int(trainer.adam.count),
                 np_rng=json.dumps(trainer.rng.bit_generator.state),
                 draw=bytes(trainer.draw.get_state()))
    return state


@contextlib.contextmanager
def kept_checkpoints(saved: list, restored: list, losses: list):
    """Stage1Trainer with each checkpoint's state kept as it is saved and as
    it is restored, and each step's loss kept."""
    from dreamgaussian_tpu_torch.train import Stage1Trainer

    shipped = {n: getattr(Stage1Trainer, n) for n in ("save_checkpoint", "load_checkpoint",
                                                      "train_step")}

    def save(self, path):
        out = shipped["save_checkpoint"](self, path)
        saved.append(trainer_state(self))
        return out

    def load(self, path):
        shipped["load_checkpoint"](self, path)
        restored.append(trainer_state(self))

    def step(self):
        loss = shipped["train_step"](self)
        losses.append(float(loss))
        return loss

    Stage1Trainer.save_checkpoint, Stage1Trainer.load_checkpoint = save, load
    Stage1Trainer.train_step = step
    try:
        yield
    finally:
        for n, fn in shipped.items():
            setattr(Stage1Trainer, n, fn)


def check_snapshot_load(snap: str, png: str, card: str, load_alone: subprocess.Popen) -> dict:
    """``load_zero123`` of the full-width snapshot on the card: seconds,
    peak device memory and, in ``load_alone`` (``LOAD_ALONE``), the rise of
    the host's peak RSS over the load (held below one float32 copy of the UNet: the file is
    mapped and copied tensor by tensor); every UNet and VAE parameter equal to its
    snapshot tensor cast to bf16 with no key left over; the camera
    projection; the CLIP tower on the card against the CPU."""
    import torch

    from dreamgaussian_tpu_torch.cli.main import load_reference
    from dreamgaussian_tpu_torch.guidance import convert, loader
    from dreamgaussian_tpu_torch.guidance.clip import clip_pixel_values, load_clip_vision
    from dreamgaussian_tpu_torch.utils.config import Config

    rgb, _ = load_reference(Config(input=png, ref_size=image_options()["ref_size"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    g = loader.load_zero123(snap, ref_image=rgb, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    host = load_host_peak(load_alone, ["zero123", snap, png, str(image_options()["ref_size"])])
    n_params = 0
    for module, sub, rename in ((g.unet, "unet", convert.unet_key),
                                (g.vae, "vae", convert.vae_key)):
        sd = convert.load_torch_state_dict(snap, sub)
        params = dict(module.named_parameters())
        if sorted(rename(k) for k in sd) != sorted(params):
            raise RuntimeError(f"the {sub} snapshot's keys and the module's parameters differ")
        for k, v in sd.items():
            p = params[rename(k)]
            if p.dtype != torch.bfloat16 or not torch.equal(p, v.to("cuda").to(torch.bfloat16)):
                raise RuntimeError(f"{sub} parameter {rename(k)} is not its snapshot tensor {k}")
            n_params += p.numel()
    w, b = convert.camera_projection(convert.load_torch_state_dict(snap, "clip_camera_projection"))
    if not (torch.equal(g.cam_proj[0].cpu(), w.float()) and torch.equal(g.cam_proj[1].cpu(),
                                                                       b.float())):
        raise RuntimeError("the camera projection is not the snapshot's")
    enc = os.path.join(snap, "image_encoder")
    pixels = clip_pixel_values(rgb, 224, "cpu")
    with torch.no_grad():
        on_cpu = load_clip_vision(enc, "cpu")(pixels)
        on_card = load_clip_vision(enc, "cuda")(pixels.cuda()).cpu()
    scale = float(on_cpu.abs().max())
    clip_err = float((on_card - on_cpu).abs().max())
    guide_err = float((g.clip_emb.cpu() - on_cpu).abs().max())
    if not (clip_err <= CLIP_REL_TOL * scale and guide_err <= CLIP_REL_TOL * scale):
        raise RuntimeError(f"CLIP image_embeds on the card miss the CPU's: {clip_err:.3e} "
                           f"(guidance {guide_err:.3e}) against {CLIP_REL_TOL} x {scale:.3e}")
    print(f"[weights] load_zero123 {load_s:.1f} s, peak device memory {peak_gib:.2f} GiB, "
          f"alone in a process of its own {host['load_s']:.1f} s and its host peak RSS "
          f"{host['peak_before'] / 2**30:.2f} -> {host['peak_after'] / 2**30:.2f} GiB, "
          f"a rise of {host['rise'] / 2**30:.2f} GiB (gate: under the UNet's float32 "
          f"{host['unet_fp32'] / 2**30:.2f} GiB); "
          f"{n_params} UNet and VAE weights equal to "
          f"the snapshot's cast to bf16, no key left over; CLIP image_embeds card against CPU "
          f"max abs err {clip_err:.3e} (guidance's {guide_err:.3e}, largest |embed| "
          f"{scale:.3e}, gate {CLIP_REL_TOL} of it); card '{card}'")
    return {"load_s": load_s, "load_peak_gib": peak_gib, "load_host_rise_gib": host["rise"] / 2**30}


def run_weights_day(seed: int, card: str, load_alone: subprocess.Popen) -> dict:
    """The full-width snapshot written, loaded and driven through both CLIs
    (see WEIGHTS_STOP); every kernel call of the CLI runs held against its
    plain version."""
    import torch

    from dreamgaussian_tpu_torch.cli import main as cli1
    from dreamgaussian_tpu_torch.cli import main2 as cli2
    from dreamgaussian_tpu_torch.guidance import synthetic
    from dreamgaussian_tpu_torch.guidance.unet import ZERO123_CONFIG
    from dreamgaussian_tpu_torch.guidance.vae import VAEConfig

    runs: dict = {}
    saved, restored, losses = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "zero123-snapshot")
        torch.cuda.synchronize()
        t = time.perf_counter()
        sizes = synthetic.write_zero123_snapshot(snap, ZERO123_CONFIG, VAEConfig(),
                                                 synthetic.CLIP_VIT_L14, dtype=torch.float16,
                                                 seed=seed, device="cuda")
        write_s = time.perf_counter() - t
        n_bytes = sum(nb for nb, _ in sizes.values())
        n_values = sum(nv for _, nv in sizes.values())
        print(f"[weights] full-width snapshot written in {write_s:.1f} s: {n_values} values, "
              f"{n_bytes} bytes of fp16 safetensors ({json.dumps(sizes)}); card '{card}'")
        png = os.path.join(tmp, "disc.png")
        write_disc_png(png, 512, seed)
        load = check_snapshot_load(snap, png, card, load_alone)

        ckpt = os.path.join(tmp, "ckpt")
        argv = ["--config", os.path.join(CONFIGS, "image.yaml"), f"input={png}",
                "save_path=weights", f"outdir={tmp}", f"seed={seed}", f"zero123_ckpt={snap}",
                f"checkpoint_dir={ckpt}", f"checkpoint_every={WEIGHTS_STOP}", *WEIGHTS_ARGS]
        with kept_checkpoints(saved, restored, losses):
            first = drive_cli("stage 1 to its checkpoint", cli1,
                              argv + [f"iters={WEIGHTS_STOP}", "save_mesh=False"], runs)
            resumed = drive_cli("stage 1 resumed, export", cli1,
                                argv + [f"iters={WEIGHTS_ITERS}", "resume=True"], runs)
            refined = drive_cli("stage 2", cli2,
                                argv + [f"iters={WEIGHTS_ITERS}", f"iters_refine={WEIGHTS_REFINE}"],
                                runs)
            sai = drive_cli("image_sai stage 1", cli1,
                            ["--config", os.path.join(CONFIGS, "image_sai.yaml"), f"input={png}",
                             "save_path=sai", f"outdir={tmp}", f"seed={seed}",
                             f"zero123_ckpt={snap}", f"iters={SAI_ITERS}", "save_mesh=False"],
                            runs)
        n, faces = read_outputs(tmp, "weights", image_options()["texture_size"],
                                image_options()["capacity"])
    if (first["step"], resumed["step"], sai["step"]) != (WEIGHTS_STOP, WEIGHTS_ITERS, SAI_ITERS):
        raise RuntimeError(f"stage-1 runs ended at steps {first['step']}, {resumed['step']}, "
                           f"{sai['step']}")
    if len(saved) != 1 or len(restored) != 1 or restored[0]["step"] != WEIGHTS_STOP:
        raise RuntimeError(f"expected one checkpoint at step {WEIGHTS_STOP} saved and restored, "
                           f"got {len(saved)} saved, {len(restored)} restored")
    differ = [k for k, v in saved[0].items() if not (
        torch.equal(v, restored[0][k]) if isinstance(v, torch.Tensor) else v == restored[0][k])]
    if differ:
        raise RuntimeError(f"the resumed trainer's state differs from the saved one in {differ}")
    n_steps = WEIGHTS_STOP + (WEIGHTS_ITERS - WEIGHTS_STOP) + SAI_ITERS
    if len(losses) != n_steps or not all(math.isfinite(x) for x in losses + [refined["loss"]]):
        raise RuntimeError(f"stage-1 losses {losses}, stage-2 loss {refined['loss']}")
    launches = {k: v["launches"] for k, v in runs.items()}
    k1k2 = ("composite_fwd", "composite_bwd")
    if (any(launches[k][name] < 1 for k in launches if "stage 1" in k for name in k1k2)
            or launches["stage 1 resumed, export"]["ztest"] != 26
            or launches["stage 2"]["ztest"] != 3 * WEIGHTS_REFINE):
        raise RuntimeError(f"the weights-day runs did not go through the kernels: {launches}")
    walls = {k: v["wall_s"] for k, v in runs.items()}
    print(f"[weights] checkpoint at step {WEIGHTS_STOP} restored bit for bit "
          f"({len(saved[0])} entries, both random states); resumed to step {WEIGHTS_ITERS}; "
          f"{n} gaussians in the PLY, stage-1 mesh {faces} faces; losses finite; CLI seconds "
          f"{json.dumps({k: round(v, 1) for k, v in walls.items()})}; card '{card}'")
    shapes = hold_cli_calls(runs, "weights-day")
    total = {k: sum(v[k] for v in launches.values()) for k in launches[next(iter(launches))]}
    print(f"[weights] launches {json.dumps(total)}; snapshot {write_s:.1f} s to write, "
          f"{load['load_s']:.1f} s to load, load peak {load['load_peak_gib']:.2f} GiB on the "
          f"card, {load['load_host_rise_gib']:.2f} GiB host RSS rise; "
          f"card '{card}'")
    return {"launches": total, "shapes": shapes}


# The text day: a full-width SD 2.1-base diffusers snapshot (SD21_CONFIG's
# UNet, the KL-VAE, the 23-layer CLIP text tower: about 1.29 B values) and a
# full-width MVDream LDM file (MVDREAM_CONFIG's UNet with its camera MLP, the
# VAE, the 24-block OpenCLIP ViT-H tower: about 1.31 B values), fp16, written,
# loaded and driven: stage-1 steps at each rung (the first of a rung a warm-up,
# none a densify step under the configs' interval of 50), then both CLIs.
TEXT_PROMPT, TEXT_NEGATIVE = "a hamburger", "ugly, blurry, low quality"
TEXT_RUNG_STEPS = {128: range(1, 5), 256: range(201, 205), 512: range(301, 305)}
TEXT_PROFILED_STEP = 305
# CLI runs: 8 stage-1 steps (the ladder's three rungs), the export at the
# configs' sizes, 2 stage-2 steps; final_prune=False keeps the short run's
# cloud for the export (the JAX trainer's option for short runs).
TEXT_ITERS, TEXT_REFINE = 8, 2
TEXT_CLI_ARGS = [f"prompt={TEXT_PROMPT}", f"negative_prompt={TEXT_NEGATIVE}",
                 f"iters={TEXT_ITERS}", f"iters_refine={TEXT_REFINE}", "final_prune=False"]
PRIORS = {   # config, views per sampled camera, UNet batch (CFG x views), latent side
    "sd": ("text.yaml", 1, 2, 64),
    "mvdream": ("text_mv.yaml", 4, 8, 32),
    "imagedream": ("imagedream.yaml", 4, 10, 32),     # each group of 4 with its identity view
}
TEXT_PRIORS = ("sd", "mvdream")


@contextlib.contextmanager
def counted_unet_calls(calls: list):
    """Every UNet call's input shape kept in ``calls`` (the CLI builds its
    own guidance, so the class's forward is wrapped)."""
    from dreamgaussian_tpu_torch.guidance.unet import UNet

    shipped = UNet.forward

    def forward(self, sample, *args, **kw):
        calls.append(tuple(sample.shape))
        return shipped(self, sample, *args, **kw)
    UNet.forward = forward
    try:
        yield
    finally:
        UNet.forward = shipped


def text_options(prior: str):
    from dreamgaussian_tpu_torch.utils.config import load

    return dict(load(os.path.join(CONFIGS, PRIORS[prior][0])))


def check_text_load(prior: str, path: str, card: str, load_alone, png: str = "") -> tuple:
    """The prior loaded on the card from its file(s) (ImageDream's on the
    reference ``png``): seconds, device peak; every UNet and VAE weight equal
    to its file tensor cast to bf16 with no key left over; the text states on
    the card against the CPU's (float32 both) within CLIP_REL_TOL of the
    largest; for the single-file priors the host peak RSS rise
    (``LOAD_ALONE``). Returns the guidance and the numbers."""
    import torch

    from dreamgaussian_tpu_torch.cli.main import load_reference
    from dreamgaussian_tpu_torch.guidance import convert, loader, text_encoder
    from dreamgaussian_tpu_torch.utils.config import Config

    tag = "imagedream" if prior == "imagedream" else "text"
    if prior == "imagedream":
        ref_size = text_options(prior)["ref_size"]
        rgb, _ = load_reference(Config(input=png, ref_size=ref_size))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    if prior == "imagedream":
        g = loader.load_imagedream(path, rgb, TEXT_PROMPT, TEXT_NEGATIVE, device="cuda")
    else:
        g = loader.load_stable_diffusion(path, TEXT_PROMPT, TEXT_NEGATIVE,
                                         mvdream=prior == "mvdream", device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    prompts = [TEXT_PROMPT, TEXT_NEGATIVE]
    if prior == "sd":
        files = {"unet": {convert.unet_key(k): v for k, v in
                          convert.load_torch_state_dict(path, "unet").items()},
                 "vae": {convert.vae_key(k): v for k, v in
                         convert.load_torch_state_dict(path, "vae").items()}}
        prompts += [f"{TEXT_PROMPT}, {d} view" for d in ("front", "side", "back")]
        on_cpu = text_encoder.encode_text(path, prompts, "cpu")
        host = None
    else:
        parts = convert.split_ldm(convert.load_torch_state_dict(path))
        files = {"unet": convert.ldm_unet_state(parts["unet"], g.unet.config),
                 "vae": convert.ldm_vae_state(parts["vae"], g.vae.config)}
        on_cpu = text_encoder.encode_open_clip_text(
            parts["text"], os.path.join(os.path.dirname(path), "tokenizer"), prompts, "cpu")
        del parts
        host = load_host_peak(load_alone, ["mvdream", path, TEXT_PROMPT] if prior == "mvdream"
                              else ["imagedream", path, png, str(ref_size)])
    n_params = 0
    for sub, module in (("unet", g.unet), ("vae", g.vae)):
        params = dict(module.named_parameters())
        if sorted(files[sub]) != sorted(params):
            raise RuntimeError(f"the {prior} file's {sub} keys and the module's parameters differ")
        for k, v in files[sub].items():
            if params[k].dtype != torch.bfloat16 or not torch.equal(
                    params[k], v.to("cuda").to(torch.bfloat16)):
                raise RuntimeError(f"{prior} {sub} parameter {k} is not its file tensor")
            n_params += v.numel()
    del files
    on_card = torch.stack([g.emb[k] for k in ("pos", "neg", "front", "side", "back")
                           if k in g.emb]).cpu()
    scale = float(on_cpu.abs().max())
    err = float((on_card - on_cpu).abs().max())
    if not err <= CLIP_REL_TOL * scale:
        raise RuntimeError(f"{prior} text states on the card miss the CPU's: {err:.3e} against "
                           f"{CLIP_REL_TOL} x {scale:.3e}")
    host_s = "" if host is None else (
        f"; alone in a process of its own {host['load_s']:.1f} s, host peak RSS "
        f"{host['peak_before'] / 2**30:.2f} -> {host['peak_after'] / 2**30:.2f} GiB, a rise of "
        f"{host['rise'] / 2**30:.2f} GiB (gate: under the UNet's float32 "
        f"{host['unet_fp32'] / 2**30:.2f} GiB)")
    print(f"[{tag}] {prior} load {load_s:.1f} s, peak device memory {peak_gib:.2f} GiB; "
          f"{n_params} UNet and VAE weights equal to the file's cast to bf16, no key left "
          f"over; {len(prompts)} text states {tuple(on_card.shape)} card against CPU max abs "
          f"err {err:.3e} (largest |state| {scale:.3e}, gate {CLIP_REL_TOL} of it){host_s}; "
          f"card '{card}'")
    return g, {"load_s": load_s, "load_peak_gib": peak_gib, "text_err": err, "text_scale": scale,
               "host_rise_gib": None if host is None else host["rise"] / 2**30}


def text_steps(prior: str, guidance, seed: int, card: str) -> dict:
    """Stage1Trainer on the prior's config with its full-width guidance: the
    steps of TEXT_RUNG_STEPS (median ms per rung without each rung's first),
    one 512^2 step under torch.profiler, the peak memory, and one UNet call
    at the step's shape: its device time from the profiler, and ms per call
    by CUDA events around back-to-back calls (host-bound when the host
    dispatches slower than the card runs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from dreamgaussian_tpu_torch.ops.rasterize_cuda import LAUNCHES
    from dreamgaussian_tpu_torch.train import Stage1Trainer
    from dreamgaussian_tpu_torch.utils.config import Config

    opt = Config({**text_options(prior), "prompt": TEXT_PROMPT})
    _, views, batch, latent = PRIORS[prior]
    trainer = Stage1Trainer(opt, capacity=opt["capacity"], seed=seed,
                            guidance_fns=((opt["lambda_sd"], guidance.guidance_fn()),),
                            device="cuda")
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    rungs = {}
    for size, steps in TEXT_RUNG_STEPS.items():
        times = []
        for step in steps:
            trainer.step = step - 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = float(trainer.train_step())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            if not math.isfinite(loss):
                raise RuntimeError(f"{prior}: non-finite loss at step {step}")
        rungs[size] = {"median_ms": statistics.median(times[1:]), "warmup_ms": times[0],
                       "ms": [round(x, 1) for x in times[1:]]}
    trainer.step = TEXT_PROFILED_STEP - 1
    _, wall, breakdown = profiled_step(trainer)
    launches = dict(LAUNCHES)
    n_steps = sum(len(r) for r in TEXT_RUNG_STEPS.values()) + 1
    if launches["composite_fwd"] < n_steps * views or launches["composite_bwd"] < n_steps * views:
        raise RuntimeError(f"{prior}: the steps did not launch K1 and K2 per view: {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cfg = guidance.unet.config
    x = torch.randn(batch, latent, latent, 4, device="cuda")
    tt = torch.full((batch,), 500, device="cuda")
    ctx = torch.randn(batch, 77, cfg.cross_attention_dim, device="cuda")
    kw = {} if prior == "sd" else {"camera": torch.randn(batch, 16, device="cuda")}
    if prior == "imagedream":
        kw["ip"] = torch.randn(batch, 257, cfg.ip_embed_dim, device="cuda")
        kw["ip_img"] = torch.randn(batch // cfg.num_views, latent, latent, 4, device="cuda")
    with torch.no_grad():
        unet_events_ms = cuda_ms(lambda: guidance.unet(x, tt, ctx, **kw), reps=5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("unet"):
                guidance.unet(x, tt, ctx, **kw)
            torch.cuda.synchronize()
    unet_ms = range_device_ms(prof, ("unet",))["unet"]
    tag = "[imagedream]" if prior == "imagedream" else f"[text] {prior}"
    print(f"{tag} stage-1 ms per step by rung {json.dumps(rungs)}; 512^2 step under "
          f"the profiler {wall:.1f} ms, device busy {breakdown['device_busy_ms']:.1f} ms; peak "
          f"{peak_gib:.2f} GiB; one UNet call (batch {batch}, {latent}^2 latents) device "
          f"{unet_ms:.2f} ms (profiler), {unet_events_ms:.2f} ms per call back to back (CUDA "
          f"events); launches {json.dumps(launches)}; card '{card}'")
    return {"rungs": rungs, "busy_ms": breakdown["device_busy_ms"], "peak_gib": peak_gib,
            "unet_ms": unet_ms, "unet_events_ms": unet_events_ms}


def drive_prior_clis(prior: str, argv: list, outdir: str, runs: dict, card: str) -> dict:
    """``cli.main`` then ``cli.main2`` on the prior's config with ``argv``
    (``drive_cli``); reads the outputs back and gates each run's UNet calls
    (TEXT_ITERS at the prior's batch, then one per refine step) and kernel
    launches (K3: 26 for the export, a target and a grad render per view in
    each stage-2 step; K1 and K2 per view per stage-1 step)."""
    import numpy as np

    from dreamgaussian_tpu_torch.cli import main as cli1
    from dreamgaussian_tpu_torch.cli import main2 as cli2
    from dreamgaussian_tpu_torch.guidance.sds import refine_init_step

    _, views, batch, latent = PRIORS[prior]
    tag = "[imagedream]" if prior == "imagedream" else f"[text] {prior}"
    unet_calls: dict = {}
    for label, cli in ((f"{prior} main", cli1), (f"{prior} main2", cli2)):
        calls: list = []
        with counted_unet_calls(calls):
            stats = drive_cli(label, cli, argv, runs)
        unet_calls[label] = calls
        if not math.isfinite(stats["loss"]):
            raise RuntimeError(f"the run {label} ended with loss {stats['loss']}")
    n, faces = read_outputs(outdir, prior, text_options(prior)["texture_size"],
                            text_options(prior)["capacity"])
    refine_steps = text_options(prior).get("refine_steps", 50)
    refine_calls = sum(refine_steps - refine_init_step(
        refine_steps, np.float32(min(1.0, s / TEXT_REFINE) * 0.15 + 0.8))
        for s in range(1, TEXT_REFINE + 1))
    want = {f"{prior} main": [(batch, latent, latent, 4)] * TEXT_ITERS,
            f"{prior} main2": [(batch, latent, latent, 4)] * refine_calls}
    for label, shapes in want.items():
        if unet_calls[label] != shapes:
            raise RuntimeError(f"{label} ran the UNet {len(unet_calls[label])} times at "
                               f"{sorted(set(unet_calls[label]))}, not {len(shapes)} at "
                               f"{shapes[:1]}")
    main_l, main2_l = runs[f"{prior} main"]["launches"], runs[f"{prior} main2"]["launches"]
    if (main_l["ztest"] != 26 or main2_l["ztest"] != 2 * views * TEXT_REFINE
            or main_l["composite_bwd"] != TEXT_ITERS * views
            or main_l["composite_fwd"] != TEXT_ITERS * views + 26):
        raise RuntimeError(f"the {prior} runs did not launch the kernels as the code gives: "
                           f"main {main_l}, main2 {main2_l}")
    print(f"{tag} CLIs: {n} gaussians in the PLY, stage-1 mesh {faces} faces; "
          f"UNet calls main {TEXT_ITERS} (batch {batch}, {latent}^2), main2 "
          f"{refine_calls}; K3 launches main 26, main2 {2 * views} per step; losses "
          f"finite; card '{card}'")
    return {"gaussians": n, "faces": faces,
            "unet_calls": {k: len(v) for k, v in unet_calls.items()}}


def run_text_day(seed: int, card: str, load_alone, work: str) -> dict:
    """The SD snapshot and the MVDream file written (under ``work``, where
    the ImageDream day's cli.dream finds them), loaded, timed and driven
    through both CLIs (see TEXT_PROMPT); every kernel call of the CLI runs
    held against its plain version, the UNet calls and K3 launches gated."""
    import torch

    from dreamgaussian_tpu_torch.guidance import synthetic
    from dreamgaussian_tpu_torch.guidance.unet import MVDREAM_CONFIG, SD21_CONFIG
    from dreamgaussian_tpu_torch.guidance.vae import VAEConfig

    runs: dict = {}
    summary: dict = {}
    tmp = os.path.join(work, "text")
    paths = {"sd": os.path.join(tmp, "sd21-base"),
             "mvdream": os.path.join(tmp, "mvdream", "sd-v2.1-base-4view.pt")}
    os.makedirs(os.path.dirname(paths["mvdream"]))
    for prior in TEXT_PRIORS:
        torch.cuda.synchronize()
        t = time.perf_counter()
        if prior == "sd":
            sizes = synthetic.write_sd_snapshot(paths[prior], SD21_CONFIG, VAEConfig(),
                                                synthetic.SD21_TEXT, dtype=torch.float16,
                                                seed=seed, device="cuda")
            n_bytes = sum(nb for nb, _ in sizes.values())
            n_values = sum(nv for _, nv in sizes.values())
        else:
            n_bytes, n_values = synthetic.write_mvdream_checkpoint(
                paths[prior], MVDREAM_CONFIG, VAEConfig(), dtype=torch.float16, seed=seed,
                device="cuda")
        write_s = time.perf_counter() - t
        print(f"[text] {prior} full-width file written in {write_s:.1f} s: {n_values} values, "
              f"{n_bytes} bytes of fp16; card '{card}'")
        guidance, load = check_text_load(prior, paths[prior], card, load_alone)
        steps = text_steps(prior, guidance, seed, card)
        del guidance
        torch.cuda.empty_cache()
        summary[prior] = {"write_s": write_s, "values": n_values, "bytes": n_bytes, **load,
                          **steps}
    for prior in TEXT_PRIORS:
        argv = ["--config", os.path.join(CONFIGS, PRIORS[prior][0]), f"sd_ckpt={paths[prior]}",
                f"save_path={prior}", f"outdir={tmp}", f"seed={seed}", *TEXT_CLI_ARGS]
        summary[prior]["cli"] = drive_prior_clis(prior, argv, tmp, runs, card)
    shapes = hold_cli_calls(runs, "text-day")
    launches = {k: v["launches"] for k, v in runs.items()}
    total = {k: sum(v[k] for v in launches.values()) for k in launches[next(iter(launches))]}
    walls = {k: round(v["wall_s"], 1) for k, v in runs.items()}
    print(f"[text] launches {json.dumps(total)}; CLI seconds {json.dumps(walls)}; "
          f"{json.dumps({p: {k: v for k, v in d.items() if k != 'rungs'} for p, d in summary.items()})}"
          f"; card '{card}'")
    return {"launches": total, "shapes": shapes, "paths": paths}


# The ImageDream day: a full-width single-file ImageDream checkpoint
# (IMAGEDREAM_CONFIG's UNet with its camera MLP, resampler and ip projections,
# the VAE, the 24-block OpenCLIP ViT-H text tower: about 1.41 B values) and the
# CLIP ViT-H/14 image encoder beside it (0.63 B values), fp16; loaded on the
# disc reference, timed on the text day's rung steps, driven through both CLIs
# on configs/imagedream.yaml, then cli.dream in its three modes.
DREAM_STEPS = 10
DREAM_SIDE = 512       # SD's one image, or the 2x2 grid of the 256^2 views


def check_image_tokens(g, path: str, png: str, card: str) -> dict:
    """ImageDream's image conditioning: the CLIP tokens of the reference on
    the card, and those the guidance holds, against the CPU's (float32 both)
    within CLIP_REL_TOL of the largest; [257, 1280] tokens and a finite
    [32, 32, 4] ``ip_img``."""
    import torch

    from dreamgaussian_tpu_torch.cli.main import load_reference
    from dreamgaussian_tpu_torch.guidance.clip import clip_pixel_values, load_clip_vision_tokens
    from dreamgaussian_tpu_torch.utils.config import Config

    rgb, _ = load_reference(Config(input=png, ref_size=text_options("imagedream")["ref_size"]))
    enc = os.path.join(os.path.dirname(path), "image_encoder")
    pixels = clip_pixel_values(rgb, 224, "cpu")
    with torch.no_grad():
        tokens_cpu = load_clip_vision_tokens(enc, "cpu")(pixels)[0]
        tokens_card = load_clip_vision_tokens(enc, "cuda")(pixels.cuda())[0].cpu()
    errs = {}
    for name, got in (("tokens", tokens_card), ("guidance tokens", g.img_emb["pos"].cpu())):
        scale = float(tokens_cpu.abs().max())
        errs[name] = (float((got - tokens_cpu).abs().max()), scale)
        if not errs[name][0] <= CLIP_REL_TOL * scale:
            raise RuntimeError(f"ImageDream {name} on the card miss the CPU's: "
                               f"{errs[name][0]:.3e} against {CLIP_REL_TOL} x {scale:.3e}")
    if tuple(g.img_emb["pos"].shape) != (257, 1280) or tuple(g.img_emb["ip_img"].shape) != (
            32, 32, 4) or not bool(torch.isfinite(g.img_emb["ip_img"]).all()):
        raise RuntimeError(f"ImageDream's image conditioning has shapes "
                           f"{tuple(g.img_emb['pos'].shape)}, {tuple(g.img_emb['ip_img'].shape)}")
    print(f"[imagedream] CLIP tokens {tuple(tokens_cpu.shape)} card against CPU max abs err "
          f"(largest |entry|): "
          f"{json.dumps({k: [float(f'{e:.3e}'), float(f'{m:.3e}')] for k, (e, m) in errs.items()})}"
          f" (gate {CLIP_REL_TOL} of the largest); ip_img {tuple(g.img_emb['ip_img'].shape)} "
          f"finite; card '{card}'")
    return {"clip_err": errs["tokens"][0], "clip_scale": errs["tokens"][1]}


def run_imagedream_day(seed: int, card: str, load_alone, work: str, text_paths: dict) -> dict:
    """The ImageDream file written, loaded, timed and driven through both CLIs
    (every kernel call held against its plain version, the UNet calls and K3
    launches gated), then ``cli.dream`` in its three modes on the text
    day's files and this one (each PNG read back, ``DREAM_STEPS`` UNet calls
    each)."""
    import numpy as np
    import torch

    from dreamgaussian_tpu_torch.cli import dream
    from dreamgaussian_tpu_torch.guidance import synthetic
    from dreamgaussian_tpu_torch.guidance.unet import IMAGEDREAM_CONFIG
    from dreamgaussian_tpu_torch.guidance.vae import VAEConfig
    from dreamgaussian_tpu_torch.utils.png import read_png

    tmp = os.path.join(work, "imagedream")
    os.makedirs(tmp)
    path = os.path.join(tmp, "sd-v2.1-base-4view-ipmv.pt")
    torch.cuda.synchronize()
    t = time.perf_counter()
    sizes = synthetic.write_imagedream_checkpoint(path, IMAGEDREAM_CONFIG, VAEConfig(),
                                                  dtype=torch.float16, seed=seed, device="cuda")
    write_s = time.perf_counter() - t
    print(f"[imagedream] full-width file and image encoder written in {write_s:.1f} s: "
          f"{json.dumps(sizes)} (bytes, values) in fp16; card '{card}'")
    png = os.path.join(tmp, "disc.png")
    write_disc_png(png, 512, seed)
    guidance, load = check_text_load("imagedream", path, card, load_alone, png)
    load.update(check_image_tokens(guidance, path, png, card))
    steps = text_steps("imagedream", guidance, seed, card)
    del guidance
    torch.cuda.empty_cache()

    runs: dict = {}
    argv = ["--config", os.path.join(CONFIGS, PRIORS["imagedream"][0]), f"input={png}",
            f"sd_ckpt={path}", "save_path=imagedream", f"outdir={tmp}", f"seed={seed}",
            *TEXT_CLI_ARGS]
    cli = drive_prior_clis("imagedream", argv, tmp, runs, card)
    shapes = hold_cli_calls(runs, "imagedream-day")

    dreams = {}
    for mode, ckpt in (("sd", text_paths["sd"]), ("mvdream", text_paths["mvdream"]),
                       ("imagedream", path)):
        out = os.path.join(tmp, f"dream_{mode}.png")
        calls: list = []
        with counted_unet_calls(calls):
            drive_cli(f"dream {mode}", dream, [TEXT_PROMPT, "--negative", TEXT_NEGATIVE, "--mode",
                                               mode, "--ckpt", ckpt, "--image", png, "--steps",
                                               str(DREAM_STEPS), "--seed", str(seed), "--out",
                                               out], runs)
        img = read_png(out)
        _, _, batch, latent = PRIORS[mode]
        if img.shape != (DREAM_SIDE, DREAM_SIDE, 3) or float(img.std()) == 0.0:
            raise RuntimeError(f"cli.dream {mode} wrote a {img.shape} image of spread "
                               f"{float(img.std())}, not a {DREAM_SIDE}^2 one")
        if calls != [(batch, latent, latent, 4)] * DREAM_STEPS:
            raise RuntimeError(f"cli.dream {mode} ran the UNet {len(calls)} times at "
                               f"{sorted(set(calls))}, not {DREAM_STEPS} at batch {batch}")
        dreams[mode] = {"s": runs[f"dream {mode}"]["wall_s"], "png": list(img.shape),
                        "mean": float(np.mean(img))}
    print(f"[imagedream] cli.dream at {DREAM_STEPS} steps, {DREAM_STEPS} UNet calls each, PNGs "
          f"read back: {json.dumps(dreams)}; card '{card}'")
    launches = {k: v["launches"] for k, v in runs.items()}
    total = {k: sum(v[k] for v in launches.values()) for k in launches[next(iter(launches))]}
    walls = {k: round(v["wall_s"], 1) for k, v in runs.items()}
    summary = {"write_s": write_s, "sizes": sizes, **load,
               **{k: v for k, v in steps.items() if k != "rungs"}, "cli": cli}
    print(f"[imagedream] launches {json.dumps(total)}; CLI seconds {json.dumps(walls)}; "
          f"{json.dumps(summary)}; card '{card}'")
    return {"launches": total, "shapes": shapes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    with (load_alone_process() as zero123_alone, load_alone_process() as mvdream_alone,
          load_alone_process() as imagedream_alone):
        return smoke(args, zero123_alone, mvdream_alone, imagedream_alone)


def smoke(args, load_alone: subprocess.Popen, mvdream_alone: subprocess.Popen,
          imagedream_alone: subprocess.Popen) -> int:
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
    t_start = t0 = time.perf_counter()
    # One nvcc per library, all at once: the kernels, and K3 without the
    # sift, which check_ztest times against the shipped build.
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(cuda_build.build, ["composite_fwd", "composite_bwd", "ztest"], True),
                  pool.submit(cuda_build.build, ["ztest"], True, ("-DZTEST_SIFT=0",))]
        for b in builds:
            b.result()
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

    kernels = check_kernels(args.seed, result.pop("trainer"))
    for row in kernels:
        row["launches"] = result["launches"][row["name"]]

    export = run_export(args.seed, card)
    opts = image_options()
    k3 = check_ztest(export["mesh"], math.radians(opts["fovy"]), opts["radius"])
    k3["launches"] = export["launches"]["ztest"]
    kernels[0]["launches_export"] = export["launches"]["composite_fwd"]

    stage2 = run_stage2(args.seed, card, export["mesh"], result.pop("guidance"))
    k3["launches_stage2"] = stage2["launches"]
    k3["launches_stage2_step"] = stage2["steps"][-1]["k3_launches"]
    k3["stage2_shapes"] = check_ztest_stage2(stage2.pop("trainer"))
    kernels.append(k3)
    cli = run_cli(args.seed, card)
    for row in kernels:
        row["launches_cli"] = cli["launches"][row["name"]]
        row["cli_shapes"] = cli["shapes"][row["name"]]
    weights_day = run_weights_day(args.seed, card, load_alone)
    for row in kernels:
        row["launches_weights_day"] = weights_day["launches"][row["name"]]
        row["weights_day_shapes"] = weights_day["shapes"][row["name"]]
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        text_day = run_text_day(args.seed, card, mvdream_alone, work)
        print(f"[text] the text day took {time.perf_counter() - t0:.1f} s; card '{card}'")
        t0 = time.perf_counter()
        imagedream_day = run_imagedream_day(args.seed, card, imagedream_alone, work,
                                            text_day["paths"])
        print(f"[imagedream] the ImageDream day took {time.perf_counter() - t0:.1f} s; "
              f"card '{card}'")
    for row in kernels:
        row["launches_text_day"] = text_day["launches"][row["name"]]
        row["text_day_shapes"] = text_day["shapes"][row["name"]]
        row["launches_imagedream_day"] = imagedream_day["launches"][row["name"]]
        row["imagedream_day_shapes"] = imagedream_day["shapes"][row["name"]]
    print(f"[smoke] {time.perf_counter() - t_start:.1f} s from the build to here; card '{card}'")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
