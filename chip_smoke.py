"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

1. builds the port's CUDA kernels (one nvcc per source) and its host
   tools (g++: the mesh tools, the image tools and the image codecs), all
   at once, and prints the toolchain;
1b. the formats phase (``run_formats``): decodes every checked-in JPEG
   fixture (``tests/fixtures/port_jpeg/``, written by
   ``scripts/port_make_jpeg_fixtures.py``) and holds it bit for bit against
   cv2's decode stored beside it, with the host's decode ms; decodes every
   arithmetic-coded and lossless fixture (``tests/fixtures/port_jpeg_variants/``,
   ``scripts/port_make_jpeg_variant_fixtures.py``: SOF3, SOF9, SOF10, DAC,
   restart intervals, cut-off files, and the processes cv2 refuses) under
   both flags against cv2's stored decodes (ValueError where cv2 gives
   None), with the host's ms for the 512^2 arithmetic progressive photo, the
   1024x768 arithmetic sequential one and the 256^2 lossless one
   (``check_jpeg_variants``); reads every
   fixture of ``tests/fixtures/port_images/`` (PNG, WebP, BMP, PNM, GIF;
   ``scripts/port_make_image_fixtures.py``), ``tests/fixtures/port_tiff/``
   (TIFF: every codec, layout and photometric the port reads;
   ``scripts/port_make_tiff_fixtures.py``) and ``tests/fixtures/port_jp2/``
   (JPEG 2000: JP2 and J2K, 5/3 and 9/7, every progression order, tiles,
   tile-parts, palettes, channel definitions and colour spaces) and
   ``tests/fixtures/port_jp2_archival/`` (SOP/EPH markers, the six
   code-block styles, ROI, PPM/PPT packed packet headers;
   ``scripts/port_make_jp2_fixtures.py``), ``tests/fixtures/port_hdr/``
   (Radiance HDR, PFM, Sun raster) and ``tests/fixtures/port_tiff_codecs/``
   (SGILog, SGILog24, ThunderScan, NeXT, 10/12/14-bit samples) under IMREAD_UNCHANGED and
   IMREAD_COLOR, and the GLB's and OBJs' textures through ``Mesh.load``,
   each held bit for bit against cv2's stored decode (or refused where cv2
   returns None), with the host's median ms (``check_image_fixtures``);
   runs GrabCut on
   the card on the 512^2 photo (device ms of the pixel work under
   torch.profiler, host ms of the min-cuts) and holds its matte against the
   port's CPU run and cv2's stored one (alpha >= 128 IoU); lines
   ``[formats]``;
2. runs stage-1 image-to-3D with full-width Zero123 guidance (random bf16
   weights) through ``Stage1Trainer`` with ``configs/image.yaml``'s
   options at capacity 16384: steps 1-3 at the 128 rung, step 200 (256,
   densify) and step 300 (512, densify), checking finite losses and that
   every step launched K1 and K2; saves the PLY and loads it back;
3. holds K1 and K2 against their plain PyTorch versions on the card (K2
   against the plain version in float64, with the float32 plain version's
   error printed beside it; a K2 call that fails its gate is saved under
   ``chiprun_out/k2_holds/``) and times kernel and plain version: on a synthetic scene that covers a
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
   ``[kernels] ... in the weights-day``); the ``image_sai.yaml`` run takes
   the 512^2 RGB photo as an arithmetic-coded progressive JPEG
   (``photo_512_arith.jpg``, the 512^2 JPEG fixture's coefficients: the
   same pixels, checked) and no U2Net weights: decoded by the port, matted
   by GrabCut on the card (checked), recentred, then stage 1; then
   ``cli.main`` on ``configs/image.yaml`` with the 512^2 lossy RGBA WebP
   photo (its alpha kept: no matting, checked) for a few steps, and
   ``cli.main2`` with ``mesh=`` the GLB fixture whose base colour is a 512^2
   JPEG (read by the port, checked) for the stage-2 steps, 3 K3 launches
   each; the same two with a 512^2 LZW RGBA TIFF (unassociated alpha,
   premultiplied as cv2 reads it; no matting, checked) and an OBJ sphere
   whose ``map_Kd`` is a tiled LZW TIFF; and the same two with a 512^2
   lossless RGBA JPEG 2000 cut-out as archives write it (SOP and EPH
   markers, RESET|RESTART|CAUSAL|ERTERM|SEGMARK code-blocks) and an OBJ
   sphere whose ``map_Kd`` is a BYPASS-coded JP2 in 32^2 tiles with PPT
   markers and an RGN marker (``jp2 stage 1``, ``jp2 stage 2``); and the
   same two with the 512^2 JPEG photo's decode written as a 24-bit Sun
   raster (read back equal to those pixels, matted by GrabCut on the card)
   and an OBJ sphere whose ``map_Kd`` is a 128^2 RLE Radiance HDR
   (``ras stage 1``, ``hdr stage 2``);
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
12. the apps day (``run_apps_day``): ``cli.process`` mats an RGB photo (the
   disc without its alpha) with a random full-width ``u2net.pth`` (U2Net's
   matte on the card against the CPU's); ``scripts/port_runall.py --video``
   runs stage 1, stage 2 and a 36-frame turntable on a folder with that one
   input (fake guidance, cut in depth: ``APPS_ARGS``); ``cli.render`` makes
   a 36-frame 512^2 GIF of its PLY and an H.264 MP4 of its OBJ (read back,
   the MP4's box tree by ``read_mp4``; ms per frame of the renders alone;
   the MP4's bytes, the host ms per frame of ``encode_mp4`` and its
   reconstruction's PSNR against the frames, gated at 30 dB); ``cli.eval``
   scores both with a random VGG16 and lpips lins and the CLIP ViT-L/14 of
   a full-width Zero123 snapshot, on which
   ``cli.novel_view`` then samples 3 views at 10 steps (UNet calls gated);
   ``cli.serve`` answers ``/``, ``/render`` in its three modes and 10 timed
   renders at 512^2 for the PLY and for the mesh, then trains live on
   ``configs/image.yaml`` until ``/status`` shows 5 steps; ``cli.webapp``
   runs a stage-1 and a stage-2 job to their GIFs. Each run counts its
   kernel launches from 0 and holds every K1, K2 and K3 call against the
   plain version (lines ``[apps]``, ``[cli]``, ``[kernels] ... in the
   apps-day``);
13. the sharding day (``run_shard_day``): ranks of a (data, tile) mesh, one
   process each, all on the one card, joined by gloo (the backend rule of
   ``parallel/multihost.py``; NCCL refuses two ranks on one device), each
   loading a full-width Zero123 snapshot written for the day: data2
   (batch 2, 3 steps, densify at step 2) and data2xtile2 (2
   steps) at the 512^2 rung; gates: the replicas bit for bit after every
   step, every K1/K2 call of every rank (tile offsets included) against the
   plain version, the data2 step against one process over both views with
   the ranks' draws replayed, the tile2 and tile4 renders of the synthetic
   512^2 scene against the unsharded one with their gradients; then
   ``cli.main`` with mesh=data2 on two ``torchrun`` launchers of one rank
   each (``--nnodes 2``, a static rendezvous on localhost, both ranks on
   the one card: gloo by the rule), stopped with a checkpoint at step
   ``SHARD_CLI_STOP`` and resumed to the CLI's iters with node 1 given a
   checkpoint folder that does not exist (both ranks resume at that step
   from rank 0's state; the replicas bit for bit after each leg; both PLYs
   and leg 2's export read back), every kernel call of both
   ranks held; lines ``[shard]`` (ms per step, all-reduce ms, rays/s, peak
   memory per rank, each leg's seconds) and ``[kernels] ... in the
   shard-day``;
14. prints the ``kernels`` JSON line, the card's name and power limit, and
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
# K2 against its plain version evaluated in float64 on the same inputs
# (rasterize_cuda.composite_backward_f64, each pair's skip and clamp taken
# as float32 takes them), elementwise in each gradient row:
# |kernel - exact| <= K2_RTOL |exact| + K2_ATOL * max |exact row|. The rows
# differ in scale by orders of magnitude (the conic rows carry squared
# offsets), so each is held to its own. The kernel takes the moments of a
# gaussian about its own centre; the plain version in float32 takes them
# about the tile's and chains them to the conic gradients through products
# of offsets that cancel. On the 2,000-pair lists of ImageDream's 128^2
# renders the float32 plain version, as the card computes it, used up to 1.48
# of this gate against float64 where the kernel used 0.06
# (scripts/port_k2_hold_sweep.py), so the float32 plain version is printed
# beside the kernel and does not judge it. A relative error of 1e-3 in the
# terms of the pairs deep in a pixel's list exceeds the gate.
K2_RTOL = 1e-4
K2_ATOL = 1e-5
# Where a K2 hold that fails leaves the call's inputs (gitignored; a card
# call brings the folder back).
HOLD_DUMPS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out", "k2_holds")
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
    cloud, cam = main_path_cloud(seed, n, size)
    return bin_cloud(*cloud, cam, size)


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
    tolerance scaled to each row's own magnitude (``k2_shares``);
    ``verbose`` prints each row's error beside its median and largest
    |grad|. Rows 10-15 must be zero."""
    shares = k2_shares(d_k, d_r, rtol, atol)
    ok = not bool(d_k[len(GRAD_ROWS):].any()) and max(shares) <= 1.0
    for i, name in enumerate(GRAD_ROWS if verbose else ()):
        mag = d_r[i].abs()
        nonzero = mag[mag > 0]
        median = float(nonzero.median()) if nonzero.numel() else 0.0
        print(f"[kernels] K2 row {name}: max abs err {float((d_k[i] - d_r[i]).abs().max()):.3e}, "
              f"median |grad| {median:.3e}, max |grad| {float(mag.max()):.3e}, share of "
              f"tolerance used {shares[i]:.3f}")
    return ok


def k2_shares(d, want, rtol: float = K2_RTOL, atol: float = K2_ATOL) -> list:
    """For each gradient row, the largest share of K2's gate (``rtol`` of
    each element of ``want`` plus ``atol`` of its row's largest, in float64)
    that |d - want| uses: above 1 the row fails."""
    shares = []
    for i in range(len(GRAD_ROWS)):
        mag = want[i].double().abs()
        tol = rtol * mag + atol * float(mag.max())
        shares.append(float(((d[i].double() - want[i]).abs() / tol.clamp_min(1e-300)).max()))
    return shares


def k2_report(out, args: list, geo: dict) -> tuple:
    """A K2 call's gradients ``out`` against its plain version in float32
    and against the float64 oracle on the same inputs
    (``rasterize_cuda.composite_backward_f64``), and the float32 plain
    version against that oracle: for each pair the largest abs error and
    the share of the gate used per row. Returns (report, plain, oracle)."""
    import torch

    from dreamgaussian_tpu_torch.ops import rasterize_cuda as rc

    with torch.no_grad():
        plain = rc.composite_backward_ref(*args, **geo)
        exact = rc.composite_backward_f64(*args, **geo)
    rows = len(GRAD_ROWS)
    report = {}
    for name, d, want in (("kernel_vs_f64", out, exact), ("plain_vs_f64", plain, exact),
                          ("kernel_vs_plain", out, plain)):
        d, want = d[:rows].double(), want[:rows].double()
        shares = k2_shares(d, want)
        report[name] = {"max_abs_err": float((d - want).abs().max()), "share": max(shares),
                        "row": GRAD_ROWS[shares.index(max(shares))],
                        "shares": [round(x, 4) for x in shares]}
    return report, plain, exact


def dump_k2_call(tag: str, args: list, geo: dict, **outputs) -> str:
    """A K2 call's inputs, its geometry (tile offset included) and the
    given outputs (the kernel's gradients, the plain version's) as one npz
    under ``chiprun_out/k2_holds/``; returns the path."""
    import numpy as np

    os.makedirs(HOLD_DUMPS, exist_ok=True)
    names = ("dup_feat", "chunk_starts", "n_chunks", "fwd_out", "g_out")
    path = os.path.join(HOLD_DUMPS, f"{tag.replace(' ', '_').replace('^', '')}_{os.getpid()}_"
                                    f"{int(time.time() * 1e3)}.npz")
    np.savez_compressed(path, **{k: a.detach().cpu().numpy() for k, a in zip(names, args)},
                        **{k: v.detach().cpu().numpy() for k, v in outputs.items()},
                        **{k: np.asarray(v) for k, v in geo.items()})
    return path


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
    report, _, exact = k2_report(d_k, [dup_feat, cs, nc, ref, g_out], geo)
    bwd_err, plain = report["kernel_vs_f64"]["max_abs_err"], report["plain_vs_f64"]
    print(f"[kernels] {label}: K2 against the plain version in float64 max abs err "
          f"{bwd_err:.3e}, the plain version in float32 {plain['max_abs_err']:.3e} (share of "
          f"the gate {plain['share']:.3f}, row {plain['row']}); tolerance per element "
          f"{K2_RTOL:g} |grad| + {K2_ATOL:g} max |grad| of its row")
    if not grad_rows_agree(d_k, exact, K2_RTOL, K2_ATOL):
        raise RuntimeError(f"K2 disagrees with its plain version in float64 ({label})")

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


def composite_label(geo: dict) -> str:
    """A K1/K2 call's frame: "512^2", or a tile-sharded rank's slab
    ("512 wide, tiles 128...255")."""
    off, n = geo.get("tile_offset", 0), geo["num_tiles"]
    if off == 0 and n == geo["grid_x"] ** 2:
        return f"{render_side(geo)}^2"
    return f"{geo['grid_x'] * geo['tile']} wide, tiles {off}...{off + n - 1}"


def hold_composite_calls(phase: str, fwd: list, bwd: list) -> dict:
    """K1 and K2 at every call a run made, against their plain versions on
    the same inputs (the tile offset included; K2's in float64), with
    check_shape's gates; one row per kernel and frame or slab: calls and
    the largest error, for K2 also the share of the gate used and the
    float32 plain version's error and share against float64."""
    import torch

    from dreamgaussian_tpu_torch.ops import rasterize_cuda as rc

    rows: dict = {"composite_fwd": {}, "composite_bwd": {}}
    for name, calls in (("composite_fwd", fwd), ("composite_bwd", bwd)):
        for c in calls:
            label = composite_label(c["geo"])
            args, out = [a.detach() for a in c["args"]], c["out"].detach()
            with torch.no_grad():
                if name == "composite_fwd":
                    ref = rc.composite_forward_ref(*args, **c["geo"])
                    err = float((out[:, :5] - ref[:, :5]).abs().max())
                    ok = err <= 1e-3 and float((out[:, 5] != ref[:, 5]).float().mean()) <= 1e-3
                else:
                    report, plain, ref = k2_report(out, args, c["geo"])
                    err = report["kernel_vs_f64"]["max_abs_err"]
                    ok = grad_rows_agree(out, ref, K2_RTOL, K2_ATOL, verbose=False)
            if not ok:
                if name == "composite_bwd":
                    # Each row's error beside its tolerance, the kernel's and
                    # the float32 plain version's against float64, and the
                    # call's inputs for a later look.
                    grad_rows_agree(out, ref, K2_RTOL, K2_ATOL)
                    path = dump_k2_call(f"{phase} {label}", args, c["geo"], d_kernel=out,
                                        d_plain=plain)
                    print(f"[kernels] K2 at a {label} call of {phase} against the plain version "
                          f"in float64 (gate {K2_RTOL:g} |grad| + {K2_ATOL:g} max |grad| of its "
                          f"row, share above 1 fails): {json.dumps(report)}; inputs saved to "
                          f"{path}")
                raise RuntimeError(f"{name} disagrees with its plain version at a {label} "
                                   f"call of {phase}")
            row = rows[name].setdefault(label, {
                "phase": phase, "label": label, "tile_offset": c["geo"].get("tile_offset", 0),
                "calls": 0, "max_abs_err": 0.0, "blocks": c["blocks"]})
            row["calls"] += 1
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if name == "composite_bwd":
                for key, pair in (("gate_share", "kernel_vs_f64"),
                                  ("plain_f32_gate_share", "plain_vs_f64")):
                    row[key] = max(row.get(key, 0.0), report[pair]["share"])
                row["plain_f32_max_abs_err"] = max(row.get("plain_f32_max_abs_err", 0.0),
                                                   report["plain_vs_f64"]["max_abs_err"])
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


@contextlib.contextmanager
def kernel_run(label: str, runs: dict):
    """The block's run with every kernel count set to 0 just before it and
    read just after, and every kernel call kept (``tapped``, from any
    thread); records the run's calls, launches and seconds in
    ``runs[label]``."""
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
        yield
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {**rasterize_cuda.LAUNCHES, **mesh_raster_cuda.LAUNCHES}
    if [len(fwd), len(bwd), len(zt)] != [launches[k] for k in
                                          ("composite_fwd", "composite_bwd", "ztest")]:
        raise RuntimeError(f"the run {label} launched a kernel outside its caller")
    runs[label] = {"calls": (fwd, bwd, zt), "launches": launches, "wall_s": wall}
    print(f"[cli] {label}: {wall:.1f} s, launches {json.dumps(launches)}")


def drive_cli(label: str, cli, argv: list, runs: dict):
    """``cli.main(argv)`` as a ``kernel_run``; returns what it returns."""
    with kernel_run(label, runs):
        stats = cli.main(argv)
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
                  f"calls held against the plain version, {held_error(row)}{extra}")
    return shapes


def held_error(row: dict) -> str:
    """A held row's error: K2's against the plain version in float64, with
    the float32 plain version's beside it."""
    if "gate_share" not in row:
        return f"max abs err {row['max_abs_err']:.3e}"
    return (f"in float64 max abs err {row['max_abs_err']:.3e} (share of the gate "
            f"{row['gate_share']:.3f}), the plain version in float32 "
            f"{row['plain_f32_max_abs_err']:.3e} (share {row['plain_f32_gate_share']:.3f})")


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


# The formats phase: the port's JPEG decoder held against cv2's decodes of the
# checked-in fixtures (scripts/port_make_jpeg_fixtures.py; the card's machine
# has no cv2), and GrabCut on the card on the 512^2 photo against the port's
# CPU run and cv2's stored matte. Card against CPU: the same draws (a seeded
# CPU generator) and float64 on both, where exp and log may round apart in
# the last bit; against cv2: OpenCV's k-means draws from its own RNG.
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                             "port_jpeg")
PHOTO_512 = os.path.join(JPEG_FIXTURES, "photo_512.jpg")
JPEG_VARIANT_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                     "fixtures", "port_jpeg_variants")
PHOTO_512_ARITH = os.path.join(JPEG_VARIANT_FIXTURES, "photo_512_arith.jpg")
# The variants the card times: (file, what it is).
VARIANT_TIMED = (("photo_512_arith.jpg", "512^2 arithmetic-coded progressive"),
                 ("photo_1024x768_arith.jpg", "1024x768 arithmetic-coded sequential"),
                 ("photo_256_lossless.jpg", "256^2 lossless (SOF3, predictor 7)"))
IMAGE_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                              "port_images")
PHOTO_WEBP = os.path.join(IMAGE_FIXTURES, "photo_512_rgba.webp")
SPHERE_GLB = os.path.join(IMAGE_FIXTURES, "sphere_jpeg.glb")
TIFF_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                             "port_tiff")
PHOTO_TIFF = os.path.join(TIFF_FIXTURES, "photo_512_rgba.tif")
SPHERE_TIFF = os.path.join(TIFF_FIXTURES, "sphere_tiff.obj")
JP2_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                            "port_jp2")
JP2_ARCHIVAL_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                     "fixtures", "port_jp2_archival")
PHOTO_JP2 = os.path.join(JP2_ARCHIVAL_FIXTURES, "photo_512_rgba_archival.jp2")
SPHERE_JP2 = os.path.join(JP2_ARCHIVAL_FIXTURES, "sphere_jp2_archival.obj")
HDR_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                            "port_hdr")
SPHERE_HDR = os.path.join(HDR_FIXTURES, "sphere_hdr.obj")
TIFF_CODEC_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                   "fixtures", "port_tiff_codecs")
GRABCUT_IOU_CPU = 0.99
GRABCUT_IOU_CV2 = 0.95
DECODE_REPS = 5


def alpha_iou(a, b) -> float:
    """Intersection over union of two alphas' ``>= 128`` masks."""
    x, y = a >= 128, b >= 128
    return float((x & y).sum() / max((x | y).sum(), 1))


@contextlib.contextmanager
def grabcut_watch(record: dict):
    """Within the block, each GrabCut run's device and min-cut calls and
    host seconds in ``record``."""
    from dreamgaussian_tpu_torch.preprocess import grabcut

    real_cut, real_grabcut = grabcut.min_cut, grabcut.grabcut
    record.update(runs=[], cuts=0, cut_s=0.0)

    def min_cut(*args):
        t = time.perf_counter()
        out = real_cut(*args)
        record["cuts"] += 1
        record["cut_s"] += time.perf_counter() - t
        return out

    def run(*args, **kw):
        mask = real_grabcut(*args, **kw)
        record["runs"].append(str(mask.device))
        return mask

    grabcut.min_cut, grabcut.grabcut = min_cut, run
    try:
        yield
    finally:
        grabcut.min_cut, grabcut.grabcut = real_cut, real_grabcut


def run_formats(card: str) -> dict:
    """Every JPEG fixture decoded and held bit for bit against cv2's decode
    (the cut-off ones too; the one cv2 reads as None refused with
    ValueError), and read under IMREAD_COLOR against cv2's; GrabCut on the
    512^2 photo on the card (device ms of the pixel work, host ms of the
    min-cuts) against the CPU's and cv2's mattes."""
    import hashlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dreamgaussian_tpu_torch.preprocess.grabcut import ITERATIONS, grabcut_alpha
    from dreamgaussian_tpu_torch.utils.imread import IMREAD_COLOR, decode_image
    from dreamgaussian_tpu_torch.utils.jpeg import decode_jpeg
    from dreamgaussian_tpu_torch.utils.png import read_png

    with open(os.path.join(JPEG_FIXTURES, "decodes.json")) as fh:
        digests = json.load(fh)
    decode_ms = {}
    for name, want in sorted(digests.items()):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as fh:
            data = fh.read()
        if want["shape"] is None:
            for read in (lambda: decode_jpeg(data), lambda: decode_image(data, IMREAD_COLOR)):
                try:
                    read()
                except ValueError:
                    continue
                raise RuntimeError(f"{name}: decoded where cv2's decode is None")
            print(f"[formats] {name}: refused (ValueError) under both flags, as cv2 returns "
                  f"None; card '{card}'")
            continue
        colour = decode_image(data, IMREAD_COLOR)
        digest = hashlib.sha256(np.ascontiguousarray(colour).tobytes()).hexdigest()
        if [list(colour.shape), digest] != [want["color"]["shape"], want["color"]["sha256"]]:
            raise RuntimeError(f"{name} (IMREAD_COLOR): read {list(colour.shape)} (SHA-256 "
                               f"{digest[:16]}) against cv2's {want['color']}")
        times = []
        for _ in range(DECODE_REPS):
            t = time.perf_counter()
            got = decode_jpeg(data)
            times.append((time.perf_counter() - t) * 1e3)
        digest = hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest()
        npy = os.path.join(JPEG_FIXTURES, name.replace(".jpg", ".npy"))
        err = (int(np.abs(got.astype(np.int32) - np.load(npy)).max())
               if os.path.exists(npy) and got.shape == np.load(npy).shape else 0)
        if list(got.shape) != want["shape"] or digest != want["sha256"] or err:
            raise RuntimeError(f"{name}: decoded {got.shape} (SHA-256 {digest[:16]}, max abs "
                               f"err {err}) against cv2's {want['shape']} {want['sha256'][:16]}")
        decode_ms[name] = statistics.median(times)
        print(f"[formats] {name} {list(got.shape)}: equal to cv2's decode bit for bit (SHA-256 "
              f"{digest[:16]}), and under IMREAD_COLOR, decoded in a median "
              f"{decode_ms[name]:.2f} ms of {DECODE_REPS} on the host; card '{card}'")

    decode_ms.update(check_jpeg_variants(card))
    decode_ms.update(check_image_fixtures(card))

    with open(PHOTO_512, "rb") as fh:
        img = decode_jpeg(fh.read())
    cv2_alpha = read_png(os.path.join(JPEG_FIXTURES, "photo_512_alpha.png"))
    grabcut_alpha(img[:128, :128], device="cuda")       # warm-up: the card's first kernels
    watch: dict = {}
    torch.cuda.synchronize()
    with grabcut_watch(watch), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        card_alpha = grabcut_alpha(img, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    device_ms = sum(device_ms_by_name(prof).values())
    t = time.perf_counter()
    cpu_alpha = grabcut_alpha(img, device="cpu")
    cpu_s = time.perf_counter() - t
    iou_cpu, iou_cv2 = alpha_iou(card_alpha, cpu_alpha), alpha_iou(card_alpha, cv2_alpha)
    if (watch["runs"] != ["cuda:0"] or watch["cuts"] != ITERATIONS or iou_cpu < GRABCUT_IOU_CPU
            or iou_cv2 < GRABCUT_IOU_CV2):
        raise RuntimeError(f"GrabCut on the card: runs {watch['runs']}, {watch['cuts']} min-cuts, "
                           f"IoU {iou_cpu:.4f} against the CPU (gate {GRABCUT_IOU_CPU}), "
                           f"{iou_cv2:.4f} against cv2 (gate {GRABCUT_IOU_CV2})")
    out = {"decode_ms": decode_ms, "grabcut_wall_s": wall_s, "grabcut_device_ms": device_ms,
           "grabcut_min_cut_ms": watch["cut_s"] * 1e3, "grabcut_cpu_s": cpu_s,
           "iou_cpu": iou_cpu, "iou_cv2": iou_cv2,
           "differ_cpu": int((card_alpha != cpu_alpha).sum())}
    print(f"[formats] GrabCut of the 512^2 photo on the card: {wall_s * 1e3:.1f} ms of wall, "
          f"{device_ms:.1f} ms of device time (the pixel work), {watch['cut_s'] * 1e3:.1f} ms "
          f"of host min-cut ({ITERATIONS} cuts); the port's CPU run {cpu_s * 1e3:.1f} ms; "
          f"alpha>=128 IoU against the CPU {iou_cpu:.4f} ({out['differ_cpu']} alpha values "
          f"differ; gate {GRABCUT_IOU_CPU}), against cv2's stored matte {iou_cv2:.4f} (gate "
          f"{GRABCUT_IOU_CV2}); card '{card}'")
    return out


def check_jpeg_variants(card: str) -> dict:
    """Every fixture of ``scripts/port_make_jpeg_variant_fixtures.py`` read
    by the port (``read_image``, as cv2.imread reads the cut ones) under
    IMREAD_UNCHANGED and IMREAD_COLOR and held bit for bit against cv2's
    stored decode (shape and SHA-256; the small files' arrays too), or
    refused with ValueError where cv2's is None; the host's median ms of
    ``DECODE_REPS`` reads of the ``VARIANT_TIMED`` photos."""
    import hashlib

    import numpy as np

    from dreamgaussian_tpu_torch.utils.imread import IMREAD_COLOR, IMREAD_UNCHANGED, read_image

    with open(os.path.join(JPEG_VARIANT_FIXTURES, "decodes.json")) as fh:
        digests = json.load(fh)
    out, refused = {}, []
    for name, want in sorted(digests.items()):
        path = os.path.join(JPEG_VARIANT_FIXTURES, name)
        parts = []
        for key, flags in (("unchanged", IMREAD_UNCHANGED), ("color", IMREAD_COLOR)):
            w = want if key == "unchanged" else want["color"]
            if w is None or w["sha256"] is None:
                try:
                    read_image(path, flags)
                except ValueError:
                    parts.append(None)
                    continue
                raise RuntimeError(f"{name} ({key}): read where cv2's decode is None")
            times = []
            for _ in range(DECODE_REPS if name in dict(VARIANT_TIMED) else 1):
                t = time.perf_counter()
                got = read_image(path, flags)
                times.append((time.perf_counter() - t) * 1e3)
            digest = hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest()
            npy = path.replace(".jpg", ".npy")
            err = (int(np.abs(got.astype(np.int32) - np.load(npy)).max())
                   if key == "unchanged" and os.path.exists(npy)
                   and got.shape == np.load(npy).shape else 0)
            if [list(got.shape), digest] != [w["shape"], w["sha256"]] or err:
                raise RuntimeError(f"{name} ({key}): read {list(got.shape)} (SHA-256 "
                                   f"{digest[:16]}, max abs err {err}) against cv2's {w}")
            out[f"{name} {key}"] = statistics.median(times)
            parts.append(f"{key} {list(got.shape)} SHA-256 {digest[:16]}")
        if parts == [None, None]:
            refused.append(name)
            continue
        parts = [p or "refused (ValueError) as cv2 returns None" for p in parts]
        print(f"[formats] {name}: equal to cv2's decode bit for bit ({'; '.join(parts)}); "
              f"card '{card}'")
    print(f"[formats] {len(refused)} variant JPEGs refused with ValueError under both flags, "
          f"as cv2 returns None: {', '.join(refused)}; card '{card}'")
    timed = {what: out[f"{name} unchanged"] for name, what in VARIANT_TIMED}
    print(f"[formats] JPEG variants, IMREAD_UNCHANGED median host ms of {DECODE_REPS}: "
          f"{json.dumps(timed)}; card '{card}'")
    return out


def check_image_fixtures(card: str) -> dict:
    """Every fixture of ``scripts/port_make_image_fixtures.py`` and
    ``scripts/port_make_tiff_fixtures.py`` (each with its second set: Radiance
    HDR, PFM and Sun raster; the TIFF codecs) and
    ``scripts/port_make_jp2_fixtures.py`` (both of its sets) read by the port under
    IMREAD_UNCHANGED and IMREAD_COLOR (``utils/imread.py``), the GLB and
    the OBJs through ``Mesh.load``, each held bit for bit against cv2's
    stored decode (shape, dtype, SHA-256; the 83x61 files' arrays too), or
    refused where cv2's is undefined (NotImplementedError) or None
    (ValueError); one line each with the host's median ms of
    ``DECODE_REPS`` reads."""
    import hashlib

    import numpy as np

    from dreamgaussian_tpu_torch.meshing.mesh import Mesh
    from dreamgaussian_tpu_torch.utils.imread import IMREAD_COLOR, IMREAD_UNCHANGED, decode_image

    textures = {"tex_grey.obj": "tex_grey.png", "tex_palette.obj": "tex_palette.png",
                "tex_exif.obj": "tex_exif.jpg", "sphere_jpeg.glb": "sphere_jpeg.glb",
                "sphere_tiff.obj": "sphere_tiff.tif", "sphere_jp2.obj": "sphere_jp2.jp2",
                "sphere_jp2_archival.obj": "sphere_jp2_archival.jp2",
                "sphere_hdr.obj": "sphere_hdr.hdr"}

    def timed(fn):
        times, out = [], None
        for _ in range(DECODE_REPS):
            t = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t) * 1e3)
        return out, statistics.median(times)

    out = {}
    for folder, none_means in ((IMAGE_FIXTURES, NotImplementedError), (TIFF_FIXTURES, ValueError),
                               (JP2_FIXTURES, ValueError), (JP2_ARCHIVAL_FIXTURES, ValueError),
                               (HDR_FIXTURES, ValueError), (TIFF_CODEC_FIXTURES, ValueError)):
        with open(os.path.join(folder, "decodes.json")) as fh:
            digests = json.load(fh)
        small = np.load(os.path.join(folder, "small_decodes.npz"))

        def held(name: str, key: str, got) -> str:
            want = digests[name][key]
            digest = hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest()
            err = (int((got.view(np.uint8) != small[name].view(np.uint8)).sum())
                   if key == "unchanged" and name in small.files and got.shape == small[name].shape
                   and got.dtype == small[name].dtype else 0)
            if ([list(got.shape), str(got.dtype), digest] != [want["shape"], want["dtype"],
                                                              want["sha256"]] or err):
                raise RuntimeError(f"{name} ({key}): read {got.dtype} {list(got.shape)} (SHA-256 "
                                   f"{digest[:16]}, {err} bytes differ) against cv2's {want}")
            return digest

        for name in sorted(digests):
            if name.endswith(".glb"):
                continue
            path = os.path.join(folder, name)
            with open(path, "rb") as fh:
                data = fh.read()
            parts = []
            for key, flags in (("unchanged", IMREAD_UNCHANGED), ("color", IMREAD_COLOR)):
                if digests[name][key] is None:
                    try:
                        decode_image(data, flags, path)
                    except none_means:
                        parts.append(f"{key}: refused as cv2 " + (
                            "leaves it in part unwritten" if none_means is NotImplementedError
                            else "returns None"))
                        continue
                    raise RuntimeError(f"{name} ({key}): read where cv2's decode is "
                                       f"{'undefined' if none_means is NotImplementedError else 'None'}")
                got, ms = timed(lambda: decode_image(data, flags, path))
                digest = held(name, key, got)
                out[f"{name} {key}"] = ms
                parts.append(f"{key} {got.dtype} {list(got.shape)} SHA-256 {digest[:16]} in a "
                             f"median {ms:.2f} ms")
            print(f"[formats] {name}: equal to cv2's decode bit for bit ({'; '.join(parts)} of "
                  f"{DECODE_REPS} on the host); card '{card}'")
        for mesh_file, tex in textures.items():
            if not os.path.exists(os.path.join(folder, mesh_file)):
                continue
            mesh, ms = timed(lambda: Mesh.load(os.path.join(folder, mesh_file), resize=False))
            albedo = np.rint(mesh.albedo * 255).astype(np.uint8)
            digest = held(tex, "color", albedo)
            out[mesh_file] = ms
            print(f"[formats] {mesh_file}: albedo {list(albedo.shape)} equal to cv2's "
                  f"IMREAD_COLOR decode of {tex} bit for bit (SHA-256 {digest[:16]}), Mesh.load "
                  f"in a median {ms:.2f} ms of {DECODE_REPS}; card '{card}'")
    big = {k: out[k] for k in ("photo_1024x768.webp color", "photo_1024x768_jpeg.tif color",
                               "photo_1024x768_lossy.jp2 color",
                               "photo_1024x768_bypass.jp2 color",
                               "photo_1024x768_lossless.jp2 color")}
    print(f"[formats] 1024x768 photos, IMREAD_COLOR median host ms: {json.dumps(big)} (the "
          f"JPEG's is its decode_jpeg line above); card '{card}'")
    hdr = {k: out[k] for k in ("env_1024x512.hdr unchanged", "logluv_256.tif unchanged")}
    print(f"[formats] float decodes, IMREAD_UNCHANGED median host ms of {DECODE_REPS}: the "
          f"1024x512 RLE Radiance HDR {hdr['env_1024x512.hdr unchanged']:.2f}, the 256^2 SGILog "
          f"TIFF {hdr['logluv_256.tif unchanged']:.2f}; card '{card}'")
    return out


def write_sun_raster(jpeg: str, path: str) -> str:
    """The JPEG's decode written as a 24-bit RT_STANDARD Sun raster (the
    32-byte big-endian header, BGR rows padded to 16 bits); the port's read
    of it must equal those pixels. Returns ``path``."""
    import struct

    import numpy as np

    from dreamgaussian_tpu_torch.utils.imread import read_image
    from dreamgaussian_tpu_torch.utils.jpeg import decode_jpeg

    with open(jpeg, "rb") as fh:
        rgb = decode_jpeg(fh.read())
    h, w = rgb.shape[:2]
    rows = rgb[..., ::-1].reshape(h, 3 * w)
    rows = np.pad(rows, ((0, 0), (0, rows.shape[1] & 1)))
    with open(path, "wb") as fh:
        fh.write(struct.pack(">8I", 0x59A66A95, w, h, 24, rows.size, 1, 0, 0) + rows.tobytes())
    back = read_image(path)
    if back.shape != rgb.shape or not np.array_equal(back, rgb):
        raise RuntimeError(f"the Sun raster of {os.path.basename(jpeg)} read back as "
                           f"{back.dtype} {back.shape}, not its pixels")
    return path


def run_weights_day(seed: int, card: str, load_alone: subprocess.Popen) -> dict:
    """The full-width snapshot written, loaded and driven through both CLIs
    (see WEIGHTS_STOP); every kernel call of the CLI runs held against its
    plain version."""
    import numpy as np
    import torch

    from dreamgaussian_tpu_torch.cli import main as cli1
    from dreamgaussian_tpu_torch.cli import main2 as cli2
    from dreamgaussian_tpu_torch.guidance import synthetic
    from dreamgaussian_tpu_torch.guidance.unet import ZERO123_CONFIG
    from dreamgaussian_tpu_torch.guidance.vae import VAEConfig
    from dreamgaussian_tpu_torch.meshing.mesh import Mesh
    from dreamgaussian_tpu_torch.preprocess.grabcut import ITERATIONS
    from dreamgaussian_tpu_torch.utils.imread import read_image

    runs: dict = {}
    saved, restored, losses = [], [], []
    sai_matte: dict = {}
    webp_matte: dict = {}
    tiff_matte: dict = {}
    jp2_matte: dict = {}
    ras_matte: dict = {}
    glb_albedo = Mesh.load(SPHERE_GLB, resize=False).albedo
    tiff_albedo = Mesh.load(SPHERE_TIFF, resize=False).albedo
    jp2_albedo = Mesh.load(SPHERE_JP2, resize=False).albedo
    hdr_albedo = Mesh.load(SPHERE_HDR, resize=False).albedo
    os.environ.pop("DG_U2NET_CKPT", None)       # the JPEG is matted by GrabCut
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
            with grabcut_watch(sai_matte):
                sai = drive_cli("image_sai stage 1", cli1,
                                ["--config", os.path.join(CONFIGS, "image_sai.yaml"),
                                 f"input={PHOTO_512_ARITH}", "save_path=sai", f"outdir={tmp}",
                                 f"seed={seed}", f"zero123_ckpt={snap}", f"iters={SAI_ITERS}",
                                 "save_mesh=False"], runs)
            # A user's inputs in the formats the port reads since the image
            # slice: the lossy RGBA WebP photo through stage 1 (its alpha
            # kept: no matting), and a GLB with a JPEG base colour refined.
            webp_argv = ["--config", os.path.join(CONFIGS, "image.yaml"), f"input={PHOTO_WEBP}",
                         f"outdir={tmp}", f"seed={seed}", f"zero123_ckpt={snap}"]
            with grabcut_watch(webp_matte):
                webp = drive_cli("webp stage 1", cli1, webp_argv + [
                    "save_path=webp", f"iters={SAI_ITERS}", "save_mesh=False"], runs)
            glb = drive_cli("glb stage 2", cli2, webp_argv + [
                "save_path=glb", f"mesh={SPHERE_GLB}", f"iters_refine={WEIGHTS_REFINE}"], runs)
            # A cut-out TIFF (LZW, unassociated alpha: premultiplied as cv2
            # reads it) through stage 1, and an OBJ with a tiled TIFF texture.
            tiff_argv = ["--config", os.path.join(CONFIGS, "image.yaml"), f"input={PHOTO_TIFF}",
                         f"outdir={tmp}", f"seed={seed}", f"zero123_ckpt={snap}"]
            with grabcut_watch(tiff_matte):
                tiff = drive_cli("tiff stage 1", cli1, tiff_argv + [
                    "save_path=tiff", f"iters={SAI_ITERS}", "save_mesh=False"], runs)
            tiff_mesh = drive_cli("tiff stage 2", cli2, tiff_argv + [
                "save_path=tiffmesh", f"mesh={SPHERE_TIFF}", f"iters_refine={WEIGHTS_REFINE}"],
                runs)
            # A lossless RGBA JP2 cut-out with archival coding options
            # through stage 1, and an OBJ whose texture is a BYPASS-coded
            # JP2 in 32^2 tiles with PPT and RGN markers.
            jp2_argv = ["--config", os.path.join(CONFIGS, "image.yaml"), f"input={PHOTO_JP2}",
                        f"outdir={tmp}", f"seed={seed}", f"zero123_ckpt={snap}"]
            with grabcut_watch(jp2_matte):
                jp2 = drive_cli("jp2 stage 1", cli1, jp2_argv + [
                    "save_path=jp2", f"iters={SAI_ITERS}", "save_mesh=False"], runs)
            jp2_mesh = drive_cli("jp2 stage 2", cli2, jp2_argv + [
                "save_path=jp2mesh", f"mesh={SPHERE_JP2}", f"iters_refine={WEIGHTS_REFINE}"],
                runs)
            # The 512^2 JPEG photo as a 24-bit Sun raster (matted by GrabCut on
            # the card), and an OBJ whose texture is an RLE Radiance HDR (its
            # reference view the RGBA WebP's, which needs no second matting).
            ras = write_sun_raster(PHOTO_512, os.path.join(tmp, "photo_512.ras"))
            ras_argv = ["--config", os.path.join(CONFIGS, "image.yaml"), f"input={ras}",
                        f"outdir={tmp}", f"seed={seed}", f"zero123_ckpt={snap}"]
            with grabcut_watch(ras_matte):
                ras_run = drive_cli("ras stage 1", cli1, ras_argv + [
                    "save_path=ras", f"iters={SAI_ITERS}", "save_mesh=False"], runs)
            hdr_mesh = drive_cli("hdr stage 2", cli2, webp_argv + [
                "save_path=hdrmesh", f"mesh={SPHERE_HDR}", f"iters_refine={WEIGHTS_REFINE}"],
                runs)
        n, faces = read_outputs(tmp, "weights", image_options()["texture_size"],
                                image_options()["capacity"])
    if sai_matte["runs"] != ["cuda:0"] or sai_matte["cuts"] != ITERATIONS:
        raise RuntimeError(f"the image_sai run's JPEG was not matted by GrabCut on the card: "
                           f"{sai_matte}")
    if not np.array_equal(read_image(PHOTO_512_ARITH), read_image(PHOTO_512)):
        raise RuntimeError("the arithmetic-coded photo does not decode to photo_512.jpg's pixels")
    print(f"[weights] image_sai input {os.path.relpath(PHOTO_512_ARITH)}: an arithmetic-coded "
          f"progressive JPEG decoded by the port (equal to "
          f"{os.path.relpath(PHOTO_512)}'s pixels, checked), matted by GrabCut on "
          f"{sai_matte['runs'][0]} ({sai_matte['cuts']} host min-cuts, "
          f"{sai_matte['cut_s'] * 1e3:.1f} ms), recentred; card '{card}'")
    if webp_matte["runs"] or glb_albedo is None or glb_albedo.shape != (512, 512, 3):
        raise RuntimeError(f"the WebP photo was matted ({webp_matte}) or the GLB's JPEG base "
                           f"colour was not read ({None if glb_albedo is None else glb_albedo.shape})")
    print(f"[weights] webp input {os.path.relpath(PHOTO_WEBP)}: a lossy RGBA WebP decoded by the "
          f"port, its alpha kept (no matting), {SAI_ITERS} stage-1 steps in "
          f"{runs['webp stage 1']['wall_s']:.1f} s; glb mesh {os.path.relpath(SPHERE_GLB)}: its "
          f"512^2 JPEG base colour read by the port, {WEIGHTS_REFINE} stage-2 steps in "
          f"{runs['glb stage 2']['wall_s']:.1f} s (loss {glb['loss']:.5f}); card '{card}'")
    if tiff_matte["runs"] or tiff_albedo is None or tiff_albedo.shape != (128, 128, 3):
        raise RuntimeError(f"the TIFF photo was matted ({tiff_matte}) or the OBJ's TIFF texture "
                           f"was not read ({None if tiff_albedo is None else tiff_albedo.shape})")
    print(f"[weights] tiff input {os.path.relpath(PHOTO_TIFF)}: an LZW RGBA TIFF decoded by the "
          f"port (unassociated alpha premultiplied, as cv2 reads it), its alpha kept, "
          f"{SAI_ITERS} stage-1 steps in {runs['tiff stage 1']['wall_s']:.1f} s; obj mesh "
          f"{os.path.relpath(SPHERE_TIFF)}: its 128^2 tiled LZW TIFF texture read by the port, "
          f"{WEIGHTS_REFINE} stage-2 steps in {runs['tiff stage 2']['wall_s']:.1f} s (loss "
          f"{tiff_mesh['loss']:.5f}); card '{card}'")
    if jp2_matte["runs"] or jp2_albedo is None or jp2_albedo.shape != (128, 128, 3):
        raise RuntimeError(f"the JP2 photo was matted ({jp2_matte}) or the OBJ's JP2 texture "
                           f"was not read ({None if jp2_albedo is None else jp2_albedo.shape})")
    print(f"[weights] jp2 input {os.path.relpath(PHOTO_JP2)}: a lossless RGBA JPEG 2000 with "
          f"SOP/EPH markers and RESET|RESTART|CAUSAL|ERTERM|SEGMARK code-blocks decoded by the "
          f"port, its alpha kept, {SAI_ITERS} stage-1 steps in "
          f"{runs['jp2 stage 1']['wall_s']:.1f} s; obj mesh {os.path.relpath(SPHERE_JP2)}: its "
          f"128^2 BYPASS-coded JP2 texture in 32^2 tiles with PPT and RGN markers read by the "
          f"port, {WEIGHTS_REFINE} stage-2 steps in {runs['jp2 stage 2']['wall_s']:.1f} s (loss "
          f"{jp2_mesh['loss']:.5f}); card '{card}'")
    if ras_matte["runs"] != ["cuda:0"] or ras_matte["cuts"] != ITERATIONS:
        raise RuntimeError(f"the Sun raster photo was not matted by GrabCut on the card: "
                           f"{ras_matte}")
    if hdr_albedo is None or hdr_albedo.shape != (128, 128, 3):
        raise RuntimeError(f"the OBJ's Radiance HDR texture was not read "
                           f"({None if hdr_albedo is None else hdr_albedo.shape})")
    print(f"[weights] ras input: the 512^2 JPEG photo's decode written as a 24-bit Sun raster "
          f"and read back equal to those pixels, matted by GrabCut on {ras_matte['runs'][0]} "
          f"({ras_matte['cuts']} host min-cuts, {ras_matte['cut_s'] * 1e3:.1f} ms), "
          f"{SAI_ITERS} stage-1 steps in {runs['ras stage 1']['wall_s']:.1f} s; obj mesh "
          f"{os.path.relpath(SPHERE_HDR)}: its 128^2 RLE Radiance HDR texture read by the port "
          f"(times 255, saturated, as cv2 reads it under IMREAD_COLOR), {WEIGHTS_REFINE} stage-2 "
          f"steps in {runs['hdr stage 2']['wall_s']:.1f} s (loss {hdr_mesh['loss']:.5f}); "
          f"card '{card}'")
    if (first["step"], resumed["step"], sai["step"], webp["step"], tiff["step"],
            jp2["step"], ras_run["step"]) != (WEIGHTS_STOP, WEIGHTS_ITERS, SAI_ITERS, SAI_ITERS,
                                              SAI_ITERS, SAI_ITERS, SAI_ITERS):
        raise RuntimeError(f"stage-1 runs ended at steps {first['step']}, {resumed['step']}, "
                           f"{sai['step']}, {webp['step']}, {tiff['step']}, {jp2['step']}, "
                           f"{ras_run['step']}")
    if len(saved) != 1 or len(restored) != 1 or restored[0]["step"] != WEIGHTS_STOP:
        raise RuntimeError(f"expected one checkpoint at step {WEIGHTS_STOP} saved and restored, "
                           f"got {len(saved)} saved, {len(restored)} restored")
    differ = [k for k, v in saved[0].items() if not (
        torch.equal(v, restored[0][k]) if isinstance(v, torch.Tensor) else v == restored[0][k])]
    if differ:
        raise RuntimeError(f"the resumed trainer's state differs from the saved one in {differ}")
    n_steps = WEIGHTS_STOP + (WEIGHTS_ITERS - WEIGHTS_STOP) + 5 * SAI_ITERS
    if len(losses) != n_steps or not all(math.isfinite(x) for x in losses + [
            refined["loss"], glb["loss"], tiff_mesh["loss"], jp2_mesh["loss"], hdr_mesh["loss"]]):
        raise RuntimeError(f"stage-1 losses {losses}, stage-2 losses {refined['loss']}, "
                           f"{glb['loss']}, {tiff_mesh['loss']}, {jp2_mesh['loss']}, "
                           f"{hdr_mesh['loss']}")
    launches = {k: v["launches"] for k, v in runs.items()}
    k1k2 = ("composite_fwd", "composite_bwd")
    if (any(launches[k][name] < 1 for k in launches if "stage 1" in k for name in k1k2)
            or launches["stage 1 resumed, export"]["ztest"] != 26
            or launches["stage 2"]["ztest"] != 3 * WEIGHTS_REFINE
            or launches["glb stage 2"]["ztest"] != 3 * WEIGHTS_REFINE
            or launches["tiff stage 2"]["ztest"] != 3 * WEIGHTS_REFINE
            or launches["jp2 stage 2"]["ztest"] != 3 * WEIGHTS_REFINE
            or launches["hdr stage 2"]["ztest"] != 3 * WEIGHTS_REFINE):
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


# The apps day: a photo (the disc without its alpha) matted by a random
# full-width U2Net through cli.process, then the batch script
# (scripts/port_runall.py --video: stage 1, stage 2 and a turntable), the
# turntables of its PLY (a GIF) and OBJ (an H.264 MP4) through cli.render
# (36 frames at 512^2), the metrics (cli.eval) with a random full-width
# VGG16, lpips lins and the CLIP ViT-L/14 image_encoder/ of a full-width
# Zero123 snapshot, novel views on that snapshot (cli.novel_view), the
# viewer on the PLY and on the mesh and live on configs/image.yaml
# (cli.serve), and a stage-1 and a stage-2 job of the web app (cli.webapp). The batch and web-app runs are cut in depth (APPS_ARGS).
APPS_FRAMES, APPS_SIZE, APPS_REF = 36, 512, 256
APPS_ARGS = ["fake_guidance=True", "iters=12", "iters_refine=2", "density_start_iter=4",
             "densification_interval=4", "density_thresh=0.2", "final_prune=False",
             "mc_resolution=64", "decimate_target=20000", "texture_size=256",
             "bake_resolution=256"]
RUNALL_VIDEO = (36, 512, 512, 3)      # the batch script's turntable: cli.render's defaults
APPS_FPS = 15                         # cli.render's default
MP4_PSNR_DB = 30.0                    # the turntable MP4 in RGB, as tests/test_torch_mp4.py
NOVEL_HORS, NOVEL_STEPS = ("-60", "60", "180"), 10
SERVE_REQUESTS, LIVE_STEPS = 10, 5
U2NET_TOL = 1e-4    # U2Net's matte on the card against the CPU's (float32, TF32 off)


def get_url(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=120) as r:
        return r.read()


@contextlib.contextmanager
def served(handler):
    """``handler`` served on a free local port in a thread: yields its URL."""
    import threading
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def drive_viewer(label: str, state, size: int, runs: dict) -> dict:
    """``/``, ``/render`` in the three modes (each PNG decoded, its size
    checked), ``/status``, then the median ms of SERVE_REQUESTS renders as
    the client sees them; all as one kernel run."""
    import numpy as np

    from dreamgaussian_tpu_torch.cli import serve
    from dreamgaussian_tpu_torch.utils.png import decode_png

    with kernel_run(label, runs), served(serve.make_handler(state)) as url:
        if b"viewer" not in get_url(url + "/"):
            raise RuntimeError(f"{label}: the page is not the viewer's")
        spread = {}
        for mode in ("image", "depth", "alpha"):
            img = decode_png(get_url(f"{url}/render?elev=15&azim=30&radius=2&mode={mode}"))
            if img.shape != (size, size, 3):
                raise RuntimeError(f"{label}: /render {mode} gave a {img.shape} PNG")
            spread[mode] = float(img.std())
        ms = []
        for i in range(SERVE_REQUESTS):
            t = time.perf_counter()
            get_url(f"{url}/render?elev={5 * i}&azim={36 * i}&radius=2.2&mode=image")
            ms.append(1e3 * (time.perf_counter() - t))
        status = json.loads(get_url(url + "/status"))
    if min(spread.values()) == 0.0:
        raise RuntimeError(f"{label}: a mode rendered a flat image: {spread}")
    return {"median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms),
            "spread": spread, "status": status}


def drive_live_viewer(png: str, runs: dict) -> dict:
    """``cli.serve``'s live mode on configs/image.yaml with the fake guidance:
    training on until ``/status`` shows LIVE_STEPS steps with a finite loss,
    a ``/render``, training off, the trainer's thread ended."""
    import numpy as np

    from dreamgaussian_tpu_torch.cli import serve
    from dreamgaussian_tpu_torch.utils.png import decode_png

    state = serve.make_live_state(os.path.join(CONFIGS, "image.yaml"),
                                  [f"input={png}", "fake_guidance=True"], APPS_SIZE)
    try:
        with kernel_run("serve live", runs), served(serve.make_handler(state)) as url:
            get_url(url + "/train?on=1")
            deadline = time.time() + 120
            while time.time() < deadline:
                st = json.loads(get_url(url + "/status"))
                if st["step"] >= LIVE_STEPS and st["loss"] is not None:
                    break
                time.sleep(0.05)
            img = decode_png(get_url(url + "/render?elev=10&azim=45&mode=image"))
            get_url(url + "/train?on=0")
            state.close()          # the step in flight ends before the counts are read
            st = json.loads(get_url(url + "/status"))
    finally:
        state.close()
    if st["step"] < LIVE_STEPS or not math.isfinite(st["loss"]) or img.shape != (
            APPS_SIZE, APPS_SIZE, 3):
        raise RuntimeError(f"the live viewer did not train: {st}, render {img.shape}")
    return {"steps": st["step"], "loss": st["loss"]}


def drive_webapp(data: str, outdir: str, png: str, runs: dict) -> dict:
    """A stage-1 and then a stage-2 job of ``cli.webapp`` on ``png`` through
    its routes, each polled until it ends with ``[webapp] done``; each orbit
    GIF read back."""
    from dreamgaussian_tpu_torch.cli import webapp
    from dreamgaussian_tpu_torch.utils.gif import read_gif

    state = webapp.AppState(data, outdir, APPS_ARGS, device="cuda")
    out = {}
    with served(webapp.make_handler(state)) as url:
        if os.path.basename(png).encode() not in get_url(url + "/"):
            raise RuntimeError("the web app does not list its input")
        for stage in (1, 2):
            with kernel_run(f"webapp stage {stage}", runs):
                err = json.loads(get_url(f"{url}/run?stage={stage}&input={png}"))["error"]
                if err:
                    raise RuntimeError(f"the web app refused stage {stage}: {err}")
                while json.loads(get_url(url + "/status"))["running"]:
                    time.sleep(0.1)
            st = json.loads(get_url(url + "/status"))
            if not st["log"].endswith("[webapp] done"):
                raise RuntimeError(f"the web app's stage {stage} failed:\n{st['log']}")
            frames, delay = read_gif(st["artifact"])
            if frames.shape != (webapp.ORBIT_FRAMES, webapp.ORBIT_SIZE, webapp.ORBIT_SIZE, 3):
                raise RuntimeError(f"the web app's stage-{stage} GIF holds {frames.shape}")
            if get_url(f"{url}/artifact?path={st['artifact']}")[:6] != b"GIF89a":
                raise RuntimeError("the web app did not serve its GIF")
            out[stage] = {"s": runs[f"webapp stage {stage}"]["wall_s"],
                          "gif": list(frames.shape), "mesh": os.path.basename(st["mesh"])}
    return out


def check_mp4(path: str, info: dict, frames: list, card: str) -> dict:
    """The turntable MP4 that cli.render wrote at ``path`` (``info``: its
    read_mp4) and the encoder on ``frames``, the same views rendered again
    (the CLI's run loaded the library): the host ms per frame of
    ``encode_mp4``, the file's bytes, and its
    reconstruction at the CPU test's PSNR bound (there is no decoder on this
    machine; tests/test_torch_mp4.py holds the reconstruction against
    ffmpeg's decode)."""
    import numpy as np

    from dreamgaussian_tpu_torch.utils import mp4

    imgs = [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in frames]
    t0 = time.perf_counter()
    data, rec = mp4.encode_mp4(imgs, APPS_FPS)
    ms = 1e3 * (time.perf_counter() - t0) / len(imgs)
    t0 = time.perf_counter()
    for f in imgs:
        mp4.rgb_to_yuv420p(f)
    yuv_ms = 1e3 * (time.perf_counter() - t0) / len(imgs)
    rgb = mp4.yuv420p_to_rgb(*rec).astype(np.float64)
    psnr = [10 * math.log10(255.0 ** 2 / max(np.mean((r - f) ** 2), 1e-12))
            for r, f in zip(rgb, np.asarray(imgs, np.float64))]
    size = os.path.getsize(path)
    raw = len(imgs) * APPS_SIZE * APPS_SIZE * 3 // 2
    if min(psnr) < MP4_PSNR_DB or size >= raw / 4 or info["profile_idc"] != 66:
        raise RuntimeError(f"the turntable MP4: PSNR {min(psnr):.2f} dB (gate {MP4_PSNR_DB}), "
                           f"{size} bytes of {raw} raw, profile {info['profile_idc']}")
    out = {"bytes": size, "encoded_bytes": len(data), "raw_yuv420p_bytes": raw,
           "encode_ms_per_frame": ms, "rgb_to_yuv_ms_per_frame": yuv_ms,
           "min_psnr_db": min(psnr), "level_idc": info["level_idc"]}
    print(f"[apps] cli.render mesh.mp4: {len(info['sample_sizes'])} samples of "
          f"{info['width']}x{info['height']} at {APPS_FPS} fps, level_idc {info['level_idc']}, "
          f"{size} bytes ({size / raw:.4f} of raw yuv420p); host encode_mp4 {ms:.2f} ms per "
          f"frame (its colour conversion alone {yuv_ms:.2f}); reconstruction PSNR min {min(psnr):.2f} dB (gate {MP4_PSNR_DB}); "
          f"card '{card}'")
    return out


def run_apps_day(seed: int, card: str, work: str) -> dict:
    """The apps day (see APPS_ARGS); every K1, K2 and K3 call of each run held
    against its plain version right after the run."""
    import shutil

    import numpy as np
    import torch

    from dreamgaussian_tpu_torch.cli import eval as cli_eval
    from dreamgaussian_tpu_torch.cli import novel_view, process, render, serve
    from dreamgaussian_tpu_torch.guidance import synthetic
    from dreamgaussian_tpu_torch.guidance.unet import ZERO123_CONFIG
    from dreamgaussian_tpu_torch.guidance.vae import VAEConfig
    from dreamgaussian_tpu_torch.preprocess.u2net import u2net_alpha
    from dreamgaussian_tpu_torch.utils.gif import read_gif
    from dreamgaussian_tpu_torch.utils.mp4 import read_mp4
    from dreamgaussian_tpu_torch.utils.png import read_png, write_png

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import port_runall

    tmp = os.path.join(work, "apps")
    data, logs = os.path.join(tmp, "data"), os.path.join(tmp, "logs")
    os.makedirs(data)
    runs: dict = {}
    shapes: dict = {"composite_fwd": [], "composite_bwd": [], "ztest": []}
    launches = {"composite_fwd": 0, "composite_bwd": 0, "ztest": 0}
    summary: dict = {}

    def held(label: str):
        """Hold the run's kernel calls now and drop them."""
        for k, rows in hold_cli_calls({label: runs[label]}, "apps-day").items():
            shapes[k] += rows
        for k in launches:
            launches[k] += runs[label]["launches"][k]
        runs[label]["calls"] = None

    # cli.process on an RGB PNG with a full-width u2net.pth; the matte card against CPU.
    u2 = os.path.join(tmp, "u2net.pth")
    n_u2 = synthetic.write_u2net(u2, full=True, seed=seed, device="cuda")
    rgb, _ = disc_rgba(512, seed)
    photo = np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    photo_png = os.path.join(tmp, "photo.png")
    write_png(photo_png, photo)
    out = drive_cli("process", process, [photo_png, "--size", str(APPS_REF), "--u2net", u2], runs)
    held("process")
    rgba = read_png(out)
    alpha = {d: u2net_alpha(photo, u2, device=d) for d in ("cuda", "cpu")}
    u2_err = float(np.abs(alpha["cuda"] - alpha["cpu"]).max())
    if rgba.shape != (APPS_REF, APPS_REF, 4) or u2_err > U2NET_TOL or float(rgba[..., 3].std()) == 0.0:
        raise RuntimeError(f"cli.process wrote a {rgba.shape} RGBA; U2Net card against CPU "
                           f"{u2_err:.3e} (gate {U2NET_TOL})")
    summary["process"] = {"u2net_values": n_u2, "s": runs["process"]["wall_s"],
                          "u2net_card_cpu_err": u2_err}
    print(f"[apps] cli.process: a {n_u2}-value u2net.pth, the RGBA {rgba.shape} read back, "
          f"U2Net card against CPU max abs err {u2_err:.3e} (gate {U2NET_TOL}); card '{card}'")
    name = "photo"
    png = os.path.join(data, f"{name}_rgba.png")
    shutil.copy(out, png)

    # The batch script on a folder with that one input.
    written = drive_cli("port_runall", port_runall,
                        ["--dir", data, "--out", logs, "--config",
                         os.path.join(CONFIGS, "image.yaml"), "--video", "--extra", *APPS_ARGS],
                        runs)
    held("port_runall")
    ply, obj = os.path.join(logs, f"{name}_model.ply"), os.path.join(logs, f"{name}.obj")
    video, _ = read_gif(written[1])
    if written[0] != obj or video.shape != RUNALL_VIDEO:
        raise RuntimeError(f"port_runall wrote {written}, a {video.shape} turntable")

    # cli.render on the stage-1 PLY (a GIF) and the stage-2 OBJ (an H.264 MP4);
    # the render alone timed apart.
    fovy = math.radians(49.1)
    for label, path, ext in (("render gaussians", ply, "gif"), ("render mesh", obj, "mp4")):
        out = drive_cli(label, render, [path, "--out", os.path.join(tmp, f"{label[7:]}.{ext}"),
                                        "--num_frames", str(APPS_FRAMES), "--size",
                                        str(APPS_SIZE)], runs)
        held(label)
        if ext == "gif":
            shape = read_gif(out)[0].shape
        else:
            info = read_mp4(out)
            shape = (len(info["sample_sizes"]), info["height"], info["width"], 3)
            if info["durations"] != [info["timescale"] // APPS_FPS] * APPS_FRAMES:
                raise RuntimeError(f"{label} wrote samples of {info['durations']} in "
                                   f"{info['timescale']} a second")
        if shape != (APPS_FRAMES, APPS_SIZE, APPS_SIZE, 3):
            raise RuntimeError(f"{label} wrote a {ext} of {shape}")
        with kernel_run(label + " (frames only)", runs):
            frames = render.orbit_frames(path, APPS_FRAMES, APPS_SIZE, 0.0, 2.0, fovy, "cuda")
        held(label + " (frames only)")
        if np.std(frames) == 0:
            raise RuntimeError(f"{label} rendered flat frames")
        summary[label] = {"s": runs[label]["wall_s"],
                          "ms_per_frame": 1e3 * runs[label + " (frames only)"]["wall_s"]
                          / APPS_FRAMES, ext: list(shape)}
        if ext == "mp4":
            summary[label]["mp4"] = check_mp4(out, info, frames, card)

    # A full-width Zero123 snapshot: novel views on it, its CLIP tower for the metrics.
    snap = os.path.join(tmp, "zero123")
    synthetic.write_zero123_snapshot(snap, ZERO123_CONFIG, VAEConfig(), synthetic.CLIP_VIT_L14,
                                     dtype=torch.float16, seed=seed, device="cuda")
    vgg, lins = os.path.join(tmp, "vgg16.pth"), os.path.join(tmp, "vgg.pth")
    synthetic.write_vgg16_features(vgg, seed=seed, device="cuda")
    synthetic.write_lpips_lins(lins, seed=seed, device="cuda")
    for label, path in (("eval gaussians", ply), ("eval mesh", obj)):
        m = drive_cli(label, cli_eval, [png, path, "--clip_ckpt",
                                        os.path.join(snap, "image_encoder"), "--vgg_ckpt", vgg,
                                        "--lpips_ckpt", lins], runs)
        held(label)
        if sorted(m) != ["clip_sim", "front_lpips", "front_mae", "front_psnr"] or not all(
                math.isfinite(v) for v in m.values()):
            raise RuntimeError(f"{label} gave {m}")
        summary[label] = {"s": runs[label]["wall_s"], **m}
    calls: list = []
    with counted_unet_calls(calls):
        paths = drive_cli("novel_view", novel_view,
                          [png, "--ckpt", snap, "--hors", *NOVEL_HORS, "--vers", "10",
                           "--steps", str(NOVEL_STEPS), "--out", os.path.join(tmp, "nv")], runs)
    held("novel_view")
    views = [read_png(p) for p in paths]
    if calls != [(2 * len(NOVEL_HORS), 32, 32, 8)] * NOVEL_STEPS or any(
            v.shape != (256, 256, 3) for v in views):
        raise RuntimeError(f"cli.novel_view ran the UNet at {calls[:2]} x {len(calls)} and "
                           f"wrote {[v.shape for v in views]}")
    summary["novel_view"] = {"s": runs["novel_view"]["wall_s"], "unet_calls": len(calls),
                             "pngs": [os.path.basename(p) for p in paths]}
    shutil.rmtree(snap)

    # The viewer on the PLY and on the mesh, then live.
    for label, path in (("serve gaussians", ply), ("serve mesh", obj)):
        summary[label] = drive_viewer(label, serve.ViewerState(path, size=APPS_SIZE), APPS_SIZE,
                                      runs)
        held(label)
    summary["serve live"] = drive_live_viewer(png, runs)
    held("serve live")

    # The web app's two jobs.
    summary["webapp"] = drive_webapp(data, os.path.join(tmp, "webapp"), png, runs)
    held("webapp stage 1")
    held("webapp stage 2")

    if min(launches.values()) < 1:
        raise RuntimeError(f"the apps day did not go through every kernel: {launches}")
    print(f"[apps] launches {json.dumps(launches)}; "
          f"seconds {json.dumps({k: round(v['wall_s'], 2) for k, v in runs.items()})}; "
          f"{json.dumps(summary)}; card '{card}'")
    return {"launches": launches, "shapes": shapes}


# The sharding day: ranks of a (data, tile) mesh, one process each, all on
# the one card. They join by gloo, by the backend rule of
# parallel/multihost.py (NCCL refuses two ranks on one device), and
# time-slice the card: the day proves the sharded paths and the offset
# kernels, not a speed-up. Each run at the 512^2 rung with the full-width
# Zero123 snapshot in bf16: (data, tile), trainer options, steps. (A tile2
# run was cut when the CLI became two legs on two nodes: data2xtile2 keeps
# the offset kernels on every call, its ranks the tile2 and tile4 renders.)
SHARD_SIZE = 512
SHARD_RUNS = {
    "data2": ((2, 1), {"batch_size": 2, "density_start_iter": 1, "densification_interval": 2}, 3),
    "data2xtile2": ((2, 2), {"batch_size": 2}, 2),
}
# The data2 step against one process over both views with the same draws.
# Zero123's guidance returns the sum over its views (the reference's loss
# at one view), and the data-parallel step divides each rank's guidance term
# by the data size, as the JAX step does: the one-process step that it
# reproduces has the guidance weight over the data size. The one process
# evaluates the guidance view by view (batch 1, as on a rank): in bf16 a
# convolution's rounding follows the batch it runs in (a batch of 2 moves
# the VAE's latents and the UNet's output by 2% of their scale on the CPU,
# and CFG's factor 5 carries that into the gradient). What differs then is
# the order of float32 sums (the all-reduce, the known view's two halves):
# each parameter group's gradient to 1e-3 of its norm, the loss to 1e-4.
SHARD_GRAD_REL = 1e-3
SHARD_LOSS_RTOL = 1e-4
# The CLI's two nodes (a launcher of one rank each) and the step its first
# leg stops at.
SHARD_CLI_RANKS, SHARD_CLI_STOP = 2, 15


def state_digest(trainer) -> dict:
    """SHA-256 of every parameter, Adam moment and densify stat of the
    trainer, and Adam's step count: equal digests are equal bits."""
    import hashlib

    out = {"adam_count": int(trainer.adam.count), "capacity": trainer.capacity}
    for group, tensors in (("p", trainer.params), ("mu", trainer.adam.mu),
                           ("nu", trainer.adam.nu), ("aux", trainer.aux._asdict())):
        for k, v in tensors.items():
            data = v.detach().contiguous().cpu().numpy().tobytes()
            out[f"{group}_{k}"] = hashlib.sha256(data).hexdigest()
    return out


class KeptDraw:
    """The trainer's ``draw``, keeping every draw after the init's (name,
    value on the CPU) for a replay."""

    def __init__(self, inner):
        self.inner = inner
        self.kept = []

    def __call__(self, name, shape, dist, low=0, high=None):
        value = self.inner(name, shape, dist, low, high)
        if not name.startswith("init_"):
            self.kept.append((name, value.detach().cpu()))
        return value


class ReplayedDraw:
    """A rank's kept draws for the one-process step that evaluates the
    guidance view by view over all the data ranks' views: every rank drew
    the same samples for its own views, so each kept draw is served once per
    data rank."""

    def __init__(self, inner, kept: list, data: int):
        self.inner, self.data = inner, data
        self.kept = [item for item in kept for _ in range(data)]

    def __call__(self, name, shape, dist, low=0, high=None):
        if name.startswith("init_"):
            return self.inner(name, shape, dist, low, high)
        kept_name, value = self.kept.pop(0)
        if kept_name != name:
            raise RuntimeError(f"replayed draw {kept_name!r} where {name!r} was asked")
        if tuple(value.shape) != tuple(shape):
            raise RuntimeError(f"replayed {name!r} of {tuple(value.shape)} for {tuple(shape)}")
        return value.to(self.inner.device)


def main_path_cloud(seed: int, n: int = 16384, size: int = 512):
    """The synthetic scene of ``main_path_scene``: activated parameters on
    the card and its camera."""
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
    return (t(xyz), scale, quat, opacity, shs), cam


def shard_render_check(seed: int, tile2, tile4) -> dict:
    """The synthetic 512^2 scene rendered tile-sharded over ``tile2`` and
    ``tile4`` (mesh tile axes) against the unsharded render on the same
    card: image, depth and alpha with K1's gate, the gradients of sum(image
    * w) + sum(alpha) per parameter with K2's (per element, K2_RTOL of the
    value plus K2_ATOL of the largest). Returns the errors."""
    import torch

    from dreamgaussian_tpu_torch.ops.rasterize import render_gaussians
    from dreamgaussian_tpu_torch.parallel.tile_shard import render_gaussians_tile_sharded

    cloud, cam = main_path_cloud(seed)
    a = [torch.from_numpy(cam.arrays()[k]).cuda() for k in ("view", "full_proj", "campos", "tanfov")]
    w = torch.randn((SHARD_SIZE, SHARD_SIZE, 3), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    bg = torch.ones(3, device="cuda")

    def render(axis):
        args = [c.detach().clone().requires_grad_(True) for c in cloud]
        if axis is None:
            out = render_gaussians(*args, *a, SHARD_SIZE, SHARD_SIZE, bg, tile=32, device="cuda")
        else:
            out = render_gaussians_tile_sharded(*args, *a, SHARD_SIZE, SHARD_SIZE, bg, axis, tile=32)
        grads = torch.autograd.grad((out.image * w).sum() + out.alpha.sum(), args)
        return out, grads

    single, g_single = render(None)
    errs = {}
    for label, axis in (("tile2", tile2), ("tile4", tile4)):
        out, grads = render(axis)
        torch.cuda.synchronize()
        img_err = max(float((getattr(out, k) - getattr(single, k)).abs().max())
                      for k in ("image", "depth", "alpha"))
        share = 0.0
        for g, g0 in zip(grads, g_single):
            tol = K2_RTOL * g0.abs() + K2_ATOL * float(g0.abs().max())
            share = max(share, float(((g - g0).abs() / tol.clamp_min(1e-30)).max()))
        if not img_err <= 1e-3 or share > 1.0:
            raise RuntimeError(f"the {label} render disagrees with the unsharded one: image, "
                               f"depth, alpha max err {img_err}, gradient tolerance used {share}")
        errs[label] = {"render_max_abs_err": img_err, "grad_share_of_tolerance": share}
    return errs


def shard_rank_main(argv: list) -> int:
    """One rank of a sharding-day run (``SHARD_RUNS``): joins the run's
    process group, loads the snapshot, trains the run's steps on the mesh
    with every K1/K2 call kept, holds them, and writes its results to
    ``<work>/<run>_r<rank>.json``."""
    t_start = time.perf_counter()
    run, init, world, rank, work, seed = argv
    world, rank, seed = int(world), int(rank), int(seed)
    import numpy as np
    import torch
    import torch.distributed as dist

    from dreamgaussian_tpu_torch.guidance.loader import load_zero123
    from dreamgaussian_tpu_torch.ops import rasterize, rasterize_cuda
    from dreamgaussian_tpu_torch.parallel import initialize_multihost, make_mesh_2d
    from dreamgaussian_tpu_torch.train import Stage1Trainer
    from dreamgaussian_tpu_torch.train.stage1 import TorchDraw
    from dreamgaussian_tpu_torch.utils.config import Config

    (data, tile), over, steps = SHARD_RUNS[run]
    backend = initialize_multihost(init_method=init, world_size=world, rank=rank, device="cuda")
    mesh = make_mesh_2d(data, tile, device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"run": run, "rank": rank, "backend": backend, "device": str(mesh.device)}
    if run == "data2xtile2":
        result["render_check"] = shard_render_check(seed, mesh.tile, make_mesh_2d(1, 4, device="cuda").tile)

    opt = Config({**image_options(), "novel_resolutions": [SHARD_SIZE] * 3, **over})
    rgb, mask = disc_rgba(opt["ref_size"], seed)
    t = time.perf_counter()
    guidance = load_zero123(os.path.join(work, "zero123"), ref_image=rgb, device=mesh.device)
    result["load_s"] = time.perf_counter() - t
    draw = KeptDraw(TorchDraw(seed, mesh.device))
    trainer = Stage1Trainer(opt, ref_rgb=rgb, ref_mask=mask, capacity=opt["capacity"], seed=seed,
                            guidance_fns=((opt["lambda_zero123"], guidance.guidance_fn()),),
                            device=mesh.device, draw=draw, mesh=mesh)

    shipped = dist.all_reduce
    spent = [0.0]

    def timed_all_reduce(*a, **k):
        # Synchronized on both sides: the collective's own time.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = shipped(*a, **k)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    fwd, bwd = [], []
    steps_ms, reduce_ms, losses, digests = [], [], [], []
    for k in rasterize_cuda.LAUNCHES:
        rasterize_cuda.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    result["setup_s"] = time.perf_counter() - t_start
    dist.all_reduce = timed_all_reduce
    try:
        with (tapped(rasterize, "composite_forward", fwd, rasterize_cuda.LAST_GRID, "composite_fwd"),
              tapped(rasterize, "composite_backward", bwd, rasterize_cuda.LAST_GRID,
                     "composite_bwd")):
            for i in range(steps):
                spent[0] = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = float(trainer.train_step())
                torch.cuda.synchronize()
                steps_ms.append((time.perf_counter() - t0) * 1e3)
                reduce_ms.append(spent[0] * 1e3)
                losses.append(loss)
                digests.append(state_digest(trainer))
                if i == 0 and run == "data2" and rank == 0:
                    np.savez(os.path.join(work, "data2_step1.npz"), loss=loss,
                             **{f"mu_{k}": v.cpu().numpy() for k, v in trainer.adam.mu.items()},
                             **{f"aux_{k}": v.cpu().numpy()
                                for k, v in trainer.aux._asdict().items()})
                    torch.save(draw.kept, os.path.join(work, "data2_draws.pt"))
    finally:
        dist.all_reduce = shipped
    launches = dict(rasterize_cuda.LAUNCHES)
    if [len(fwd), len(bwd)] != [launches["composite_fwd"], launches["composite_bwd"]]:
        raise RuntimeError(f"rank {rank} of {run} launched a kernel outside its caller")
    result.update(
        steps_ms=steps_ms, allreduce_ms=reduce_ms, losses=losses, digests=digests,
        launches=launches, splits=sum(1 for name, _ in draw.kept if name == "split"),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        held=hold_composite_calls(f"{run} rank {rank}", fwd, bwd))
    with open(os.path.join(work, f"{run}_r{rank}.json"), "w") as f:
        json.dump(result, f)
    if backend is not None:
        dist.destroy_process_group()
    return 0


def cli_rank_main(argv: list) -> int:
    """One rank of ``torchrun ... chip_smoke.py cli-rank <work> <cli args>``:
    runs ``python -m dreamgaussian_tpu_torch.cli.main <cli args>`` in this
    process (``runpy``, as ``-m`` runs it) as a ``kernel_run``, holds every
    kernel call against the plain version and writes to
    ``<work>/cli_r<rank>.json`` the launches, the rows, the digest of the
    trainer's state after its training (``state_digest``) and the step a
    resume restored (None without one)."""
    import runpy

    from dreamgaussian_tpu_torch.train import Stage1Trainer

    work, cli_args = argv[0], argv[1:]
    rank = int(os.environ["RANK"])
    runs: dict = {}
    kept = {"digest": None, "resumed_step": None}
    shipped = Stage1Trainer.train, Stage1Trainer.load_checkpoint

    def train(self, *a, **k):
        stats = shipped[0](self, *a, **k)
        kept["digest"] = state_digest(self)
        return stats

    def load_checkpoint(self, path):
        shipped[1](self, path)
        kept["resumed_step"] = self.step

    sys.argv = ["dreamgaussian_tpu_torch.cli.main", *cli_args]
    Stage1Trainer.train, Stage1Trainer.load_checkpoint = train, load_checkpoint
    try:
        with kernel_run(f"CLI rank {rank}", runs):
            runpy.run_module("dreamgaussian_tpu_torch.cli.main", run_name="__main__",
                             alter_sys=True)
    finally:
        Stage1Trainer.train, Stage1Trainer.load_checkpoint = shipped
    shapes = hold_cli_calls(runs, "shard-day")
    with open(os.path.join(work, f"cli_r{rank}.json"), "w") as f:
        json.dump({"launches": next(iter(runs.values()))["launches"], "shapes": shapes, **kept}, f)
    return 0


def shard_single_process(seed: int, work: str, rank0: dict) -> dict:
    """The data2 run's first step in this process over both views, with the
    rank's draws replayed (``ReplayedDraw``), the guidance view by view and
    its weight over the data size (see SHARD_GRAD_REL): the loss and the
    gradients (Adam's first moment after one step: 0.1 of the gradient,
    before Adam's division) against the ranks'."""
    import numpy as np
    import torch

    from dreamgaussian_tpu_torch.guidance.loader import load_zero123
    from dreamgaussian_tpu_torch.train import Stage1Trainer
    from dreamgaussian_tpu_torch.train.stage1 import TorchDraw
    from dreamgaussian_tpu_torch.utils.config import Config

    (data, _), over, _ = SHARD_RUNS["data2"]
    opt = Config({**image_options(), "novel_resolutions": [SHARD_SIZE] * 3, **over})
    rgb, mask = disc_rgba(opt["ref_size"], seed)
    guidance = load_zero123(os.path.join(work, "zero123"), ref_image=rgb, device="cuda")
    draw = ReplayedDraw(TorchDraw(seed, torch.device("cuda")),
                        torch.load(os.path.join(work, "data2_draws.pt")), data)
    fn = guidance.guidance_fn()

    def view_by_view(images, cond, step_ratio, draw):
        return sum(fn(images[i:i + 1], {k: v[i:i + 1] for k, v in cond.items()}, step_ratio, draw)
                   for i in range(images.shape[0]))

    trainer = Stage1Trainer(opt, ref_rgb=rgb, ref_mask=mask, capacity=opt["capacity"], seed=seed,
                            guidance_fns=((opt["lambda_zero123"] / data, view_by_view),),
                            device="cuda", draw=draw)
    loss = float(trainer.train_step())
    with np.load(os.path.join(work, "data2_step1.npz")) as z:
        ranks = {k: z[k] for k in z.files}
    rel = {}
    for k, mu in trainer.adam.mu.items():
        mu = mu.cpu().numpy()
        if mu.size:
            rel[k] = float(np.linalg.norm(ranks[f"mu_{k}"] - mu) / max(np.linalg.norm(mu), 1e-30))
    loss_rel = abs(float(ranks["loss"]) - loss) / abs(loss)
    denom_equal = bool(np.array_equal(ranks["aux_denom"], trainer.aux.denom.cpu().numpy()))
    radii_equal = bool(np.array_equal(ranks["aux_max_radii2d"],
                                      trainer.aux.max_radii2d.cpu().numpy()))
    acc = trainer.aux.grad_accum.cpu().numpy()
    rel["densify_grad_accum"] = float(np.linalg.norm(ranks["aux_grad_accum"] - acc)
                                      / max(np.linalg.norm(acc), 1e-30))
    ok = (max(rel.values()) <= SHARD_GRAD_REL and loss_rel <= SHARD_LOSS_RTOL and denom_equal
          and radii_equal and float(ranks["loss"]) == rank0["losses"][0])
    out = {"loss_ranks": float(ranks["loss"]), "loss_one_process": loss,
           "loss_rel_err": loss_rel, "grad_rel_err": rel, "densify_counts_equal": denom_equal,
           "densify_radii_equal": radii_equal}
    print(f"[shard] data2 step 1 against one process over both views (replayed draws, guidance "
          f"view by view, weight / {data}): {json.dumps(out)}; gates: gradient {SHARD_GRAD_REL} "
          f"of its norm, loss {SHARD_LOSS_RTOL}")
    if not ok:
        raise RuntimeError("the data-parallel step disagrees with one process")
    return out


def run_shard_day(seed: int, card: str, work: str) -> dict:
    """The sharding day (see SHARD_RUNS): a full-width Zero123 snapshot
    written to ``work``; each run's ranks started together on the card;
    their replicas bit for bit after every step, their launches, every K1
    and K2 call held (offsets included); the data2 step against one
    process; the tile-sharded render against the unsharded one (in the
    data2xtile2 ranks); then cli.main with mesh=data2 on two torchrun
    launchers, stopped and resumed. Returns the day's launches and rows per
    kernel."""
    import numpy as np
    import torch

    from dreamgaussian_tpu_torch.guidance import synthetic
    from dreamgaussian_tpu_torch.guidance.unet import ZERO123_CONFIG
    from dreamgaussian_tpu_torch.guidance.vae import VAEConfig
    from dreamgaussian_tpu_torch.meshing.mesh import Mesh
    from dreamgaussian_tpu_torch.parallel import rays_per_second
    from dreamgaussian_tpu_torch.parallel.launch import (free_port, run_nodes, run_ranks,
                                                         torchrun_nodes)
    from dreamgaussian_tpu_torch.scene import load_ply

    work = os.path.join(work, "shard")
    os.makedirs(work)
    t = time.perf_counter()
    synthetic.write_zero123_snapshot(os.path.join(work, "zero123"), ZERO123_CONFIG, VAEConfig(),
                                     synthetic.CLIP_VIT_L14, dtype=torch.float16, seed=seed,
                                     device="cuda")
    print(f"[shard] full-width Zero123 snapshot written in {time.perf_counter() - t:.1f} s")
    me = os.path.abspath(__file__)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    launches = {"composite_fwd": 0, "composite_bwd": 0, "ztest": 0}
    shapes: dict = {"composite_fwd": [], "composite_bwd": [], "ztest": []}
    results = {}
    for run, ((data, tile), over, steps) in SHARD_RUNS.items():
        world = data * tile
        init = f"tcp://127.0.0.1:{free_port()}"
        t = time.perf_counter()
        run_ranks(lambda r: [sys.executable, me, "shard-rank", run, init, str(world), str(r), work,
                             str(seed)], world, timeout=300, env=env)
        wall = time.perf_counter() - t
        ranks = []
        for r in range(world):
            with open(os.path.join(work, f"{run}_r{r}.json")) as f:
                ranks.append(json.load(f))
        for i in range(steps):
            if any(rk["digests"][i] != ranks[0]["digests"][i] for rk in ranks):
                raise RuntimeError(f"{run}: the replicas differ after step {i + 1}")
        if not all(math.isfinite(x) for rk in ranks for x in rk["losses"]):
            raise RuntimeError(f"{run}: non-finite losses")
        if any(min(rk["launches"].values()) < 1 for rk in ranks):
            raise RuntimeError(f"{run}: a rank did not launch every kernel")
        offsets = sorted({row["tile_offset"] for rk in ranks for rows in rk["held"].values()
                          for row in rows})
        if tile > 1 and not any(offsets):
            raise RuntimeError(f"{run}: no call with a tile offset")
        if run == "data2" and any(rk["splits"] != 1 for rk in ranks):
            raise RuntimeError("data2: the densify of step 2 did not run on every rank")
        for k in ("composite_fwd", "composite_bwd"):
            launches[k] += sum(rk["launches"][k] for rk in ranks)
            for rk in ranks:
                shapes[k] += rk["held"][k]
        # A step of the mesh takes as long as its slowest rank.
        step_ms = [max(rk["steps_ms"][i] for rk in ranks) for i in range(steps)]
        red_ms = [max(rk["allreduce_ms"][i] for rk in ranks) for i in range(steps)]
        steady = statistics.median(step_ms[1:])
        views = over["batch_size"]
        rays = rays_per_second(SHARD_SIZE, SHARD_SIZE, views, steady / 1e3)
        results[run] = {"wall_s": wall, "step_ms": step_ms, "steady_ms": steady,
                        "allreduce_ms": red_ms, "rays_per_s": rays, "offsets": offsets,
                        "peak_gib": [rk["peak_gib"] for rk in ranks],
                        "load_s": [rk["load_s"] for rk in ranks],
                        "setup_s": [rk["setup_s"] for rk in ranks], "losses": ranks[0]["losses"]}
        print(f"[shard] {run} (data={data}xtile={tile}, backend {ranks[0]['backend']}, ranks on "
              f"{ranks[0]['device']}): ms per step {[round(x, 1) for x in step_ms]} (steady "
              f"{steady:.1f}), all-reduce ms per step {[round(x, 2) for x in red_ms]}, "
              f"rays_per_second {rays:.0f} ({views} views of {SHARD_SIZE}^2), peak GiB per rank "
              f"{[round(rk['peak_gib'], 2) for rk in ranks]}, losses {ranks[0]['losses']}, "
              f"launches per rank {[rk['launches'] for rk in ranks]}, tile offsets seen "
              f"{offsets}, replicas bit for bit after every step; {wall:.1f} s (a rank's start to "
              f"its first step {max(results[run]['setup_s']):.1f} s, the snapshot's load "
              f"{max(results[run]['load_s']):.1f} s of it); card '{card}'")
        if run == "data2xtile2":
            for rk in ranks:
                print(f"[shard] tile-sharded {SHARD_SIZE}^2 render against the unsharded one, rank "
                      f"{rk['rank']}: {json.dumps(rk['render_check'])}")
        if run == "data2":
            results["one_process"] = shard_single_process(seed, work, ranks[0])

    for k, rows in shapes.items():
        for row in rows:
            print(f"[kernels] {k} in the shard-day {row['phase']} at {row['label']}: "
                  f"{row['calls']} calls held against the plain version, {held_error(row)}, "
                  f"grid {row['blocks']} blocks")
    # The CLI on two nodes, as a user runs it on hosts without a shared disk:
    # two torchrun launchers of one rank each (both on the one card) train
    # mesh=data2 to step SHARD_CLI_STOP and save; then resume=True to the
    # CLI's iters, node 1 given a checkpoint folder that does not exist.
    png = os.path.join(work, "disc.png")
    write_disc_png(png, 512, seed)
    ckpt = {0: os.path.join(work, "ckpt"), 1: os.path.join(work, "node1", "ckpt")}
    cli_s, cli_launches = {}, {}
    # Leg 1 writes its PLY and no mesh (the export is leg 2's).
    for leg, extra in (("leg1", [f"iters={SHARD_CLI_STOP}", f"checkpoint_every={SHARD_CLI_STOP}",
                                 "save_mesh=False"]), ("leg2", ["resume=True"])):
        leg_work = os.path.join(work, leg)
        os.makedirs(leg_work)
        port = free_port()
        t = time.perf_counter()
        logs = run_nodes(lambda r: [
            *torchrun_nodes(SHARD_CLI_RANKS, r, 1, port), me, "cli-rank", leg_work,
            "--config", os.path.join(CONFIGS, "image.yaml"), f"input={png}",
            f"save_path=shard_{leg}", f"outdir={os.path.join(work, 'cli')}", f"seed={seed}",
            "mesh=data2", "batch_size=2", f"checkpoint_dir={ckpt[r]}",
            *(f"{k}={v}" for k, v in CLI_OVERRIDES.items()), *extra], SHARD_CLI_RANKS,
            timeout=300, env=env)
        cli_s[leg] = time.perf_counter() - t
        log = "\n".join(logs)
        print("\n".join(line for line in log.splitlines() if line.startswith(
            ("[shard]", "[INFO] training", "[INFO] resumed", "[cli]", "[kernels]"))))
        if any(want not in log for want in ("[INFO] training on a data=2xtile=1 device mesh",
                                            "backend gloo", "[shard] note: Zero123's guidance")):
            raise RuntimeError(f"the CLI's {leg} did not train on a gloo data=2 mesh with the "
                               f"Zero123 note:\n{log[-3000:]}")
        ranks = []
        for r in range(SHARD_CLI_RANKS):
            with open(os.path.join(leg_work, f"cli_r{r}.json")) as f:
                ranks.append(json.load(f))
        cli_launches[leg] = [rk["launches"] for rk in ranks]
        for rk in ranks:
            for k in launches:
                launches[k] += rk["launches"][k]
                shapes[k] += rk["shapes"][k]
        if any(rk["digest"] != ranks[0]["digest"] for rk in ranks):
            raise RuntimeError(f"the CLI's {leg}: the replicas differ after the run")
        if cli_launches[leg][0]["ztest"] != (26 if leg == "leg2" else 0) \
                or cli_launches[leg][1]["ztest"] != 0 or min(
                cl[k] for cl in cli_launches[leg] for k in ("composite_fwd", "composite_bwd")) < 1:
            raise RuntimeError(f"the CLI's {leg} ranks did not go through the kernels: "
                               f"{cli_launches[leg]}")
        resumed = [rk["resumed_step"] for rk in ranks]
        if leg == "leg2" and (resumed != [SHARD_CLI_STOP] * SHARD_CLI_RANKS or any(
                f"resumed from {ckpt[r]} at step {SHARD_CLI_STOP} (rank {r})" not in log
                for r in range(SHARD_CLI_RANKS)) or os.path.exists(ckpt[1])):
            raise RuntimeError(f"the CLI's leg 2 did not resume every rank at step "
                               f"{SHARD_CLI_STOP} from rank 0's checkpoint: {resumed}")
    read, outdir = {}, os.path.join(work, "cli")
    for leg in cli_s:
        params, aux, _ = load_ply(os.path.join(outdir, f"shard_{leg}_model.ply"),
                                  capacity=image_options()["capacity"], device="cuda")
        n = int(aux.alive.sum())
        if n == 0 or not bool(torch.isfinite(params["xyz"][:n]).all()):
            raise RuntimeError(f"the sharded CLI's {leg} PLY did not read back")
        read[leg] = {"gaussians": n}
    mesh = Mesh.load(os.path.join(outdir, "shard_leg2_mesh.obj"), resize=False)
    if len(mesh.f) == 0 or not np.isfinite(mesh.v).all():
        raise RuntimeError("the sharded CLI's mesh did not read back")
    read["leg2"]["faces"] = len(mesh.f)
    print(f"[shard] cli.main mesh=data2 on two torchrun nodes of one rank each, backend gloo (one "
          f"card): leg 1 to step {SHARD_CLI_STOP} {cli_s['leg1']:.1f} s, leg 2 resumed at step "
          f"{SHARD_CLI_STOP} on both ranks (node 1 without the checkpoint folder) to step "
          f"{CLI_OVERRIDES['iters']} {cli_s['leg2']:.1f} s; every rank exit 0, replicas bit for "
          f"bit after each leg, PLYs and leg 2's mesh read back {json.dumps(read)}, launches per "
          f"rank {json.dumps(cli_launches)}; card '{card}'")
    results["cli_s"] = cli_s
    return {"launches": launches, "shapes": shapes, "results": results}


def main() -> int:
    # The sharding day's processes: a rank of a run, a rank of the CLI.
    if sys.argv[1:2] == ["shard-rank"]:
        return shard_rank_main(sys.argv[2:])
    if sys.argv[1:2] == ["cli-rank"]:
        return cli_rank_main(sys.argv[2:])
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
    from dreamgaussian_tpu_torch import native

    t_start = t0 = time.perf_counter()
    # One compiler per library, all at once: the kernels, K3 without the
    # sift (which check_ztest times against the shipped build), and the
    # host tools (g++): the mesh tools, the image tools, the image codecs,
    # the JPEG 2000 decoder and the H.264 encoder.
    with concurrent.futures.ThreadPoolExecutor(7) as pool:
        builds = [pool.submit(cuda_build.build, ["composite_fwd", "composite_bwd", "ztest"], True),
                  pool.submit(cuda_build.build, ["ztest"], True, ("-DZTEST_SIFT=0",)),
                  pool.submit(native.build), pool.submit(native.build, native.IMAGE_TOOLS),
                  pool.submit(native.build, native.IMAGE_CODECS),
                  pool.submit(native.build, native.JPEG2000),
                  pool.submit(native.build, native.H264_INTRA)]
        libs = [b.result() for b in builds]
    print(f"[build] kernels, {', '.join(lib.name for lib in libs[2:])} "
          f"ready in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    formats = run_formats(card)
    print(f"[formats] the formats phase took {time.perf_counter() - t0:.1f} s; card '{card}'")

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
        t0 = time.perf_counter()
        apps_day = run_apps_day(args.seed, card, work)
        print(f"[apps] the apps day took {time.perf_counter() - t0:.1f} s; card '{card}'")
        t0 = time.perf_counter()
        shard_day = run_shard_day(args.seed, card, work)
        print(f"[shard] the sharding day took {time.perf_counter() - t0:.1f} s; card '{card}'")
    for row in kernels:
        row["launches_text_day"] = text_day["launches"][row["name"]]
        row["text_day_shapes"] = text_day["shapes"][row["name"]]
        row["launches_imagedream_day"] = imagedream_day["launches"][row["name"]]
        row["imagedream_day_shapes"] = imagedream_day["shapes"][row["name"]]
        row["launches_apps_day"] = apps_day["launches"][row["name"]]
        row["apps_day_shapes"] = apps_day["shapes"][row["name"]]
        row["launches_shard_day"] = shard_day["launches"][row["name"]]
        row["shard_day_shapes"] = shard_day["shapes"][row["name"]]
    print(f"[smoke] {time.perf_counter() - t_start:.1f} s from the build to here (the formats "
          f"phase {formats['grabcut_wall_s'] + formats['grabcut_cpu_s']:.1f} s of GrabCut); "
          f"card '{card}'")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
