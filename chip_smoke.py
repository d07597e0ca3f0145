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
4. prints the ``kernels`` JSON line, the card's name and power limit, and
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


def profiled_step(trainer):
    """One train step under torch.profiler: (loss, wall ms, breakdown) with
    device busy time by kernel name (CUDA activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        loss = float(trainer.train_step())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    by_name = {}   # device activity only (kernels, copies, fills)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
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
    cuda_build.build(["composite_fwd", "composite_bwd"], verbose=True)
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s")

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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
