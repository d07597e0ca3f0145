"""Stage-1 trainer: Gaussian-splat optimization with SDS guidance (eager).

Port of ``dreamgaussian_tpu/train/stage1.py``'s ``Stage1Trainer`` as an
eager PyTorch step (forward, ``backward()``, Adam, stats, densify and reset
on schedule). Semantics kept:

- known-view loss = 10000*w*mse(image, ref_rgb) + 1000*w*mse(alpha,
  ref_mask), w = step_ratio when ``warmup_rgb_loss`` else 1;
- novel-view resolution ladder 128/256/512 at step ratios 0.3/0.6;
- orbit sampling ver ~ U[min_ver, max_ver), hor ~ U[-180, 180), drawn from
  ``np.random.default_rng(seed)`` in the JAX trainer's call order, then
  the white/black background draw (``invert_bg_prob``);
- densification stats from the LAST novel view, with the mean2D gradient
  scaled by (W/2, H/2); densify/prune every ``densification_interval``
  inside [density_start_iter, density_end_iter], opacity reset every
  ``opacity_reset_interval``; ``nan_to_num`` on the gradients;
- xyz LR on the exponential schedule with spatial_lr_scale 10 for random
  init;
- renders at tile 32, chunk 128.

Random draws other than the cameras (init positions and colours, split
jitter, SDS noise) go through one ``draw(name, shape, dist)`` function,
by default a seeded ``torch.Generator``; tests pass their own to inject
samples. The fused multi-step scan, sharding meshes and checkpoints of the
JAX trainer are not ported yet.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable

import numpy as np
import torch

from .. import resolve_device
from ..ops.rasterize import render_gaussians
from ..scene import (
    accumulate_stats,
    adam_init,
    adam_update,
    densify_and_prune,
    expon_lr,
    init_random,
    load_ply,
    num_alive,
    prune_only,
    reset_opacity,
    save_ply,
)
from ..scene.optim import AdamState
from ..utils.camera import Camera, orbit_camera, stack_cameras

# Guidance interface: (images [B,H,W,3] in [0,1], cond dict, step_ratio,
# draw) -> scalar loss, differentiable w.r.t. images.
GuidanceFn = Callable[..., torch.Tensor]

TILE = 32


class TorchDraw:
    """The trainer's random numbers from one seeded ``torch.Generator``."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, name: str, shape: tuple, dist: str) -> torch.Tensor:
        if dist == "uniform":
            return torch.rand(shape, generator=self.gen, device=self.device)
        if dist == "normal":
            return torch.randn(shape, generator=self.gen, device=self.device)
        raise ValueError(f"unknown distribution {dist!r} for draw {name!r}")


def _render_one(params, cam, bg, width, height, sh_degree, alive, tap=None):
    return render_gaussians(
        params["xyz"], torch.exp(params["scaling"]), params["rotation"],
        torch.sigmoid(params["opacity"][:, 0]),
        torch.cat([params["f_dc"], params["f_rest"]], dim=1),
        cam["view"], cam["full_proj"], cam["campos"], cam["tanfov"],
        width, height, bg, sh_degree=sh_degree, alive=alive, mean2d_tap=tap,
        tile=TILE, device=params["xyz"].device,
    )


class Stage1Trainer:
    """Headless stage-1 optimization (GUI-free equivalent of main.py)."""

    def __init__(
        self,
        opt: Any,
        ref_rgb: np.ndarray | None = None,
        ref_mask: np.ndarray | None = None,
        guidance_fns: tuple = (),
        capacity: int = 16384,
        seed: int = 0,
        device: str | torch.device = "cuda",
        draw: Callable[[str, tuple, str], torch.Tensor] | None = None,
    ):
        """opt: config namespace with the reference's image.yaml keys.
        guidance_fns: tuple of (weight, fn) entries (see GuidanceFn)."""
        if opt.get("mvdream", False) or opt.get("imagedream", False):
            raise ValueError("multi-view priors (mvdream/imagedream) are not ported yet")
        self.device = resolve_device(device)
        self.opt = opt
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.draw = draw if draw is not None else TorchDraw(seed, self.device)
        self.step = 0
        self.capacity = capacity
        self.guidance_fns = guidance_fns
        self.overflow = None          # binning overflow of the last step
        self.densify_dropped = None   # candidates densify found no slot for

        load = opt.get("load", None)
        if load:
            self.params, self.aux, self.sh_degree = load_ply(load, capacity, self.device)
            self.spatial_lr_scale = 1.0
        else:
            self.params, self.aux = init_random(
                self.draw, num_pts=opt.get("num_pts", 5000), capacity=capacity,
                radius=0.5, sh_degree=opt.get("sh_degree", 0), device=self.device,
            )
            self.sh_degree = opt.get("sh_degree", 0)
            self.spatial_lr_scale = 10.0
        self.adam = adam_init(self.params)

        self.ref_size = opt.get("ref_size", 256)
        self.ref_rgb = self._tensor(ref_rgb) if ref_rgb is not None else None
        self.ref_mask = self._tensor(ref_mask) if ref_mask is not None else None
        self.use_known_view = ref_rgb is not None

        fovy = np.radians(opt.get("fovy", 49.1))
        self.fovy = fovy
        self.fovx = fovy  # square renders; the reference uses fovx = fovy
        self.radius = opt.get("radius", 2.0)
        self.elevation = opt.get("elevation", 0.0)
        pose = orbit_camera(self.elevation, 0.0, self.radius)
        self.fixed_cam = Camera.from_pose(pose, self.ref_size, self.ref_size, fovy, fovy)
        self.batch_size = opt.get("batch_size", 1)

        self.lr_schedules = {
            "total_iters": float(opt.get("iters", 500)),
            "xyz": expon_lr(
                opt.get("position_lr_init", 1e-3) * self.spatial_lr_scale,
                opt.get("position_lr_final", 2e-5) * self.spatial_lr_scale,
                lr_delay_mult=opt.get("position_lr_delay_mult", 0.02),
                max_steps=opt.get("position_lr_max_steps", 500),
            ),
            "f_dc": opt.get("feature_lr", 0.01),
            "f_rest": opt.get("feature_lr", 0.01) / 20.0,
            "opacity": opt.get("opacity_lr", 0.05),
            "scaling": opt.get("scaling_lr", 5e-3),
            "rotation": opt.get("rotation_lr", 5e-3),
        }
        self._densify = functools.partial(
            densify_and_prune,
            grad_threshold=opt.get("densify_grad_threshold", 0.01),
            min_opacity=0.01, extent=4.0,
            percent_dense=opt.get("percent_dense", 0.01),
        )

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _cam_tensors(self, arrays: dict) -> dict:
        return {k: self._tensor(v) for k, v in arrays.items()}

    # -- camera sampling (host-side numpy, mirroring the reference RNG use) --

    def _sample_novel_cameras(self, size: int):
        opt = self.opt
        min_ver = max(
            min(opt.get("min_ver", -30), opt.get("min_ver", -30) - self.elevation),
            -80 - self.elevation,
        )
        max_ver = min(
            max(opt.get("max_ver", 30), opt.get("max_ver", 30) - self.elevation),
            80 - self.elevation,
        )
        cams, vers, hors, poses = [], [], [], []
        for _ in range(self.batch_size):
            ver = int(self.rng.integers(min_ver, max_ver))
            hor = int(self.rng.integers(-180, 180))
            vers.append(ver)
            hors.append(hor)
            pose = orbit_camera(self.elevation + ver, hor, self.radius)
            poses.append(pose)
            cams.append(Camera.from_pose(pose, size, size, self.fovy, self.fovx))
        return (cams, np.array(vers, np.float32), np.array(hors, np.float32),
                np.stack(poses).astype(np.float32))

    def novel_size_for(self, step: int) -> int:
        """Novel-view resolution of ``step`` on the 128/256/512 ladder."""
        ratio = min(1.0, step / self.opt.get("iters", 500))
        ladder = self.opt.get("novel_resolutions", [128, 256, 512])
        return ladder[0] if ratio < 0.3 else (ladder[1] if ratio < 0.6 else ladder[2])

    def _loss(self, params, tap, step, novel, bg, cond, size):
        opt = self.opt
        # float32 like the JAX step's traced scalars.
        step_ratio = float(min(np.float32(1.0), np.float32(step) / np.float32(self.lr_schedules["total_iters"])))
        w = step_ratio if opt.get("warmup_rgb_loss", True) else 1.0
        alive = self.aux.alive
        loss = torch.zeros((), device=self.device)
        overflow = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.use_known_view:
            known = self._cam_tensors(self.fixed_cam.arrays())
            out = _render_one(params, known, torch.ones(3, device=self.device),
                              self.ref_size, self.ref_size, self.sh_degree, alive)
            loss = loss + 10000.0 * w * torch.mean((out.image - self.ref_rgb) ** 2)
            loss = loss + 1000.0 * w * torch.mean((out.alpha - self.ref_mask) ** 2)
            overflow = overflow + out.overflow
        images, last = [], None
        n_novel = novel["view"].shape[0]
        for b in range(n_novel):
            cam_b = {k: v[b] for k, v in novel.items()}
            last = _render_one(params, cam_b, bg, size, size, self.sh_degree, alive,
                               tap=tap if b == n_novel - 1 else None)
            images.append(last.image)
            overflow = overflow + last.overflow
        images = torch.stack(images)
        for weight, fn in self.guidance_fns:
            loss = loss + weight * fn(images, cond, step_ratio, self.draw)
        return loss, last.radii, overflow

    def train_step(self) -> torch.Tensor:
        """One optimization step; returns the loss (a device tensor)."""
        opt = self.opt
        self.step += 1
        size = self.novel_size_for(self.step)
        cams, vers, hors, poses = self._sample_novel_cameras(size)
        novel = self._cam_tensors(stack_cameras(cams))
        bg_white = self.rng.random() > opt.get("invert_bg_prob", 0.5)
        bg = torch.full((3,), 1.0 if bg_white else 0.0, device=self.device)
        cond = {"vers": self._tensor(vers), "hors": self._tensor(hors),
                "radii": torch.zeros(len(vers), device=self.device),
                "poses": self._tensor(poses)}

        params = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        tap = torch.zeros((self.capacity, 2), device=self.device, requires_grad=True)
        loss, radii, self.overflow = self._loss(params, tap, self.step, novel, bg, cond, size)
        loss.backward()
        # A parameter (or the tap) that no loss term reached has no .grad:
        # its gradient is zero, as jax.grad returns it.
        grad = lambda t: torch.zeros_like(t) if t.grad is None else torch.nan_to_num(t.grad)  # noqa: E731
        grads = {k: grad(p) for k, p in params.items()}

        lrs = {k: self.lr_schedules[k] for k in ("f_dc", "f_rest", "opacity", "scaling", "rotation")}
        lrs["xyz"] = self.lr_schedules["xyz"](self.step)
        self.params, self.adam = adam_update(self.params, grads, self.adam, lrs)

        in_window = (opt.get("density_start_iter", 100) <= self.step
                     <= opt.get("density_end_iter", 3000))
        if in_window:
            # CUDA reports dL/dmean2D in half-image units.
            self.aux = accumulate_stats(self.aux, grad(tap) * (size / 2.0), radii)
            if self.step % opt.get("densification_interval", 100) == 0:
                split_noise = self.draw("split", (2, self.capacity, 3), "normal").to(self.device)
                self.params, self.adam, self.aux, dropped = self._densify(
                    self.params, self.adam, self.aux, split_noise)
                self.densify_dropped = dropped if self.densify_dropped is None \
                    else torch.maximum(self.densify_dropped, dropped)
            if self.step % opt.get("opacity_reset_interval", 700) == 0:
                self.params, self.adam = reset_opacity(self.params, self.adam)
        return loss.detach()

    def _check_overflow(self) -> None:
        """Host-sync check: binning must not have dropped duplicates, and a
        densify that ran out of free slots grows the capacity."""
        if self.overflow is not None and int(self.overflow) > 0:
            raise RuntimeError(f"binning dropped {int(self.overflow)} duplicates")
        if self.densify_dropped is not None:
            dropped = int(self.densify_dropped)
            if dropped > 0:
                self._grow_capacity(self.capacity * 2, dropped)
            self.densify_dropped = None

    def _grow_capacity(self, new_capacity: int, dropped: int) -> None:
        """Double the padded-slot capacity after densify ran out of free
        slots (the reference grows without bound). The dropped candidates
        themselves are lost; the next pass has room."""
        old = self.capacity
        print(f"[stage1] WARNING: densify dropped {dropped} candidates at "
              f"capacity {old}; growing capacity {old} -> {new_capacity}")
        pad = new_capacity - old

        def pad_rows(v, fill=0.0):
            return torch.cat([v, torch.full((pad,) + v.shape[1:], fill, dtype=v.dtype,
                                            device=v.device)])

        fills = {"scaling": -10.0}
        self.params = {k: pad_rows(v, fills.get(k, 0.0)) for k, v in self.params.items()}
        # Dead rotation rows get the identity quaternion.
        self.params["rotation"][old:, 0] = 1.0
        self.adam = AdamState(
            mu={k: pad_rows(v) for k, v in self.adam.mu.items()},
            nu={k: pad_rows(v) for k, v in self.adam.nu.items()},
            count=self.adam.count,
        )
        self.aux = self.aux._replace(
            alive=pad_rows(self.aux.alive, False),
            max_radii2d=pad_rows(self.aux.max_radii2d),
            grad_accum=pad_rows(self.aux.grad_accum),
            denom=pad_rows(self.aux.denom),
        )
        self.capacity = new_capacity

    def train(self, iters: int | None = None, log_every: int = 100) -> dict:
        """Run ``iters`` steps, then the reference's final prune."""
        iters = iters if iters is not None else self.opt.get("iters", 500)
        t0 = time.perf_counter()
        loss = torch.tensor(float("nan"))
        for _ in range(iters):
            loss = self.train_step()
            if log_every and self.step % log_every == 0:
                print(f"[stage1] step {self.step} loss {float(loss):.4f} "
                      f"alive {num_alive(self.aux)}")
                self._check_overflow()
        self._check_overflow()
        self.params, self.adam, self.aux = prune_only(
            self.params, self.adam, self.aux, min_opacity=0.01, extent=1.0,
            max_screen_size=1.0)
        loss = float(loss)
        return {"loss": loss, "wall_s": time.perf_counter() - t0,
                "alive": num_alive(self.aux)}

    @torch.no_grad()
    def render_view(self, cam: Camera, bg=None):
        """No-grad render of one camera (test_step analogue)."""
        bg = torch.ones(3, device=self.device) if bg is None else self._tensor(bg)
        return _render_one(self.params, self._cam_tensors(cam.arrays()), bg,
                           cam.width, cam.height, self.sh_degree, self.aux.alive)

    def save_ply(self, path: str) -> int:
        return save_ply(path, self.params, self.aux)
