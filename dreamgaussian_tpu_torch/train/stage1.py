"""Stage-1 trainer: Gaussian-splat optimization with SDS guidance (eager).

Port of ``dreamgaussian_tpu/train/stage1.py``'s ``Stage1Trainer`` as an
eager PyTorch step (forward, ``backward()``, Adam, stats, densify and reset
on schedule). Semantics kept:

- known-view loss = 10000*w*mse(image, ref_rgb) + 1000*w*mse(alpha,
  ref_mask), w = step_ratio when ``warmup_rgb_loss`` else 1;
- novel-view resolution ladder 128/256/512 at step ratios 0.3/0.6;
- orbit sampling ver ~ U[min_ver, max_ver), hor ~ U[-180, 180), drawn from
  ``np.random.default_rng(seed)`` in the JAX trainer's call order, then
  the white/black background draw (``invert_bg_prob``); with ``mvdream``
  or ``imagedream`` each sampled camera becomes a group of 4 views at
  hor + 90 i, its poses consecutive in ``cond["poses"]``; ImageDream's
  input image conditions the guidance, and there is no known view;
- densification stats from the LAST novel view, with the mean2D gradient
  scaled by (W/2, H/2); densify/prune every ``densification_interval``
  inside [density_start_iter, density_end_iter], opacity reset every
  ``opacity_reset_interval``; ``nan_to_num`` on the gradients;
- xyz LR on the exponential schedule with spatial_lr_scale 10 for random
  init;
- renders at tile 32, chunk 128.

Random draws other than the cameras (init positions and colours, split
jitter, SDS noise and timesteps) go through one ``draw(name, shape, dist,
...)`` function, by default a seeded ``torch.Generator``; tests pass their
own to inject samples. ``train`` saves checkpoints every
``checkpoint_every`` steps and ``load_checkpoint`` resumes from one
(``utils/checkpoint.py``). The fused multi-step scan of the JAX trainer
has no counterpart (the loop runs its steps eagerly).

With a ``mesh`` (``parallel.make_mesh_2d``, one process per rank) the novel
views shard over its data axis and each render's tile rows over its tile
axis (``parallel/dp.py``, ``parallel/tile_shard.py``); the step body
(``train/step.py``) is the same one the single-process trainer runs.
Every rank holds the same parameters, Adam state and densify statistics
after every step, and only rank 0 writes files (PLY, checkpoints).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable

import numpy as np
import torch

from .. import resolve_device
from ..scene import (
    adam_init,
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
from ..utils import trace
from ..utils.camera import Camera, orbit_camera, stack_cameras
from .step import apply_update, gradients, render_one

# Guidance interface: (images [B,H,W,3] in [0,1], cond dict, step_ratio,
# draw) -> scalar loss, differentiable w.r.t. images.
GuidanceFn = Callable[..., torch.Tensor]


class TorchDraw:
    """The trainer's random numbers from one seeded ``torch.Generator``."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, name: str, shape: tuple, dist: str, low: int = 0,
                 high: int | None = None) -> torch.Tensor:
        """``dist``: "uniform" on [0, 1), "normal", or "randint" on [low, high)."""
        if dist == "uniform":
            return torch.rand(shape, generator=self.gen, device=self.device)
        if dist == "normal":
            return torch.randn(shape, generator=self.gen, device=self.device)
        if dist == "randint":
            return torch.randint(low, high, shape, generator=self.gen, device=self.device)
        raise ValueError(f"unknown distribution {dist!r} for draw {name!r}")

    def get_state(self) -> np.ndarray:
        """The generator's state as uint8, for a checkpoint."""
        return self.gen.get_state().numpy()

    def set_state(self, state: np.ndarray) -> None:
        self.gen.set_state(torch.from_numpy(np.asarray(state, np.uint8)))


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
        mesh=None,
    ):
        """opt: config namespace with the reference's image.yaml keys.
        guidance_fns: tuple of (weight, fn) entries (see GuidanceFn).
        mesh: a ``parallel.Mesh2D`` (its ``device`` is this rank's), or None
        for one process."""
        self.device = resolve_device(device)
        self.mesh = mesh
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
        # ImageDream takes the reference image as its conditioning, not as a
        # known view.
        self.use_known_view = ref_rgb is not None and not opt.get("imagedream", False)

        fovy = np.radians(opt.get("fovy", 49.1))
        self.fovy = fovy
        self.fovx = fovy  # square renders; the reference uses fovx = fovy
        self.radius = opt.get("radius", 2.0)
        self.elevation = opt.get("elevation", 0.0)
        pose = orbit_camera(self.elevation, 0.0, self.radius)
        self.fixed_cam = Camera.from_pose(pose, self.ref_size, self.ref_size, fovy, fovy)
        self.n_views = 4 if (opt.get("mvdream", False) or opt.get("imagedream", False)) else 1
        self.batch_size = opt.get("batch_size", 1)
        if mesh is not None:
            total_views = self.batch_size * self.n_views
            if total_views % mesh.data.size:
                raise ValueError(f"{total_views} views cannot shard over data={mesh.data.size}")
            if (total_views // mesh.data.size) % self.n_views:
                raise ValueError(
                    "multi-view groups must stay on one device "
                    f"(views/device={total_views // mesh.data.size}, group={self.n_views})")

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
            for i in range(self.n_views):
                pose = orbit_camera(self.elevation + ver, hor + 90 * i, self.radius)
                poses.append(pose)
                cams.append(Camera.from_pose(pose, size, size, self.fovy, self.fovx))
        return (cams, np.array(vers, np.float32), np.array(hors, np.float32),
                np.stack(poses).astype(np.float32))

    def novel_size_for(self, step: int) -> int:
        """Novel-view resolution of ``step`` on the 128/256/512 ladder."""
        ratio = min(1.0, step / self.opt.get("iters", 500))
        ladder = self.opt.get("novel_resolutions", [128, 256, 512])
        return ladder[0] if ratio < 0.3 else (ladder[1] if ratio < 0.6 else ladder[2])

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the run's files (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def train_step(self) -> torch.Tensor:
        """One optimization step; returns the loss (a device tensor, summed
        over the mesh's data ranks)."""
        opt = self.opt
        self.step += 1
        with trace.span("stage1.step", step=self.step):
            with trace.span("stage1.cameras"):
                size = self.novel_size_for(self.step)
                cams, vers, hors, poses = self._sample_novel_cameras(size)
                novel = self._cam_tensors(stack_cameras(cams))
                bg_white = self.rng.random() > opt.get("invert_bg_prob", 0.5)
                bg = torch.full((3,), 1.0 if bg_white else 0.0, device=self.device)
                cond = {"vers": self._tensor(vers), "hors": self._tensor(hors),
                        "radii": torch.zeros(len(vers), device=self.device),
                        "poses": self._tensor(poses)}
                if self.mesh is not None:
                    from ..parallel.dp import shard_cameras

                    # This rank's views, and their per-camera and per-view entries.
                    novel, cond = shard_cameras(self.mesh, novel), shard_cameras(self.mesh, cond)
                known = self._cam_tensors(self.fixed_cam.arrays()) if self.use_known_view else None

            loss, grads, tap_grad, radii, self.overflow = gradients(
                self.params, self.step, known, novel, bg, self.ref_rgb, self.ref_mask, self.draw,
                cond, self.aux.alive, mesh=self.mesh, novel_size=size, ref_size=self.ref_size,
                sh_degree=self.sh_degree, use_known_view=self.use_known_view,
                warmup_rgb_loss=opt.get("warmup_rgb_loss", True),
                total_iters=self.lr_schedules["total_iters"], guidance_fns=self.guidance_fns)
            in_window = (opt.get("density_start_iter", 100) <= self.step
                         <= opt.get("density_end_iter", 3000))
            self.params, self.adam, self.aux = apply_update(
                self.params, self.adam, self.aux, grads, tap_grad, radii, self.step,
                self.lr_schedules, size, accum=in_window)
            if in_window:
                if self.step % opt.get("densification_interval", 100) == 0:
                    with trace.span("stage1.densify", device=True, count="densify"):
                        split_noise = self.draw("split", (2, self.capacity, 3),
                                                "normal").to(self.device)
                        self.params, self.adam, self.aux, dropped = self._densify(
                            self.params, self.adam, self.aux, split_noise)
                    self.densify_dropped = dropped if self.densify_dropped is None \
                        else torch.maximum(self.densify_dropped, dropped)
                if self.step % opt.get("opacity_reset_interval", 700) == 0:
                    with trace.span("stage1.opacity_reset"):
                        self.params, self.adam = reset_opacity(self.params, self.adam)
        return loss

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

    def train(self, iters: int | None = None, log_every: int = 100,
              checkpoint_every: int = 0, checkpoint_dir: str | None = None) -> dict:
        """Run ``iters`` more steps, saving a checkpoint to ``checkpoint_dir``
        after every step that is a multiple of ``checkpoint_every``; then the
        reference's final prune unless ``final_prune`` is false (short runs
        can lose every gaussian to it before any signal accumulates)."""
        iters = iters if iters is not None else self.opt.get("iters", 500)
        t0 = time.perf_counter()
        loss = torch.tensor(float("nan"))
        for _ in range(iters):
            loss = self.train_step()
            if log_every and self.step % log_every == 0:
                print(f"[stage1] step {self.step} loss {float(loss):.4f} "
                      f"alive {num_alive(self.aux)}")
                self._check_overflow()
            if (checkpoint_every and checkpoint_dir and self.step % checkpoint_every == 0
                    and self.is_writer):
                self.save_checkpoint(checkpoint_dir)
        self._check_overflow()
        if self.opt.get("final_prune", True):
            self.params, self.adam, self.aux = prune_only(
                self.params, self.adam, self.aux, min_opacity=0.01, extent=1.0,
                max_screen_size=1.0)
        loss = float(loss)
        return {"loss": loss, "wall_s": time.perf_counter() - t0,
                "alive": num_alive(self.aux), "step": self.step}

    def save_checkpoint(self, path: str) -> str:
        """The whole train state into the directory ``path``."""
        from ..utils.checkpoint import save_stage1

        return save_stage1(path, self)

    def load_checkpoint(self, path: str) -> None:
        """Resume from the checkpoint in the directory ``path``."""
        from ..utils.checkpoint import restore_stage1

        restore_stage1(path, self)

    @torch.no_grad()
    def render_view(self, cam: Camera, bg=None):
        """No-grad render of one camera (test_step analogue)."""
        bg = torch.ones(3, device=self.device) if bg is None else self._tensor(bg)
        return render_one(self.params, self._cam_tensors(cam.arrays()), bg,
                          cam.width, cam.height, self.sh_degree, self.aux.alive)

    def save_ply(self, path: str) -> int:
        """Write the cloud as PLY (rank 0 of a mesh only); returns the number
        of gaussians."""
        if not self.is_writer:
            return num_alive(self.aux)
        return save_ply(path, self.params, self.aux)
