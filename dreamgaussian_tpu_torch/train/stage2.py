"""Stage-2 trainer: UV-texture (and optional geometry) refinement (eager).

Port of ``dreamgaussian_tpu/train/stage2.py``'s ``Stage2Trainer``. Each
step has two phases, the JAX package's two jitted programs:

1. the target phase, under ``torch.no_grad()``: render the novel views at
   the target SSAA, run every refine fn on them (the diffusion prior's
   img2img at strength 0.8 + 0.15 * step_ratio), and resize the refined
   images to the render resolution;
2. the grad step: the known-view loss ``mean(((image - ref) * valid)**2)``
   with ``valid = (alpha > 0) & (viewcos > 0.5)`` (no gradient through the
   mask), one render of the novel views at the step's SSAA with
   ``lambda * mean((image - target)**2)`` per refine fn, ``backward()``,
   ``nan_to_num`` of the gradients, then Adam with ``texture_lr`` on
   ``raw_albedo`` and ``geom_lr`` on ``v_offsets``.

Cameras and the SSAA factor come from ``np.random.default_rng(seed)`` in
the JAX trainer's call order (``_sample_ssaa``, then ``ver``, ``hor`` per
batch entry). With ``mvdream`` or ``imagedream`` each sampled camera
becomes a group of 4 views at hor + 90 i (their poses in ``cond``), and
the known view sits at azimuth 90 (ImageDream has none: its input image
conditions the refine). The refine noise comes from ``draw("refine_noise", shape,
"normal")``, one draw per refine fn per step; tests inject JAX's samples.

refine_fns: tuple of (weight, fn) entries with fn(images [B,H,W,3], cond,
strength, draw) -> refined images (no gradient), as
``Zero123Guidance.refine_fn`` gives them.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from .. import resolve_device
from ..ops.mesh_raster import scale_img
from ..render.mesh_renderer import MeshRendererState, render_mesh
from ..scene.optim import AdamState, adam_init, adam_update
from ..utils import trace
from ..utils.camera import Camera, orbit_camera
from .stage1 import TorchDraw

# The reference's continuous SSAA jitter min(2, max(0.125, 2*rand())) in
# four bins of equal weight; at the 512 default the renders are 128, 384,
# 640 and 896 pixels wide, all divisible by 32.
SSAA_CHOICES = (0.25, 0.75, 1.25, 1.75)


class Stage2Trainer:
    def __init__(
        self,
        opt: Any,
        mesh,
        ref_rgb: np.ndarray | None = None,
        ref_mask: np.ndarray | None = None,
        refine_fns: tuple = (),
        seed: int = 0,
        refine_image_size: int | None = None,
        device: str | torch.device = "cuda",
        draw: Callable[[str, tuple, str], torch.Tensor] | None = None,
    ):
        """opt: config namespace with the reference's stage-2 keys. ref_mask
        is taken for the CLI's call and not used: the known-view loss masks
        by the render's own coverage and view angle."""
        self.device = resolve_device(device)
        self.opt = opt
        self.rng = np.random.default_rng(seed)
        self.draw = draw if draw is not None else TorchDraw(seed, self.device)
        self.step = 0
        self.mesh = mesh
        self.state = MeshRendererState.from_mesh(mesh, self.device)
        self.train_geo = bool(opt.get("train_geo", False))
        self.refine_fns = refine_fns
        self.refine_image_size = refine_image_size

        self.params = self.state.trainable(self.train_geo)
        self.adam = adam_init(self.params)
        self.lrs = {"raw_albedo": opt.get("texture_lr", 0.2),
                    "v_offsets": opt.get("geom_lr", 1e-4)}

        self.ref_size = opt.get("ref_size", 256)
        self.ref_rgb = self._tensor(ref_rgb) if ref_rgb is not None else None
        self.use_known_view = ref_rgb is not None and not opt.get("imagedream", False)

        self.fovy = np.radians(opt.get("fovy", 49.1))
        self.radius = opt.get("radius", 2.0)
        self.elevation = opt.get("elevation", 0.0)
        mv = bool(opt.get("mvdream", False) or opt.get("imagedream", False))
        self.fixed_cam = Camera.from_pose(orbit_camera(self.elevation, 90 if mv else 0, self.radius),
                                          self.ref_size, self.ref_size, self.fovy, self.fovy)
        self.n_views = 4 if mv else 1
        self.batch_size = opt.get("batch_size", 1)
        self.render_resolution = opt.get("novel_resolution", 512)
        self.phase_times: list = []   # (target_s, grad_s) per step when phase_timing

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------

    def _sample_ssaa(self) -> float:
        return SSAA_CHOICES[int(self.rng.integers(0, len(SSAA_CHOICES)))]

    def _sample_novel(self):
        opt = self.opt
        min_ver = max(min(opt.get("min_ver", -30), opt.get("min_ver", -30) - self.elevation),
                      -80 - self.elevation)
        max_ver = min(max(opt.get("max_ver", 30), opt.get("max_ver", 30) - self.elevation),
                      80 - self.elevation)
        cams, poses, vers, hors = [], [], [], []
        size = self.render_resolution
        for _ in range(self.batch_size):
            ver = int(self.rng.integers(min_ver, max_ver))
            hor = int(self.rng.integers(-180, 180))
            vers.append(ver)
            hors.append(hor)
            for i in range(self.n_views):
                pose = orbit_camera(self.elevation + ver, hor + 90 * i, self.radius)
                poses.append(pose)
                cams.append(Camera.from_pose(pose, size, size, self.fovy, self.fovy))
        return cams, np.stack(poses), np.array(vers, np.float32), np.array(hors, np.float32)

    def _view(self, cam: Camera):
        """(camera tensors, camera-to-world rotation) of ``cam``: the view is
        the rectified world-to-camera matrix with rows 1:3 negated."""
        arr = {k: self._tensor(v) for k, v in cam.arrays().items() if k in ("view", "full_proj")}
        w2c = np.asarray(cam.view[:3, :3]).copy()
        w2c[1:3] *= -1
        return arr, self._tensor(w2c.T)

    def _render(self, cam: Camera, size: int, ssaa: float, params=None) -> dict:
        arr, rot = self._view(cam)
        st = self.state.with_params(self.params if params is None else params)
        return render_mesh(st, arr, rot, size, size, ssaa=ssaa, train_geo=self.train_geo)

    def _target_ssaa(self, ssaa_novel: float) -> float:
        """SSAA of the target render. The render is only the refine's input,
        which each guidance resizes to its image_size, so by default it is
        rendered at image_size / render_resolution (0.5 for Zero123's 256 at
        512). ``target_render_jitter`` renders it at the grad render's
        jittered SSAA instead, ``target_render_ssaa`` at a given factor."""
        if self.opt.get("target_render_jitter", False):
            return ssaa_novel
        ssaa = self.opt.get("target_render_ssaa", None)
        if ssaa is not None:
            return ssaa
        if self.refine_image_size is not None:
            return min(1.0, self.refine_image_size / self.render_resolution)
        return 0.5

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _targets(self, cams, ssaa: float, cond: dict, strength: np.float32) -> list:
        """Target phase: render the novel views and refine them -> one
        [B, H, W, 3] target per refine fn, at the render resolution."""
        size = self.render_resolution
        images = torch.stack([self._render(c, size, ssaa)["image"] for c in cams])
        return [scale_img(fn(images, cond, strength, self.draw), size, size)
                for _, fn in self.refine_fns]

    def _loss(self, params, cams, ssaa_novel: float, targets: list) -> torch.Tensor:
        """Grad step's loss: known view, then each novel view against each target."""
        loss = torch.zeros((), device=self.device)
        if self.use_known_view:
            out = self._render(self.fixed_cam, self.ref_size, 1.0, params)
            valid = ((out["alpha"] > 0) & (out["viewcos"] > 0.5)).float().detach()
            loss = loss + torch.mean(((out["image"] - self.ref_rgb) * valid) ** 2)
        for b, cam in enumerate(cams):
            image = self._render(cam, self.render_resolution, ssaa_novel, params)["image"]
            for (lam, _), target in zip(self.refine_fns, targets):
                loss = loss + lam * torch.mean((image - target[b]) ** 2)
        return loss

    def train_step(self) -> torch.Tensor:
        """One step; returns the loss (a device tensor)."""
        self.step += 1
        with trace.span("stage2.step", step=self.step):
            step_ratio = min(1.0, self.step / self.opt.get("iters_refine", 50))
            with trace.span("stage2.cameras"):
                ssaa_novel = self._sample_ssaa()
                cams, poses, vers, hors = self._sample_novel()
                # float32, as the JAX step's traced strength.
                strength = np.float32(step_ratio * 0.15 + 0.8)
                cond = dict(vers=self._tensor(vers), hors=self._tensor(hors),
                            radii=torch.zeros(len(vers), device=self.device),
                            poses=self._tensor(poses))

            timing = self.opt.get("phase_timing", False)
            if timing:
                self._sync()
                t0 = time.perf_counter()
            with trace.span("stage2.target"):
                targets = self._targets(cams, self._target_ssaa(ssaa_novel), cond, strength)
            if timing:
                self._sync()
                t1 = time.perf_counter()

            with trace.span("stage2.grad"):
                params = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
                loss = self._loss(params, cams, ssaa_novel, targets)
                with trace.span("stage2.backward"):
                    if loss.requires_grad:
                        loss.backward()
                    # A parameter no loss term reached has a zero gradient, as
                    # in jax.grad.
                    grads = {k: torch.zeros_like(p) if p.grad is None else torch.nan_to_num(p.grad)
                             for k, p in params.items()}
                with trace.span("stage2.update"):
                    self.params, self.adam = adam_update(self.params, grads, self.adam, self.lrs)
            if timing:
                self._sync()
                self.phase_times.append((t1 - t0, time.perf_counter() - t1))
        return loss.detach()

    def train(self, iters: int | None = None, log_every: int = 10) -> dict:
        iters = iters if iters is not None else self.opt.get("iters_refine", 50)
        t0 = time.perf_counter()
        loss = float("nan")
        for _ in range(iters):
            loss = self.train_step()
            if log_every and self.step % log_every == 0:
                print(f"[stage2] step {self.step} loss {float(loss):.6f}")
        return {"loss": float(loss), "wall_s": time.perf_counter() - t0}

    def export_mesh(self, path: str):
        """Write the refined mesh: vertices with their offsets, the albedo
        through the sigmoid."""
        with torch.no_grad():
            v = self.state.v + self.params.get("v_offsets", torch.zeros_like(self.state.v))
            self.mesh.v = v.cpu().numpy()
            self.mesh.albedo = torch.sigmoid(self.params["raw_albedo"]).cpu().numpy()
        self.mesh.write(path)
        return self.mesh

    @torch.no_grad()
    def render_view(self, cam: Camera, ssaa: float = 1.0) -> dict:
        arr, rot = self._view(cam)
        return render_mesh(self.state.with_params(self.params), arr, rot, cam.height,
                           cam.width, ssaa=ssaa, train_geo=self.train_geo)

    # ------------------------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Params, Adam moments and count, the step and the draw's state as
        one npz (the JAX trainer's keys, with ``draw_state`` for its key)."""
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        arrs = {f"p_{k}": host(v) for k, v in self.params.items()}
        arrs.update({f"mu_{k}": host(v) for k, v in self.adam.mu.items()})
        arrs.update({f"nu_{k}": host(v) for k, v in self.adam.nu.items()})
        arrs["adam_count"] = np.asarray(self.adam.count)
        arrs["step"] = np.asarray(self.step)
        if isinstance(self.draw, TorchDraw):
            arrs["draw_state"] = self.draw.get_state()
        np.savez(path, **arrs)

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as data:
            pick = lambda prefix: {k[len(prefix):]: self._tensor(v)  # noqa: E731
                                   for k, v in data.items() if k.startswith(prefix)}
            self.params = pick("p_")
            self.adam = AdamState(mu=pick("mu_"), nu=pick("nu_"), count=int(data["adam_count"]))
            self.step = int(data["step"])
            if "draw_state" in data and isinstance(self.draw, TorchDraw):
                self.draw.set_state(data["draw_state"])
