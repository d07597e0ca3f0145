"""Plain PyTorch stage-1 step of DreamGaussian, the benchmark's reference.

One step, as the published DreamGaussian trainer (main.py) takes it at a
fixed capacity:

1. cameras from the run's numpy generator (``render.sample_orbit``), then
   the background: white when ``rng.random() > invert_bg_prob``;
2. the known-view loss ``10000 w mse(image, ref) + 1000 w mse(alpha, mask)``
   with ``w = step / iters`` (a 256^2 render at elevation 0, azimuth 0),
   when the cell has a known view; then each novel render (the last one
   with the 2D-mean tap for densification) and the guidance's SDS loss,
   weighted by the configuration's lambda;
3. the gradients, NaN-zeroed; Adam (betas 0.9, 0.999, eps 1e-15, bias
   corrections in float32) with the per-group rates and the exponential
   position schedule;
4. inside the densify window: the statistics of the last view (the 2D-mean
   gradient norm scaled by size / 2, the screen radius), and on the
   interval clone and split (threshold 0.01, percent_dense 0.01, extent 4,
   split children at scale / 1.6 jittered by a rotated normal draw) with
   the prune (opacity < 0.01 or scale > 0.4), new gaussians in the freed
   slots in index order, moments of freed slots zeroed, statistics reset.

The random draws (SDS noise, split jitter) are the benchmark's, handed to
both sides. Over ``ranks`` data ranks (the data-parallel step) each rank's
share of the views goes through the guidance with the same noise, and the
guidance term is the mean of the ranks' losses, as the published
data-parallel step defines it. Imports nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import render

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15
LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def expon_lr(step: float, init: float, final: float, delay_mult: float, max_steps: int) -> float:
    """Log-linear decay from ``init`` to ``final`` over ``max_steps`` (no
    delay steps, so ``delay_mult`` does not act), in float32."""
    f32 = np.float32
    t = np.clip(f32(step) / f32(max_steps), f32(0.0), f32(1.0))
    return float(np.exp(f32(math.log(init)) * (f32(1.0) - t) + f32(math.log(final)) * t))


def adam(params: dict, grads: dict, mu: dict, nu: dict, count: int, lrs: dict):
    t = np.float32(count)
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** t)
    out = {}
    for k, p in params.items():
        mu[k] = ADAM_B1 * mu[k] + (1.0 - ADAM_B1) * grads[k]
        nu[k] = ADAM_B2 * nu[k] + (1.0 - ADAM_B2) * grads[k] * grads[k]
        out[k] = p - lrs[k] * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS))
    return out


def rotmat(q):
    return torch.stack(render.rotation_entries(q), -1).reshape(-1, 3, 3)


@torch.no_grad()
def densify(state: "Stage1", split_noise, threshold=0.01, min_opacity=0.01, extent=4.0,
            percent_dense=0.01):
    p, alive = state.params, state.alive
    grads = state.grad_accum / torch.clamp_min(state.denom, 1.0)
    grads = torch.where((state.denom > 0) & alive, grads, 0.0)
    scale = torch.exp(p["scaling"])
    max_scale = scale.amax(-1)
    hot = alive & (grads >= threshold)
    small = max_scale <= percent_dense * extent
    clone, split = hot & small, hot & ~small
    keep = alive & ~split & ~((torch.sigmoid(p["opacity"][:, 0]) < min_opacity)
                              | (max_scale > 0.1 * extent))
    rot = rotmat(p["rotation"])

    def child(noise):
        c = dict(p)
        c["xyz"] = p["xyz"] + torch.einsum("cij,cj->ci", rot, noise * scale)
        c["scaling"] = torch.log(scale / 1.6)
        return c

    kids = (child(split_noise[0]), child(split_noise[1]))
    cand = {k: torch.cat([p[k], kids[0][k], kids[1][k]]) for k in p}
    cand_ok = torch.cat([clone, split, split]) & ~(
        (torch.sigmoid(cand["opacity"][:, 0]) < min_opacity)
        | (torch.exp(cand["scaling"]).amax(-1) > 0.1 * extent))
    free = ~keep
    cap = free.shape[0]
    slots = torch.nonzero(free).flatten()
    wanted = torch.nonzero(cand_ok).flatten()[:slots.numel()]
    slots = slots[:wanted.numel()]
    new = {}
    for k, v in p.items():
        v = v.clone()
        v[slots] = cand[k][wanted]
        new[k] = v
    for moments in (state.mu, state.nu):
        for k in moments:
            moments[k] = torch.where(free.reshape((-1,) + (1,) * (moments[k].dim() - 1)),
                                     0.0, moments[k])
    new_alive = keep.clone()
    new_alive[slots] = True
    state.params, state.alive = new, new_alive
    state.grad_accum = torch.zeros(cap, device=free.device)
    state.denom = torch.zeros(cap, device=free.device)


def rung(opt: dict, step: int) -> int:
    """Novel-view side of ``step`` on the 128/256/512 ladder (step ratios
    0.3 and 0.6)."""
    ratio = min(1.0, step / opt.get("iters", 500))
    ladder = opt.get("novel_resolutions", [128, 256, 512])
    return ladder[0] if ratio < 0.3 else (ladder[1] if ratio < 0.6 else ladder[2])


class Stage1:
    """The reference trainer's state: raw parameters at a fixed capacity
    (``LEAVES``), the alive mask, Adam's moments and the densify
    statistics. ``opt`` is the configuration's trainer options; ``sds`` a
    ``guidance.SDS``; ``draws`` yields the benchmark's draws in order as
    (name, tensor)."""

    def __init__(self, opt: dict, params: dict, alive, ref_rgb, ref_mask, sds, weight: float,
                 rng: np.random.Generator, draws, step: int, n_views: int, batch: int = 1,
                 ranks: int = 1):
        self.opt, self.sds, self.weight, self.rng = opt, sds, weight, rng
        self.params = {k: v.clone() for k, v in params.items()}
        self.alive = alive.clone()
        self.ref_rgb, self.ref_mask = ref_rgb, ref_mask
        self.draws = draws
        self.step = step
        self.n_views, self.batch, self.ranks = n_views, batch, ranks
        dev = alive.device
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.grad_accum = torch.zeros(alive.shape[0], device=dev)
        self.denom = torch.zeros(alive.shape[0], device=dev)
        self.fovy = math.radians(opt.get("fovy", 49.1))

    def _draw(self, name: str):
        got, tensor = next(self.draws)
        if got != name:
            raise RuntimeError(f"the reference wants the draw {name!r}, the run made {got!r}")
        return tensor

    def _cam(self, pose):
        dev = self.alive.device
        return {k: torch.from_numpy(v).to(dev) for k, v in render.camera_arrays(pose, self.fovy).items()}

    def train_step(self) -> float:
        """One step; returns the loss."""
        opt, dev = self.opt, self.alive.device
        self.step += 1
        iters = opt.get("iters", 500)
        size = rung(opt, self.step)
        vers, hors, poses = render.sample_orbit(self.rng, opt, self.batch, self.n_views)
        bg = torch.full((3,), 1.0 if self.rng.random() > opt.get("invert_bg_prob", 0.5) else 0.0,
                        device=dev)
        step_ratio = float(min(np.float32(1.0), np.float32(self.step) / np.float32(iters)))
        w = step_ratio if opt.get("warmup_rgb_loss", True) else 1.0
        params = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        renders, loss = [], torch.zeros((), device=dev)
        if self.ref_rgb is not None:
            ref_size = opt.get("ref_size", 256)
            known = render.Render(params, self.alive, self._cam(render.orbit_pose(
                opt.get("elevation", 0.0), 0.0, opt.get("radius", 2.0))), ref_size,
                torch.ones(3, device=dev))
            image = render.clamp_tie(known.image, 0.0, 1.0)
            loss = loss + (10000.0 * w * torch.mean((image - self.ref_rgb) ** 2)
                           + 1000.0 * w * torch.mean((known.alpha - self.ref_mask) ** 2))
            renders.append(known)
        novel = [render.Render(params, self.alive, self._cam(p), size, bg) for p in poses]
        renders += novel
        images = torch.stack([render.clamp_tie(r.image, 0.0, 1.0) for r in novel])
        cond = {"vers": torch.from_numpy(vers).to(dev), "hors": torch.from_numpy(hors).to(dev),
                "radii": torch.zeros(len(vers), device=dev),
                "poses": torch.from_numpy(poses).to(dev)}
        # Over data ranks each rank's views go through the guidance alone,
        # with the same noise draw on every rank, and the sum over the
        # ranks of each rank's loss over ``ranks`` is the step's.
        noise = self._draw("sds_noise")
        per = images.shape[0] // self.ranks
        for r in range(self.ranks):
            views = slice(r * per, (r + 1) * per)
            entries = slice(r * len(vers) // self.ranks, (r + 1) * len(vers) // self.ranks)
            part = {k: v[views if k == "poses" else entries] for k, v in cond.items()}
            loss = loss + self.weight * self.sds.loss(images[views], part, step_ratio,
                                                      noise) / self.ranks
        loss.backward()
        for r in renders:
            r.backward()
        grads = {k: torch.nan_to_num(p.grad) if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        tap = torch.nan_to_num(novel[-1].mean2d_grad)
        radii = novel[-1].proj.radius

        self.count += 1
        lrs = {"f_dc": opt.get("feature_lr", 0.01), "f_rest": opt.get("feature_lr", 0.01) / 20.0,
               "opacity": opt.get("opacity_lr", 0.05), "scaling": opt.get("scaling_lr", 5e-3),
               "rotation": opt.get("rotation_lr", 5e-3),
               "xyz": expon_lr(self.step, opt.get("position_lr_init", 1e-3) * self.pos_lr_scale,
                               opt.get("position_lr_final", 2e-5) * self.pos_lr_scale,
                               opt.get("position_lr_delay_mult", 0.02),
                               opt.get("position_lr_max_steps", 500))}
        self.params = adam(self.params, grads, self.mu, self.nu, self.count, lrs)
        start, end = opt.get("density_start_iter", 100), opt.get("density_end_iter", 3000)
        if start <= self.step <= end:
            vis = (radii > 0) & self.alive
            gnorm = torch.linalg.norm(tap * (size / 2.0), dim=-1)
            self.grad_accum = self.grad_accum + torch.where(vis, gnorm, 0.0)
            self.denom = self.denom + vis.float()
            if self.step % opt.get("densification_interval", 100) == 0:
                noise = self._draw("split").reshape(2, -1, 3)
                densify(self, noise, threshold=opt.get("densify_grad_threshold", 0.01),
                        percent_dense=opt.get("percent_dense", 0.01))
            if self.step % opt.get("opacity_reset_interval", 700) == 0:
                op = torch.sigmoid(self.params["opacity"]).clamp_max(0.01)
                self.params["opacity"] = torch.log(op / (1.0 - op))
                self.mu["opacity"] = torch.zeros_like(self.mu["opacity"])
                self.nu["opacity"] = torch.zeros_like(self.nu["opacity"])
        return float(loss.detach())

    pos_lr_scale = 1.0   # a cloud handed in (not the random start) keeps the rate as set
