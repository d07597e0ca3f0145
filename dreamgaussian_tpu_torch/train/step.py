"""The stage-1 step body, shared by the single-process trainer and the
data-parallel step (``parallel/dp.py``): render, loss, gradients and the
replicated update.

With a mesh (``parallel.Mesh2D``) the same body runs on every rank:

- the known-view loss is computed on every rank and divided by the data
  size, so the sum over the data group reproduces the single-process
  gradient;
- the guidance loss is the mean over the rank's views (the guidance's
  contract) divided by the data size;
- the densify statistics come from the GLOBALLY-LAST novel view only: the
  mean2D gradient tap renders with the last local view of the last data
  rank (elsewhere it is not passed, so its gradient is zero there), and
  only that rank keeps the view's radii; the sum and the max over the data
  group (``parallel.dp.reduce_over_data``) then give every rank that view's
  statistics. This is the reference's last-view quirk, which the
  single-process trainer keeps;
- each render's tile rows shard over the tile axis when it has more than
  one rank (``parallel/tile_shard.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rasterize import render_gaussians
from ..scene import accumulate_stats, adam_update
from ..utils import trace

TILE = 32


def render_one(params, cam, bg, width, height, sh_degree, alive, tap=None, mesh=None,
               tile: int = TILE):
    """One render of raw parameters; tile-sharded over ``mesh``'s tile axis
    when it has more than one rank."""
    args = (params["xyz"], torch.exp(params["scaling"]), params["rotation"],
            torch.sigmoid(params["opacity"][:, 0]),
            torch.cat([params["f_dc"], params["f_rest"]], dim=1),
            cam["view"], cam["full_proj"], cam["campos"], cam["tanfov"], width, height, bg)
    if mesh is not None and mesh.tile.size > 1:
        from ..parallel.tile_shard import render_gaussians_tile_sharded

        return render_gaussians_tile_sharded(*args, mesh.tile, sh_degree=sh_degree, alive=alive,
                                             mean2d_tap=tap, tile=tile)
    return render_gaussians(*args, sh_degree=sh_degree, alive=alive, mean2d_tap=tap, tile=tile,
                            device=params["xyz"].device)


def local_loss(params, tap, step: float, known_cams, novel_cams, bg, ref_rgb, ref_mask, draw,
               cond, alive, *, mesh, novel_size: int, ref_size: int, sh_degree: int,
               use_known_view: bool, warmup_rgb_loss: bool, total_iters: float,
               guidance_fns: tuple):
    """This rank's share of the step's loss: (loss, radii of the globally
    last view or zeros, binning overflow). ``novel_cams`` and ``cond``'s
    per-view entries are this rank's; ``tap`` renders with the globally
    last view."""
    n_data = 1 if mesh is None else mesh.data.size
    last_rank = mesh is None or mesh.data.index == n_data - 1
    dev = params["xyz"].device
    # float32 like the JAX step's traced scalars.
    step_ratio = float(min(np.float32(1.0), np.float32(step) / np.float32(total_iters)))
    w = step_ratio if warmup_rgb_loss else 1.0
    loss = torch.zeros((), device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    n_local = novel_cams["view"].shape[0]
    radii = torch.zeros((params["xyz"].shape[0],), dtype=torch.int32, device=dev)
    with trace.span("stage1.render"):
        if use_known_view:
            out = render_one(params, known_cams, torch.ones(3, device=dev), ref_size, ref_size,
                             sh_degree, alive, mesh=mesh)
            known = (10000.0 * w * torch.mean((out.image - ref_rgb) ** 2)
                     + 1000.0 * w * torch.mean((out.alpha - ref_mask) ** 2))
            loss = loss + known / n_data
            overflow = overflow + out.overflow
        images = []
        for b in range(n_local):
            last_view = last_rank and b == n_local - 1
            out = render_one(params, {k: v[b] for k, v in novel_cams.items()}, bg, novel_size,
                             novel_size, sh_degree, alive, tap=tap if last_view else None,
                             mesh=mesh)
            images.append(out.image)
            if last_view:
                radii = out.radii
            overflow = overflow + out.overflow
        images = torch.stack(images)
    # Guidance contract: fn returns the MEAN loss over the views given, so
    # the sum over the data ranks of mean / n_data is the global mean (as
    # in JAX; Zero123's fn returns the sum over its views, which this
    # divides by n_data against one process, in both packages).
    for weight, fn in guidance_fns:
        with trace.span("stage1.guidance"):
            loss = loss + weight * fn(images, cond, step_ratio, draw) / n_data
    return loss, radii, overflow


def gradients(params, step: float, known_cams, novel_cams, bg, ref_rgb, ref_mask, draw, cond,
              alive, *, mesh=None, **loss_kw):
    """The step's forward and backward (NaN-zeroed gradients) and, over a
    mesh with more than one data rank, their reduction over the data
    group: (loss, grads, tap gradient, radii, overflow), equal on every
    rank."""
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    tap = torch.zeros((params["xyz"].shape[0], 2), device=params["xyz"].device,
                      requires_grad=True)
    loss, radii, overflow = local_loss(params, tap, step, known_cams, novel_cams, bg, ref_rgb,
                                       ref_mask, draw, cond, alive, mesh=mesh, **loss_kw)
    with trace.span("stage1.backward"):
        loss.backward()

        # A tensor that no loss term reached has no .grad: its gradient is
        # zero, as jax.grad returns it.
        def grad(t):
            return torch.zeros_like(t) if t.grad is None else torch.nan_to_num(t.grad)

        grads, tap_grad, loss = {k: grad(p) for k, p in params.items()}, grad(tap), loss.detach()
    if mesh is not None and mesh.data.size > 1:
        from ..parallel.dp import reduce_over_data

        with trace.span("stage1.allreduce"):
            grads, tap_grad, loss, overflow, radii = reduce_over_data(
                mesh, grads, tap_grad, loss, overflow, radii)
    return loss, grads, tap_grad, radii, overflow


def apply_update(params, adam, aux, grads, tap_grad, radii, step: float, lr_schedules: dict,
                 novel_size: int, accum: bool):
    """The replicated Adam update and, when ``accum``, the densify stats
    (the tap's gradient in the half-image units the reference thresholds)."""
    with trace.span("stage1.update"):
        lrs = {k: lr_schedules[k] for k in ("f_dc", "f_rest", "opacity", "scaling", "rotation")}
        lrs["xyz"] = lr_schedules["xyz"](step)
        params, adam = adam_update(params, grads, adam, lrs)
        if accum:
            aux = accumulate_stats(aux, tap_grad * (novel_size / 2.0), radii)
    return params, adam, aux
