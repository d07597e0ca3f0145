"""Data-parallel stage-1 training over ``torch.distributed``.

Port of ``dreamgaussian_tpu/parallel/dp.py``. The novel SDS views shard
over a mesh's ``data`` axis: each rank renders its own views and evaluates
the guidance loss on them, and the gradients are combined with ONE packed
all-reduce over the data group (``reduce_over_data``). Parameters, Adam
moments and the density controller are replicated: every rank computes
the same update, so no parameter is ever sent, and densify decisions agree
on every rank. The step body (the loss's division of labour over the
ranks, the densify tap of the globally last view) is the single-process
trainer's, ``train/step.py``.

Random numbers: the JAX step takes one replicated key, so every data rank
draws the same noise and timestep for its own views. The port keeps that:
every rank's ``draw`` and camera RNG are seeded alike and advance alike.

``make_dp_train_scan`` (K steps fused in one dispatch) has no counterpart:
the eager trainer's loop (``train/stage1.py``) runs the same steps, with
densify and opacity reset on the steps where JAX's ``lax.cond`` fires.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..train.step import apply_update, gradients
from .multihost import Mesh2D, make_mesh_2d


def make_data_mesh(n_ranks: int | None = None, device: str | torch.device = "cuda") -> Mesh2D:
    """A mesh whose every rank is on the data axis."""
    return make_mesh_2d(data=n_ranks, tile=1, device=device)


def shard_cameras(mesh: Mesh2D, cams: dict) -> dict:
    """This rank's slice of stacked per-view arrays (leading axis: views,
    in data-rank order)."""
    out = {}
    for k, v in cams.items():
        n = v.shape[0]
        if n % mesh.data.size:
            raise ValueError(f"{n} views of {k!r} cannot shard over data={mesh.data.size}")
        per = n // mesh.data.size
        out[k] = v[mesh.data.index * per:(mesh.data.index + 1) * per]
    return out


def reduce_over_data(mesh: Mesh2D, grads: dict, tap_grad, loss, overflow, radii):
    """The gradients, the tap's gradient, the loss and the overflow summed
    over the data group in ONE packed all-reduce, the radii by a MAX
    all-reduce. Returns them in the same order."""
    keys = sorted(grads)
    parts = [grads[k] for k in keys] + [tap_grad, loss.reshape(1),
                                        overflow.to(loss.dtype).reshape(1)]
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, group=mesh.data.group)
    radii = radii.clone()
    dist.all_reduce(radii, op=dist.ReduceOp.MAX, group=mesh.data.group)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    grads = dict(zip(keys, out[:len(keys)]))
    tap_grad, loss, overflow = out[len(keys)], out[-2][0], out[-1][0].to(torch.int32)
    return grads, tap_grad, loss, overflow, radii


def make_dp_train_step(mesh: Mesh2D, *, novel_size: int, ref_size: int, sh_degree: int,
                       views_per_device: int, use_known_view: bool, warmup_rgb_loss: bool,
                       lr_schedules: dict, guidance_fns: tuple = ()) -> Callable:
    """One data-parallel (and, with a tile axis, tile-sharded) train step,
    as JAX's ``make_dp_train_step``:

        step(params, adam, aux, step, known_cams, novel_cams, bg, ref_rgb,
             ref_mask, draw, cond, accum=True)
          -> (params, adam, aux, {"loss", "overflow"})

    ``novel_cams`` and the per-view entries of ``cond`` are this rank's
    ``views_per_device`` views (``shard_cameras``); the rest is replicated.
    The returned state and metrics are equal on every rank."""
    loss_kw = dict(novel_size=novel_size, ref_size=ref_size, sh_degree=sh_degree,
                   use_known_view=use_known_view, warmup_rgb_loss=warmup_rgb_loss,
                   total_iters=lr_schedules["total_iters"], guidance_fns=guidance_fns)

    def step_fn(params, adam, aux, step, known_cams, novel_cams, bg, ref_rgb, ref_mask, draw,
                cond, accum=True):
        if novel_cams["view"].shape[0] != views_per_device:
            raise ValueError(f"expected {views_per_device} local views, got "
                             f"{novel_cams['view'].shape[0]}")
        loss, grads, tap_grad, radii, overflow = gradients(
            params, step, known_cams, novel_cams, bg, ref_rgb, ref_mask, draw, cond, aux.alive,
            mesh=mesh, **loss_kw)
        params, adam, aux = apply_update(params, adam, aux, grads, tap_grad, radii, step,
                                         lr_schedules, novel_size, accum)
        return params, adam, aux, {"loss": loss, "overflow": overflow}

    return step_fn
