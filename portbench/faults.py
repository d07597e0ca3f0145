"""Faults planted under the timed path, for the test that sees ``correct``
come out false and for the readings the limits are set against. Never
used by a run of the benchmark.

- ``state_unchanged``: the update returns the state as it was (stage 1:
  the parameters, Adam's state and the statistics; stage 2: the albedo
  and Adam's state): a step that changes nothing;
- ``render_altered``: every render (the gaussian render of stage 1, the
  mesh render of stage 2) comes back as its negative, ``1 - image`` (an
  answer altered where it is produced);
- ``exchange_left_out`` (data mesh): the gradients' all-reduce over the
  data ranks is skipped, each rank keeps its own;
- ``half_batch`` (data mesh): the ranks of the second half of the data
  axis contribute nothing to the all-reduce, and the sum is doubled (the
  mean taken over the rest).
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "render_altered", "exchange_left_out", "half_batch")
MESH_FAULTS = ("exchange_left_out", "half_batch")


def _stage1_update(params, adam, aux, *args, **kwargs):
    return params, adam, aux


def _stage2_update(params, grads, state, lrs, *args, **kwargs):
    return params, state


def _negative(original):
    def broken(*args, **kwargs):
        out = original(*args, **kwargs)
        if isinstance(out, dict):
            return dict(out, image=1.0 - out["image"])
        return out._replace(image=1.0 - out.image)
    return broken


def _no_exchange(mesh, grads, tap_grad, loss, overflow, radii):
    return grads, tap_grad, loss, overflow, radii


def _half_batch(original):
    def broken(mesh, grads, tap_grad, loss, overflow, radii):
        if mesh.data.index >= mesh.data.size // 2:
            grads = {k: torch.zeros_like(v) for k, v in grads.items()}
            tap_grad, loss = torch.zeros_like(tap_grad), torch.zeros_like(loss)
        grads, tap_grad, loss, overflow, radii = original(mesh, grads, tap_grad, loss, overflow,
                                                          radii)
        return {k: 2.0 * v for k, v in grads.items()}, 2.0 * tap_grad, 2.0 * loss, overflow, radii
    return broken


@contextlib.contextmanager
def plant(name: str):
    from dreamgaussian_tpu_torch.parallel import dp as dp_mod
    from dreamgaussian_tpu_torch.train import stage1 as stage1_mod
    from dreamgaussian_tpu_torch.train import stage2 as stage2_mod
    from dreamgaussian_tpu_torch.train import step as step_mod

    if name == "state_unchanged":
        patches = [(stage1_mod, "apply_update", _stage1_update),
                   (stage2_mod, "adam_update", _stage2_update)]
    elif name == "render_altered":
        patches = [(step_mod, "render_gaussians", _negative(step_mod.render_gaussians)),
                   (stage2_mod, "render_mesh", _negative(stage2_mod.render_mesh))]
    elif name == "exchange_left_out":
        patches = [(dp_mod, "reduce_over_data", _no_exchange)]
    elif name == "half_batch":
        patches = [(dp_mod, "reduce_over_data", _half_batch(dp_mod.reduce_over_data))]
    else:
        raise ValueError(f"unknown fault {name!r}")
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, fn in patches:
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
