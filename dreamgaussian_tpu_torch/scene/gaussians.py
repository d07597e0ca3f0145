"""Gaussian scene state with fixed-capacity adaptive density control.

Port of ``dreamgaussian_tpu/scene/gaussians.py``. Parameters live in
fixed-capacity arrays with an ``alive`` mask; densify and prune are
functions ``(params, adam, aux) -> (params, adam, aux)`` at constant
shape: survivors keep their slots (so Adam moments stay aligned) and new
gaussians go into freed slots. Activations: scale = exp(log-scale),
opacity = sigmoid(logit), rotation normalized at use.

Quirks of the reference kept for parity:

- the densification stats are zeroed for ALL gaussians after each densify
  pass, so the screen-radius prune inside ``densify_and_prune`` never
  fires; ``prune_only`` uses live stats;
- clones cannot be selected by the split of the same pass;
- split originals are pruned; split children get scale/(0.8*N), N=2, and
  xyz jittered by a rotated Normal(0, scale) sample;
- ``reset_opacity`` clamps activated opacity to <= 0.01 and zeroes the
  opacity Adam moments.

Random draws (positions, colours, split jitter) come in through a
``draw(name, shape, dist)`` function, so tests can inject samples.
PLY output is byte-identical to the JAX package's.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from ..ops.knn import mean_knn_sq_dist
from ..ops.quat import normalize_quat, quat_to_rotmat
from ..utils import ply as plyio
from .optim import AdamState

# draw(name, shape, dist) -> float32 tensor; dist is "uniform" ([0, 1)) or
# "normal" (standard normal).
Draw = Callable[[str, tuple, str], torch.Tensor]


class GaussianAux(NamedTuple):
    """Non-trainable per-slot state."""

    alive: torch.Tensor         # [C] bool
    max_radii2d: torch.Tensor   # [C] f32, max screen radius since reset
    grad_accum: torch.Tensor    # [C] f32, sum ||dL/d mean2d_ndc||
    denom: torch.Tensor         # [C] f32, visibility count


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def num_alive(aux: GaussianAux) -> int:
    return int(aux.alive.sum())


def _empty_aux(capacity: int, num_pts: int, device) -> GaussianAux:
    zeros = torch.zeros(capacity, dtype=torch.float32, device=device)
    return GaussianAux(
        alive=torch.arange(capacity, device=device) < num_pts,
        max_radii2d=zeros, grad_accum=zeros.clone(), denom=zeros.clone(),
    )


def init_random(
    draw: Draw,
    num_pts: int = 5000,
    capacity: int = 65536,
    radius: float = 0.5,
    sh_degree: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[dict, GaussianAux]:
    """Random-ball initialization: uniform in a ``radius`` ball, colours
    ~ U[0, 1/255) taken as SH, opacity 0.1, isotropic log-scale from the
    mean 3-NN squared distance, identity rotation."""
    assert capacity >= num_pts
    phi = draw("init_phi", (num_pts,), "uniform").to(device) * 2.0 * math.pi
    costheta = draw("init_cos", (num_pts,), "uniform").to(device) * 2.0 - 1.0
    sintheta = torch.sqrt(torch.clamp_min(1.0 - costheta ** 2, 0.0))
    r = radius * torch.pow(draw("init_mu", (num_pts,), "uniform").to(device), 1.0 / 3.0)
    xyz = torch.stack(
        [r * sintheta * torch.cos(phi), r * sintheta * torch.sin(phi), r * costheta], 1
    )
    shs = draw("init_col", (num_pts, 3), "uniform").to(device) / 255.0
    dist2 = torch.clamp_min(mean_knn_sq_dist(xyz, k=3), 1e-7)
    scaling = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    n_rest = (sh_degree + 1) ** 2 - 1

    def pad(x, fill=0.0):
        return torch.cat([x, torch.full((capacity - num_pts,) + x.shape[1:], fill,
                                        dtype=torch.float32, device=device)])

    params = {
        "xyz": pad(xyz),
        "f_dc": pad(shs[:, None, :]),
        "f_rest": torch.zeros((capacity, n_rest, 3), dtype=torch.float32, device=device),
        "opacity": pad(inverse_sigmoid(torch.full((num_pts, 1), 0.1, device=device))),
        "scaling": pad(scaling, fill=-10.0),
        "rotation": pad(torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=device).repeat(num_pts, 1)),
    }
    return {k: v.float().contiguous() for k, v in params.items()}, \
        _empty_aux(capacity, num_pts, device)


def accumulate_stats(aux: GaussianAux, mean2d_grad: torch.Tensor,
                     radii: torch.Tensor) -> GaussianAux:
    """Fold one render's densification signals into the running stats.

    mean2d_grad: [C,2] dL/d(pixel mean2d) * (W/2, H/2); radii: [C] int32.
    """
    vis = (radii > 0) & aux.alive
    gnorm = torch.linalg.norm(mean2d_grad[:, :2], dim=-1)
    return aux._replace(
        max_radii2d=torch.where(vis, torch.maximum(aux.max_radii2d, radii.float()),
                                aux.max_radii2d),
        grad_accum=aux.grad_accum + torch.where(vis, gnorm, torch.zeros_like(gnorm)),
        denom=aux.denom + vis.float(),
    )


def _alloc_slots(free: torch.Tensor, want: torch.Tensor):
    """Map the j-th wanted item to the j-th free slot (index order).

    Returns (dest [M] int64, == C for items that got no slot, ok [M])."""
    c = free.shape[0]
    order = torch.sort((~free).to(torch.int32), stable=True).indices
    n_free = free.sum()
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    ok = want & (rank < n_free)
    dest = torch.where(ok, order[torch.clamp(rank, 0, c - 1)], torch.full_like(rank, c))
    return dest, ok


def _scatter_rows(params: dict, new_vals: dict, dest: torch.Tensor) -> dict:
    """Rows ``new_vals[k][i]`` into slot ``dest[i]``; dest == C is dropped."""
    out = {}
    for k, v in params.items():
        buf = torch.cat([v, v[:1]])        # one spare row takes the drops
        buf[dest] = new_vals[k].to(v.dtype)
        out[k] = buf[:-1]
    return out


def _zero_rows(tree: dict, mask: torch.Tensor) -> dict:
    return {
        k: torch.where(mask.reshape((-1,) + (1,) * (v.dim() - 1)), torch.zeros_like(v), v)
        for k, v in tree.items()
    }


@torch.no_grad()
def densify_and_prune(
    params: dict,
    adam: AdamState,
    aux: GaussianAux,
    split_noise: torch.Tensor,
    grad_threshold: float = 0.01,
    min_opacity: float = 0.01,
    extent: float = 4.0,
    percent_dense: float = 0.01,
):
    """Clone + split + prune at fixed capacity.

    ``split_noise``: [2, C, 3] standard-normal jitter for the two split
    children. Returns ``(params, adam, aux, dropped)``; ``dropped`` is the
    number of candidates that found no free slot (callers grow capacity).
    """
    alive = aux.alive
    grads = aux.grad_accum / torch.clamp_min(aux.denom, 1.0)
    grads = torch.where((aux.denom > 0) & alive, grads, torch.zeros_like(grads))

    act_scale = torch.exp(params["scaling"])
    max_scale = act_scale.amax(-1)
    act_op = torch.sigmoid(params["opacity"][:, 0])

    hot = alive & (grads >= grad_threshold)
    small = max_scale <= percent_dense * extent
    clone_sel = hot & small
    split_sel = hot & ~small

    prune_orig = (act_op < min_opacity) | (max_scale > 0.1 * extent)
    keep = alive & ~split_sel & ~prune_orig
    free = ~keep

    rot = quat_to_rotmat(normalize_quat(params["rotation"]))

    def split_child(sample):
        child = dict(params)
        child["xyz"] = params["xyz"] + torch.einsum("cij,cj->ci", rot, sample * act_scale)
        child["scaling"] = torch.log(act_scale / 1.6)  # /(0.8*N), N=2
        return child

    children = (split_child(split_noise[0]), split_child(split_noise[1]))
    cand = {k: torch.cat([params[k], children[0][k], children[1][k]]) for k in params}
    cand_op = torch.sigmoid(cand["opacity"][:, 0])
    cand_ws = torch.exp(cand["scaling"]).amax(-1) > 0.1 * extent
    cand_valid = torch.cat([clone_sel, split_sel, split_sel])
    cand_valid = cand_valid & ~((cand_op < min_opacity) | cand_ws)

    dest, ok = _alloc_slots(free, cand_valid)
    dropped = cand_valid.sum() - ok.sum()
    new_params = _scatter_rows(params, cand, dest)

    mu = _zero_rows(adam.mu, free)
    nu = _zero_rows(adam.nu, free)
    new_alive = torch.cat([keep, keep[:1]])
    new_alive[dest] = True
    zeros = torch.zeros_like(aux.max_radii2d)
    new_aux = GaussianAux(alive=new_alive[:-1], max_radii2d=zeros,
                          grad_accum=zeros.clone(), denom=zeros.clone())
    return new_params, AdamState(mu=mu, nu=nu, count=adam.count), new_aux, dropped


@torch.no_grad()
def prune_only(params: dict, adam: AdamState, aux: GaussianAux,
               min_opacity: float = 0.01, extent: float = 1.0,
               max_screen_size: float = 1.0):
    """Standalone prune with LIVE stats (reference ``prune``)."""
    act_op = torch.sigmoid(params["opacity"][:, 0])
    max_scale = torch.exp(params["scaling"]).amax(-1)
    prune = act_op < min_opacity
    if max_screen_size:
        prune = prune | (aux.max_radii2d > max_screen_size)
        prune = prune | (max_scale > 0.1 * extent)
    keep = aux.alive & ~prune
    freed = aux.alive & ~keep
    return (
        params,
        AdamState(mu=_zero_rows(adam.mu, freed), nu=_zero_rows(adam.nu, freed),
                  count=adam.count),
        aux._replace(alive=keep),
    )


@torch.no_grad()
def reset_opacity(params: dict, adam: AdamState):
    """Clamp activated opacity to <= 0.01 and zero its Adam moments."""
    params = dict(params)
    params["opacity"] = inverse_sigmoid(torch.clamp_max(torch.sigmoid(params["opacity"]), 0.01))
    mu = dict(adam.mu)
    nu = dict(adam.nu)
    mu["opacity"] = torch.zeros_like(mu["opacity"])
    nu["opacity"] = torch.zeros_like(nu["opacity"])
    return params, AdamState(mu=mu, nu=nu, count=adam.count)


def save_ply(path: str, params: Mapping[str, torch.Tensor], aux: GaussianAux) -> int:
    """Write alive gaussians as a GS-standard PLY. Returns the point count."""
    alive = aux.alive.detach().cpu().numpy()
    p = {k: v.detach().cpu().numpy()[alive] for k, v in params.items()}
    n = p["xyz"].shape[0]
    if n == 0:
        print(f"[WARN] saving EMPTY gaussian ply to {path} (0 alive)")
        plyio.write_ply(path, {"vertex": plyio.structured_from_columns(
            {name: np.zeros((0,), np.float32) for name in ("x", "y", "z")}
        )})
        return 0
    cols: dict[str, np.ndarray] = {}
    for i, name in enumerate("xyz"):
        cols[name] = p["xyz"][:, i]
    for name in ("nx", "ny", "nz"):
        cols[name] = np.zeros((n,), np.float32)
    f_dc = p["f_dc"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_dc.shape[1]):
        cols[f"f_dc_{i}"] = f_dc[:, i]
    f_rest = p["f_rest"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_rest.shape[1]):
        cols[f"f_rest_{i}"] = f_rest[:, i]
    cols["opacity"] = p["opacity"][:, 0]
    for i in range(3):
        cols[f"scale_{i}"] = p["scaling"][:, i]
    for i in range(4):
        cols[f"rot_{i}"] = p["rotation"][:, i]
    cols = {k: v.astype(np.float32) for k, v in cols.items()}
    plyio.write_ply(path, {"vertex": plyio.structured_from_columns(cols)})
    return n


def load_ply(path: str, capacity: int | None = None,
             device: str | torch.device = "cuda") -> tuple[dict, GaussianAux, int]:
    """Load a GS-standard PLY into padded tensors -> (params, aux, sh_degree).
    Capacity defaults to the next power of two >= 2N (at least 1024)."""
    cols = plyio.read_ply(path)["vertex"]
    names = cols.dtype.names
    n = cols.shape[0]
    if capacity is None:
        capacity = max(1024, 1 << int(np.ceil(np.log2(max(n, 1) * 2))))
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], axis=1).reshape(n, 1, 3)
    rest_names = sorted((nm for nm in names if nm.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    n_rest = len(rest_names) // 3
    sh_degree = int(round(np.sqrt(n_rest + 1))) - 1
    if rest_names:
        fr = np.stack([cols[nm] for nm in rest_names], axis=1)
        f_rest = fr.reshape(n, 3, n_rest).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    opacity = cols["opacity"][:, None]
    scaling = np.stack([cols[f"scale_{i}"] for i in range(3)], axis=1)
    rotation = np.stack([cols[f"rot_{i}"] for i in range(4)], axis=1)

    def pad(x, fill=0.0):
        full = np.concatenate([x, np.full((capacity - n,) + x.shape[1:], fill, np.float32)])
        return torch.from_numpy(full.astype(np.float32)).to(device)

    params = {
        "xyz": pad(xyz),
        "f_dc": pad(f_dc),
        "f_rest": pad(f_rest),
        "opacity": pad(opacity),
        "scaling": pad(scaling, fill=-10.0),
        "rotation": torch.from_numpy(np.concatenate([
            rotation, np.tile(np.array([[1, 0, 0, 0]], np.float32), (capacity - n, 1)),
        ]).astype(np.float32)).to(device),
    }
    return params, _empty_aux(capacity, n, device), sh_degree
