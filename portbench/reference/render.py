"""Plain PyTorch gaussian rendering: cameras, EWA projection, compositing.

The benchmark's reference for the port's gaussian render (projection,
binning, K1/K2). It follows the published 3D Gaussian Splatting rasterizer
(Kerbl et al. 2023) as the port states it, without tiles as a data
structure:

- cameras: OpenGL orbit poses, the GS rectification (w2c rows 1:3 and the
  translation negated, ``campos = -c2w[:3, 3]``) and the z-forward GS
  projection;
- projection: view-space z cull at 0.2, the 1.3 tan(fov) frustum clamp of
  the EWA Jacobian, +0.3 pixel dilation, radius ceil(3 sqrt(lambda_max)),
  pixel centres at integer coordinates, SH degree 0 colours clamped at 0
  after +0.5;
- compositing: a gaussian reaches the pixels of the 32^2 screen tiles its
  radius rect covers, front to back by view depth (index order on ties);
  ``alpha = min(0.99, opacity exp(-d^T conic d / 2))`` skipped when the
  exponent is positive or alpha < 1/255; a pixel stops before the first
  pair that would take its transmittance under 1e-4. The 0.99 clamp is
  straight-through in the gradient, as in the published backward.

Each pixel's list is composited densely (every pair of the pixel's tile at
once, in float32 with ``cumprod``), so nothing of the port's chunked
layout, culling or kernels is used. Imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814
TERM_EPS = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
TILE = 32
# Elements of the largest [tiles, pixels, pairs] block composited at once.
BLOCK_ELEMENTS = 1 << 26


def clamp_tie(x, lo=None, hi=None):
    """``min(max(x, lo), hi)`` with half the gradient at a tie (the port's
    and the JAX package's rule at a bound)."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype, device=x.device))
    return x


# ---------------------------------------------------------------------------
# Cameras (numpy, host side)
# ---------------------------------------------------------------------------


def _normalize(x, eps=1e-20):
    return x / np.sqrt(np.maximum(np.sum(x * x, axis=-1, keepdims=True), eps))


def orbit_pose(elevation: float, azimuth: float, radius: float) -> np.ndarray:
    """OpenGL camera-to-world pose [4, 4] looking at the origin; degrees."""
    el, az = math.radians(elevation), math.radians(azimuth)
    campos = np.array([radius * math.cos(el) * math.sin(az), -radius * math.sin(el),
                       radius * math.cos(el) * math.cos(az)], dtype=np.float32)
    forward = _normalize(campos - np.zeros(3, np.float32))
    right = _normalize(np.cross(np.array([0, 1, 0], np.float32), forward))
    up = _normalize(np.cross(forward, right))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([right, up, forward], axis=1)
    pose[:3, 3] = campos
    return pose


def camera_arrays(pose: np.ndarray, fovy: float, znear=0.01, zfar=100.0) -> dict:
    """GS camera of a pose (square frame, fovx = fovy in radians): view,
    full_proj, campos, tan of the half fovs."""
    w2c = np.linalg.inv(np.asarray(pose, np.float32))
    w2c[1:3, :3] *= -1
    w2c[:3, 3] *= -1
    t = math.tan(fovy / 2)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = proj[1, 1] = 1.0 / t
    proj[3, 2] = 1.0
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    return {"view": w2c.astype(np.float32), "full_proj": (proj @ w2c).astype(np.float32),
            "campos": (-np.asarray(pose, np.float32)[:3, 3]).copy(),
            "tanfov": np.array([t, t], np.float32)}


def ver_range(opt: dict, elevation: float) -> tuple:
    lo, hi = opt.get("min_ver", -30), opt.get("max_ver", 30)
    return (max(min(lo, lo - elevation), -80 - elevation),
            min(max(hi, hi - elevation), 80 - elevation))


def sample_orbit(rng: np.random.Generator, opt: dict, batch: int, n_views: int):
    """A stage-1 step's cameras from the run's numpy generator, in the
    trainers' call order: per batch entry an integer elevation offset in
    [min_ver, max_ver) and azimuth in [-180, 180); each becomes
    ``n_views`` poses at azimuth + 90 i. Returns (vers, hors, poses)."""
    elevation, radius = opt.get("elevation", 0.0), opt.get("radius", 2.0)
    lo, hi = ver_range(opt, elevation)
    vers, hors, poses = [], [], []
    for _ in range(batch):
        ver, hor = int(rng.integers(lo, hi)), int(rng.integers(-180, 180))
        vers.append(ver)
        hors.append(hor)
        poses += [orbit_pose(elevation + ver, hor + 90 * i, radius) for i in range(n_views)]
    return np.array(vers, np.float32), np.array(hors, np.float32), np.stack(poses)


# ---------------------------------------------------------------------------
# Projection (torch, differentiable)
# ---------------------------------------------------------------------------


class Projected(NamedTuple):
    mean2d: torch.Tensor   # [N, 2]
    depth: torch.Tensor    # [N]
    conic: torch.Tensor    # [N, 3]
    color: torch.Tensor    # [N, 3]
    opacity: torch.Tensor  # [N]
    radius: torch.Tensor   # [N] int32, 0 = not drawn


def rotation_entries(q):
    """Rows of the rotation matrix of unnormalised w-first quaternions."""
    q = q / torch.sqrt(torch.clamp_min((q * q).sum(-1, keepdim=True), 1e-12))
    w, x, y, z = q.unbind(-1)
    return (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y))


def project(params: dict, alive, cam: dict, size: int) -> Projected:
    """Project raw parameters (log-scales, opacity logits, SH degree 0)
    through one camera (``camera_arrays`` as tensors) at size^2."""
    xyz = params["xyz"]
    scale = torch.exp(params["scaling"])
    opacity = torch.sigmoid(params["opacity"][:, 0])
    view, full = cam["view"], cam["full_proj"]
    tanx, tany = cam["tanfov"][0], cam["tanfov"][1]
    focal_x, focal_y = size / (2.0 * tanx), size / (2.0 * tany)
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], 1)
    pv = hom @ view.T
    pc = hom @ full.T
    depth = pv[:, 2]
    p_w = 1.0 / (pc[:, 3] + 1e-7)
    mean2d = torch.stack([((pc[:, 0] * p_w + 1.0) * size - 1.0) * 0.5,
                          ((pc[:, 1] * p_w + 1.0) * size - 1.0) * 0.5], -1)
    r = torch.stack(rotation_entries(params["rotation"]), -1).reshape(-1, 3, 3)
    m = r * scale[:, None, :]
    cov3 = m @ m.transpose(1, 2)
    tx = clamp_tie(pv[:, 0] / depth, -1.3 * tanx, 1.3 * tanx) * depth
    ty = clamp_tie(pv[:, 1] / depth, -1.3 * tany, 1.3 * tany) * depth
    zeros = torch.zeros_like(depth)
    jac = torch.stack([
        torch.stack([focal_x / depth, zeros, -focal_x * tx / (depth * depth)], -1),
        torch.stack([zeros, focal_y / depth, -focal_y * ty / (depth * depth)], -1),
    ], 1)                                                      # [N, 2, 3]
    t = jac @ view[:3, :3]
    cov2 = t @ cov3 @ t.transpose(1, 2)
    cxx, cxy, cyy = cov2[:, 0, 0] + 0.3, cov2[:, 0, 1], cov2[:, 1, 1] + 0.3
    det = cxx * cyy - cxy * cxy
    ok = det != 0.0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([cyy * inv, -cxy * inv, cxx * inv], -1)
    with torch.no_grad():
        mid = 0.5 * (cxx + cyy)
        lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))
        radius = torch.where((depth > 0.2) & ok & alive, radius, 0.0).to(torch.int32)
    color = clamp_tie(SH_C0 * params["f_dc"][:, 0, :] + 0.5, 0.0)
    return Projected(mean2d, depth, conic, color, opacity, radius)


# ---------------------------------------------------------------------------
# Compositing
# ---------------------------------------------------------------------------


class TileLists(NamedTuple):
    """Per-tile lists in depth order: ids [T, L] (N where padded), count [T]."""
    ids: torch.Tensor
    count: torch.Tensor


@torch.no_grad()
def tile_lists(proj: Projected, size: int, tile: int = TILE) -> TileLists:
    """For every tile of the frame, the gaussians whose radius rect (in
    whole tiles, truncated as the published ``getRect`` does) covers it,
    in depth order."""
    n = proj.depth.shape[0]
    dev = proj.depth.device
    grid = size // tile
    valid = proj.radius > 0
    order = torch.sort(torch.where(valid, proj.depth, torch.full_like(proj.depth, math.inf)),
                       stable=True).indices
    r = proj.radius.float()
    mx, my = proj.mean2d[:, 0], proj.mean2d[:, 1]
    xmin = torch.clamp(((mx - r) / tile).to(torch.int32), 0, grid)
    ymin = torch.clamp(((my - r) / tile).to(torch.int32), 0, grid)
    xmax = torch.clamp(((mx + r + tile - 1) / tile).to(torch.int32), 0, grid)
    ymax = torch.clamp(((my + r + tile - 1) / tile).to(torch.int32), 0, grid)
    tid = torch.arange(grid * grid, device=dev)
    tx, ty = (tid % grid)[:, None], (tid // grid)[:, None]
    o = order[None, :]
    inside = ((xmin[o] <= tx) & (tx < xmax[o]) & (ymin[o] <= ty) & (ty < ymax[o])
              & valid[o])                                      # [T, N] in depth order
    count = inside.sum(1)
    width = max(int(count.max()), 1)
    pos = torch.sort((~inside).to(torch.int8), dim=1, stable=True).indices[:, :width]
    ids = torch.where(torch.arange(width, device=dev)[None] < count[:, None], order[pos], n)
    return TileLists(ids, count)


def composite_block(proj: Projected, ids, tiles, size: int, bg, tile: int = TILE):
    """Composite the tiles ``tiles`` [G] whose lists are ``ids`` [G, L]:
    (rgb on bg [G, P, 3], alpha [G, P], contributing pairs [G, P, L] bool,
    stopped pixels [G, P] bool)."""
    dev = ids.device
    grid = size // tile
    pad = lambda v, fill: torch.cat([v, torch.full_like(v[:1], fill)])  # noqa: E731
    mean = pad(proj.mean2d, 0.0)[ids]                          # [G, L, 2]
    conic = pad(proj.conic, 0.0)[ids]
    color = pad(proj.color, 0.0)[ids]
    opac = pad(proj.opacity, 0.0)[ids]
    pid = torch.arange(tile * tile, device=dev)
    px = ((tiles % grid) * tile)[:, None] + (pid % tile)[None]  # [G, P]
    py = ((tiles // grid) * tile)[:, None] + (pid // tile)[None]
    dx = px.float()[:, :, None] - mean[:, None, :, 0]          # [G, P, L]
    dy = py.float()[:, :, None] - mean[:, None, :, 1]
    a, b, c = (conic[:, None, :, k] for k in range(3))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    raw = opac[:, None, :] * torch.exp(power)
    keep = (power <= 0.0) & (raw >= ALPHA_MIN) & (ids < proj.depth.shape[0])[:, None, :]
    # min(0.99, raw), straight-through in the gradient.
    alpha = torch.where(keep, raw - (raw - ALPHA_MAX).clamp_min(0.0).detach(), 0.0)
    t_incl = torch.cumprod(1.0 - alpha, -1)
    contrib = keep & (t_incl.detach() >= TERM_EPS)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], -1)
    w = torch.where(contrib, alpha * t_excl, 0.0)
    rgb = torch.einsum("gpl,glc->gpc", w, color)
    t_final = torch.where(contrib, 1.0 - alpha, 1.0).prod(-1)
    stopped = (keep & (t_incl.detach() < TERM_EPS)).any(-1)
    return rgb + t_final[..., None] * bg, 1.0 - t_final, contrib, stopped


def _blocks(lists: TileLists):
    """Groups of tiles, longest lists first, each within BLOCK_ELEMENTS."""
    order = torch.argsort(lists.count, descending=True).tolist()
    counts = lists.count.tolist()
    group = []
    for t in order:
        width = max(counts[group[0]] if group else counts[t], 1)
        if group and (len(group) + 1) * TILE * TILE * width > BLOCK_ELEMENTS:
            yield group
            group = []
        group.append(t)
    if group:
        yield group


def _to_image(tiles, size, tile=TILE):
    """(rows, cols) [G, P] of the pixels of ``tiles`` in the frame."""
    grid = size // tile
    pid = torch.arange(tile * tile, device=tiles.device)
    ys = ((tiles // grid) * tile)[:, None] + (pid // tile)[None]
    xs = ((tiles % grid) * tile)[:, None] + (pid % tile)[None]
    return ys, xs


class Render:
    """One render of raw parameters, run in two passes so that the
    compositing never holds the autograd graph of the whole frame:
    ``__init__`` projects (keeping the graph) and composites without one;
    ``backward(g_image, g_alpha)`` composites again block by block with a
    graph, pulls the pixel gradients through, then through the projection.
    ``image`` [S, S, 3] (on the background, not clamped) and ``alpha``
    [S, S] are leaves the caller's loss reads. ``mean2d_grad`` after
    ``backward`` is the loss's gradient w.r.t. the pixel means."""

    def __init__(self, params: dict, alive, cam: dict, size: int, bg):
        self.size, self.bg = size, bg
        self.proj = project(params, alive, cam, size)
        self.leaf = Projected(*(t.detach().requires_grad_(t.is_floating_point())
                                for t in self.proj))
        self.lists = tile_lists(self.leaf, size)
        dev = bg.device
        image = torch.empty((size, size, 3), device=dev)
        alpha = torch.empty((size, size), device=dev)
        with torch.no_grad():
            for group in _blocks(self.lists):
                tiles = torch.tensor(group, device=dev)
                rgb, a, _, _ = composite_block(self.leaf, self.lists.ids[tiles], tiles, size, bg)
                ys, xs = _to_image(tiles, size)
                image[ys, xs] = rgb
                alpha[ys, xs] = a
        self.image = image.requires_grad_(True)
        self.alpha = alpha.requires_grad_(True)

    def backward(self):
        """Pull ``image.grad`` and ``alpha.grad`` back to the parameters."""
        g_img = self.image.grad if self.image.grad is not None else torch.zeros_like(self.image)
        g_a = self.alpha.grad if self.alpha.grad is not None else torch.zeros_like(self.alpha)
        dev = g_img.device
        for group in _blocks(self.lists):
            tiles = torch.tensor(group, device=dev)
            rgb, a, _, _ = composite_block(self.leaf, self.lists.ids[tiles], tiles, self.size,
                                           self.bg)
            ys, xs = _to_image(tiles, self.size)
            torch.autograd.backward([rgb, a], [g_img[ys, xs], g_a[ys, xs]])
        outs = [(p, l.grad) for p, l in zip(self.proj, self.leaf)
                if p.requires_grad and l.grad is not None]
        if outs:
            torch.autograd.backward([p for p, _ in outs], [g for _, g in outs])
        self.mean2d_grad = (self.leaf.mean2d.grad if self.leaf.mean2d.grad is not None
                            else torch.zeros_like(self.leaf.mean2d))


@torch.no_grad()
def pair_counts(params: dict, alive, cam: dict, size: int) -> dict:
    """The compositing work that one render of these inputs needs
    (``counts_of`` their projection)."""
    return counts_of(project(params, alive, cam, size), size)


@torch.no_grad()
def counts_of(proj: Projected, size: int) -> dict:
    """By the plain compositing above: contributing (gaussian, pixel) pairs,
    pixels that stop (each evaluates one pair past its contributors),
    (gaussian, tile) pairs with a contributor in the tile, and pixels."""
    lists = tile_lists(proj, size)
    bg = torch.zeros(3, device=proj.depth.device)
    contrib = stops = slots = 0
    for group in _blocks(lists):
        tiles = torch.tensor(group, device=bg.device)
        _, _, mask, stopped = composite_block(proj, lists.ids[tiles], tiles, size, bg)
        contrib += int(mask.sum())
        stops += int(stopped.sum())
        slots += int(mask.any(1).sum())
    return {"contributing_pairs": contrib, "stopping_pixels": stops,
            "feature_slots": slots, "pixels": size * size}
