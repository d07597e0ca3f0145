"""Plain PyTorch mesh rendering of stage 2, the benchmark's reference.

The rules follow the port's published description of its renderer
(``render/mesh_renderer.py``, ``ops/mesh_raster.py``), which stand in for
nvdiffrast's ``rasterize``, ``interpolate``, ``texture`` and
``antialias``:

- visibility: per pixel centre (pixel i at ndc (2i + 1) / size - 1) the
  covering triangle (edge functions of either winding, a centre on an edge
  inside, zero-area triangles and triangles with a vertex at w <= 1e-6
  left out) of least screen-affine NDC depth ``z = sum (e_i / area) z_i``;
  equal depth goes to the larger face index. This is computed densely over
  the triangles whose bounding box meets each 32^2 tile, without the
  port's chunked lists or its kernel;
- shading: perspective-correct barycentrics re-derived at the winner
  (differentiable), normals and depth interpolated, the albedo logits
  sampled trilinearly over a 2x2-mean mip chain (LOD the log2 of the larger
  screen footprint in texels, from the barycentrics one pixel right and
  down), the sigmoid after, the analytic silhouette antialias of adjacent
  pixel pairs, the background blended by coverage, then the antialiased
  bilinear resize from the SSAA size and a clamp to [0, 1].

The shading and antialias arithmetic is a copy of the port's plain torch
code as the benchmark was defined; the visibility is the benchmark's own.
Imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .render import BLOCK_ELEMENTS, clamp_tie

TILE = 32


class Rast(NamedTuple):
    tri_id: torch.Tensor    # [H, W] int64, 0 = miss, else face index + 1
    bary: torch.Tensor      # [H, W, 3]
    zbuf: torch.Tensor      # [H, W]
    mask: torch.Tensor      # [H, W] bool
    bary_dx: torch.Tensor
    bary_dy: torch.Tensor


def screen_coords(v_clip, width: int, height: int):
    w = v_clip[:, 3:4]
    ndc = v_clip[:, :3] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))
    sizes = torch.tensor([width, height], dtype=v_clip.dtype, device=v_clip.device)
    return ((ndc[:, :2] + 1.0) * sizes - 1.0) * 0.5, ndc[:, 2], w[:, 0]


def tile_faces(tv, ok, width: int, height: int, tile: int = TILE):
    """Per 32^2 tile, the faces whose pixel bounding box meets it, in index
    order: (ids [T, L] with F as padding, count [T])."""
    nf = tv.shape[0]
    gx, gy = width // tile, height // tile
    lo = torch.floor(tv.amin(1) / tile)
    hi = torch.floor(tv.amax(1) / tile)
    tid = torch.arange(gx * gy, device=tv.device)
    tx, ty = (tid % gx)[:, None].float(), (tid // gx)[:, None].float()
    hit = ((lo[None, :, 0] <= tx) & (tx <= hi[None, :, 0]) & (lo[None, :, 1] <= ty)
           & (ty <= hi[None, :, 1]) & ok[None])                       # [T, F]
    count = hit.sum(1)
    width_l = max(int(count.max()), 1)
    pos = torch.sort((~hit).to(torch.int8), dim=1, stable=True).indices[:, :width_l]
    ids = torch.where(torch.arange(width_l, device=tv.device)[None] < count[:, None], pos, nf)
    return ids, count


@torch.no_grad()
def visibility(v_clip, faces, width: int, height: int, tile: int = TILE):
    """(tri_id [H, W] face + 1 or 0, z [H, W]) and the per-tile box counts
    (for the work the z-test needs): box pairs, covering pairs, slots."""
    xy, z_ndc, w = screen_coords(v_clip, width, height)
    nf = faces.shape[0]
    tv, tz = xy[faces], z_ndc[faces]
    ok = (w[faces] > 1e-6).all(1)
    ids, count = tile_faces(tv, ok, width, height, tile)
    gx = width // tile
    tri_id = torch.zeros((height, width), dtype=torch.int64, device=v_clip.device)
    zbuf = torch.zeros((height, width), device=v_clip.device)
    work = {"box_pairs": 0, "cover_pairs": 0, "slots": 0, "pixels": width * height}
    tvp = torch.cat([tv, torch.zeros_like(tv[:1])])
    tzp = torch.cat([tz, torch.zeros_like(tz[:1])])
    pid = torch.arange(tile * tile, device=v_clip.device)
    order = torch.argsort(count, descending=True).tolist()
    counts = count.tolist()
    start = 0
    while start < len(order):
        per = max(1, BLOCK_ELEMENTS // (tile * tile * max(counts[order[start]], 1)))
        group = torch.tensor(order[start:start + per], device=v_clip.device)
        start += per
        gid = ids[group]                                           # [G, L]
        px = ((group % gx) * tile)[:, None] + (pid % tile)[None]
        py = ((group // gx) * tile)[:, None] + (pid // tile)[None]
        px, py = px.float()[:, :, None], py.float()[:, :, None]     # [G, P, 1]
        p = tvp[gid][:, None]                                      # [G, 1, L, 3, 2]
        x0, y0, x1, y1 = p[..., 0, 0], p[..., 0, 1], p[..., 1, 0], p[..., 1, 1]
        x2, y2 = p[..., 2, 0], p[..., 2, 1]
        e0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
        e1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
        e2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        inside = torch.where(area > 0.0, torch.minimum(torch.minimum(e0, e1), e2),
                             -torch.maximum(torch.maximum(e0, e1), e2))
        real = (gid < nf)[:, None]
        valid = (inside >= 0.0) & (area != 0.0) & real
        inv = 1.0 / torch.where(area != 0.0, area, torch.ones_like(area))
        zf = tzp[gid][:, None]
        z = (e0 * inv) * zf[..., 0] + (e1 * inv) * zf[..., 1] + (e2 * inv) * zf[..., 2]
        zc = torch.where(valid, z, math.inf)
        zmin = zc.amin(-1, keepdim=True)
        best = torch.where((zc <= zmin) & valid, gid[:, None] + 1, 0).amax(-1)
        ys, xs = py[..., 0].long(), px[..., 0].long()
        tri_id[ys, xs] = best
        zbuf[ys, xs] = torch.where(best > 0, zmin[..., 0], 0.0)
        bx = ((px >= torch.minimum(torch.minimum(x0, x1), x2))
              & (px <= torch.maximum(torch.maximum(x0, x1), x2))
              & (py >= torch.minimum(torch.minimum(y0, y1), y2))
              & (py <= torch.maximum(torch.maximum(y0, y1), y2)) & real)
        work["box_pairs"] += int(bx.sum())
        work["cover_pairs"] += int(valid.sum())
        work["slots"] += int(bx.any(1).sum())
    return tri_id, zbuf, work


def rasterize(v_clip, faces, width: int, height: int) -> tuple:
    tri_id, zbuf, work = visibility(v_clip, faces, width, height)
    mask = tri_id > 0
    xy, _, w_clip = screen_coords(v_clip, width, height)
    nf = faces.shape[0]
    fidx = torch.clamp(tri_id - 1, 0, nf - 1)
    fa = torch.cat([xy, w_clip[:, None]], 1)[faces][fidx]          # [H, W, 3, 3]
    p, pw = fa[..., :2], fa[..., 2]
    pxx = torch.arange(width, dtype=torch.float32, device=v_clip.device)[None, :]
    pyy = torch.arange(height, dtype=torch.float32, device=v_clip.device)[:, None]
    x0, y0, x1, y1, x2, y2 = (p[..., 0, 0], p[..., 0, 1], p[..., 1, 0], p[..., 1, 1],
                              p[..., 2, 0], p[..., 2, 1])

    def bary_at(qx, qy):
        e0 = (x2 - x1) * (qy - y1) - (y2 - y1) * (qx - x1)
        e1 = (x0 - x2) * (qy - y2) - (y0 - y2) * (qx - x2)
        e2 = (x1 - x0) * (qy - y0) - (y1 - y0) * (qx - x0)
        area = e0 + e1 + e2
        inv_area = 1.0 / torch.where(area.abs() > 1e-12, area, torch.full_like(area, 1e-12))
        b = torch.stack([e0, e1, e2], -1) * inv_area[..., None]
        pc = b / clamp_tie(pw, 1e-12)
        pc = pc / clamp_tie(pc.sum(-1, keepdim=True), 1e-12)
        return torch.where(mask[..., None], pc, torch.zeros_like(pc))

    bary = bary_at(pxx, pyy)
    with torch.no_grad():
        bdx = bary_at(pxx + 1.0, pyy) - bary
        bdy = bary_at(pxx, pyy + 1.0) - bary
    return Rast(tri_id, bary, torch.where(mask, zbuf, 0.0), mask, bdx, bdy), work


def interpolate(attrs, faces, rast: Rast, derivs: bool = False):
    nf = faces.shape[0]
    a = attrs[faces][torch.clamp(rast.tri_id - 1, 0, nf - 1)]      # [H, W, 3, A]
    m = rast.mask[..., None]
    out = torch.where(m, (a * rast.bary[..., None]).sum(-2), 0.0)
    if not derivs:
        return out
    return (out, torch.where(m, (a * rast.bary_dx[..., None]).sum(-2), 0.0),
            torch.where(m, (a * rast.bary_dy[..., None]).sum(-2), 0.0))


def mip_chain(tex, min_size: int = 4) -> list:
    chain = [tex]
    while min(chain[-1].shape[0], chain[-1].shape[1]) > min_size:
        t = chain[-1]
        h2, w2 = t.shape[0] // 2, t.shape[1] // 2
        chain.append(t[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, -1).mean((1, 3)))
    return chain


def _bilinear(flat, x, y, lw, lh, offset):
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1 = torch.minimum(x0 + 1, lw - 1)
    y1 = torch.minimum(y0 + 1, lh - 1)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    tap = lambda i: flat[i.reshape(-1)].reshape(i.shape + flat.shape[1:])  # noqa: E731
    return (tap(offset + y0 * lw + x0) * (1 - fx) * (1 - fy) + tap(offset + y0 * lw + x1) * fx * (1 - fy)
            + tap(offset + y1 * lw + x0) * (1 - fx) * fy + tap(offset + y1 * lw + x1) * fx * fy)


def sample_mip(chain: list, uv, uv_dx, uv_dy):
    th, tw = chain[0].shape[0], chain[0].shape[1]
    n = len(chain)
    dev = uv.device
    sizes = torch.tensor([tw, th], dtype=torch.float32, device=dev)
    rho = torch.maximum(torch.linalg.vector_norm(uv_dx * sizes, dim=-1),
                        torch.linalg.vector_norm(uv_dy * sizes, dim=-1))
    lod = clamp_tie(torch.log2(clamp_tie(rho, 1e-12)), 0.0, n - 1.0)
    c = chain[0].shape[-1]
    flat = torch.cat([t.reshape(-1, c) for t in chain])
    table = lambda vals: torch.tensor(vals, dtype=torch.int64, device=dev)  # noqa: E731
    offs = table([0] + [int(sum(t.shape[0] * t.shape[1] for t in chain[:i])) for i in range(1, n)])
    ths, tws = table([t.shape[0] for t in chain]), table([t.shape[1] for t in chain])
    l0 = torch.floor(lod).long()
    l1 = torch.clamp(l0 + 1, max=n - 1)
    frac = (lod - l0.float())[..., None]
    u, v = clamp_tie(uv[..., 0], 0.0, 1.0), clamp_tie(uv[..., 1], 0.0, 1.0)

    def level(li):
        lw, lh = tws[li], ths[li]
        return _bilinear(flat, u * (lw - 1).float(), v * (lh - 1).float(), lw, lh, offs[li])

    return level(l0) * (1 - frac) + level(l1) * frac


def _aa_axis(color, rast: Rast, xy, faces, horizontal: bool, z_eps: float):
    tri_id, zbuf, mask = rast.tri_id, rast.zbuf, rast.mask
    h, w = tri_id.shape
    nf = faces.shape[0]
    if horizontal:
        sl_a, sl_b = (slice(None), slice(0, w - 1)), (slice(None), slice(1, None))
    else:
        sl_a, sl_b = (slice(0, h - 1), slice(None)), (slice(1, None), slice(None))
    id_a, id_b, m_a, m_b = tri_id[sl_a], tri_id[sl_b], mask[sl_a], mask[sl_b]
    z_a = torch.where(m_a, zbuf[sl_a], math.inf)
    z_b = torch.where(m_b, zbuf[sl_b], math.inf)
    pair = (id_a != id_b) & ((~m_a) | (~m_b) | ((z_a - z_b).abs() > z_eps))
    win_a = z_a <= z_b
    wid = torch.where(win_a, id_a, id_b)
    p = xy[faces[torch.clamp(wid - 1, 0, nf - 1)]]                 # [h', w', 3, 2]
    ys, xs = torch.meshgrid(torch.arange(id_a.shape[0], dtype=torch.float32, device=xy.device),
                            torch.arange(id_a.shape[1], dtype=torch.float32, device=xy.device),
                            indexing="ij")
    off = win_a.logical_not().float()
    if horizontal:
        qwx, qwy, qlx, qly = xs + off, ys, xs + (1.0 - off), ys
    else:
        qwx, qwy, qlx, qly = xs, ys + off, xs, ys + (1.0 - off)

    def edges(qx, qy):
        e = torch.stack([(p[..., i2, 0] - p[..., i1, 0]) * (qy - p[..., i1, 1])
                         - (p[..., i2, 1] - p[..., i1, 1]) * (qx - p[..., i1, 0])
                         for i1, i2 in ((1, 2), (2, 0), (0, 1))], -1)
        return e * torch.where(e.sum(-1, keepdim=True) >= 0, 1.0, -1.0)

    dxy = (p[..., (2, 0, 1), :] - p[..., (1, 2, 0), :]).abs()
    owned = dxy[..., 1] >= dxy[..., 0] if horizontal else dxy[..., 0] > dxy[..., 1]
    e_w, e_l = edges(qwx, qwy), edges(qlx, qly)
    crossing = (e_w >= 0) & (e_l < 0) & owned
    t_i = e_w / clamp_tie(e_w - e_l, 1e-12)
    t = torch.where(crossing, t_i, torch.full_like(t_i, 2.0)).amin(-1)
    has = crossing.any(-1) & pair
    t = clamp_tie(torch.where(has, t, torch.full_like(t, 0.5)), 0.0, 1.0)
    c_a, c_b = color[sl_a], color[sl_b]
    wa = win_a[..., None]
    c_w, c_l = torch.where(wa, c_a, c_b), torch.where(wa, c_b, c_a)
    adj_w = clamp_tie(0.5 - t, 0.0)[..., None] * (c_l - c_w)
    adj_l = clamp_tie(t - 0.5, 0.0)[..., None] * (c_w - c_l)
    adj_a, adj_b = torch.where(wa, adj_w, adj_l), torch.where(wa, adj_l, adj_w)
    if horizontal:
        return F.pad(adj_a, (0, 0, 0, 1)) + F.pad(adj_b, (0, 0, 1, 0))
    return F.pad(adj_a, (0, 0, 0, 0, 0, 1)) + F.pad(adj_b, (0, 0, 0, 0, 1, 0))


def antialias(color, rast: Rast, v_clip, faces, width: int, height: int, z_eps: float = 1e-3):
    xy, _, _ = screen_coords(v_clip, width, height)
    return (color + _aa_axis(color, rast, xy, faces, True, z_eps)
            + _aa_axis(color, rast, xy, faces, False, z_eps))


def scale_img(img, h: int, w: int):
    """Bilinear resize of [..., H, W, C] with the widened triangle filter
    when shrinking."""
    lead, (hi, wi, c) = img.shape[:-3], img.shape[-3:]
    x = img.reshape(-1, hi, wi, c).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).reshape(*lead, h, w, c)


def trunc_rev_sigmoid(x, eps: float = 1e-6):
    x = clamp_tie(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def safe_normalize(x, eps: float = 1e-20):
    return x * torch.rsqrt(clamp_tie((x * x).sum(-1, keepdim=True), eps))


def ssaa_side(size: int, ssaa: float, tile: int = TILE) -> int:
    return size if ssaa == 1 else int(math.ceil(size * ssaa / tile) * tile)


def render(mesh: dict, raw_albedo, cam: dict, pose_rot, size: int, ssaa: float,
           work: list | None = None) -> dict:
    """One render of the mesh (v, f, vn, vt, ft tensors) with the albedo
    logits ``raw_albedo`` through a GS camera (view, full_proj) at size^2
    after rendering at the SSAA side; ``work`` collects the z-test's
    counts."""
    s = ssaa_side(size, ssaa)
    v, f = mesh["v"], mesh["f"]
    v_h = torch.cat([v, torch.ones_like(v[:, :1])], 1)
    v_clip = v_h @ cam["full_proj"].T
    v_cam_z = (v_h @ cam["view"].T)[:, 2:3]
    rast, counts = rasterize(v_clip, f, s, s)
    if work is not None:
        work.append(counts)
    alpha = rast.mask.float()[..., None]
    dn = interpolate(torch.cat([v_cam_z, mesh["vn"]], 1), f, rast)
    texc, texc_dx, texc_dy = interpolate(mesh["vt"], mesh["ft"], rast, derivs=True)
    albedo = torch.sigmoid(sample_mip(mip_chain(raw_albedo), texc, texc_dx, texc_dy))
    normal = safe_normalize(dn[..., 1:4])
    viewcos = (normal @ pose_rot)[..., 2:3]
    albedo = antialias(albedo, rast, v_clip, f, s, s)
    image = alpha * albedo + (1.0 - alpha)
    if s != size:
        image, alpha, viewcos = (scale_img(x, size, size) for x in (image, alpha, viewcos))
    return {"image": clamp_tie(image, 0.0, 1.0), "alpha": alpha, "viewcos": viewcos}
