"""Isosurface extraction from an occupancy grid (marching tetrahedra).

The port's own copy of ``dreamgaussian_tpu/meshing/marching_cubes.py``
(host numpy, same algorithm and the same output on the same field); it
stands in for ``mcubes.marching_cubes``. Implementation is marching *tetrahedra*: each cell of the grid is split
into 6 tetrahedra, and each tet contributes 0-2 triangles depending on
which corners are above the iso threshold. Compared to classic marching
cubes this needs no 256-case table, has no ambiguous configurations, and
vectorizes cleanly; it emits ~2x more triangles, which is irrelevant here
because the pipeline decimates to a face budget right after.

Vectorized numpy on host (runs once per export): active cells are
prefiltered by sign change, vertices are deduplicated by canonical grid
edge, and triangle winding is consistent (normals point toward the
low-density side, matching mcubes' convention of outward normals for
value>threshold interiors).
"""

from __future__ import annotations

import numpy as np

# Six-tetrahedra decomposition of the unit cube. Corner ids:
#   0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0)
#   4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
# All six tets share the main diagonal 0-6, so faces between tets match up
# and the output surface is watertight.
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int64,
)
_TETS = np.array(
    [
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
        [0, 5, 1, 6],
    ],
    dtype=np.int64,
)

# Per-tet case table, indexed by the 4-bit inside mask (bit i = corner i of
# the tet is inside, i.e. value > threshold). Each entry lists triangles as
# triples of tet-edge ids; edge ids index _TET_EDGES. The table is DERIVED
# at import time with an explicit geometric orientation check on a
# positively oriented reference tet — winding is a topological invariant
# under positive-determinant maps, so it transfers to every positive tet
# of the decomposition; negative tets get flipped at runtime.
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)


def _derive_cases():
    ref = np.array(
        [[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]
    )  # positive orientation: det[v1-v0, v2-v0, v3-v0] > 0
    edge_mid = {
        tuple(sorted((int(a), int(b)))): (ref[a] + ref[b]) / 2
        for a, b in _TET_EDGES
    }
    edge_id = {
        tuple(sorted((int(a), int(b)))): i
        for i, (a, b) in enumerate(_TET_EDGES)
    }

    def oriented(tri_corners, inside):
        """Order a triangle of edge keys so its normal points outward
        (away from the inside region)."""
        pts = [edge_mid[k] for k in tri_corners]
        n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
        inside_centroid = np.mean([ref[i] for i in inside], axis=0)
        outward = np.mean(pts, axis=0) - inside_centroid
        keys = tri_corners if np.dot(n, outward) > 0 else tri_corners[::-1]
        return tuple(edge_id[k] for k in keys)

    cases: list[list[tuple[int, int, int]]] = []
    for mask in range(16):
        inside = [i for i in range(4) if mask >> i & 1]
        outside = [i for i in range(4) if not (mask >> i & 1)]
        tris: list[tuple[int, int, int]] = []
        if len(inside) == 1:
            a = inside[0]
            keys = [tuple(sorted((a, b))) for b in outside]
            tris.append(oriented(keys, inside))
        elif len(inside) == 3:
            d = outside[0]
            keys = [tuple(sorted((d, b))) for b in inside]
            tris.append(oriented(keys, inside))
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            # Quad on edges (a,c), (a,d), (b,d), (b,c) — cyclic order.
            k = [
                tuple(sorted((a, c))),
                tuple(sorted((a, d))),
                tuple(sorted((b, d))),
                tuple(sorted((b, c))),
            ]
            tris.append(oriented([k[0], k[1], k[2]], inside))
            tris.append(oriented([k[0], k[2], k[3]], inside))
        cases.append(tris)
    tri = np.full((16, 2, 3), -1, dtype=np.int64)
    cnt = np.zeros(16, dtype=np.int64)
    for i, ts in enumerate(cases):
        cnt[i] = len(ts)
        for j, t in enumerate(ts):
            tri[i, j] = t
    return tri, cnt


_CASE_TRI, _CASE_CNT = _derive_cases()


def marching_cubes(
    occ: np.ndarray, threshold: float
) -> tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of ``occ`` at ``threshold``.

    Returns (vertices [V, 3] float64 in grid coordinates, triangles
    [F, 3] int64), same convention as ``mcubes.marching_cubes``.
    """
    occ = np.asarray(occ)
    rx, ry, rz = occ.shape
    inside = occ > threshold

    # Active cells: any corner differs from corner 0.
    c = inside[:-1, :-1, :-1]
    active = np.zeros_like(c)
    for dx, dy, dz in _CORNERS[1:]:
        active |= (
            inside[dx : rx - 1 + dx, dy : ry - 1 + dy, dz : rz - 1 + dz] != c
        )
    cells = np.argwhere(active)  # [C, 3]
    if cells.shape[0] == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    # Global grid-corner ids of each cell corner: [C, 8]
    corner_xyz = cells[:, None, :] + _CORNERS[None, :, :]  # [C, 8, 3]
    corner_id = (
        corner_xyz[..., 0] * (ry * rz)
        + corner_xyz[..., 1] * rz
        + corner_xyz[..., 2]
    )
    corner_val = occ.reshape(-1)[corner_id]  # [C, 8]
    corner_in = corner_val > threshold

    # Per (cell, tet): 4 corners, case id.
    tc = corner_id[:, _TETS]          # [C, 6, 4] global ids
    tv = corner_val[:, _TETS]         # [C, 6, 4]
    ti = corner_in[:, _TETS]          # [C, 6, 4]
    case = (
        ti[..., 0] * 1 + ti[..., 1] * 2 + ti[..., 2] * 4 + ti[..., 3] * 8
    ).astype(np.int64)                # [C, 6]

    n_tri = _CASE_CNT[case]           # [C, 6]
    tri_edges = _CASE_TRI[case]       # [C, 6, 2, 3] tet-edge ids (-1 pad)

    # Flatten all emitted triangles.
    flat_cnt = n_tri.reshape(-1)
    keep2 = np.repeat(np.arange(2)[None, :], flat_cnt.shape[0], axis=0) < (
        flat_cnt[:, None]
    )  # [CT, 2]
    tri_sel = tri_edges.reshape(-1, 2, 3)[keep2]  # [F, 3] tet-edge ids

    # Tet index per emitted triangle, to look up corner data.
    tet_flat = np.repeat(
        np.arange(flat_cnt.shape[0]), np.clip(flat_cnt, 0, 2)
    )
    tcf = tc.reshape(-1, 4)[tet_flat]  # [F, 4]
    tvf = tv.reshape(-1, 4)[tet_flat]  # [F, 4]

    # Orientation: the 6-tet decomposition alternates handedness; flip
    # triangles of negatively oriented tets for consistent winding.
    tet_of = np.tile(np.arange(6), case.shape[0])[
        np.repeat(np.arange(flat_cnt.shape[0]), np.clip(flat_cnt, 0, 2))
    ]
    # Signed volume sign of each tet in the decomposition (static per tet id).
    corner_pos = _CORNERS.astype(np.float64)
    vols = []
    for t in _TETS:
        a, b, cc, d = corner_pos[t]
        vols.append(np.linalg.det(np.stack([b - a, cc - a, d - a])))
    neg = np.asarray(vols)[tet_of] < 0

    # Edge endpoints (global corner ids) per triangle vertex: [F, 3, 2]
    e0 = _TET_EDGES[tri_sel][..., 0]
    e1 = _TET_EDGES[tri_sel][..., 1]
    g0 = np.take_along_axis(tcf, e0, axis=1)
    g1 = np.take_along_axis(tcf, e1, axis=1)
    v0 = np.take_along_axis(tvf, e0, axis=1)
    v1 = np.take_along_axis(tvf, e1, axis=1)

    # Canonical edge key (sorted endpoints) for dedup.
    lo = np.minimum(g0, g1)
    hi = np.maximum(g0, g1)
    key = lo * (rx * ry * rz) + hi
    uniq, first, inv = np.unique(
        key.reshape(-1), return_index=True, return_inverse=True
    )
    faces = inv.reshape(-1, 3)

    # Interpolated vertex positions for unique edges.
    gl = lo.reshape(-1)[first]
    gh = hi.reshape(-1)[first]
    vl = occ.reshape(-1)[gl]
    vh = occ.reshape(-1)[gh]
    t = (threshold - vl) / np.where(vh != vl, vh - vl, 1.0)
    t = np.clip(t, 0.0, 1.0)

    def unflat(g):
        x = g // (ry * rz)
        y = (g // rz) % ry
        z = g % rz
        return np.stack([x, y, z], axis=-1).astype(np.float64)

    verts = unflat(gl) + t[:, None] * (unflat(gh) - unflat(gl))

    # Fix winding: flip faces from negative tets.
    faces[neg] = faces[neg][:, ::-1]

    # Drop degenerate triangles (two vertices on the same edge).
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[ok]
