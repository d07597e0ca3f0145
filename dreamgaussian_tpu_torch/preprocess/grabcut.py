"""GrabCut matting without weights, as ``cv2.grabCut(img, mask, rect, bgd,
fgd, 5, cv2.GC_INIT_WITH_RECT)`` and ``cv2.GaussianBlur(alpha, (5, 5), 0)``
compute it in ``dreamgaussian_tpu/cli/process.py``'s ``remove_background``
(OpenCV's ``modules/imgproc/src/grabcut.cpp``):

- the rect's pixels start as probable foreground, the rest as background;
- two GMMs (background, foreground) of 5 components, 13 float64 values
  each (weight, mean, 3x3 covariance), initialised by k-means++ (3 trials
  a centre) and OpenCV's Lloyd loop (at most 10 passes) on the float32
  colours; the draws come from a seeded ``torch.Generator`` (OpenCV draws
  from its thread RNG, so seeds are not compared);
- beta = 1 / (2 * the mean squared colour difference over the left,
  up-left, up and up-right neighbours); n-links gamma * exp(-beta * d^2),
  gamma = 50, the diagonals divided by sqrt(2);
- 5 iterations of: each pixel's most likely component; the GMMs learnt
  from those (0.01 added to a covariance's diagonal when its determinant
  is at most 1e-6); t-links -log of the other GMM's density, lambda = 9 *
  gamma for the fixed pixels; a max-flow/min-cut; the probable pixels
  relabelled by the side of the cut they fall on.

The per-pixel work (assignment, learning, t-links, the n-links once, the
blur) runs in torch float64 on the given device, the card by default. The
min-cut runs on the host: the Boykov-Kolmogorov max-flow of OpenCV's
``GCGraph`` in ``csrc/image_tools.cpp``, with one device-to-host copy of
the t-links per iteration. The blur is OpenCV's fixed-point 8-bit path:
with sigma 0 a 5-tap kernel is the binomial [1, 4, 6, 4, 1] / 16, rounded
once at the end, ``BORDER_REFLECT_101``; it equals cv2's bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import native, resolve_device

GC_BGD, GC_FGD, GC_PR_BGD, GC_PR_FGD = 0, 1, 2, 3
COMPONENTS = 5
GAMMA = 50.0
LAMBDA = 9 * GAMMA
ITERATIONS = 5
SEED = 0                    # of the k-means draws (a CPU generator: the same draws on any device)
KMEANS_PASSES = 10          # OpenCV's TermCriteria(MAX_ITER, 10)
PP_TRIALS = 3               # kmeans' SPP_TRIALS
KMEANS_EPS = float(np.finfo(np.float32).eps) ** 2
# gamma / std::sqrt(2.0f): the float square root of 2.
GAMMA_DIAGONAL = GAMMA / float(np.sqrt(np.float32(2.0)))


def min_cut(source_w: np.ndarray, sink_w: np.ndarray, src: np.ndarray, dst: np.ndarray,
            cap: np.ndarray, rev_cap: np.ndarray) -> tuple[np.ndarray, float]:
    """Max-flow/min-cut of a graph of ``len(source_w)`` vertices, vertex i
    joined to the source by ``source_w[i]`` and to the sink by
    ``sink_w[i]``, edge e from ``src[e]`` to ``dst[e]`` with capacity
    ``cap[e]`` and ``rev_cap[e]`` back (OpenCV's GCGraph, edges in the
    order given). Returns (bool [V]: the vertex lies on the source side,
    the flow's value)."""
    s = np.ascontiguousarray(source_w, np.float64)
    t = np.ascontiguousarray(sink_w, np.float64)
    i = np.ascontiguousarray(src, np.int32)
    j = np.ascontiguousarray(dst, np.int32)
    c = np.ascontiguousarray(cap, np.float64)
    r = np.ascontiguousarray(rev_cap, np.float64)
    n = len(s)
    if t.shape != (n,) or s.ndim != 1 or not (i.shape == j.shape == c.shape == r.shape) \
            or i.ndim != 1:
        raise ValueError("min_cut takes [V] terminal weights and [E] edges and capacities")
    if i.size and (min(i.min(), j.min()) < 0 or max(i.max(), j.max()) >= n or (i == j).any()):
        raise ValueError("an edge joins a vertex outside the graph or to itself")
    side = np.zeros(n, np.uint8)
    flow = np.zeros(1, np.float64)
    ret = native.image_tools().dg_maxflow(
        n, len(i), i.ctypes.data, j.ctypes.data, c.ctypes.data, r.ctypes.data, s.ctypes.data,
        t.ctypes.data, side.ctypes.data, flow.ctypes.data)
    if ret != 0:
        raise RuntimeError(f"max-flow failed with code {ret} (a path of no positive capacity)")
    return side.astype(bool), float(flow[0])


def _sq(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances of the rows of x to c, summed in order."""
    d = x - c
    return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]


def kmeans(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """Labels int64 [M] of float32 [M, 3] samples: OpenCV's ``kmeans`` with
    ``KMEANS_PP_CENTERS``, one attempt and ``TermCriteria(MAX_ITER, 10)``."""
    m = x.shape[0]
    # generateCentersPP: each next centre the best of 3 draws by D^2.
    first = int(torch.randint(m, (), generator=generator))
    dist = _sq(x, x[first])
    total = float(dist.double().sum())
    chosen = [first]
    for _ in range(1, k):
        cum = torch.cumsum(dist.double(), 0)
        best_sum, best, best_dist = math.inf, -1, None
        for _ in range(PP_TRIALS):
            p = float(torch.rand((), generator=generator, dtype=torch.float64)) * total
            i = min(int(torch.searchsorted(cum, torch.tensor([p], dtype=torch.float64,
                                                             device=x.device))), m - 1)
            trial = torch.minimum(_sq(x, x[i]), dist)
            s = float(trial.double().sum())
            if s < best_sum:
                best_sum, best, best_dist = s, i, trial
        if best < 0:
            raise RuntimeError("kmeans: cannot pick a centre (huge or NaN samples)")
        chosen.append(best)
        total, dist = best_sum, best_dist
    centres = x[chosen]

    def assign(c):
        return torch.stack([_sq(x, c[j]) for j in range(k)], 1).argmin(1)

    labels = assign(centres)
    xd = x.double()
    for it in range(1, KMEANS_PASSES):
        counts = torch.bincount(labels, minlength=k).tolist()
        sums = torch.zeros(k, 3, dtype=torch.float64, device=x.device).index_add_(0, labels, xd)
        for j in range(k):
            if counts[j]:
                continue
            # An empty cluster takes the farthest sample of the largest one.
            big = max(range(k), key=lambda q: (counts[q], -q))
            members = torch.nonzero(labels == big)[:, 0]
            d = _sq(x[members], (sums[big] / counts[big]).float())
            far = int(members[d.shape[0] - 1 - int(torch.flip(d, (0,)).argmax())])
            counts[big] -= 1
            counts[j] += 1
            labels[far] = j
            sums[big] -= xd[far]
            sums[j] += xd[far]
        new = (sums / torch.tensor(counts, dtype=torch.float64, device=x.device)[:, None]).float()
        shift = float(((new.double() - centres.double()) ** 2).sum(1).max())
        centres = new
        if it + 1 == KMEANS_PASSES or shift <= KMEANS_EPS:
            break                   # the last pass keeps its labels, as OpenCV's does
        labels = assign(centres)
    return labels


class GMM:
    """A GMM of ``COMPONENTS`` components: weights [K], means [K, 3],
    covariances [K, 3, 3] (float64), with the inverses and determinants."""

    def __init__(self, colors: torch.Tensor, comp: torch.Tensor):
        """Learnt from float64 [M, 3] colours and their components [M]
        (OpenCV's initLearning, addSample, endLearning)."""
        dev = colors.device
        n = torch.bincount(comp, minlength=COMPONENTS).double()
        zeros = torch.zeros(COMPONENTS, 12, dtype=torch.float64, device=dev)
        sums = zeros[:, :3].index_add_(0, comp, colors)
        prods = zeros[:, 3:].index_add_(
            0, comp, (colors[:, :, None] * colors[:, None, :]).reshape(-1, 9))
        present = n > 0
        inv_n = 1.0 / torch.where(present, n, torch.ones_like(n))
        self.weight = torch.where(present, n / n.sum(), torch.zeros_like(n))
        m = sums * inv_n[:, None]
        c = prods * inv_n[:, None] - (m[:, :, None] * m[:, None, :]).reshape(-1, 9)

        def det(c):
            return (c[:, 0] * (c[:, 4] * c[:, 8] - c[:, 5] * c[:, 7])
                    - c[:, 1] * (c[:, 3] * c[:, 8] - c[:, 5] * c[:, 6])
                    + c[:, 2] * (c[:, 3] * c[:, 7] - c[:, 4] * c[:, 6]))

        d = det(c)
        fix = (d <= 1e-6)[:, None] & torch.tensor([1, 0, 0, 0, 1, 0, 0, 0, 1], dtype=torch.bool,
                                                   device=dev)
        c = torch.where(fix, c + 0.01, c)       # calcInverseCovAndDeterm(ci, 0.01)
        d = torch.where(present, det(c), torch.ones_like(d))
        self.mean, self.cov, self.det, self.present = m, c, d, present
        inv = 1.0 / d
        # inverseCovs[ci][row][col], as OpenCV lays them out
        self.inv = torch.stack([
            (c[:, 4] * c[:, 8] - c[:, 5] * c[:, 7]) * inv,
            -(c[:, 1] * c[:, 8] - c[:, 2] * c[:, 7]) * inv,
            (c[:, 1] * c[:, 5] - c[:, 2] * c[:, 4]) * inv,
            -(c[:, 3] * c[:, 8] - c[:, 5] * c[:, 6]) * inv,
            (c[:, 0] * c[:, 8] - c[:, 2] * c[:, 6]) * inv,
            -(c[:, 0] * c[:, 5] - c[:, 2] * c[:, 3]) * inv,
            (c[:, 3] * c[:, 7] - c[:, 4] * c[:, 6]) * inv,
            -(c[:, 0] * c[:, 7] - c[:, 1] * c[:, 6]) * inv,
            (c[:, 0] * c[:, 4] - c[:, 1] * c[:, 3]) * inv], 1).reshape(-1, 3, 3)

    def check(self) -> None:
        """OpenCV's assertion that every used covariance is not singular."""
        if bool((self.present & (self.det <= np.finfo(np.float64).eps)).any()):
            raise RuntimeError("grabCut: a GMM component's covariance is singular")

    def densities(self, colors: torch.Tensor) -> torch.Tensor:
        """[N, K]: each component's density 1/sqrt(det) * exp(-mult/2) at
        float64 [N, 3] colours, 0 for a component of no weight."""
        out = []
        for k in range(COMPONENTS):
            d = colors - self.mean[k]
            i = self.inv[k]
            mult = (d[:, 0] * (d[:, 0] * i[0, 0] + d[:, 1] * i[1, 0] + d[:, 2] * i[2, 0])
                    + d[:, 1] * (d[:, 0] * i[0, 1] + d[:, 1] * i[1, 1] + d[:, 2] * i[2, 1])
                    + d[:, 2] * (d[:, 0] * i[0, 2] + d[:, 1] * i[1, 2] + d[:, 2] * i[2, 2]))
            p = 1.0 / torch.sqrt(self.det[k]) * torch.exp(-0.5 * mult)
            out.append(torch.where(self.present[k], p, torch.zeros_like(p)))
        return torch.stack(out, 1)

    def total(self, dens: torch.Tensor) -> torch.Tensor:
        """The mixture's density from ``densities``, summed in component order."""
        res = torch.zeros_like(dens[:, 0])
        for k in range(COMPONENTS):
            res = res + self.weight[k] * dens[:, k]
        return res


def _neighbour_edges(h: int, w: int, planes: np.ndarray):
    """(src, dst, weight) of the 8-neighbourhood's edges in OpenCV's
    constructGCGraph order: per pixel in raster order, its left, up-left,
    up and up-right neighbour. planes: float64 [4, H, W] in that order."""
    y, x = np.mgrid[0:h, 0:w]
    idx = (y * w + x).reshape(-1)
    offsets = (-1, -w - 1, -w, -w + 1)
    valid = np.stack([x > 0, (x > 0) & (y > 0), y > 0, (x < w - 1) & (y > 0)]).reshape(4, -1)
    src = np.broadcast_to(idx, (4, idx.size)).T
    dst = (idx[None, :] + np.array(offsets)[:, None]).T
    keep = valid.T
    return (src[keep].astype(np.int32), dst[keep].astype(np.int32),
            planes.reshape(4, -1).T[keep])


def _n_links(img: torch.Tensor) -> torch.Tensor:
    """float64 [4, H, W] n-link weights (left, up-left, up, up-right) of
    float64 [H, W, 3] colours (calcBeta, calcNWeights)."""
    h, w = img.shape[:2]

    def sq(a, b):
        d = a - b
        return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]

    diffs = [sq(img[:, 1:], img[:, :-1]), sq(img[1:, 1:], img[:-1, :-1]),
             sq(img[1:, :], img[:-1, :]), sq(img[1:, :-1], img[:-1, 1:])]
    total = float(sum(d.sum() for d in diffs))          # integers: exact in any order
    if total <= np.finfo(np.float64).eps:
        beta = 0.0
    else:
        beta = 1.0 / (2 * total / (4 * w * h - 3 * w - 3 * h + 2))
    planes = torch.zeros(4, h, w, dtype=torch.float64, device=img.device)
    planes[0, :, 1:] = GAMMA * torch.exp(-beta * diffs[0])
    planes[1, 1:, 1:] = GAMMA_DIAGONAL * torch.exp(-beta * diffs[1])
    planes[2, 1:, :] = GAMMA * torch.exp(-beta * diffs[2])
    planes[3, 1:, :-1] = GAMMA_DIAGONAL * torch.exp(-beta * diffs[3])
    return planes


def grabcut(rgb: np.ndarray, rect: tuple[int, int, int, int], device="cuda") -> torch.Tensor:
    """uint8 [H, W] mask of OpenCV's labels (GC_BGD, GC_FGD, GC_PR_BGD,
    GC_PR_FGD) on ``device`` after ``ITERATIONS`` of GrabCut on the uint8
    [H, W, 3] image, started from ``rect`` = (x, y, width, height)."""
    dev = resolve_device(device)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("grabcut takes a uint8 [H, W, 3] image")
    h, w = rgb.shape[:2]
    img = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev).double()
    colors = img.reshape(-1, 3)
    x0, y0 = max(0, rect[0]), max(0, rect[1])
    x1, y1 = x0 + min(rect[2], w - x0), y0 + min(rect[3], h - y0)
    mask = torch.full((h, w), GC_BGD, dtype=torch.uint8, device=dev)
    mask[y0:max(y0, y1), x0:max(x0, x1)] = GC_PR_FGD
    gen = torch.Generator().manual_seed(SEED)

    # initGMMs: k-means of each side's float32 colours.
    back = ((mask == GC_BGD) | (mask == GC_PR_BGD)).reshape(-1)
    gmms = []
    for side in (back, ~back):
        samples = colors[side]
        if samples.shape[0] == 0:
            raise ValueError("grabcut: the rect leaves no background or no foreground pixel")
        labels = kmeans(samples.float(), min(COMPONENTS, samples.shape[0]), gen)
        gmms.append(GMM(samples, labels))

    src, dst, weight = _neighbour_edges(h, w, _n_links(img).cpu().numpy())   # copied once
    for _ in range(ITERATIONS):
        back = ((mask == GC_BGD) | (mask == GC_PR_BGD)).reshape(-1)
        dens = [g.densities(colors) for g in gmms]
        comp = torch.where(back, dens[0].argmax(1), dens[1].argmax(1))   # whichComponent
        gmms = [GMM(colors[side], comp[side]) for side in (back, ~back)]  # learnGMMs
        for g in gmms:
            g.check()
        flat = mask.reshape(-1)
        probable = (flat == GC_PR_BGD) | (flat == GC_PR_FGD)
        to_source = torch.where(probable, -torch.log(gmms[0].total(gmms[0].densities(colors))),
                                torch.where(flat == GC_BGD, 0.0, LAMBDA))
        to_sink = torch.where(probable, -torch.log(gmms[1].total(gmms[1].densities(colors))),
                              torch.where(flat == GC_BGD, LAMBDA, 0.0))
        t_links = torch.stack([to_source, to_sink]).cpu().numpy()        # one copy to the host
        fore, _ = min_cut(t_links[0], t_links[1], src, dst, weight, weight)
        fore = torch.from_numpy(fore).to(dev)
        flat = torch.where(probable, torch.where(fore, GC_PR_FGD, GC_PR_BGD).to(torch.uint8), flat)
        mask = flat.reshape(h, w)
    return mask


def _reflect101(n: int, pad: int) -> np.ndarray:
    """OpenCV's borderInterpolate(i, n, BORDER_REFLECT_101) for i in
    [-pad, n + pad)."""
    out = []
    for i in range(-pad, n + pad):
        if n == 1:
            out.append(0)
            continue
        while i < 0 or i >= n:
            i = -i if i < 0 else 2 * n - 2 - i
        out.append(i)
    return np.array(out)


def gaussian_blur5(a: torch.Tensor) -> torch.Tensor:
    """``cv2.GaussianBlur(a, (5, 5), 0)`` of a uint8 [H, W] tensor, bit for
    bit: the binomial kernel [1, 4, 6, 4, 1] / 16 both ways in integers,
    one rounding of the sum / 256, ``BORDER_REFLECT_101``."""
    h, w = a.shape
    rows = torch.from_numpy(_reflect101(h, 2)).to(a.device)
    cols = torch.from_numpy(_reflect101(w, 2)).to(a.device)
    x = a.to(torch.int32)[rows][:, cols]
    k = (1, 4, 6, 4, 1)
    t = sum(k[i] * x[:, i:i + w] for i in range(5))
    s = sum(k[i] * t[i:i + h] for i in range(5))
    return ((s + 128) >> 8).to(torch.uint8)


def grabcut_alpha(rgb: np.ndarray, device="cuda") -> np.ndarray:
    """uint8 [H, W] alpha of the JAX ``remove_background`` without U2Net
    weights: GrabCut on a rect inset by max(4, min(H, W) // 20), 5
    iterations, foreground 255, then the 5x5 blur."""
    h, w = rgb.shape[:2]
    margin = max(4, min(h, w) // 20)
    mask = grabcut(rgb, (margin, margin, w - 2 * margin, h - 2 * margin), device)
    fore = (mask == GC_FGD) | (mask == GC_PR_FGD)
    alpha = torch.where(fore, 255, 0).to(torch.uint8)
    return gaussian_blur5(alpha).cpu().numpy()
