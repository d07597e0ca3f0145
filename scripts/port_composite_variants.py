"""Time the tile compositor's CUDA kernels (K1, K2) as shipped against their
build variants, on one NVIDIA card, all inside one process so that the
numbers compare.

    python3 scripts/port_composite_variants.py [--seed 0] [--trainer]
                                               [--only LABEL[,LABEL...]]

A variant is the port's ``csrc/composite_fwd.cu`` / ``composite_bwd.cu``
compiled with other flags: without multiply-add contraction, or without the
sift (``COMPOSITE_SIFT=0``, the one compile-time switch of the sources). Every
variant is first held against the plain PyTorch versions with
``chip_smoke.py``'s gates, then timed with CUDA events (20 launches after 2
warm-up), twice, in the order a, b, ..., b, a, and once as 20 launches
replayed from a CUDA graph (device time with no host work between the
launches). Scenes: ``chip_smoke.py``'s synthetic 512^2 scene, and a seeded
cloud shaped like the trainer's start (5,000 small gaussians in a ball of
radius 0.5, which fills the middle of the frame and leaves the border tiles
empty) at 128^2, 256^2 and 512^2; with ``--trainer`` also the trainer's own
cloud after ``chip_smoke.py``'s ladder, at the four shapes its step renders.
Prints one table, then the same as one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# label -> extra nvcc flags of both kernels; () is the design as shipped.
VARIANTS = {
    "shipped": (),
    "no contraction (--fmad=false)": ("--fmad=false",),
    "no sift (walk every gaussian)": ("-DCOMPOSITE_SIFT=0",),
}


def blob_cloud(seed: int, n: int = 5000):
    """Activated parameters of a cloud like the trainer's at its start."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    xyz = d / np.linalg.norm(d, axis=1, keepdims=True) * (0.5 * np.cbrt(rng.uniform(size=(n, 1))))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
    return (t(xyz), t(np.exp(rng.uniform(-4.6, -3.4, size=(n, 3)))), t(rng.normal(size=(n, 4))),
            t(rng.uniform(0.05, 0.6, size=n)), t(rng.normal(size=(n, 1, 3)) * 0.5))


def variant_fns(extra: tuple):
    """(forward, backward): the port's wrappers, loading the libraries built
    with ``extra`` flags."""
    from dreamgaussian_tpu_torch.ops import cuda_build
    from dreamgaussian_tpu_torch.ops import rasterize_cuda as rc

    load = cuda_build.load

    @contextlib.contextmanager
    def variant():
        cuda_build.load = lambda name, argtypes: load(name, argtypes, extra)
        try:
            yield
        finally:
            cuda_build.load = load

    def forward(*a, **k):
        with variant():
            return rc.composite_forward(*a, **k)

    def backward(*a, **k):
        with variant():
            return rc.composite_backward(*a, **k)

    return forward, backward


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None, help="comma-separated variant labels")
    ap.add_argument("--trainer", action="store_true",
                    help="also the trainer's cloud after chip_smoke.py's ladder, at its four shapes")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_composite_variants: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from dreamgaussian_tpu_torch.ops import cuda_build
    from dreamgaussian_tpu_torch.ops import rasterize_cuda as rc
    from dreamgaussian_tpu_torch.utils.camera import Camera, orbit_camera

    torch.backends.cuda.matmul.allow_tf32 = False
    variants = dict(VARIANTS)
    if args.only:
        variants = {k: variants[k] for k in args.only.split(",")}
    # One nvcc per library, all at once.
    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda extra: cuda_build.build(["composite_fwd", "composite_bwd"],
                                                     verbose=True, extra=extra),
                      variants.values()))

    fov = math.radians(49.1)
    scenes = [("synthetic 512^2", *chip_smoke.main_path_scene(args.seed))]
    cloud = blob_cloud(args.seed)
    for size in (128, 256, 512):
        cam = Camera.from_pose(orbit_camera(-15.0, 60.0, 2.0), size, size, fov, fov)
        scenes.append((f"blob {size}^2", *chip_smoke.bin_cloud(*cloud, cam, size)))

    if args.trainer:
        scenes += chip_smoke.trainer_shapes(chip_smoke.run_slice(args.seed)["trainer"])

    card = chip_smoke.card_line()
    table, failed = [], []
    for label, dup_feat, bins, geo in scenes:
        cs, nc = bins.chunk_starts, bins.n_chunks
        ref = rc.composite_forward_ref(dup_feat, cs, nc, **geo)
        g_out = torch.randn(ref.shape, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(args.seed))
        # K2 is held to its plain version in float64, as chip_smoke.py holds it.
        d_ref = rc.composite_backward_f64(dup_feat, cs, nc, ref, g_out, **geo)
        print(f"[scene] {label}: {int(bins.num_dups)} duplicates, {int(nc.sum())} chunks, "
              f"longest tile {int(nc.max())}, tiles with a list {int((nc > 0).sum())} of "
              f"{geo['num_tiles']}")
        fns = {name: variant_fns(extra) for name, extra in variants.items()}
        for name, (forward, backward) in fns.items():
            out = forward(dup_feat, cs, nc, **geo)
            err = float((out[:, :5] - ref[:, :5]).abs().max())
            mismatch = float((out[:, 5] != ref[:, 5]).float().mean())
            d_k = backward(dup_feat, cs, nc, ref, g_out, **geo)
            again = backward(dup_feat, cs, nc, ref, g_out, **geo)
            torch.cuda.synchronize()
            print(f"[check] {label} / {name}: K1 max abs err {err:.3e}, n_contrib mismatch "
                  f"{mismatch:.2e}")
            same_bits = torch.equal(d_k, again)
            rows_ok = chip_smoke.grad_rows_agree(d_k, d_ref, chip_smoke.K2_RTOL, chip_smoke.K2_ATOL)
            if not (err <= 1e-3 and mismatch <= 1e-3 and same_bits and rows_ok):
                failed.append(f"{name} on {label}: K1 err {err:.3e}, mismatch {mismatch:.2e}, "
                              f"K2 equal bits {same_bits}, rows agree {rows_ok}")
                print(f"[check] FAILED {failed[-1]}")
        order = list(fns) + list(reversed(fns))
        times: dict = {name: {"k1": [], "k2": []} for name in fns}
        for name in order:
            forward, backward = fns[name]
            times[name]["k1"].append(chip_smoke.cuda_ms(lambda: forward(dup_feat, cs, nc, **geo), 20))
            times[name]["k2"].append(
                chip_smoke.cuda_ms(lambda: backward(dup_feat, cs, nc, ref, g_out, **geo), 20))
        for name, t in times.items():
            forward, backward = fns[name]
            g1 = chip_smoke.graph_ms(lambda: forward(dup_feat, cs, nc, **geo))
            g2 = chip_smoke.graph_ms(lambda: backward(dup_feat, cs, nc, ref, g_out, **geo))
            table.append({"scene": label, "variant": name, "k1_ms": t["k1"], "k2_ms": t["k2"],
                          "k1_graph_ms": g1, "k2_graph_ms": g2})
            print(f"[time] {label} / {name}: K1 {t['k1'][0]:.4f} {t['k1'][1]:.4f} ms, "
                  f"K2 {t['k2'][0]:.4f} {t['k2'][1]:.4f} ms; in a CUDA graph K1 {g1:.4f}, "
                  f"K2 {g2:.4f} ms")
    print(json.dumps({"card": card, "rows": table}))
    print(card)
    if failed:
        print("variants that fail a gate:\n" + "\n".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
