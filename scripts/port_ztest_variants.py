"""Time the triangle z-test kernel (K3) as shipped against its alternatives,
on one NVIDIA card, all inside one process so that the numbers compare.

    python3 scripts/port_ztest_variants.py [--seed 0] [--views 9,21]

The variants: the port's ``csrc/ztest.cu`` as shipped (a warp per 8x4
patch walks the triangles that its exact per-edge sift lets through); the
same built with ``-DZTEST_SIFT=0`` (every valid slot walked); and the
triangle-major design of ``scripts/ztest_triangle_major.cu`` (a thread per
slot folds its covering pixels into per-pixel keys with a 64-bit atomic
min). The input is ``chip_smoke.py``'s export (a seeded 16384-gaussian
cloud through ``export_textured_mesh`` at ``configs/image.yaml``'s sizes)
under each bake camera at the bake's shape (512^2, tile 32, chunk 128), and
under view 9 the same launch with every list empty. Every variant is first
held to the plain version's bits (ids and z) at every view, then timed with
CUDA events (20 launches after 2 warm-up) in the order a, b, c, c, b, a, and
once as 20 launches replayed from a CUDA graph. Prints one line per view and
variant, the sums over the views, then one JSON line; exits 1 if a variant
gives other bits.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TRI_MAJOR_SOURCE = ROOT / "scripts" / "ztest_triangle_major.cu"


def build_tri_major():
    """nvcc the triangle-major library with K3's flags; start it and return
    a function that waits for it and loads it."""
    from dreamgaussian_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = cuda_build.BUILD_DIR / f"ztest_tri_major-{os.getpid()}.so"
    proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.flags_for("ztest"), "-o", str(so),
                             str(TRI_MAJOR_SOURCE)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def wait():
        log, _ = proc.communicate()
        print(f"[build] {TRI_MAJOR_SOURCE.name}\n{log.strip()}")
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for the triangle-major kernel")
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        # feat, k_total, chunk_starts, n_chunks, out_id, out_z, num_tiles,
        # grid_x, chunk, tile, stream, blocks_launched
        lib.ztest_tri_major.argtypes = [p, ctypes.c_longlong, p, p, p, p, i, i, i, i, p,
                                        ctypes.POINTER(i)]
        lib.ztest_tri_major.restype = i
        return lib
    return wait


def tri_major_fn(lib):
    import torch

    def run(dup_feat, chunk_starts, n_chunks, *, grid_x, num_tiles, chunk, tile):
        pix = tile * tile
        out_id = torch.empty((num_tiles, pix), dtype=torch.int32, device=dup_feat.device)
        out_z = torch.empty((num_tiles, pix), dtype=torch.float32, device=dup_feat.device)
        blocks = ctypes.c_int(0)
        rc = lib.ztest_tri_major(dup_feat.data_ptr(), dup_feat.shape[1], chunk_starts.data_ptr(),
                                 n_chunks.data_ptr(), out_id.data_ptr(), out_z.data_ptr(),
                                 num_tiles, grid_x, chunk, tile,
                                 torch.cuda.current_stream().cuda_stream, ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"triangle-major launch failed with CUDA error {rc}")
        return out_id, out_z
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--views", default=None, help="comma-separated bake views (default: all 26)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_ztest_variants: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from dreamgaussian_tpu_torch import native
    from dreamgaussian_tpu_torch.meshing.export import BAKE_VERS
    from dreamgaussian_tpu_torch.ops import cuda_build
    from dreamgaussian_tpu_torch.ops import mesh_raster_cuda as mr

    t0 = time.perf_counter()
    wait_tri_major = build_tri_major()   # its nvcc runs while the others build
    cuda_build.build(["composite_fwd", "composite_bwd", "ztest"], verbose=True)
    no_sift = ("-DZTEST_SIFT=0",)
    cuda_build.build(["ztest"], verbose=True, extra=no_sift)
    variants = {"shipped": mr.ztest, "no sift": chip_smoke.ztest_built_with(no_sift),
                "triangle-major": tri_major_fn(wait_tri_major())}
    native.build()
    print(f"[build] ready in {time.perf_counter() - t0:.1f} s")

    card = chip_smoke.card_line()
    mesh = chip_smoke.run_export(args.seed, card)["mesh"]
    fov, radius = math.radians(chip_smoke.IMAGE_OPTIONS["fovy"]), chip_smoke.IMAGE_OPTIONS["radius"]
    views = range(len(BAKE_VERS)) if args.views is None else [int(v) for v in args.views.split(",")]
    rows, failed = [], []
    order = list(variants) + list(reversed(variants))
    for view in views:
        dup_feat, bins, geo = chip_smoke.bake_view_inputs(mesh, fov, radius, view)
        cs, nc = bins.chunk_starts, bins.n_chunks
        r_ids, r_z = mr.ztest_ref(dup_feat, cs, nc, **geo)
        bound = chip_smoke.ztest_bound_ms(dup_feat, bins, geo)[0]
        lists = [("", nc)] + ([(" empty", torch.zeros_like(nc))] if view == chip_smoke.K3_BAKE_VIEW else [])
        for suffix, counts in lists:
            for name, fn in variants.items():
                ids, z = fn(dup_feat, cs, counts, **geo)
                want = (r_ids, r_z) if not suffix else (torch.zeros_like(r_ids), torch.zeros_like(r_z))
                if not (torch.equal(ids, want[0]) and torch.equal(z, want[1])):
                    failed.append(f"{name} at view {view}{suffix}")
            times = {name: [] for name in variants}
            for name in order:
                fn = variants[name]
                times[name].append(chip_smoke.cuda_ms(lambda: fn(dup_feat, cs, counts, **geo), 20))
            for name, t in times.items():
                fn = variants[name]
                g = chip_smoke.graph_ms(lambda: fn(dup_feat, cs, counts, **geo))
                rows.append({"view": f"{view}{suffix}", "variant": name, "ms": t, "graph_ms": g,
                             "bound_ms": bound, "chunks": int(counts.sum()),
                             "longest_tile_chunks": int(counts.max())})
                print(f"[time] view {view}{suffix}, {int(counts.sum())} chunks (longest tile "
                      f"{int(counts.max())}) / {name}: {t[0]:.4f} {t[1]:.4f} ms; in a CUDA graph "
                      f"{g:.4f} ms; bound {bound:.5f} ms")
    totals = {name: sum(min(r["ms"]) for r in rows if r["variant"] == name and "empty" not in r["view"])
              for name in variants}
    print(f"[time] sum over the views of the faster turn: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in totals.items()))
    print(json.dumps({"card": card, "rows": rows, "totals_ms": totals, "failed": failed}))
    print(card)
    if failed:
        print("variants that give other bits: " + ", ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
