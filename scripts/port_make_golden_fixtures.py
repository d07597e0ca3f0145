"""Writes the JAX golden run's own stage-1 export and stage-2 render into
``tests/fixtures/port_golden/``, for the port's CLI test to hold its
stage 2 against.

    JAX_PLATFORMS=cpu python scripts/port_make_golden_fixtures.py [--out tests/fixtures/port_golden]

Runs the JAX package's CLIs (``dreamgaussian_tpu.cli.main``, then
``cli.main2``) on the CPU at ``tests/test_golden_e2e.py``'s overrides and
input: stage 1 on the fake Zero123 guidance at seed 0, the textured-mesh
export, stage 2. Writes:

- ``golden_mesh.obj``, ``golden_mesh.mtl``, ``golden_mesh_albedo.png``:
  the stage-1 export, as the JAX CLI wrote it;
- ``stage2_render.npy``: the JAX ``Stage2Trainer(opt, mesh,
  seed=0).render_view`` of the refined ``golden.obj`` at the golden view
  (64^2, elevation 10, azimuth 35, radius 2, fov 49.1), float16 as the
  goldens are stored;
- ``jax_run.json``: the jax version, and the PSNR of this run's stage-1
  and stage-2 renders against ``tests/fixtures/golden_e2e``'s goldens.

The export is kept because the isotropic remesh turns float32 rounding
differences of a trained cloud into different meshes; holding the port's
stage 2 on this mesh compares stage 2 alone. ``--port`` also runs the
port's CLIs as ``tests/test_torch_cli.py`` does (the JAX fake's weights
and the JAX run's draws injected) and prints where the two runs part: the
clouds' largest parameter differences, each cloud's marching-cubes and
remeshed sizes, the OBJ sizes, and the PSNR of the port's renders against
the JAX run's. Needs JAX; rerun only to change the fixtures.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(REPO, "tests", "fixtures", "port_golden")
EXPORT = ("golden_mesh.obj", "golden_mesh.mtl", "golden_mesh_albedo.png")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--port", action="store_true", help="compare the port's run with this one")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    sys.path.insert(0, REPO)
    import jax

    from dreamgaussian_tpu.cli import main as cli1
    from dreamgaussian_tpu.cli import main2 as cli2
    from dreamgaussian_tpu.meshing.mesh import Mesh
    from dreamgaussian_tpu.ops.rasterize import render_gaussians
    from dreamgaussian_tpu.scene import load_ply
    from dreamgaussian_tpu.train import Stage2Trainer
    from dreamgaussian_tpu.utils.config import load_with_cli
    from test_golden_e2e import GOLDEN_DIR, _orbit_cam, psnr
    from test_torch_cli import OVERRIDES
    from torch_cli_cases import disc_png

    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        overrides = [o for o in OVERRIDES if o != "device=cpu"] + ["jax_cache=False"]
        opt = load_with_cli(os.path.join(REPO, "configs", "image.yaml"),
                            [f"input={disc_png(os.path.join(tmp, 'disc.png'))}",
                             f"outdir={tmp}", *overrides])
        stats1 = cli1.run(opt)
        stats2 = cli2.run(opt)
        for name in EXPORT:
            shutil.copy(os.path.join(tmp, name), os.path.join(args.out, name))

        import jax.numpy as jnp

        params, aux, sh = load_ply(stats1["ply_path"], capacity=1024)
        a = {k: jnp.asarray(v) for k, v in _orbit_cam().arrays().items()}
        img1 = np.asarray(render_gaussians(
            params["xyz"], jnp.exp(params["scaling"]), params["rotation"],
            jax.nn.sigmoid(params["opacity"][:, 0]),
            jnp.concatenate([params["f_dc"], params["f_rest"]], axis=1),
            a["view"], a["full_proj"], a["campos"], a["tanfov"], 64, 64, jnp.ones(3),
            sh_degree=sh, alive=aux.alive).image, np.float16)
        mesh = Mesh.load(stats2["mesh_path"], resize=False)
        img2 = np.asarray(Stage2Trainer(opt, mesh, seed=0).render_view(_orbit_cam())["image"],
                          np.float16)
        if args.port:
            compare_port(tmp, stats1["ply_path"], img1, img2)
    np.save(os.path.join(args.out, "stage2_render.npy"), img2)
    record = {
        "jax": jax.__version__, "backend": jax.default_backend(),
        "psnr_db_against_golden_e2e": {
            "stage1_render": psnr(img1, np.load(os.path.join(GOLDEN_DIR, "stage1_render.npy"))),
            "stage2_render": psnr(img2, np.load(os.path.join(GOLDEN_DIR, "stage2_render.npy"))),
        },
    }
    with open(os.path.join(args.out, "jax_run.json"), "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"[fixtures] {json.dumps(record)} -> {args.out}")


def compare_port(jax_dir: str, jax_ply: str, img1, img2) -> None:
    """The port's two-stage run beside the JAX run in ``jax_dir``, then
    the port's stage 2 on the JAX export; prints where they part."""
    import torch

    from dreamgaussian_tpu_torch import native
    from dreamgaussian_tpu_torch.meshing.export import extract_occupancy_field
    from dreamgaussian_tpu_torch.meshing.marching_cubes import marching_cubes
    from dreamgaussian_tpu_torch.meshing.mesh import Mesh
    from dreamgaussian_tpu_torch.ops.rasterize import render_gaussians
    from dreamgaussian_tpu_torch.scene import load_ply
    from dreamgaussian_tpu_torch.train import Stage2Trainer
    from test_golden_e2e import psnr
    from test_torch_cli import _golden_camera, run_port_clis

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as port_dir:
        opt = run_port_clis(port_dir, mesh=None)
        clouds = {"jax": load_ply(jax_ply, capacity=1024, device="cpu"),
                  "port": load_ply(os.path.join(port_dir, "golden_model.ply"), capacity=1024,
                                   device="cpu")}
        for k, v in clouds["jax"][0].items():
            if v.numel():
                print(f"[compare] cloud {k}: max abs difference "
                      f"{float((v - clouds['port'][0][k]).abs().max()):.3g}")
        for name, (params, aux, _) in clouds.items():
            occ, tf = extract_occupancy_field(params, aux.alive, resolution=opt.mc_resolution,
                                              device="cpu")
            verts, faces = marching_cubes(np.asarray(occ), opt.density_thresh)
            v, f = native.clean_mesh(tf.grid_to_world(verts, opt.mc_resolution), faces,
                                     weld_eps=1e-6, min_comp_frac=0.1)
            v = native.laplacian_smooth(v, f, 2, 0.5)
            rv, rf = native.isotropic_remesh(v, f, 0.015, n_iter=5)
            print(f"[compare] {name} cloud's export: marching cubes {len(verts)} vertices "
                  f"{len(faces)} faces, cleaned {len(v)}/{len(f)}, remeshed {len(rv)}/{len(rf)}")
        for name in ("golden_mesh.obj", "golden.obj"):
            sizes = [len(Mesh.load(os.path.join(d, name), resize=False).v)
                     for d in (jax_dir, port_dir)]
            print(f"[compare] {name}: {sizes[0]} vertices (JAX), {sizes[1]} (port)")

        params, aux, sh = clouds["port"]
        cam = {k: torch.from_numpy(np.asarray(v, np.float32))
               for k, v in _golden_camera().arrays().items()}
        with torch.no_grad():
            port1 = render_gaussians(
                params["xyz"], torch.exp(params["scaling"]), params["rotation"],
                torch.sigmoid(params["opacity"][:, 0]),
                torch.cat([params["f_dc"], params["f_rest"]], 1), cam["view"],
                cam["full_proj"], cam["campos"], cam["tanfov"], 64, 64, torch.ones(3),
                sh_degree=sh, alive=aux.alive, device="cpu").image.numpy()
        print(f"[compare] stage 1: port render {psnr(np.float16(port1), img1):.2f} dB from the "
              "JAX run's")

        def render(path):
            with torch.no_grad():
                img = Stage2Trainer(opt, Mesh.load(path, resize=False), seed=0,
                                    device="cpu").render_view(_golden_camera())["image"]
            return psnr(np.float16(img.numpy()), img2)

        refined = os.path.join(port_dir, "golden.obj")
        print(f"[compare] stage 2 end to end: port render {render(refined):.2f} dB from the "
              "JAX run's")
        run_port_clis(port_dir, mesh=os.path.join(jax_dir, "golden_mesh.obj"), stage1=False)
        print(f"[compare] stage 2 on the JAX export: port render {render(refined):.2f} dB from "
              "the JAX run's")


if __name__ == "__main__":
    main()
