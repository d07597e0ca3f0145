"""Data-parallel training of the PyTorch port against the JAX package, in
gloo ranks on the CPU (``tests/torch_shard_cases.py``) against JAX meshes
of the virtual CPU devices: one DP step with injected draws against
``make_dp_train_step``; ``Stage1Trainer`` on data2 and data2xtile2 meshes
against JAX's trainer on a two-device mesh (densify and an opacity reset
inside the loop) and, with densify active, against the port's trainer in
one process; the replicas bit for bit on every rank; the CLI's mesh spec,
its errors, and a two-rank ``torchrun`` of the CLI."""

import concurrent.futures
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dreamgaussian_tpu.parallel import make_dp_train_step
from dreamgaussian_tpu.parallel.dp import shard_cameras
from dreamgaussian_tpu.scene import adam_init, init_random
from dreamgaussian_tpu.train import Stage1Trainer as JTrainer
from dreamgaussian_tpu.utils.camera import Camera, orbit_camera, stack_cameras
from dreamgaussian_tpu.utils.config import Config
from dreamgaussian_tpu_torch.cli import main as tcli1
from dreamgaussian_tpu_torch.scene import load_ply
from dreamgaussian_tpu_torch.train import Stage1Trainer as TTrainer
from torch_cli_cases import disc_png
from torch_cpu_cases import one_torch_thread  # noqa: F401
from torch_shard_cases import (LRS, REPO, XYZ_LR, Injected, plain_guidance, run_ranks,
                               write_inputs)

SIZE = 32
STEPS, CAP, SEED = 6, 512, 0
# A learning rate per group for the Adam-aware parameter check.
GROUP_LR = {"xyz": XYZ_LR, **{k: v for k, v in LRS.items() if k != "total_iters"}}


def _jax_lrs():
    return dict(LRS, xyz=lambda s: XYZ_LR)


def _views(n, size=SIZE, fov=0.857):
    cams = [Camera.from_pose(orbit_camera(10.0, 360.0 * i / n - 180.0, 2.0), size, size, fov, fov)
            for i in range(n)]
    return stack_cameras(cams)


def _known(size=SIZE):
    return Camera.from_pose(orbit_camera(0, 0, 2.0), size, size, 0.857, 0.857).arrays()


def _params_close(got: dict, ref: dict, steps: int):
    """test_torch_stage1's rule: Adam divides by sqrt(v), so where a gradient
    is within float32 noise of zero the noise decides part of a step. Every
    parameter stays within 1% of the distance its group's learning rate
    allows over the steps; the typical one agrees to float32 rounding."""
    for k, lr in GROUP_LR.items():
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=0.01 * steps * lr, err_msg=k)
        if np.size(ref[k]):
            assert np.median(np.abs(got[k] - ref[k])) <= 1e-6, k


# ---------------------------------------------------------------------------
# One DP step against make_dp_train_step
# ---------------------------------------------------------------------------


def _dp_step_case(work):
    """One step over two data ranks (a view each) with a guidance that draws
    its noise: writes the port's inputs to ``work`` and returns a function
    that runs the step in JAX. The same noise on both ranks, as JAX's
    replicated key gives every device."""
    params, aux = init_random(jax.random.PRNGKey(0), num_pts=128, capacity=256)
    views, known = _views(2), _known()
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (1, SIZE, SIZE, 3)))
    ref_rgb, ref_mask = np.full((SIZE, SIZE, 3), 0.5, np.float32), np.ones((SIZE, SIZE), np.float32)
    arrays = {**{f"p_{k}": np.asarray(v) for k, v in params.items()},
              **{f"aux_{k}": np.asarray(v) for k, v in aux._asdict().items()},
              **{f"known_{k}": v for k, v in known.items()},
              **{f"novel_{k}": v for k, v in views.items()},
              "noise": noise[None], "ref_rgb": ref_rgb, "ref_mask": ref_mask}
    write_inputs(work, arrays, {"size": SIZE, "steps": 1, "noise": True})

    def guidance(images, cond, step_ratio, key):
        return jnp.mean((images - 0.5 - 0.1 * jax.random.normal(key, images.shape)) ** 2)

    def run_jax():
        mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
        step = make_dp_train_step(mesh, novel_size=SIZE, ref_size=SIZE, sh_degree=0,
                                  views_per_device=1, use_known_view=True,
                                  warmup_rgb_loss=False, lr_schedules=_jax_lrs(),
                                  guidance_fns=((1.0, guidance),))
        p1, a1, x1, m = step(params, adam_init(params), aux, jnp.float32(1.0),
                             {k: jnp.asarray(v) for k, v in known.items()},
                             shard_cameras(mesh, views), jnp.ones(3), jnp.asarray(ref_rgb),
                             jnp.asarray(ref_mask), key, {})
        return {"loss": float(m["loss"]), "p": jax.device_get(p1),
                "mu": jax.device_get(a1.mu), "aux": jax.device_get(x1)._asdict()}

    return run_jax


def test_dp_step_loss_and_gradients_match_jax(dp_step):
    ranks, ref = dp_step
    for r in ranks:
        # float32 renders and reductions in another order.
        np.testing.assert_allclose(r["loss_0"], ref["loss"], rtol=1e-5)
        # Adam's first moment after one step is 0.1 times the reduced
        # gradient: the gradients before Adam's division, held to
        # tests/test_tile_shard.py's gradient bound.
        for k, mu in ref["mu"].items():
            mu = np.asarray(mu)
            mag = np.abs(mu).max(initial=0.0) + 1e-12
            np.testing.assert_allclose(r[f"mu0_{k}"], mu, rtol=1e-3, atol=1e-4 * mag, err_msg=k)


def test_dp_step_state_matches_jax(dp_step):
    ranks, ref = dp_step
    for r in ranks:
        _params_close({k: r[f"p_{k}"] for k in GROUP_LR}, ref["p"], steps=1)
        # The densify stats of the globally last view: its radii exactly,
        # the tap's gradient norm to float32 rounding.
        np.testing.assert_array_equal(r["aux_denom"], ref["aux"]["denom"])
        np.testing.assert_array_equal(r["aux_max_radii2d"], ref["aux"]["max_radii2d"])
        acc = np.asarray(ref["aux"]["grad_accum"])
        assert acc.max() > 0
        np.testing.assert_allclose(r["aux_grad_accum"], acc, rtol=1e-3, atol=1e-4 * acc.max())


# ---------------------------------------------------------------------------
# Stage1Trainer on meshes
# ---------------------------------------------------------------------------


def _trainer_opt(**over):
    size = 64    # two tile rows of 32, for the tile axis
    return dict(iters=12, ref_size=size, num_pts=256, sh_degree=0, batch_size=2,
                novel_resolutions=[size] * 3, warmup_rgb_loss=True, density_start_iter=1,
                density_end_iter=10, densification_interval=3, opacity_reset_interval=5,
                elevation=0, radius=2.0, fovy=49.1, min_ver=-30, max_ver=30,
                invert_bg_prob=0.5, **over)


# At the default threshold (JAX's mesh test's configuration) densify runs on
# its steps and finds nothing to split; at this one it clones, splits and
# runs out of slots.
ACTIVE = {"densify_grad_threshold": 1e-4}


def _target(size=64):
    yy, xx = np.mgrid[0:size, 0:size]
    c = (size - 1) / 2
    disc = ((xx - c) ** 2 + (yy - c) ** 2) < (size * 0.3) ** 2
    rgb = np.ones((size, size, 3), np.float32)
    rgb[disc] = [0.9, 0.2, 0.1]
    return rgb, disc.astype(np.float32)


def _jax_guidance(images, cond, step_ratio, key):
    return jnp.mean((images - 0.5) ** 2)


# The port's mesh trainers: (mesh, extra configuration) by name.
MESH_RUNS = {"data2": ((2, 1), {}), "data2xtile2": ((2, 2), {}),
             "data2_densify": ((2, 1), ACTIVE), "data2xtile2_densify": ((2, 2), ACTIVE)}


def _single_process_trainer(arrays):
    """The port's trainer in one process with densify active, from the
    mesh runs' cloud and split draws: its losses and final state."""
    from dreamgaussian_tpu_torch.scene import adam_init as t_adam_init

    tr = TTrainer(Config(_trainer_opt(**ACTIVE)), ref_rgb=arrays["ref_rgb"],
                  ref_mask=arrays["ref_mask"], guidance_fns=((1.0, plain_guidance),),
                  capacity=CAP, seed=SEED, device="cpu", draw=Injected({"split": arrays["split"]}))
    tr.params = {k[2:]: torch.tensor(v) for k, v in arrays.items() if k.startswith("p_")}
    tr.aux = tr.aux._replace(**{k[4:]: torch.tensor(v) for k, v in arrays.items()
                                if k.startswith("aux_")})
    tr.adam = t_adam_init(tr.params)
    losses = [float(tr.train_step()) for _ in range(STEPS)]
    return {"losses": losses, "alive": tr.aux.alive.numpy(),
            "p": {k: v.numpy() for k, v in tr.params.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of this file. The port's ranks start in two sets, one per
    world size (two ranks: the DP step, then the data2 trainers; four: the
    data2xtile2 trainers), and run while this process computes the JAX
    side and the port's single-process trainer.

    The trainers: JAX's on a two-device data mesh for STEPS train_steps;
    the port's on data2 and data2xtile2 from JAX's initial cloud, with
    JAX's split noise injected, at JAX's configuration and with densify
    active (ACTIVE)."""
    dp_work = str(tmp_path_factory.mktemp("dp_step"))
    dp_jax = _dp_step_case(dp_work)

    rgb, mask = _target()
    jt = JTrainer(Config(_trainer_opt()), ref_rgb=rgb, ref_mask=mask,
                  guidance_fns=((1.0, _jax_guidance),), capacity=CAP, seed=SEED,
                  mesh=Mesh(np.array(jax.devices()[:2]), ("data",)))
    init_p, init_aux = jax.device_get(jt.params), jax.device_get(jt.aux)
    # The JAX mesh trainer's keys per step: the scan's step keys, then its
    # densify keys; densify_and_prune draws normal(dkey, (2, C, 3)).
    key, split = jt.key, []
    for s in range(1, STEPS + 1):
        key, _ = jax.random.split(key)
        key, sub = jax.random.split(key)
        if s % 3 == 0:
            split.append(np.asarray(jax.random.normal(jax.random.split(sub, 1)[0], (2, CAP, 3))))
    arrays = {**{f"p_{k}": np.asarray(v) for k, v in init_p.items()},
              **{f"aux_{k}": np.asarray(v) for k, v in init_aux._asdict().items()},
              "split": np.stack(split), "ref_rgb": rgb, "ref_mask": mask}
    works = {}
    for name, (mesh, over) in MESH_RUNS.items():
        works[name] = str(tmp_path_factory.mktemp(name))
        write_inputs(works[name], arrays, {"trainer": _trainer_opt(**over), "mesh": mesh,
                                           "capacity": CAP, "seed": SEED, "steps": STEPS})
    two = [name for name, (mesh, _) in MESH_RUNS.items() if mesh == (2, 1)]
    four = [name for name in MESH_RUNS if name not in two]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks2 = pool.submit(run_ranks, [("dp_step", dp_work)]
                             + [("trainer", works[n]) for n in two], 2)
        ranks4 = pool.submit(run_ranks, [("trainer", works[n]) for n in four], 4)
        jax_step = dp_jax()
        losses = [float(jt.train_step()) for _ in range(STEPS)]
        jax_trainer = {"losses": losses, "xyz": np.asarray(jt.params["xyz"]),
                       "alive": np.asarray(jt.aux.alive), "alive0": np.asarray(init_aux.alive)}
        single = _single_process_trainer(arrays)
        dp_ranks, *out2 = ranks2.result()
        out4 = ranks4.result()
    mesh_ranks = {**dict(zip(two, out2)), **dict(zip(four, out4))}
    return {"dp_step": (dp_ranks, jax_step), "mesh": (mesh_ranks, jax_trainer, single)}


@pytest.fixture(scope="module")
def dp_step(runs):
    return runs["dp_step"]


@pytest.fixture(scope="module")
def mesh_runs(runs):
    return runs["mesh"]


@pytest.mark.parametrize("name", ["data2", "data2xtile2"])
def test_mesh_trainer_matches_jax_mesh_trainer(mesh_runs, name):
    """The port's data2 and data2xtile2 trainers against JAX's on a
    two-device data mesh (tile sharding changes no step's arithmetic beyond
    the order of float32 sums)."""
    runs, ref, _ = mesh_runs
    for r in runs[name]:
        losses = [float(r[f"loss_{i}"]) for i in range(STEPS)]
        # tests/test_parallel.py's bounds for the mesh trainer.
        np.testing.assert_allclose(losses, ref["losses"], rtol=2e-4)
        np.testing.assert_allclose(r[f"s{STEPS - 1}_p_xyz"], ref["xyz"], atol=1e-5)
        np.testing.assert_array_equal(r[f"s{STEPS - 1}_aux_alive"], ref["alive"])


def test_densify_inside_the_mesh_loop(mesh_runs):
    """Densify fires on steps 3 and 6 (two split draws) and the opacity
    reset on step 5, on every rank alike; with densify active the cloud
    grows at step 3."""
    runs, ref, _ = mesh_runs
    for r in runs["data2"] + runs["data2xtile2"]:
        assert int(r["draws"]) == 2 and int(r["dropped"]) == 0
        np.testing.assert_array_equal(r["s5_aux_alive"], ref["alive0"])
        np.testing.assert_array_equal(r["s4_mu_opacity"], 0.0)   # reset after step 5
    for name in ("data2_densify", "data2xtile2_densify"):
        for r in runs[name]:
            assert int(r["draws"]) == 2
            assert r["s2_aux_alive"].sum() > r["s1_aux_alive"].sum()
            # Densify ran out of slots: the check after the run doubled the
            # capacity on every rank.
            assert int(r["dropped"]) > 0 and int(r["capacity"]) == 2 * CAP
            np.testing.assert_array_equal(r["s4_mu_opacity"], 0.0)   # reset after step 5
            assert not np.array_equal(r["s3_mu_opacity"], 0.0)


@pytest.mark.parametrize("name", ["data2", "data2xtile2", "data2_densify",
                                  "data2xtile2_densify"])
def test_replicas_are_bit_identical(mesh_runs, name):
    """Parameters, Adam moments and densify stats equal on every rank after
    every step (the densify steps included): the ranks never send a
    parameter, so any drift would stay."""
    ranks = mesh_runs[0][name]
    keys = [k for k in ranks[0] if k.startswith("s")]
    assert len(keys) == STEPS * (3 * 6 + 4)
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("name", ["data2_densify", "data2xtile2_densify"])
def test_active_densify_mesh_trainers_match_single_process(mesh_runs, name):
    """With densify active, data2 and data2xtile2 (views over data, tile
    rows over tile) against the port's trainer in one process on the same
    cloud and draws: the losses at the mesh trainer's bound, the densify
    decisions equal. Densify's new gaussians start with zero Adam moments,
    and their first update is a whole step whose sign a near-zero gradient
    takes from its rounding: a few entries may differ by one flipped step."""
    runs, _, single = mesh_runs
    for r in runs[name]:
        np.testing.assert_allclose([float(r[f"loss_{i}"]) for i in range(STEPS)],
                                   single["losses"], rtol=2e-4)
        np.testing.assert_array_equal(r[f"s{STEPS - 1}_aux_alive"], single["alive"])
        for k, lr in GROUP_LR.items():
            got, ref = r[f"s{STEPS - 1}_p_{k}"], single["p"][k]
            if not ref.size:
                continue
            diff = np.abs(got - ref)
            # At most one step of one entry in 200 flipped (2 lr), none more;
            # the typical entry equal to float32 rounding.
            assert diff.max() <= 2 * lr + 1e-6, (k, diff.max())
            assert (diff > 0.01 * STEPS * lr).mean() <= 5e-3, k
            assert np.median(diff) <= 1e-6, k


# ---------------------------------------------------------------------------
# The CLI's mesh key
# ---------------------------------------------------------------------------


def test_mesh_spec_parsing():
    assert tcli1.parse_mesh_spec(None) is None and tcli1.parse_mesh_spec("") is None
    assert tcli1.parse_mesh_spec(8) == {"data": 8}
    assert tcli1.parse_mesh_spec("8") == {"data": 8}
    assert tcli1.parse_mesh_spec("data8") == {"data": 8}
    assert tcli1.parse_mesh_spec("data4xtile2") == {"data": 4, "tile": 2}
    assert tcli1.parse_mesh_spec("tile2") == {"tile": 2}
    for bad in ("foo3", "data2xdata2", "data0", "data2x", "tile"):
        with pytest.raises(ValueError, match="bad mesh spec"):
            tcli1.parse_mesh_spec(bad)


def test_mesh_of_another_size_than_the_world_raises(monkeypatch, tmp_path):
    from dreamgaussian_tpu_torch.utils.config import load_with_cli

    monkeypatch.setenv("WORLD_SIZE", "2")
    opt = load_with_cli("configs/image.yaml", [f"outdir={tmp_path}", "device=cpu",
                                               "mesh=data2xtile2"])
    with pytest.raises(ValueError, match="needs 4 ranks, this run has 2"):
        tcli1.build_mesh(opt)
    monkeypatch.delenv("WORLD_SIZE")
    assert tcli1.build_mesh(load_with_cli("configs/image.yaml", ["device=cpu"])) is None


def test_cli_under_torchrun_on_two_cpu_ranks(tmp_path):
    """``torchrun --standalone --nproc-per-node 2`` of cli.main with
    mesh=data2 on the CPU: both ranks exit 0, rank 0 writes the PLY."""
    args = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
            "-m", "dreamgaussian_tpu_torch.cli.main", "--config", "configs/image.yaml",
            f"input={disc_png(tmp_path / 'disc.png')}", f"outdir={tmp_path}", "save_path=mesh",
            "mesh=data2", "batch_size=2", "device=cpu", "fake_guidance=True", "iters=3",
            "ref_size=32", "novel_resolutions=[32,32,32]", "num_pts=256", "capacity=512",
            "save_mesh=False", "final_prune=False"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    log = res.stdout + res.stderr
    assert res.returncode == 0, log
    assert "[INFO] training on a data=2xtile=1 device mesh" in log, log
    assert "backend gloo" in log, log
    # configs/image.yaml's Zero123 term (the fake here) sums its views.
    assert "[shard] note: Zero123's guidance returns the sum over its views" in log, log
    params, aux, _ = load_ply(str(tmp_path / "mesh_model.ply"), capacity=512, device="cpu")
    n = int(aux.alive.sum())
    assert n > 0 and bool(torch.isfinite(params["xyz"][:n]).all())
